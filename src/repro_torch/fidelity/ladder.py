"""The fidelity ladder: a declarative stack of evaluation fidelities — a
copy of ``repro.fidelity.ladder`` whose timed rungs run the CUDA kernels.

A :class:`Rung` names one way of scoring a configuration — cheaper and less
faithful toward the bottom, expensive ground truth at the top:

  * **rung 0 — analytic** (``cost``): the Hopper cost model of the CUDA
    kernels (:func:`repro_torch.kernels.cost.kernel_cost`). Zero hardware;
    thousands of configs per second; ordering-faithful where the model is
    good (see ``python -m repro_torch.launch.fidelity audit``).
  * **rung 1 — proxy** (``proxy``): CUDA-event timing on the card at reduced
    problem dims (:data:`repro_torch.kernels.problems.PROXY_DIMS`). Real
    launches of the same kernels, a fraction of the full cost.
  * **rung 2 — hardware** (``hw``): full-dims timing — the paper's
    evaluation, the budget that matters.

On the CPU (``device="cpu"``, for tests and machines without a card) the
timed rungs wall-clock the plain versions instead, at the bench dims.

Each rung carries an evaluation ``budget`` (counted exactly like a
campaign's ``max_evals``: records, failures, and GP skips all consume it)
and a ``promote`` count — how many of its best configurations graduate to
the next rung (the successive-halving shape: wide and cheap below, narrow
and expensive above). :func:`default_ladder` builds the standard
cost → proxy → hardware stack for any benchmark kernel; ladders with
arbitrary evaluators (tests, third-party fidelities) construct
:class:`FidelityLadder` directly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core.plopper import EvalResult

__all__ = ["Rung", "FidelityLadder", "default_ladder"]


@dataclasses.dataclass(frozen=True)
class Rung:
    """One fidelity level.

    ``evaluator`` is the standard ``config -> EvalResult`` callable.
    ``executor``, when set, overrides it for this rung's campaign (e.g. a
    hardened or thread-pool executor for the hardware rung); the evaluator
    is then ignored by the campaign but still used for calibration-free
    re-scoring, so keep both coherent.
    """

    level: int
    name: str
    evaluator: Callable[[Mapping[str, Any]], EvalResult]
    budget: int
    promote: int = 0          # top-k graduating to the next rung (0 on top)
    executor: Any | None = None

    def __post_init__(self):
        if self.budget < 1:
            raise ValueError(f"rung {self.name!r}: budget must be >= 1, "
                             f"got {self.budget}")
        if self.promote < 0:
            raise ValueError(f"rung {self.name!r}: promote must be >= 0, "
                             f"got {self.promote}")


class FidelityLadder:
    """An ordered, validated sequence of rungs (ascending fidelity)."""

    def __init__(self, rungs: Sequence[Rung]):
        rungs = list(rungs)
        if not rungs:
            raise ValueError("a fidelity ladder needs at least one rung")
        levels = [r.level for r in rungs]
        if levels != sorted(set(levels)):
            raise ValueError(f"rung levels must be strictly ascending, got {levels}")
        names = [r.name for r in rungs]
        if len(set(names)) != len(names):
            raise ValueError(f"rung names must be unique, got {names}")
        for below, above in zip(rungs, rungs[1:]):
            if below.promote < 1:
                raise ValueError(
                    f"rung {below.name!r} promotes nothing to {above.name!r}; "
                    f"set promote >= 1 on every non-top rung")
            if below.promote > below.budget:
                raise ValueError(
                    f"rung {below.name!r} cannot promote {below.promote} from "
                    f"a budget of {below.budget}")
            if below.promote > above.budget:
                raise ValueError(
                    f"rung {below.name!r} promotes {below.promote} but "
                    f"{above.name!r} can only evaluate {above.budget}")
        self.rungs = rungs

    def __len__(self) -> int:
        return len(self.rungs)

    def __iter__(self):
        return iter(self.rungs)

    def __getitem__(self, i: int) -> Rung:
        return self.rungs[i]

    @property
    def top(self) -> Rung:
        """The ground-truth rung — its best record is the cascade's answer,
        and its budget is the hardware-evaluation bill."""
        return self.rungs[-1]

    def describe(self) -> list[dict]:
        return [{"level": r.level, "name": r.name, "budget": r.budget,
                 "promote": r.promote} for r in self.rungs]


def default_ladder(
    kernel: str,
    *,
    budgets: Sequence[int] = (64, 16, 8),
    promote: Sequence[int] | None = None,
    dims: tuple | None = None,
    proxy_dims: tuple | None = None,
    repeats: int = 2,
    warmup: int = 1,
    top_executor: Any | None = None,
    device: str | None = None,
) -> FidelityLadder:
    """The standard cost → proxy → hardware ladder for a benchmark kernel.

    ``budgets`` gives one entry per rung, bottom-up; a 2-entry budget list
    builds a cost → hardware ladder (no proxy rung) — the shape the
    background tuner uses. ``promote`` defaults to half the next rung's
    budget (at least 2). The timed rungs run
    :func:`~repro_torch.kernels.problems.gpu_problem` on ``device``: the
    card (the default; raises without one), or ``"cpu"`` for the plain
    versions. ``dims`` defaults to :data:`~repro_torch.kernels.problems.LARGE_SHAPES`
    on the card and :data:`~repro_torch.kernels.problems.BENCH_DIMS` on the
    CPU; rung 0 screens at ``dims`` too; ``proxy_dims`` defaults to
    :data:`~repro_torch.kernels.problems.PROXY_DIMS`. Raises ``KeyError``
    for kernels without a cost-model entry (not ``fidelity_ready``).
    """
    from repro_torch.core.plopper import TimingEvaluator
    from repro_torch.kernels.cost import KERNEL_COST_FNS
    from repro_torch.kernels.problems import (
        BENCH_DIMS,
        LARGE_SHAPES,
        PROXY_DIMS,
        gpu_problem,
        make_cost_evaluator,
    )
    from repro_torch.kernels.util import resolve_device

    if kernel not in KERNEL_COST_FNS:
        raise KeyError(
            f"kernel {kernel!r} has no cost-model entry and cannot screen on "
            f"rung 0 (fidelity_ready == False); registered cost models: "
            f"{sorted(KERNEL_COST_FNS)}")
    if len(budgets) not in (2, 3):
        raise ValueError(f"budgets must have 2 or 3 entries, got {list(budgets)}")
    dev = resolve_device(device)
    if dims is None:
        dims = (LARGE_SHAPES if dev.type == "cuda" else BENCH_DIMS)[kernel]
    dims = tuple(dims)
    if promote is None:
        promote = [max(2, b // 2) for b in budgets[1:]]
    if len(promote) != len(budgets) - 1:
        raise ValueError(
            f"promote needs {len(budgets) - 1} entries for {len(budgets)} "
            f"rungs, got {list(promote)}")

    rungs = [Rung(level=0, name="cost", budget=int(budgets[0]),
                  promote=int(promote[0]),
                  evaluator=make_cost_evaluator(kernel, dims))]
    if len(budgets) == 3:
        pdims = tuple(proxy_dims) if proxy_dims is not None \
            else PROXY_DIMS.get(kernel, dims)
        rungs.append(Rung(
            level=1, name="proxy", budget=int(budgets[1]),
            promote=int(promote[1]),
            evaluator=TimingEvaluator(gpu_problem(kernel, pdims, device=dev),
                                      repeats=repeats, warmup=warmup)))
    rungs.append(Rung(
        level=len(budgets) - 1, name="hw", budget=int(budgets[-1]),
        evaluator=TimingEvaluator(gpu_problem(kernel, dims, device=dev),
                                  repeats=repeats, warmup=warmup),
        executor=top_executor))
    return FidelityLadder(rungs)
