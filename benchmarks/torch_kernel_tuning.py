"""Schedule tuning of the port's CUDA kernels against the Hopper cost model,
the counterpart of ``benchmarks/pallas_tuning.py`` (which tunes the Pallas
kernels' BlockSpecs against a TPU model).

Each of the nine kernels is tuned over its ``gpu`` space at the paper's
LARGE sizes with the cost backend (``repro_torch.kernels.cost``, the
cascade's rung 0: nothing launches), from seed 1234. A row gives the
tuned config's modeled time beside the default's, and its modeled
utilisation: the flops it computes over the modeled time times the peak of
the route it takes (``kernels/cost.py:hopper()``'s FFMA, 3xTF32 or
min/max rate). On the card each tuned config is also re-timed with the row
timer (``benchmarks.torch_common.time_callable``) beside its modeled time.

Pass a :class:`~repro_torch.dispatch.TuningStore` (or a path) and each
campaign warm-starts from the store's nearest records and publishes its
winner back under the ``cost`` backend, as the JAX package's does.

    PYTHONPATH=src:. python -m benchmarks.torch_kernel_tuning [--max-evals N] \\
        [--store DIR] [--device cpu]
"""

from __future__ import annotations

import argparse

from benchmarks.torch_common import DEFAULT_EVALS, Row, emit, time_callable
from repro_torch.core import autotune
from repro_torch.dispatch import TuningRecord, TuningStore
from repro_torch.dispatch.lookup import warm_start_material
from repro_torch.kernels.cost import kernel_cost
from repro_torch.kernels.problems import (
    LARGE_SHAPES,
    gpu_problem,
    make_cost_evaluator,
    problem_signature_for,
)
from repro_torch.kernels.spaces import kernel_space
from repro_torch.kernels.util import resolve_device

__all__ = ["tune_all"]


def tune_all(max_evals: int | None = None, store: TuningStore | str | None = None,
             device=None) -> list[Row]:
    """One row per kernel: the tuned config's modeled microseconds, with the
    default's, the modeled utilisation and, on the card, the tuned config's
    measured time at LARGE."""
    dev = resolve_device(device)
    if isinstance(store, str):
        store = TuningStore(store)
    rows = []
    for name in LARGE_SHAPES:
        dims = LARGE_SHAPES[name]
        sig = problem_signature_for(name, "cost")
        space = kernel_space(name, target="gpu")
        default = space.default_configuration()
        base_t, _ = kernel_cost(name, default, *dims)
        warm_cfgs, warm_recs = None, None
        if store is not None:
            warm_cfgs, warm_recs = warm_start_material(store, name, sig, backend="cost")
        res = autotune(space, make_cost_evaluator(name, dims),
                       max_evals=max_evals or max(DEFAULT_EVALS, 40), learner="RF",
                       seed=1234, warm_start=warm_cfgs,
                       warm_start_records=warm_recs)
        b = res.best
        if store is not None:
            store.put(TuningRecord(
                kernel=name, signature=sig, backend="cost", config=dict(b.config),
                objective=float(b.objective), n_evals=len(res.db),
                source="benchmark:torch_kernel_tuning"))
        util = b.info["flops"] / (b.objective * b.info["peak"])
        measured = "not measured (CPU)"
        if dev.type == "cuda":
            fn, args = gpu_problem(name, dims, device=dev)(b.config)
            measured = f"{time_callable(fn, args) * 1e6:.1f}"
        rows.append(Row(
            f"kernel_tuning/{name}", b.objective * 1e6,
            f"default_us={base_t * 1e6:.1f};at_eval={b.index};util={util:.2f};"
            f"measured_us={measured};config={b.config}", dict(b.config)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-evals", type=int, default=None,
                    help="cost-model evaluations per kernel (default 40)")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="TuningStore to warm-start from and publish into")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the tuned configs are re-timed (default: the card; "
                         "cpu: modeled times only)")
    args = ap.parse_args(argv)
    emit(tune_all(args.max_evals, args.store, device=args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
