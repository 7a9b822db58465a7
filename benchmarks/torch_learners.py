"""Four-learner comparison on the port (the paper's Figs 3-6 and its Sec. 4
method), the counterpart of ``benchmarks/learners.py``: the same syr2k
campaign under RF / ET / GBRT / GP, each reporting its best objective, the
evaluation that found it, its real evaluations and the duplicate proposals
it skipped (GP's early finish, Sec. 2.2).

On the card the campaigns time the CUDA kernel at the paper's LARGE size
over the ``gpu`` space (the JAX package's 192 x 160 was sized for a CPU);
on the CPU (``device="cpu"``) the plain version at ``BENCH_DIMS`` over the
``host`` space.
"""

from __future__ import annotations

from benchmarks.torch_common import DEFAULT_EVALS, Row
from repro_torch.core import TimingEvaluator, compare_learners
from repro_torch.kernels import problems
from repro_torch.kernels import variants as V
from repro_torch.kernels.spaces import kernel_space
from repro_torch.kernels.util import resolve_device

__all__ = ["learner_campaigns", "learner_comparison"]


def learner_campaigns(max_evals: int = DEFAULT_EVALS, device=None) -> dict:
    """``learner -> SearchResult`` of the four syr2k campaigns (seed 1234)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    dims = (problems.LARGE_SHAPES if on_card else problems.BENCH_DIMS)["syr2k"]
    args = problems.problem_inputs("syr2k", dims, dev)
    ev = TimingEvaluator(V.syr2k_host(args), repeats=2, warmup=1)
    return compare_learners(kernel_space("syr2k", target="gpu" if on_card else "host"), ev,
                            max_evals=max_evals, seed=1234)


def learner_comparison(max_evals: int = DEFAULT_EVALS, device=None) -> list[Row]:
    """One row per learner: its best objective (the campaign's own, as the
    JAX package reports it), found at, real evaluations, skipped duplicates."""
    rows = []
    for learner, res in learner_campaigns(max_evals, device).items():
        b = res.best
        rows.append(Row(
            f"learners_syr2k/{learner}", b.objective * 1e6,
            f"at_eval={b.index};evaluated={res.n_evaluated};skipped_dups={res.n_skipped};"
            f"config={b.config}", dict(b.config)))
    return rows
