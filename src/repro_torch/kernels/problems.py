"""Problem sizes and the variant factory the autotuner times.

  * ``BENCH_DIMS`` — small sizes for the CPU backend (plain versions, tests);
    the same as ``repro.kernels.problems.BENCH_DIMS``.
  * ``LARGE_SHAPES`` — the paper's LARGE dataset sizes, which the GPU
    backend times on the card.

:func:`gpu_problem` creates a problem's inputs on the device once per
campaign and returns the ``factory(config) -> (fn, args)`` that
:class:`~repro_torch.core.plopper.TimingEvaluator` runs: every evaluation
reuses the same device tensors, and on the card every one is a launch of the
CUDA kernel with the proposed schedule.
"""

from __future__ import annotations

from repro_torch.kernels import ops, ref
from repro_torch.kernels.util import resolve_device

__all__ = ["BENCH_DIMS", "LARGE_SHAPES", "gpu_problem", "problem_inputs"]

BENCH_DIMS = {
    "syr2k": (240, 200),
    "mm3": (200, 180, 160, 150, 170),
}

LARGE_SHAPES = {
    "syr2k": (1200, 1000),
    "mm3": (800, 900, 1000, 1100, 1200),
}

_OPS = {"syr2k": ops.syr2k_op, "mm3": ops.mm3_op}


def problem_inputs(name: str, dims: tuple, device, seed: int = 0):
    """The problem's inputs, drawn with numpy from ``seed`` and moved to ``device``."""
    init = {"syr2k": ref.init_syr2k, "mm3": ref.init_mm3}[name]
    return ref.to_device(init(*dims, seed=seed), device)


def gpu_problem(name: str, dims: tuple | None = None, device=None, seed: int = 0):
    """Variant factory for ``name`` at ``dims`` (default :data:`LARGE_SHAPES`)
    on ``device`` (default ``cuda``; ``"cpu"`` runs the plain versions).
    The inputs are created once, here, not once per evaluation."""
    dev = resolve_device(device)
    dims = LARGE_SHAPES[name] if dims is None else tuple(dims)
    args = problem_inputs(name, dims, dev, seed)
    op = _OPS[name]

    def factory(config):
        return (lambda *xs: op(*xs, config=config)), args

    return factory
