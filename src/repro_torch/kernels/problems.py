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
    "lu": (256,),
    "heat3d": (40, 8),
    "covariance": (300, 240),
    "floyd_warshall": (240,),
}

LARGE_SHAPES = {
    "syr2k": (1200, 1000),
    "mm3": (800, 900, 1000, 1100, 1200),
    "lu": (2000,),
    "heat3d": (120, 500),
    "covariance": (1400, 1200),
    "floyd_warshall": (2800,),
}

_OPS = {"syr2k": ops.syr2k_op, "mm3": ops.mm3_op, "lu": ops.lu_op,
        "covariance": ops.covariance_op, "floyd_warshall": ops.floyd_warshall_op}


def problem_inputs(name: str, dims: tuple, device, seed: int = 0):
    """The problem's inputs, drawn with numpy from ``seed`` and moved to
    ``device``. heat3d's dims are (N, tsteps): its one input is the N^3 grid."""
    init = {"syr2k": ref.init_syr2k, "mm3": ref.init_mm3, "lu": ref.init_lu,
            "heat3d": lambda N, tsteps, seed: ref.init_heat3d(N, seed=seed),
            "covariance": ref.init_covariance,
            "floyd_warshall": ref.init_floyd_warshall}[name]
    return ref.to_device(init(*dims, seed=seed), device)


def gpu_problem(name: str, dims: tuple | None = None, device=None, seed: int = 0):
    """Variant factory for ``name`` at ``dims`` (default :data:`LARGE_SHAPES`)
    on ``device`` (default ``cuda``; ``"cpu"`` runs the plain versions).
    The inputs are created once, here, not once per evaluation."""
    dev = resolve_device(device)
    dims = LARGE_SHAPES[name] if dims is None else tuple(dims)
    args = problem_inputs(name, dims, dev, seed)
    if name == "heat3d":
        tsteps = dims[1]

        def op(A, config):
            return ops.heat3d_op(A, tsteps, config=config)
    else:
        op = _OPS[name]

    def factory(config):
        return (lambda *xs: op(*xs, config=config)), args

    return factory
