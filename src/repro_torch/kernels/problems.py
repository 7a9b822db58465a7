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

import torch

from repro_torch.kernels import model_kernels, ops, ref
from repro_torch.kernels.util import resolve_device

__all__ = ["BENCH_DIMS", "LARGE_SHAPES", "gpu_problem", "problem_inputs"]

BENCH_DIMS = {
    "syr2k": (240, 200),
    "mm3": (200, 180, 160, 150, 170),
    "lu": (256,),
    "heat3d": (40, 8),
    "covariance": (300, 240),
    "floyd_warshall": (240,),
    "flash_attention": (4, 128, 128, 64),
    "decode_attention": (8, 2, 128, 64),   # (BH, G, seq_bucket, hd)
    "matmul": (256, 192, 224),
}

LARGE_SHAPES = {
    "syr2k": (1200, 1000),
    "mm3": (800, 900, 1000, 1100, 1200),
    "lu": (2000,),
    "heat3d": (120, 500),
    "covariance": (1400, 1200),
    "floyd_warshall": (2800,),
    # the serving kernels: a 16-head 4k-context serving shape, the JAX
    # package's LARGE analog
    "flash_attention": (16, 4096, 4096, 128),
    "decode_attention": (16, 8, 4096, 128),
    "matmul": (2000, 2300, 2600),
}

_OPS = {"syr2k": ops.syr2k_op, "mm3": ops.mm3_op, "lu": ops.lu_op,
        "covariance": ops.covariance_op, "floyd_warshall": ops.floyd_warshall_op}
# the serving kernels: their dispatch builders, over a sampled config
_MODEL_HOSTS = {"flash_attention": model_kernels.flash_attention_host,
                "decode_attention": model_kernels.decode_attention_host,
                "matmul": model_kernels.matmul_host}


def problem_inputs(name: str, dims: tuple, device, seed: int = 0):
    """The problem's inputs, drawn with numpy from ``seed`` and moved to
    ``device``. heat3d's dims are (N, tsteps): its one input is the N^3 grid;
    decode_attention's last input is the int32 cur_pos vector."""
    if name == "decode_attention":
        q, k, v, cur_pos = model_kernels.init_decode_attention(*dims, seed=seed)
        return ref.to_device((q, k, v), device) + (
            torch.from_numpy(cur_pos).to(device),)
    init = {"syr2k": ref.init_syr2k, "mm3": ref.init_mm3, "lu": ref.init_lu,
            "heat3d": lambda N, tsteps, seed: ref.init_heat3d(N, seed=seed),
            "covariance": ref.init_covariance,
            "floyd_warshall": ref.init_floyd_warshall,
            "flash_attention": model_kernels.init_flash_attention,
            "matmul": model_kernels.init_matmul}[name]
    return ref.to_device(init(*dims, seed=seed), device)


def gpu_problem(name: str, dims: tuple | None = None, device=None, seed: int = 0):
    """Variant factory for ``name`` at ``dims`` (default :data:`LARGE_SHAPES`)
    on ``device`` (default ``cuda``; ``"cpu"`` runs the plain versions).
    The inputs are created once, here, not once per evaluation."""
    dev = resolve_device(device)
    dims = LARGE_SHAPES[name] if dims is None else tuple(dims)
    args = problem_inputs(name, dims, dev, seed)
    if name in _MODEL_HOSTS:
        return _MODEL_HOSTS[name](args)
    if name == "heat3d":
        tsteps = dims[1]

        def op(A, config):
            return ops.heat3d_op(A, tsteps, config=config)
    else:
        op = _OPS[name]

    def factory(config):
        return (lambda *xs: op(*xs, config=config)), args

    return factory
