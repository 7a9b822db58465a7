"""syr2k: O = alpha*A@B^T + alpha*B@A^T + beta*C (the paper's Sec. 4.1 case study).

:func:`syr2k` launches the hand-written CUDA kernel ``csrc/syr2k.cu`` for
tensors on the card, and takes the plain PyTorch version :func:`syr2k_plain`
only for tensors on the CPU. Knob mapping (same names and clamping as
``repro.kernels.syr2k.syr2k``):

  * P3/P4/P5 tile sizes -> ``bi``/``bj``/``bk`` (O-row tile, O-column tile,
    chunk of the contraction over M);
  * P2 interchange      -> ``interchange`` (which tile axis the block raster
    walks first);
  * P0/P1 array packing -> ``pack_a``/``pack_b`` (stage the A, resp. B,
    chunks in shared memory; otherwise the inner loop reads global memory).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.util import (
    ConfigRejected,
    check_operand,
    max_shared_memory_per_block,
)

__all__ = ["syr2k", "syr2k_check", "syr2k_plain", "syr2k_smem_bytes"]


def syr2k_smem_bytes(bi: int, bj: int, bk: int, pack_a: bool, pack_b: bool,
                     limit: int | None = None) -> int:
    """Dynamic shared memory (bytes) one block of ``csrc/syr2k.cu`` needs for
    this tile and these knobs under a per-block ``limit`` (default: the
    current card's), or -1 for a tile its register tile cannot hold. The
    kernel's ring takes as many stages (3 down to 1) as fit the limit, so a
    result above it means even one stage does not fit. The kernel's own
    layout answers, so the library is built first."""
    if limit is None:
        limit = max_shared_memory_per_block(torch.device("cuda"))
    return build.load("syr2k").syr2k_smem_bytes(bi, bj, bk, int(pack_a), int(pack_b),
                                                int(limit))


def syr2k_plain(C, A, B, alpha: float = 1.5, beta: float = 1.2) -> torch.Tensor:
    """The plain version: the same function in f32 PyTorch ops. The schedule
    knobs do not change syr2k's arithmetic, so it takes none."""
    Cf, Af, Bf = C.float(), A.float(), B.float()
    return (beta * Cf + alpha * (Af @ Bf.T + Bf @ Af.T)).to(C.dtype)


def syr2k_check(C, A, B, *, bi: int = 128, bj: int = 128, bk: int = 128,
                pack_a: bool = False, pack_b: bool = False) -> tuple[int, int, int]:
    """The wrapper's checks before a launch, without launching: shapes and,
    on the card, the operands (dtype, device, contiguity) and the tile
    against the register tile and the device's shared memory per block.
    Raises :class:`ConfigRejected` for a tile the kernel cannot run; returns
    the clamped ``(bi, bj, bk)``."""
    N, M = A.shape
    if tuple(B.shape) != (N, M) or tuple(C.shape) != (N, N):
        raise ValueError(f"syr2k shapes: C {tuple(C.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}")
    bi, bj, bk = min(bi, N), min(bj, N), min(bk, M)
    if C.device.type == "cpu":
        return bi, bj, bk
    dev = C.device
    for name, t, shape in (("C", C, (N, N)), ("A", A, (N, M)), ("B", B, (N, M))):
        check_operand(name, t, shape, (torch.float32,), dev)
    limit = max_shared_memory_per_block(dev)
    smem = syr2k_smem_bytes(bi, bj, bk, pack_a, pack_b, limit)
    if smem < 0:
        raise ConfigRejected(f"syr2k tile {bi}x{bj} does not fit the kernel's register tile")
    if smem > limit:
        raise ConfigRejected(f"syr2k bi={bi} bj={bj} bk={bk} pack_a={pack_a} "
                             f"pack_b={pack_b} needs {smem} B of shared memory, "
                             f"the device allows {limit} B per block")
    return bi, bj, bk


def syr2k(
    C: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    alpha: float = 1.5,
    beta: float = 1.2,
    *,
    bi: int = 128,
    bj: int = 128,
    bk: int = 128,
    interchange: bool = False,
    pack_a: bool = False,
    pack_b: bool = False,
) -> torch.Tensor:
    bi, bj, bk = syr2k_check(C, A, B, bi=bi, bj=bj, bk=bk, pack_a=pack_a, pack_b=pack_b)
    N, M = A.shape
    if C.device.type == "cpu":
        return syr2k_plain(C, A, B, alpha, beta)

    dev = C.device
    limit = max_shared_memory_per_block(dev)
    out = torch.empty_like(C)
    lib = build.load("syr2k")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.mark_launch()
        err = lib.syr2k_launch(
            C.data_ptr(), A.data_ptr(), B.data_ptr(), out.data_ptr(),
            N, M, float(alpha), float(beta), bi, bj, bk,
            int(pack_a), int(pack_b), int(interchange), limit, stream)
    build.check(lib, err, "syr2k")
    syr2k.launches += 1
    return out


syr2k.launches = 0  # kernel launches since the last reset (chip_smoke reads it)
