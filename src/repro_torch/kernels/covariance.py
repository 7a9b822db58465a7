"""covariance: data (N x M) -> cov (M x M) = (D - mu)^T (D - mu) / (N - 1)
(the paper's Sec. 4.5).

:func:`covariance` launches the hand-written CUDA kernel
``csrc/covariance.cu`` for tensors on the card, and takes the plain PyTorch
version :func:`covariance_plain` only for tensors on the CPU. Knob mapping
(same names and clamping as ``repro.kernels.covariance.covariance``):

  * ``bi``/``bj``   -> output (attribute x attribute) tile;
  * ``bk``          -> chunk of the reduction over the N data points;
  * ``fuse_center`` -> subtract the column means inside the kernel, from each
                       chunk in shared memory as it lands, instead of in a
                       separate centering pass before it;
  * ``interchange`` -> which output tile axis the block raster walks first.

The means come from a plain ``data.mean(0)`` in both cases, as in the JAX
package. Rows past N and columns past M are masked in the kernel, where the
JAX package pads (M to ``lcm(bi, bj)``, rows with the means).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.util import (
    ConfigRejected,
    check_operand,
    max_shared_memory_per_block,
)

__all__ = ["covariance", "covariance_check", "covariance_plain", "covariance_smem_bytes"]


def covariance_smem_bytes(bi: int, bj: int, bk: int, limit: int | None = None) -> int:
    """Dynamic shared memory (bytes) one block of ``csrc/covariance.cu``
    needs for this tile under a per-block ``limit`` (default: the current
    card's), or -1 for a tile its register tile cannot hold. The kernel's
    ring takes as many stages (3 down to 1) as fit the limit, so a result
    above it means even one stage does not fit. The kernel's own layout
    answers, so the library is built first."""
    if limit is None:
        limit = max_shared_memory_per_block(torch.device("cuda"))
    return build.load("covariance").covariance_smem_bytes(bi, bj, bk, int(limit))


def covariance_plain(data: torch.Tensor) -> torch.Tensor:
    """The plain version: the same function in f32 PyTorch ops. Centering
    inside or before the product gives the same values, so it takes no knob."""
    c = data - data.mean(0, keepdim=True)
    return (c.T @ c) / (data.shape[0] - 1.0)


def covariance_check(data, *, bi: int = 64, bj: int = 64,
                     bk: int = 32) -> tuple[int, int, int]:
    """The wrapper's checks before a launch, without launching: shape and
    dtype and, on the card, the operand and the tile against the register
    tile and the device's shared memory per block. Raises
    :class:`ConfigRejected` for a tile the kernel cannot run; returns the
    clamped ``(bi, bj, bk)``."""
    if data.dim() != 2:
        raise ValueError(f"covariance data must be N x M, got {tuple(data.shape)}")
    N, M = data.shape
    if data.dtype != torch.float32:
        raise TypeError(f"covariance is f32 only, got {data.dtype}")
    bi, bj, bk = min(bi, M), min(bj, M), min(bk, N)
    if data.device.type == "cpu":
        return bi, bj, bk
    dev = data.device
    check_operand("data", data, (N, M), (torch.float32,), dev)
    limit = max_shared_memory_per_block(dev)
    smem = covariance_smem_bytes(bi, bj, bk, limit)
    if smem < 0:
        raise ConfigRejected(f"covariance tile {bi}x{bj} does not fit the kernel's register tile")
    if smem > limit:
        raise ConfigRejected(f"covariance bi={bi} bj={bj} bk={bk} needs {smem} B of "
                             f"shared memory, the device allows {limit} B per block")
    return bi, bj, bk


def covariance(
    data: torch.Tensor,
    *,
    bi: int = 64,
    bj: int = 64,
    bk: int = 32,
    fuse_center: bool = True,
    interchange: bool = False,
) -> torch.Tensor:
    bi, bj, bk = covariance_check(data, bi=bi, bj=bj, bk=bk)
    N, M = data.shape
    if data.device.type == "cpu":
        return covariance_plain(data)

    dev = data.device
    limit = max_shared_memory_per_block(dev)
    build.mark_launch()  # the call's device work starts with the mean
    mean = data.mean(0)
    src = data if fuse_center else (data - mean).contiguous()
    out = torch.empty((M, M), dtype=torch.float32, device=dev)
    lib = build.load("covariance")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.mark_launch()
        err = lib.covariance_launch(
            src.data_ptr(), mean.data_ptr(), out.data_ptr(), N, M, bi, bj, bk,
            int(fuse_center), int(interchange), limit, stream)
    build.check(lib, err, "covariance")
    covariance.launches += 1
    return out


covariance.launches = 0  # kernel launches since the last reset (chip_smoke reads it)
