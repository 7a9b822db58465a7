"""Tunable tiled matmul — the building block under mm3, lu's trailing
update and the model's dispatched output projection and unembed.

:func:`tiled_matmul` launches the hand-written CUDA kernel ``csrc/matmul.cu``
for tensors on the card, and takes the plain PyTorch version
:func:`tiled_matmul_plain` only for tensors on the CPU. Knob mapping (same
names and clamping as ``repro.kernels.matmul.tiled_matmul``):

  * tiling        -> ``bm``/``bn``/``bk`` (output tile, contraction chunk);
  * interchange   -> which output tile axis the block raster walks first;
  * array packing -> ``pack=True`` accumulates the whole contraction in f32
                     registers and stores once; ``pack=False`` adds each
                     ``bk`` chunk's product into the output in its own dtype
                     (a read-modify-write per chunk: looser in bf16).

The kernel picks its route before the launch and reports it
(:data:`ROUTES`; counted in ``tiled_matmul.route_launches``):

  * ``split``: tiles of at most 8 rows (the decode's products), f32 or bf16:
    B streamed from device memory into registers, K split across the CTAs
    of a thread-block cluster where the column tiles alone leave SMs idle
    (:func:`matmul_splits`), the partial tiles added in a fixed order through
    distributed shared memory (the same bits on every call);
  * ``wgmma``: bf16 tiles past 8 rows with ``pack=True`` and TMA-aligned
    operands (16-byte bases, K and N multiples of 8): ``wgmma`` behind a TMA
    ring;
  * ``mma_sync``: f32 tiles past 8 rows in 3xTF32, and the bf16 ones the
    ``wgmma`` route does not take (``pack=False``, unaligned operands):
    ``mma.sync`` behind a ``cp.async`` ring;
  * ``ffma``: the f32 128-row tiles whose padded tensor-core layout does not
    fit the shared memory (chunks of 192 or 256).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.util import (
    ConfigRejected,
    check_operand,
    max_shared_memory_per_block,
    sm_count,
)

__all__ = ["tiled_matmul", "tiled_matmul_plain", "tiled_matmul_check",
           "matmul_tile_check", "matmul_smem_bytes", "matmul_splits", "reset_route_counts",
           "ROUTES"]

DTYPES = (torch.float32, torch.bfloat16)
# matmul_launch's route codes, in order
ROUTES = ("ffma", "mma_sync", "wgmma", "split")


def matmul_smem_bytes(bm: int, bn: int, bk: int, dtype: torch.dtype = torch.float32,
                      limit: int | None = None) -> int:
    """Dynamic shared memory (bytes) one block of ``csrc/matmul.cu`` needs
    for this tile and input ``dtype`` (staged as it is) under a per-block
    ``limit`` (default: the current card's), or -1 for a tile its register
    tile cannot hold. The kernel's ring takes as many stages (3 down to 1) as
    fit the limit, so a result above it means even one stage does not fit.
    The kernel's own layout answers, so the library is built first."""
    if limit is None:
        limit = max_shared_memory_per_block(torch.device("cuda"))
    return build.load("matmul").matmul_smem_bytes(bm, bn, bk, int(dtype == torch.bfloat16),
                                                  int(limit))


def matmul_splits(M: int, K: int, N: int, *, bm: int, bn: int, bk: int = 32,
                  pack: bool = True, dtype: torch.dtype = torch.float32,
                  device: torch.device | None = None) -> int:
    """CTAs the split route (tiles of at most 8 rows) puts on one column
    tile of an (M, K) @ (K, N) product of ``dtype`` operands on ``device``
    (default: the current card), the tiles already clamped to the shape: 1
    for pack=False or a tile past 8 rows. The kernel's own rule answers,
    from the SM count read at run time and its occupancy on the card."""
    dev = torch.device("cuda") if device is None else device
    return build.load("matmul").matmul_splits(M, K, N, bm, bn, bk, int(pack),
                                              int(dtype == torch.bfloat16), sm_count(dev))


def tiled_matmul_plain(a: torch.Tensor, b: torch.Tensor, *, bk: int, pack: bool,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """The plain version, with the kernel's arithmetic: f32 products, and
    with ``pack=False`` one rounding to ``out_dtype`` per ``bk`` chunk and
    per accumulation step, as the read-modify-write does."""
    af, bf = a.float(), b.float()
    if pack:
        return (af @ bf).to(out_dtype)
    K = a.shape[1]
    o = torch.zeros(a.shape[0], b.shape[1], dtype=out_dtype, device=a.device)
    for k0 in range(0, K, bk):
        part = (af[:, k0:k0 + bk] @ bf[k0:k0 + bk]).to(out_dtype)
        o = (o.float() + part.float()).to(out_dtype)
    return o


def tiled_matmul_check(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bn: int = 128,
                       bk: int = 128,
                       out_dtype: torch.dtype | None = None) -> tuple[int, int, int]:
    """The wrapper's checks before a launch, without launching: operands
    (shape, dtype, device, contiguity) and, on the card, the tile against
    the register tile and the device's shared memory per block. Raises
    :class:`ConfigRejected` for a tile the kernel cannot run; returns the
    clamped ``(bm, bn, bk)``."""
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"tiled_matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device.type != "cpu":
        dev = a.device
        check_operand("a", a, (M, K), DTYPES, dev)
        check_operand("b", b, (K, N), (a.dtype,), dev)
        if (out_dtype or a.dtype) not in DTYPES:
            raise TypeError(f"tiled_matmul out_dtype {out_dtype} not in {DTYPES}")
    return matmul_tile_check(M, K, N, bm=bm, bn=bn, bk=bk, dtype=a.dtype, device=a.device)


def matmul_tile_check(M: int, K: int, N: int, *, bm: int, bn: int, bk: int,
                      dtype: torch.dtype, device: torch.device) -> tuple[int, int, int]:
    """The tile's part of :func:`tiled_matmul_check` for an (M, K) @ (K, N)
    product of ``dtype`` inputs on ``device``: positive tiles, clamped to
    the shape and, on the card, held against the register tile and the
    device's shared memory per block. Returns the clamped ``(bm, bn, bk)``."""
    if int(bm) < 1 or int(bn) < 1 or int(bk) < 1:
        raise ConfigRejected(f"tiled_matmul tiles must be positive, got {bm}x{bn}x{bk}")
    bm, bn, bk = min(int(bm), max(M, 1)), min(int(bn), max(N, 1)), min(int(bk), max(K, 1))
    if device.type == "cpu":
        return bm, bn, bk
    limit = max_shared_memory_per_block(device)
    smem = matmul_smem_bytes(bm, bn, bk, dtype, limit)
    if smem < 0:
        raise ConfigRejected(f"matmul tile {bm}x{bn} does not fit the kernel's register tile")
    if smem > limit:
        raise ConfigRejected(f"matmul bm={bm} bn={bn} bk={bk} needs {smem} B of "
                             f"shared memory, the device allows {limit} B per block")
    return bm, bn, bk


def tiled_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    bm: int = 128,
    bn: int = 128,
    bk: int = 128,
    interchange: bool = False,
    pack: bool = True,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """C = A @ B. Shapes need not be multiples of the tiles (the kernel masks
    the ragged edges)."""
    bm, bn, bk = tiled_matmul_check(a, b, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype)
    M, K = a.shape
    N = b.shape[1]
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return tiled_matmul_plain(a, b, bk=bk, pack=pack, out_dtype=out_dtype)

    dev = a.device
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    lib = build.load("matmul")
    route = ctypes.c_longlong(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.mark_launch()
        err = lib.matmul_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N, bm, bn, bk,
            int(pack), int(interchange), int(a.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), max_shared_memory_per_block(dev),
            sm_count(dev), stream, ctypes.byref(route))
    build.check(lib, err, "tiled_matmul")
    tiled_matmul.launches += 1
    taken = ROUTES[route.value]  # the route the kernel took
    tiled_matmul.route_launches[taken] += 1
    if a.dtype == torch.bfloat16 and taken in ("mma_sync", "wgmma"):
        tiled_matmul.bf16_tc_launches += 1
    return out


def reset_route_counts() -> None:
    """Zero ``tiled_matmul``'s per-route counts (its ``launches`` too is
    reset by whoever reads it)."""
    tiled_matmul.route_launches = dict.fromkeys(ROUTES, 0)
    tiled_matmul.bf16_tc_launches = 0


tiled_matmul.launches = 0  # kernel launches since the last reset (chip_smoke reads it)
# of them, by the route matmul_launch reports, and the bf16 ones on the
# tensor cores (wgmma or mma.sync)
tiled_matmul.route_launches = dict.fromkeys(ROUTES, 0)
tiled_matmul.bf16_tc_launches = 0
