"""Blocked Floyd-Warshall in the (min, +) semiring (the paper's Sec. 4.6).

The classic three-phase blocked algorithm, as in
``repro.kernels.floyd_warshall``; per block round ``kb``:

  phase 1  diagonal block closure (in-block Floyd-Warshall), in place:
           :func:`closure_in_block`, one launch of a single-block helper;
  phase 2  row panel  D[kb,:] = min(D[kb,:], D[kb,kb] (x) D[kb,:]),
           col panel  D[:,kb] = min(D[:,kb], D[:,kb] (x) D[kb,kb]);
  phase 3  trailing   D       = min(D, D[:,kb] (x) D[kb,:]).

Every product of phases 2 and 3 is :func:`minplus_update`, which launches
the hand-written CUDA kernel ``csrc/floyd_warshall.cu`` for tensors on the
card and takes the plain version :func:`minplus_update_plain` only for
tensors on the CPU; so does :func:`closure_in_block` with
:func:`closure_plain`. Knobs (the JAX package's): ``bs`` (block), ``bi``/``bj``
(phase-3 tiles), ``unroll`` (the unroll factor of the kernel's k loop, a
template parameter of the CUDA kernel). The panels take the whole panel
extent as one tile side, as the JAX package does, clamped to the kernel's
register tile (:data:`MAX_TILE`).

``allow_semiring_reassociation=True`` is mandatory to run the blocked
schedule — the caller-visible analog of ``-polly-pragma-ignore-depcheck``.
Min is exact and every candidate path length is one rounded add whatever
the tiles, so the kernels and their plain versions agree bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.util import (
    ConfigRejected,
    check_operand,
    max_shared_memory_per_block,
    pad_to,
)

__all__ = ["floyd_warshall", "floyd_warshall_plain", "minplus_update",
           "minplus_update_plain", "closure_in_block", "closure_plain",
           "minplus_smem_bytes"]

_BIG = 1.0e18  # padding distance: an +inf surrogate that survives addition
MAX_TILE = 128  # csrc/floyd_warshall.cu's register tile (minplus_smem_bytes is -1 past it)
UNROLLS = (1, 2, 4, 8)  # the k-loop unroll factors the kernel is instantiated for


def minplus_smem_bytes(bi: int, bj: int, bs: int) -> int:
    """Dynamic shared memory (bytes) one block of the min-plus kernel needs
    for this tile and contraction width, or -1 for a tile its register tile
    cannot hold. The kernel's own layout answers, so the library is built
    first."""
    return build.load("floyd_warshall").minplus_smem_bytes(bi, bj, bs)


def minplus_update_plain(D, A, B) -> torch.Tensor:
    """The plain version: min(D, A (x) B), a k loop of ``torch.minimum``."""
    acc = D
    for k in range(A.shape[1]):
        acc = torch.minimum(acc, A[:, k:k + 1] + B[k:k + 1, :])
    return acc


def closure_plain(D) -> torch.Tensor:
    """The plain in-block Floyd-Warshall: ``bs`` relaxation sweeps."""
    for k in range(D.shape[0]):
        D = torch.minimum(D, D[:, k:k + 1] + D[k:k + 1, :])
    return D


def _closure_plain_in_place(D, off, bs):
    D[off:off + bs, off:off + bs] = closure_plain(D[off:off + bs, off:off + bs])


def _check_f32(*ts) -> None:
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"floyd_warshall kernels are f32 only, got {t.dtype}")


def minplus_update(
    D: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    *,
    bi: int = 128,
    bj: int = 128,
    unroll: int = 1,
) -> torch.Tensor:
    """min(D, A (x) B): D (n x m), A (n x bs), B (bs x m); one k-block deep.
    Always writes a fresh output (a caller may pass one tensor as D and B)."""
    n, m = D.shape
    bs = A.shape[1]
    if tuple(A.shape) != (n, bs) or tuple(B.shape) != (bs, m):
        raise ValueError(f"minplus_update shapes: D {tuple(D.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}")
    if unroll not in UNROLLS:
        raise ValueError(f"unroll must be one of {UNROLLS}, got {unroll}")
    _check_f32(D, A, B)
    bi, bj = min(bi, n), min(bj, m)
    if D.device.type == "cpu":
        return minplus_update_plain(D, A, B)

    dev = D.device
    for name, t, shape in (("D", D, (n, m)), ("A", A, (n, bs)), ("B", B, (bs, m))):
        check_operand(name, t, shape, (torch.float32,), dev)
    smem = minplus_smem_bytes(bi, bj, bs)
    if smem < 0:
        raise ConfigRejected(f"minplus tile {bi}x{bj} does not fit the kernel's register tile")
    limit = max_shared_memory_per_block(dev)
    if smem > limit:
        raise ConfigRejected(f"minplus bi={bi} bj={bj} needs {smem} B of shared memory, "
                             f"the device allows {limit} B per block")

    out = torch.empty_like(D)
    lib = build.load("floyd_warshall")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.minplus_launch(D.data_ptr(), A.data_ptr(), B.data_ptr(), out.data_ptr(),
                                 n, m, bs, bi, bj, unroll, stream)
    build.check(lib, err, "minplus_update")
    minplus_update.launches += 1
    return out


minplus_update.launches = 0  # kernel launches since the last reset (chip_smoke reads it)


def closure_in_block(D: torch.Tensor, off: int, bs: int) -> None:
    """Close the bs x bs diagonal block of the square matrix D at (off, off)
    in place (phase 1). On the card: one launch of the single-block helper."""
    _check_f32(D)
    Np = D.shape[0]
    if D.dim() != 2 or D.shape[1] != Np or not 0 <= off <= Np - bs:
        raise ValueError(f"closure_in_block: block ({off}, {bs}) of {tuple(D.shape)}")
    if D.device.type == "cpu":
        _closure_plain_in_place(D, off, bs)
        return
    check_operand("D", D, (Np, Np), (torch.float32,), D.device)
    lib = build.load("floyd_warshall")
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream(D.device).cuda_stream
        err = lib.closure_launch(D.data_ptr(), Np, off, bs, stream)
    build.check(lib, err, "closure_in_block")
    closure_in_block.launches += 1


closure_in_block.launches = 0  # kernel launches since the last reset (chip_smoke reads it)


def _blocked(path, bs, bi, bj, minplus, closure):
    """The three-phase schedule over ``nb`` block rounds; ``minplus`` and
    ``closure`` are the kernels' wrappers or their plain versions."""
    N = path.shape[0]
    bs = min(bs, N)
    D = pad_to(path, (bs, bs), value=_BIG)
    if D is path:
        D = path.clone()  # the closure works in place; the input is never written
    Np = D.shape[0]
    pt = min(bs, MAX_TILE)  # the panel's tile side: the whole panel, as far as it fits
    for off in range(0, Np, bs):
        end = off + bs
        # phase 1. In place is exact: D[k, k] >= 0, so step k leaves row and
        # column k as they are, and the sweep reads nothing it has changed.
        closure(D, off, bs)
        diag = D[off:end, off:end].contiguous()
        # phase 2: the row panel is a contiguous row slice, the column panel
        # is copied out; each product writes a fresh tensor
        row = minplus(D[off:end], diag, D[off:end], bi=pt, bj=bj)
        D[off:end] = row
        col = D[:, off:end].contiguous()
        col = minplus(col, col, diag, bi=bi, bj=pt)
        D[:, off:end] = col
        # phase 3: the trailing update
        D = minplus(D, col, row, bi=bi, bj=bj)
    return D[:N, :N].contiguous()


def floyd_warshall(
    path: torch.Tensor,
    *,
    bs: int = 64,
    bi: int = 128,
    bj: int = 128,
    unroll: int = 1,
    allow_semiring_reassociation: bool = False,
) -> torch.Tensor:
    """All-pairs shortest paths. The blocked schedule reorders (min, +)
    reductions, which is only legal because (min, +) is a commutative
    semiring; like Polly, this refuses unless the caller asserts it."""
    if not allow_semiring_reassociation:
        raise ValueError(
            "blocked Floyd-Warshall reassociates the (min,+) reduction; pass "
            "allow_semiring_reassociation=True (the -polly-pragma-ignore-"
            "depcheck analog) or use ref.floyd_warshall_ref"
        )
    _check_f32(path)

    def minplus(D, A, B, bi, bj):
        return minplus_update(D, A, B, bi=bi, bj=bj, unroll=unroll)

    return _blocked(path, bs, bi, bj, minplus, closure_in_block)


def floyd_warshall_plain(path: torch.Tensor, *, bs: int = 64) -> torch.Tensor:
    """The blocked schedule with the plain versions, on any device: the
    kernels' result bit for bit at the same ``bs``."""

    def minplus(D, A, B, bi, bj):
        return minplus_update_plain(D, A, B)

    return _blocked(path, bs, 0, 0, minplus, _closure_plain_in_place)
