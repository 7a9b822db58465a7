"""Blocked Floyd-Warshall in the (min, +) semiring (the paper's Sec. 4.6).

The classic three-phase blocked algorithm, as in
``repro.kernels.floyd_warshall``; per block round ``kb``:

  phase 1  diagonal block closure (in-block Floyd-Warshall), in place:
           :func:`closure_in_block`, one launch of a helper that holds the
           block in registers (one warp, one CTA, or past bs = 128 a
           thread-block cluster; past 256 one CTA on the block in global
           memory);
  phase 2  row panel  D[kb,:] = min(D[kb,:], D[kb,kb] (x) D[kb,:]),
           col panel  D[:,kb] = min(D[:,kb], D[:,kb] (x) D[kb,kb]);
  phase 3  trailing   D       = min(D, D[:,kb] (x) D[kb,:]).

Every product of phases 2 and 3 is :func:`minplus_update`, which launches
the hand-written CUDA kernel ``csrc/floyd_warshall.cu`` for tensors on the
card and takes the plain version :func:`minplus_update_plain` only for
tensors on the CPU; so does :func:`closure_in_block` with
:func:`closure_plain`. Knobs (the JAX package's): ``bs`` (block), ``bi``/``bj``
(phase-3 tiles), ``unroll`` (the unroll factor of the kernel's k loop, a
template parameter of the CUDA kernel).

The driver works on views of one padded distance matrix and copies only the
closed diagonal block each round: both panels are updated in place, each as
one row of tiles that spans the panel's whole ``bs`` side (so no block reads
another block's tile; the long side is cut into :data:`PANEL_TILE`-wide
tiles, so that a panel is many blocks on the card, where the JAX package
takes the whole panel), and the trailing update goes from the matrix into a
second buffer, which becomes the matrix of the next round.

``allow_semiring_reassociation=True`` is mandatory to run the blocked
schedule — the caller-visible analog of ``-polly-pragma-ignore-depcheck``.
Min is exact and every candidate path length is one rounded add whatever
the tiles, so the kernels and their plain versions agree bit for bit.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.util import (
    ConfigRejected,
    check_operand,
    max_shared_memory_per_block,
    pad_to,
)

__all__ = ["floyd_warshall", "floyd_warshall_check", "floyd_warshall_plain", "minplus_update",
           "minplus_update_plain", "closure_in_block", "closure_plain",
           "minplus_smem_bytes"]

_BIG = 1.0e18  # padding distance: an +inf surrogate that survives addition
MAX_TILE = 256  # csrc/floyd_warshall.cu's largest tile extent (at most 256 threads a block)
PANEL_TILE = 16  # the long-side tile of the driver's phase-2 panels
UNROLLS = (1, 2, 4, 8)  # the k-loop unroll factors the kernel is instantiated for


def minplus_smem_bytes(bi: int, bj: int, bs: int, limit: int | None = None) -> int:
    """Dynamic shared memory (bytes) one block of the min-plus kernel needs
    for this tile and contraction width under a per-block ``limit``
    (default: the current card's), or -1 for a tile the kernel does not take
    (an extent past 256, or more than 256 threads). The ring of chunks is as
    deep as fits the limit, so a result above it means even one stage does
    not fit. The kernel's own layout answers, so the library is built
    first."""
    if limit is None:
        limit = max_shared_memory_per_block(torch.device("cuda"))
    return _smem_bytes(int(bi), int(bj), int(bs), int(limit))


@functools.lru_cache(maxsize=4096)
def _smem_bytes(bi: int, bj: int, bs: int, limit: int) -> int:
    return build.load("floyd_warshall").minplus_smem_bytes(bi, bj, bs, limit)


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


def _span(t: torch.Tensor) -> tuple[int, int]:
    """[first, last] byte addresses a 2-D view touches."""
    last = (t.shape[0] - 1) * t.stride(0) + (t.shape[1] - 1) * t.stride(1)
    return t.data_ptr(), t.data_ptr() + 4 * last


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.data_ptr() == b.data_ptr() and a.shape == b.shape and a.stride() == b.stride()


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    (a0, a1), (b0, b1) = _span(a), _span(b)
    return a0 <= b1 and b0 <= a1


def _check_view(name: str, t: torch.Tensor, shape: tuple[int, int], dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if t.stride(1) != 1 or t.stride(0) < shape[1]:
        raise ValueError(f"{name} must be a row-major view with unit column stride, "
                         f"got strides {t.stride()}")


def _check_aliasing(D, A, B, out, bi: int, bj: int) -> None:
    """The kernel's in-place rule: ``out`` is ``D`` itself or apart from it,
    and overlaps ``A`` (``B``) only as the same view with one tile spanning
    all its columns (rows), so no block reads another block's tile."""
    n, m = out.shape
    if _overlap(out, D) and not _same_view(out, D):
        raise ValueError("minplus_update: out overlaps D without being D")
    if _overlap(out, A) and not (_same_view(out, A) and bj >= m):
        raise ValueError("minplus_update: out may be A only as the same view with bj >= m")
    if _overlap(out, B) and not (_same_view(out, B) and bi >= n):
        raise ValueError("minplus_update: out may be B only as the same view with bi >= n")


def _launch(D, A, B, out, bi: int, bj: int, unroll: int, limit: int, stream: int) -> None:
    """One launch of the min-plus kernel on checked views; counts it."""
    n, m = D.shape
    lib = build.load("floyd_warshall")
    err = lib.minplus_launch(D.data_ptr(), D.stride(0), A.data_ptr(), A.stride(0),
                             B.data_ptr(), B.stride(0), out.data_ptr(), out.stride(0),
                             n, m, A.shape[1], bi, bj, unroll, limit, stream)
    build.check(lib, err, "minplus_update")
    minplus_update.launches += 1


def _tile_check(bi: int, bj: int, bs: int, limit: int) -> None:
    smem = _smem_bytes(bi, bj, bs, limit)
    if smem < 0:
        raise ConfigRejected(f"minplus tile {bi}x{bj}: the kernel takes extents up to "
                             f"{MAX_TILE} and at most 256 threads (an 8x8 register tile each)")
    if smem > limit:
        raise ConfigRejected(f"minplus bi={bi} bj={bj} bs={bs} needs {smem} B of shared "
                             f"memory, the device allows {limit} B per block")


def minplus_update(
    D: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    *,
    bi: int = 128,
    bj: int = 128,
    unroll: int = 1,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """min(D, A (x) B): D (n x m), A (n x bs), B (bs x m); one k-block deep.
    Operands may be row-major views (unit column stride, any row stride).
    Writes ``out`` (a fresh tensor by default) and returns it; ``out`` may
    be ``D`` itself, and may be ``A`` (``B``) as well where one tile spans
    all of its columns (rows), as the blocked driver's panels do."""
    n, m = D.shape
    bs = A.shape[1]
    if tuple(A.shape) != (n, bs) or tuple(B.shape) != (bs, m):
        raise ValueError(f"minplus_update shapes: D {tuple(D.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}")
    if unroll not in UNROLLS:
        raise ValueError(f"unroll must be one of {UNROLLS}, got {unroll}")
    _check_f32(D, A, B)
    if out is not None:
        _check_f32(out)
        if tuple(out.shape) != (n, m):
            raise ValueError(f"minplus_update out has shape {tuple(out.shape)}, want {(n, m)}")
    bi, bj = min(bi, n), min(bj, m)
    if D.device.type == "cpu":
        res = minplus_update_plain(D, A, B)
        return res if out is None else out.copy_(res)

    dev = D.device
    for name, t, shape in (("D", D, (n, m)), ("A", A, (n, bs)), ("B", B, (bs, m))):
        _check_view(name, t, shape, dev)
    if out is None:
        out = torch.empty((n, m), dtype=torch.float32, device=dev)
    _check_view("out", out, (n, m), dev)
    _check_aliasing(D, A, B, out, bi, bj)
    limit = max_shared_memory_per_block(dev)
    _tile_check(bi, bj, bs, limit)
    with torch.cuda.device(dev):
        _launch(D, A, B, out, bi, bj, unroll, limit, torch.cuda.current_stream(dev).cuda_stream)
    return out


minplus_update.launches = 0  # kernel launches since the last reset (chip_smoke reads it)


def closure_in_block(D: torch.Tensor, off: int, bs: int) -> None:
    """Close the bs x bs diagonal block of the square matrix D at (off, off)
    in place (phase 1). On the card: one launch of the helper (a warp up to
    bs = 32, one CTA up to 128, a cluster of CTAs up to 256, past it one CTA
    on the block in global memory)."""
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
    """The three-phase schedule over ``nb`` block rounds; ``minplus(D, A, B,
    bi, bj, out)`` and ``closure`` are the kernels' launchers or their plain
    versions. Phase 2 runs in place on views of the padded matrix; phase 3
    writes a second buffer, which becomes the matrix (ping-pong)."""
    N = path.shape[0]
    bs = min(bs, N)
    D = pad_to(path, (bs, bs), value=_BIG)
    if D is path:
        D = path.clone()  # the closure works in place; the input is never written
    Np = D.shape[0]
    E = torch.empty_like(D)
    pt = min(PANEL_TILE, Np)  # the panels' long-side tile
    for off in range(0, Np, bs):
        end = off + bs
        # phase 1. In place is exact: D[k, k] >= 0, so step k leaves row and
        # column k as they are, and the sweep reads nothing it has changed.
        closure(D, off, bs)
        diag = D[off:end, off:end].clone(memory_format=torch.contiguous_format)
        # phase 2, in place: each tile spans the panel's bs side, so a block
        # reads no other block's tile
        row = D[off:end]
        minplus(row, diag, row, bs, pt, row)
        col = D[:, off:end]
        minplus(col, col, diag, pt, bs, col)
        # phase 3: the trailing update, into the other buffer
        minplus(D, col, row, bi, bj, E)
        D, E = E, D
    return D[:N, :N].contiguous()


def floyd_warshall_check(path: torch.Tensor, *, bs: int = 64, bi: int = 128, bj: int = 128,
                         unroll: int = 1) -> tuple[int, int]:
    """The wrapper's checks before a launch, without launching: dtype,
    ``unroll`` and, on the card, the operand and the three tiles a round
    launches (the trailing ``bi`` x ``bj`` and the two panels') against the
    kernel's extents and the device's shared memory per block. Raises
    :class:`ConfigRejected` for a tile the kernel cannot run; returns the
    clamped ``(bi, bj)`` of the trailing update."""
    _check_f32(path)
    if unroll not in UNROLLS:
        raise ConfigRejected(f"unroll must be one of {UNROLLS}, got {unroll}")
    if int(bs) < 1 or int(bi) < 1 or int(bj) < 1:
        raise ConfigRejected(f"floyd_warshall tiles must be positive, got bs={bs} bi={bi} "
                             f"bj={bj}")
    N = path.shape[0]
    bsc = min(int(bs), N)
    Np = -(-N // bsc) * bsc
    bi, bj, pt = min(int(bi), Np), min(int(bj), Np), min(PANEL_TILE, Np)
    if path.device.type == "cpu":
        return bi, bj
    dev = path.device
    check_operand("path", path, (N, N), (torch.float32,), dev)
    limit = max_shared_memory_per_block(dev)
    for ti, tj in ((bi, bj), (bsc, pt), (pt, bsc)):
        _tile_check(ti, tj, bsc, limit)
    return bi, bj


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
    bi, bj = floyd_warshall_check(path, bs=bs, bi=bi, bj=bj, unroll=unroll)
    if path.device.type == "cpu":
        return floyd_warshall_plain(path, bs=bs)

    # on the card: the tiles are checked once, then every launch goes
    # straight to the kernels on the current stream
    dev = path.device
    limit = max_shared_memory_per_block(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream

        def minplus(D, A, B, ti, tj, out):
            _launch(D, A, B, out, ti, tj, unroll, limit, stream)

        return _blocked(path, bs, bi, bj, minplus, closure_in_block)


def floyd_warshall_plain(path: torch.Tensor, *, bs: int = 64) -> torch.Tensor:
    """The blocked schedule with the plain versions, on any device: the
    kernels' result bit for bit at the same ``bs``."""

    def minplus(D, A, B, bi, bj, out):
        out.copy_(minplus_update_plain(D, A, B))

    return _blocked(path, bs, 0, 0, minplus, _closure_plain_in_place)
