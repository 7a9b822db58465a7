"""Blocked LU decomposition without pivoting (the paper's Sec. 4.3).

Right-looking blocked algorithm with block size ``bs``, as in
``repro.kernels.lu``; per block step:

  (a) factor the bs x bs diagonal block in place (unblocked Doolittle):
      :func:`lu_factor_diag`, on the card one launch of the single-block
      helper in ``csrc/lu.cu`` (up to bs = 128 the block in registers, one
      barrier a row step; past it in shared memory), on the CPU
      :func:`lu_factor_diag_plain`;
  (b) row panel  U12 = L11^-1 A12 and column panel L21 = A21 U11^-1, with
      ``torch.linalg.solve_triangular`` (plain array code in the JAX
      package too, outside any Pallas kernel);
  (c) trailing update A22 -= L21 @ U12 through
      :func:`~repro_torch.kernels.matmul.tiled_matmul` (``bk = bs``), the
      tuned kernel.

Only the active trailing block (N - off - bs)^2 is updated. The JAX package
needs static shapes, so it runs a full-extent GEMM on masked panels; the
masked rows and columns there are exact zeros, so every entry gets the same
terms in the same order here, at 2/3 N^3 flops instead of 2 N^3. Knobs:
``bs`` (panel), ``bm``/``bn`` (trailing-GEMM tiles), ``pack`` (GEMM packing).
``lu`` works on a copy: its input is never written.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.matmul import matmul_tile_check, tiled_matmul, tiled_matmul_plain
from repro_torch.kernels.util import (
    ConfigRejected,
    cdiv,
    check_operand,
    max_shared_memory_per_block,
)

__all__ = ["lu", "lu_check", "lu_plain", "lu_factor_diag", "lu_factor_diag_plain",
           "lu_factor_diag_smem_bytes"]


def lu_factor_diag_smem_bytes(bs: int) -> int:
    """Shared memory (bytes) the diagonal-block helper's block uses for a
    bs x bs block (past bs = 128 the whole block, row stride bs + 1). The
    kernel's own layout answers, so the library is built first."""
    return build.load("lu").lu_factor_diag_smem_bytes(bs)


def lu_factor_diag_plain(D: torch.Tensor) -> torch.Tensor:
    """The plain unblocked Doolittle on a bs x bs block (a new tensor): the
    arithmetic of ``repro.kernels.lu._factor_diag``, row step by row step."""
    M = D.clone()
    for r in range(M.shape[0] - 1):
        M[r + 1:, r] /= M[r, r]
        M[r + 1:, r + 1:] -= torch.outer(M[r + 1:, r], M[r, r + 1:])
    return M


def _factor_plain_in_place(A, off, bs):
    A[off:off + bs, off:off + bs] = lu_factor_diag_plain(A[off:off + bs, off:off + bs])


def _diag_check(bs: int, limit: int) -> None:
    smem = lu_factor_diag_smem_bytes(bs)
    if smem > limit:
        raise ConfigRejected(f"lu bs={bs} needs {smem} B of shared memory for its diagonal "
                             f"block, the device allows {limit} B per block")


def lu_factor_diag(A: torch.Tensor, off: int, bs: int) -> None:
    """Factor the bs x bs diagonal block of the square matrix A at (off, off)
    in place. On the card: one launch of the single-block helper."""
    if A.dtype != torch.float32:
        raise TypeError(f"lu is f32 only, got {A.dtype}")
    Np = A.shape[0]
    if A.dim() != 2 or A.shape[1] != Np or not 0 <= off <= Np - bs:
        raise ValueError(f"lu_factor_diag: block ({off}, {bs}) of {tuple(A.shape)}")
    if A.device.type == "cpu":
        _factor_plain_in_place(A, off, bs)
        return
    dev = A.device
    check_operand("A", A, (Np, Np), (torch.float32,), dev)
    _diag_check(bs, max_shared_memory_per_block(dev))
    lib = build.load("lu")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lu_factor_diag_launch(A.data_ptr(), Np, off, bs, stream)
    build.check(lib, err, "lu_factor_diag")
    lu_factor_diag.launches += 1


lu_factor_diag.launches = 0  # kernel launches since the last reset (chip_smoke reads it)


def _blocked(A, bs, factor, matmul):
    """Right-looking blocked LU on a padded copy of A; ``factor`` and
    ``matmul`` are the kernels' wrappers or their plain versions."""
    N = A.shape[0]
    bs = min(bs, N)
    Np = cdiv(N, bs) * bs
    M = torch.zeros((Np, Np), dtype=A.dtype, device=A.device)
    M[:N, :N] = A
    if Np != N:  # the padded diagonal is the identity: padding stays outside A
        idx = torch.arange(N, Np, device=A.device)
        M[idx, idx] = 1.0
    for off in range(0, Np, bs):
        end = off + bs
        factor(M, off, bs)
        if end == Np:
            break
        D = M[off:end, off:end]
        U12 = torch.linalg.solve_triangular(D, M[off:end, end:], upper=False,
                                            unitriangular=True).contiguous()
        L21 = torch.linalg.solve_triangular(D, M[end:, off:end], upper=True,
                                            left=False).contiguous()
        M[off:end, end:] = U12
        M[end:, off:end] = L21
        M[end:, end:] -= matmul(L21, U12)
    return M[:N, :N].contiguous()


def lu_check(A: torch.Tensor, *, bs: int = 32, bm: int = 128, bn: int = 128) -> None:
    """The wrapper's checks before its first launch, without launching: a
    square f32 matrix and, on the card, the operand, the diagonal block's
    shared memory and the trailing GEMM's tile at its largest (the first
    step's) against the register tile and the device's limit. Raises
    :class:`ConfigRejected` for a schedule the kernels cannot run."""
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"lu needs a square matrix, got {tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise TypeError(f"lu is f32 only, got {A.dtype}")
    if int(bs) < 1 or int(bm) < 1 or int(bn) < 1:
        raise ConfigRejected(f"lu tiles must be positive, got bs={bs} bm={bm} bn={bn}")
    if A.device.type == "cpu":
        return
    dev = A.device
    N = A.shape[0]
    check_operand("A", A, (N, N), (torch.float32,), dev)
    bs = min(int(bs), N)
    limit = max_shared_memory_per_block(dev)
    _diag_check(bs, limit)
    rest = cdiv(N, bs) * bs - bs  # the first trailing update's rows and columns
    if rest > 0:
        matmul_tile_check(rest, bs, rest, bm=bm, bn=bn, bk=bs, dtype=torch.float32,
                          device=dev)


def lu(
    A: torch.Tensor,
    *,
    bs: int = 32,
    bm: int = 128,
    bn: int = 128,
    pack: bool = True,
) -> torch.Tensor:
    """Packed LU of A (N x N): L strictly below the diagonal (unit implied),
    U on and above it. Matches ``ref.lu_ref``."""
    lu_check(A, bs=bs, bm=bm, bn=bn)
    bk = min(bs, A.shape[0])
    return _blocked(A, bs, lu_factor_diag,
                    lambda L, U: tiled_matmul(L, U, bm=bm, bn=bn, bk=bk, pack=pack))


def lu_plain(A: torch.Tensor, *, bs: int = 32, pack: bool = True) -> torch.Tensor:
    """The blocked schedule with the plain versions, on any device."""
    bk = min(bs, A.shape[0])
    return _blocked(A, bs, _factor_plain_in_place,
                    lambda L, U: tiled_matmul_plain(L, U, bk=bk, pack=pack,
                                                    out_dtype=torch.float32))
