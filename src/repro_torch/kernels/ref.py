"""Plain-PyTorch oracles and problem data for the ported kernels.

The oracles are the PolyBench reference computations, as in
``repro.kernels.ref``. Problem data is drawn with numpy from a seed (torch
and ``jax.random`` give different numbers from one seed), so the same arrays
can be handed to both packages; :func:`to_device` carries them onto the card.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["syr2k_ref", "mm3_ref", "lu_ref", "heat3d_ref", "heat3d_masked_step",
           "covariance_ref", "floyd_warshall_ref", "init_syr2k", "init_mm3",
           "init_lu", "init_heat3d", "init_covariance", "init_floyd_warshall",
           "to_device", "problem_signature"]


# ---------------------------------------------------------------------------
# syr2k: C = alpha*A@B^T + alpha*B@A^T + beta*C   (A, B: N x M; C: N x N)
# ---------------------------------------------------------------------------


def syr2k_ref(C, A, B, alpha=1.5, beta=1.2):
    return alpha * (A @ B.T) + alpha * (B @ A.T) + beta * C


def init_syr2k(N: int, M: int, seed: int = 0):
    """f32 numpy (C, A, B); cast on the way to the device (:func:`to_device`)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, M), dtype=np.float32)
    B = rng.standard_normal((N, M), dtype=np.float32)
    C = rng.standard_normal((N, N), dtype=np.float32)
    return C, A, B


# ---------------------------------------------------------------------------
# 3mm: G = (A @ B) @ (C @ D)
# ---------------------------------------------------------------------------


def mm3_ref(A, B, C, D):
    E = A @ B
    F = C @ D
    return E @ F


def init_mm3(P: int, Q: int, R: int, S: int, T: int, seed: int = 0):
    """f32 numpy (A, B, C, D), each scaled by 1/sqrt of its column count as
    ``repro.kernels.ref.init_mm3`` does, so products stay O(1)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((P, Q), dtype=np.float32) / np.float32(np.sqrt(Q))
    B = rng.standard_normal((Q, R), dtype=np.float32) / np.float32(np.sqrt(R))
    C = rng.standard_normal((R, S), dtype=np.float32) / np.float32(np.sqrt(S))
    D = rng.standard_normal((S, T), dtype=np.float32) / np.float32(np.sqrt(T))
    return A, B, C, D


# ---------------------------------------------------------------------------
# lu: A = L*U (Doolittle, no pivoting); returns packed LU (unit L below diag)
# ---------------------------------------------------------------------------


def lu_ref(A):
    """Unblocked Doolittle, one rank-1 update per row, in f32."""
    M = A.float().clone()
    for k in range(M.shape[0] - 1):
        M[k + 1:, k] /= M[k, k]
        M[k + 1:, k + 1:] -= torch.outer(M[k + 1:, k], M[k, k + 1:])
    return M


def init_lu(N: int, seed: int = 0):
    """f32 numpy (A,): standard normal plus N*I, diagonally dominant as
    PolyBench makes it, so the factorization without pivoting is stable."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N), dtype=np.float32)
    A += np.float32(N) * np.eye(N, dtype=np.float32)
    return (A,)


# ---------------------------------------------------------------------------
# heat-3d: TSTEPS of the PolyBench 3-axis second-difference update
# ---------------------------------------------------------------------------


def heat3d_masked_step(A):
    """One masked stencil application: interior points get
    0.125*(second difference along i, j, k) + A, every other point keeps its
    value. The operations and their order are those of
    ``repro.kernels.ref._heat3d_step`` (and of the CUDA kernel)."""
    mid = A[1:-1, 1:-1, 1:-1]
    m2 = 2.0 * mid
    di = (A[2:, 1:-1, 1:-1] - m2) + A[:-2, 1:-1, 1:-1]
    dj = (A[1:-1, 2:, 1:-1] - m2) + A[1:-1, :-2, 1:-1]
    dk = (A[1:-1, 1:-1, 2:] - m2) + A[1:-1, 1:-1, :-2]
    out = A.clone()
    out[1:-1, 1:-1, 1:-1] = ((0.125 * di + 0.125 * dj) + 0.125 * dk) + mid
    return out


def heat3d_ref(A, tsteps: int):
    # PolyBench alternates A->B->A; with the masked update each pass is the
    # same operator, so 2*tsteps masked applications reproduce it.
    for _ in range(2 * tsteps):
        A = heat3d_masked_step(A)
    return A


def init_heat3d(N: int, seed: int = 0):
    """f32 numpy (A,): an N^3 grid, uniform in [0, 1)."""
    rng = np.random.default_rng(seed)
    return (rng.random((N, N, N), dtype=np.float32),)


# ---------------------------------------------------------------------------
# covariance: data (N points x M attrs) -> cov (M x M)
# ---------------------------------------------------------------------------


def covariance_ref(data):
    N = data.shape[0]
    c = data - data.mean(0, keepdim=True)
    return (c.T @ c) / (N - 1.0)


def init_covariance(N: int, M: int, seed: int = 0):
    """f32 numpy (data,): N points of M attributes, standard normal."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, M), dtype=np.float32),)


# ---------------------------------------------------------------------------
# floyd-warshall: all-pairs shortest paths, min-plus relaxation over k
# ---------------------------------------------------------------------------


def floyd_warshall_ref(path):
    D = path
    for k in range(D.shape[0]):
        D = torch.minimum(D, D[:, k:k + 1] + D[k:k + 1, :])
    return D


def init_floyd_warshall(N: int, seed: int = 0):
    """f32 numpy (w,): edge costs uniform in [1, 10), zero diagonal."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(1.0, 10.0, (N, N)).astype(np.float32)
    np.fill_diagonal(w, 0.0)
    return (w,)


def to_device(arrays, device, dtype: torch.dtype | None = None) -> tuple[torch.Tensor, ...]:
    """Carry numpy problem data (this module's ``init_*``, or the JAX
    package's arrays after ``np.asarray``) onto ``device`` as contiguous
    tensors, optionally cast to ``dtype``."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))
        out.append(t.to(device=device, dtype=dtype or torch.float32).contiguous())
    return tuple(out)


# ---------------------------------------------------------------------------
# problem signatures: paper problem dims -> per-argument shape signature,
# mirroring the init_* array shapes above. This is the SAME signature
# repro.dispatch derives from the runtime args, so configs published from
# offline campaigns (autotune CLI --store, pallas_tuning) resolve at
# dispatch() time instead of being structurally incompatible.
# ---------------------------------------------------------------------------


def problem_signature(name: str, *dims: int) -> tuple:
    if name == "syr2k":
        N, M = dims
        return ((N, N), (N, M), (N, M))
    if name == "mm3":
        P, Q, R, S, T = dims
        return ((P, Q), (Q, R), (R, S), (S, T))
    if name == "lu":
        (N,) = dims
        return ((N, N),)
    if name == "heat3d":
        N, tsteps = dims
        return ((N, N, N), (tsteps,))
    if name == "covariance":
        N, M = dims
        return ((N, M),)
    if name == "floyd_warshall":
        (N,) = dims
        return ((N, N),)
    if name == "flash_attention":
        # trailing (2,) = the static `causal=True` kwarg the service folds in
        BH, Sq, Sk, hd = dims
        return ((BH, Sq, hd), (BH, Sk, hd), (BH, Sk, hd), (2,))
    if name == "decode_attention":
        # (BH,) = per-row cur_pos; trailing (1,), (1,) = the static
        # `ring=False`/`window=0` defaults the service folds in
        BH, G, S, hd = dims
        return ((BH, G, hd), (BH, S, hd), (BH, S, hd), (BH,), (1,), (1,))
    if name == "matmul":
        M, K, N = dims
        return ((M, K), (K, N))
    raise KeyError(f"unknown kernel {name!r}")
