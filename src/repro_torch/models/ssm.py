"""Mamba2 (SSD — state-space duality) block: chunked parallel form for
training/prefill and O(1)-state recurrence for decode — the counterpart of
``repro.models.ssm``.

The chunked SSD algorithm is a blocked matrix program (intra-chunk
"attention-like" diagonal blocks + inter-chunk state recurrence); ``chunk``
is its tile size. Everything here is plain tensor operations, as in the
JAX package (no Pallas kernel there). The recurrent state (the conv window
and the SSM state) is f32 whatever the config's dtype, and
:func:`mamba2_decode` updates it in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.common import (
    dense_init,
    einsum,
    matmul,
    replicate_like,
    reshape,
    rms_norm,
)

__all__ = ["init_mamba2", "mamba2_forward", "mamba2_decode", "init_ssm_cache", "ssd"]


# ---------------------------------------------------------------------------
# chunked SSD core
# ---------------------------------------------------------------------------


def _linear_on_shards(fn, t: DTensor) -> DTensor:
    """``fn`` (linear, along dims no placement of ``t`` shards) on each
    device's shard of ``t``: a partial sum stays one, and its gradient is
    the whole gradient on every device."""
    pl = t.placements
    grad = [Replicate() if p.is_partial() else p for p in pl]
    return DTensor.from_local(fn(t.to_local(grad_placements=grad)), t.device_mesh, pl,
                              run_check=False)


def _pad(t: torch.Tensor, pad: tuple) -> torch.Tensor:
    """``F.pad(t, pad)`` (with zeros); a DTensor whose padded dims are not
    sharded is padded on each device's shard (torch 2.11 has no DTensor rule
    for ``pad``)."""
    if isinstance(t, DTensor):
        dims = {t.ndim - 1 - i // 2 for i, n in enumerate(pad) if n}
        if not any(p.is_shard() and p.dim in dims for p in t.placements):
            return _linear_on_shards(lambda x: F.pad(x, pad), t)
    return F.pad(t, pad)


def _cumsum(t: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum`` over the last dim; a DTensor whose last dim is not
    sharded sums on each device's shard (torch 2.11 has no DTensor rule for
    the backward's ``flip``)."""
    if isinstance(t, DTensor) and not any(p.is_shard(t.ndim - 1) for p in t.placements):
        return _linear_on_shards(lambda x: torch.cumsum(x, dim=-1), t)
    return torch.cumsum(t, dim=-1)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L); out[i, j] = sum_{j < t <= i} a[t], -inf above
    the diagonal (exp turns it into an exact 0)."""
    L = a.shape[-1]
    cs = _cumsum(a)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = replicate_like(torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device)),
                          diff)
    return diff.masked_fill(~mask, float("-inf"))


def ssd(x, dt, A, B, C, chunk: int = 64, initial_state=None):
    """Chunked state-space-dual scan.

    x: (b, s, H, P); dt: (b, s, H) (already softplus'd); A: (H,) negative;
    B, C: (b, s, N) (single group, broadcast over heads).
    Returns (y: (b, s, H, P) in x's dtype, final_state: (b, H, P, N) f32).
    """
    b, s, H, P = x.shape
    N = B.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"ssd: sequence length {s} is not a multiple of the chunk {chunk}")
    c = s // chunk

    f32 = torch.float32
    Xd = reshape((x * dt[..., None]).to(f32), b, c, chunk, H, P)
    Ad = reshape((dt * A[None, None, :]).to(f32), b, c, chunk, H)
    Ad = Ad.permute(0, 3, 1, 2)                         # (b, H, c, L)
    Bc = reshape(B.to(f32), b, c, chunk, N)
    Cc = reshape(C.to(f32), b, c, chunk, N)

    A_cum = _cumsum(Ad)                                 # (b, H, c, L)

    # 1) intra-chunk (diagonal blocks). The reference's one five-operand
    # einsum, contracted as C.B^T over N first (b, c, L, L), times the decay
    # mask (b, H, c, L, L), then against X over the chunk's positions: the
    # largest intermediate is (b, H, c, L, L), never (b, c, L, L, H, P)
    Lmat = torch.exp(_segsum(Ad))                       # (b, H, c, L, L)
    CB = einsum("bcln,bcsn->bcls", Cc, Bc)
    M = CB[:, None] * Lmat                              # (b, H, c, L, L)
    Y_diag = einsum("bhcls,bcshp->bclhp", M, Xd)

    # 2) chunk-final states: X weighted by its decay to the chunk's end,
    # then against B over the chunk's positions
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)   # (b, H, c, L)
    Xw = Xd * decay_states.permute(0, 2, 3, 1)[..., None]
    states = einsum("bclhp,bcln->bchpn", Xw, Bc)

    # 3) inter-chunk recurrence
    if initial_state is None:
        initial_state = states.new_zeros((b, H, P, N))
    states = torch.cat([initial_state[:, None].to(f32), states], dim=1)
    chunk_sums = _pad(A_cum[..., -1], (1, 0))           # (b, H, c+1)
    decay_chunk = torch.exp(_segsum(chunk_sums))        # (b, H, c+1, c+1)
    new_states = einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states_prev, final_state = new_states[:, :-1], new_states[:, -1]

    # 4) state -> output contribution: C against the carried state, then
    # the decay from the chunk's start
    out_decay = torch.exp(A_cum)                        # (b, H, c, L)
    Y_off = einsum("bcln,bchpn->bclhp", Cc, states_prev)
    Y_off = Y_off * out_decay.permute(0, 2, 3, 1)[..., None]

    y = reshape(Y_diag + Y_off, b, s, H, P)
    return y.to(x.dtype), final_state


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------


def _dims(d_model: int, expand: int, head_dim: int, n_state: int):
    d_in = expand * d_model
    H = d_in // head_dim
    conv_dim = d_in + 2 * n_state
    return d_in, H, conv_dim


def init_mamba2(generator: torch.Generator, d_model: int, *, expand: int = 2,
                head_dim: int = 64, n_state: int = 128, conv_width: int = 4,
                dtype=torch.bfloat16) -> dict:
    """The projections in ``dtype``; the conv, A, D, dt bias and norm in
    f32, as in the JAX package."""
    d_in, H, conv_dim = _dims(d_model, expand, head_dim, n_state)
    dev = generator.device
    proj_out = 2 * d_in + 2 * n_state + H
    return {
        "in_proj": dense_init((d_model, proj_out), generator, 0, dtype),
        "conv_w": dense_init((conv_width, conv_dim), generator, 0, torch.float32),
        "conv_b": torch.zeros(conv_dim, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
        "D": torch.ones(H, device=dev),
        "dt_bias": torch.zeros(H, device=dev),
        "norm": torch.zeros(d_in, device=dev),
        "out_proj": dense_init((d_in, d_model), generator, 0, dtype),
    }


def _split_proj(zxbcdt, d_in: int, n_state: int, H: int):
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in: 2 * d_in + 2 * n_state]
    dt = zxbcdt[..., 2 * d_in + 2 * n_state:]
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S. xBC: (B, S, Cd); w: (cw, Cd)."""
    cw = w.shape[0]
    S = xBC.shape[1]
    x32 = xBC.float()
    out = x32 * w[-1]
    padded = _pad(x32, (0, 0, cw - 1, 0))
    for i in range(cw - 1):
        out = out + padded[:, i: i + S, :] * w[i]
    return F.silu(out + b).to(xBC.dtype)


def mamba2_forward(p: dict, x: torch.Tensor, cfg, chunk: int = 64) -> torch.Tensor:
    """x: (B, S, d_model) -> (B, S, d_model)."""
    d_in, H, _ = _dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim, cfg.ssm_state)
    N, P = cfg.ssm_state, cfg.ssm_head_dim

    z, xBC, dt = _split_proj(matmul(x, p["in_proj"]), d_in, N, H)
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xs = xBC[..., :d_in]
    Bmat = xBC[..., d_in: d_in + N]
    Cmat = xBC[..., d_in + N:]

    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    B_, S_, _ = x.shape
    xh = reshape(xs, B_, S_, H, P)
    y, _ = ssd(xh, dt, A, Bmat, Cmat, chunk=chunk)
    y = y + xh.float().to(y.dtype) * p["D"][None, None, :, None].to(y.dtype)

    y = reshape(y, B_, S_, d_in)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"])
    return matmul(y, p["out_proj"])


# ---------------------------------------------------------------------------
# decode path (single token, recurrent)
# ---------------------------------------------------------------------------


def init_ssm_cache(cfg, B: int, dtype=torch.float32, device=None) -> dict:
    d_in, H, conv_dim = _dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim, cfg.ssm_state)
    return {
        "conv": torch.zeros((B, cfg.ssm_conv_width - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((B, H, cfg.ssm_head_dim, cfg.ssm_state), dtype=dtype, device=device),
    }


def mamba2_decode(p: dict, x: torch.Tensor, cache: dict, cfg) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, d_model); cache: {conv: (B, cw-1, Cd), ssm: (B, H, P, N)},
    updated in place (the JAX package returns a new one). Returns (out
    (B, 1, d_model), cache)."""
    d_in, H, _ = _dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim, cfg.ssm_state)
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    B_ = x.shape[0]

    z, xBC, dt = _split_proj(matmul(x, p["in_proj"])[:, 0, :], d_in, N, H)

    # the window is a new tensor, so the shifted copy into the cache aliases
    # nothing this step still reads: the oldest column drops, the new goes last
    conv = cache["conv"]
    window = torch.cat([conv, xBC[:, None, :].to(conv.dtype)], dim=1)
    conv_out = einsum("bwc,wc->bc", window.float(), p["conv_w"]) + p["conv_b"]
    conv.copy_(window[:, 1:])
    xBC = F.silu(conv_out)

    xs = xBC[..., :d_in]
    Bmat = xBC[..., d_in: d_in + N]                             # (B, N)
    Cmat = xBC[..., d_in + N:]

    dt = F.softplus(dt.float() + p["dt_bias"])                  # (B, H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None, :])                             # (B, H), f32

    xh = reshape(xs, B_, H, P).float()
    contrib = dt[..., None, None] * xh[..., None] * Bmat[:, None, None, :]
    state = cache["ssm"]
    state.mul_(dA[..., None, None]).add_(contrib)               # (B, H, P, N)

    y = einsum("bhpn,bn->bhp", state, Cmat.float())
    y = y + xh * p["D"][None, :, None]
    y = reshape(y, B_, 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype)[:, None, :], p["norm"])
    return matmul(y, p["out_proj"]), cache
