"""Grouped-query attention: chunked training/prefill path and single-token
decode path, with sliding-window / local-global masking — the counterpart
of ``repro.models.attention``.

With a dispatch service, full (non-windowed) attention runs through the
tuned ``flash_attention`` variant and single-token decode through the tuned
``decode_attention`` variant: on the card, the hand-written CUDA kernels.
Without one, both take the chunked / dense tensor-op paths below.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import CacheRows
from repro_torch.models.common import einsum, replicate_like, reshape

__all__ = ["gqa_attention", "gqa_decode", "make_positions"]

_NEG = -1.0e30


def _service_attention(q, k, v, *, causal, service):
    """Route full (non-windowed) attention through the dispatch service's
    tuned flash-attention variant. K/V are flattened to the kernel's
    (batch*kv_heads, seq, head_dim) layout — the shape signature the service
    resolves tuned ``(bq, bk)`` tiles against — and the G query heads per kv
    head run as G calls of the one dispatched variant, so GQA never
    materializes repeated K/V copies. Returns None when the call can't be
    expressed as a flash kernel (ragged GQA grouping), letting the caller
    fall back to the chunked path."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if K == 0 or H % K:
        return None
    G = H // K
    # contiguous copies: with B = 1 the reshapes are strided views, and the
    # kernel takes contiguous operands
    kf = k.permute(0, 2, 1, 3).reshape(B * K, Sk, hd).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * K, Sk, hd).contiguous()
    # head h = k*G + g: group axis out front, kv-head axis aligned with kf
    qg = q.reshape(B, Sq, K, G, hd).permute(3, 0, 2, 1, 4)    # (G, B, K, Sq, hd)
    qg = qg.reshape(G, B * K, Sq, hd).contiguous()
    fn = service.dispatch("flash_attention", qg[0], kf, vf, causal=causal)
    og = torch.stack([fn(qg[g], kf, vf) for g in range(G)])   # (G, B*K, Sq, hd)
    out = og.reshape(G, B, K, Sq, hd).permute(1, 3, 2, 0, 4)  # (B, Sq, K, G, hd)
    return out.reshape(B, Sq, H, hd)


def _service_decode(q, k_cache, v_cache, cur_pos, *, ring, window, service):
    """Route single-token decode attention through the dispatch service's
    tuned ``decode_attention`` variant. The (B, S, K, hd) cache is handed
    over as its (B*K, S, hd) row view (:class:`CacheRows`): the kernel reads
    row ``b*K + k`` at ``(b, k)`` in place, where the JAX package's
    ``transpose(0, 2, 1, 3).reshape`` would copy the whole cache of every
    layer at every token in PyTorch. The signature is the row layout's, as
    in the JAX package. ``cur_pos`` becomes a per-row (B*K,) vector
    (continuous batching gives every sequence its own position). Returns
    None for ragged GQA grouping, letting the caller fall back to the dense
    path."""
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    if K == 0 or H % K:
        return None
    qg = q.reshape(B * K, H // K, hd)
    kf, vf = CacheRows(k_cache), CacheRows(v_cache)
    if isinstance(cur_pos, int):  # no host-device copy, no synchronisation
        cp = torch.full((B * K,), cur_pos, dtype=torch.int32, device=q.device)
    else:
        cp = torch.as_tensor(cur_pos, dtype=torch.int32, device=q.device).reshape(-1)
        cp = cp.expand(B).repeat_interleave(K)  # row b*K + k shares seq b's pos
    fn = service.dispatch("decode_attention", qg, kf, vf, cp,
                          ring=bool(ring), window=int(window or 0))
    o = fn(qg, kf, vf, cp)                      # (B*K, G, hd)
    return o.reshape(B, 1, H, hd).to(q.dtype)


def make_positions(B: int, S: int, device=None) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


def _mask(qpos, kpos, *, causal: bool, window) -> torch.Tensor:
    """qpos: (Sq,), kpos: (Sk,) -> (Sq, Sk) boolean allow-mask; a window
    of 0 or less (or None) disables the sliding window."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window is not None and int(window) > 0:
        m &= (qpos[:, None] - kpos[None, :]) < int(window)
    return m


def gqa_attention(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Sk, K, hd)
    v: torch.Tensor,            # (B, Sk, K, hd)
    *,
    causal: bool = True,
    window=None,
    chunk: int = 512,
    scale: float | None = None,
    f32: bool = True,
    service=None,
) -> torch.Tensor:
    # the dispatch path: callers pass a service only when window masking is
    # statically off (see blocks.attn_layer_train); custom scales and bf16
    # score accumulation stay on the chunked path for exact-variant parity
    if service is not None and scale is None and f32:
        out = _service_attention(q, k, v, causal=causal, service=service)
        if out is not None:
            return out
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else hd ** -0.5
    cdt = torch.float32 if f32 else q.dtype
    neg = _NEG if f32 else -6.0e4  # bf16-safe mask value

    qg = reshape(q, B, Sq, K, G, hd)
    kpos = torch.arange(Sk, device=q.device)
    kc, vc = k.to(cdt), v.to(cdt)
    chunk = min(chunk, Sq)
    outs = []
    for q0 in range(0, Sq, chunk):
        qblk = qg[:, q0:q0 + chunk]
        qpos = torch.arange(q0, q0 + qblk.shape[1], device=q.device)
        s = einsum("bqkgh,bskh->bkgqs", qblk.to(cdt), kc) * scale
        m = replicate_like(_mask(qpos, kpos, causal=causal, window=window), s)
        s = torch.where(m, s, torch.tensor(neg, dtype=cdt, device=q.device))
        p = torch.softmax(s.float(), dim=-1).to(cdt)
        outs.append(einsum("bkgqs,bskh->bqkgh", p, vc).to(q.dtype))
    return reshape(torch.cat(outs, dim=1), B, Sq, H, hd)


def gqa_decode(
    q: torch.Tensor,            # (B, 1, H, hd)
    k_cache: torch.Tensor,      # (B, S, K, hd)
    v_cache: torch.Tensor,      # (B, S, K, hd)
    cur_pos,                    # int or (B,): index of each new token
    *,
    window=None,
    ring: bool = False,
    scale: float | None = None,
    service=None,
) -> torch.Tensor:
    """One-token attention against a filled cache (positions <= cur_pos).

    ``ring=True`` treats the cache as a circular buffer of the last S tokens
    (slot j holds absolute position cur_pos - ((cur_pos - j) mod S)).
    ``cur_pos`` may be a (B,) vector (continuous batching: per-sequence
    positions). ``service`` routes the call through the tuned
    ``decode_attention`` dispatch entry (see blocks.attn_layer_decode's
    gating)."""
    if service is not None and scale is None \
            and (window is None or isinstance(window, int)):
        out = _service_decode(q, k_cache, v_cache, cur_pos, ring=ring,
                              window=window, service=service)
        if out is not None:
            return out
    B, _, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = scale if scale is not None else hd ** -0.5

    qg = reshape(q, B, K, G, hd)
    s = einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float()) * scale
    slots = torch.arange(S, device=q.device)
    # (B|1, 1) per-row positions: a scalar broadcasts over the batch
    cpb = torch.as_tensor(cur_pos, device=q.device).reshape(-1)[:, None]
    if ring:
        kpos = cpb - torch.remainder(cpb - slots[None, :], S)  # absolute positions
    else:
        kpos = slots[None, :].expand(cpb.shape[0], S)
    valid = (kpos <= cpb) & (kpos >= 0)
    if window is not None and int(window) > 0:
        valid &= (cpb - kpos) < int(window)
    s = torch.where(replicate_like(valid[:, None, None, :], s), s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype).float(), v_cache.float())
    return reshape(o, B, 1, H, hd).to(q.dtype)
