"""Layer blocks of the dense family — the counterpart of the GQA parts of
``repro.models.blocks``: init, train-time (prefill) apply and decode-time
apply of a transformer layer with GQA attention and a dense MLP.

The decode apply writes the new token's K/V into the layer's cache in place
(``index_put_`` on the layer's slice of the stacked cache), where the JAX
package returns an updated copy. MLA, Mamba2 and cross-attention layers
come with their families.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import gqa_attention, gqa_decode
from repro_torch.models.common import (
    ArchConfig,
    dense_init,
    mrope,
    rms_norm,
    rope,
    service_matmul,
)
from repro_torch.models.moe import init_mlp, mlp

__all__ = ["init_attn_layer", "attn_layer_train", "attn_layer_decode", "layer_windows"]


# ---------------------------------------------------------------------------
# per-layer attention-window schedule (mixtral SWA, gemma3 local:global)
# ---------------------------------------------------------------------------


def layer_windows(cfg: ArchConfig) -> np.ndarray:
    """(L,) window sizes; 0 means full/global attention."""
    L = cfg.n_layers
    if cfg.local_global_ratio:
        r = cfg.local_global_ratio
        w = np.full(L, cfg.sliding_window or 1024, np.int32)
        w[r::r + 1] = 0  # every (r+1)-th layer is global
        return w
    if cfg.sliding_window:
        return np.full(L, cfg.sliding_window, np.int32)
    return np.zeros(L, np.int32)


# ---------------------------------------------------------------------------
# transformer layer (GQA attention, dense MLP)
# ---------------------------------------------------------------------------


def init_attn_layer(generator: torch.Generator, cfg: ArchConfig, *, moe: bool = False,
                    d_ff: int | None = None) -> dict:
    if cfg.attn_type != "gqa":
        raise NotImplementedError(f"{cfg.attn_type} attention waits for its family "
                                  f"(ROADMAP.md Queue 1, item 5)")
    if moe:
        raise NotImplementedError("MoE layers wait for the MoE family "
                                  "(ROADMAP.md Queue 1, item 5)")
    d = cfg.d_model
    hd = cfg.hd
    dtype = cfg.dtype
    dev = generator.device
    p: dict = {"ln1": torch.zeros(d, device=dev), "ln2": torch.zeros(d, device=dev)}
    p["wq"] = dense_init((d, cfg.n_heads * hd), generator, 0, dtype)
    p["wk"] = dense_init((d, cfg.n_kv_heads * hd), generator, 0, dtype)
    p["wv"] = dense_init((d, cfg.n_kv_heads * hd), generator, 0, dtype)
    p["wo"] = dense_init((cfg.n_heads * hd, d), generator, 0, dtype)
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(cfg.n_heads * hd, device=dev)
        p["bk"] = torch.zeros(cfg.n_kv_heads * hd, device=dev)
        p["bv"] = torch.zeros(cfg.n_kv_heads * hd, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(hd, device=dev)
        p["k_norm"] = torch.zeros(hd, device=dev)
    p["mlp"] = init_mlp(generator, d, d_ff or cfg.d_ff, dtype)
    return p


def _qkv(p, h, cfg, positions):
    B, S, _ = h.shape
    hd = cfg.hd
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd).to(cfg.dtype)
    k = k.reshape(B, S, cfg.n_kv_heads, hd).to(cfg.dtype)
    v = v.reshape(B, S, cfg.n_kv_heads, hd).to(cfg.dtype)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if positions is not None:
        if cfg.mrope:
            q = mrope(q, positions, cfg.rope_theta)
            k = mrope(k, positions, cfg.rope_theta)
        else:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_layer_train(p, x, *, cfg: ArchConfig, positions, window=None,
                     causal: bool = True, chunk: int = 512, service=None):
    """Returns x after the layer. positions: (B, S) or (B, 3, S) for M-RoPE;
    window: this layer's window (0 = full attention). ``service`` routes
    attention and the output projection through :mod:`repro_torch.dispatch`
    tuned variants."""
    # the flash route is gated statically, as in the JAX package: only archs
    # with no windowed layers qualify
    svc_attn = service if not (cfg.sliding_window or cfg.local_global_ratio) else None
    h = rms_norm(x, p["ln1"])
    q, k, v = _qkv(p, h, cfg, positions)
    o = gqa_attention(q, k, v, causal=causal, window=window, chunk=chunk,
                      f32=cfg.attn_f32, service=svc_attn)
    B, S = x.shape[:2]
    x = x + service_matmul(o.reshape(B, S, -1), p["wo"], service)
    return x + mlp(p["mlp"], rms_norm(x, p["ln2"]))


def attn_layer_decode(p, x, cache, pos, *, cfg: ArchConfig, window=None, service=None):
    """x: (B, 1, d); cache: {'k': (B, S, K, hd), 'v': ...}, updated in place
    with this token's K/V. ``pos`` is an int or a (B,) vector (continuous
    batching: per-sequence positions; the insert becomes a per-row
    scatter). Returns (x, cache). ``service`` routes the output projection
    through the tuned tiled matmul and — for archs with no windowed layers
    — single-token attention through the tuned ``decode_attention``
    kernel."""
    B = x.shape[0]
    h = rms_norm(x, p["ln1"])
    svc_attn = service if not (cfg.sliding_window or cfg.local_global_ratio) else None
    scalar = isinstance(pos, (int, np.integer))
    if scalar:  # a Python int: no host-device copy, no synchronisation
        pos = int(pos)
        positions = torch.full((B, 1), pos, device=x.device)
    else:
        pos = torch.as_tensor(pos, device=x.device).reshape(-1).expand(B)
        positions = pos[:, None]
    if cfg.mrope:
        positions = positions[:, None, :].expand(B, 3, 1)
    q, k, v = _qkv(p, h, cfg, positions)
    S_alloc = cache["k"].shape[1]
    ring = bool(cfg.sliding_window) and not cfg.local_global_ratio \
        and S_alloc == cfg.sliding_window
    if scalar:
        slot = pos % S_alloc if ring else pos
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    else:
        # per-sequence positions: row b writes its own slot
        slots = (torch.remainder(pos, S_alloc) if ring else pos).long()
        rows = torch.arange(B, device=x.device)
        cache["k"].index_put_((rows, slots), k[:, 0].to(cache["k"].dtype))
        cache["v"].index_put_((rows, slots), v[:, 0].to(cache["v"].dtype))
    o = gqa_decode(q, cache["k"], cache["v"], pos,
                   window=None if svc_attn is not None else window,
                   ring=ring, service=svc_attn)
    x = x + service_matmul(o.reshape(B, 1, -1), p["wo"], service)
    return x + mlp(p["mlp"], rms_norm(x, p["ln2"])), cache
