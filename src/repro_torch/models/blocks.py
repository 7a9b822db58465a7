"""Layer blocks — the counterpart of ``repro.models.blocks``: init,
train-time (prefill) apply and decode-time apply of a layer with GQA or MLA
attention and a dense MLP or routed experts (the dense, MoE and VLM
families, zamba2's shared attention block and whisper's encoder), of a
Mamba2 layer (the SSM and hybrid families), and of whisper's decoder layer
with cross-attention to the encoder's output (the audio family).

The decode apply writes the new token's K/V (or MLA latent, or Mamba2
state) into the layer's cache in place (on the layer's slice of the stacked
cache), where the JAX package returns an updated copy.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import gqa_attention, gqa_decode
from repro_torch.models.common import (
    ArchConfig,
    constrain,
    dense_init,
    matmul,
    mrope,
    replicate_like,
    reshape,
    rms_norm,
    rope,
    service_matmul,
)
from repro_torch.models.mla import init_mla, mla_attention, mla_decode
from repro_torch.models.moe import init_mlp, init_moe, mlp, moe_ffn
from repro_torch.models.ssm import init_mamba2, mamba2_decode, mamba2_forward

__all__ = ["init_attn_layer", "attn_layer_train", "attn_layer_decode",
           "init_mamba_layer", "mamba_layer_train", "mamba_layer_decode",
           "init_cross_layer", "cross_kv", "cross_layer_train", "cross_layer_decode",
           "layer_windows"]


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
# transformer layer (GQA or MLA attention; dense MLP or MoE)
# ---------------------------------------------------------------------------


def init_attn_layer(generator: torch.Generator, cfg: ArchConfig, *, moe: bool = False,
                    d_ff: int | None = None) -> dict:
    """MLA for ``attn_type="mla"``, else GQA: ``"none"`` too, zamba2's
    shared block under its SSM config, as in the JAX package."""
    d = cfg.d_model
    hd = cfg.hd
    dtype = cfg.dtype
    dev = generator.device
    p: dict = {"ln1": torch.zeros(d, device=dev), "ln2": torch.zeros(d, device=dev)}
    if cfg.attn_type == "mla":
        p["mla"] = init_mla(generator, cfg, dtype)
    else:
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
    if moe:
        p["moe"] = init_moe(generator, d, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts,
                            cfg.n_shared_experts, dtype)
    else:
        p["mlp"] = init_mlp(generator, d, d_ff or cfg.d_ff, dtype)
    return p


def _qkv(p, h, cfg, positions):
    B, S, _ = h.shape
    hd = cfg.hd
    q = matmul(h, p["wq"])
    k = matmul(h, p["wk"])
    v = matmul(h, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = reshape(q, B, S, cfg.n_heads, hd).to(cfg.dtype)
    k = reshape(k, B, S, cfg.n_kv_heads, hd).to(cfg.dtype)
    v = reshape(v, B, S, cfg.n_kv_heads, hd).to(cfg.dtype)
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


def _ffn(p, x, cfg: ArchConfig, moe: bool):
    """The layer's FFN on the pre-normed residual: (y, the router's aux
    loss, 0 for a dense MLP)."""
    if moe:
        return moe_ffn(p["moe"], x, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                       group_size=cfg.moe_group)
    return mlp(p["mlp"], x), torch.zeros((), device=x.device)


def attn_layer_train(p, x, *, cfg: ArchConfig, positions, window=None, moe: bool = False,
                     causal: bool = True, chunk: int = 512, service=None, act_spec=None):
    """Returns (x, aux) after the layer. positions: (B, S) or (B, 3, S) for
    M-RoPE; window: this layer's window (0 = full attention). ``service``
    routes GQA attention and its output projection through
    :mod:`repro_torch.dispatch` tuned variants; MLA and the experts stay
    plain tensor operations, as in the JAX package. ``act_spec`` (DTensor
    placements) pins the residual stream after the attention half too: DTensor
    places each operator on its own, and without the pin it shards the FFN's
    input over ``model`` and all-reduces the FFN's hidden activations."""
    h = rms_norm(x, p["ln1"])
    if cfg.attn_type == "mla":
        x = x + mla_attention(p["mla"], h, cfg,
                              positions if positions.ndim == 2 else positions[:, 0])
    else:
        # the flash route is gated statically, as in the JAX package: only
        # archs with no windowed layers qualify
        svc_attn = service if not (cfg.sliding_window or cfg.local_global_ratio) else None
        q, k, v = _qkv(p, h, cfg, positions)
        o = gqa_attention(q, k, v, causal=causal, window=window, chunk=chunk,
                          f32=cfg.attn_f32, service=svc_attn)
        B, S = x.shape[:2]
        x = x + service_matmul(reshape(o, B, S, -1), p["wo"], service)
    x = constrain(x, act_spec)
    y, aux = _ffn(p, rms_norm(x, p["ln2"]), cfg, moe)
    return x + y, aux


def _gqa_decode(p, h, cache, pos, *, cfg: ArchConfig, window, service):
    """The GQA half of a decode layer on the normed input ``h``: writes this
    token's K/V into ``cache`` and returns the projected attention output."""
    B = h.shape[0]
    svc_attn = service if not (cfg.sliding_window or cfg.local_global_ratio) else None
    scalar = isinstance(pos, (int, np.integer))
    if scalar:  # a Python int: no host-device copy, no synchronisation
        pos = int(pos)
        positions = replicate_like(torch.full((B, 1), pos, device=h.device), h)
    else:
        pos = torch.as_tensor(pos, device=h.device).reshape(-1).expand(B)
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
        rows = torch.arange(B, device=h.device)
        cache["k"].index_put_((rows, slots), k[:, 0].to(cache["k"].dtype))
        cache["v"].index_put_((rows, slots), v[:, 0].to(cache["v"].dtype))
    o = gqa_decode(q, cache["k"], cache["v"], pos,
                   window=None if svc_attn is not None else window,
                   ring=ring, service=svc_attn)
    return service_matmul(reshape(o, B, 1, -1), p["wo"], service)


def attn_layer_decode(p, x, cache, pos, *, cfg: ArchConfig, window=None, moe: bool = False,
                      mla_absorb: bool = True, service=None):
    """x: (B, 1, d); cache: {'k': (B, S, K, hd), 'v': ...} or the MLA latent
    cache, updated in place with this token's entry. ``pos`` is an int, or
    for the GQA families a (B,) vector (continuous batching: per-sequence
    positions; the insert becomes a per-row scatter). Returns (x, cache,
    aux). ``service`` routes the GQA output projection through the tuned
    tiled matmul and — for archs with no windowed layers — single-token
    attention through the tuned ``decode_attention`` kernel."""
    h = rms_norm(x, p["ln1"])
    if cfg.attn_type == "mla":
        attn, cache = mla_decode(p["mla"], h, cache, cfg, pos, absorb=mla_absorb)
    else:
        attn = _gqa_decode(p, h, cache, pos, cfg=cfg, window=window, service=service)
    x = x + attn
    y, aux = _ffn(p, rms_norm(x, p["ln2"]), cfg, moe)
    return x + y, cache, aux


# ---------------------------------------------------------------------------
# mamba2 layer (pre-norm residual)
# ---------------------------------------------------------------------------


def init_mamba_layer(generator: torch.Generator, cfg: ArchConfig) -> dict:
    return {
        "ln": torch.zeros(cfg.d_model, device=generator.device),
        "mixer": init_mamba2(generator, cfg.d_model, expand=cfg.ssm_expand,
                             head_dim=cfg.ssm_head_dim, n_state=cfg.ssm_state,
                             conv_width=cfg.ssm_conv_width, dtype=cfg.dtype),
    }


def mamba_layer_train(p, x, *, cfg: ArchConfig, chunk: int = 64):
    return x + mamba2_forward(p["mixer"], rms_norm(x, p["ln"]), cfg, chunk=chunk)


def mamba_layer_decode(p, x, cache, *, cfg: ArchConfig):
    """Returns (x, cache): the layer's conv window and SSM state updated in
    place."""
    y, cache = mamba2_decode(p["mixer"], rms_norm(x, p["ln"]), cache, cfg)
    return x + y, cache


# ---------------------------------------------------------------------------
# encoder-decoder (whisper): decoder layer with cross-attention
# ---------------------------------------------------------------------------


def init_cross_layer(generator: torch.Generator, cfg: ArchConfig) -> dict:
    """A GQA layer with a dense MLP, plus the cross-attention's norm
    (``ln_x``) and projections (``xq``, ``xk``, ``xv``, ``xo``)."""
    d, hd = cfg.d_model, cfg.hd
    p = init_attn_layer(generator, cfg)
    p["ln_x"] = torch.zeros(d, device=generator.device)
    p["xq"] = dense_init((d, cfg.n_heads * hd), generator, 0, cfg.dtype)
    p["xk"] = dense_init((d, cfg.n_kv_heads * hd), generator, 0, cfg.dtype)
    p["xv"] = dense_init((d, cfg.n_kv_heads * hd), generator, 0, cfg.dtype)
    p["xo"] = dense_init((cfg.n_heads * hd, d), generator, 0, cfg.dtype)
    return p


def cross_kv(p, enc: torch.Tensor, cfg: ArchConfig) -> dict:
    """The layer's cross-attention K/V from the encoder's output ``enc``
    (B, Se, d): ``{"k", "v": (B, Se, K, hd)}``, no rope (the JAX package's
    ``dec_body``)."""
    B, Se = enc.shape[:2]
    shape = (B, Se, cfg.n_kv_heads, cfg.hd)
    return {"k": reshape(matmul(enc, p["xk"]), *shape).to(cfg.dtype),
            "v": reshape(matmul(enc, p["xv"]), *shape).to(cfg.dtype)}


def _cross_attend(p, x, enc_k, enc_v, cfg):
    B, S, _ = x.shape
    h = rms_norm(x, p["ln_x"])
    q = reshape(matmul(h, p["xq"]), B, S, cfg.n_heads, cfg.hd).to(cfg.dtype)
    o = gqa_attention(q, enc_k, enc_v, causal=False, window=None)
    return x + matmul(reshape(o, B, S, -1), p["xo"])


def cross_layer_train(p, x, enc_kv, *, cfg: ArchConfig, positions, act_spec=None):
    """Decoder layer: causal self-attention, cross-attention to the
    encoder's K/V, MLP. Every product is plain and attention the chunked
    path, as in the JAX package (which passes no service here).
    ``act_spec`` pins the residual stream after each attention, as in
    :func:`attn_layer_train`."""
    h = rms_norm(x, p["ln1"])
    q, k, v = _qkv(p, h, cfg, positions)
    B, S = x.shape[:2]
    o = gqa_attention(q, k, v, causal=True, window=None)
    x = constrain(x + matmul(reshape(o, B, S, -1), p["wo"]), act_spec)
    x = constrain(_cross_attend(p, x, enc_kv["k"], enc_kv["v"], cfg), act_spec)
    return x + mlp(p["mlp"], rms_norm(x, p["ln2"]))


def cross_layer_decode(p, x, cache, enc_kv, pos: int, *, cfg: ArchConfig):
    """x: (B, 1, d); cache: the layer's self-attention {'k', 'v': (B, S, K,
    hd)}, this token's entry written at ``pos`` (an int) in place; enc_kv:
    the layer's cross K/V, filled at prefill. Returns (x, cache)."""
    B = x.shape[0]
    pos = int(pos)
    h = rms_norm(x, p["ln1"])
    q, k, v = _qkv(p, h, cfg, replicate_like(torch.full((B, 1), pos, device=x.device), h))
    cache["k"][:, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v[:, 0].to(cache["v"].dtype)
    o = gqa_decode(q, cache["k"], cache["v"], pos)
    x = x + matmul(reshape(o, B, 1, -1), p["wo"])
    x = _cross_attend(p, x, enc_kv["k"], enc_kv["v"], cfg)
    return x + mlp(p["mlp"], rms_norm(x, p["ln2"])), cache
