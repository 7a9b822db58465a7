"""DeepSeek-V2 Multi-head Latent Attention (MLA) — the counterpart of
``repro.models.mla``.

KV state is compressed to a per-token latent (kv_lora_rank) plus a shared
rotary key (qk_rope_dim); queries go through their own low-rank bottleneck
(q_lora_rank). Decode has two schedules of the same math:

  * ``absorb=False`` — cached latents are up-projected to per-head K/V
    every step;
  * ``absorb=True``  — W_UK is folded into the query and W_UV applied after
    attention, so decode attends directly over the latent cache
    (kv_lora_rank + qk_rope_dim wide).

All of it is plain tensor operations, as in the JAX package, which runs MLA
outside its attention kernels. ``mla_decode`` writes the new token's latent
into the cache in place (the JAX package returns an updated copy).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import (
    dense_init,
    einsum,
    matmul,
    replicate_like,
    reshape,
    rms_norm,
    rope,
)

__all__ = ["init_mla", "mla_attention", "mla_decode", "init_mla_cache"]

_NEG = -1.0e30


def init_mla(generator: torch.Generator, cfg, dtype) -> dict:
    """The norm scales stay f32, as in the JAX package."""
    d = cfg.d_model
    H = cfg.n_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    dev = generator.device
    return {
        "wq_a": dense_init((d, cfg.q_lora_rank), generator, 0, dtype),
        "q_norm": torch.zeros(cfg.q_lora_rank, device=dev),
        "wq_b": dense_init((cfg.q_lora_rank, H * qd), generator, 0, dtype),
        "wkv_a": dense_init((d, cfg.kv_lora_rank + cfg.qk_rope_dim), generator, 0, dtype),
        "kv_norm": torch.zeros(cfg.kv_lora_rank, device=dev),
        "wkv_b": dense_init((cfg.kv_lora_rank, H * (cfg.qk_nope_dim + cfg.v_head_dim)),
                            generator, 0, dtype),
        "wo": dense_init((H * cfg.v_head_dim, d), generator, 0, dtype),
    }


def _project_q(p, x, cfg, positions):
    B, S, _ = x.shape
    H = cfg.n_heads
    q = matmul(rms_norm(matmul(x, p["wq_a"]), p["q_norm"]), p["wq_b"])
    q = reshape(q, B, S, H, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _project_kv_latent(p, x, cfg, positions):
    c = matmul(x, p["wkv_a"])
    c_kv = rms_norm(c[..., :cfg.kv_lora_rank], p["kv_norm"])
    k_rope = c[..., None, cfg.kv_lora_rank:]           # (B, S, 1, rope)
    k_rope = rope(k_rope, positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _up_kv(p, c_kv, cfg):
    B, S, _ = c_kv.shape
    H = cfg.n_heads
    kv = reshape(matmul(c_kv, p["wkv_b"]), B, S, H, cfg.qk_nope_dim + cfg.v_head_dim)
    return kv[..., :cfg.qk_nope_dim], kv[..., cfg.qk_nope_dim:]  # k_nope, v


def mla_attention(p: dict, x: torch.Tensor, cfg, positions, chunk: int = 512) -> torch.Tensor:
    """Training/prefill MLA with causal masking (chunked over queries)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5

    q_nope, q_rope = _project_q(p, x, cfg, positions)
    c_kv, k_rope = _project_kv_latent(p, x, cfg, positions)
    k_nope, v = _up_kv(p, c_kv, cfg)

    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, cfg.qk_rope_dim)], dim=-1)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(S, device=x.device)

    chunk = min(chunk, S)
    outs = []
    for q0 in range(0, S, chunk):
        qblk = q[:, q0:q0 + chunk]
        qpos = torch.arange(q0, q0 + qblk.shape[1], device=x.device)
        s = einsum("bqhd,bshd->bhqs", qblk.float(), kf) * scale
        mask = replicate_like(qpos[:, None] >= kpos[None, :], s)
        s = torch.where(mask[None, None], s, _NEG)
        pr = torch.softmax(s, dim=-1)
        outs.append(einsum("bhqs,bshd->bqhd", pr, vf).to(x.dtype))
    out = torch.cat(outs, dim=1)
    return matmul(reshape(out, B, S, H * cfg.v_head_dim), p["wo"])


def init_mla_cache(cfg, B: int, S: int, dtype, device=None) -> dict:
    return {
        "c_kv": torch.zeros((B, S, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((B, S, cfg.qk_rope_dim), dtype=dtype, device=device),
    }


def _scalar_pos(pos) -> int:
    if isinstance(pos, (int, np.integer)):
        return int(pos)
    if isinstance(pos, torch.Tensor) and pos.ndim == 0:
        return int(pos)
    raise ValueError(f"mla_decode takes one scalar position for the whole batch, as in "
                     f"the JAX package; got {type(pos).__name__} of shape "
                     f"{tuple(np.shape(pos))} (per-sequence positions serve the GQA "
                     f"families only)")


def mla_decode(p: dict, x: torch.Tensor, cache: dict, cfg, pos,
               absorb: bool = True) -> tuple[torch.Tensor, dict]:
    """One-token MLA decode. x: (B, 1, d); pos: a scalar index. The cache is
    updated in place and returned."""
    pos = _scalar_pos(pos)
    B = x.shape[0]
    H = cfg.n_heads
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    positions = replicate_like(torch.full((B, 1), pos, device=x.device), x)

    q_nope, q_rope = _project_q(p, x, cfg, positions)      # (B, 1, H, *)
    c_new, kr_new = _project_kv_latent(p, x, cfg, positions)

    cache["c_kv"][:, pos] = c_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, pos] = kr_new[:, 0].to(cache["k_rope"].dtype)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    S = c_kv.shape[1]
    valid = replicate_like(torch.arange(S, device=x.device)[None, :] <= pos, x)  # (1, S)

    wkv_b = reshape(p["wkv_b"], cfg.kv_lora_rank, H, cfg.qk_nope_dim + cfg.v_head_dim)
    w_uk = wkv_b[..., :cfg.qk_nope_dim]                    # (lora, H, nope)
    w_uv = wkv_b[..., cfg.qk_nope_dim:]                    # (lora, H, v)

    if absorb:
        # fold W_UK into q; attend over the latent cache directly
        q_eff = einsum("bqhn,lhn->bqhl", q_nope.float(), w_uk.float())
        s = einsum("bqhl,bsl->bhqs", q_eff, c_kv.float())
        s = s + einsum("bqhr,bsr->bhqs", q_rope.float(), k_rope.float())
        s = torch.where(valid[:, None, None, :], s * scale, _NEG)
        pr = torch.softmax(s, dim=-1)
        lat = einsum("bhqs,bsl->bqhl", pr, c_kv.float())
        o = einsum("bqhl,lhv->bqhv", lat, w_uv.float())
    else:
        # naive: up-project the whole cache each step
        k_nope, v = _up_kv(p, c_kv, cfg)                   # (B, S, H, *)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, cfg.qk_rope_dim)],
                      dim=-1)
        s = einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
        s = torch.where(valid[:, None, None, :], s, _NEG)
        pr = torch.softmax(s, dim=-1)
        o = einsum("bhqs,bshv->bqhv", pr, v.float())

    out = matmul(reshape(o, B, 1, H * cfg.v_head_dim).to(x.dtype), p["wo"])
    return out, cache
