"""Shared model building blocks: norms, rotary embeddings (incl. M-RoPE),
initializers, and the architecture config schema — the counterpart of
``repro.models.common``, on torch tensors."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

__all__ = ["ArchConfig", "rms_norm", "rope", "mrope", "dense_init",
           "service_matmul", "ACT"]


def service_matmul(x: torch.Tensor, w: torch.Tensor, service=None) -> torch.Tensor:
    """``x @ w`` routed through the dispatch service's tuned tiled matmul
    (``csrc/matmul.cu`` on the card, per ``(rows, K) x (K, N)`` shape
    signature); a plain matmul without a service. Leading dims of ``x`` are
    flattened for the kernel's 2-D contract and restored afterwards; the
    kernel takes contiguous operands, so ``w`` must be contiguous (the tied
    unembed's transpose is made once per parameter set, see
    ``models.model``)."""
    if service is None:
        return x @ w
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    fn = service.dispatch("matmul", x2, w)
    return fn(x2, w).reshape(*lead, w.shape[-1])


# ---------------------------------------------------------------------------
# Architecture configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture. Field defaults cover the plain dense case;
    family-specific blocks read their own fields."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None      # default d_model // n_heads

    # attention
    attn_type: str = "gqa"           # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 1.0e4
    mrope: bool = False              # qwen2-vl 3-section rotary
    sliding_window: int | None = None
    local_global_ratio: int | None = None   # gemma3: N local per 1 global
    qk_norm: bool = False
    attn_f32: bool = True            # attention scores/softmax in f32 (knob)

    # MoE
    capacity_factor: float = 1.25
    moe_group: int = 2048            # GShard dispatch group size (tunable)
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int | None = None      # routed-expert hidden width
    first_dense_layers: int = 0      # deepseek: leading dense layer(s)

    # MLA (deepseek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2) / hybrid (zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    attn_every: int = 0              # zamba2: shared attn block interval

    # encoder-decoder (whisper)
    is_encdec: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500          # whisper frame count after conv frontend
    frontend: str | None = None      # audio_stub | vision_stub

    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16
    notes: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.attn_type == "none" and self.attn_every == 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (see DESIGN.md §Arch-applicability)."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window is not None
            or self.local_global_ratio is not None
        )

    def param_count(self) -> int:
        """Analytic parameter count (for 6*N*D roofline bookkeeping)."""
        d, L = self.d_model, self.n_layers
        hd = self.hd
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for layer in range(L):
            if self.attn_type == "gqa":
                attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                    + self.n_heads * hd * d
            elif self.attn_type == "mla":
                qdim = self.qk_rope_dim + self.qk_nope_dim
                attn = (
                    d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qdim
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d
                )
            else:
                attn = 0
            if self.family in ("ssm", "hybrid") and self.attn_type == "none":
                d_in = self.ssm_expand * d
                nheads = d_in // self.ssm_head_dim
                attn = d * (2 * d_in + 2 * self.ssm_state + nheads) + d_in * d \
                    + self.ssm_conv_width * (d_in + 2 * self.ssm_state)
            is_moe = self.n_experts > 0 and layer >= self.first_dense_layers
            if is_moe:
                eff = self.moe_d_ff or self.d_ff
                mlp = self.n_experts * 3 * d * eff + self.n_shared_experts * 3 * d * eff \
                    + d * self.n_experts
            elif self.family in ("ssm", "hybrid"):
                mlp = 0  # mamba layers carry no FFN; zamba2's d_ff lives in
                # the shared attention block (counted below)
            else:
                mlp = 3 * d * self.d_ff if self.d_ff else 0
            total += attn + mlp + 2 * d
        if self.attn_every:
            total += 4 * d * d + 3 * d * self.d_ff  # zamba2 shared block
        if self.is_encdec:
            # encoder layers: self-attn + mlp; decoder already counted above
            total += self.n_encoder_layers * (
                4 * d * self.n_heads * hd + 3 * d * self.d_ff + 2 * d
            )
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared, not all experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        eff = self.moe_d_ff or self.d_ff
        inactive = (self.n_experts - self.top_k) * 3 * d * eff
        moe_layers = self.n_layers - self.first_dense_layers
        return int(self.param_count() - moe_layers * inactive)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def _rope_angles(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """positions: (..., S) -> cos/sin (..., S, dim//2), in f32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1.0e4) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, hd); positions: (B, S)."""
    hd = x.shape[-1]
    cos, sin = _rope_angles(positions, hd, theta)  # (B, S, hd/2)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float = 1.0e4,
          sections: tuple = (2, 3, 3)) -> torch.Tensor:
    """Qwen2-VL multimodal rotary: the head_dim halves are partitioned into
    (t, h, w) sections, each rotated by its own position stream.

    x: (B, S, H, hd); positions3: (B, 3, S). ``sections`` are relative parts
    of hd//2 (Qwen2-VL uses 16/24/24 of 64 -> 2:3:3).
    """
    hd = x.shape[-1]
    half = hd // 2
    total = sum(sections)
    widths = [half * s // total for s in sections]
    widths[-1] = half - sum(widths[:-1])

    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    parts, off = [], 0
    for axis, w in enumerate(widths):
        pos = positions3[:, axis, :].float()                  # (B, S)
        parts.append(pos[..., None] * inv[off: off + w])      # (B, S, w)
        off += w
    ang = torch.cat(parts, dim=-1)[:, :, None, :]             # (B, S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense_init(shape, generator: torch.Generator, in_axis: int = 0,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Normal weights with std 1/sqrt(fan_in), drawn in f32 from
    ``generator`` on its device, then cast to ``dtype``. (The JAX package
    draws from a ``jax.random`` key: the two give different numbers; tests
    carry the JAX package's weights over with ``models.convert``.)"""
    fan_in = shape[in_axis] if in_axis < len(shape) else shape[0]
    std = (1.0 / max(fan_in, 1)) ** 0.5
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * std).to(dtype)


ACT = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}
