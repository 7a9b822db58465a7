"""Shared model building blocks: norms, rotary embeddings (incl. M-RoPE),
initializers, and the architecture config schema — the counterpart of
``repro.models.common``, on torch tensors."""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

__all__ = ["ArchConfig", "rms_norm", "rope", "mrope", "dense_init",
           "service_matmul", "replicate_like", "replicated_on", "reshape", "einsum", "matmul",
           "constrain", "ACT"]


def replicate_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor the model makes itself (a mask, positions), as a
    DTensor replicated on ``ref``'s mesh when ``ref`` is a DTensor (DTensor
    refuses to mix the two in one operation); ``t`` itself otherwise."""
    if isinstance(ref, DTensor) and not isinstance(t, DTensor):
        return DTensor.from_local(t, ref.device_mesh, [Replicate()] * ref.device_mesh.ndim,
                                  run_check=False)
    return t


def replicated_on(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, a DTensor whose value is small (a scalar), replicated on
    ``ref``'s mesh where the two meshes differ (the experts of the
    multi-pod mesh beside the joined one, ``parallel.placement_mesh``);
    ``t`` itself otherwise."""
    if not (isinstance(t, DTensor) and isinstance(ref, DTensor)) \
            or t.device_mesh == ref.device_mesh:
        return t
    full = t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim).to_local()
    return DTensor.from_local(full, ref.device_mesh, [Replicate()] * ref.device_mesh.ndim,
                              run_check=False)


def _view_groups(old: tuple, new: tuple) -> list:
    """The dims of ``old`` and ``new`` (one shape reshaped to the other) in
    groups of equal size: [(old dims, new dims), ...]."""
    groups, i, j = [], 0, 0
    while i < len(old) and j < len(new):
        a, b, pa, pb = [i], [j], old[i], new[j]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb:
                a.append(i)
                pa *= old[i]
                i += 1
            else:
                b.append(j)
                pb *= new[j]
                j += 1
        groups.append((a, b))
    if groups:  # trailing size-1 dims join the last group
        groups[-1][0].extend(range(i, len(old)))
        groups[-1][1].extend(range(j, len(new)))
    return groups


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``, also for a DTensor sharded where DTensor
    refuses the reshape: a dim split into parts whose first part the shard
    count does not divide (qwen2-0.5b's 14 heads on a 16-wide ``model``
    axis), or a dim merged into the one before it. Those mesh dims are
    gathered first, an explicit redistribution (XLA reshards silently). The
    result is pinned to its placements, so its gradient comes back in a
    layout the reverse reshape takes."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    if -1 in shape:
        known = math.prod(n for n in shape if n != -1)
        shape = tuple(x.numel() // max(known, 1) if n == -1 else n for n in shape)
    mesh, pl = x.device_mesh, list(x.placements)
    ways = [1] * x.ndim
    for i, p in enumerate(pl):
        if p.is_shard():
            ways[p.dim] *= mesh.size(i)
    bad = set()
    for a, b in _view_groups(tuple(x.shape), tuple(shape)):
        bad.update(d for d in a[1:] if ways[d] > 1)
        if ways[a[0]] > 1 and len(b) > 1 and shape[b[0]] % ways[a[0]]:
            bad.add(a[0])
    if bad:
        x = x.redistribute(mesh, [Replicate() if p.is_shard() and p.dim in bad else p
                                  for p in pl])
    y = x.reshape(*shape)
    return y.redistribute(mesh, y.placements)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _local_placements(eq: str, ops: tuple):
    """(each operand's placements, each operand's gradient's, the output's)
    for ``torch.einsum(eq, *ops)`` computed on each device's shards. On
    every mesh dim one subscript is sharded: the one the largest operand
    shards there (where operands shard different ones); the operands that
    carry it shard it, the others replicate (a replicated operand takes its
    local slice, any other is redistributed: the smaller operands move, as a
    partitioner would choose); a subscript of the output then stays sharded,
    a contracted one leaves a partial sum. An operand replicated on a mesh
    dim that shards another subscript met each device's slice of it, so its
    gradient there is a partial sum."""
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    mesh = ops[0].device_mesh
    targets, grads = [[] for _ in ops], [[] for _ in ops]
    placements = []
    for i in range(mesh.ndim):
        sharded = [(t.numel(), sub[t.placements[i].dim]) for sub, t in zip(ins, ops)
                   if t.placements[i].is_shard()]
        letter = max(sharded)[1] if sharded else None
        for sub, target, grad in zip(ins, targets, grads):
            here = Shard(sub.index(letter)) if letter and letter in sub else Replicate()
            target.append(here)
            grad.append(Partial() if letter and letter not in sub else here)
        placements.append(Replicate() if letter is None else
                          Shard(out.index(letter)) if letter in out else Partial())
    return targets, grads, placements


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *ops)``; for DTensor operands, the einsum of each
    device's shards after the placements :func:`_local_placements` picks, as
    XLA partitions it (the batch and head dims of attention and the SSD scan
    stay sharded). DTensor's own einsum flattens the batch dims into one,
    which it refuses where two of them are sharded in torch's releases
    before 2.13, and gathers the larger operand (MLA's latent cache, a
    token's step) where operands shard different dims."""
    if not any(isinstance(t, DTensor) for t in ops):
        return torch.einsum(eq, *ops)
    ref = next(t for t in ops if isinstance(t, DTensor))
    ops = tuple(replicate_like(t, ref) for t in ops)
    targets, grads, placements = _local_placements(eq, ops)
    ops = tuple(t if list(t.placements) == target else t.redistribute(t.device_mesh, target)
                for t, target in zip(ops, targets))
    # contiguous, the result and the operands' gradients: DTensor takes a
    # shard's layout for the global one's, and einsum and its backward return
    # permuted views (the shards divide evenly, by the sharding rules, so
    # DTensor infers the global shape)
    local = torch.einsum(eq, *(_ContiguousGrad.apply(t.to_local(grad_placements=g))
                               for t, g in zip(ops, grads)))
    return DTensor.from_local(local.contiguous(), ref.device_mesh, placements,
                              run_check=False)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a 2-D ``w``; with DTensors, the product of each
    device's shards (:func:`einsum`). DTensor's own matmul flattens ``x``'s
    leading dims, which it refuses where two of them are sharded (the batch
    over ``data`` and the sequence over ``model``: sequence parallelism) in
    torch's releases before 2.13."""
    if not (isinstance(x, DTensor) or isinstance(w, DTensor)):
        return x @ w
    lead = "abcdefgh"[:x.ndim - 1]
    return einsum(f"{lead}y,yz->{lead}z", x, w)


def constrain(x: torch.Tensor, placements) -> torch.Tensor:
    """The activation sharding constraint (the JAX package's ``_cst``):
    ``x`` redistributed to ``placements`` (a tuple of DTensor placements, one
    per mesh dim, ``parallel.named(mesh, spec)``) when it is a DTensor; a
    no-op for ``placements`` None or a plain tensor."""
    if placements is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, tuple(placements))


def service_matmul(x: torch.Tensor, w: torch.Tensor, service=None) -> torch.Tensor:
    """``x @ w`` routed through the dispatch service's tuned tiled matmul
    (``csrc/matmul.cu`` on the card, per ``(rows, K) x (K, N)`` shape
    signature); a plain matmul without a service. Leading dims of ``x`` are
    flattened for the kernel's 2-D contract and restored afterwards; the
    kernel takes contiguous operands, so ``w`` must be contiguous (the tied
    unembed's transpose is made once per parameter set, see
    ``models.model``)."""
    if service is None:
        return matmul(x, w)
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
    ang = positions.float()[..., None] * replicate_like(inv, positions)
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
    inv = replicate_like(inv, positions3)
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
    carry the JAX package's weights over with ``models.convert``.) The scale
    is applied in place: an expert tensor at DeepSeek-V2's width is 5 GB in
    f32, and ``w * std`` would hold a second one."""
    if generator.device.type == "meta":  # models.abstract_params: shapes only
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = shape[in_axis] if in_axis < len(shape) else shape[0]
    std = (1.0 / max(fan_in, 1)) ** 0.5
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(std).to(dtype)


ACT = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}
