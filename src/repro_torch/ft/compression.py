"""Gradient compression with error feedback for the data-parallel
all-reduce — the counterpart of ``repro.ft.compression``, on
``torch.distributed``.

The wire trick: quantize the gradient to a low-precision payload *before*
the all-reduce and keep the quantization residual locally (error feedback),
adding it back before the next step's quantization. With bf16 payloads the
all-reduce moves half the bytes of f32; int8 moves a quarter.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["quantize", "dequantize", "compressed_psum", "ef_compress_grads"]


def quantize(x: torch.Tensor, dtype: torch.dtype = torch.int8):
    """Symmetric per-tensor quantization. Returns (payload, scale)."""
    if dtype == torch.bfloat16:
        return x.to(torch.bfloat16), torch.ones((), dtype=torch.float32, device=x.device)
    amax = x.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if q.dtype == torch.bfloat16:
        return q.float()
    return q.float() * scale


def compressed_psum(x: torch.Tensor, group=None, dtype: torch.dtype = torch.int8):
    """All-reduce (sum) over ``group`` (the default process group when None)
    with a compressed wire payload.

    int8 path: agree on a global scale (a ``max`` all-reduce of the local
    maxima), pre-divide by the group's size so the int8 sum cannot
    overflow, and sum *in int8* — 1 byte a value on the wire (4x less than
    f32). The pre-division costs log2(N) bits of precision, which the
    error-feedback residual (:func:`ef_compress_grads`) re-injects on later
    steps."""
    if dtype == torch.bfloat16:
        q = x.to(torch.bfloat16)
        dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
        return q.float()
    n = dist.get_world_size(group)
    gmax = x.abs().max() + 1e-12
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    scale = gmax / 127.0
    # pre-scaled so the N-shard sum stays within the int8 range
    q = torch.clamp(torch.round(x / (scale * n)), -127, 127).to(torch.int8)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)  # int8 payload on the wire
    return q.float() * (scale * n)


def ef_compress_grads(grads: dict, residual: dict, dtype: torch.dtype = torch.int8):
    """Error-feedback step (local half): g' = Q(g + r); r' = g + r - g'.
    Returns (g', r') as trees of ``grads``' structure; the caller
    all-reduces the quantized payload."""
    deq, res = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(residual)):
        g32 = g.float() + r
        q, scale = quantize(g32, dtype)
        d = dequantize(q, scale)
        deq.append(d)
        res.append(g32 - d)
    return tree_unflatten(grads, deq), tree_unflatten(grads, res)
