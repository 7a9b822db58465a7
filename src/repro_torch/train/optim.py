"""AdamW and LR schedules — the counterpart of ``repro.train.optim``.

The arithmetic is the JAX package's: moments in f32 (stored in
``moment_dtype``), bias correction by the step count, and weight decay on
every leaf with ``p.ndim >= 2``. Because the layers are stacked on a leading
axis, that rule also decays the stacked norm scales and biases (``(L, d)``
leaves such as ``layers/ln1`` or ``layers/bq``), as the JAX package does; the
decision is the leaf's rank, never its name. The update runs in place under
``torch.no_grad()`` (no second copy of the weights) and returns the same
dicts it was given.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.common import replicated_on
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AdamW", "adamw_init", "adamw_update", "cosine_lr", "linear_warmup_lr"]


@dataclasses.dataclass
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: torch.dtype = torch.float32


def adamw_init(params: dict, moment_dtype: torch.dtype = torch.float32) -> dict:
    """``{"m", "v"}`` zeros in ``moment_dtype`` under ``params``' keys, and
    ``step``, a 0-d int32 tensor on their device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)}


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1):
    """One AdamW step, in place on ``params`` and ``state``; returns (params,
    state). ``lr`` is a float or a 0-d tensor (a schedule's value): no host
    synchronisation either way."""
    state["step"] += 1
    t = state["step"].float()
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                          tree_leaves(state["v"]), tree_leaves(params)):
        g32 = g.float()
        # .float() is the tensor itself when it is f32: the moments then
        # update in place; a bf16 moment is computed in f32 and stored back
        m32 = m.float().mul_(b1).add_((1 - b1) * g32)
        v32 = v.float().mul_(b2).add_((1 - b2) * g32 * g32)
        delta = (m32 / replicated_on(c1, m32)).div_(
            (v32 / replicated_on(c2, v32)).sqrt_().add_(eps))
        p32 = p.float()
        if p.ndim >= 2:  # weight decay on matrices only (stacked leaves included)
            delta.add_(weight_decay * p32)
        p32.sub_(delta.mul_(lr))
        for dst, src in ((p, p32), (m, m32), (v, v32)):
            if dst is not src:
                dst.copy_(src)
    return params, state


def linear_warmup_lr(step, *, peak: float, warmup: int):
    return peak * min(1.0, (step + 1) / warmup)


def cosine_lr(step, *, peak: float, warmup: int, total: int, floor: float = 0.1):
    if step < warmup:
        return peak * (step + 1) / warmup
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1.0 + math.cos(math.pi * prog)))
