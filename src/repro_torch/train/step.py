"""Training step: loss + gradients + AdamW, with microbatch gradient
accumulation and a remat policy — the counterpart of ``repro.train.step``.

The step differentiates :func:`repro_torch.models.loss_fn` with
``torch.autograd.grad`` over the parameter leaves and updates the weights
and the optimizer state in place. It passes no dispatch service, as the JAX
package's step passes none, so no hand-written kernel runs: attention takes
the chunked path and the products are plain ``torch.matmul``. Its metrics
are 0-d tensors on the weights' device; nothing in the step waits for the
device.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.common import ArchConfig
from repro_torch.models.model import loss_fn
from repro_torch.train.optim import adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["make_train_step", "make_grad_step", "init_train_state"]


def _check_trainable(params: dict) -> None:
    if "embed_t" in params:
        raise ValueError("a train state holds no embed_t (the tied unembed's serving copy): "
                         "train models.trainable(params) and rebuild it with "
                         "models.tied_unembed for serving")


def init_train_state(params: dict, moment_dtype: torch.dtype = torch.float32) -> dict:
    """The optimizer state of ``params`` (a dict without ``embed_t``)."""
    _check_trainable(params)
    return adamw_init(params, moment_dtype)


def _microbatch(x: torch.Tensor, i: int, accum: int) -> torch.Tensor:
    """Microbatch ``i`` of ``accum`` of a batch leaf: rows ``[i * mb, (i + 1)
    * mb)``, as the JAX package's reshape takes them (the MoE family's
    capacity groups and aux loss depend on which rows meet). A DTensor leaf
    is gathered over the mesh dims that shard its rows, sliced, and sharded
    again where those dims divide the microbatch (replicated there
    otherwise)."""
    if x.shape[0] % accum:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of accum {accum}")
    mb = x.shape[0] // accum
    if not isinstance(x, DTensor):
        return x[i * mb:(i + 1) * mb]
    mesh, pl = x.device_mesh, list(x.placements)
    if any(p.is_partial() for p in pl):
        raise ValueError("a batch leaf holds partial sums")
    rows = [Replicate() if p.is_shard(0) else p for p in pl]
    part = x.redistribute(mesh, rows)[i * mb:(i + 1) * mb]
    ways = math.prod(mesh.size(d) for d, p in enumerate(pl) if p.is_shard(0))
    return part.redistribute(mesh, pl) if mb % ways == 0 else part


def make_grad_step(cfg: ArchConfig, *, accum: int = 1, remat: str = "none",
                   attn_chunk: int = 512, ssm_chunk: int = 64, act_spec=None,
                   logits_spec=None):
    """Returns grad_step(params, batch) -> (total, metrics, grads): the
    gradients of :func:`loss_fn` over ``tree_leaves(params)``, the first half
    of :func:`make_train_step`'s step (its arguments are that function's).
    ``accum`` > 1 splits the batch into microbatches and averages their
    gradients in f32; ``metrics`` then hold the mean loss as ``loss`` and an
    ``aux`` of 0, and ``total`` is that loss, as in the JAX package."""
    loss = functools.partial(loss_fn, cfg=cfg, remat=remat, attn_chunk=attn_chunk,
                             ssm_chunk=ssm_chunk, act_spec=act_spec,
                             logits_spec=logits_spec)

    def grads_of(params: dict, leaves: list, batch: dict):
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in leaves]
            total, metrics = loss(tree_unflatten(params, live), batch)
            grads = torch.autograd.grad(total, live, materialize_grads=True)
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    def grad_step(params: dict, batch: dict):
        leaves = tree_leaves(params)
        if accum == 1:
            return grads_of(params, leaves, batch)
        grads, lsum = None, torch.zeros((), device=leaves[0].device)
        for i in range(accum):
            _, met, g = grads_of(params, leaves,
                                 {k: _microbatch(v, i, accum) for k, v in batch.items()})
            if grads is None:
                grads = [x.float() for x in g]
            else:
                for a, x in zip(grads, g):
                    a.add_(x.float())
            lsum = lsum + met["loss"]
        grads = [g / accum for g in grads]
        metrics = {"loss": lsum / accum, "aux": torch.zeros_like(lsum)}
        return metrics["loss"], metrics, grads

    return grad_step


def make_train_step(cfg: ArchConfig, *, lr: float = 3e-4, accum: int = 1,
                    remat: str = "none", attn_chunk: int = 512, ssm_chunk: int = 64,
                    weight_decay: float = 0.1, act_spec=None, logits_spec=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), the first two updated in place. ``accum`` > 1 splits the batch
    into microbatches and sums their gradients in f32 (the metrics then
    hold the mean loss as ``loss`` and ``total`` and an ``aux`` of 0, as in
    the JAX package). ``metrics``: ``loss``, ``aux``, ``total``,
    ``grad_norm`` (over all the leaves) and ``step``. ``act_spec`` and
    ``logits_spec`` (DTensor placements) constrain the residual stream and
    the logits of a step on DTensor parameters (``models.forward``). The
    gradients are :func:`make_grad_step`'s."""
    grad_step = make_grad_step(cfg, accum=accum, remat=remat, attn_chunk=attn_chunk,
                               ssm_chunk=ssm_chunk, act_spec=act_spec,
                               logits_spec=logits_spec)

    def train_step(params: dict, opt_state: dict, batch: dict):
        _check_trainable(params)
        total, metrics, grads = grad_step(params, batch)
        params, opt_state = adamw_update(tree_unflatten(params, grads), opt_state, params,
                                         lr=lr, weight_decay=weight_decay)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        metrics = dict(metrics, total=total, grad_norm=gnorm, step=opt_state["step"].clone())
        return params, opt_state, metrics

    return train_step
