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

import torch

from repro_torch.models.common import ArchConfig
from repro_torch.models.model import loss_fn
from repro_torch.train.optim import adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["make_train_step", "init_train_state"]


def _check_trainable(params: dict) -> None:
    if "embed_t" in params:
        raise ValueError("a train state holds no embed_t (the tied unembed's serving copy): "
                         "train models.trainable(params) and rebuild it with "
                         "models.tied_unembed for serving")


def init_train_state(params: dict, moment_dtype: torch.dtype = torch.float32) -> dict:
    """The optimizer state of ``params`` (a dict without ``embed_t``)."""
    _check_trainable(params)
    return adamw_init(params, moment_dtype)


def make_train_step(cfg: ArchConfig, *, lr: float = 3e-4, accum: int = 1,
                    remat: str = "none", attn_chunk: int = 512, ssm_chunk: int = 64,
                    weight_decay: float = 0.1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), the first two updated in place. ``accum`` > 1 splits the batch
    into microbatches and sums their gradients in f32 (the metrics then
    hold the mean loss as ``loss`` and ``total`` and an ``aux`` of 0, as in
    the JAX package). ``metrics``: ``loss``, ``aux``, ``total``,
    ``grad_norm`` (over all the leaves) and ``step``."""
    loss = functools.partial(loss_fn, cfg=cfg, remat=remat, attn_chunk=attn_chunk,
                             ssm_chunk=ssm_chunk)

    def grads_of(params: dict, leaves: list, batch: dict):
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in leaves]
            total, metrics = loss(tree_unflatten(params, live), batch)
            grads = torch.autograd.grad(total, live, materialize_grads=True)
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    def train_step(params: dict, opt_state: dict, batch: dict):
        _check_trainable(params)
        leaves = tree_leaves(params)
        if accum == 1:
            total, metrics, grads = grads_of(params, leaves, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % accum:
                raise ValueError(f"batch {b} is not a multiple of accum {accum}")
            mb = b // accum
            grads, lsum = None, torch.zeros((), device=leaves[0].device)
            for i in range(accum):
                _, met, g = grads_of(params, leaves,
                                     {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
                if grads is None:
                    grads = [x.float() for x in g]
                else:
                    for a, x in zip(grads, g):
                        a.add_(x.float())
                lsum = lsum + met["loss"]
            grads = [g / accum for g in grads]
            metrics = {"loss": lsum / accum, "aux": torch.zeros_like(lsum)}
            total = metrics["loss"]

        params, opt_state = adamw_update(tree_unflatten(params, grads), opt_state, params,
                                         lr=lr, weight_decay=weight_decay)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        metrics = dict(metrics, total=total, grad_norm=gnorm, step=opt_state["step"].clone())
        return params, opt_state, metrics

    return train_step
