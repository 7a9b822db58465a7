"""Mixture-of-experts FFN: top-k routing with GShard-style capacity dispatch,
and the dense (gated SwiGLU) MLP used by dense layers and shared experts —
the counterpart of ``repro.models.moe``.

Dispatch and combine are dense (ng, G, E, C) tensors, as in the JAX
package: every expert's weights are read whatever the routing. Shared
experts (DeepSeek-V2) are an always-on dense MLP added to the routed path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.common import dense_init, matmul, reshape

__all__ = ["init_moe", "moe_ffn", "init_mlp", "mlp"]


# ---------------------------------------------------------------------------
# dense (gated SwiGLU) MLP — also used for shared experts and dense layers
# ---------------------------------------------------------------------------


def init_mlp(generator: torch.Generator, d: int, ff: int, dtype) -> dict:
    return {
        "wg": dense_init((d, ff), generator, 0, dtype),
        "wu": dense_init((d, ff), generator, 0, dtype),
        "wd": dense_init((ff, d), generator, 0, dtype),
    }


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(matmul(x, p["wg"])) * matmul(x, p["wu"])
    return matmul(h, p["wd"])


# ---------------------------------------------------------------------------
# routed experts
# ---------------------------------------------------------------------------


def init_moe(generator: torch.Generator, d: int, eff: int, n_experts: int,
             n_shared: int, dtype) -> dict:
    """The router stays f32 whatever ``dtype`` is, as in the JAX package."""
    p = {
        "router": dense_init((d, n_experts), generator, 0, torch.float32),
        "wg": dense_init((n_experts, d, eff), generator, 1, dtype),
        "wu": dense_init((n_experts, d, eff), generator, 1, dtype),
        "wd": dense_init((n_experts, eff, d), generator, 1, dtype),
    }
    if n_shared:
        p["shared"] = init_mlp(generator, d, n_shared * eff, dtype)
    return p


def _topk(probs: torch.Tensor, k: int):
    """``torch.topk`` over the experts (the last dim). DTensor router
    probabilities keep the experts whole on every device (the router is
    replicated over them), so the top k of each device's rows is the top k:
    taken on the shards, whose backward DTensor does not place before torch
    2.13 (it scatters into a plain tensor)."""
    if not isinstance(probs, DTensor):
        return torch.topk(probs, k, dim=-1)
    if any(p.is_shard(probs.ndim - 1) for p in probs.placements):
        raise ValueError("the router's probabilities are sharded over the experts")
    vals, idx = torch.topk(probs.to_local(), k, dim=-1)
    mesh, pl = probs.device_mesh, probs.placements
    return (DTensor.from_local(vals, mesh, pl, run_check=False),
            DTensor.from_local(idx, mesh, pl, run_check=False))


def moe_ffn(
    p: dict,
    x: torch.Tensor,            # (B, S, d)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    group_size: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux_loss). Capacity-dropped tokens fall through to the
    residual stream (their routed contribution is zero), GShard semantics.

    Tokens are split into groups of ``group_size`` (the last one padded with
    zero rows) and capacity is per group, C = max(int(cf * G * k / E), 4).
    A token's slot in an expert is its rank among the group's tokens routed
    there, in token order; a token past C is dropped. The operations run in
    the JAX package's order, so that the same tokens are dropped."""
    B, S, d = x.shape
    E = p["router"].shape[1]
    T = B * S
    xt = reshape(x, T, d)

    G = min(group_size, T)
    pad = (-T) % G
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    ng = xt.shape[0] // G
    xg = reshape(xt, ng, G, d)

    logits = matmul(xg.float(), p["router"])                   # (ng, G, E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k returns the lower index first when values tie; torch.topk
    # leaves the order of tied values unspecified (its CPU and CUDA paths may
    # differ), so exactly tied router probabilities can route differently
    gate_vals, gate_idx = _topk(probs, top_k)                  # (ng, G, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    onehot = F.one_hot(gate_idx, E).float()                    # (ng, G, k, E)
    gates = (onehot * gate_vals[..., None]).sum(dim=2)         # (ng, G, E)
    mask = onehot.sum(dim=2)                                   # (ng, G, E)

    # GShard load-balancing aux loss (over real tokens only)
    real = slice(0, T) if pad else slice(None)  # no slice of a DTensor's sharded dim
    me = reshape(probs, -1, E)[real].mean(dim=0)
    ce = reshape(mask, -1, E)[real].mean(dim=0) / max(top_k, 1)
    aux = E * torch.sum(me * ce)

    # per-group capacity assignment
    C = max(int(capacity_factor * G * top_k / E), 4)
    pos = torch.cumsum(mask, dim=1) - 1.0                      # (ng, G, E)
    keep = mask * (pos < C)
    pos = torch.where(keep > 0, pos, 0.0).long()

    disp = keep[..., None] * F.one_hot(pos, C).float()         # (ng, G, E, C)
    comb = disp * gates[..., None]

    cd = x.dtype
    if isinstance(xg, DTensor):
        # the reference's einsums as batched products over explicit reshapes
        # (a DTensor's einsum reshapes its shards where DTensor cannot):
        # dispatch "gtec,gtd->gecd", the experts "gecd,edf->gecf" with the
        # tokens of all groups in one (E, ng*C, .) batch, combine
        # "gtec,gecd->gtd"
        xe = torch.matmul(reshape(disp.to(cd), ng, G, E * C).transpose(1, 2), xg)
        xe = reshape(reshape(xe, ng, E, C, d).transpose(0, 1).contiguous(), E, ng * C, d)
        h = F.silu(torch.matmul(xe, p["wg"])) * torch.matmul(xe, p["wu"])
        ye = reshape(torch.matmul(h, p["wd"]), E, ng, C, d).transpose(0, 1).contiguous()
        yt = torch.matmul(reshape(comb.to(cd), ng, G, E * C), reshape(ye, ng, E * C, d))
        y = reshape(reshape(yt, ng * G, d)[real], B, S, d)
    else:
        xe = torch.einsum("gtec,gtd->gecd", disp.to(cd), xg)       # (ng, E, C, d)
        h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["wg"]))
        h = h * torch.einsum("gecd,edf->gecf", xe, p["wu"])
        ye = torch.einsum("gecf,efd->gecd", h, p["wd"])            # (ng, E, C, d)
        yt = torch.einsum("gtec,gecd->gtd", comb.to(cd), ye).reshape(ng * G, d)
        y = yt[:T].reshape(B, S, d)

    if "shared" in p:
        y = y + mlp(p["shared"], x)
    return y, aux
