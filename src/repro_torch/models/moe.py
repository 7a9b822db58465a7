"""The dense (gated SwiGLU) MLP of ``repro.models.moe``, used by the dense
layers. The routed-expert FFN (``init_moe``, ``moe_ffn``) comes with the MoE
family."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init

__all__ = ["init_mlp", "mlp"]


def init_mlp(generator: torch.Generator, d: int, ff: int, dtype) -> dict:
    return {
        "wg": dense_init((d, ff), generator, 0, dtype),
        "wu": dense_init((d, ff), generator, 0, dtype),
        "wd": dense_init((ff, d), generator, 0, dtype),
    }


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    return h @ p["wd"]
