"""Carry the JAX package's parameters into the port.

:func:`params_from_numpy` turns ``repro.models.init_params``'s pytree, with
its leaves as numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``),
into the port's tensors under the same keys, so that both packages compute
with the same weights (the two draw different numbers from one seed). It
adds ``embed_t`` for tied embeddings, as ``models.model.init_params`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import tied_unembed

__all__ = ["params_from_numpy"]


# the weight matrices, which the JAX package keeps in cfg.dtype; norm scales
# and biases stay f32 there
WEIGHTS = frozenset({"embed", "unembed", "wq", "wk", "wv", "wo", "wg", "wu", "wd"})


def _tree(tree: dict, device, dtype) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _tree(v, device, dtype)
            continue
        t = torch.from_numpy(np.array(v, dtype=np.float32))  # a writable copy
        out[k] = t.to(device=device, dtype=dtype if k in WEIGHTS else torch.float32)
    return out


def params_from_numpy(tree: dict, device="cpu", dtype: torch.dtype = torch.float32,
                      tie_embeddings: bool = True) -> dict:
    """The port's parameter dict for a JAX-package parameter tree of numpy
    arrays: weight matrices in ``dtype``, norm scales and biases in f32, as
    the JAX package keeps them."""
    params = _tree(tree, torch.device(device), dtype)
    return tied_unembed(params) if tie_embeddings else params
