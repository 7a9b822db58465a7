"""repro_torch.models — the LM substrate: the dense, MoE, SSM, hybrid, VLM
and audio families (the counterpart of ``repro.models``)."""

from repro_torch.models.common import ArchConfig
from repro_torch.models.model import (
    abstract_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    tied_unembed,
    trainable,
)

__all__ = ["ArchConfig", "abstract_params", "decode_step", "forward", "init_cache",
           "init_params", "loss_fn", "tied_unembed", "trainable"]
