"""repro_torch.models — the LM substrate: the dense, MoE, SSM, hybrid and
VLM families (the counterpart of ``repro.models``; the audio family is not
ported yet)."""

from repro_torch.models.common import ArchConfig
from repro_torch.models.model import (
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    tied_unembed,
    trainable,
)

__all__ = ["ArchConfig", "decode_step", "forward", "init_cache", "init_params", "loss_fn",
           "tied_unembed", "trainable"]
