"""repro_torch.models — the LM substrate, dense and MoE families (the
counterpart of ``repro.models``)."""

from repro_torch.models.common import ArchConfig
from repro_torch.models.model import decode_step, forward, init_cache, init_params

__all__ = ["ArchConfig", "decode_step", "forward", "init_cache", "init_params"]
