"""repro_torch.parallel — sharding rules and DTensor placements (the
counterpart of ``repro.parallel``)."""

from repro_torch.parallel.sharding import (
    ShardingProfile,
    Spec,
    batch_specs,
    cache_specs,
    distribute,
    make_profile,
    mesh_axis_size,
    named,
    param_specs,
)

__all__ = [
    "ShardingProfile", "Spec", "batch_specs", "cache_specs", "distribute",
    "make_profile", "mesh_axis_size", "named", "param_specs",
]
