"""repro_torch.launch — mesh construction, the dry-run, and the command-line
entry points (autotune, serve, guard, fidelity, train, obs, analyze, fleet,
dryrun)."""

from repro_torch.launch.mesh import make_mesh_from_plan, make_production_mesh

__all__ = ["make_mesh_from_plan", "make_production_mesh"]
