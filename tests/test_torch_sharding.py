"""The port's sharding rules against the reference's: parameter, cache and
batch specs leaf by leaf, exactly, for six architectures on both production
meshes (the duck-typed meshes of tests/test_sharding.py serve both
packages); ``make_profile``; the specs' DTensor placements, and shards on a
fake world of 8 ranks."""

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as ref_config
from repro.launch.cells import input_specs as ref_input_specs
from repro.models.model import abstract_params as ref_abstract_params
from repro.models.model import init_cache as ref_init_cache
from repro.parallel.sharding import (
    batch_specs as ref_batch_specs,
    cache_specs as ref_cache_specs,
    make_profile as ref_make_profile,
    param_specs as ref_param_specs,
)
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.cells import input_specs
from repro_torch.launch.mesh import fake_world, make_mesh_from_plan
from repro_torch.models import abstract_params, init_cache
from repro_torch.parallel import (
    Spec,
    batch_specs,
    cache_specs,
    distribute,
    make_profile,
    named,
    param_specs,
)
from repro_torch.parallel.sharding import axis_sizes, placement_mesh
from repro_torch.tree import tree_map_with_path


class _MeshLike:
    """Duck-typed mesh carrying only .shape and .axis_names."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes


MESH1 = _MeshLike((16, 16), ("data", "model"))
MESH2 = _MeshLike((2, 16, 16), ("pod", "data", "model"))
ARCHS = ["qwen2-vl-7b", "deepseek-v2-236b", "mixtral-8x7b", "mamba2-780m",
         "whisper-large-v3", "gemma3-1b"]


def _ax(a):
    return a[0] if isinstance(a, tuple) and len(a) == 1 else a


def _canon(spec) -> tuple:
    return tuple(_ax(e) for e in tuple(spec))


def _ref_flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(getattr(k, "key", str(k)) for k in path): _canon(s) for path, s in flat}


def _port_flat(tree) -> dict:
    out = {}
    tree_map_with_path(lambda path, s: out.__setitem__(tuple(path), _canon(s)), tree)
    return out


def _profiles(mesh):
    """(reference, port) profiles of every kind and the catalog's batches."""
    for kind, batch in (("train", 256), ("prefill", 32), ("decode", 128), ("decode", 1)):
        yield ref_make_profile(mesh, kind, batch), make_profile(mesh, kind, batch)


@pytest.mark.parametrize("mesh", [MESH1, MESH2], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch, mesh):
    cfg, rcfg = get_config(arch), ref_config(arch)
    rparams, params = ref_abstract_params(rcfg), abstract_params(cfg)
    for rprof, prof in _profiles(mesh):
        assert (prof.batch_axes, prof.fsdp_axes, prof.tp_axis) == \
            (rprof.batch_axes, rprof.fsdp_axes, rprof.tp_axis)
        want = _ref_flat(ref_param_specs(rparams, mesh, rprof, rcfg))
        got = _port_flat(param_specs(params, mesh, prof, cfg))
        assert got == want


@pytest.mark.parametrize("mesh", [MESH1, MESH2], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS + ["zamba2-1.2b"])
def test_cache_and_batch_specs_equal_the_references(arch, mesh):
    cfg, rcfg = get_config(arch), ref_config(arch)
    rcache = jax.eval_shape(lambda: ref_init_cache(rcfg, 128, 1024))
    cache = init_cache(cfg, 128, 1024, device="meta")
    for rprof, prof in _profiles(mesh):
        assert _port_flat(cache_specs(cache, mesh, prof, cfg)) == \
            _ref_flat(ref_cache_specs(rcache, mesh, rprof, rcfg))
        for shape in SHAPES.values():
            got = _port_flat(batch_specs(input_specs(cfg, shape), mesh, prof))
            want = _ref_flat(ref_batch_specs(ref_input_specs(rcfg, shape), mesh, rprof))
            assert got == want


@pytest.mark.parametrize("shape,axes,kind,batch", [
    ((2, 16, 16), ("pod", "data", "model"), "decode", 1),
    ((2, 16, 16), ("pod", "data", "model"), "decode", 128),
    ((2, 16, 16), ("pod", "data", "model"), "decode", 2),
    ((2, 16, 16), ("pod", "data", "model"), "prefill", 16),
    ((16, 16), ("data", "model"), "train", 256),
    ((16, 16), ("data", "model"), "prefill", 8),
])
def test_make_profile_equals_the_references(shape, axes, kind, batch):
    mesh = _MeshLike(shape, axes)
    got, want = make_profile(mesh, kind, batch), ref_make_profile(mesh, kind, batch)
    assert (got.batch_axes, got.fsdp_axes) == (want.batch_axes, want.fsdp_axes)
    assert _canon(got.batch_spec(2)) == _canon(want.batch_spec(2))


def test_specs_become_placements_and_refuse_a_shared_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    with fake_world(8):
        mesh = make_mesh_from_plan(_Plan((2, 4), ("data", "model")))
        assert named(mesh, Spec("model", "data")) == (Shard(1), Shard(0))
        assert named(mesh, Spec(None, ("data", "model"))) == (Shard(1), Shard(1))
        assert named(mesh, Spec(None, None)) == (Replicate(), Replicate())
        tree = named(mesh, {"a": Spec("data"), "b": {"c": Spec(None, "model")}})
        assert tree == {"a": (Shard(0), Replicate()), "b": {"c": (Replicate(), Shard(1))}}
        with pytest.raises(ValueError, match="shards dims"):
            named(mesh, Spec("data", "data"))
        with pytest.raises(ValueError, match="mesh's order"):
            named(mesh, Spec(("model", "data")))


def test_distribute_places_meta_shards_of_the_local_shape():
    with fake_world(8):
        mesh = make_mesh_from_plan(_Plan((2, 4), ("data", "model")))
        assert axis_sizes(mesh) == {"data": 2, "model": 4}
        tree = {"w": torch.empty(6, 8, device="meta"), "b": torch.empty(8, device="meta")}
        out = distribute(tree, mesh, {"w": Spec("data", "model"), "b": Spec(None)})
        assert tuple(out["w"].shape) == (6, 8)
        assert tuple(out["w"].to_local().shape) == (3, 2)
        assert out["w"].to_local().device.type == "meta"
        assert tuple(out["b"].to_local().shape) == (8,)


def test_multi_pod_placement_joins_pod_and_data():
    from torch.distributed.tensor import Replicate, Shard

    with fake_world(16):
        mesh = make_mesh_from_plan(_Plan((2, 2, 4), ("pod", "data", "model")))
        flat, join = placement_mesh(mesh)
        assert tuple(flat.mesh_dim_names) == ("pod+data", "model")
        assert tuple(flat.shape) == (4, 4)
        spec = join(Spec(("pod", "data"), "model"))
        assert named(flat, spec) == (Shard(0), Shard(1))
        assert join({"x": Spec(None, None)}) == {"x": Spec(None, None)}
        assert named(flat, join(Spec(None))) == (Replicate(), Replicate())
        with pytest.raises(ValueError, match="alone"):
            join(Spec("pod", None))


class _Plan:
    def __init__(self, shape, axes):
        self.shape, self.axes = shape, axes
