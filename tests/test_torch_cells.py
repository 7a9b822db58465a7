"""The port's dry-run cells against the reference's: ``plan_cell``,
``model_flops``, ``input_specs`` and ``abstract_params`` for every
architecture, shape and mesh; a reduced cell of each kind traced on a fake
world of 8 ranks; the dry-run CLI; and a train step with DTensor params on
the CPU's own (1, 1) mesh against the plain step and the reference's 1x1
mesh step with its activation and logits specs."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_reduced as ref_reduced
from repro.launch.cells import input_specs as ref_input_specs
from repro.launch.cells import model_flops as ref_model_flops
from repro.launch.cells import plan_cell as ref_plan_cell
from repro.models.model import abstract_params as ref_abstract_params
from repro.models.model import init_params as ref_init_params
from repro.train.step import init_train_state as ref_init_train_state
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, get_reduced
from repro_torch.data import SyntheticLM
from repro_torch.launch import dryrun
from repro_torch.launch.cells import build_cell, input_specs, model_flops, plan_cell
from repro_torch.launch.mesh import fake_world, local_mesh, make_mesh_from_plan
from repro_torch.models import abstract_params, trainable
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import Spec, batch_specs, distribute, make_profile, param_specs
from repro_torch.parallel.sharding import named
from repro_torch.perf.op_cost import trace_step
from repro_torch.train import init_train_state, make_train_step
from repro_torch.tree import tree_leaves, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _MeshLike:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes


MESHES = {"16x16": _MeshLike((16, 16), ("data", "model")),
          "2x16x16": _MeshLike((2, 16, 16), ("pod", "data", "model"))}
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32, jnp.int32: torch.int32}


def _dtype(d):
    return DTYPES[jnp.dtype(d).type]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], (*prefix, k))
    else:
        yield prefix, tree


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_plan_cell_model_flops_and_inputs_equal_the_references(arch, mesh):
    m = MESHES[mesh]
    for shape in SHAPES:
        try:
            want = ref_plan_cell(arch, shape, m)
        except ValueError as e:
            with pytest.raises(ValueError, match="long_500k"):
                plan_cell(arch, shape, m)
            assert "long_500k" in str(e)
            continue
        got = plan_cell(arch, shape, m)
        assert (got.arch, got.kind, got.chips) == (want.arch, want.kind, want.chips)
        assert dataclasses.asdict(got.shape) == dataclasses.asdict(want.shape)
        assert (got.profile.batch_axes, got.profile.fsdp_axes, got.profile.tp_axis) == \
            (want.profile.batch_axes, want.profile.fsdp_axes, want.profile.tp_axis)
        assert got.knobs == want.knobs
        assert model_flops(got) == ref_model_flops(want)
        ins, rins = input_specs(got.cfg, got.shape), ref_input_specs(want.cfg, want.shape)
        assert sorted(ins) == sorted(rins)
        for k in ins:
            assert tuple(ins[k].shape) == tuple(rins[k].shape), (shape, k)
            assert ins[k].dtype == _dtype(rins[k].dtype) and ins[k].device.type == "meta"


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_params_equal_the_references_shapes_and_dtypes(arch):
    from repro.configs import get_config as ref_config
    from repro_torch.configs import get_config

    got = dict(_flat(abstract_params(get_config(arch))))
    want = dict(_flat(ref_abstract_params(ref_config(arch))))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert leaf.dtype == _dtype(want[path].dtype), path
        assert leaf.device.type == "meta"


class _Plan:
    def __init__(self, shape, axes):
        self.shape, self.axes = shape, axes


@pytest.mark.parametrize("arch,kind", [
    ("qwen1.5-0.5b", "train"), ("qwen1.5-0.5b", "prefill"), ("qwen1.5-0.5b", "decode"),
    ("mixtral-8x7b", "train"), ("deepseek-v2-236b", "decode"), ("mamba2-780m", "train"),
    ("zamba2-1.2b", "decode"), ("qwen2-vl-7b", "prefill"), ("whisper-large-v3", "train"),
])
def test_a_reduced_cell_of_each_kind_traces_on_a_fake_world(arch, kind):
    """A reduced config's cell traces on a (2, 4) mesh of fake ranks: meta
    shards, every collective one rank's, nothing allocated."""
    name = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    accum = 2 if arch == "qwen1.5-0.5b" else 1  # one cell of microbatches on their shards
    with fake_world(8):
        mesh = make_mesh_from_plan(_Plan((2, 4), ("data", "model")))
        plan = plan_cell(arch, name, mesh, {"ssm_chunk": 32, "attn_chunk": 32, "accum": accum})
        plan.cfg = get_reduced(arch)
        plan.shape = ShapeSpec(name, kind, 64, 8)
        cell, aux = build_cell(plan, mesh)
        trace = trace_step(cell.fn, *cell.args)
    assert aux["chips"] == 8 and aux["kind"] == kind
    assert trace.cost.flops > 0 and trace.cost.bytes > 0 and trace.peak_bytes > trace.arg_bytes
    assert trace.cost.collective_bytes > 0
    assert set(trace.cost.coll_by_kind) <= {"all-gather", "all-reduce", "reduce-scatter",
                                           "all-to-all", "collective-permute"}
    leaves = [t for t in tree_leaves(cell.args[0])]
    assert all(t.to_local().device.type == "meta" for t in leaves)


def test_dryrun_cli_writes_an_ok_row_with_the_references_keys(tmp_path, capsys):
    out = tmp_path / "d.json"
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    (row,) = json.loads(out.read_text())
    assert {"arch", "shape", "mesh", "status", "seconds", "knobs", "memory_analysis",
            "roofline", "fits_card"} <= set(row)
    assert row["status"] == "ok" and row["mesh"] == "16x16" and row["fits_card"] is True
    r = row["roofline"]
    assert {"chips", "compute_sec", "memory_sec", "collective_sec", "dominant", "bound_sec",
            "roofline_fraction", "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "peak_memory_per_device", "model_flops",
            "useful_flops_ratio", "collective_detail"} <= set(r)
    assert r["chips"] == 256 and r["bound_sec"] > 0
    assert "fits_card=True" in capsys.readouterr().out
    # crash-safe resume: a finished cell is skipped
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    assert "[skip-done]" in capsys.readouterr().out


def test_dryrun_local_mesh_needs_a_card_or_the_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="needs a card"):
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--mesh", "local",
                     "--out", str(tmp_path / "l.json")])
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--mesh", "local",
                        "--device", "cpu", "--out", str(tmp_path / "c.json")]) == 0
    (row,) = json.loads((tmp_path / "c.json").read_text())
    assert row["mesh"] == "1x1" and row["roofline"]["collective_bytes_per_device"] == 0


def test_dryrun_imports_no_jax_and_allocates_no_parameters():
    """deepseek-v2-236b's train cell placed on the 16x16 mesh: 236e9
    parameters and their AdamW moments as DTensors, in a process that holds
    none of them and never imports JAX."""
    code = ("import resource, sys\n"
            "from repro_torch.launch import dryrun\n"
            "from repro_torch.launch.cells import build_cell, plan_cell\n"
            "from repro_torch.launch.mesh import fake_world, make_production_mesh\n"
            "with fake_world(256):\n"
            "    mesh = make_production_mesh()\n"
            "    build_cell(plan_cell('deepseek-v2-236b', 'train_4k', mesh), mesh)\n"
            "assert not [m for m in sys.modules if m == 'jax' or m.startswith('repro.')]\n"
            "print(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    # 472 GB of bf16 parameters and 1.9 TB of f32 moments: the process holds none
    assert int(out.strip().splitlines()[-1]) < 2_000_000  # KB


def _ref_params(cfg, seed=0):
    jp = ref_init_params(cfg, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, jp)


def test_a_dtensor_train_step_on_the_local_mesh_equals_the_plain_and_the_reference():
    """A gloo (1, 1) mesh: the DTensor step's losses and params equal the
    plain step's (1e-6 relative; params atol 1e-6 + rtol 1e-5), and the
    reference's 1x1-mesh step with act_spec and logits_spec gives the same
    losses (f32, 1e-5 relative)."""
    jcfg = dataclasses.replace(ref_reduced("qwen1.5-0.5b"), dtype=jnp.float32)
    cfg = dataclasses.replace(get_reduced("qwen1.5-0.5b"), dtype=torch.float32)
    np_params = _ref_params(jcfg)
    stream = SyntheticLM(cfg.vocab_size, 16, 4, seed=5)
    batches = [stream.batch_at(i) for i in range(2)]

    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jstep = jax.jit(ref_make_train_step(jcfg, lr=1e-3, act_spec=P(("data",), None, None),
                                        logits_spec=P(("data",), None, "model")))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    js = ref_init_train_state(jp)
    ref_losses = []
    with jmesh:
        for b in batches:
            jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
            ref_losses.append(float(jm["loss"]))

    params = trainable(params_from_numpy(np_params, tie_embeddings=cfg.tie_embeddings))
    opt = init_train_state(params)
    step = make_train_step(cfg, lr=1e-3)
    with local_mesh("cpu") as mesh:
        prof = make_profile(mesh, "train", 4)
        specs = param_specs(params, mesh, prof, cfg)
        params_d = distribute(tree_map(torch.clone, params), mesh, specs)
        opt_d = distribute(init_train_state(params), mesh,
                           {"m": specs, "v": specs, "step": Spec()})
        step_d = make_train_step(cfg, lr=1e-3,
                                 act_spec=named(mesh, Spec(("data",), None, None)),
                                 logits_spec=named(mesh, Spec(("data",), None, "model")))
        for b, want in zip(batches, ref_losses):
            tb = {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}
            _, _, m = step(params, opt, tb)
            _, _, md = step_d(params_d, opt_d, distribute(tb, mesh, batch_specs(tb, mesh, prof)))
            got = float(md["loss"].full_tensor())
            assert abs(got - float(m["loss"])) <= 1e-6 * abs(got)
            assert abs(got - want) <= 1e-5 * abs(want)
        # the DTensor table's gradient is summed by index_add_, the plain
        # one's by index_put_: the same terms in another order (f32)
        for a, b in zip(tree_leaves(params_d), tree_leaves(params)):
            torch.testing.assert_close(a.full_tensor(), b, atol=1e-6, rtol=1e-5)


def test_mixtral_on_the_multi_pod_mesh_is_refused_with_the_reason():
    """The reference places mixtral's 8 experts on ``pod`` alone there; the
    port's multi-pod placement joins pod and data (ROADMAP Queue 3)."""
    from repro_torch.launch.mesh import make_production_mesh

    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        plan = plan_cell("mixtral-8x7b", "decode_32k", mesh)
        with pytest.raises(ValueError, match=r"\('pod',\) alone"):
            build_cell(plan, mesh)
