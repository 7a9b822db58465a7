"""The sharded train step on a world larger than one: 4 gloo ranks on the
CPU, a (2, 2) ("data", "model") mesh, against the plain step on the same
params and batch. The reduced qwen1.5-0.5b (dense, tied embeddings),
mixtral-8x7b (MoE, sliding window), deepseek-v2-236b (MLA, shared
experts) and mamba2-780m (the SSD scan in two chunks of 8) in f32 take
the vocab-parallel embedding and NLL, the shard-local einsums,
``_microbatch``, the MoE's ``_topk`` and the scan's ``_pad`` and
``_cumsum`` with every placement the (1, 1) meshes leave out: vocab and
heads over ``model``, the batch and the FSDP storage over ``data``; with
and without sequence parallelism, with 2 microbatches, and with no
``logits_spec`` (the logits left as partial sums) or no specs at all.

A second world of 6 gloo ranks holds the multi-pod placement
(``parallel.placement_mesh``) where the experts go over one data axis
alone, on the (pod, data, model) mesh itself, and the rest of the step on
the joined (pod+data, model) mesh: the reduced mixtral-8x7b's 4 experts on
``pod`` of a (2, 3, 1) mesh, and on ``data`` of a (3, 2, 1) one, with its
groups replicated (one group of all tokens) and sharded over the joined
dim (groups of 8 tokens, two a rank: the experts' all-to-all), and d_model 96 where
``d`` is also FSDP-sharded over the other data axis.

Each rank runs every case; the parent reads what rank 0 measured: the
loss within 1e-5 relative of the plain step's, and each gradient leaf
within rtol 1e-5 and an atol of the larger of 1e-6 and twice the plain
f32 step's own largest distance from the f64 step on that leaf (f32 sums
in another order: the shards' and the collectives'; the SSD scan's f32
rounding reaches 5e-6 on mamba2's gradients, the dense family's stays
below 5e-7; the MoE router computes in f32 at any dtype, so the MoE
family, which has no f64 step, is held at atol 1e-6). The ranks are
processes of their own (this file run as a script), on a FileStore in
the test's temporary directory; no network.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

WORLD = 4
ARCHS = ("qwen1.5-0.5b", "mixtral-8x7b", "deepseek-v2-236b", "mamba2-780m")
# name -> (seq_parallel, accum, act_spec and logits_spec given, logits_spec given)
CASES = {
    "specs": (False, 1, True, True),
    "seq_parallel": (True, 1, True, True),
    "accum2": (False, 2, True, True),
    "logits_spec_none": (False, 1, True, False),
    "no_specs": (False, 1, False, False),
}
# name -> (mesh shape over ("pod", "data", "model"), cfg overrides, the
# experts' mesh axis)
POD_WORLD = 6
POD_CASES = {
    "pod": ((2, 3, 1), {}, "pod"),
    "pod_grouped_fsdp": ((2, 3, 1), {"d_model": 96, "moe_group": 8}, "pod"),
    "data_grouped_fsdp": ((3, 2, 1), {"d_model": 96, "moe_group": 8}, "data"),
}
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-5
TIMEOUT = 240


def _case(arch: str, name: str, mesh) -> dict:
    import dataclasses

    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.models import init_params, trainable
    from repro_torch.parallel import Spec, batch_specs, distribute, make_profile, param_specs
    from repro_torch.parallel.sharding import named
    from repro_torch.train.step import make_grad_step
    from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

    seq_parallel, accum, act, logits = CASES[name]
    cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    params = trainable(init_params(cfg, torch.Generator().manual_seed(0)))
    batch = make_batch(SyntheticLM(cfg.vocab_size, 16, 4, seed=1), 0, "cpu")
    total, _, grads = make_grad_step(cfg, accum=accum, ssm_chunk=8)(params, batch)
    grads64 = grads  # the MoE router runs in f32 whatever the dtype: no f64 step
    if cfg.family != "moe":
        _, _, grads64 = make_grad_step(dataclasses.replace(cfg, dtype=torch.float64),
                                       accum=accum, ssm_chunk=8)(
            tree_map(torch.Tensor.double, params), batch)

    prof = make_profile(mesh, "train", 4)
    params_d = distribute(tree_map(torch.clone, params), mesh,
                          param_specs(params, mesh, prof, cfg))
    batch_d = distribute(batch, mesh, batch_specs(batch, mesh, prof))
    act_spec = named(mesh, Spec(("data",), "model" if seq_parallel else None, None))
    vocab = "model" if cfg.vocab_size % 2 == 0 else None
    logits_spec = named(mesh, Spec(("data",), None, vocab))
    step_d = make_grad_step(cfg, accum=accum, ssm_chunk=8,
                            act_spec=act_spec if act else None,
                            logits_spec=logits_spec if logits else None)
    total_d, _, grads_d = step_d(params_d, batch_d)
    loss_d = float(total_d.full_tensor() if hasattr(total_d, "full_tensor") else total_d)

    leaves = {}
    paths = tree_leaves(tree_map_with_path(lambda p, _: ".".join(p), params))
    for path, g, g64, gd in zip(paths, grads, grads64, grads_d):
        gd = gd.full_tensor() if hasattr(gd, "full_tensor") else gd
        err = (gd.double() - g.double()).abs()
        f32_err = float((g.double() - g64).abs().max())
        room = max(GRAD_ATOL, 2 * f32_err) + GRAD_RTOL * g.double().abs()
        leaves[path] = {"worst": float((err / room).max()), "max_abs_err": float(err.max()),
                        "plain_f32_err": f32_err, "max_abs": float(g.abs().max())}
    assert len(leaves) == len(tree_leaves(params))
    return {"loss": float(total), "loss_sharded": loss_d, "leaves": leaves}


def _pod_case(name: str) -> dict:
    """The grad step of POD_CASES[name] placed as ``launch.cells.build_cell``
    places a cell on the multi-pod mesh, against the plain step."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_reduced
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.models import init_params, trainable
    from repro_torch.parallel import (Spec, batch_specs, distribute, make_profile,
                                      param_specs)
    from repro_torch.parallel.sharding import OnMesh, named, placement_mesh
    from repro_torch.train.step import make_grad_step
    from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

    shape, overrides, ep = POD_CASES[name]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("pod", "data", "model"))
    flat, join = placement_mesh(mesh)
    cfg = dataclasses.replace(get_reduced("mixtral-8x7b"), dtype=torch.float32, **overrides)
    params = trainable(init_params(cfg, torch.Generator().manual_seed(0)))
    batch = make_batch(SyntheticLM(cfg.vocab_size, 16, POD_WORLD, seed=1), 0, "cpu")
    total, _, grads = make_grad_step(cfg)(params, batch)

    prof = make_profile(mesh, "train", POD_WORLD)
    specs = join(param_specs(params, mesh, prof, cfg))
    experts = specs["layers"]["moe"]["wg"]
    assert isinstance(experts, OnMesh) and experts[1] == ep, experts
    params_d = distribute(tree_map(torch.clone, params), flat, specs)
    batch_d = distribute(batch, flat, join(batch_specs(batch, mesh, prof)))
    dp = ("pod", "data")
    step_d = make_grad_step(cfg, act_spec=named(flat, join(Spec(dp, None, None))),
                            logits_spec=named(flat, join(Spec(dp, None, "model"))))
    total_d, _, grads_d = step_d(params_d, batch_d)

    leaves = {}
    paths = tree_leaves(tree_map_with_path(lambda p, _: ".".join(p), params))
    for path, g, gd in zip(paths, grads, grads_d):
        err = (gd.full_tensor().double() - g.double()).abs()
        room = GRAD_ATOL + GRAD_RTOL * g.double().abs()
        leaves[path] = {"worst": float((err / room).max()), "max_abs_err": float(err.max()),
                        "max_abs": float(g.abs().max())}
    return {"loss": float(total), "loss_sharded": float(total_d.full_tensor()),
            "leaves": leaves}


def _rank_main(rank: int, store: str, out: str, world: int) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        if world == WORLD:
            mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
            cases = {f"{arch}/{name}": functools.partial(_case, arch, name, mesh)
                     for arch in ARCHS for name in CASES}
        else:
            cases = {name: functools.partial(_pod_case, name) for name in POD_CASES}
        results = {}
        for key, run in cases.items():
            try:
                results[key] = run()
            except Exception as e:  # reported by the parent, case by case
                results[key] = {"error": f"{type(e).__name__}: {e}"}
        if rank == 0:
            Path(out).write_text(json.dumps(results))
    finally:
        dist.destroy_process_group()


def _run_world(tmp, world: int) -> dict:
    store, out = str(tmp / "store"), tmp / "results.json"
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, *filter(None, [os.environ.get("PYTHONPATH")])]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), store, str(out), str(world)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return _run_world(tmp_path_factory.mktemp("multirank"), WORLD)


@pytest.fixture(scope="module")
def pod_results(tmp_path_factory):
    return _run_world(tmp_path_factory.mktemp("multipod"), POD_WORLD)


@pytest.mark.parametrize("name", list(POD_CASES))
def test_experts_over_one_data_axis_of_the_multi_pod_mesh_equal_the_plain_step(
        pod_results, name):
    r = pod_results[name]
    assert "error" not in r, r["error"]
    assert abs(r["loss_sharded"] - r["loss"]) <= LOSS_RTOL * abs(r["loss"]), r
    bad = {k: v for k, v in r["leaves"].items() if not v["worst"] <= 1.0}
    assert not bad, bad


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_the_sharded_grad_step_on_a_2x2_mesh_equals_the_plain_step(results, arch, name):
    r = results[f"{arch}/{name}"]
    assert "error" not in r, r["error"]
    assert abs(r["loss_sharded"] - r["loss"]) <= LOSS_RTOL * abs(r["loss"]), r
    bad = {k: v for k, v in r["leaves"].items() if not v["worst"] <= 1.0}
    assert not bad, bad


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4]))
