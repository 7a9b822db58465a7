"""The op-level cost counter and the Hopper roofline (the counterparts of
repro.perf.hlo_cost and repro.perf.roofline): closed forms, collectives by
the reference's kinds on a fake world, the refusal of a ctypes launch, the
reduced train step's FLOPs against the reference's HLO walker, the peak of
live bytes, the roofline's terms, and CostModelEvaluator's contract."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_reduced as ref_reduced
from repro.models.model import init_params as ref_init_params
from repro.perf.hlo_cost import module_cost
from repro.perf.roofline import RooflineReport as RefReport
from repro.perf.hlo import CollectiveStats as RefStats
from repro.train.step import init_train_state as ref_init_train_state
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.configs import get_reduced
from repro_torch.core import CostModelEvaluator, EvalResult
from repro_torch.kernels import matmul
from repro_torch.kernels.cost import H100_SXM5
from repro_torch.launch.mesh import fake_world, make_mesh_from_plan
from repro_torch.models import abstract_params
from repro_torch.parallel import Spec, distribute
from repro_torch.perf import HW, Cost, RooflineReport, analyze_step, hardware, step_cost
from repro_torch.perf.collectives import COLLECTIVE_KINDS, CollectiveStats, payload_bytes
from repro_torch.perf.op_cost import trace_step
from repro_torch.train import init_train_state, make_train_step

# the reduced qwen1.5-0.5b train step's FLOPs, counted here against the
# reference's HLO walker on the same step: 0.987 (remat none) and 0.988
# (full) measured; eager counts each op once where XLA's fusions count some
# twice. Held to this band.
FLOP_BAND = (0.95, 1.05)


class _Plan:
    def __init__(self, shape, axes):
        self.shape, self.axes = shape, axes


@pytest.mark.parametrize("M,K,N", [(64, 96, 32), (1, 7, 5), (128, 128, 256)])
def test_a_matmul_counts_exactly_2mnk(M, K, N):
    a, b = torch.randn(M, K), torch.randn(K, N)
    cost = step_cost(lambda x, y: x @ y, a, b)
    assert cost.flops == 2 * M * N * K
    assert cost.bytes == 4 * (M * K + K * N + M * N)


def test_ten_layers_count_ten_times_one():
    w = torch.randn(32, 32, device="meta")

    def layers(x, n):
        for _ in range(n):
            x = torch.tanh(x @ w)
        return x

    x = torch.randn(16, 32, device="meta")
    one, ten = step_cost(layers, x, 1), step_cost(layers, x, 10)
    assert ten.flops == 10 * one.flops and ten.bytes == 10 * one.bytes
    assert one.flops == 2 * 16 * 32 * 32 + 16 * 32


def test_elementwise_and_reductions_count_as_the_walker_does():
    x = torch.randn(128, 128)
    cost = step_cost(lambda v: torch.exp(v).sum(), x)
    assert cost.flops == 128 * 128 + 128 * 128  # exp per result, reduce per operand
    cost = step_cost(lambda v: v.mean(dim=0), x)
    assert cost.flops == 128 * 128 + 128
    cost = step_cost(lambda v: v.t().contiguous().view(-1), x)  # views move nothing
    assert cost.flops == 0 and cost.bytes == 2 * 4 * 128 * 128


def test_collectives_by_kind_with_local_payloads_on_a_fake_world():
    from torch.distributed.tensor import Partial, Replicate, Shard

    with fake_world(4):
        mesh = make_mesh_from_plan(_Plan((2, 2), ("data", "model")))
        x = distribute(torch.empty(8, 16, device="meta"), mesh, Spec("data", "model"))

        def step(x):
            full = x.redistribute(mesh, [Replicate(), Replicate()])       # 2 all-gathers
            part = full.to_local()
            from torch.distributed.tensor import DTensor
            p = DTensor.from_local(part, mesh, [Partial(), Replicate()], run_check=False)
            p.redistribute(mesh, [Replicate(), Replicate()])              # all-reduce
            p.redistribute(mesh, [Shard(0), Replicate()])                 # reduce-scatter
            return full

        trace = trace_step(step, x)
    c = trace.cost
    assert set(c.coll_by_kind) == {"all-gather", "all-reduce", "reduce-scatter"}
    assert set(c.coll_by_kind) <= set(COLLECTIVE_KINDS)
    # local shard 4x8 f32 gathered over model (4x16), then over data (8x16)
    assert c.coll_by_kind["all-gather"] == 4 * (4 * 16 + 8 * 16)
    assert c.coll_by_kind["all-reduce"] == 4 * 8 * 16
    assert c.coll_by_kind["reduce-scatter"] == 4 * 8 * 16
    assert c.collective_bytes == sum(c.coll_by_kind.values())
    assert trace.collectives.count_by_kind == {"all-gather": 2, "all-reduce": 1,
                                              "reduce-scatter": 1}
    assert trace.payload_dtypes["all-reduce"] == ["float32"]


def test_payload_is_the_larger_of_result_and_any_operand():
    a, b = torch.empty(4, device="meta"), torch.empty(16, device="meta")
    assert payload_bytes((a,), b) == 64
    assert payload_bytes(([a, a],), (a,)) == 32  # a coalesced argument counts whole
    assert payload_bytes((b, a), (b,)) == 64     # an in-place gather's output argument


def test_a_kernel_launch_inside_the_counted_call_raises():
    def launches_a_kernel(x):
        matmul.tiled_matmul.launches += 1  # what a ctypes launch leaves behind
        return x + 1

    before = matmul.tiled_matmul.launches
    try:
        with pytest.raises(RuntimeError, match="tiled_matmul"):
            step_cost(launches_a_kernel, torch.ones(3))
    finally:
        matmul.tiled_matmul.launches = before


def test_the_peak_holds_arguments_and_the_most_live_temporaries():
    x = torch.empty(1024, device="meta")  # 4 KB

    def fn(x):
        a = x * 2          # +4 KB
        b = a * 3          # +4 KB (a still alive)
        del a
        c = b + 1          # +4 KB (b alive), a freed
        return c

    trace = trace_step(fn, x)
    assert trace.arg_bytes == 4096
    assert trace.peak_bytes == 4096 * 3


@pytest.mark.parametrize("remat", ["none", "full"])
def test_the_reduced_train_steps_flops_are_within_the_band_of_the_references(remat):
    rcfg = dataclasses.replace(ref_reduced("qwen1.5-0.5b"), dtype=jnp.float32)
    params = ref_init_params(rcfg, jax.random.PRNGKey(0))
    B, S = 4, 64
    batch = {"tokens": jnp.zeros((B, S), jnp.int32), "labels": jnp.zeros((B, S), jnp.int32)}
    compiled = jax.jit(ref_make_train_step(rcfg, remat=remat)).lower(
        params, ref_init_train_state(params), batch).compile()
    want = module_cost(compiled.as_text())

    cfg = dataclasses.replace(get_reduced("qwen1.5-0.5b"), dtype=torch.float32)
    tp = abstract_params(cfg)
    tb = {k: torch.zeros(B, S, dtype=torch.int32, device="meta") for k in batch}
    got = step_cost(make_train_step(cfg, remat=remat), tp, init_train_state(tp), tb)
    assert FLOP_BAND[0] <= got.flops / want.flops <= FLOP_BAND[1], (got.flops, want.flops)


def test_the_roofline_terms_and_row_keys_are_the_references():
    cost = Cost(flops=2e12, bytes=6.7e9, collective_bytes=9e9,
                coll_by_kind={"all-gather": 9e9})
    rep = analyze_step(cost, chips=256, peak_memory=40e9, model_flops=400e12, hw=HW)
    assert rep.compute_sec == pytest.approx(2e12 / 989e12)
    assert rep.memory_sec == pytest.approx(6.7e9 / 3.35e12)
    assert rep.collective_sec == pytest.approx(9e9 / 4.5e11)
    assert rep.dominant == "collective" and rep.bound_sec == rep.collective_sec
    assert rep.useful_flops_ratio == pytest.approx(400e12 / (2e12 * 256))
    assert rep.fits_card is True
    ref = RefReport(chips=256, flops_per_device=2e12, bytes_per_device=6.7e9,
                    collective_bytes_per_device=9e9,
                    collectives=RefStats({"all-gather": 9e9}, {"all-gather": 1}),
                    peak_memory_per_device=40e9, model_flops=400e12)
    assert set(ref.row()) <= set(rep.row())
    assert RooflineReport.__dataclass_fields__.keys() == RefReport.__dataclass_fields__.keys()


def test_hardware_takes_the_cards_figures_and_no_tpu_figure():
    assert hardware(torch.bfloat16, H100_SXM5).peak_flops == 989e12
    assert hardware(torch.float32, H100_SXM5).peak_flops == 67e12
    hw = hardware(torch.bfloat16, H100_SXM5)
    assert (hw.hbm_bw, hw.link_bw, hw.memory_bytes) == (3.35e12, 4.5e11, 80e9)
    assert not {197e12, 819e9, 50e9, 16e9} & {hw.peak_flops, hw.hbm_bw, hw.link_bw,
                                               hw.memory_bytes}


def test_cost_model_evaluator_scores_and_penalises_like_the_reference():
    ev = CostModelEvaluator(lambda config: (lambda: config["x"]),
                            score=lambda built: (built * 2.0, {"x": built}))
    res = ev({"x": 3})
    assert res == EvalResult(6.0, True, {"x": 3})

    def broken(config):
        def thunk():
            raise ValueError("cannot trace")
        return thunk

    bad = CostModelEvaluator(broken, penalty=123.0)({"x": 1})
    assert (bad.objective, bad.ok) == (123.0, False)
    assert bad.info["error"] == "ValueError: cannot trace" and "trace" in bad.info


def test_cost_model_evaluator_defaults_to_the_roofline_of_a_traced_cell():
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.cells import plan_cell

    with fake_world(8):
        mesh = make_mesh_from_plan(_Plan((2, 4), ("data", "model")))

        def factory(config):
            def thunk():
                plan = plan_cell("qwen1.5-0.5b", "decode_32k", mesh)
                plan.cfg = get_reduced("qwen1.5-0.5b")
                plan.shape = ShapeSpec("decode", "decode", 32, 8)
                return plan, mesh
            return thunk

        res = CostModelEvaluator(factory)({})
    assert res.ok and res.objective == res.info["bound_sec"] > 0
    assert res.info["chips"] == 8 and res.info["hw"] == hardware().name
    assert isinstance(res.info["collective_detail"], str)


def test_collective_stats_summary_is_the_references():
    stats = CollectiveStats({"all-gather": 2e6, "all-reduce": 5e5}, {"all-gather": 3,
                                                                  "all-reduce": 1})
    ref = RefStats({"all-gather": 2e6, "all-reduce": 5e5}, {"all-gather": 3, "all-reduce": 1})
    assert stats.summary() == ref.summary()
    assert (stats.total_bytes, stats.total_count) == (ref.total_bytes, ref.total_count)
