"""The port's tuning loop against the JAX package's, on the CPU: store
signatures of the canonical problems, the autotune CLI's store round trip
(``--store`` publishes what ``DispatchService`` resolves as an exact hit,
``--warm-start`` re-evaluates it first, ``--prune-infeasible``), the
PolyBench dispatch builders (the port's plain versions against the
reference's host molds on the same numpy inputs, tolerances of
tests/test_kernels.py: f32 2e-3, mm3 and covariance 5e-3, Floyd-Warshall
exact), the feasibility pass's verdicts, and background tuning: a miss
enqueues one campaign that publishes and hot-swaps, warm-started from the
store, on tensors of its own."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analyze.feasibility import check_config as jax_check_config
from repro.core import EvalResult as JaxEvalResult
from repro.core.space import ConfigurationSpace as JaxSpace
from repro.core.space import Ordinal as JaxOrdinal
from repro.dispatch import BackgroundTuner as JaxBackgroundTuner
from repro.dispatch import TuningStore as JaxStore
from repro.dispatch import registered as jax_registered
from repro.kernels import problems as jproblems
from repro.kernels import spaces as jspaces
from repro.kernels import variants as jvariants
from repro_torch.analyze import check_config
from repro_torch.core import EvalResult
from repro_torch.core.database import PerformanceDatabase
from repro_torch.core.space import ConfigurationSpace, Ordinal
from repro_torch.dispatch import (
    BackgroundTuner,
    DispatchService,
    TuningRecord,
    TuningStore,
    register,
    registered,
)
from repro_torch.kernels import problems, ref, spaces, variants
from repro_torch.kernels.syr2k import syr2k_plain
from repro_torch.launch import autotune

KERNELS = sorted(jproblems.BENCH_DIMS)
POLYBENCH = ("syr2k", "mm3", "lu", "heat3d", "covariance", "floyd_warshall")
F32TOL = dict(atol=2e-3, rtol=2e-3)
TOL = {"syr2k": F32TOL, "lu": F32TOL, "heat3d": F32TOL,
       "mm3": dict(atol=5e-3, rtol=5e-3), "covariance": dict(atol=5e-3, rtol=5e-3),
       "floyd_warshall": dict(atol=0.0, rtol=0.0)}


def _summary(out: str) -> dict:
    _, _, body = out.partition("\n{")
    return json.loads("{" + body)


# ---------------------------------------------------------------------------
# signatures of the canonical problems
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", KERNELS)
def test_problem_signatures_match_reference(kernel):
    for ours, theirs in (("cpu", "host"), ("gpu", "cost")):
        sig = problems.problem_signature_for(kernel, ours)
        assert sig == jproblems.problem_signature_for(kernel, theirs)
        assert problems.dims_from_signature(kernel, sig) == \
            jproblems.dims_from_signature(kernel, sig)
    assert problems.dims_from_signature(kernel, problems.problem_signature_for(kernel, "gpu")) \
        == problems.LARGE_SHAPES[kernel]


# ---------------------------------------------------------------------------
# the CLI: --store, --warm-start, --prune-infeasible
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["syr2k", "covariance"])
def test_cli_store_resolves_as_exact_hit_and_warm_starts(kernel, tmp_path, capsys):
    store = str(tmp_path / "store")
    assert autotune.main(["--kernel", kernel, "--backend", "cpu", "--max-evals", "4",
                          "--store", store, "--seed", "5"]) == 0
    best = _summary(capsys.readouterr().out)["best_config"]
    rec, = TuningStore(store).records()
    assert (rec.kernel, rec.backend, rec.config) == (kernel, "cpu", best)
    assert rec.signature == problems.problem_signature_for(kernel, "cpu")

    args = problems.problem_inputs(kernel, problems.BENCH_DIMS[kernel], "cpu")
    svc = DispatchService(TuningStore(store), backend="cpu", target="host")
    out = svc.call(kernel, *args)
    assert svc.stats["store_exact"] == 1 and svc.stats["build_failed"] == 0
    want = ref.syr2k_ref(*args) if kernel == "syr2k" else ref.covariance_ref(*args)
    torch.testing.assert_close(out, want, **F32TOL)

    db = str(tmp_path / "warm")
    assert autotune.main(["--kernel", kernel, "--backend", "cpu", "--max-evals", "2",
                          "--warm-start", store, "--db", db, "--seed", "6"]) == 0
    assert "warm-start: nearest store config re-evaluated first" in capsys.readouterr().out
    assert PerformanceDatabase(db).records[0].config == best


def test_cli_warm_start_from_an_empty_store_is_a_cold_start(tmp_path, capsys):
    assert autotune.main(["--kernel", "syr2k", "--backend", "cpu", "--max-evals", "2",
                          "--warm-start", str(tmp_path / "none")]) == 0
    assert "warm-start: store has no compatible record; cold start" in capsys.readouterr().out


def test_cli_prune_infeasible_reports_its_count(tmp_path, capsys):
    assert autotune.main(["--kernel", "heat3d", "--backend", "cpu", "--max-evals", "3",
                          "--prune-infeasible"]) == 0
    out = capsys.readouterr().out
    assert "feasibility: pruned 0 statically-infeasible candidate(s)" in out
    assert set(_summary(out)) == {"best_config", "best_objective_sec", "found_at_eval",
                                  "importance", "device", "launches", "n_evaluated",
                                  "n_failed", "wall_sec", "timings"}


# ---------------------------------------------------------------------------
# the PolyBench dispatch builders against the reference's
# ---------------------------------------------------------------------------

SMALL = {"syr2k": (48, 32), "mm3": (20, 18, 16, 15, 17), "lu": (24,), "heat3d": (12, 2),
         "covariance": (30, 24), "floyd_warshall": (24,)}


def _small_problem(kernel):
    dims = SMALL[kernel]
    if kernel == "heat3d":
        return ref.init_heat3d(dims[0]), {"tsteps": dims[1]}
    return getattr(ref, f"init_{kernel}")(*dims), {}


@pytest.mark.parametrize("kernel", POLYBENCH)
def test_polybench_builders_match_reference(kernel):
    arrays, static = _small_problem(kernel)
    space = spaces.kernel_space(kernel, target="host", seed=11)
    rng = np.random.default_rng(11)
    cfgs = [space.default_configuration()] + [space.sample_configuration(rng) for _ in range(2)]
    for cfg in cfgs:
        if kernel == "lu":
            cfg = dict(cfg, bs=min(cfg["bs"], 8))   # several block steps at N = 24
        v = variants.DISPATCH_BUILDERS[kernel](cfg, **static)
        args = ref.to_device(arrays, "cpu")
        v.check(*args)
        got = v(*args)
        want = jvariants.DISPATCH_BUILDERS[kernel](cfg, **static)(
            *(jnp.asarray(a) for a in arrays))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[kernel])


def test_registered_kernels_match_reference():
    # other test modules register toy kernels in both registries: compare the
    # built-in ones, and every one of them must be there
    builtin = set(jspaces.KERNEL_SPACES)
    assert sorted(set(registered()) & builtin) == sorted(set(jax_registered()) & builtin) \
        == sorted(builtin)
    assert set(variants.DISPATCH_BUILDERS) == set(jvariants.DISPATCH_BUILDERS)
    assert set(variants.HOST_VARIANTS) == set(jvariants.HOST_VARIANTS)


def test_host_factories_time_the_plain_versions():
    C, A, B = ref.to_device(ref.init_syr2k(40, 30), "cpu")
    fn, args = variants.syr2k_host((C, A, B))({"bi": 16, "bj": 16, "bk": 16})
    torch.testing.assert_close(fn(*args), syr2k_plain(C, A, B))
    (H,) = ref.to_device(ref.init_heat3d(10), "cpu")
    fn, args = variants.heat3d_host((H,), tsteps=2)({"bi": 4, "fuse_t": 2})
    torch.testing.assert_close(fn(*args), ref.heat3d_ref(H, 2))


# ---------------------------------------------------------------------------
# feasibility: the reference's verdicts on the host spaces
# ---------------------------------------------------------------------------

POISONED = [dict(bi=0, bj=8, bk=8), dict(bj=8), dict(bi="x", bj=8, bk=8, bs=4),
            dict(bs=-1, bi=8, bj=8, unroll=3), dict(bi=4, fuse_t=3), dict(impl="triton"),
            dict(impl="pallas", bk=16, hg=1, page=48), dict(bm=8, bn=0, bk=4)]


@pytest.mark.parametrize("kernel", KERNELS)
def test_check_config_verdicts_match_reference(kernel):
    space = jspaces.kernel_space(kernel, target="host", seed=3)
    rng = np.random.default_rng(3)
    cfgs = [space.sample_configuration(rng) for _ in range(50)] + POISONED
    dims = jproblems.BENCH_DIMS[kernel]
    sig = jproblems.problem_signature_for(kernel, "host")
    for cfg in cfgs:
        ours = check_config(kernel, cfg, dims=dims, target="host")
        theirs = jax_check_config(kernel, cfg, dims=dims, target="host")
        assert (ours.ok, ours.reasons) == (theirs.ok, theirs.reasons), cfg
        via_sig = check_config(kernel, cfg, signature=sig, target="host")
        assert (via_sig.ok, via_sig.reasons) == (ours.ok, ours.reasons)
    # the gpu target adds only the shared-memory rule, inert without a card
    assert check_config(kernel, POISONED[0], dims=dims, target="gpu").reasons == \
        check_config(kernel, POISONED[0], dims=dims, target="host").reasons


def test_infeasible_exact_record_is_quarantined_before_any_build(tmp_path):
    st = TuningStore(str(tmp_path))
    sig = problems.problem_signature_for("heat3d", "cpu")
    st.put(TuningRecord("heat3d", sig, "cpu", dict(bi=4, fuse_t=3), 1e-6))
    svc = DispatchService(st, backend="cpu", target="host")
    (A,) = problems.problem_inputs("heat3d", problems.BENCH_DIMS["heat3d"], "cpu")
    out = svc.call("heat3d", A, tsteps=problems.BENCH_DIMS["heat3d"][1])
    assert svc.stats["infeasible"] == 1 and svc.stats["build_failed"] == 0
    assert st.quarantines("heat3d")[0]["reason"] == "fuse_indivisible:fuse_t"
    torch.testing.assert_close(out, ref.heat3d_ref(A, problems.BENCH_DIMS["heat3d"][1]))


# ---------------------------------------------------------------------------
# background tuning (tests/test_dispatch.py's cases, on the port)
# ---------------------------------------------------------------------------

_SEQ = (1, 2, 4, 8, 16, 32)


def _toy_space(target="host", seed=1234, cls=(ConfigurationSpace, Ordinal)):
    cs = cls[0](seed=seed)
    cs.add_hyperparameter(cls[1]("s", _SEQ, default=1))
    return cs


def _toy_evaluator(cfg):
    return EvalResult(1.0 / cfg["s"], True, {})   # minimized at the largest s


register("torch_toy_scale", builder=lambda cfg: lambda x: x * cfg["s"],
         space=_toy_space, make_evaluator=lambda factory: _toy_evaluator)


def test_background_tuner_publishes_and_hot_swaps(tmp_path):
    store = TuningStore(str(tmp_path / "s"))
    tuner = BackgroundTuner(store, max_workers=1, max_evals=8, n_initial=3)
    try:
        fut = tuner.submit("torch_toy_scale", ((4,),), "cpu",
                           space=_toy_space(), evaluator=_toy_evaluator)
        assert fut is not None
        recs = tuner.drain()
        assert tuner.errors == []
        assert recs[0] is not None and recs[0].config["s"] == max(_SEQ)
        got = store.get("torch_toy_scale", ((4,),), "cpu")
        assert got is not None and got.source == "background"
    finally:
        tuner.shutdown()


def test_background_tuner_warm_starts_from_neighbors(tmp_path):
    store = TuningStore(str(tmp_path / "s"))
    store.put(TuningRecord("torch_toy_scale", ((8,),), "cpu", {"s": 32}, 1 / 32))
    tuner = BackgroundTuner(store, max_workers=1, max_evals=3, n_initial=1)
    try:
        tuner.submit("torch_toy_scale", ((4,),), "cpu", space=_toy_space(),
                     evaluator=_toy_evaluator)
        recs = tuner.drain()
        assert tuner.errors == []
        assert recs[0] is not None and recs[0].config["s"] == 32
    finally:
        tuner.shutdown()


def test_background_campaign_equals_the_reference_with_a_fixed_seed(tmp_path):
    def run(tuner_cls, store_cls, cls, result_cls):
        store = store_cls(str(tmp_path / tuner_cls.__module__))
        tuner = tuner_cls(store, max_workers=1, max_evals=7, n_initial=3, seed=21)
        try:
            tuner.submit("k", ((16, 16),), "b", space=_toy_space(seed=5, cls=cls),
                         evaluator=lambda cfg: result_cls(1.0 / cfg["s"] + 0.01 * (cfg["s"] == 32),
                                                          True, {}))
            (rec,) = tuner.drain()
            assert tuner.errors == []
            return rec.config, rec.objective, rec.n_evals
        finally:
            tuner.shutdown()

    ours = run(BackgroundTuner, TuningStore, (ConfigurationSpace, Ordinal), EvalResult)
    theirs = run(JaxBackgroundTuner, JaxStore, (JaxSpace, JaxOrdinal), JaxEvalResult)
    assert ours == theirs


def test_dispatch_miss_enqueues_one_background_campaign(tmp_path):
    store = TuningStore(str(tmp_path / "s"))
    tuner = BackgroundTuner(store, max_workers=1, max_evals=6, n_initial=2)
    svc = DispatchService(store, backend="cpu", target="host", tuner=tuner,
                          resolve_ttl_sec=0.0)
    try:
        x = torch.arange(4.0)
        for _ in range(1000):           # every call a miss (no fast-map TTL)
            svc.call("torch_toy_scale", x)
        assert svc.stats["bg_enqueued"] == 1
        tuner.drain()
        assert tuner.errors == []
        torch.testing.assert_close(svc.call("torch_toy_scale", x), x * max(_SEQ))
        assert svc.stats["store_exact"] >= 1
        assert svc.telemetry()["campaigns"] == 1
    finally:
        tuner.shutdown()


def test_background_campaign_neither_reads_nor_writes_the_callers_tensors(tmp_path):
    seen = []

    def builder(cfg):
        def fn(x):
            seen.append((x.data_ptr(), float(x[0])))
            x.mul_(cfg["s"])            # in place, as decode_step writes its cache
            return x
        return fn

    register("torch_toy_inplace", builder=builder, space=_toy_space)
    store = TuningStore(str(tmp_path / "s"))
    tuner = BackgroundTuner(store, max_workers=1, max_evals=4, n_initial=2)
    svc = DispatchService(store, backend="cpu", target="host", tuner=tuner)
    try:
        x = torch.full((4,), 3.0)
        svc.dispatch("torch_toy_inplace", x)
        assert svc.stats["bg_enqueued"] == 1
        x.fill_(7.0)                     # the caller's next step, while the campaign runs
        tuner.drain()
        assert tuner.errors == [] and seen
        assert all(ptr != x.data_ptr() for ptr, _ in seen)
        assert torch.equal(x, torch.full((4,), 7.0))     # never written by the campaign
        assert seen[0][1] == 3.0         # it started from the values at the miss
    finally:
        tuner.shutdown()


def test_cascade_campaigns_wait_for_fidelity(tmp_path):
    # repro_torch.fidelity is ported: a cascade tuner is built, and its
    # campaigns screen on the cost model before they time (more of it:
    # tests/test_torch_fidelity.py)
    tuner = BackgroundTuner(TuningStore(str(tmp_path)), cascade=True, cascade_budgets=(8, 2))
    try:
        assert tuner.cascade and tuner.cascade_budgets == (8, 2)
        assert tuner.stats["cascade_campaigns"] == 0
    finally:
        tuner.shutdown()


def test_a_record_past_the_rules_but_refused_by_the_wrapper_degrades(tmp_path):
    # fuse_t = 4 divides 2 * tsteps (the feasibility rule holds), but the
    # kernel takes fuse_t 1 or 2: the build guard's check refuses it
    st = TuningStore(str(tmp_path))
    sig = problems.problem_signature_for("heat3d", "cpu")
    st.put(TuningRecord("heat3d", sig, "cpu", dict(bi=4, fuse_t=4), 1e-6))
    svc = DispatchService(st, backend="cpu", target="host")
    N, tsteps = problems.BENCH_DIMS["heat3d"]
    (A,) = problems.problem_inputs("heat3d", (N, tsteps), "cpu")
    out = svc.call("heat3d", A, tsteps=tsteps)
    assert svc.stats["build_failed"] == 1 and svc.stats["infeasible"] == 0
    assert st.quarantines("heat3d")[0]["reason"] == "build_failed"
    torch.testing.assert_close(out, ref.heat3d_ref(A, tsteps))


def test_serve_tune_publishes_what_the_next_run_resolves(tmp_path, capsys):
    from repro_torch.launch import serve

    store = str(tmp_path / "store")
    run = ["--device", "cpu", "--reduced", "--batch", "2", "--prompt-len", "6", "--gen", "3",
           "--store", store]
    assert serve.main(run + ["--tune"]) == 0
    out = capsys.readouterr().out
    first = json.loads(out.split("[serve] dispatch stats: ")[1].splitlines()[0])
    assert first["bg_enqueued"] >= 6 and "errors 0" in out
    assert serve.main(run) == 0
    second = json.loads(capsys.readouterr().out.split("[serve] dispatch stats: ")[1]
                        .splitlines()[0])
    assert second["bg_enqueued"] == 0 and second["store_exact"] >= 5
    assert {r.backend for r in TuningStore(store).records()} == {"cpu"}
