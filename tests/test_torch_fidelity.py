"""repro_torch.fidelity against repro.fidelity on the same inputs — the
calibration fits, Spearman's rho, the ladder's validation errors, fixed-seed
cascades with injected deterministic evaluators (records, best config and
stats bit for bit, also after a resume) — and the Hopper cost model
(``repro_torch.kernels.cost``): +inf exactly where ``SmemBudget`` refuses,
never below its bound, never faster with more padding; the CLIs (``autotune
--cascade``, ``launch.fidelity``), the background tuner's cascade, and rho
recomputed from a run recorded on the card
(``tests/data/torch_fidelity_recorded.json``)."""

import contextlib
import io
import json
import math
import os
import shutil

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import repro.core as jcore
import repro.engine as jengine
import repro.fidelity as jfid
import repro_torch.core as tcore
import repro_torch.engine as tengine
import repro_torch.fidelity as tfid
from repro.fidelity.audit import spearman_rho as jspearman
from repro.launch import autotune as jautotune
from repro_torch.analyze import feasibility
from repro_torch.core.space import config_key
from repro_torch.dispatch import registry
from repro_torch.fidelity.audit import audit_kernel, spearman_rho
from repro_torch.kernels import cost, problems
from repro_torch.kernels.spaces import kernel_space
from repro_torch.launch import autotune, fidelity

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "torch_fidelity_recorded.json")
KERNELS = sorted(cost.KERNEL_COST_FNS)
PACKAGES = {"ref": (jcore, jengine, jfid), "port": (tcore, tengine, tfid)}


# ---------------------------------------------------------------------------
# the copied modules against the reference's, on the same inputs
# ---------------------------------------------------------------------------

def toy_space(core, seed=1):
    cs = core.ConfigurationSpace(seed=seed)
    cs.add_hyperparameters([
        core.Ordinal("a", (1, 2, 4, 8, 16), default=4),
        core.Ordinal("b", (1, 2, 4, 8, 16), default=4),
    ])
    return cs


def true_obj(cfg):
    return (np.log2(cfg["a"]) - 3) ** 2 + (np.log2(cfg["b"]) - 1) ** 2 + 0.1


def make_eval(core, scale, power=1.0):
    def evaluate(cfg):
        return core.EvalResult(scale * true_obj(cfg) ** power, True, {})
    return evaluate


def toy_ladder(core, fid, budgets=(30, 10, 6), promote=(6, 3)):
    return fid.FidelityLadder([
        fid.Rung(0, "cost", make_eval(core, 0.001, 1.1), budget=budgets[0],
                 promote=promote[0]),
        fid.Rung(1, "proxy", make_eval(core, 0.1), budget=budgets[1], promote=promote[1]),
        fid.Rung(2, "hw", make_eval(core, 1.0), budget=budgets[2]),
    ])


def cascade(pkg, **kw):
    core, _, fid = PACKAGES[pkg]
    return fid.CascadeCampaign(toy_space(core), toy_ladder(core, fid), seed=42,
                               n_initial=5, **kw)


def records(db):
    return [(r.index, r.status, r.config, r.objective, r.info) for r in db.records]


def test_calibration_fits_are_identical():
    rng = np.random.default_rng(3)
    pairs = [(lo, 7.0 * lo ** 0.6 * math.exp(rng.normal(0, 0.1)))
             for lo in rng.uniform(1e-5, 1e-2, size=9)]
    pairs += [(float("nan"), 1.0), (0.0, 1.0), (1e-3, float("inf"))]
    for n in range(len(pairs) + 1):
        ours, theirs = tfid.RungCalibration(min_pairs=3), jfid.RungCalibration(min_pairs=3)
        for lo, hi in pairs[:n]:
            assert ours.update(lo, hi) == theirs.update(lo, hi)
        assert ours.describe() == theirs.describe()
        for x in (1e-6, 3e-4, 0.05, -1.0, float("nan")):
            a, b = ours.apply(x), theirs.apply(x)
            assert a == b or (math.isnan(a) and math.isnan(b))


def test_pairs_from_records_are_identical():
    out = []
    for core in (tcore, jcore):
        lo, hi = core.PerformanceDatabase(), core.PerformanceDatabase()
        for cfg, obj in (({"a": 1, "b": 2}, 0.001), ({"a": 2, "b": 2}, 0.002),
                         ({"a": 4, "b": 4}, 0.004)):
            lo.add(cfg, obj)
        for cfg, obj in (({"a": 2, "b": 2}, 0.2), ({"a": 1, "b": 2}, 0.1),
                         ({"a": 8, "b": 8}, 0.8), ({"a": 2, "b": 2}, 0.3)):
            hi.add(cfg, obj)
        fid = tfid if core is tcore else jfid
        out.append(fid.pairs_from_records(lo.records, hi.records))
    assert out[0] == out[1] == [(0.002, 0.2), (0.001, 0.1)]


@pytest.mark.parametrize("n,ties", [(3, False), (10, False), (16, True), (2, False)])
def test_spearman_rho_is_identical(n, ties):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 4, n) if ties else rng.normal(size=n)
    y = x + rng.normal(scale=0.5, size=n)
    a, b = spearman_rho(x, y), jspearman(x, y)
    assert a == b or (math.isnan(a) and math.isnan(b))
    assert math.isnan(spearman_rho([1, 1, 1], [1, 2, 3]))


def _error(fid, core, build):
    try:
        build(fid, make_eval(core, 1.0))
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("build", [
    lambda f, ev: f.Rung(0, "cost", ev, budget=0),
    lambda f, ev: f.Rung(0, "cost", ev, budget=4, promote=-1),
    lambda f, ev: f.FidelityLadder([]),
    lambda f, ev: f.FidelityLadder([f.Rung(1, "a", ev, 4, 2), f.Rung(0, "b", ev, 4)]),
    lambda f, ev: f.FidelityLadder([f.Rung(0, "a", ev, 4, 2), f.Rung(1, "a", ev, 4)]),
    lambda f, ev: f.FidelityLadder([f.Rung(0, "a", ev, 4, 0), f.Rung(1, "b", ev, 4)]),
    lambda f, ev: f.FidelityLadder([f.Rung(0, "a", ev, 4, 5), f.Rung(1, "b", ev, 8)]),
    lambda f, ev: f.FidelityLadder([f.Rung(0, "a", ev, 8, 6), f.Rung(1, "b", ev, 4)]),
], ids=["budget", "promote", "empty", "ascending", "unique", "promotes-nothing",
        "cannot-promote", "can-only-evaluate"])
def test_ladder_validation_errors_are_identical(build):
    ours, theirs = _error(tfid, tcore, build), _error(jfid, jcore, build)
    assert ours is not None and ours == theirs


def test_fixed_seed_cascade_is_bit_identical_to_the_reference():
    ours, theirs = cascade("port", kernel="toy").run(), cascade("ref", kernel="toy").run()
    for a, b in zip(ours.rungs, theirs.rungs, strict=True):
        assert records(a.db) == records(b.db)
        assert a.timings["rung"] == b.timings["rung"]
    assert ours.best.config == theirs.best.config == {"a": 8, "b": 2}
    assert ours.best.objective == theirs.best.objective
    assert ours.stats == theirs.stats
    assert ours.hw_evals == theirs.hw_evals == 6
    assert ours.summary() == theirs.summary()
    for i, rung in enumerate(ours.rungs):
        assert all(r.info.get("rung") == i for r in rung.db.records if r.status == "ok")


def test_priors_with_warm_start_records_are_identical():
    priors = [({"a": 8, "b": 2}, 0.1)]
    ours = cascade("port", warm_start_records=priors)
    theirs = cascade("ref", warm_start_records=priors)
    ours.run(), theirs.run()
    for i in range(3):
        assert ours._priors_for(i) == theirs._priors_for(i)


def test_resume_gives_the_remaining_budgets_and_replays_identically(tmp_path):
    got = {}
    for pkg in PACKAGES:
        root = tmp_path / pkg
        full = cascade(pkg, db_root=str(root / "A")).run()
        # a kill mid-rung-1: rung 0 complete, rung 1 cut to 4 records
        B = root / "B"
        shutil.copytree(root / "A" / "rung0", B / "rung0")
        os.makedirs(B / "rung1")
        lines = (root / "A" / "rung1" / "results.jsonl").read_text().splitlines(keepends=True)
        (B / "rung1" / "results.jsonl").write_text("".join(lines[:4]))
        resumed = cascade(pkg, db_root=str(B)).run()
        assert [s["screened"] for s in resumed.stats["rungs"]] == [0, 6, 6]
        for a, b in zip(full.rungs, resumed.rungs):
            assert [(r.config, r.objective) for r in a.db.records] == \
                [(r.config, r.objective) for r in b.db.records]
        again = cascade(pkg, db_root=str(B)).run()   # a finished cascade: a no-op
        assert all(s["screened"] == 0 for s in again.stats["rungs"])
        got[pkg] = [[(r.config, r.objective) for r in res.db.records]
                    for res in resumed.rungs], resumed.best.config
    assert got["port"] == got["ref"]


def test_single_rung_equals_a_plain_campaign():
    ladder = tfid.FidelityLadder([tfid.Rung(0, "hw", make_eval(tcore, 1.0), budget=12)])
    cres = tfid.CascadeCampaign(toy_space(tcore), ladder, seed=9, n_initial=5).run()
    flat = tengine.Campaign(toy_space(tcore), make_eval(tcore, 1.0), max_evals=12,
                            seed=9, n_initial=5).run()
    assert [(r.config, r.objective) for r in cres.rungs[0].db.records] == \
        [(r.config, r.objective) for r in flat.db.records]


# ---------------------------------------------------------------------------
# the Hopper cost model
# ---------------------------------------------------------------------------

LIMIT = 227 * 1024


def _fake_smem(*args, **kw):
    """A stand-in for the kernels' ``*_smem_bytes`` (which need the built
    library): bytes grow with the first two integer knobs, -1 past 200."""
    ints = [int(a) for a in args if isinstance(a, int) and not isinstance(a, bool)]
    if any(i > 200 for i in ints[:3]):
        return -1
    a, b = (ints + ints)[:2]
    return 16 * a * b


@pytest.fixture
def fake_card(monkeypatch):
    """SmemBudget and the cost model on stand-in shared-memory numbers, as
    if a card were there."""
    from repro_torch.kernels import (
        covariance,
        decode_attention,
        flash_attention,
        floyd_warshall,
        heat3d,
        lu,
        matmul,
        syr2k,
    )

    monkeypatch.setattr(feasibility, "smem_limit", lambda: LIMIT)
    for mod, name in ((syr2k, "syr2k_smem_bytes"), (matmul, "matmul_smem_bytes"),
                      (lu, "lu_factor_diag_smem_bytes"), (heat3d, "heat3d_smem_bytes"),
                      (covariance, "covariance_smem_bytes"),
                      (floyd_warshall, "minplus_smem_bytes"),
                      (flash_attention, "flash_attention_smem_bytes"),
                      (decode_attention, "decode_attention_smem_bytes")):
        monkeypatch.setattr(mod, name, _fake_smem)


def _sample(kernel, seed, target="gpu"):
    space = kernel_space(kernel, target=target, seed=1)
    return space.sample_configurations(1, np.random.default_rng(seed))[0]


DIMS = {k: (problems.LARGE_SHAPES[k], problems.BENCH_DIMS[k], problems.PROXY_DIMS[k])
        for k in KERNELS}


@pytest.mark.parametrize("kernel", KERNELS)
@settings(max_examples=25, deadline=None,   # the stand-ins hold for every input
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 2 ** 32 - 1), which=st.integers(0, 2))
def test_cost_is_infinite_exactly_where_smem_budget_refuses(fake_card, kernel, seed, which):
    cfg, dims = _sample(kernel, seed), DIMS[kernel][which]
    ctx = feasibility.RuleContext(kernel=kernel, dims=dims, target="gpu")
    refused = list(feasibility.SmemBudget().check(cfg, ctx))
    t, info = cost.kernel_cost(kernel, cfg, *dims)
    assert math.isinf(t) == bool(refused)
    if refused:
        assert info["infeasible"] == "smem"
        assert set(info["reasons"]) == {f.code for f in refused}
    else:
        assert 0 < t < math.inf and info["smem_bytes"] is not None


@pytest.mark.parametrize("kernel", KERNELS)
def test_gpu_defaults_at_large_are_finite(kernel):
    cfg = kernel_space(kernel, target="gpu").default_configuration()
    t, info = cost.kernel_cost(kernel, cfg, *problems.LARGE_SHAPES[kernel])
    assert 0 < t < math.inf
    assert {"hbm_bytes", "smem_bytes", "flops", "launches", "modeled_sec"} <= set(info)
    assert info["modeled_sec"] == t and info["launches"] >= 1


# the operations each kernel must do, independent of the model: its peak's
# route is FFMA but for the tensor-core products and min-plus
FLOPS = {
    "syr2k": lambda N, M: 2.0 * N * (N + 1) * M,
    "covariance": lambda N, M: float(M) * (M + 1) * N,
    "matmul": lambda M, K, N: 2.0 * M * K * N,
    "mm3": lambda P, Q, R, S, T: 2.0 * (P * Q * R + R * S * T + P * R * T),
    "heat3d": lambda N, t: 2.0 * t * N ** 3 * 12,
    "floyd_warshall": lambda N: float(N) ** 3,
    "flash_attention": lambda BH, Sq, Sk, hd: 2.0 * BH * Sq * Sk * hd,
    "decode_attention": lambda BH, G, S, hd: 4.0 * BH * G * S * hd,
}


@pytest.mark.parametrize("kernel", KERNELS)
@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), which=st.integers(0, 2))
def test_cost_is_never_below_the_bound(kernel, seed, which):
    cfg, dims = _sample(kernel, seed), DIMS[kernel][which]
    t, info = cost.kernel_cost(kernel, cfg, *dims)
    hw = cost.hopper()
    if kernel in FLOPS:
        assert info["flops"] == FLOPS[kernel](*dims)
    assert info["peak"] in (hw.ffma_flops, hw.tf32x3_flops, hw.minmax_ops)
    assert info["peak"] == hw.minmax_ops if kernel == "floyd_warshall" else True
    bound = max(info["flops"] / info["peak"], info["compulsory_bytes"] / hw.hbm_bytes_per_sec)
    assert t >= bound * (1 - 1e-12)


TILE_KNOBS = {"syr2k": (("bi", 0), ("bj", 0)), "covariance": (("bi", 1), ("bj", 1)),
              "matmul": (("bm", 0), ("bn", 2))}


@pytest.mark.parametrize("kernel,knob,dim", [(k, n, d) for k, v in TILE_KNOBS.items()
                                             for n, d in v])
@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), extent=st.integers(9, 3000),
       t1=st.integers(1, 128), t2=st.integers(1, 128))
def test_more_padding_never_models_faster(kernel, knob, dim, seed, extent, t1, t2):
    # two tiles that cut the extent into as many tiles and run the same
    # thread map class (register tile; matmul's route): the larger one pads
    # more and must not model faster
    t1, t2 = sorted((t1, t2))
    dims = list(problems.BENCH_DIMS[kernel])
    dims[dim] = extent
    t1, t2 = min(t1, extent), min(t2, extent)
    same_class = (t1 > 64) == (t2 > 64) and (kernel != "matmul" or (t1 > 8) == (t2 > 8))
    if -(-extent // t1) != -(-extent // t2) or not same_class:
        return
    cfg = dict(_sample(kernel, seed))
    if kernel != "matmul":   # the symmetric kernels: as many working blocks too
        n, other = extent, min(int(cfg["bj" if knob == "bi" else "bi"]), extent)
        lower = [cost._lower_tiles(n, t, other) if knob == "bi" else
                 cost._lower_tiles(n, other, t) for t in (t1, t2)]
        if lower[0] != lower[1]:
            return
    a = cost.kernel_cost(kernel, {**cfg, knob: t1}, *dims)[0]
    b = cost.kernel_cost(kernel, {**cfg, knob: t2}, *dims)[0]
    assert b >= a * (1 - 1e-12)


def test_launches_are_counted_from_the_drivers():
    lu_default = kernel_space("lu").default_configuration()
    few = cost.kernel_cost("lu", {**lu_default, "bs": 128}, 2000)[1]["launches"]
    many = cost.kernel_cost("lu", {**lu_default, "bs": 16}, 2000)[1]["launches"]
    assert many > 4 * few
    fw = kernel_space("floyd_warshall").default_configuration()   # bs 64: 44 rounds
    info = cost.kernel_cost("floyd_warshall", fw, 2800)[1]
    assert info["launches"] >= 44 * 4
    heat = cost.kernel_cost("heat3d", {"bi": 8, "fuse_t": 2}, 120, 500)[1]
    assert heat["launches"] == 500
    assert cost.kernel_cost("mm3", kernel_space("mm3").default_configuration(),
                            *problems.LARGE_SHAPES["mm3"])[1]["launches"] == 3


def test_model_reads_no_tpu_constant():
    src = open(cost.__file__).read()
    for word in ("VMEM", "MXU", "197e12", "819e9", "roofline"):
        assert word not in src


def test_cost_evaluator_penalises_what_does_not_fit(fake_card):
    evaluate = problems.make_cost_evaluator("syr2k")
    big = dict(kernel_space("syr2k").default_configuration(), bi=128, bj=128)
    res = evaluate(big)
    assert not res.ok and res.objective == 1e9 and res.info["infeasible"] == "smem"
    assert evaluate(kernel_space("syr2k").default_configuration()).ok


# ---------------------------------------------------------------------------
# the CLIs and the background tuner
# ---------------------------------------------------------------------------

def _summary(out: str) -> dict:
    return json.loads("{" + out.split("\n{", 1)[1])


def test_autotune_cpu_cascade_at_bench_dims(tmp_path, capsys):
    db = str(tmp_path / "db")
    argv = ["--kernel", "syr2k", "--backend", "cpu", "--cascade",
            "--rung-budgets", "8,4,2", "--db", db, "--seed", "3"]
    assert autotune.main(argv) == 0
    out = capsys.readouterr().out
    summary = _summary(out)
    block = summary["cascade"]
    assert [r["name"] for r in block["rungs"]] == ["cost", "proxy", "hw"]
    assert block["hw_evals"] == 2 and summary["n_evaluated"] + summary["n_failed"] == 2
    assert block["screened"] == 12 and len(block["eval_sec"]) == 3
    assert summary["launches"] == {"syr2k": 0}
    for level, n in enumerate((8, 4, 2)):
        recs = tcore.PerformanceDatabase(os.path.join(db, f"rung{level}")).records
        assert len(recs) == n and all(r.info.get("rung") == level for r in recs)
    assert autotune.main(argv + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert "resume: rung 2 (hw) has 2 record(s), 0 remaining" in out
    assert all(r["screened"] == 0 for r in _summary(out)["cascade"]["rungs"])


@pytest.mark.parametrize("flags", [
    ["--cascade", "--backend", "cost"],
    ["--rung-budgets", "8,4"],
    ["--promote", "2", "--backend", "cpu"],
])
def test_autotune_rejects_bad_combinations_as_the_reference(flags):
    def error(main, argv):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), pytest.raises(SystemExit):
            main(argv)
        return err.getvalue().strip().splitlines()[-1].split("error: ", 1)[1]

    ref_flags = [("host" if f == "cpu" else f) for f in flags]
    assert error(autotune.main, ["--kernel", "syr2k", *flags]) == \
        error(jautotune.main, ["--kernel", "syr2k", *ref_flags])


def test_autotune_cascade_without_a_card_raises():
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        autotune.main(["--kernel", "syr2k", "--cascade", "--rung-budgets", "8,4,2"])


def test_autotune_cost_backend_scores_without_launching(capsys):
    assert autotune.main(["--kernel", "matmul", "--backend", "cost", "--max-evals", "5"]) == 0
    summary = _summary(capsys.readouterr().out)
    assert summary["device"] == "cost model" and summary["n_evaluated"] == 5


def test_fidelity_show_and_audit_on_the_cpu(tmp_path, capsys):
    assert fidelity.main(["show", "--kernel", "matmul", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["fidelity_ready"] is True
    assert [r["name"] for r in out["ladder"]] == ["cost", "proxy", "hw"]
    assert out["dims"] == list(problems.BENCH_DIMS["matmul"])
    assert out["proxy_dims"] == list(problems.PROXY_DIMS["matmul"])
    path = str(tmp_path / "audit.json")
    rc = fidelity.main(["audit", "--kernel", "syr2k", "--device", "cpu", "--samples", "4",
                        "--json", "--out", path])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    (row,) = rep["audit"]
    assert row["n_sampled"] == 4 and row["target"] == "host" and len(row["pairs"]) == 4
    assert json.load(open(path))["hw"]["sms"] == cost.hopper().sms


@pytest.mark.parametrize("flag,which,table", [
    ("--full-dims", "full", problems.BENCH_DIMS),
    ("--proxy-dims", "proxy", problems.PROXY_DIMS),
])
def test_fidelity_audit_takes_the_reference_dims(flag, which, table, capsys):
    # the reference's --full-dims and the cascade's proxy dims; the report
    # names the dims it measured at
    rc = fidelity.main(["audit", "--kernel", "mm3", "--device", "cpu", "--samples", "3",
                        flag, "--json"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    (row,) = rep["audit"]
    assert rep["dims"] == which and row["dims"] == list(table["mm3"])
    assert row["n_sampled"] == 3
    with pytest.raises(SystemExit):
        fidelity.main(["audit", "--full-dims", "--proxy-dims"])


def test_fidelity_readiness_covers_the_registry():
    cov = problems.fidelity_readiness()
    assert set(cov) == set(registry.registered())
    assert all(cov[k] for k in KERNELS)


def test_background_cascade_publishes_and_counts(tmp_path):
    from repro_torch.dispatch import BackgroundTuner, DispatchService, TuningStore

    store = TuningStore(str(tmp_path / "store"))
    tuner = BackgroundTuner(store, max_workers=1, max_evals=4, n_initial=2, cascade=True,
                            cascade_budgets=(12, 3))
    svc = DispatchService(store, backend="cpu", target="host", tuner=tuner)
    try:
        a, b = problems.problem_inputs("matmul", (4, 96, 96), "cpu")
        svc.call("matmul", a, b)
        (rec,) = tuner.drain()
        assert tuner.errors == [] and rec is not None
        assert tuner.stats["cascade_campaigns"] == 1 and tuner.stats["screened"] == 12
        assert tuner.stats["promoted"] >= 1
        tel = svc.telemetry()
        assert (tel["cascade_campaigns"], tel["screened"]) == (1, 12)
        again = DispatchService(store, backend="cpu", target="host")
        again.call("matmul", a, b)
        assert again.stats["store_exact"] == 1
    finally:
        tuner.shutdown()


def test_cost_backend_falls_back_to_a_flat_campaign(tmp_path, monkeypatch):
    from repro_torch.dispatch import BackgroundTuner, DispatchService, TuningStore

    registry.registered()   # the built-ins, before the registry is swapped
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
    problems.register_cost_backend()
    store = TuningStore(str(tmp_path / "store"))
    tuner = BackgroundTuner(store, max_workers=1, max_evals=4, n_initial=2, cascade=True)
    svc = DispatchService(store, backend="cost", target="gpu", tuner=tuner)
    try:
        a, b = problems.problem_inputs("matmul", (4, 96, 96), "cpu")
        svc.dispatch("matmul", a, b)
        (rec,) = tuner.drain()
        assert tuner.errors == [] and rec is not None and rec.backend == "cost"
        assert tuner.stats["cascade_campaigns"] == 0 and tuner.stats["campaigns"] == 1
        t, _ = cost.kernel_cost("matmul", rec.config, 4, 96, 96)
        assert rec.objective == t     # scored by the model, nothing timed
    finally:
        tuner.shutdown()


# ---------------------------------------------------------------------------
# rho recomputed from a run recorded on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def recorded():
    with open(FIXTURE) as fh:
        return json.load(fh)


def test_recording_is_from_the_card(recorded):
    assert "H100" in recorded["card"] and " W" in recorded["card"]
    assert recorded["device"] == "cuda" and recorded["samples"] == 16
    assert sorted(r["kernel"] for r in recorded["audit"]) == KERNELS
    for row in recorded["audit"]:
        assert row["dims"] == list(problems.LARGE_SHAPES[row["kernel"]])
        assert row["target"] == "gpu" and row["smem_limit"] > 0


@pytest.mark.parametrize("kernel", KERNELS)
def test_rho_reproduces_the_recording(recorded, kernel, monkeypatch):
    row = next(r for r in recorded["audit"] if r["kernel"] == kernel)
    hw = cost.Hopper(**recorded["hw"])
    smem = {config_key(p["config"]): p["smem"] for p in row["pairs"]}
    monkeypatch.setattr(feasibility, "smem_limit", lambda: row["smem_limit"])
    monkeypatch.setattr(feasibility, "smem_needs",
                        lambda k, cfg, dims, limit: [("", b) for b in smem[config_key(cfg)]])
    scores, measured = [], []
    for pair in row["pairs"]:
        t, _ = cost.kernel_cost(kernel, pair["config"], *row["dims"], hw=hw)
        assert math.isfinite(t) == (pair["modeled_sec"] is not None)
        if pair["measured_sec"] is not None:
            scores.append(t)
            measured.append(pair["measured_sec"])
    rho = spearman_rho(scores, measured)
    if row["rho"] is None:
        assert math.isnan(rho)
    else:
        assert rho == pytest.approx(row["rho"], abs=0.02), \
            f"{kernel}: the model's ordering drifted from the recording"
        assert row["screen_ok"] == (row["rho"] >= recorded["rho_min"])


def test_audit_with_the_recorded_timings_injected(recorded, monkeypatch):
    # the same seed and samples draw the recorded configs again
    row = next(r for r in recorded["audit"] if r["kernel"] == "syr2k")
    table = {config_key(p["config"]): p["measured_sec"] for p in row["pairs"]}
    smem = {config_key(p["config"]): p["smem"] for p in row["pairs"]}
    monkeypatch.setattr(feasibility, "smem_limit", lambda: row["smem_limit"])
    monkeypatch.setattr(feasibility, "smem_needs",
                        lambda k, cfg, dims, limit: [("", b) for b in smem[config_key(cfg)]])
    monkeypatch.setattr(cost, "hopper", lambda: cost.Hopper(**recorded["hw"]))
    rep = audit_kernel("syr2k", n_samples=recorded["samples"], seed=recorded["seed"],
                       measure=lambda c: table.get(config_key(c)) or float("nan"))
    assert [p["config"] for p in rep["pairs"]] == [p["config"] for p in row["pairs"]]
    assert rep["rho"] == pytest.approx(row["rho"], abs=0.02)
