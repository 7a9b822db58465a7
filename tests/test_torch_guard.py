"""The port's guard against the JAX package's, on the CPU: hardened
evaluation (crash isolation, deadlines, pathological slowdowns, bit-identical
trajectories with the guard off), shadow evaluation (live measurements told
into the store, challengers), the drift watch (quarantine, fallback,
re-campaign; the pure policy; window deltas; offline replay, which decides
as the reference does on one snapshot log), the ``gpu`` backend's watch over
the shadow samples' histogram, guarded background campaigns, the obs
exposition and the guard CLI — tests/test_guard.py's cases without the fleet
and transport ones."""

import json
import time

import numpy as np
import pytest
import torch

from repro.guard import WatchPolicy as JaxWatchPolicy
from repro.guard import replay_decisions as jax_replay_decisions
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro_torch.core import EvalResult
from repro_torch.core.database import FAILED, OK
from repro_torch.core.plopper import PENALTY
from repro_torch.core.space import ConfigurationSpace, Ordinal
from repro_torch.dispatch import BackgroundTuner, DispatchService, TuningRecord, TuningStore
from repro_torch.dispatch.registry import register
from repro_torch.engine import Campaign
from repro_torch.guard import (
    FailureObservation,
    GuardAgent,
    HardenedExecutor,
    HardenPolicy,
    ShadowPolicy,
    WatchPolicy,
    clear_faults,
    guard_counters,
    inject,
    replay_decisions,
    window_stats,
)
from repro_torch.guard.shadow import RACE_ROUNDS
from repro_torch.guard.watch import SHADOW_HISTOGRAM, _decide
from repro_torch.launch import guard as guard_cli
from repro_torch.obs import MetricsRegistry, prometheus_text, read_snapshot_file, write_snapshot


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    clear_faults()
    yield
    clear_faults()


def _space(seed=1234):
    cs = ConfigurationSpace(seed=seed)
    cs.add_hyperparameter(Ordinal("s", (1, 2, 4, 8, 16, 32), default=1))
    cs.add_hyperparameter(Ordinal("t", (1, 2, 4), default=1))
    return cs


def _det_eval(cfg):
    # deterministic "latency": minimized at s=32, t=4; no wall-clock noise
    return EvalResult(1.0 / (cfg["s"] * cfg["t"]), True, {})


def _toy_space(target="host", seed=1234):
    cs = ConfigurationSpace(seed=seed)
    cs.add_hyperparameter(Ordinal("s", (1, 2, 4, 8, 16, 32), default=1))
    return cs


register("torch_guard_toy", builder=lambda cfg: lambda x: x * cfg["s"],
         space=_toy_space,
         make_evaluator=lambda factory: (lambda cfg: EvalResult(1.0 / cfg["s"], True, {})))


# ---------------------------------------------------------------------------
# hardened evaluation
# ---------------------------------------------------------------------------


def test_crash_becomes_failure_observation_with_reason_code():
    def boom(cfg):
        raise ValueError("kaboom")

    ex = HardenedExecutor(boom, HardenPolicy())
    res = ex.submit({"s": 1}).result()
    assert res.ok is False
    assert res.objective == PENALTY
    assert res.info["failure"] == "exception"
    assert res.info["reason"] == "eval_crash:ValueError"
    assert ex.stats["crashes"] == 1
    assert isinstance(FailureObservation("exception", "r", 1.0, 0.0, {}).to_eval_result(),
                      EvalResult)


def test_campaign_survives_crashing_evaluator_and_penalizes_surrogate():
    def flaky(cfg):
        if cfg["s"] >= 16:  # a "region" of the space crashes
            raise RuntimeError("bad tile")
        return _det_eval(cfg)

    ex = HardenedExecutor(flaky, HardenPolicy(), metrics=MetricsRegistry())
    result = Campaign(_space(), executor=ex, max_evals=12, seed=7, n_initial=4).run()
    db = result.db
    assert len(db) == 12
    failed = [r for r in db.records if r.status == FAILED]
    assert failed
    for r in failed:
        assert r.objective == PENALTY
        assert r.info["reason"] == "eval_crash:RuntimeError"
    assert result.best is not None and result.best.config["s"] < 16


def test_hung_evaluator_times_out_without_stalling_campaign():
    with inject("eval.hang", times=1, hang_max_sec=30.0):
        ex = HardenedExecutor(_det_eval, HardenPolicy(deadline_sec=0.25))
        t0 = time.monotonic()
        result = Campaign(_space(), executor=ex, max_evals=6, seed=7, n_initial=3).run()
        wall = time.monotonic() - t0
    assert wall < 10.0
    timeouts = [r for r in result.db.records
                if r.status == FAILED and r.info.get("failure") == "timeout"]
    assert len(timeouts) == 1
    assert timeouts[0].info["reason"] == "eval_timeout:0.25s"
    assert timeouts[0].objective == pytest.approx(0.25 * 10.0)
    assert len([r for r in result.db.records if r.status == OK]) == 5


def test_pathological_slowdown_reclassified_keeping_measurement():
    def ev(cfg):
        return EvalResult(5.0 if cfg["s"] == 1 else 0.001, True, {})

    ex = HardenedExecutor(ev, HardenPolicy(baseline_sec=0.001, slowdown_factor=50.0))
    res = ex.submit({"s": 1, "t": 1}).result()
    assert res.ok is False and res.info["failure"] == "pathological"
    assert res.info["reason"].startswith("pathological_slowdown:")
    assert res.objective == 5.0
    assert ex.submit({"s": 2, "t": 1}).result().ok is True


def test_fixed_seed_trajectory_bit_identical_with_guard_disabled():
    base = Campaign(_space(), _det_eval, max_evals=14, seed=42, n_initial=4).run()
    hardened = Campaign(_space(), executor=HardenedExecutor(_det_eval, HardenPolicy()),
                        max_evals=14, seed=42, n_initial=4).run()
    assert [(r.config, r.objective, r.status) for r in base.db.records] == \
           [(r.config, r.objective, r.status) for r in hardened.db.records]
    assert (base.best.config, base.best.objective) == \
        (hardened.best.config, hardened.best.objective)


# ---------------------------------------------------------------------------
# shadow evaluation
# ---------------------------------------------------------------------------


def _service(tmp_path, backend="cpu", **kw):
    store = TuningStore(str(tmp_path / "store"))
    return DispatchService(store, backend=backend, target="host",
                           metrics=MetricsRegistry(), **kw), store


def test_shadow_eval_tells_live_measurement_into_store(tmp_path):
    svc, store = _service(tmp_path)
    store.put(TuningRecord("torch_guard_toy", ((4,),), "cpu", {"s": 2}, 10.0))
    guard = GuardAgent(svc, shadow=ShadowPolicy(epsilon=1.0, challenger_fraction=0.0))
    svc.attach_guard(guard)
    x = torch.arange(4.0)
    fn = svc.dispatch("torch_guard_toy", x)
    n = guard.shadow.policy.tell_window  # the first tell: the median of a full window
    for _ in range(n):
        torch.testing.assert_close(fn(x), x * 2)
    stats = guard.shadow.snapshot_stats()
    assert stats["shadow_evals"] == n and stats["shadow_tells"] == 1
    rec = store.get("torch_guard_toy", ((4,),), "cpu")
    assert rec.source == "shadow" and rec.objective < 10.0 and rec.config == {"s": 2}
    shadow = window_stats(None, svc.metrics.snapshot(), SHADOW_HISTOGRAM)
    assert shadow[("torch_guard_toy", "4", "cpu")]["count"] == n


def test_one_low_shadow_sample_is_not_told(tmp_path):
    # the store keeps the least objective told and the watch holds the live
    # p50 to it: a lone fast sample must not become the record's objective
    svc, store = _service(tmp_path)
    store.put(TuningRecord("torch_guard_toy", ((4,),), "cpu", {"s": 2}, 10.0))
    guard = GuardAgent(svc, shadow=ShadowPolicy(epsilon=1.0, challenger_fraction=0.0,
                                                tell_window=5))
    for sample in (1.0, 1.0, 0.01, 1.0, 1.0, 1.0, 1.0):
        guard.shadow.on_shadow("torch_guard_toy", ((4,),), {"s": 2}, {}, (torch.zeros(4),),
                               sample, "observe")
    assert guard.shadow.snapshot_stats()["shadow_tells"] == 1
    assert store.get("torch_guard_toy", ((4,),), "cpu").objective == 1.0


def test_shadow_challenger_races_and_counts(tmp_path):
    svc, store = _service(tmp_path)
    store.put(TuningRecord("torch_guard_toy", ((4,),), "cpu", {"s": 2}, 10.0))
    guard = GuardAgent(svc, shadow=ShadowPolicy(epsilon=1.0, challenger_fraction=1.0, seed=3))
    svc.attach_guard(guard)
    x = torch.arange(4.0)
    fn = svc.dispatch("torch_guard_toy", x)
    for _ in range(4):
        fn(x)
    stats = guard.shadow.snapshot_stats()
    assert stats["challenger_evals"] >= 1
    assert stats["shadow_errors"] == 0


def _sleepy_space(target="host", seed=1234):
    cs = ConfigurationSpace(seed=seed)
    cs.add_hyperparameter(Ordinal("s", (1, 4), default=4))
    return cs


def test_challenger_objective_is_on_the_live_scale(tmp_path):
    # the challenger (s=1) and the served config (s=4) are raced back to
    # back; the told objective is the live sample scaled by their ratio, not
    # the challenger's own (hot, millisecond) time
    register("torch_guard_sleepy", space=_sleepy_space,
             builder=lambda cfg: lambda x: (time.sleep(1e-3 * cfg["s"]), x)[1])
    store = TuningStore(str(tmp_path))
    store.put(TuningRecord("torch_guard_sleepy", ((4,),), "cpu", {"s": 4}, 10.0))
    svc = DispatchService(store, backend="cpu", target="host")
    guard = GuardAgent(svc, shadow=ShadowPolicy(epsilon=1.0, challenger_fraction=1.0))
    guard.shadow.on_shadow("torch_guard_sleepy", ((4,),), {"s": 4}, {}, (torch.zeros(4),),
                           0.5, "challenger")
    stats = guard.shadow.snapshot_stats()
    assert stats["challenger_evals"] == 1 and stats["challenger_promoted"] == 1
    rec = store.get("torch_guard_sleepy", ((4,),), "cpu")
    assert rec.config == {"s": 1} and rec.source == "shadow_challenger"
    assert 0.05 < rec.objective < 0.4   # about 0.5 * 1/4


@pytest.mark.parametrize("side,outlier", [(4, 0.2), (1, -1e-3)])
def test_challenger_race_outlasts_one_outlier_call(tmp_path, side, outlier):
    # one timed call of a side is an outlier: the served config (s=4, 4 ms)
    # stalls 200 ms, or the challenger (s=1, 1 ms) takes no time at all; each
    # side's median over its alternating timed calls sets the ratio, so the
    # challenger is still told at about 0.5 * 1/4
    calls = []

    def builder(cfg):
        def run(x):
            extra = 0.0
            if cfg["s"] == side:
                calls.append(1)
                if len(calls) == 2:  # the one after the warm-up call
                    extra = outlier
            time.sleep(1e-3 * cfg["s"] + extra)
            return x
        return run

    name = f"torch_guard_outlier_{side}"
    register(name, space=_sleepy_space, builder=builder)
    store = TuningStore(str(tmp_path))
    store.put(TuningRecord(name, ((4,),), "cpu", {"s": 4}, 10.0))
    svc = DispatchService(store, backend="cpu", target="host")
    guard = GuardAgent(svc, shadow=ShadowPolicy(epsilon=1.0, challenger_fraction=1.0))
    guard.shadow.on_shadow(name, ((4,),), {"s": 4}, {}, (torch.zeros(4),), 0.5, "challenger")
    rec = store.get(name, ((4,),), "cpu")
    assert len(calls) == 1 + RACE_ROUNDS
    assert rec.config == {"s": 1} and rec.source == "shadow_challenger"
    assert 0.05 < rec.objective < 0.4


@pytest.mark.parametrize("stalled", [2, 3])
def test_challenger_is_never_told_below_its_own_race_time(tmp_path, stalled):
    # the served config (s=4, 4 ms, and 4 ms live) stalls 36 ms in most of
    # its timed race calls: the ratio of the medians is then about 1/40, but
    # the challenger (s=1) took at least 1 ms in each of its own calls
    calls = []

    def builder(cfg):
        def run(x):
            extra = 0.0
            if cfg["s"] == 4:
                calls.append(1)
                if 1 < len(calls) <= 1 + stalled:  # timed calls after the warm-up
                    extra = 0.036
            time.sleep(1e-3 * cfg["s"] + extra)
            return x
        return run

    name = f"torch_guard_stalled_{stalled}"
    register(name, space=_sleepy_space, builder=builder)
    store = TuningStore(str(tmp_path))
    store.put(TuningRecord(name, ((4,),), "cpu", {"s": 4}, 10.0))
    svc = DispatchService(store, backend="cpu", target="host")
    guard = GuardAgent(svc, shadow=ShadowPolicy(epsilon=1.0, challenger_fraction=1.0))
    guard.shadow.on_shadow(name, ((4,),), {"s": 4}, {}, (torch.zeros(4),), 4e-3, "challenger")
    rec = store.get(name, ((4,),), "cpu")
    assert len(calls) == 1 + RACE_ROUNDS
    assert rec.config == {"s": 1} and rec.source == "shadow_challenger"
    assert 1e-3 <= rec.objective < 4e-3


def test_execute_wrapper_samples_every_period_th_execution(tmp_path):
    """A served executable counts its own executions inline: every
    ``1/epsilon``-th is sampled, and every ``1/challenger_fraction``-th
    sample of the signature races a challenger (the evaluator counts those
    per signature); a hot swap's new executable counts from 0, where the
    JAX package's count per signature runs on."""
    svc, store = _service(tmp_path)
    store.put(TuningRecord("torch_guard_toy", ((4,),), "cpu", {"s": 2}, 10.0))
    guard = GuardAgent(svc, shadow=ShadowPolicy(epsilon=0.25, challenger_fraction=0.5))
    svc.attach_guard(guard)
    assert guard.shadow_period == 4
    modes = []
    guard.on_shadow = lambda kernel, sig, config, static_kw, args, dt, mode: modes.append(mode)
    x = torch.arange(4.0)
    fn = svc.dispatch("torch_guard_toy", x)
    for _ in range(6):
        fn(x)                       # sampled at its 4th
    svc.invalidate("torch_guard_toy")
    fn2 = svc.dispatch("torch_guard_toy", x)
    assert fn2 is not fn
    for _ in range(6):
        fn2(x)                      # its 4th
    fn(x), fn(x)                    # the first one's 8th
    assert modes == ["observe", "challenger", "observe"]
    # one executable alone: its 4th, 8th and 12th of 12, alternating modes
    svc.invalidate("torch_guard_toy")
    fn3 = svc.dispatch("torch_guard_toy", x)
    seen = []
    for i in range(1, 13):
        n = len(modes)
        fn3(x)
        if len(modes) > n:
            seen.append((i, modes[-1]))
    assert seen == [(4, "challenger"), (8, "observe"), (12, "challenger")]
    assert GuardAgent(svc, shadow=ShadowPolicy(epsilon=0.0)).shadow_period == 0
    assert GuardAgent(svc).shadow_period == 0


def test_shadow_epsilon_zero_never_samples(tmp_path):
    svc, store = _service(tmp_path)
    store.put(TuningRecord("torch_guard_toy", ((4,),), "cpu", {"s": 2}, 10.0))
    guard = GuardAgent(svc, shadow=ShadowPolicy(epsilon=0.0))
    svc.attach_guard(guard)
    x = torch.arange(4.0)
    fn = svc.dispatch("torch_guard_toy", x)
    for _ in range(5):
        fn(x)
    assert guard.shadow.snapshot_stats()["shadow_evals"] == 0
    assert store.get("torch_guard_toy", ((4,),), "cpu").objective == 10.0


# ---------------------------------------------------------------------------
# drift watch
# ---------------------------------------------------------------------------


class _StubTuner:
    """Records re-campaign submissions without running any."""

    def __init__(self):
        self.submitted = []
        self.stats = {}

    def submit(self, kernel, signature, backend, **kw):
        self.submitted.append((kernel, signature, backend))
        return object()


def _drift(svc, store, guard, fn, x, backend):
    for _ in range(5):
        fn(x)
    assert guard.check_once() == []  # first check only sets the window base
    for _ in range(5):
        fn(x)
    assert guard.check_once() == []  # healthy window: no breach
    with inject("dispatch.latency", delay_sec=0.02):  # 200x the baseline
        for _ in range(5):
            fn(x)
        assert guard.check_once() == []  # breach 1 of 2: hysteresis holds
        for _ in range(5):
            fn(x)
        return guard.check_once()  # breach 2: sustained drift -> act


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_drift_quarantines_falls_back_and_requests_retune(tmp_path, backend):
    # backend "gpu": the watch reads the shadow samples' histogram (every call
    # shadowed here), not the executions'
    svc, store = _service(tmp_path, backend=backend, tuner=_StubTuner())
    store.put(TuningRecord("torch_guard_toy", ((4,),), backend, {"s": 2}, 1e-4))
    guard = GuardAgent(svc, watch=WatchPolicy(
        drift_factor=50.0, hysteresis=2, cooldown_sec=0.0, min_samples=4),
        shadow=ShadowPolicy(epsilon=1.0, challenger_fraction=0.0) if backend == "gpu" else None)
    assert guard.histogram == ("dispatch_shadow_seconds" if backend == "gpu"
                               else "dispatch_execute_seconds")
    svc.attach_guard(guard)
    x = torch.arange(4.0)
    fn = svc.dispatch("torch_guard_toy", x)
    decisions = _drift(svc, store, guard, fn, x, backend)

    assert len(decisions) == 1
    d = decisions[0]
    assert d["action"] == "quarantine" and d["reason"].startswith("drift:")
    assert d["config"] == {"s": 2} and d["retune_requested"] is True
    quars = store.quarantines("torch_guard_toy")
    assert len(quars) == 1 and quars[0]["reason"].startswith("drift:")
    assert svc.tuner.submitted == [("torch_guard_toy", ((4,),), backend)]
    assert svc.stats["bg_enqueued"] == 1
    before = svc.stats["store_default"]
    fn2 = svc.dispatch("torch_guard_toy", x)
    assert fn2 is not fn
    assert svc.stats["store_default"] == before + 1
    torch.testing.assert_close(fn2(x), x * 1)  # default s=1
    assert guard.stats["quarantines"] == 1 and guard.stats["fallbacks"] == 1


def test_drift_hysteresis_and_cooldown_pure_policy():
    policy = WatchPolicy(drift_factor=3.0, hysteresis=2, cooldown_sec=100.0, min_samples=1)
    key = ("k", "4", "cpu")
    breach = {key: {"count": 10, "sum": 1.0, "p50": 1.0, "p99": 2.0}}
    healthy = {key: {"count": 10, "sum": 0.001, "p50": 1e-4, "p99": 1e-4}}
    baselines = {key: 1e-3}
    states = {}
    assert _decide(breach, baselines, states, policy, now=0.0) == []
    assert _decide(healthy, baselines, states, policy, now=1.0) == []
    assert _decide(breach, baselines, states, policy, now=2.0) == []
    got = _decide(breach, baselines, states, policy, now=3.0)
    assert len(got) == 1 and got[0]["reason"] == "drift:1000.0x"
    _decide(breach, baselines, states, policy, now=4.0)
    assert _decide(breach, baselines, states, policy, now=5.0) == []
    assert len(_decide(breach, baselines, states, policy, now=103.0)) == 1


def test_unknown_baseline_is_ignored():
    policy = WatchPolicy(min_samples=1, hysteresis=1)
    windows = {("k", "4", "cpu"): {"count": 5, "sum": 5.0, "p50": 1.0, "p99": 1.0}}
    assert _decide(windows, {}, {}, policy, now=0.0) == []


def test_window_stats_are_deltas_not_cumulative():
    reg = MetricsRegistry()
    for _ in range(10):
        reg.observe("dispatch_execute_seconds", 1e-4, kernel="k", signature="4", backend="cpu")
    snap1 = reg.snapshot()
    for _ in range(10):
        reg.observe("dispatch_execute_seconds", 0.05, kernel="k", signature="4", backend="cpu")
    snap2 = reg.snapshot()
    cumulative = window_stats(None, snap2)[("k", "4", "cpu")]
    window = window_stats(snap1, snap2)[("k", "4", "cpu")]
    assert cumulative["count"] == 20 and window["count"] == 10
    assert window["p50"] > 10 * cumulative["p50"]


def _snapshot_log(registry_cls, name="dispatch_execute_seconds"):
    reg = registry_cls()
    lab = dict(kernel="k", signature="4", backend="gpu")
    for _ in range(8):
        reg.observe(name, 1e-4, **lab)
    snaps = [{"snapshot": reg.snapshot()}]
    for lat in (0.05, 2e-4, 0.05, 0.05, 0.05):  # drift, recovery, drift again
        for _ in range(8):
            reg.observe(name, lat, **lab)
        snaps.append({"snapshot": reg.snapshot()})
    return snaps


def test_replay_decisions_match_the_reference():
    baselines = {("k", "4", "gpu"): 1e-4}
    for policy in (dict(drift_factor=3.0, hysteresis=2, cooldown_sec=0.0, min_samples=4),
                   dict(drift_factor=3.0, hysteresis=1, cooldown_sec=25.0, min_samples=4)):
        ours = replay_decisions(_snapshot_log(MetricsRegistry), baselines,
                                WatchPolicy(**policy))
        theirs = jax_replay_decisions(_snapshot_log(JaxRegistry), baselines,
                                      JaxWatchPolicy(**policy))
        assert ours and ours == theirs
    shadow = replay_decisions(_snapshot_log(MetricsRegistry, SHADOW_HISTOGRAM), baselines,
                              WatchPolicy(hysteresis=2, cooldown_sec=0.0, min_samples=4),
                              SHADOW_HISTOGRAM)
    assert [d["window_index"] for d in shadow] == [4]


def test_telemetry_guard_section(tmp_path):
    svc, store = _service(tmp_path)
    guard = GuardAgent(svc, shadow=ShadowPolicy(epsilon=0.5))
    svc.attach_guard(guard)
    guard.check_once()
    tel = svc.telemetry()
    assert tel["guard"]["checks"] == 1 and tel["guard"]["quarantines"] == 0
    assert "shadow" in tel["guard"]
    assert tel["guard"]["watching"]["hysteresis"] == guard.watch.hysteresis
    assert tel["guard"]["watching"]["histogram"] == "dispatch_execute_seconds"


def test_guard_agent_thread_lifecycle(tmp_path):
    svc, _store = _service(tmp_path)
    guard = GuardAgent(svc, watch=WatchPolicy(interval_sec=0.05))
    guard.start()
    deadline = time.monotonic() + 5.0
    while guard.stats["checks"] < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    guard.stop()
    assert guard.stats["checks"] >= 2 and guard.stats["watch_errors"] == 0


def test_background_tuner_hardens_campaigns_and_skips_banned_configs(tmp_path):
    crash_log = []

    def _guard_eval(cfg):
        if cfg["s"] == 32:
            crash_log.append(dict(cfg))
            raise RuntimeError("hot loop")
        return EvalResult(1.0 / cfg["s"], True, {})

    register("torch_toy_guarded", builder=lambda cfg: lambda x: x * cfg["s"],
             space=lambda target="host": _space(), make_evaluator=lambda factory: _guard_eval)
    store = TuningStore(str(tmp_path / "store"))
    store.quarantine(TuningRecord("torch_toy_guarded", ((4,),), "cpu",
                                  {"s": 16, "t": 4}, 1.0), reason="drift:9.9x")
    tuner = BackgroundTuner(store, max_evals=24, n_initial=6, seed=11,
                            harden=HardenPolicy(deadline_sec=10.0))
    fut = tuner.submit("torch_toy_guarded", ((4,),), "cpu", space=_space(),
                       evaluator=_guard_eval)
    rec = fut.result(timeout=60)
    tuner.shutdown()
    assert not tuner.errors and rec is not None
    assert rec.config != {"s": 16, "t": 4}
    assert store.get("torch_toy_guarded", ((4,),), "cpu").config == rec.config
    if crash_log:
        assert rec.config["s"] != 32


# ---------------------------------------------------------------------------
# exposition and the CLI
# ---------------------------------------------------------------------------


def test_snapshot_file_round_trip_and_prometheus_text(tmp_path):
    reg = MetricsRegistry()
    reg.add("guard_quarantines_total", kernel="k")
    reg.observe("dispatch_shadow_seconds", 2e-5, kernel="k", signature="4", backend="gpu")
    path = str(tmp_path / "obs.jsonl")
    write_snapshot(path, reg, run="a")
    write_snapshot(path, reg, run="b")
    lines = read_snapshot_file(path, merge=False)
    assert [line["run"] for line in lines] == ["a", "b"]
    merged = read_snapshot_file(path)
    assert guard_counters(merged) == {"guard_quarantines_total": 2.0}
    text = prometheus_text(reg.snapshot())
    assert "# TYPE repro_dispatch_shadow_seconds histogram" in text
    assert 'repro_guard_quarantines_total{kernel="k"} 1' in text


def test_guard_cli_status_replay_and_faults(tmp_path, capsys):
    store = TuningStore(str(tmp_path / "store"))
    store.put(TuningRecord("k", ((4,),), "gpu", {"s": 2}, 1e-4))
    store.quarantine(TuningRecord("k", ((8,),), "gpu", {"s": 4}, 1.0), reason="drift:4.0x")
    obs = str(tmp_path / "obs.jsonl")
    with open(obs, "w") as f:
        for line in _snapshot_log(MetricsRegistry, SHADOW_HISTOGRAM):
            f.write(json.dumps({"time": 0.0, "snapshot": line["snapshot"]}) + "\n")

    assert guard_cli.main(["status", "--store", store.path, "--obs", obs]) == 0
    status = json.loads(capsys.readouterr().out)
    assert status["quarantines"] == 1 and len(status["drift_quarantines"]) == 1
    assert status["obs_snapshots"] == 6 and status["baseline_keys"] == 1

    assert guard_cli.main(["replay", "--store", store.path, "--obs", obs,
                           "--min-samples", "4", "--histogram", SHADOW_HISTOGRAM,
                           "--cooldown", "0"]) == 0
    replay = json.loads(capsys.readouterr().out)
    assert replay["windows"] == 5 and replay["policy"]["histogram"] == SHADOW_HISTOGRAM
    assert [d["window_index"] for d in replay["decisions"]] == [4]
    assert guard_cli.main(["replay", "--store", store.path, "--obs", obs]) == 0
    assert json.loads(capsys.readouterr().out)["decisions"] == []  # the other histogram

    assert guard_cli.main(["faults", "--spec", "eval.crash:times=1"]) == 0
    faults = json.loads(capsys.readouterr().out)
    assert "eval.hang" in faults["catalog"] and faults["spec"]["armed"] == 1


def test_gpu_service_without_a_card_times_shadow_samples_on_the_host(tmp_path):
    # the shadow clock follows the tensors: CPU tensors are timed with
    # perf_counter even on the gpu backend, and no CUDA call is made
    svc, store = _service(tmp_path, backend="gpu")
    guard = GuardAgent(svc, shadow=ShadowPolicy(epsilon=1.0, challenger_fraction=0.0))
    svc.attach_guard(guard)
    x = torch.arange(4.0)
    svc.call("torch_guard_toy", x)
    (row,) = [h for h in svc.metrics.snapshot()["histograms"] if h["name"] == SHADOW_HISTOGRAM]
    assert row["count"] == 1 and row["labels"]["backend"] == "gpu"
    assert np.isfinite(row["sum"]) and row["sum"] >= 0.0
