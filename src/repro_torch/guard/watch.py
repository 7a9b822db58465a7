"""Drift/regression watch: live latency vs stored baseline — a copy of
``repro.guard.watch``.

The per-signature latency histograms give every served signature a live
latency distribution; every :class:`TuningRecord` carries the objective
measured when the config was tuned. The watcher closes the loop: each
check folds the registry, subtracts the previous fold (fixed bucket bounds
make delta histograms element-wise), and compares the *window* p50 against
``drift_factor x baseline``.

Which histogram it reads follows the service's backend, so that it compares
like with like. A store objective on the ``gpu`` backend is CUDA-event
seconds, while ``dispatch_execute_seconds`` holds a call's enqueue time
(the execute wrapper does not synchronise): at the model's shape a
decode_attention call is about 8 us on the device and about 33 us of host
wall to enqueue, past ``drift_factor`` 3.0 times its objective with no
drift at all. So on ``gpu`` the watch reads ``dispatch_shadow_seconds``,
the device time of the shadow-sampled calls (:mod:`repro_torch.guard.shadow`;
an epsilon fraction of the calls, so a window needs ``min_samples /
epsilon`` executions). On the CPU a call's wall time is its run time, and
the watch reads ``dispatch_execute_seconds``, as the JAX package's does. Sustained
breaches (``hysteresis`` consecutive windows, outside ``cooldown_sec``)
quarantine the record with a machine-readable ``drift:<ratio>x`` reason,
invalidate the executable cache (serving degrades to the default config),
and nudge the background tuner to re-campaign the signature.

The decision core is pure over (previous snapshot, current snapshot,
baselines), so :func:`replay_decisions` can re-run the exact policy over
an obs snapshot JSONL offline — ``repro-guard replay``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.metrics import histogram_quantile

__all__ = [
    "EXECUTE_HISTOGRAM",
    "SHADOW_HISTOGRAM",
    "WatchPolicy",
    "GuardAgent",
    "window_stats",
    "replay_decisions",
    "guard_counters",
]

WindowKey = Tuple[str, str, str]  # (kernel, signature_key, backend)

EXECUTE_HISTOGRAM = "dispatch_execute_seconds"  # every call: enqueue time on the card
SHADOW_HISTOGRAM = "dispatch_shadow_seconds"    # shadow-sampled calls: device time


@dataclasses.dataclass(frozen=True)
class WatchPolicy:
    interval_sec: float = 10.0   # watch-thread check period
    drift_factor: float = 3.0    # window p50 must exceed factor x baseline
    hysteresis: int = 2          # consecutive breaching windows before acting
    cooldown_sec: float = 60.0   # per-signature quiet period after an action
    min_samples: int = 8         # executions required per window


@dataclasses.dataclass
class _DriftState:
    breaches: int = 0
    last_action: float = float("-inf")  # monotonic seconds


def window_stats(prev_snap: Optional[dict], cur_snap: dict,
                 name: str = EXECUTE_HISTOGRAM) -> Dict[WindowKey, dict]:
    """Per-signature stats for the *window* between two snapshots.

    Bucket bounds are a fixed constant, so the window histogram is just
    element-wise count subtraction — no per-observation state needed.
    """
    prev_cells: Dict[WindowKey, dict] = {}
    for h in (prev_snap or {}).get("histograms", []):
        if h["name"] == name:
            prev_cells[_cell_key(h)] = h
    out: Dict[WindowKey, dict] = {}
    for h in cur_snap.get("histograms", []):
        if h["name"] != name:
            continue
        key = _cell_key(h)
        prev = prev_cells.get(key)
        counts = list(h["counts"])
        total_sum = float(h["sum"])
        if prev is not None:
            counts = [int(c) - int(p) for c, p in zip(counts, prev["counts"])]
            total_sum -= float(prev["sum"])
        count = sum(counts)
        if count <= 0:
            continue
        out[key] = {
            "count": count,
            "sum": total_sum,
            "p50": histogram_quantile(counts, 0.50),
            "p99": histogram_quantile(counts, 0.99),
        }
    return out


def _cell_key(h: dict) -> WindowKey:
    lab = h["labels"]
    return (lab.get("kernel", ""), lab.get("signature", ""),
            lab.get("backend", ""))


def _decide(windows: Dict[WindowKey, dict],
            baselines: Dict[WindowKey, float],
            states: Dict[WindowKey, _DriftState],
            policy: WatchPolicy, now: float) -> List[dict]:
    """Pure drift-policy core: updates ``states`` in place, returns the
    quarantine decisions for this window. No I/O, no store access."""
    decisions: List[dict] = []
    for key, w in sorted(windows.items()):
        if w["count"] < policy.min_samples:
            continue
        baseline = baselines.get(key)
        if baseline is None or baseline <= 0.0:
            states.pop(key, None)
            continue
        state = states.setdefault(key, _DriftState())
        if w["p50"] <= policy.drift_factor * baseline:
            state.breaches = 0
            continue
        state.breaches += 1
        ratio = w["p50"] / baseline
        if state.breaches < policy.hysteresis:
            continue
        if now - state.last_action < policy.cooldown_sec:
            continue
        state.last_action = now
        state.breaches = 0
        kernel, sig_key, backend = key
        decisions.append({
            "action": "quarantine",
            "kernel": kernel,
            "signature": sig_key,
            "backend": backend,
            "reason": f"drift:{ratio:.1f}x",
            "p50_sec": w["p50"],
            "p99_sec": w["p99"],
            "baseline_sec": baseline,
            "window_count": w["count"],
        })
    return decisions


class GuardAgent:
    """The guard umbrella bound to one :class:`DispatchService` via
    ``service.attach_guard(agent)``: shadow-evaluation sampling hooks plus
    the drift-watch thread. ``check_once()`` runs a single watch cycle
    (what the thread loop and the tests call). ``histogram`` is the latency
    histogram the watch reads: :data:`SHADOW_HISTOGRAM` on the ``gpu``
    backend, :data:`EXECUTE_HISTOGRAM` otherwise."""

    def __init__(self, service, *, watch: WatchPolicy = WatchPolicy(),
                 shadow=None, decisions_path: Optional[str] = None):
        from repro_torch.guard.shadow import ShadowEvaluator, ShadowPolicy

        self.service = service
        self.watch = watch
        self.histogram = (SHADOW_HISTOGRAM if getattr(service, "backend", None) == "gpu"
                          else EXECUTE_HISTOGRAM)
        self.shadow = (ShadowEvaluator(service, shadow)
                       if isinstance(shadow, ShadowPolicy) else shadow)
        # every shadow_period-th execution of a served executable is sampled
        # (0: none); the service's execute wrapper counts inline
        self.shadow_period = 0 if self.shadow is None else self.shadow.policy.shadow_period()
        self.decisions_path = decisions_path
        self.decisions: List[dict] = []
        self.stats: Dict[str, int] = {
            "checks": 0, "quarantines": 0, "fallbacks": 0, "retunes": 0,
            "watch_errors": 0,
        }
        self._prev_snap: Optional[dict] = None
        self._states: Dict[WindowKey, _DriftState] = {}
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- shadow hooks (called from the instrumented execute wrapper) -------
    def shadow_sample(self, kernel: str, sig_key: str) -> str:
        """The mode of an execution the shadow period selected."""
        return self.shadow.sample_mode(kernel, sig_key)

    def on_shadow(self, kernel: str, sig, config, static_kw, args,
                  measured_sec: float, mode: str) -> None:
        if self.shadow is not None:
            self.shadow.on_shadow(kernel, sig, config, static_kw, args,
                                  measured_sec, mode)

    # -- the watch cycle ---------------------------------------------------
    def _baselines(self) -> Dict[WindowKey, float]:
        svc = self.service
        if svc.store is None:
            return {}
        svc.store.refresh()
        from repro_torch.dispatch.signature import signature_key

        return {(r.kernel, signature_key(r.signature), r.backend):
                float(r.objective) for r in svc.store.records()}

    def check_once(self) -> List[dict]:
        """One watch cycle; returns (and applies) this window's decisions."""
        svc = self.service
        snap = svc.metrics.snapshot()
        with self._lock:
            prev, self._prev_snap = self._prev_snap, snap
            self.stats["checks"] += 1
        svc.metrics.add("guard_checks_total")
        if prev is None:
            return []
        windows = window_stats(prev, snap, self.histogram)
        baselines = self._baselines()  # store I/O stays outside the guard lock
        with self._lock:
            decisions = _decide(windows, baselines, self._states,
                                self.watch, time.monotonic())
        for d in decisions:
            self._apply(d)
        return decisions

    def _apply(self, decision: dict) -> None:
        from repro_torch.dispatch.signature import parse_signature_key

        svc = self.service
        kernel = decision["kernel"]
        sig = parse_signature_key(decision["signature"])
        rec = svc.store.peek(kernel, sig, decision["backend"])
        if rec is not None:
            svc.store.quarantine(rec, reason=decision["reason"])
            decision["config"] = dict(rec.config)
        svc.invalidate(kernel, sig)
        retuned = False
        if hasattr(svc, "request_retune"):
            retuned = bool(svc.request_retune(kernel, decision["signature"]))
        decision["retune_requested"] = retuned
        decision["time"] = time.time()
        with self._lock:
            self.stats["quarantines"] += 1
            self.stats["fallbacks"] += 1  # serving degrades to default now
            if retuned:
                self.stats["retunes"] += 1
            self.decisions.append(dict(decision))
        svc.metrics.add("guard_quarantines_total", kernel=kernel)
        svc.metrics.add("guard_fallbacks_total", kernel=kernel)
        if self.decisions_path:
            from repro_torch.core.jsonl import append_jsonl

            append_jsonl(self.decisions_path, decision)

    # -- thread lifecycle (SyncAgent-style) --------------------------------
    def start(self) -> "GuardAgent":
        if self._thread is not None:
            return self
        self._stopping.clear()
        self._thread = threading.Thread(target=self._run, name="repro-torch-guard",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stopping.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def nudge(self) -> None:
        self._wake.set()

    def _run(self) -> None:
        while not self._stopping.is_set():
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — watch must outlive bad cycles
                with self._lock:
                    self.stats["watch_errors"] += 1
                self.service.metrics.add("guard_watch_errors_total")
            self._wake.wait(self.watch.interval_sec)
            self._wake.clear()

    # -- reporting ---------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                **self.stats,
                "decisions": [dict(d) for d in self.decisions[-20:]],
                "watching": {
                    "histogram": self.histogram,
                    "drift_factor": self.watch.drift_factor,
                    "hysteresis": self.watch.hysteresis,
                    "cooldown_sec": self.watch.cooldown_sec,
                    "min_samples": self.watch.min_samples,
                },
            }
        if self.shadow is not None:
            out["shadow"] = self.shadow.snapshot_stats()
        out["counters"] = guard_counters(self.service.metrics.snapshot())
        return out


def guard_counters(snapshot: dict, prefix: str = "guard_") -> Dict[str, float]:
    """Aggregate ``guard_*`` counters from an obs snapshot (labels folded),
    e.g. hardened-executor failure counts recorded by background campaigns."""
    out: Dict[str, float] = {}
    for c in snapshot.get("counters", []):
        if c["name"].startswith(prefix):
            out[c["name"]] = out.get(c["name"], 0.0) + float(c["value"])
    return out


def replay_decisions(snapshots: List[dict],
                     baselines: Dict[WindowKey, float],
                     policy: WatchPolicy = WatchPolicy(),
                     name: str = EXECUTE_HISTOGRAM) -> List[dict]:
    """Re-run the drift policy over a recorded obs snapshot sequence
    (``repro_torch.obs.export.read_snapshot_file(..., merge=False)`` lines)
    with no side effects: the offline audit of what the live watcher did (or
    would have done), over the histogram ``name`` (the live watcher's
    :attr:`GuardAgent.histogram`). Snapshot *i* vs *i+1* forms window *i*."""
    states: Dict[WindowKey, _DriftState] = {}
    out: List[dict] = []
    for i in range(1, len(snapshots)):
        prev = snapshots[i - 1].get("snapshot", snapshots[i - 1])
        cur = snapshots[i].get("snapshot", snapshots[i])
        windows = window_stats(prev, cur, name)
        for d in _decide(windows, baselines, states, policy,
                         now=i * max(policy.interval_sec, 1e-9)):
            d["window_index"] = i
            out.append(d)
    return out
