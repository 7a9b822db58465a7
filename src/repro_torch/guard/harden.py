"""Hardened campaign evaluation: deadlines, crash isolation, and
pathological-slowdown detection — a copy of ``repro.guard.harden`` on the
port's ``core.plopper``.

CATBench-class autotuning evaluations hang, crash, or return absurd
timings; a production tuner must absorb those as *data*.
:class:`HardenedExecutor` wraps any evaluator behind the engine's
``Executor`` protocol and converts each failure mode into a structured
:class:`FailureObservation` whose penalized objective flows through the
campaign's normal ``tell`` path — so the record lands in the
``PerformanceDatabase`` with status FAILED and the surrogate learns to
avoid the region instead of merely skipping it.

Reason codes match the store's quarantine taxonomy (machine-readable
``<kind>[:<detail>]``): ``eval_timeout:<deadline>s``,
``eval_crash:<ExcType>``, ``pathological_slowdown:<ratio>x``.

Worker threads are daemonic and spawned per submission (the campaign
already bounds in-flight work to ``max_inflight``), so a genuinely hung
evaluator is abandoned — it can neither stall the campaign nor block
interpreter exit.

On the card, a timeout abandons the host thread only: a kernel it launched
still runs on the device to its end (nothing cancels a launch), and the
abandoned thread may go on launching. A CUDA fault inside an evaluation (an
illegal address, a launch failure) is sticky: every later CUDA call of the
process fails with it. The executor records the first such evaluation as a
crash like any other; it does not pretend the process can continue on the
device, and the campaigns after it fail too.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional

from repro_torch.core.plopper import PENALTY, EvalResult
from repro_torch.guard.faults import fault_point

__all__ = [
    "REASON_CRASH",
    "REASON_DRIFT",
    "REASON_PATHOLOGICAL",
    "REASON_TIMEOUT",
    "FailureObservation",
    "HardenPolicy",
    "HardenedExecutor",
]

REASON_TIMEOUT = "eval_timeout"
REASON_CRASH = "eval_crash"
REASON_PATHOLOGICAL = "pathological_slowdown"
REASON_DRIFT = "drift"  # emitted by the watch layer, listed here for the taxonomy


@dataclasses.dataclass(frozen=True)
class FailureObservation:
    """A failed evaluation, structured: kind + machine-readable reason +
    the penalized objective fed back to the surrogate."""

    kind: str            # "timeout" | "exception" | "pathological"
    reason: str          # e.g. "eval_timeout:5.0s", "eval_crash:ValueError"
    objective: float     # penalized objective (seconds scale when informative)
    wall_sec: float
    config: Dict[str, Any]
    detail: str = ""

    def to_eval_result(self) -> EvalResult:
        return EvalResult(self.objective, False, {
            "failure": self.kind,
            "reason": self.reason,
            "wall_sec": round(self.wall_sec, 6),
            "detail": self.detail,
        })


@dataclasses.dataclass(frozen=True)
class HardenPolicy:
    """Knobs for hardened evaluation.

    ``deadline_sec=None`` disables the timeout (crash isolation still
    applies). The timeout penalty is ``deadline_sec * timeout_penalty_scale``
    — region-informative (a slow region scores worse than a fast one's
    deadline) rather than the flat :data:`PENALTY` used for crashes.
    ``baseline_sec`` (e.g. the warm-start incumbent) arms the
    pathological-slowdown check: an *ok* result slower than
    ``baseline_sec * slowdown_factor`` is reclassified as a failure,
    keeping its measured objective.
    """

    deadline_sec: Optional[float] = None
    timeout_penalty_scale: float = 10.0
    baseline_sec: Optional[float] = None
    slowdown_factor: float = 50.0
    crash_penalty: float = PENALTY


class HardenedExecutor:
    """Engine ``Executor`` adding per-evaluation deadlines + crash isolation.

    With ``parallel=1``, no deadline expiry, and a well-behaved evaluator
    the submit/result ordering is identical to ``InlineExecutor`` —
    fixed-seed campaign trajectories are bit-identical (pinned by test).
    """

    def __init__(self, evaluator: Callable[[Mapping[str, Any]], EvalResult],
                 policy: HardenPolicy = HardenPolicy(), *, parallel: int = 1,
                 metrics=None, labels: Optional[Dict[str, str]] = None):
        if parallel < 1:
            raise ValueError(f"parallel must be >= 1, got {parallel}")
        self.evaluator = evaluator
        self.policy = policy
        self.max_inflight = parallel
        self.labels = dict(labels or {})
        self._metrics = metrics
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {
            "evals": 0, "timeouts": 0, "crashes": 0, "pathological": 0,
            "late_results": 0,
        }

    # -- metrics helpers -------------------------------------------------
    def _count(self, key: str, metric: Optional[str] = None, **labels) -> None:
        with self._lock:
            self.stats[key] += 1
        if self._metrics is not None and metric is not None:
            self._metrics.add(metric, **{**self.labels, **labels})

    # -- Executor protocol -----------------------------------------------
    def submit(self, config: Mapping[str, Any]) -> cf.Future:
        cfg = dict(config)
        outer: cf.Future = cf.Future()
        self._count("evals", "guard_evals_total")
        if self.max_inflight == 1 and self.policy.deadline_sec is None:
            # serial, no deadline: evaluate inline so ordering (and hence
            # fixed-seed trajectories) matches InlineExecutor exactly
            self._finish(outer, cfg, *self._guarded(cfg))
            return outer
        t0 = time.perf_counter()
        timer = None
        if self.policy.deadline_sec is not None:
            timer = threading.Timer(
                self.policy.deadline_sec, self._on_deadline, args=(outer, cfg))
            timer.daemon = True
            timer.start()
        worker = threading.Thread(
            target=self._worker, args=(outer, cfg, timer, t0),
            name="repro-torch-guard-eval", daemon=True)
        worker.start()
        return outer

    def shutdown(self, wait: bool = True) -> None:
        # per-submission daemon threads: nothing to join; abandoned hung
        # evaluations die with the process
        pass

    # -- internals -------------------------------------------------------
    def _guarded(self, cfg: Dict[str, Any]):
        """Run one evaluation; returns (result, wall_sec). Never raises."""
        t0 = time.perf_counter()
        try:
            fault_point("eval.slow", **self.labels)
            fault_point("eval.hang", **self.labels)
            fault_point("eval.crash", **self.labels)
            res = self.evaluator(cfg)
        except BaseException as e:  # noqa: BLE001 — crash isolation is the point
            wall = time.perf_counter() - t0
            self._count("crashes", "guard_failures_total", kind="exception")
            obs = FailureObservation(
                kind="exception",
                reason=f"{REASON_CRASH}:{type(e).__name__}",
                objective=self.policy.crash_penalty,
                wall_sec=wall, config=cfg, detail=str(e)[:500])
            return obs.to_eval_result(), wall
        wall = time.perf_counter() - t0
        base = self.policy.baseline_sec
        if (res.ok and base is not None
                and res.objective > base * self.policy.slowdown_factor):
            ratio = res.objective / base
            self._count("pathological", "guard_failures_total", kind="pathological")
            obs = FailureObservation(
                kind="pathological",
                reason=f"{REASON_PATHOLOGICAL}:{ratio:.1f}x",
                objective=res.objective,  # measured: already its own penalty
                wall_sec=wall, config=cfg,
                detail=f"objective {res.objective:.3e}s vs baseline {base:.3e}s")
            return obs.to_eval_result(), wall
        return res, wall

    def _worker(self, outer: cf.Future, cfg: Dict[str, Any], timer, t0) -> None:
        res, _ = self._guarded(cfg)
        if timer is not None:
            timer.cancel()
        self._finish(outer, cfg, res, time.perf_counter() - t0)

    def _on_deadline(self, outer: cf.Future, cfg: Dict[str, Any]) -> None:
        deadline = self.policy.deadline_sec or 0.0
        obs = FailureObservation(
            kind="timeout",
            reason=f"{REASON_TIMEOUT}:{deadline:g}s",
            objective=deadline * self.policy.timeout_penalty_scale,
            wall_sec=deadline, config=cfg,
            detail=f"evaluation exceeded {deadline:g}s deadline")
        if self._set(outer, obs.to_eval_result()):
            self._count("timeouts", "guard_failures_total", kind="timeout")

    def _finish(self, outer: cf.Future, cfg: Dict[str, Any],
                res: EvalResult, wall: float) -> None:
        if not self._set(outer, res):
            # deadline already resolved this future; the straggler's
            # result is dropped (counted) so it can't corrupt the tell order
            self._count("late_results", "guard_late_results_total")

    @staticmethod
    def _set(fut: cf.Future, res: EvalResult) -> bool:
        try:
            fut.set_result(res)
            return True
        except cf.InvalidStateError:
            return False
