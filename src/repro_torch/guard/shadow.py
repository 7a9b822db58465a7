"""Shadow evaluation: live traffic as free tuning hardware — the
counterpart of ``repro.guard.shadow``.

For an epsilon fraction of dispatch executions the instrumented wrapper
times the call (:class:`~repro_torch.core.plopper.LaunchClock`, the
evaluator's clock: on the card from its first device operation to its end
by ``torch.cuda.Event`` records on the serving stream, waiting on events of
that stream only, never a device-wide synchronise; on the CPU
``perf_counter``) and hands that time to
:meth:`ShadowEvaluator.on_shadow`, which ``tell``s the median of the served
config's last ``tell_window`` samples into the :class:`TuningStore` (the
store's strict-improvement ``put`` is the accept test). The JAX package
tells each sample; here one sample is not enough, since the store keeps the
least objective it is told and the drift watch holds the live p50 to it: a
rare sample far below the rest, told alone, became a record's objective and
had the watch quarantine a healthy record.

A sub-fraction of those shadow samples additionally builds a *challenger*
config — a store neighbor or a seeded space sample — and races it on the
live arguments against the served config, both warmed and then timed in
``RACE_ROUNDS`` alternating rounds; the challenger's objective is the
median of the recent live samples scaled by the ratio of the two sides'
median times, but never less than the challenger's own median, and it is
promoted (put + hot-swap invalidate) when that beats the incumbent. A call
repeated at once is not timed in the serving loop's conditions, so the
challenger's own time is not on the scale of the live samples the watch
compares with its objective; the ratio is. One timed call a side is not
enough: a single stall during the served config's call made a ratio far
below 1, promoted the challenger at a fraction of the live latency and had
the watch quarantine it. Stalls in two of the served side's three calls
still make such a ratio (on the card a decode record stood at 2.0 us, a
sixth of its live p50 and below the device time of any decode call), so the
ratio only raises the challenger's own time, never lowers it: a timed call
is never shorter than its device work. The port runs
eagerly, so there is no traced call to skip, as the JAX package must.

Sampling is deterministic (call counters, not RNG): every
``round(1/epsilon)``-th execution of a served executable is shadowed, every
``round(1/challenger_fraction)``-th shadow of a signature tries a
challenger. The dispatch service's execute wrapper counts its own
executions inline and asks :meth:`ShadowEvaluator.sample_mode` only on a
sampled one: on the card a call into the guard on every execution was a
visible share of a decode call's host time, against the serving
benchmark's 2% limit. The JAX package counts executions per signature, so
there a hot swap keeps the count; here the swapped-in executable counts
from 0. Shadowing never breaks serving: every
failure path is swallowed into a counter.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.plopper import LaunchClock

__all__ = ["ShadowPolicy", "ShadowEvaluator"]

RACE_ROUNDS = 3  # timed calls of each side of a challenger race


@dataclasses.dataclass(frozen=True)
class ShadowPolicy:
    epsilon: float = 0.01             # fraction of executions shadow-timed
    challenger_fraction: float = 0.1  # fraction of shadow samples that race a challenger
    challenger_neighbors: int = 3     # store neighbors considered as challengers
    seed: int = 0                     # space-sample challenger stream
    tell_window: int = 5              # live samples whose median is told

    def shadow_period(self) -> int:
        return max(1, round(1.0 / self.epsilon)) if self.epsilon > 0 else 0

    def challenger_period(self) -> int:
        return (max(1, round(1.0 / self.challenger_fraction))
                if self.challenger_fraction > 0 else 0)


class ShadowEvaluator:
    def __init__(self, service, policy: ShadowPolicy = ShadowPolicy()):
        self.service = service
        self.policy = policy
        self._challenger_period = policy.challenger_period()
        self._lock = threading.Lock()
        self._samples: Dict[Tuple[str, str], int] = {}  # per-signature shadows
        self._recent: Dict[tuple, collections.deque] = {}  # per served config: last samples
        self._rng = np.random.default_rng(policy.seed)
        self.stats: Dict[str, int] = {
            "shadow_evals": 0, "shadow_tells": 0, "shadow_skipped": 0,
            "shadow_errors": 0, "challenger_evals": 0, "challenger_promoted": 0,
            "challenger_infeasible": 0,
        }

    def sample_mode(self, kernel: str, sig_key: str) -> str:
        """"observe" | "challenger" for an execution the shadow period
        selected (the dispatch service's execute wrapper counts its own
        executions and calls this on every ``shadow_period()``-th). Lock-free:
        each get/set is atomic under the GIL, and a racing increment can at
        worst lose a count, which only moves the next challenger."""
        k = (kernel, sig_key)
        s = self._samples.get(k, 0) + 1
        self._samples[k] = s
        ch = self._challenger_period
        return "challenger" if (ch and s % ch == 0) else "observe"

    # -- the measurement sink ---------------------------------------------
    def on_shadow(self, kernel: str, sig, config: dict, static_kw: dict,
                  args: tuple, measured_sec: float, mode: str) -> None:
        """Handle one shadow measurement. Never raises."""
        svc = self.service
        try:
            self._count("shadow_evals")
            svc.metrics.add("guard_shadow_evals_total", kernel=kernel)
            from repro_torch.dispatch.store import TuningRecord

            told, live = self._live(kernel, sig, config, measured_sec)
            if told is not None and svc.store is not None and self._tell(TuningRecord(
                    kernel=kernel, signature=tuple(sig), backend=svc.backend,
                    config=dict(config), objective=told,
                    n_evals=self.policy.tell_window, source="shadow")):
                self._count("shadow_tells")
            if mode == "challenger":
                self._challenge(kernel, sig, config, static_kw, args, live)
        except Exception:  # noqa: BLE001 — shadowing must never break serving
            self._count("shadow_errors")
            svc.metrics.add("guard_shadow_errors_total", kernel=kernel)

    def _live(self, kernel: str, sig, config: dict,
              measured_sec: float) -> Tuple[Optional[float], float]:
        """Adds a sample of the served config; returns the median of its last
        ``tell_window`` samples (None until that many were taken) and the
        median of those taken so far."""
        from repro_torch.core.space import config_key

        window = max(1, self.policy.tell_window)
        key = (kernel, tuple(sig), config_key(config))
        with self._lock:
            recent = self._recent.setdefault(key, collections.deque(maxlen=window))
            recent.append(float(measured_sec))
            live = float(np.median(recent))
            return (live if len(recent) == window else None), live

    def _tell(self, rec) -> bool:
        # the store accepts strict improvements only: a measurement no better
        # than the record in hand is not offered (put locks, refreshes and
        # fsyncs the log, on the serving thread)
        cur = self.service.store.peek(rec.kernel, rec.signature, rec.backend)
        if cur is not None and rec.objective >= cur.objective:
            return False
        return bool(self.service.store.put(rec))

    # -- challenger path ---------------------------------------------------
    def _pick_challenger(self, kernel: str, sig, config: dict) -> Optional[dict]:
        from repro_torch.core.space import config_key
        from repro_torch.dispatch.registry import get as get_variant
        from repro_torch.dispatch.signature import signature_distance

        svc = self.service
        incumbent = config_key(config)
        if svc.store is not None:
            ranked = sorted(
                (r for r in svc.store.records(kernel=kernel, backend=svc.backend)
                 if signature_distance(tuple(sig), r.signature) != float("inf")),
                key=lambda r: signature_distance(tuple(sig), r.signature))
            for r in ranked[: self.policy.challenger_neighbors]:
                if config_key(r.config) != incumbent:
                    return dict(r.config)
        space = get_variant(kernel).space(svc.target)
        for _ in range(8):  # resample past the incumbent
            cand = space.sample_configuration(self._rng)
            if config_key(cand) != incumbent:
                return cand
        return None

    def _challenge(self, kernel: str, sig, config: dict, static_kw: dict,
                   args: tuple, live_sec: float) -> None:
        from repro_torch.analyze.feasibility import check_config
        from repro_torch.dispatch.registry import get as get_variant
        from repro_torch.dispatch.store import TuningRecord
        from repro_torch.kernels.util import ConfigRejected

        svc = self.service
        cand = self._pick_challenger(kernel, sig, config)
        if cand is None:
            return
        first = next((a for a in args if hasattr(a, "dtype")), None)
        verdict = check_config(kernel, cand, signature=tuple(sig),
                               target=svc.target,
                               dtype=None if first is None else first.dtype)
        if not verdict.ok:
            self._count("challenger_infeasible")
            return
        spec = get_variant(kernel)
        built = spec.builder(cand, **static_kw)
        try:
            check = getattr(built, "check", None)
            if check is not None:
                check(*args)
        except ConfigRejected:
            self._count("challenger_infeasible")
            return
        served = spec.builder(config, **static_kw)
        race = (built, served)
        for variant in race:
            variant(*args)  # warm: the kernel's library is loaded, its smem limit set
        times = ([], [])
        for _ in range(RACE_ROUNDS):  # alternating: an outlier is one sample, not a side
            for variant, side in zip(race, times):
                clock = LaunchClock(args)  # waits for the queued calls, then times one
                variant(*args)
                side.append(clock.stop())
        # on the live samples' scale, never below the challenger's own time
        own, served_sec = float(np.median(times[0])), float(np.median(times[1]))
        dt = own * max(1.0, live_sec / max(served_sec, 1e-12))
        self._count("challenger_evals")
        svc.metrics.add("guard_challenger_evals_total", kernel=kernel)
        if svc.store is not None and self._tell(TuningRecord(
                kernel=kernel, signature=tuple(sig), backend=svc.backend,
                config=dict(cand), objective=float(dt), n_evals=1,
                source="shadow_challenger")):
            self._count("challenger_promoted")
            svc.metrics.add("guard_challenger_promoted_total", kernel=kernel)
            svc.invalidate(kernel, tuple(sig))

    def _count(self, key: str) -> None:
        with self._lock:
            self.stats[key] += 1

    def snapshot_stats(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self.stats)
