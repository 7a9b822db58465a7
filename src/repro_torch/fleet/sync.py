"""Replica binding + the anti-entropy SyncAgent.

:class:`Replica` ties one :class:`~repro_torch.dispatch.store.TuningStore` to its
:class:`~repro_torch.fleet.oplog.OpLog`: local store mutations emit ops (stamped
while the store lock is held, so op order matches application order — lock
order is always store → fleet, and ingestion releases the oplog locks
before touching the store), replicated ops fold back into the store through the
deterministic merge, and an attached
:class:`~repro_torch.dispatch.service.DispatchService` gets its compiled
executables invalidated whenever replication changes what the store serves
— a better config tuned anywhere in the fleet hot-swaps in here.

:class:`SyncAgent` is the anti-entropy daemon (a thread, like
:class:`~repro_torch.dispatch.background.BackgroundTuner`): every
``interval_sec`` — or immediately after :meth:`~SyncAgent.nudge`, which the
dispatch service fires when a background campaign publishes — it pulls
remote deltas, merges them, and pushes local ones. Transport failures
(peer down, shared dir unmounted) are counted, never raised: serving
continues on local state and the next cycle retries.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Iterable

from repro_torch.dispatch.signature import parse_signature_key
from repro_torch.dispatch.store import TuningStore
from repro_torch.fleet.oplog import Op, OpLog
from repro_torch.fleet.transport import Transport
from repro_torch.guard.faults import fault_point
from repro_torch.obs.metrics import get_registry, summarize_histograms
from repro_torch.obs.trace import span as obs_span

__all__ = ["Replica", "SyncAgent"]


class Replica:
    def __init__(
        self,
        store: TuningStore,
        *,
        oplog: OpLog | None = None,
        service=None,
    ):
        self.store = store
        self.oplog = oplog or OpLog(os.path.join(store.path, "fleet"))
        self.service = service
        store.set_op_sink(self.oplog.emit)
        # records that predate fleet attachment still need ops, or peers
        # would never learn this host's previously tuned configs
        for rec in store.records():
            self.oplog.ensure_put(rec)
        # ...and an oplog that predates this store view (restart, wiped
        # store dir, crash between durable ingest and store application)
        # folds its merged winners and bans straight back in
        self.reconcile(self.oplog.merge_keys())

    @property
    def host_id(self) -> str:
        return self.oplog.host_id

    # -- merge application -------------------------------------------------------

    def ingest(self, ops: Iterable[Op]) -> int:
        """Fold replicated ops into the oplog, then reconcile the store
        against the merge. Returns the number of store-visible changes.

        Reconciliation deliberately covers *every* merge-state key, not just
        the freshly ingested ones: locally-originated ops (a quarantine, a
        compaction eviction) can flip a key's merge winner to a put that
        only ever existed in the oplog, and the next cycle must fold that
        winner into the store even when the transport delivered nothing."""
        self.oplog.ingest(ops)
        return self.reconcile(self.oplog.merge_keys())

    def reconcile(self, keys: Iterable[tuple]) -> int:
        """Drive the store to the merge state for ``keys``: apply the
        merge's quarantines, evict local bests that are dead in the merge,
        and put merge winners that beat (or replace) the local record.
        Every change invalidates the attached service's executables for
        that signature so the next dispatch serves the fleet's best.

        Quarantines are re-derived from the merge state (not from freshly
        delivered ops): version-vector dedup means a quarantine op is
        delivered exactly once, so a crash between its durable oplog append
        and the store application must not lose the ban — replaying
        reconciliation heals it."""
        changed = 0
        for key in keys:
            kernel, sig_key, backend = key
            sig = parse_signature_key(sig_key)
            for qop in self.oplog.key_quarantines(key):
                if self.store.is_quarantined(qop.record):
                    continue  # cheap in-memory check before the flocked apply
                if self.store.apply_remote("quarantine", qop.record):
                    changed += 1
                    self._invalidate(qop.record)
            win = self.oplog.winner(key)
            cur = self.store.peek(kernel, sig, backend)
            if win is None:
                # every put for this key is tombstoned or quarantined
                if cur is not None and self.store.apply_remote("evict", cur):
                    changed += 1
                    self._invalidate(cur)
                continue
            wrec = win.record
            if cur is not None and wrec.objective >= cur.objective \
                    and (cur.config != wrec.config
                         or wrec.objective > cur.objective):
                # the local record lost the merge without being beaten on
                # objective — its op was evicted/quarantined fleet-wide (the
                # same config may even have been legitimately re-tuned to a
                # slower, newer measurement), or it tied and the stamp order
                # picked the other config; evict it so the winner lands
                if self.store.apply_remote("evict", cur):
                    cur = None
            if (cur is None or wrec.objective < cur.objective) \
                    and self.store.apply_remote("put", wrec):
                changed += 1
                self._invalidate(wrec)
        if changed and self.service is not None:
            with self.service._lock:
                self.service.stats["sync_applied"] += changed
        return changed

    def _invalidate(self, rec) -> None:
        if self.service is not None:
            self.service.invalidate(rec.kernel, rec.signature)

    # -- telemetry ---------------------------------------------------------------

    def status(self, transport: Transport | None = None) -> dict:
        self.store.refresh()
        self.oplog.refresh()
        last = self.oplog.last_sync()
        quarantines = self.store.quarantines()
        out = {
            "host": self.host_id,
            "records": len(self.store),
            "ops": len(self.oplog),
            # quarantine tombstones with their machine-readable reasons
            # (build_failed, or repro_torch.analyze feasibility codes); replicated
            # bans carry an empty reason — reasons are host-local
            "quarantined": [
                {"kernel": q["kernel"], "signature": q["signature"],
                 "backend": q["backend"], "reason": q["reason"]}
                for q in quarantines
            ],
            "clock": self.oplog._clock,
            "version_vector": self.oplog.version_vector(),
            "last_sync_age_sec": (  # lint: allow=REP101 oplog sync stamps are cross-process wall-clock
                round(time.time() - last["time"], 3) if last else None),
            "last_sync": last,
        }
        if transport is not None:
            out["transport"] = transport.describe()
            out["ops_pending"] = transport.pending(self.oplog)
        # sync-duration + replication-lag histograms (count/p50/p99) from
        # this process's obs registry — populated by any SyncAgent cycles run
        # here (the `serve --interval` daemon, or a one-shot `sync`); empty
        # for a process that has not synced
        snap = get_registry().snapshot()
        out["obs"] = summarize_histograms(snap, prefix="fleet_")
        # per-error-class transport failure counts and guard (drift/shadow)
        # counters: ``launch.fleet status`` shows *why* sync is failing and
        # what the resilience layer has been doing, not just that it ran
        out["counters"] = {}
        for c in snap.get("counters", []):
            name = c["name"]
            if name == "fleet_transport_errors":
                kind = c["labels"].get("kind", "")
                row = out["counters"].setdefault(name, {})
                row[kind] = row.get(kind, 0) + int(c["value"])
            elif name.startswith("guard_"):
                out["counters"][name] = (
                    out["counters"].get(name, 0) + int(c["value"]))
        return out


class SyncAgent:
    """Periodic push/pull of op deltas between this replica and its
    transport; see module docstring."""

    def __init__(
        self,
        replica: Replica,
        transport: Transport,
        *,
        interval_sec: float = 30.0,
        max_errors: int = 20,
        max_backoff_sec: float | None = None,
        backoff_jitter: float = 0.25,
        rng=None,
    ):
        self.replica = replica
        self.transport = transport
        self.interval_sec = interval_sec
        # consecutive transport failures back the loop off exponentially
        # (doubling per failure, capped, with multiplicative jitter so a
        # fleet of replicas behind one dead peer doesn't retry in lockstep)
        # instead of hammering a dead peer every interval
        self.max_backoff_sec = (max_backoff_sec if max_backoff_sec is not None
                                else interval_sec * 32)
        self.backoff_jitter = backoff_jitter
        self._rng = rng if rng is not None else random.Random()
        # per-cycle pull/merge/push durations accumulate here (flat view)
        # and into the obs registry's fleet_{pull,merge,push,cycle}_seconds
        # histograms, labeled by host
        self.stats = {"cycles": 0, "sync_applied": 0, "sync_published": 0,
                      "sync_errors": 0, "ops_pending": 0, "last_sync": 0.0,
                      "pull_sec": 0.0, "merge_sec": 0.0, "push_sec": 0.0,
                      # error-class -> count, e.g. {"ConnectionError": 4}:
                      # *why* sync is failing, not just that it is
                      "transport_errors": {},
                      "consecutive_failures": 0, "backoff_sec": 0.0}
        # monotonic companion to stats["last_sync"] (which stays wall-clock
        # for display): in-process age/lag math must not step under NTP
        self._last_sync_mono = 0.0
        self.errors: list[BaseException] = []
        self._max_errors = max_errors
        self._wake = threading.Event()
        self._stopping = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        if replica.service is not None:
            replica.service.attach_sync(self)

    # -- one anti-entropy cycle --------------------------------------------------

    def sync_once(self) -> dict:
        applied = published = pending = 0
        pull_sec = merge_sec = push_sec = 0.0
        host = self.replica.host_id
        registry = get_registry()
        with self._lock:
            last_mono = self._last_sync_mono
        if last_mono:
            # replication lag proxy: how stale this replica was when the
            # cycle started (time since its previous successful sync)
            registry.observe("fleet_replication_lag_seconds",
                             time.monotonic() - last_mono, host=host)
        t_cycle = time.perf_counter()
        try:
            t0 = time.perf_counter()
            with obs_span("fleet.pull", host=host):
                fault_point("transport.partition", op="pull", host=host)
                fault_point("transport.flake", op="pull", host=host)
                pulled = self.transport.pull(self.replica.oplog)
            pull_sec = time.perf_counter() - t0
            t0 = time.perf_counter()
            with obs_span("fleet.merge", host=host, ops=len(pulled)):
                applied = self.replica.ingest(pulled)
            merge_sec = time.perf_counter() - t0
            t0 = time.perf_counter()
            with obs_span("fleet.push", host=host):
                fault_point("transport.partition", op="push", host=host)
                fault_point("transport.flake", op="push", host=host)
                published = self.transport.push(self.replica.oplog)
            push_sec = time.perf_counter() - t0
            pending = self.transport.pending(self.replica.oplog)
            self.replica.oplog.note_sync(
                applied=applied, published=published, pending=pending)
        except Exception as e:  # noqa: BLE001 — anti-entropy must outlive peers
            self._record_durations(registry, host, pull_sec, merge_sec,
                                   push_sec, time.perf_counter() - t_cycle)
            kind = type(e).__name__
            registry.add("fleet_transport_errors", kind=kind, host=host)
            with self._lock:
                self.stats["sync_errors"] += 1
                errs = self.stats["transport_errors"]
                errs[kind] = errs.get(kind, 0) + 1
                self.stats["consecutive_failures"] += 1
                self.errors.append(e)
                del self.errors[:-self._max_errors]
            return {"applied": applied, "published": published,
                    "pending": pending, "error": repr(e)}
        self._record_durations(registry, host, pull_sec, merge_sec, push_sec,
                               time.perf_counter() - t_cycle)
        registry.set_gauge("fleet_ops_pending", pending, host=host)
        with self._lock:
            self.stats["cycles"] += 1
            self.stats["sync_applied"] += applied
            self.stats["sync_published"] += published
            self.stats["ops_pending"] = pending
            self.stats["consecutive_failures"] = 0
            self.stats["backoff_sec"] = 0.0
            self.stats["last_sync"] = time.time()  # wall-clock, display only
            self._last_sync_mono = time.monotonic()
            self.stats["pull_sec"] += pull_sec
            self.stats["merge_sec"] += merge_sec
            self.stats["push_sec"] += push_sec
        svc = self.replica.service
        if svc is not None and published:
            with svc._lock:
                svc.stats["sync_published"] += published
        # the returned dict keeps its pre-obs shape (callers compare it
        # exactly); per-cycle durations live in self.stats and the registry
        return {"applied": applied, "published": published, "pending": pending}

    @staticmethod
    def _record_durations(registry, host, pull_sec, merge_sec, push_sec,
                          cycle_sec) -> None:
        """Feed one cycle's phase durations into the obs histograms. Runs on
        the error path too — a cycle that dies mid-push still accounts for
        the pull/merge time it spent."""
        registry.observe("fleet_pull_seconds", pull_sec, host=host)
        registry.observe("fleet_merge_seconds", merge_sec, host=host)
        registry.observe("fleet_push_seconds", push_sec, host=host)
        registry.observe("fleet_cycle_seconds", cycle_sec, host=host)

    def lag(self) -> dict:
        """Replication-lag view merged into ``DispatchService.telemetry()``."""
        with self._lock:
            last_mono = self._last_sync_mono
            return {
                "sync_ops_pending": self.stats["ops_pending"],
                "sync_last_age_sec": (
                    round(time.monotonic() - last_mono, 3)
                    if last_mono else float("inf")),
                "sync_errors": self.stats["sync_errors"],
                "sync_transport_errors": dict(self.stats["transport_errors"]),
                "sync_consecutive_failures": self.stats["consecutive_failures"],
                "sync_backoff_sec": self.stats["backoff_sec"],
            }

    def _backoff_delay(self, consecutive_failures: int) -> float:
        """Next wait after ``consecutive_failures`` straight failed cycles:
        exponential (doubling) from ``interval_sec``, capped at
        ``max_backoff_sec``, with up to ``backoff_jitter`` multiplicative
        jitter to de-synchronize a fleet retrying one dead peer."""
        if consecutive_failures <= 0:
            return self.interval_sec
        base = min(self.interval_sec * (2.0 ** min(consecutive_failures - 1, 16)),
                   self.max_backoff_sec)
        return base * (1.0 + self.backoff_jitter * self._rng.random())

    # -- lifecycle ---------------------------------------------------------------

    def nudge(self) -> None:
        """Wake the loop now (e.g. a background campaign just published a
        better config — push it fleet-wide without waiting a full interval)."""
        self._wake.set()

    def start(self) -> "SyncAgent":
        if self._thread is None or not self._thread.is_alive():
            self._stopping.clear()
            self._thread = threading.Thread(
                target=self._run, name="repro-torch-fleet-sync", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stopping.is_set():
            out = self.sync_once()
            if "error" in out:
                with self._lock:
                    failures = self.stats["consecutive_failures"]
                delay = self._backoff_delay(failures)
                with self._lock:
                    self.stats["backoff_sec"] = delay
            else:
                delay = self.interval_sec
            # a nudge() still wakes a backed-off loop immediately: local
            # publishes should not wait out a dead peer's backoff window
            self._wake.wait(delay)
            self._wake.clear()

    def stop(self, wait: bool = True) -> None:
        self._stopping.set()
        self._wake.set()
        if wait and self._thread is not None:
            self._thread.join(timeout=30)
