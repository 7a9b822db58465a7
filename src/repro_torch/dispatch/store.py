"""TuningStore: the persistent, process-safe store of best-known configs.

Layout on disk (``<path>/``):

  * ``store.jsonl`` — append-only log, one :class:`TuningRecord` per line.
    The in-memory view keeps, per ``(kernel, signature, backend)`` key, the
    record with the lowest objective; the log keeps full history until
    :meth:`compact` rewrites it to bests-only.
  * ``store.lock``  — advisory ``flock`` file serializing writers across
    processes. Readers re-tail the log (:meth:`refresh`) from their last
    byte offset, so concurrent campaigns publishing results are picked up
    without re-parsing the whole file.

This is the reuse layer the extended paper calls the "evaluation database
across datasets": offline :class:`~repro.core.database.PerformanceDatabase`
campaign directories are ingested via :meth:`ingest_database`, and live
(background) campaigns publish through :meth:`put` — a hot-swap, since every
reader's next :meth:`refresh` sees the better config.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Any, Iterator, Mapping

try:
    import fcntl
except ImportError:  # non-POSIX: single-process best effort
    fcntl = None

from repro_torch.core.jsonl import append_jsonl, iter_jsonl_tail, repair_torn_tail
from repro_torch.core.space import config_key
from repro_torch.dispatch.signature import (
    ShapeSignature,
    bucket_signature,
    parse_signature_key,
    signature_key,
)

__all__ = ["TuningRecord", "TuningStore"]


@dataclasses.dataclass
class TuningRecord:
    kernel: str
    signature: ShapeSignature
    backend: str
    config: dict
    objective: float
    n_evals: int = 0
    source: str = ""          # e.g. "campaign:results/syr2k_rf", "background"
    created: float = 0.0      # unix seconds; 0 = unknown (legacy)

    def key(self) -> tuple:
        return (self.kernel, signature_key(self.signature), self.backend)

    def age_sec(self, now: float | None = None) -> float:
        if not self.created:
            return float("inf")
        # lint: allow=REP101 record `created` stamps are cross-process wall-clock
        return (now if now is not None else time.time()) - self.created

    def to_json(self) -> dict:
        return {
            "kernel": self.kernel,
            "signature": signature_key(self.signature),
            "backend": self.backend,
            "config": self.config,
            "objective": self.objective,
            "n_evals": self.n_evals,
            "source": self.source,
            "created": self.created,
        }

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "TuningRecord":
        return cls(
            kernel=str(d["kernel"]),
            signature=parse_signature_key(str(d["signature"])),
            backend=str(d["backend"]),
            config=dict(d["config"]),
            objective=float(d["objective"]),
            n_evals=int(d.get("n_evals", 0)),
            source=str(d.get("source", "")),
            created=float(d.get("created", 0.0)),
        )


class TuningStore:
    """Best-config store keyed by ``(kernel, shape-signature, backend)``.

    ``bucket=True`` applies write-time signature bucketing: every signature
    is snapped to powers of ``bucket_base`` (see
    :func:`~repro.dispatch.signature.bucket_signature`) on both :meth:`put`
    and :meth:`get`, so jittery serving shapes (batch 33, 34, 35, ...)
    collapse onto one store key instead of fragmenting the store.
    """

    def __init__(self, path: str, *, bucket: bool = False, bucket_base: float = 2.0):
        self.path = path
        self.bucket = bucket
        self.bucket_base = bucket_base
        os.makedirs(path, exist_ok=True)
        self._best: dict[tuple, TuningRecord] = {}
        # (kernel, sig-key, backend, config-key) tuples banned from serving;
        # _quarantined_json keeps the tombstone lines so compact() rewrites them
        self._quarantined: set[tuple] = set()
        self._quarantined_json: dict[tuple, dict] = {}
        self._access: dict[tuple, float] = {}  # in-process LRU clock per key
        self._offset = 0  # bytes of store.jsonl already folded into _best
        # in-process companion to the flock: refresh() is called bare (no
        # flock) from dispatch resolution, warm-start ranking, and the fleet
        # sync thread — two concurrent refreshes of one store object would
        # otherwise both fold the same lines and double-advance _offset past
        # EOF, silently skipping every record that lands there later
        self._tlock = threading.RLock()
        # repro.fleet op emission: ``sink(kind, record)`` fires for every
        # accepted put, quarantine, and compaction eviction, WHILE the store
        # lock is held — op stamp order must match store application order,
        # or a put/evict pair racing across the lock boundary draws inverted
        # Lamport stamps and the merge resurrects (or wrongly kills) the
        # record fleet-wide. Lock order is always store -> fleet, never the
        # reverse: fleet ingestion releases the oplog locks before touching
        # the store. Remote ops fold back in through :meth:`apply_remote`,
        # which never re-emits.
        self._op_sink = None
        self.refresh()

    def set_op_sink(self, sink) -> None:
        """Attach (or detach, with ``None``) the replication op sink — see
        :class:`repro.fleet.Replica`, which forwards ops into the oplog."""
        self._op_sink = sink

    def _canon(self, sig: ShapeSignature) -> ShapeSignature:
        return bucket_signature(sig, self.bucket_base) if self.bucket else sig

    # -- paths / locking --------------------------------------------------------

    def _log_path(self) -> str:
        return os.path.join(self.path, "store.jsonl")

    @contextlib.contextmanager
    def _lock(self) -> Iterator[None]:
        lock_path = os.path.join(self.path, "store.lock")
        with self._tlock:  # threads of this process first, then processes
            f = open(lock_path, "a+")
            try:
                if fcntl is not None:
                    fcntl.flock(f.fileno(), fcntl.LOCK_EX)
                yield
            finally:
                if fcntl is not None:
                    fcntl.flock(f.fileno(), fcntl.LOCK_UN)
                f.close()

    # -- read side --------------------------------------------------------------

    def refresh(self) -> int:
        """Fold any log lines appended since the last read (by this or any
        other process) into the in-memory best view. Returns #records read."""
        with self._tlock:
            return self._refresh_locked()

    def _refresh_locked(self) -> int:
        n = 0
        for d, self._offset in iter_jsonl_tail(self._log_path(), self._offset):
            if d is None:
                continue
            try:
                rec = TuningRecord.from_json(d)
            except (KeyError, ValueError):
                continue
            if d.get("quarantined"):
                self._apply_quarantine(rec, d)
            elif d.get("evicted"):
                self._apply_evict(rec)
            else:
                self._fold(rec)
            n += 1
        return n

    @staticmethod
    def _qkey(rec: TuningRecord) -> tuple:
        return rec.key() + (config_key(rec.config),)

    def _apply_quarantine(self, rec: TuningRecord, line: dict) -> None:
        qk = self._qkey(rec)
        self._quarantined.add(qk)
        self._quarantined_json[qk] = line
        cur = self._best.get(rec.key())
        if cur is not None and config_key(cur.config) == config_key(rec.config):
            del self._best[rec.key()]

    def _apply_evict(self, rec: TuningRecord) -> bool:
        """A replicated eviction tombstone: drop the key's current best iff
        it is the tombstoned config (a better config appended later in the
        log must survive replay — lines are folded in order)."""
        cur = self._best.get(rec.key())
        if cur is not None and config_key(cur.config) == config_key(rec.config):
            del self._best[rec.key()]
            return True
        return False

    def _fold(self, rec: TuningRecord) -> None:
        if self._qkey(rec) in self._quarantined:
            return
        cur = self._best.get(rec.key())
        if cur is None or rec.objective <= cur.objective:
            self._best[rec.key()] = rec

    def __len__(self) -> int:
        return len(self._best)

    def get(self, kernel: str, signature: ShapeSignature, backend: str) -> TuningRecord | None:
        key = (kernel, signature_key(self._canon(signature)), backend)
        rec = self._best.get(key)
        if rec is not None:
            # under the lock: compact() rewrites _access wholesale while
            # holding it, and a touch landing in the superseded dict would
            # silently vanish from the LRU ordering compact evicts by
            with self._tlock:
                self._access[key] = time.time()
        return rec

    def peek(self, kernel: str, signature: ShapeSignature, backend: str) -> TuningRecord | None:
        """Like :meth:`get` but without the LRU touch — replication's
        reconcile walks every key each cycle, and counting those reads as
        use would erase the access ordering :meth:`compact` evicts by."""
        return self._best.get(
            (kernel, signature_key(self._canon(signature)), backend))

    def is_quarantined(self, rec: TuningRecord) -> bool:
        """Peek-style: whether this exact (kernel, signature, backend,
        config) is already banned in this process's view. Reconcile's fast
        path — re-deriving bans every sync cycle must not pay a flocked
        log append attempt per historical quarantine."""
        rec = dataclasses.replace(rec, signature=self._canon(rec.signature))
        return self._qkey(rec) in self._quarantined

    def quarantines(self, kernel: str | None = None) -> list[dict]:
        """The quarantine tombstones in this process's view, each with its
        machine-readable ``reason`` (empty string for tombstones written
        before reasons existed, and for replicated bans — reasons are
        host-local). Keys: kernel, signature, backend, config, reason."""
        out = []
        with self._tlock:
            lines = list(self._quarantined_json.values())
        for line in lines:
            if kernel is not None and line.get("kernel") != kernel:
                continue
            out.append({
                "kernel": line.get("kernel"),
                "signature": line.get("signature"),
                "backend": line.get("backend"),
                "config": line.get("config"),
                "reason": line.get("reason", ""),
            })
        return out

    def records(self, kernel: str | None = None, backend: str | None = None) -> list[TuningRecord]:
        return [
            r for r in self._best.values()
            if (kernel is None or r.kernel == kernel)
            and (backend is None or r.backend == backend)
        ]

    # -- write side -------------------------------------------------------------

    def put(self, rec: TuningRecord, force: bool = False) -> bool:
        """Publish a record. Only a strict improvement (or ``force``) for an
        existing key is appended; returns whether the record was accepted.
        Quarantined (kernel, signature, backend, config) combinations are
        rejected outright — a poisoned config must not be re-served."""
        if not rec.created:
            rec = dataclasses.replace(rec, created=time.time())
        rec = dataclasses.replace(rec, signature=self._canon(rec.signature))
        with self._lock():
            # terminate a crashed writer's torn tail so our append does not
            # merge into the fragment; refresh then skips the isolated line
            repair_torn_tail(self._log_path())
            self.refresh()  # fold concurrent writers before deciding
            if self._qkey(rec) in self._quarantined:
                return False
            cur = self._best.get(rec.key())
            if cur is not None and not force and rec.objective >= cur.objective:
                return False
            self._offset += append_jsonl(self._log_path(), rec.to_json(), fsync=True)
            self._fold(rec)
            if self._op_sink is not None:
                self._op_sink("put", rec)
            return True

    def quarantine(self, rec: TuningRecord, reason: str = "") -> None:
        """Ban this record's exact (kernel, signature, backend, config) from
        being served or re-accepted — the dispatch service calls this when a
        stored config fails to build or trace, or when the static
        feasibility pass (repro.analyze) rejects it. The tombstone is
        appended to the log, so other processes pick it up on their next
        refresh. ``reason`` is a machine-readable code string (e.g.
        ``"build_failed"`` or feasibility codes like
        ``"tile_not_positive:bi"``) persisted on the tombstone line and
        surfaced by :meth:`quarantines` / ``repro-fleet status``; replicated
        quarantine ops do not carry it (the reason stays host-local)."""
        rec = dataclasses.replace(rec, signature=self._canon(rec.signature))
        line = rec.to_json()
        line["quarantined"] = True
        if reason:
            line["reason"] = reason
        with self._lock():
            repair_torn_tail(self._log_path())
            self.refresh()
            self._offset += append_jsonl(self._log_path(), line, fsync=True)
            self._apply_quarantine(rec, line)
            if self._op_sink is not None:
                self._op_sink("quarantine", rec)

    def apply_remote(self, kind: str, rec: TuningRecord) -> bool:
        """Replication merge hook (see :mod:`repro.fleet`): apply one
        replicated operation to this store WITHOUT re-emitting it to the op
        sink — a merged op must never echo back into the log it came from.
        Returns whether the store changed.

        * ``put`` — accepted only as a strict improvement over the current
          best (the fleet merge decides replacements by first evicting the
          dead local record); re-applying the current best is a no-op, so
          replaying an op stream is idempotent.
        * ``quarantine`` — same semantics as :meth:`quarantine`.
        * ``evict`` — drops the key's best iff it is this exact config and
          persists an ``evicted`` tombstone line so the record does not
          resurrect when the log is replayed by a fresh process.
        """
        rec = dataclasses.replace(rec, signature=self._canon(rec.signature))
        with self._lock():
            repair_torn_tail(self._log_path())
            self.refresh()
            if kind == "put":
                if self._qkey(rec) in self._quarantined:
                    return False
                cur = self._best.get(rec.key())
                if cur is not None and rec.objective >= cur.objective:
                    return False
                self._offset += append_jsonl(
                    self._log_path(), rec.to_json(), fsync=True)
                self._fold(rec)
                return True
            if kind == "quarantine":
                if self._qkey(rec) in self._quarantined:
                    return False
                line = rec.to_json()
                line["quarantined"] = True
                self._offset += append_jsonl(self._log_path(), line, fsync=True)
                self._apply_quarantine(rec, line)
                return True
            if kind == "evict":
                cur = self._best.get(rec.key())
                if cur is None or config_key(cur.config) != config_key(rec.config):
                    return False
                line = rec.to_json()
                line["evicted"] = True
                self._offset += append_jsonl(self._log_path(), line, fsync=True)
                del self._best[rec.key()]
                return True
            raise ValueError(f"unknown replicated op kind {kind!r}")

    def ingest_database(
        self,
        db_path: str,
        kernel: str,
        signature: ShapeSignature,
        backend: str,
        source: str | None = None,
    ) -> TuningRecord | None:
        """Populate from an existing campaign result dir (results.jsonl/.json).
        Publishes the campaign's best evaluated config; returns it (or None
        when the campaign has no successful evaluation or no improvement)."""
        from repro_torch.core.database import PerformanceDatabase

        db = PerformanceDatabase(db_path)
        best = db.best()
        if best is None:
            return None
        rec = TuningRecord(
            kernel=kernel,
            signature=signature,
            backend=backend,
            config=dict(best.config),
            objective=float(best.objective),
            n_evals=len(db),
            source=source or f"campaign:{db_path}",
        )
        return rec if self.put(rec) else None

    def compact(
        self,
        *,
        ttl_sec: float | None = None,
        max_per_kernel: int | None = None,
    ) -> int:
        """Rewrite the log keeping only the current best per key, optionally
        evicting along the way. Returns the number of surviving records.

        * ``ttl_sec`` drops records older than the TTL (records with an
          unknown ``created`` time have infinite age and are evicted first);
        * ``max_per_kernel`` is a per-kernel size budget: only the
          ``max_per_kernel`` most-recently-used keys per kernel survive
          (LRU by this process's :meth:`get` hits, falling back to the
          record's ``created`` time for keys never read here).

        Quarantine tombstones survive compaction so a poisoned config stays
        banned across process restarts. Every eviction is reported to the
        replication op sink (as an ``evict`` tombstone op) so a compacted
        record does not resurrect from a peer on the next fleet pull."""
        with self._lock():
            self.refresh()
            now = time.time()
            survivors = dict(self._best)
            if ttl_sec is not None:
                survivors = {k: r for k, r in survivors.items()
                             if r.age_sec(now) <= ttl_sec}
            if max_per_kernel is not None:
                by_kernel: dict[str, list[tuple]] = {}
                for k, r in survivors.items():
                    by_kernel.setdefault(r.kernel, []).append((k, r))
                survivors = {}
                for items in by_kernel.values():
                    items.sort(key=lambda kr: self._access.get(kr[0], kr[1].created),
                               reverse=True)
                    survivors.update(dict(items[:max_per_kernel]))
            tmp = self._log_path() + ".tmp"
            with open(tmp, "w") as f:
                for rec in survivors.values():
                    f.write(json.dumps(rec.to_json()) + "\n")
                for line in self._quarantined_json.values():
                    f.write(json.dumps(line) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._log_path())
            evicted = [r for k, r in self._best.items() if k not in survivors]
            self._best = survivors
            self._access = {k: t for k, t in self._access.items() if k in survivors}
            self._offset = os.path.getsize(self._log_path())
            # evict ops are stamped while the store lock is still held:
            # eviction is the one op whose merge semantics are stamp-ordered
            # against puts ("a put dies iff stamp <= the newest evict
            # stamp"), so a concurrent put accepted after this compaction
            # must also be stamped after it — emitting outside the lock
            # would let that fresh result draw the older stamp and be
            # killed fleet-wide by our tombstone
            if self._op_sink is not None:
                for r in evicted:
                    self._op_sink("evict", r)
            return len(self._best)
