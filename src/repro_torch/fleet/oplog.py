"""The replication oplog: per-host operation streams + deterministic merge.

Every local :class:`~repro_torch.dispatch.store.TuningStore` mutation becomes an
**op** — ``put`` / ``quarantine`` / ``evict`` — stamped with the emitting
host's id, a per-host monotonic sequence number, and a Lamport clock:

* the ``(host, seq)`` pair is the replication cursor: a **version vector**
  ``{host: max seq}`` describes exactly which ops a replica already holds,
  so transports ship deltas and re-delivery is a no-op;
* the ``(clock, host, seq)`` triple is a total order (the *stamp*) used by
  the merge to decide causality questions — most importantly whether a
  ``put`` happened before or after an ``evict`` tombstone for its key.

On disk (``<store>/fleet/``):

* ``host``      — this host's stable id, created once;
* ``log.jsonl`` — every op known to this host (own and replicated), in
  local application order, guarded by ``fleet.lock`` (flock) so several
  processes on one host can share the log the way they share the store;
* ``sync.json`` — timestamp + counters of the last anti-entropy cycle
  (telemetry only, written atomically).

Merge semantics (:class:`MergeState`) are a pure function of the op *set*:
applying any interleaving of the same ops — or re-applying a stream twice —
converges to identical winners. Per key, the **lowest objective wins** among
puts that survive quarantine (permanent, per exact config) and eviction
(a put is dead iff its stamp is ≤ the key's newest evict stamp — so a
tombstone kills everything it causally saw, while a genuinely newer tuning
result legitimately resurrects the key). Commutativity under eviction
requires remembering more than the current winner: we keep each key's
*undominated frontier* of puts — ``e`` permanently shadows ``p`` only when
``e`` wins selection (lower objective), survives every eviction ``p``
survives (newer stamp), AND dies with ``p`` under quarantine (same config).
The frontier holds at most one shadowed-out entry per distinct config.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
import uuid
from typing import Iterable, Iterator, Mapping

try:
    import fcntl
except ImportError:  # non-POSIX: single-process best effort
    fcntl = None

from repro_torch.core.jsonl import append_jsonl, iter_jsonl_tail, repair_torn_tail
from repro_torch.core.space import config_key
from repro_torch.dispatch.store import TuningRecord

__all__ = ["Op", "OpLog", "MergeState", "OP_KINDS"]

OP_KINDS = ("put", "quarantine", "evict")


@dataclasses.dataclass(frozen=True)
class Op:
    host: str
    seq: int        # per-host monotonic, 1-based
    clock: int      # Lamport stamp
    kind: str       # one of OP_KINDS
    record: TuningRecord

    @property
    def stamp(self) -> tuple:
        """Total order over ops: Lamport clock, host id, sequence number."""
        return (self.clock, self.host, self.seq)

    def key(self) -> tuple:
        return self.record.key()

    def to_json(self) -> dict:
        d = self.record.to_json()
        d["op"] = {"host": self.host, "seq": self.seq,
                   "clock": self.clock, "kind": self.kind}
        return d

    @classmethod
    def from_json(cls, d: Mapping) -> "Op":
        o = d["op"]
        kind = str(o["kind"])
        if kind not in OP_KINDS:
            # reject at the parse boundary: an unknown kind must never be
            # appended to a log, where it would crash every later replay
            raise ValueError(f"unknown op kind {kind!r}")
        return cls(host=str(o["host"]), seq=int(o["seq"]), clock=int(o["clock"]),
                   kind=kind, record=TuningRecord.from_json(d))


def _dominates(e: Op, p: Op) -> bool:
    # e makes p permanently irrelevant: e survives everything p survives
    # AND beats p in winner selection (lower objective; equal objectives
    # select by lowest stamp, which e's newer stamp cannot win). Surviving
    # "everything" needs the SAME config — an eviction is outlived by any
    # newer stamp, but a quarantine kills by config, so pruning across
    # configs would lose the put that should resurrect when a quarantine
    # later lands on the dominator.
    return (config_key(e.record.config) == config_key(p.record.config)
            and e.record.objective < p.record.objective and e.stamp > p.stamp)


class MergeState:
    """Order-independent fold of put/quarantine/evict ops (see module doc)."""

    def __init__(self):
        self._frontier: dict[tuple, list[Op]] = {}
        self._evict_stamp: dict[tuple, tuple] = {}
        self._quarantined: set[tuple] = set()   # key + config-key
        # the quarantine ops themselves, per key: reconciliation re-derives
        # store-level bans from here, so a crash between durable ingest and
        # store application (or a wiped store dir) cannot lose a ban —
        # version-vector dedup means the op will never be delivered again
        self._qops: dict[tuple, list[Op]] = {}
        # every put content ever folded (key + config-key + objective),
        # including dead ones: bootstrap must not re-emit a store record the
        # fleet already judged — a tombstoned record surviving in the store
        # through the ingest/apply crash window would otherwise come back
        # with a fresh stamp and outlive its own eviction
        self._put_contents: set[tuple] = set()

    @staticmethod
    def _sel(op: Op) -> tuple:
        return (op.record.objective, op.stamp)

    def winner(self, key: tuple) -> Op | None:
        """The merged best put for ``key`` (lowest objective; ties broken by
        lowest stamp), or None when every put is dead."""
        front = self._frontier.get(key)
        return min(front, key=self._sel) if front else None

    def keys(self) -> list[tuple]:
        return list(self._frontier.keys() | self._evict_stamp.keys()
                    | self._qops.keys())

    def is_quarantined(self, key: tuple, config: Mapping) -> bool:
        return key + (config_key(dict(config)),) in self._quarantined

    def quarantine_ops(self, key: tuple) -> list[Op]:
        return list(self._qops.get(key, ()))

    def has_put_content(self, rec: TuningRecord) -> bool:
        """Whether a put op with this exact content was ever folded —
        alive, shadowed, tombstoned, or quarantined."""
        return rec.key() + (config_key(rec.config), rec.objective) \
            in self._put_contents

    def apply(self, op: Op) -> bool:
        """Fold one op; returns whether the key's winner changed. Must only
        see each (host, seq) once — :class:`OpLog` dedups by version vector."""
        key = op.key()
        before = self.winner(op.key())
        if op.kind == "quarantine":
            ck = config_key(op.record.config)
            if key + (ck,) not in self._quarantined:
                self._quarantined.add(key + (ck,))
                self._qops.setdefault(key, []).append(op)
            front = [p for p in self._frontier.get(key, ())
                     if config_key(p.record.config) != ck]
            self._set_frontier(key, front)
        elif op.kind == "evict":
            prev = self._evict_stamp.get(key)
            if prev is None or op.stamp > prev:
                self._evict_stamp[key] = op.stamp
            stamp = self._evict_stamp[key]
            front = [p for p in self._frontier.get(key, ()) if p.stamp > stamp]
            self._set_frontier(key, front)
        elif op.kind == "put":
            self._put_contents.add(
                key + (config_key(op.record.config), op.record.objective))
            if key + (config_key(op.record.config),) in self._quarantined:
                return False
            evicted = self._evict_stamp.get(key)
            if evicted is not None and op.stamp <= evicted:
                return False
            front = self._frontier.get(key, [])
            if any(_dominates(e, op) for e in front):
                return False
            self._set_frontier(
                key, [e for e in front if not _dominates(op, e)] + [op])
        else:
            raise ValueError(f"unknown op kind {op.kind!r}")
        after = self.winner(key)
        if (before is None) != (after is None):
            return True
        return before is not None and before.stamp != after.stamp

    def _set_frontier(self, key: tuple, front: list[Op]) -> None:
        if front:
            self._frontier[key] = front
        else:
            self._frontier.pop(key, None)


class OpLog:
    """Durable op stream of one host: emission of local ops, idempotent
    ingestion of replicated ones, and the live :class:`MergeState`."""

    def __init__(self, path: str, host_id: str | None = None):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.host_id = host_id or self._load_or_create_host_id()
        self.state = MergeState()
        self._ops: list[Op] = []
        self._vv: dict[str, int] = {}
        self._clock = 0
        self._offset = 0
        self._tlock = threading.RLock()
        self.refresh()

    # -- identity / paths --------------------------------------------------------

    def _load_or_create_host_id(self) -> str:
        hpath = os.path.join(self.path, "host")
        try:
            with open(hpath) as f:
                hid = f.read().strip()
            if hid:
                return hid
        except FileNotFoundError:
            pass
        # claim by fully-written-then-linked temp file: a loser of the race
        # reads a COMPLETE host file (open('x')-then-write would let it read
        # an empty one, and an empty host id collapses seq spaces fleet-wide)
        hid = "h" + uuid.uuid4().hex[:10]
        tmp = f"{hpath}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(hid + "\n")
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, hpath)           # atomic: fails if someone else won
        except FileExistsError:
            with open(hpath) as f:
                hid = f.read().strip()
        finally:
            os.unlink(tmp)
        return hid

    def _log_path(self) -> str:
        return os.path.join(self.path, "log.jsonl")

    @contextlib.contextmanager
    def _lock(self) -> Iterator[None]:
        f = open(os.path.join(self.path, "fleet.lock"), "a+")
        try:
            if fcntl is not None:
                fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            yield
        finally:
            if fcntl is not None:
                fcntl.flock(f.fileno(), fcntl.LOCK_UN)
            f.close()

    # -- folding -----------------------------------------------------------------

    def __len__(self) -> int:
        with self._tlock:
            return len(self._ops)

    def _fold(self, op: Op) -> bool:
        self._vv[op.host] = max(self._vv.get(op.host, 0), op.seq)
        self._clock = max(self._clock, op.clock)
        self._ops.append(op)
        return self.state.apply(op)

    def refresh(self) -> list[Op]:
        """Fold ops appended to the log by other processes on this host
        since the last read; returns the newly seen ops."""
        new: list[Op] = []
        with self._tlock:
            for d, self._offset in iter_jsonl_tail(self._log_path(),
                                                   self._offset):
                if d is None:
                    continue
                try:
                    op = Op.from_json(d)
                except (KeyError, ValueError):
                    continue
                if op.seq <= self._vv.get(op.host, 0):
                    continue  # replayed duplicate
                self._fold(op)
                new.append(op)
        return new

    # -- locked MergeState views (safe against concurrent emit/ingest) -----------

    def merge_keys(self) -> list[tuple]:
        with self._tlock:
            return self.state.keys()

    def winner(self, key: tuple) -> Op | None:
        with self._tlock:
            return self.state.winner(key)

    def key_quarantines(self, key: tuple) -> list[Op]:
        with self._tlock:
            return self.state.quarantine_ops(key)

    # -- write side --------------------------------------------------------------

    def emit(self, kind: str, rec: TuningRecord) -> Op:
        """Stamp and append one locally-originated op. Safe across processes
        sharing this log dir: the flock + refresh keep per-host sequence
        numbers monotonic even with several emitters."""
        if kind not in OP_KINDS:
            raise ValueError(f"unknown op kind {kind!r}")
        with self._tlock, self._lock():
            repair_torn_tail(self._log_path())
            self.refresh()
            self._clock += 1
            op = Op(host=self.host_id, seq=self._vv.get(self.host_id, 0) + 1,
                    clock=self._clock, kind=kind, record=rec)
            self._offset += append_jsonl(self._log_path(), op.to_json(), fsync=True)
            self._fold(op)
            return op

    def ensure_put(self, rec: TuningRecord) -> Op | None:
        """Bootstrap hook: emit a put for a store record that predates fleet
        attachment — genuinely new local knowledge — unless the record's
        exact content is already a known put op (alive, shadowed, tombstoned
        or quarantined). Re-emitting known content would both grow the log
        on every re-attach and, worse, resurrect a fleet-evicted record with
        a fresh stamp when a crash left the store lagging the oplog."""
        with self._tlock:
            if self.state.has_put_content(rec):
                return None
            return self.emit("put", rec)

    def ingest(self, ops: Iterable[Op]) -> tuple[list[Op], set]:
        """Fold replicated ops; returns ``(newly applied ops, keys whose
        merge winner changed)``. Ops must arrive in per-host seq order (both
        built-in transports preserve append order); already-known ops are
        skipped by version vector, so re-ingesting any stream is idempotent."""
        applied: list[Op] = []
        changed: set = set()
        with self._tlock, self._lock():
            repair_torn_tail(self._log_path())
            for op in self.refresh():       # other-process emissions count too
                changed.add(op.key())
            for op in ops:
                if op.kind not in OP_KINDS:
                    continue  # never append what replay would choke on
                if op.seq <= self._vv.get(op.host, 0):
                    continue
                self._offset += append_jsonl(
                    self._log_path(), op.to_json(), fsync=True)
                if self._fold(op):
                    changed.add(op.key())
                applied.append(op)
        return applied, changed

    # -- read side (transports / telemetry) --------------------------------------

    def version_vector(self) -> dict[str, int]:
        with self._tlock:
            return dict(self._vv)

    def ops_after(self, vv: Mapping[str, int]) -> list[Op]:
        """Every known op not covered by ``vv`` — own and replicated, so a
        pull through any reachable peer propagates third-party ops too."""
        with self._tlock:
            return [op for op in self._ops if op.seq > vv.get(op.host, 0)]

    def own_ops_after(self, seq: int) -> list[Op]:
        with self._tlock:
            return [op for op in self._ops
                    if op.host == self.host_id and op.seq > seq]

    # -- sync telemetry ----------------------------------------------------------

    def note_sync(self, **counters) -> None:
        tmp = os.path.join(self.path, "sync.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"time": time.time(), **counters}, f)
        os.replace(tmp, os.path.join(self.path, "sync.json"))

    def last_sync(self) -> dict | None:
        try:
            with open(os.path.join(self.path, "sync.json")) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
