"""Fleet transports: how op streams move between hosts.

The contract (:class:`Transport`) is three idempotent methods over an
:class:`~repro_torch.fleet.oplog.OpLog`:

* ``push(oplog) -> int``   — make locally-known ops durable/visible to
  peers; safe to call repeatedly (re-pushing already-visible ops is a
  no-op, the high-water mark is re-derived from the medium itself);
* ``pull(oplog) -> [Op]``  — fetch ops this host may not have yet; final
  deduplication always happens at ``oplog.ingest`` by version vector, so a
  transport may over-deliver but must preserve per-host seq order;
* ``pending(oplog) -> int``— replication lag: locally-known ops not yet
  visible through this transport (the ``launch.fleet status`` metric).

:class:`FileTransport` is the shared-directory / object-store-style
instance: one append-only object per host, ``<root>/<host>.ops.jsonl``,
written ONLY by its owner. Single-writer objects need no cross-host
locking and map 1:1 onto append-or-replace object stores (the listed
follow-on). The localhost HTTP pair lives in :mod:`repro_torch.fleet.http`.
"""

from __future__ import annotations

import os

from repro_torch.core.jsonl import append_jsonl, iter_jsonl_tail, repair_torn_tail
from repro_torch.fleet.oplog import Op, OpLog

__all__ = ["Transport", "FileTransport", "transport_from_spec"]


class Transport:
    """Protocol base; see module docstring for the contract."""

    def push(self, oplog: OpLog) -> int:
        raise NotImplementedError

    def pull(self, oplog: OpLog) -> list[Op]:
        raise NotImplementedError

    def pending(self, oplog: OpLog) -> int:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


class FileTransport(Transport):
    """Shared-directory transport (object-store idiom: single-writer
    append-only objects; readers re-scan and filter by version vector)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._push_cache: dict[str, tuple[int, int]] = {}  # path -> (size, seq)

    def describe(self) -> str:
        return f"file:{self.root}"

    def _own_path(self, oplog: OpLog) -> str:
        return os.path.join(self.root, f"{oplog.host_id}.ops.jsonl")

    def _published_seq(self, path: str) -> int:
        """Durable high-water mark, re-derived from the object itself so a
        restarted host never double-publishes (ops in the own file are in
        seq order: the last complete line carries the max)."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return 0
        cached = self._push_cache.get(path)
        if cached is not None and cached[0] == size:
            return cached[1]
        seq = 0
        for d, _ in iter_jsonl_tail(path, 0):
            try:
                seq = max(seq, int(d["op"]["seq"]))
            except (TypeError, KeyError, ValueError):
                continue
        self._push_cache[path] = (size, seq)
        return seq

    def push(self, oplog: OpLog) -> int:
        path = self._own_path(oplog)
        repair_torn_tail(path)  # single writer: our own crashed append
        ops = oplog.own_ops_after(self._published_seq(path))
        for op in ops:
            append_jsonl(path, op.to_json())
        if ops:
            self._push_cache[path] = (os.path.getsize(path), ops[-1].seq)
        return len(ops)

    def pull(self, oplog: OpLog) -> list[Op]:
        """Ops from every other host's object not covered by the oplog's
        version vector. Deliberately stateless: coverage is judged against
        the durably-advanced vv, never an in-memory cursor, so a pull whose
        ingest later fails (disk full, crash mid-cycle) is simply
        re-delivered next cycle instead of being lost for the process's
        lifetime. Unparseable lines are skipped, not fatal — a newer peer's
        unknown op kinds must not wedge replication of its valid ops."""
        out: list[Op] = []
        vv = oplog.version_vector()
        own = os.path.basename(self._own_path(oplog))
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return out
        for name in names:
            if not name.endswith(".ops.jsonl") or name == own:
                continue
            try:
                for d, _ in iter_jsonl_tail(os.path.join(self.root, name), 0):
                    if d is None:
                        continue
                    try:
                        op = Op.from_json(d)
                    except (KeyError, ValueError):
                        continue
                    if op.seq > vv.get(op.host, 0):
                        out.append(op)
            except OSError:
                continue
        return out

    def pending(self, oplog: OpLog) -> int:
        return len(oplog.own_ops_after(self._published_seq(self._own_path(oplog))))


def transport_from_spec(spec: str) -> Transport:
    """``file:<dir>`` or ``http(s)://host:port`` — the CLI/config syntax."""
    if spec.startswith("file:"):
        return FileTransport(spec[len("file:"):])
    if spec.startswith(("http://", "https://")):
        from repro_torch.fleet.http import HttpTransport

        return HttpTransport(spec)
    raise ValueError(
        f"unknown transport spec {spec!r} (expected file:<dir> or http://...)")
