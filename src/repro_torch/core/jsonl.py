"""Crash-safe JSONL primitives shared by the performance database and the
dispatch tuning store.

The failure mode both care about: a writer dies mid-append, leaving a torn
(newline-less) final line. A later append must not concatenate onto that
tail — it would merge two records into one unparseable line and silently
lose both. :func:`repair_torn_tail` terminates the tail so the torn fragment
becomes an isolated invalid line that loaders can skip, and every append
stays line-delimited.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterator

# guard.faults is stdlib-only (and repro_torch.guard's __init__ is lazy), so this
# bottom-layer module can host the torn-write chaos point without a cycle
from repro_torch.guard.faults import FaultInjected, fault_hit

__all__ = ["repair_torn_tail", "append_jsonl", "iter_jsonl_tail"]


def repair_torn_tail(path: str) -> bool:
    """Terminate a torn final line with a newline. Returns True on repair.
    Call before appending to (or after crash-loading) a JSONL file."""
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return False
    with open(path, "rb+") as f:
        f.seek(-1, os.SEEK_END)
        if f.read(1) == b"\n":
            return False
        f.write(b"\n")
        return True


def append_jsonl(path: str, obj: Any, fsync: bool = False) -> int:
    """Append one JSON object as one line; returns bytes written."""
    line = json.dumps(obj) + "\n"
    _maybe_tear(path, line)
    with open(path, "a") as f:
        f.write(line)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    return len(line.encode())


def _maybe_tear(path: str, line: str) -> None:
    """The ``store.torn_write`` chaos fault: when armed (repro_torch.guard.faults),
    simulate a writer dying mid-append — half the line lands on disk with no
    newline, then the writer "crashes". Every durable-log append in the tree
    funnels through :func:`append_jsonl`, so one injection point covers the
    tuning store, the fleet oplog, and the obs snapshot log."""
    if fault_hit("store.torn_write", path=path) is None:
        return
    with open(path, "a") as f:
        f.write(line[: max(1, len(line) // 2)])
        f.flush()
    raise FaultInjected(f"store.torn_write: died mid-append to {path}")


def iter_jsonl_tail(path: str, offset: int) -> Iterator[tuple[Any, int]]:
    """Tail complete JSONL lines from byte ``offset``: yields
    ``(obj, end_offset)`` per line — ``obj`` is None for a blank or
    unparseable line (its bytes still advance the offset) — and stops
    *before* a torn final line, so a writer mid-append is retried at the
    caller's next tail. A missing file yields nothing.

    This is the one incremental-reader loop shared by the tuning store, the
    fleet oplog, and the fleet file transport; the subtleties (advance by
    encoded byte length before stripping, never step past a newline-less
    tail) live here exactly once."""
    if not os.path.exists(path):
        return
    with open(path) as f:
        f.seek(offset)
        for line in f:
            if not line.endswith("\n"):
                return
            offset += len(line.encode())
            line = line.strip()
            if not line:
                yield None, offset
                continue
            try:
                yield json.loads(line), offset
            except json.JSONDecodeError:
                yield None, offset
