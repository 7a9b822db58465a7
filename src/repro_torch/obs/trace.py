"""Span tracing: append-only Chrome-trace-event JSONL.

Each line of the trace file is one Chrome trace event object (complete
``"ph": "X"`` spans with microsecond ``ts``/``dur``, ``"i"`` instants, and
``"M"`` metadata), so the file is simultaneously valid JSONL — crash-safe,
torn-tail tolerant via :mod:`repro_torch.core.jsonl`, greppable line by line — and
trivially convertible to a Perfetto/``chrome://tracing``-loadable
``{"traceEvents": [...]}`` JSON via :func:`export_chrome_trace` (or
``repro-obs summarize --perfetto out.json``).

Tracing is off by default: :func:`get_tracer` returns :data:`NULL_TRACER`
(whose ``span()`` hands back a shared no-op context manager, so instrumented
hot paths pay one attribute check) unless :func:`configure_tracer` was called
or the ``REPRO_TRACE=path`` environment variable names a trace file. One
timeline covers every instrumented layer — campaign ask/evaluate/tell,
database checkpoints, dispatch lookup/build/execute/quarantine, background
tuner campaigns/publishes, fleet pull/merge/push — because they all write
through the same process tracer with per-thread ``tid``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Iterator

from repro_torch.core.jsonl import repair_torn_tail

__all__ = [
    "Tracer",
    "NULL_TRACER",
    "get_tracer",
    "configure_tracer",
    "span",
    "instant",
    "iter_trace",
    "validate_trace",
    "export_chrome_trace",
]

TRACE_ENV = "REPRO_TRACE"


class _Span:
    __slots__ = ("_tracer", "_name", "_attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer._now_us()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = self._tracer._now_us()
        ev = {
            "name": self._name,
            "cat": "repro",
            "ph": "X",
            "ts": self._t0,
            "dur": max(0, t1 - self._t0),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if self._attrs:
            ev["args"] = self._attrs
        if exc_type is not None:
            ev.setdefault("args", {})["error"] = exc_type.__name__
        self._tracer.emit(ev)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every operation is a no-op."""

    enabled = False
    path = None

    def span(self, name: str, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, **attrs) -> None:
        pass

    def emit(self, event: dict) -> None:
        pass

    def close(self) -> None:
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """Appends one trace event per line to ``path``. Thread-safe (one lock
    around the file write); timestamps are wall-clock-anchored microseconds
    advanced by ``perf_counter`` so same-host traces align across processes."""

    enabled = True

    def __init__(self, path: str, process_name: str | None = None):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        repair_torn_tail(path)
        self.path = path
        self._f = open(path, "a")
        self._lock = threading.Lock()
        self._wall_us0 = time.time_ns() // 1000
        self._perf0 = time.perf_counter()
        if process_name:
            self.emit({"name": "process_name", "ph": "M", "ts": self._wall_us0,
                       "pid": os.getpid(), "tid": 0,
                       "args": {"name": process_name}})

    def _now_us(self) -> int:
        return self._wall_us0 + int((time.perf_counter() - self._perf0) * 1e6)

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def instant(self, name: str, **attrs) -> None:
        ev = {"name": name, "cat": "repro", "ph": "i", "s": "t",
              "ts": self._now_us(), "pid": os.getpid(),
              "tid": threading.get_ident()}
        if attrs:
            ev["args"] = attrs
        self.emit(ev)

    def emit(self, event: dict) -> None:
        line = json.dumps(event, default=str) + "\n"
        with self._lock:
            f = self._f
            if f is None or f.closed:
                return  # closed tracer: drop, never raise on a serving path
            f.write(line)
            f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None and not self._f.closed:
                self._f.close()


# -- process-wide default tracer -------------------------------------------------

_tracer: Tracer | NullTracer | None = None
_tracer_lock = threading.Lock()


def get_tracer() -> "Tracer | NullTracer":
    """The process tracer: configured one, else ``REPRO_TRACE`` env
    activation, else the shared no-op."""
    global _tracer
    t = _tracer
    if t is not None:
        return t
    with _tracer_lock:
        if _tracer is None:
            path = os.environ.get(TRACE_ENV)
            _tracer = Tracer(path) if path else NULL_TRACER
        return _tracer


def configure_tracer(path: "str | Tracer | None",
                     process_name: str | None = None) -> "Tracer | NullTracer":
    """Set the process tracer (a path, a ready Tracer, or None to disable).
    Returns the active tracer."""
    global _tracer
    with _tracer_lock:
        if _tracer is not None and _tracer.enabled:
            _tracer.close()
        if path is None:
            _tracer = NULL_TRACER
        elif isinstance(path, (Tracer, NullTracer)):
            _tracer = path
        else:
            _tracer = Tracer(path, process_name=process_name)
        return _tracer


def span(name: str, **attrs):
    """``with obs.span("campaign.ask", learner="RF"): ...`` through the
    process tracer (no-op unless tracing is enabled)."""
    return get_tracer().span(name, **attrs)


def instant(name: str, **attrs) -> None:
    get_tracer().instant(name, **attrs)


# -- validation / export ---------------------------------------------------------

_REQUIRED = ("name", "ph", "ts", "pid", "tid")


def iter_trace(path: str) -> Iterator[dict]:
    """Parsed events, one per valid line; blank/torn/garbage lines skipped."""
    if not os.path.exists(path):
        return
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(ev, dict):
                yield ev


def validate_trace(path: str) -> dict:
    """Structural check of a trace file: every parseable line must be a
    Chrome trace event (required keys present, ``X`` spans carry ``dur``).
    Returns ``{"ok", "events", "invalid", "skipped", "names"}`` — ``ok`` is
    False when the file is missing/empty or any *parsed* event is malformed.
    Unparseable lines (a torn tail from a killed writer) are counted in
    ``skipped`` and do not fail validation: the JSONL contract is that a
    torn fragment stays an isolated bad line, never corrupts its neighbors."""
    events = 0
    invalid = 0
    skipped = 0
    names: set[str] = set()
    if not os.path.exists(path):
        return {"ok": False, "events": 0, "invalid": 0, "skipped": 0, "names": []}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if not isinstance(ev, dict) or not all(k in ev for k in _REQUIRED) \
                    or (ev["ph"] == "X" and "dur" not in ev):
                invalid += 1
                continue
            events += 1
            names.add(str(ev["name"]))
    return {
        "ok": events > 0 and invalid == 0,
        "events": events,
        "invalid": invalid,
        "skipped": skipped,
        "names": sorted(names),
    }


def export_chrome_trace(src: str, out: str) -> int:
    """Wrap trace JSONL into a ``{"traceEvents": [...]}`` JSON file that
    Perfetto / ``chrome://tracing`` loads directly. Returns event count."""
    events = [ev for ev in iter_trace(src)
              if all(k in ev for k in _REQUIRED)]
    parent = os.path.dirname(out)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(out, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)
