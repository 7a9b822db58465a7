"""Deterministic fault injection for chaos testing.

A *fault point* is a named hook compiled into production code paths
(``fault_point("eval.crash")``).  When no fault is armed the hook is a
dict-emptiness check — effectively free — so the points stay in the
shipped code rather than living only in test monkeypatches.

Faults are armed either programmatically::

    with inject("dispatch.latency", delay_sec=0.05, where={"kernel": "syr2k"}):
        ...

or from the environment (picked up at import time and by ``install_env_faults``)::

    REPRO_FAULTS="eval.crash:times=2;transport.partition"

Activation is deterministic: ``times=N`` fires on the first N matching
hits, ``every=K`` fires on every K-th hit, ``where`` restricts firing to
call sites whose context labels contain the given substrings.  Hang
faults block on an Event with a bounded ``hang_max_sec`` and are released
when the arming context exits, so a "hung" worker thread never outlives
the test that created it.

This module is intentionally self-contained (stdlib only) so that
low-level modules such as ``repro_torch.core.jsonl`` can import it without
creating layering cycles.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

__all__ = [
    "CATALOG",
    "Fault",
    "FaultInjected",
    "active_faults",
    "clear_faults",
    "fault_hit",
    "fault_point",
    "inject",
    "install_env_faults",
]


class FaultInjected(Exception):
    """Raised by a fault point armed with ``raises=True``."""


# Named injection points and their default behavior when armed without
# explicit parameters (env var or bare inject(name)).  Call sites may
# reference points not listed here, but these are the supported set —
# ``repro-guard faults`` prints this catalog.
CATALOG: Dict[str, Dict[str, Any]] = {
    "eval.hang": {"hang": True,
                  "doc": "evaluator blocks until released (bounded by hang_max_sec)"},
    "eval.crash": {"raises": True,
                   "doc": "evaluator raises FaultInjected"},
    "eval.slow": {"delay_sec": 0.25,
                  "doc": "evaluator sleeps delay_sec (pathological slowdown)"},
    "dispatch.latency": {"delay_sec": 0.05,
                         "doc": "served executable sleeps delay_sec (latency inflation)"},
    "transport.flake": {"raises": True, "times": 1,
                        "doc": "one transport op raises ConnectionError, then heals"},
    "transport.partition": {"raises": True,
                            "doc": "every transport op raises ConnectionError"},
    "store.torn_write": {"times": 1,
                         "doc": "next JSONL append writes a torn half-line then dies"},
}


@dataclasses.dataclass
class Fault:
    """One armed fault: firing rule + behavior."""

    point: str
    times: Optional[int] = None      # fire on first N matching hits (None = unlimited)
    every: int = 1                   # fire on every K-th matching hit
    where: Optional[Dict[str, str]] = None  # substring filters on call-site context
    delay_sec: float = 0.0           # sleep before raising/returning
    hang: bool = False               # block on the release event
    hang_max_sec: float = 30.0       # upper bound on a hang
    raises: bool = False             # raise exc after delay/hang
    exc: type = FaultInjected

    # mutable state
    hits: int = 0
    fired: int = 0

    def __post_init__(self) -> None:
        self.release_event = threading.Event()

    def matches(self, ctx: Dict[str, Any]) -> bool:
        if not self.where:
            return True
        return all(v in str(ctx.get(k, "")) for k, v in self.where.items())

    def release(self) -> None:
        """Unblock any thread parked on this fault's hang."""
        self.release_event.set()


_lock = threading.Lock()
_ACTIVE: Dict[str, Fault] = {}


def _arm(fault: Fault) -> Fault:
    with _lock:
        _ACTIVE[fault.point] = fault
    return fault


def _disarm(point: str) -> None:
    with _lock:
        fault = _ACTIVE.pop(point, None)
    if fault is not None:
        fault.release()


def clear_faults() -> None:
    """Disarm everything (releases pending hangs)."""
    with _lock:
        faults = list(_ACTIVE.values())
        _ACTIVE.clear()
    for f in faults:
        f.release()


def active_faults() -> Dict[str, Fault]:
    with _lock:
        return dict(_ACTIVE)


def fault_hit(point: str, **ctx: Any) -> Optional[Fault]:
    """Return the armed fault if this hit fires, without applying behavior.

    For call sites with fault-specific semantics (e.g. the torn-write
    point in ``append_jsonl`` writes half a line itself).
    """
    if not _ACTIVE:
        return None
    with _lock:
        fault = _ACTIVE.get(point)
        if fault is None or not fault.matches(ctx):
            return None
        fault.hits += 1
        if fault.hits % max(fault.every, 1) != 0:
            return None
        if fault.times is not None and fault.fired >= fault.times:
            return None
        fault.fired += 1
        return fault


def fault_point(point: str, **ctx: Any) -> bool:
    """Production hook: apply the armed fault's behavior, if any.

    Returns True if a fault fired.  Near-zero cost when nothing is armed.
    """
    if not _ACTIVE:
        return False
    fault = fault_hit(point, **ctx)
    if fault is None:
        return False
    if fault.delay_sec > 0.0:
        # interruptible sleep: released early when the fault is disarmed
        fault.release_event.wait(fault.delay_sec)
    if fault.hang:
        fault.release_event.wait(fault.hang_max_sec)
    if fault.raises:
        raise fault.exc(f"injected fault: {point}")
    return True


@contextmanager
def inject(point: str, **kw: Any) -> Iterator[Fault]:
    """Arm ``point`` for the duration of the block.

    Unspecified behavior fields default to the CATALOG entry for the
    point.  On exit the fault is disarmed and any parked hang released.
    """
    fault = _arm(_build(point, kw))
    try:
        yield fault
    finally:
        _disarm(point)


def _build(point: str, kw: Dict[str, Any]) -> Fault:
    defaults = {k: v for k, v in CATALOG.get(point, {}).items() if k != "doc"}
    merged = {**defaults, **kw}
    if merged.get("raises") and "exc" not in merged and point.startswith("transport."):
        merged["exc"] = ConnectionError
    return Fault(point=point, **merged)


def install_env_faults(spec: Optional[str] = None) -> int:
    """Arm faults from a ``REPRO_FAULTS`` spec string.

    Grammar: ``point[:key=val,...]`` joined by ``;``.  Keys: ``times``,
    ``every``, ``delay`` (sec), ``hang_max`` (sec), ``hang``, ``raise``,
    ``where.<label>=<substring>``.  Returns the number of faults armed.
    """
    spec = os.environ.get("REPRO_FAULTS", "") if spec is None else spec
    n = 0
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, params = part.partition(":")
        kw: Dict[str, Any] = {}
        where: Dict[str, str] = {}
        for item in params.split(","):
            item = item.strip()
            if not item:
                continue
            key, _, val = item.partition("=")
            if key == "times":
                kw["times"] = int(val)
            elif key == "every":
                kw["every"] = int(val)
            elif key == "delay":
                kw["delay_sec"] = float(val)
            elif key == "hang_max":
                kw["hang_max_sec"] = float(val)
            elif key == "hang":
                kw["hang"] = val.lower() not in ("0", "false")
            elif key == "raise":
                kw["raises"] = val.lower() not in ("0", "false")
            elif key.startswith("where."):
                where[key[len("where."):]] = val
        if where:
            kw["where"] = where
        _arm(_build(name.strip(), kw))
        n += 1
    return n


if os.environ.get("REPRO_FAULTS"):
    install_env_faults()
