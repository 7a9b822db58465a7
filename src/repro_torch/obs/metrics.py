"""Metrics core: counters, gauges, and log-bucketed latency histograms.

Design constraints, in priority order:

1. **Recording must be lock-free.** The dispatch fast-hit path is pinned (by
   test) to exactly one lock acquisition; metric recording therefore goes to
   a per-thread shard — a plain dict owned by one thread — and shards are
   folded under the registry lock only at :meth:`MetricsRegistry.snapshot`
   time. The only locked operation on a recording path is the one-time shard
   registration when a thread records its first metric.
2. **Histograms must merge deterministically.** Bucket boundaries are a
   fixed module-level constant (log2-spaced, ~1µs to ~256s), so merging two
   histograms — across threads, processes, or hosts — is element-wise count
   addition: associative, commutative, and schema-free. This mirrors the
   fleet oplog's order-independent merge contract.
3. **Snapshots are plain JSON.** ``snapshot()`` returns a dict that
   round-trips through ``json`` unchanged, so the same structure is the
   in-process view, the JSONL snapshot line, and the cross-host merge input.

Recording concurrently with ``snapshot()`` is safe (CPython dict/int ops are
atomic under the GIL) but a mid-record fold may observe a histogram whose
``count`` includes an observation whose ``sum`` does not yet — totals are
exact once the recording threads quiesce, which is what the concurrency test
pins.
"""

from __future__ import annotations

import bisect
import itertools
import threading
from typing import Any, Iterable, Mapping

__all__ = [
    "BUCKET_BOUNDS",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
    "histogram_quantile",
    "merge_snapshots",
    "summarize_histograms",
]

SCHEMA = "repro.obs/1"

# Fixed for all time: log2-spaced upper bounds in seconds, ~0.95µs .. 256s,
# plus an implicit +Inf bucket. Changing these breaks cross-version snapshot
# merging — add a new schema instead.
BUCKET_BOUNDS: tuple[float, ...] = tuple(2.0 ** e for e in range(-20, 9))

LabelKey = tuple  # ((k, v), ...) sorted


def _label_key(labels: Mapping[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Histogram:
    """One histogram cell: per-bucket counts over :data:`BUCKET_BOUNDS`
    (+Inf last), plus exact ``sum`` and ``count``."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self):
        self.counts = [0] * (len(BUCKET_BOUNDS) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(BUCKET_BOUNDS, value)] += 1
        self.sum += value
        self.count += 1

    def merge(self, other: "Histogram | Mapping[str, Any]") -> "Histogram":
        counts = other["counts"] if isinstance(other, Mapping) else other.counts
        osum = other["sum"] if isinstance(other, Mapping) else other.sum
        ocount = other["count"] if isinstance(other, Mapping) else other.count
        for i, c in enumerate(counts):
            self.counts[i] += int(c)
        self.sum += float(osum)
        self.count += int(ocount)
        return self

    def quantile(self, q: float) -> float:
        return histogram_quantile(self.counts, q)

    def to_json(self) -> dict:
        return {"counts": list(self.counts), "sum": self.sum, "count": self.count}


def histogram_quantile(counts: Iterable[int], q: float) -> float:
    """Prometheus-style quantile estimate from cumulative bucket walk with
    linear interpolation inside the winning bucket. The +Inf bucket clamps
    to the largest finite boundary. NaN for an empty histogram."""
    counts = list(counts)
    total = sum(counts)
    if total <= 0:
        return float("nan")
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= rank:
            lo = BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
            if i >= len(BUCKET_BOUNDS):  # +Inf bucket
                return BUCKET_BOUNDS[-1]
            hi = BUCKET_BOUNDS[i]
            return lo + (hi - lo) * max(0.0, min(1.0, (rank - cum) / c))
        cum += c
    return BUCKET_BOUNDS[-1]


class _Shard:
    """One thread's private metric cells. Never locked: only its owner
    writes, and snapshot-time readers tolerate a torn in-flight update."""

    __slots__ = ("counters", "gauges", "hists")

    def __init__(self):
        self.counters: dict[tuple, float] = {}
        self.gauges: dict[tuple, tuple[int, float]] = {}  # key -> (seq, value)
        self.hists: dict[tuple, Histogram] = {}


class MetricsRegistry:
    """Process-wide metric store; see module docstring for the sharding and
    merge contracts. All three record methods take ``**labels`` keyword
    label pairs; values are stringified (shape-signature keys, learner
    names, kernel names all pass through unchanged)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._shards: list[_Shard] = []
        # shared monotonic stamp: last-write-wins gauge folding across shards
        self._gauge_seq = itertools.count(1)

    # -- recording (lock-free after first use per thread) ------------------------

    def _shard(self) -> _Shard:
        shard = getattr(self._local, "shard", None)
        if shard is None:
            shard = _Shard()
            with self._lock:  # once per (thread, registry) lifetime
                self._shards.append(shard)
            self._local.shard = shard
        return shard

    def add(self, name: str, value: float = 1.0, **labels) -> None:
        """Increment a counter."""
        key = (name, _label_key(labels))
        counters = self._shard().counters
        counters[key] = counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        """Set a gauge (last write wins across threads, by global seq)."""
        self._shard().gauges[(name, _label_key(labels))] = (
            next(self._gauge_seq), float(value))

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one observation into a log-bucketed histogram."""
        key = (name, _label_key(labels))
        hists = self._shard().hists
        h = hists.get(key)
        if h is None:
            h = hists[key] = Histogram()
        h.observe(value)

    # -- folding -----------------------------------------------------------------

    def snapshot(self) -> dict:
        """Fold every shard into one JSON-safe snapshot (sorted, so equal
        states serialize identically)."""
        counters: dict[tuple, float] = {}
        gauges: dict[tuple, tuple[int, float]] = {}
        hists: dict[tuple, Histogram] = {}
        with self._lock:
            shards = list(self._shards)
        for shard in shards:
            for key, v in list(shard.counters.items()):
                counters[key] = counters.get(key, 0.0) + v
            for key, (seq, v) in list(shard.gauges.items()):
                if key not in gauges or seq > gauges[key][0]:
                    gauges[key] = (seq, v)
            for key, h in list(shard.hists.items()):
                tgt = hists.get(key)
                if tgt is None:
                    tgt = hists[key] = Histogram()
                tgt.merge(h)
        return {
            "schema": SCHEMA,
            "buckets": list(BUCKET_BOUNDS),
            "counters": [
                {"name": n, "labels": dict(lk), "value": counters[(n, lk)]}
                for n, lk in sorted(counters)],
            "gauges": [
                {"name": n, "labels": dict(lk), "value": gauges[(n, lk)][1]}
                for n, lk in sorted(gauges)],
            "histograms": [
                {"name": n, "labels": dict(lk), **hists[(n, lk)].to_json()}
                for n, lk in sorted(hists)],
        }


def merge_snapshots(*snaps: Mapping[str, Any]) -> dict:
    """Deterministic snapshot merge: counters and histograms sum, gauges are
    last-write-wins in argument order. Associative and commutative for
    counters/histograms (the property test pins this); raises on mismatched
    bucket schemas rather than silently mixing them."""
    counters: dict[tuple, float] = {}
    gauges: dict[tuple, float] = {}
    hists: dict[tuple, Histogram] = {}
    for snap in snaps:
        if list(snap.get("buckets", BUCKET_BOUNDS)) != list(BUCKET_BOUNDS):
            raise ValueError("snapshot bucket schema mismatch")
        for c in snap.get("counters", []):
            key = (c["name"], _label_key(c["labels"]))
            counters[key] = counters.get(key, 0.0) + float(c["value"])
        for g in snap.get("gauges", []):
            gauges[(g["name"], _label_key(g["labels"]))] = float(g["value"])
        for hrow in snap.get("histograms", []):
            key = (hrow["name"], _label_key(hrow["labels"]))
            tgt = hists.get(key)
            if tgt is None:
                tgt = hists[key] = Histogram()
            tgt.merge(hrow)
    return {
        "schema": SCHEMA,
        "buckets": list(BUCKET_BOUNDS),
        "counters": [{"name": n, "labels": dict(lk), "value": counters[(n, lk)]}
                     for n, lk in sorted(counters)],
        "gauges": [{"name": n, "labels": dict(lk), "value": gauges[(n, lk)]}
                   for n, lk in sorted(gauges)],
        "histograms": [{"name": n, "labels": dict(lk), **hists[(n, lk)].to_json()}
                       for n, lk in sorted(hists)],
    }


def summarize_histograms(
    snapshot: Mapping[str, Any],
    name: str | None = None,
    prefix: str | None = None,
) -> list[dict]:
    """Per-cell ``{name, labels, count, sum, p50, p99}`` rows for the
    histograms in a snapshot, filtered by exact ``name`` or ``prefix``."""
    out = []
    for h in snapshot.get("histograms", []):
        if name is not None and h["name"] != name:
            continue
        if prefix is not None and not h["name"].startswith(prefix):
            continue
        counts = h["counts"]
        out.append({
            "name": h["name"],
            "labels": dict(h["labels"]),
            "count": int(h["count"]),
            "sum": float(h["sum"]),
            "p50": histogram_quantile(counts, 0.50),
            "p99": histogram_quantile(counts, 0.99),
        })
    return out


# -- process-wide default registry ----------------------------------------------

_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process default (tests use this for isolation)."""
    global _registry
    _registry = registry
    return registry
