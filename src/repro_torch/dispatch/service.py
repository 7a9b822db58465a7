"""The runtime dispatch service: ``dispatch(kernel_name, *args)``.

The counterpart of ``repro.dispatch.service``, with PyTorch's eager calls in
place of JAX's tracing. Resolution pipeline per call:

  1. derive the shape signature from the runtime args (plus static kwargs);
  2. consult the in-process **executable cache** keyed by ``(kernel,
     config, signature)`` — a signature-keyed fast map (TTL
     ``resolve_ttl_sec``) remembers the last resolution, so a hit returns
     the already-built variant with zero store traffic; the TTL bounds how
     long a cross-process store improvement can go unnoticed, and
     in-process improvements are picked up immediately via
     :meth:`invalidate`;
  3. on a cache miss, resolve a config from the :class:`TuningStore`
     (exact hit → nearest neighbor → registered space default), build the
     variant via the dispatch registry, and cache it. A store-resolved
     config is untrusted: the **build guard** builds the variant and runs
     its pre-launch checks on the call's arguments (shapes, dtypes, the
     kernel's shared memory against the device's limit) without launching
     — where the JAX package traces it with ``jax.eval_shape`` — and a
     config that the builder cannot parse or that the checks reject
     (``ConfigRejected``) degrades to the space default (quarantined in the
     store when it was an exact hit). On the ``gpu`` target that default is
     the CUDA kernel. A fault in the caller's operands is not the record's:
     it propagates and quarantines nothing.

The cached executable is the built variant itself, a plain callable (the JAX
package jits it; there is no ``torch.compile`` here), wrapped so that every
execution lands in the per-signature latency histogram.

``stats`` counts every path (store_exact / store_near / store_default,
exec_hit / exec_miss, build_failed, serve_rebuilt) under the JAX package's
keys. Not ported yet: the background tuner (``bg_enqueued`` stays 0), the
static feasibility pass (``analyze.feasibility``: ``infeasible`` stays 0),
fleet sync (``sync_*`` stay 0) and the guard's shadow evaluation.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from repro_torch.core.space import config_key
from repro_torch.dispatch.lookup import Resolution, resolve
from repro_torch.dispatch.registry import get as get_variant
from repro_torch.dispatch.signature import shape_signature, signature_key
from repro_torch.dispatch.store import TuningStore
from repro_torch.guard.faults import fault_point
from repro_torch.kernels.util import ConfigRejected
from repro_torch.obs.metrics import get_registry, summarize_histograms
from repro_torch.obs.trace import get_tracer

__all__ = ["DispatchService", "dispatch", "call", "get_service", "configure"]

# what a builder raises for a config it cannot parse (an unknown ``impl``, a
# tile that is not an integer); of the variant's pre-launch checks only
# ConfigRejected condemns the config: the operand errors they raise (shape,
# dtype, device, contiguity) are the caller's and propagate, as does a build
# or CUDA error of the port itself (RuntimeError)
_BAD_BUILD = (ValueError, TypeError, KeyError)


class DispatchService:
    def __init__(
        self,
        store: TuningStore | None = None,
        *,
        backend: str = "gpu",
        target: str = "gpu",
        resolve_ttl_sec: float = 30.0,
        fast_sweep_size: int = 256,
        metrics=None,
    ):
        self.store = store
        # repro_torch.obs registry: per-signature execute-latency histograms
        # and request counters (shard-local, lock-free recording)
        self.metrics = metrics if metrics is not None else get_registry()
        self.backend = backend
        self.target = target
        self.resolve_ttl_sec = resolve_ttl_sec
        self.fast_sweep_size = fast_sweep_size
        # signature -> (exec key, monotonic expiry): lets repeat dispatches
        # skip store refresh + nearest-neighbor scan on the hot path
        self._fast: dict[tuple, tuple[tuple, float]] = {}
        self.stats = {
            "store_exact": 0, "store_near": 0, "store_default": 0,
            "exec_hit": 0, "exec_miss": 0, "bg_enqueued": 0, "build_failed": 0,
            "infeasible": 0,
            "serve_rebuilt": 0, "sync_applied": 0, "sync_published": 0,
        }
        self._kv_cache = None  # serve.PagedKVCache, via attach_kv_cache()
        self._exec: dict[tuple, Callable] = {}
        # jit_cached sources + stable per-name proxies: invalidate() drops the
        # cached entry, and the proxy (which callers hold) rebuilds it from
        # the source — the serve-step hot swap
        self._fn_src: dict[tuple, Callable] = {}
        self._fn_proxy: dict[tuple, Callable] = {}
        self._lock = threading.RLock()

    # -- config resolution -------------------------------------------------------

    def _resolve_nostats(self, kernel: str, signature):
        """Store resolution without touching stats or the lock; returns
        ``(config, resolution, stat_name)``."""
        res = None
        if self.store is not None:
            self.store.refresh()
            res = resolve(self.store, kernel, signature, self.backend)
        if res is None:
            return get_variant(kernel).default_config(self.target), None, "store_default"
        return dict(res.config), res, "store_exact" if res.exact else "store_near"

    def resolve_config(self, kernel: str, signature) -> tuple[dict, Resolution | None]:
        """Store-resolved config for a signature, falling back to the
        registered space default when the store is empty/absent."""
        config, res, stat = self._resolve_nostats(kernel, signature)
        with self._lock:
            self.stats[stat] += 1
        return config, res

    # -- the runtime API ---------------------------------------------------------

    def dispatch(self, kernel: str, *args, **static_kw) -> Callable:
        """Return the variant of ``kernel`` tuned for these args' shapes.
        The returned callable takes the same positional args."""
        spec = get_variant(kernel)
        sig = shape_signature(list(args) + [v for _, v in sorted(static_kw.items())])
        static_id = tuple(sorted(static_kw.items()))
        sig_key = signature_key(sig)
        fast_key = (kernel, sig_key, static_id)
        now = time.monotonic()
        # hot path: one lock acquisition for the fast-map read, the
        # executable lookup and the hit-stat bump
        with self._lock:
            entry = self._fast.get(fast_key)
            if entry is not None:
                exec_key, expires = entry
                fn = self._exec.get(exec_key)
                if fn is not None and now < expires:
                    self.stats["exec_hit"] += 1
                    self.metrics.add("dispatch_requests_total",
                                     kernel=kernel, path="fast_hit")
                    return fn
                del self._fast[fast_key]  # expired or orphaned: don't leak
        # miss path: resolve outside the lock (store refresh does file I/O)
        tracer = get_tracer()
        t0 = time.perf_counter()
        with tracer.span("dispatch.lookup", kernel=kernel, signature=sig_key):
            config, res, resolve_stat = self._resolve_nostats(kernel, sig)
        self.metrics.observe("dispatch_lookup_seconds",
                             time.perf_counter() - t0, kernel=kernel)
        self.metrics.add("dispatch_requests_total", kernel=kernel,
                         path=resolve_stat)
        key = fast_key + (config_key(config),)
        with self._lock:
            self.stats[resolve_stat] += 1
            fn = self._exec.get(key)
            self.stats["exec_hit" if fn is not None else "exec_miss"] += 1
        built = None
        if fn is None and res is not None:
            # the build guard: build the store's config and run its
            # pre-launch checks on these args, launching nothing, so that a
            # poisoned record degrades to the default instead of raising at
            # the caller
            with tracer.span("dispatch.build", kernel=kernel,
                             signature=sig_key):
                built = _guarded_build(spec, config, static_kw, args)
            if built is None:
                # only an exact hit proves the record is bad for its own
                # signature; a nearest neighbor may merely not transfer to
                # this shape
                if self.store is not None and res.exact:
                    with tracer.span("dispatch.quarantine", kernel=kernel,
                                     signature=sig_key):
                        self.store.quarantine(res.record, reason="build_failed")
                config = spec.default_config(self.target)
                key = fast_key + (config_key(config),)
                with self._lock:
                    self.stats["build_failed"] += 1
                    fn = self._exec.get(key)  # default may already be built
                self.metrics.add("dispatch_requests_total", kernel=kernel,
                                 path="build_failed")
        if fn is None:
            if built is None:
                with tracer.span("dispatch.build", kernel=kernel,
                                 signature=sig_key):
                    built = spec.builder(config, **static_kw)
            fn = self._instrument_execute(built, kernel, sig_key)
        # publish: executable insert, fast-map store, and the TTL sweep share
        # the final critical section
        with self._lock:
            fn = self._exec.setdefault(key, fn)
            self._fast[fast_key] = (key, time.monotonic() + self.resolve_ttl_sec)
            if len(self._fast) > self.fast_sweep_size:
                self._sweep_fast_locked(time.monotonic())
        return fn

    def call(self, kernel: str, *args, **static_kw):
        """Resolve, build, and run in one step."""
        return self.dispatch(kernel, *args, **static_kw)(*args)

    def _instrument_execute(self, fn: Callable, kernel: str, sig_key: str) -> Callable:
        """Wrap a variant so every call records into the per-signature
        execute-latency histogram (and a trace span when tracing is on).
        On the card a launch returns before the kernel ends, so this is
        enqueue time as the caller observes it; the wrapper does not
        synchronise, which would serialise the pipeline it measures."""
        metrics, backend = self.metrics, self.backend

        def timed(*a, **kw):
            tracer = get_tracer()
            t0 = time.perf_counter()
            try:
                fault_point("dispatch.latency", kernel=kernel, signature=sig_key)
                if tracer.enabled:
                    with tracer.span("dispatch.execute", kernel=kernel,
                                     signature=sig_key):
                        return fn(*a, **kw)
                return fn(*a, **kw)
            finally:
                metrics.observe("dispatch_execute_seconds",
                                time.perf_counter() - t0, kernel=kernel,
                                signature=sig_key, backend=backend)

        timed.__wrapped__ = fn
        return timed

    def attach_kv_cache(self, cache) -> None:
        """Bind a :class:`repro_torch.serve.PagedKVCache`: its paged
        accounting shows up in :meth:`telemetry` under ``kv_cache``."""
        self._kv_cache = cache

    def telemetry(self) -> dict:
        """The dispatch counters, the attached paged KV cache's page/token
        accounting (under ``kv_cache``) and, under ``execute_latency``,
        per-signature p50/p99 execute latency from the obs registry."""
        with self._lock:
            out = dict(self.stats)
        if self._kv_cache is not None:
            out["kv_cache"] = self._kv_cache.stats()
        out["execute_latency"] = [
            {
                "kernel": row["labels"].get("kernel"),
                "signature": row["labels"].get("signature"),
                "backend": row["labels"].get("backend"),
                "count": row["count"],
                "p50_sec": row["p50"],
                "p99_sec": row["p99"],
                "mean_sec": row["sum"] / row["count"] if row["count"] else None,
            }
            for row in summarize_histograms(
                self.metrics.snapshot(), name="dispatch_execute_seconds")
        ]
        return out

    # -- cache management --------------------------------------------------------

    def _sweep_fast_locked(self, now: float) -> int:
        """Drop expired ``_fast`` entries (caller holds the lock)."""
        doomed = [k for k, (_, expires) in self._fast.items() if now >= expires]
        for k in doomed:
            del self._fast[k]
        return len(doomed)

    def invalidate(self, kernel: str | None = None, signature=None) -> int:
        """Drop executable-cache entries (all, per kernel, or per kernel+sig)
        so the next dispatch re-resolves. Returns the number of kernel
        entries dropped. ``jit_cached`` entries are dropped alongside (any of
        them could hold the affected variant) and rebuilt from source on the
        next call through the stable proxy callers hold."""
        sig_key = signature_key(signature) if signature is not None else None

        def matches(k):
            return k[0] != "__fn__" and \
                   (kernel is None or k[0] == kernel) and \
                   (sig_key is None or k[1] == sig_key)

        with self._lock:
            doomed = [k for k in self._exec if matches(k)]
            for k in doomed:
                del self._exec[k]
            for k in [k for k in self._fast if matches(k)]:
                del self._fast[k]
            if doomed or kernel is None:
                for k in list(self._fn_src):
                    self._exec.pop(k, None)
            return len(doomed)

    # -- generic executable cache (serving integration) --------------------------

    def jit_cached(self, name: str, fn: Callable) -> Callable:
        """Cache an arbitrary callable under a stable name, sharing the
        service's executable cache and hit/miss counters (the serving step:
        repeated ``make_serve_step`` calls for one model share one entry).
        The name is the JAX package's; here nothing is compiled.

        Returns a stable proxy: when :meth:`invalidate` drops the entry, the
        next call through any held proxy rebuilds it from the source (and
        counts ``serve_rebuilt``)."""
        key = ("__fn__", name, (), ())
        with self._lock:
            self._fn_src.setdefault(key, fn)
            if key in self._exec:
                self.stats["exec_hit"] += 1
            else:
                self.stats["exec_miss"] += 1
                self._exec[key] = fn
            proxy = self._fn_proxy.get(key)
            if proxy is None:
                proxy = self._fn_proxy[key] = self._make_fn_proxy(key)
        return proxy

    def _make_fn_proxy(self, key: tuple) -> Callable:
        def proxy(*args, **kw):
            with self._lock:
                fn = self._exec.get(key)
                if fn is None:  # invalidated: rebuild from source
                    self.stats["serve_rebuilt"] += 1
                    fn = self._exec.setdefault(key, self._fn_src[key])
            return fn(*args, **kw)

        return proxy


def _guarded_build(spec, config: dict, static_kw: dict, args: tuple):
    """Build a store-resolved config and run its pre-launch checks on the
    call's args without launching; ``None`` when the config is bad."""
    try:
        built = spec.builder(config, **static_kw)
    except _BAD_BUILD:
        return None
    check = getattr(built, "check", None)
    if args and check is not None:
        try:
            check(*args)
        except ConfigRejected:
            return None
    return built


# -- module-level default service (the one-liner API) ---------------------------

_default: DispatchService | None = None
_default_lock = threading.Lock()


def get_service() -> DispatchService:
    global _default
    with _default_lock:
        if _default is None:
            _default = DispatchService()
        return _default


def configure(store: TuningStore | str | None = None, **kw) -> DispatchService:
    """(Re)build the process-wide default service, e.g.
    ``configure("results/store")``."""
    global _default
    if isinstance(store, str):
        store = TuningStore(store)
    with _default_lock:
        _default = DispatchService(store, **kw)
        return _default


def dispatch(kernel: str, *args, **static_kw) -> Callable:
    return get_service().dispatch(kernel, *args, **static_kw)


def call(kernel: str, *args, **static_kw):
    return get_service().call(kernel, *args, **static_kw)
