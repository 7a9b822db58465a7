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

     Before the build guard, the static feasibility pass
     (:mod:`repro_torch.analyze.feasibility`) judges a store-resolved config
     against the signature's problem dims (on the ``gpu`` target also the
     kernel's shared memory against the device's): an infeasible exact hit
     is quarantined with the pass's reason codes, and the call serves the
     default (``infeasible`` counts it);
  4. when the resolution is a miss, a too-distant neighbor, or a stale
     record — and a :class:`~repro_torch.dispatch.background.BackgroundTuner`
     is attached — enqueue a BO campaign for this exact signature. Its result
     is published to the store and hot-swapped in by invalidating the
     affected executable-cache entries, so later calls pick it up.

**Injected latency** (the ``dispatch.latency`` fault point of
:mod:`repro_torch.guard.faults`, "the served executable sleeps
``delay_sec``"): off the card the host sleeps before the call, as in the
JAX package. On the card the served executable runs on the device, and the
drift watch reads the device time of the shadow-sampled calls
(:mod:`repro_torch.guard.watch`), where a host sleep before the call's first
launch never shows; so there the call's stream spins for ``delay_sec``
after its launches, inside the call's device time.

The cached executable is the built variant itself, a plain callable (the JAX
package jits it; there is no ``torch.compile`` here), wrapped so that every
execution lands in the per-signature latency histogram
``dispatch_execute_seconds``. On the card a launch returns before the
kernel ends, so that histogram holds enqueue time, not device time: the
wrapper does not synchronise.

**Arguments of a background campaign.** The JAX package hands the call's
own arrays to the campaign; JAX arrays are immutable, the port's serving
tensors are not (``decode_step`` writes the KV cache in place). So a
campaign times on copies of the call's tensors (of a view's underlying
tensor, such as :class:`~repro_torch.kernels.decode_attention.CacheRows`'s
cache), made on the calling thread's stream when the campaign is enqueued,
and its stream waits on an event recorded after them: it never holds the
serving buffers. :meth:`DispatchService.request_retune` builds its
arguments as zeros from shape/dtype/device records, as the JAX package
does with ``ShapeDtypeStruct`` (so a retuned decode_attention times a
cache at position 0).

**The guard** (:meth:`attach_guard`, :class:`repro_torch.guard.GuardAgent`):
an epsilon fraction of executions is shadow-sampled. A sampled call is
timed on the device — a pair of ``torch.cuda.Event`` records on the current
stream around it, and only its end event is waited on (no device-wide
synchronise on the serving thread); on the CPU a ``perf_counter`` interval
— recorded in ``dispatch_shadow_seconds`` (labels kernel, signature,
backend) and told into the store. Store objectives are CUDA-event seconds
too, so on the ``gpu`` backend the drift watch reads that histogram.

``stats`` counts every path (store_exact / store_near / store_default,
exec_hit / exec_miss, bg_enqueued, build_failed, infeasible, serve_rebuilt)
under the JAX package's keys, and fleet replication (``sync_applied``,
``sync_published``) once a :class:`repro_torch.fleet.SyncAgent` is attached:
replicated records invalidate this service's executables, so the next
dispatch builds the kernel with the fleet's config.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Any, Callable

import torch

from repro_torch.analyze.feasibility import check_config
from repro_torch.core.plopper import LaunchClock
from repro_torch.core.space import config_key
from repro_torch.dispatch.lookup import Resolution, resolve
from repro_torch.dispatch.registry import get as get_variant
from repro_torch.dispatch.signature import shape_signature, signature_key
from repro_torch.dispatch.store import TuningStore
from repro_torch.engine.executors import evaluator_for_spec
from repro_torch.guard.faults import fault_hit
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
        distance_threshold: float = 1.0,
        staleness_sec: float | None = None,
        tuner: Any | None = None,
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
        self.distance_threshold = distance_threshold
        self.staleness_sec = staleness_sec
        self.tuner = tuner
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
        self._sync = None  # a fleet sync agent, via attach_sync()
        self._kv_cache = None  # serve.PagedKVCache, via attach_kv_cache()
        self._guard = None  # repro_torch.guard.GuardAgent, via attach_guard()
        # retune material per (kernel, sig_key): (signature, static items,
        # argument shape/dtype/device records) captured on the miss path so
        # the drift watcher can re-campaign a signature without live args
        self._retune: dict[tuple, tuple] = {}
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

    def _needs_tuning(self, res: Resolution | None) -> bool:
        if res is None:
            return True
        if not res.exact and res.distance > self.distance_threshold:
            return True
        if self.staleness_sec is not None and res.record.age_sec() > self.staleness_sec:
            return True
        return False

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
            # statically-infeasible store records never cost a build: the
            # feasibility pass proves from the config and the signature's
            # problem dims alone that the variant would be refused. Exact
            # hits are quarantined with the pass's reason codes; near
            # neighbors just degrade (the build guard's asymmetry below).
            # No dtype: a record serves f32 and bf16 calls alike, so the
            # pass refuses only what fits neither
            verdict = check_config(kernel, config, signature=sig, target=self.target)
            if not verdict.ok:
                if self.store is not None and res.exact:
                    with tracer.span("dispatch.quarantine", kernel=kernel,
                                     signature=sig_key, reason=verdict.reason()):
                        self.store.quarantine(res.record, reason=verdict.reason())
                res = None
                config = spec.default_config(self.target)
                key = fast_key + (config_key(config),)
                with self._lock:
                    self.stats["infeasible"] += 1
                    fn = self._exec.get(key)  # default may already be built
                self.metrics.add("dispatch_requests_total", kernel=kernel,
                                 path="infeasible")
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
                res = None
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
            fn = self._instrument_execute(built, kernel, sig_key, sig=sig,
                                          config=config, static_kw=static_kw)
        # shape/dtype/device records, not live tensors: enough to synthesize
        # arguments for a drift-triggered re-campaign, without pinning
        # serving buffers in this map
        retune_material = None if self._guard is None else (
            sig, static_id, tuple(_map_tensors(a, _TensorSpec.of) for a in args))
        # publish: executable insert, fast-map store, and the TTL sweep share
        # the final critical section
        with self._lock:
            fn = self._exec.setdefault(key, fn)
            self._fast[fast_key] = (key, time.monotonic() + self.resolve_ttl_sec)
            if retune_material is not None:
                self._retune[(kernel, sig_key)] = retune_material
            if len(self._fast) > self.fast_sweep_size:
                self._sweep_fast_locked(time.monotonic())
        if self.tuner is not None and self.store is not None and self._needs_tuning(res):
            self._enqueue_tuning(spec, kernel, sig, args, static_kw)
        return fn

    def call(self, kernel: str, *args, **static_kw):
        """Resolve, build, and run in one step."""
        return self.dispatch(kernel, *args, **static_kw)(*args)

    def _instrument_execute(self, fn: Callable, kernel: str, sig_key: str, *, sig=None,
                            config=None, static_kw=None) -> Callable:
        """Wrap a variant so every call records into the per-signature
        execute-latency histogram (and a trace span when tracing is on).
        On the card a launch returns before the kernel ends, so this is
        enqueue time as the caller observes it; the wrapper does not
        synchronise, which would serialise the pipeline it measures. The
        exception is a shadow-sampled call (epsilon fraction, attached guard
        only): it is timed on the device from its first device operation
        (:class:`~repro_torch.core.plopper.LaunchClock`), recorded in
        ``dispatch_shadow_seconds`` and told into the tuning store."""
        metrics, backend = self.metrics, self.backend
        # this executable's executions since its last shadow sample: a call
        # that is not sampled pays an increment and a compare, not a call
        # into the guard (the serving benchmark holds a guarded decode call
        # to within 2% of an unguarded one, a microsecond or so on the card)
        since = 0

        def timed(*a, **kw):
            nonlocal since
            tracer = get_tracer()
            guard = self._guard
            mode = None
            if guard is not None:
                since += 1
                if since >= guard.shadow_period > 0:
                    since = 0
                    mode = guard.shadow_sample(kernel, sig_key)
            t0 = time.perf_counter()
            clock = LaunchClock(a) if mode is not None else None
            try:
                stall = _latency_fault(kernel, sig_key, a)
                if tracer.enabled:
                    with tracer.span("dispatch.execute", kernel=kernel,
                                     signature=sig_key):
                        out = fn(*a, **kw)
                else:
                    out = fn(*a, **kw)
                if stall:
                    _stall_device(stall)
                if clock is not None:
                    dt = clock.stop()
                    metrics.observe("dispatch_shadow_seconds", dt, kernel=kernel,
                                    signature=sig_key, backend=backend)
                    guard.on_shadow(kernel, sig, config, static_kw, a, dt, mode)
                return out
            finally:
                metrics.observe("dispatch_execute_seconds",
                                time.perf_counter() - t0, kernel=kernel,
                                signature=sig_key, backend=backend)

        timed.__wrapped__ = fn
        return timed

    def _enqueue_tuning(self, spec, kernel, sig, args, static_kw, *, copy: bool = True) -> None:
        """Submit a background campaign for ``sig``. The campaign times on
        tensors of its own (``copy``: copies of ``args`` made here, on this
        thread's stream; else ``args`` are already fresh), never on the
        caller's."""
        inflight = getattr(self.tuner, "inflight", None)
        if inflight is not None and inflight(kernel, sig, self.backend):
            return  # deduplicated: no copies for a campaign already queued
        own, ready = _hand_off(args, copy)

        def factory(cfg):
            if ready is not None:
                ready.wait()  # the campaign's stream waits for the copies
            return spec.builder(cfg, **static_kw), own

        # make_evaluator override else CUDA-event (CPU: wall-clock) timing
        evaluator = evaluator_for_spec(spec, factory)
        first = next((t for t in own if isinstance(t, torch.Tensor)), None)
        fut = self.tuner.submit(
            kernel, sig, self.backend, space=spec.space(self.target),
            evaluator=evaluator, on_done=self._on_tuned,
            dtype=None if first is None else first.dtype)
        if fut is not None:
            with self._lock:
                self.stats["bg_enqueued"] += 1

    def _on_tuned(self, kernel: str, signature, backend: str) -> None:
        self.invalidate(kernel, signature)
        if self._sync is not None:
            # a background campaign just published: push it fleet-wide now
            self._sync.nudge()

    # -- fleet replication (repro_torch.fleet), guard --------------------------------

    def attach_sync(self, agent) -> None:
        """Bind a :class:`repro_torch.fleet.SyncAgent`: replication counters
        land in ``stats`` (``sync_applied`` / ``sync_published``), replication
        lag shows up in :meth:`telemetry`, and local background-tuning
        publishes nudge the agent to push promptly."""
        self._sync = agent
        if self.tuner is not None and getattr(self.tuner, "on_publish", None) is None:
            self.tuner.on_publish = lambda rec: agent.nudge()

    def attach_guard(self, agent) -> None:
        """Bind a :class:`repro_torch.guard.GuardAgent`: the instrumented
        execute wrapper starts shadow-sampling an epsilon fraction of calls,
        retune material is captured per signature so the drift watcher can
        re-campaign without live args, and :meth:`telemetry` grows a
        ``guard`` section. Attach before the first dispatch — wrappers
        created earlier keep serving, but their signatures only gain retune
        material after an :meth:`invalidate`."""
        self._guard = agent

    def request_retune(self, kernel: str, sig_key: str) -> bool:
        """Force a background re-campaign for a signature seen earlier by
        :meth:`dispatch` (the drift watcher's recovery path), on zeros of
        the recorded shapes, dtypes and devices. Returns False when no
        tuner/store is attached or the signature was never served with a
        guard attached."""
        if self.tuner is None or self.store is None:
            return False
        with self._lock:
            material = self._retune.get((kernel, sig_key))
        if material is None:
            return False
        sig, static_id, specs = material
        args = tuple(_map_specs(a) for a in specs)
        self._enqueue_tuning(get_variant(kernel), kernel, sig, args, dict(static_id),
                             copy=False)
        return True

    def attach_kv_cache(self, cache) -> None:
        """Bind a :class:`repro_torch.serve.PagedKVCache`: its paged
        accounting shows up in :meth:`telemetry` under ``kv_cache``."""
        self._kv_cache = cache

    def telemetry(self) -> dict:
        """The dispatch counters, the background tuner's optimizer-overhead
        aggregates (ask/tell/wait seconds) and its cascade counters
        (``cascade_campaigns``, ``screened``, ``promoted``: configs discarded
        on the cost model vs graduated to the card), a sync agent's
        replication lag when one is attached, the attached paged KV cache's page/token
        accounting (under ``kv_cache``), the guard's summary (under
        ``guard``) and, under ``execute_latency``, per-signature p50/p99
        execute latency from the obs registry."""
        with self._lock:
            out = dict(self.stats)
        if self.tuner is not None and getattr(self.tuner, "stats", None):
            out.update(self.tuner.stats)
        if self._sync is not None:
            out.update(self._sync.lag())
        if self._kv_cache is not None:
            out["kv_cache"] = self._kv_cache.stats()
        if self._guard is not None:
            out["guard"] = self._guard.summary()
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


@dataclasses.dataclass(frozen=True)
class _TensorSpec:
    """Shape, dtype and device of a tensor: retune material."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device

    @classmethod
    def of(cls, t: torch.Tensor) -> "_TensorSpec":
        return cls(tuple(t.shape), t.dtype, t.device)


def _map_tensors(a, fn):
    """``fn`` over a tensor argument, or over the tensor fields of a
    dataclass argument (a view such as ``CacheRows``); other args as they
    are."""
    if isinstance(a, torch.Tensor):
        return fn(a)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        changes = {f.name: fn(getattr(a, f.name)) for f in dataclasses.fields(a)
                   if isinstance(getattr(a, f.name), torch.Tensor)}
        return dataclasses.replace(a, **changes) if changes else a
    return a


def _map_specs(a):
    """Zeros for the :class:`_TensorSpec` records of :func:`_map_tensors`."""
    def zeros(s: _TensorSpec):
        return torch.zeros(s.shape, dtype=s.dtype, device=s.device)

    if isinstance(a, _TensorSpec):
        return zeros(a)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        changes = {f.name: zeros(getattr(a, f.name)) for f in dataclasses.fields(a)
                   if isinstance(getattr(a, f.name), _TensorSpec)}
        return dataclasses.replace(a, **changes) if changes else a
    return a


def _hand_off(args: tuple, copy: bool):
    """A campaign's own arguments: copies of ``args``' tensors (``copy``) or
    ``args`` themselves, and, where any lies on the card, an event recorded
    on the current stream after them, which the campaign's stream waits on
    before its first use (``None`` on the CPU)."""
    seen = []

    def take(t: torch.Tensor) -> torch.Tensor:
        seen.append(t)
        return t.detach().clone() if copy else t

    own = tuple(_map_tensors(a, take) for a in args)
    ready = None
    if any(t.is_cuda for t in seen):
        ready = torch.cuda.Event()
        ready.record()
    return own, ready


def _latency_fault(kernel: str, sig_key: str, args: tuple) -> float:
    """The ``dispatch.latency`` fault point of a served call (see
    :meth:`~repro_torch.guard.faults.Fault.apply`): off the card the host
    sleeps its delay here. Returns the seconds the caller stalls the device
    for after the call's launches (0.0 when nothing fired, or off the
    card)."""
    fault = fault_hit("dispatch.latency", kernel=kernel, signature=sig_key)
    if fault is None:
        return 0.0
    seen = []
    for a in args:
        _map_tensors(a, lambda t: seen.append(t) or t)
    on_card = any(t.is_cuda for t in seen)
    fault.apply(delay=not on_card)
    return fault.delay_sec if on_card else 0.0


def _stall_device(seconds: float) -> None:
    """Spin the current stream for about ``seconds`` (at the rate
    :func:`_spin_cycles_per_sec` measured), then move an armed end mark of
    a timed call past the spin (:func:`repro_torch.kernels.build.mark_end`)."""
    from repro_torch.kernels import build

    torch.cuda._sleep(int(seconds * _spin_cycles_per_sec()))
    build.mark_end()


@functools.lru_cache(maxsize=None)
def _spin_cycles_per_sec() -> float:
    """Cycles a second of ``torch.cuda._sleep`` on this card, from one spin
    of 2^24 cycles between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(1 << 24)
    end.record()
    end.synchronize()
    return (1 << 24) / (start.elapsed_time(end) / 1e3)


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
    ``configure("results/store", tuner=BackgroundTuner(...))``."""
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
