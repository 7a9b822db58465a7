"""Continuous-batching serve benchmark of the port — the counterpart of
``benchmarks/serve_bench.py``, the ground truth for every "serving got
faster" claim.

Replays a mixed prompt/output-length workload with Poisson arrivals through
the port's serving stack (``serve.prefill`` + ``decode_step`` on a
:class:`repro_torch.serve.PagedKVCache`), reshaping the decode batch as
requests join and leave, and reports p50/p99 inter-token latency, TTFT, and
token throughput per serving mode:

  * ``einsum``  — the pre-paging baseline: one dense max-batch/max-len
    cache, every step attends over the full allocation, no dispatch service
    (so no hand-written kernel runs: torch operations only);
  * ``default`` — paged cache + dispatch-service *default* decode config
    (empty tuning store): on the card the flash_attention, decode_attention
    and tiled-matmul CUDA kernels;
  * ``tuned``   — paged cache + a store seeded by a short timing campaign
    over the decode space at the serving signature: the kernel's
    ``impl``/``bk``/``hg`` axes and the cache's ``page`` layout axis are
    tuned together (page decides the seq-bucket ladder every view is cut
    on). On the card the ``gpu`` decode space has no ``page`` axis (the
    kernel never reads it, and the space is also what background campaigns
    and the guard's challengers sample), so the bench draws ``page`` itself
    from ``PAGE_SIZES_HOST`` beside each ``gpu``-space config; on the CPU
    the ``host`` space holds it, as the JAX package's.

Each request's prompt is drawn with ``np.random.default_rng(1000 + id)``
(the JAX package draws it with ``jax.random``, which torch cannot
reproduce), so a test can hand the same ids to both packages. Decoded tokens
stay on the device within a decode round; the round ends in one host read.

Writes ``BENCH_torch_serve.json`` (stamped by
``benchmarks.torch_common.bench_meta``: host, commit, torch and CUDA, the
card's name and power limit) and ``BENCH_torch_serve.obs.jsonl`` — a
``repro_torch.obs`` metrics snapshot from the tuned run's service registry,
with ``dispatch_execute_seconds`` histograms for both the prefill
(flash_attention) and decode (decode_attention) kernels, so
``python -m repro_torch.launch.obs summarize --metrics`` shows the two hot
paths side by side.

The run fails (exit 1) when any mode's p99 token latency is missing,
non-finite, or degenerate, or p50 exceeds p99; with ``--inject-drift`` also
when the guard's shadow sampling costs more than 2% (25% under ``--quick``)
of a call's min-of-N time, or the drift loop does not quarantine and fall
back.

Usage::

    PYTHONPATH=src:. python -m benchmarks.torch_serve_bench --inject-drift   # the card
    PYTHONPATH=src:. python -m benchmarks.torch_serve_bench --quick --device cpu --reduced
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch

from benchmarks.torch_common import bench_meta, time_callable, write_bench_json
from repro_torch.analyze.feasibility import check_config
from repro_torch.configs import get_config, get_reduced
from repro_torch.dispatch import TuningRecord, TuningStore
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul import tiled_matmul
from repro_torch.kernels.model_kernels import (
    decode_attention_builder,
    decode_attention_signature,
    init_decode_attention,
    init_flash_attention,
)
from repro_torch.kernels.spaces import PAGE_SIZES_HOST, kernel_space
from repro_torch.kernels.util import resolve_device
from repro_torch.launch.serve import service_for
from repro_torch.models import init_params
from repro_torch.obs.export import write_snapshot
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import PagedKVCache, make_serve_step, prefill

# the wrappers whose launches each mode counts
WRAPPERS = (flash_attention, decode_attention, tiled_matmul)


# ---------------------------------------------------------------------------
# workload
# ---------------------------------------------------------------------------


def make_workload(n_requests: int, rate: float, prompt_lens, out_mean: int,
                  out_cap: int, seed: int):
    """Deterministic request list: Poisson arrivals (exponential gaps at
    ``rate`` req/s), prompt lengths cycled from a fixed set, output lengths
    4 + geometric(mean ``out_mean``) capped at ``out_cap``."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    reqs = []
    for i in range(n_requests):
        out = 4 + int(rng.geometric(1.0 / max(out_mean - 4, 1)))
        reqs.append({
            "id": i,
            "arrival": float(arrivals[i]),
            "prompt_len": int(prompt_lens[i % len(prompt_lens)]),
            "out_len": int(min(out, out_cap)),
        })
    return reqs


def _pad_batch(active, free, max_batch):
    """Round the batch up the {1,2,4,8,...} ladder with free slots so the
    serve step sees a bounded set of batch shapes (padding rows decode
    garbage at position 0 that admission later overwrites)."""
    b = 1
    while b < len(active):
        b *= 2
    b = min(b, max_batch)
    pad = [s for s in free if s not in active][: b - len(active)]
    return active + pad


def request_prompt(req: dict, vocab: int) -> np.ndarray:
    """(1, prompt_len) int64 token ids of ``req``, from its own seed."""
    return np.random.default_rng(1000 + req["id"]).integers(0, vocab, (1, req["prompt_len"]))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}


# ---------------------------------------------------------------------------
# one serving run
# ---------------------------------------------------------------------------


def run_mode(mode: str, cfg, params, workload, *, max_batch: int, max_len: int,
             page_size: int, service, round_cap: int = 8) -> dict:
    """Serve ``workload`` to completion on ``params``' device; returns
    latency/throughput metrics, the kernels' launches over the run
    (``launches``) and each request's generated ids (``ids``: request id ->
    its ``out_len`` tokens, the first from the prefill).

    ``einsum`` mode decodes the full dense allocation every step (no views);
    paged modes cut bucketed views per round and write back on membership or
    bucket changes."""
    dev = params["embed"].device
    paged = mode != "einsum"
    pc = PagedKVCache(cfg, max_batch, max_len,
                      page_size=page_size if paged else max_len, device=dev)
    serve = make_serve_step(cfg, service=service)
    pending = sorted(workload, key=lambda r: r["arrival"])
    state: dict[int, dict] = {}   # slot -> {req, tok, made}
    ids: dict[int, list[int]] = {}
    token_lat: list[float] = []
    ttft: list[float] = []
    tokens_out = 0
    peak = pc.stats()   # paged accounting at peak residency, not at drain
    launches0 = _launch_counts()

    t0 = time.perf_counter()
    skipped = 0.0   # idle fast-forward: virtual seconds skipped while empty

    def clock():
        return time.perf_counter() - t0 + skipped

    while pending or state:
        # admissions: arrivals due now, while slots are free
        free = pc.free_slots()
        while pending and free and pending[0]["arrival"] <= clock():
            req = pending.pop(0)
            slot = free.pop(0)
            prompt = torch.from_numpy(request_prompt(req, cfg.vocab_size)).to(dev)
            logits, cache = prefill(params, {"tokens": prompt}, cfg,
                                    max_len=pc.alloc, service=service)
            pc.admit(slot, cache, req["prompt_len"])
            first = int(torch.argmax(logits[0, -1]))   # a host read: the device is done
            state[slot] = {"req": req, "tok": first, "made": 1}
            ids[req["id"]] = [first]
            tokens_out += 1
            ttft.append(clock() - req["arrival"])
            if state[slot]["made"] >= req["out_len"]:
                pc.release(slot)
                del state[slot]
        if not state:
            if pending:   # idle: fast-forward to the next arrival
                skipped += max(0.0, pending[0]["arrival"] - clock()) + 1e-9
            continue

        # one decode round: fixed membership, fixed bucket
        active = sorted(state)
        cur_stats = pc.stats()
        if cur_stats["tokens_resident"] > peak["tokens_resident"]:
            peak = cur_stats
        steps = min(round_cap,
                    min(state[s]["req"]["out_len"] - state[s]["made"] for s in active))
        if paged:
            slots = _pad_batch(active, pc.free_slots(), max_batch)
            bucket = pc.seq_bucket(slots, extra=steps)
            view = pc.view(slots, bucket)
        else:
            slots = list(range(max_batch))
            bucket = pc.alloc
            view = pc.buf
        # padding rows decode token 0 at position 0, as the JAX package's do
        live = torch.tensor([[s in state] for s in slots], device=dev)
        cur = torch.tensor([[state[s]["tok"] if s in state else 0] for s in slots],
                           dtype=torch.long, device=dev)
        made = []
        for _ in range(steps):
            pos = torch.tensor([int(pc.pos[s]) + 1 if s in state else 0 for s in slots],
                               dtype=torch.int32, device=dev)
            ts = time.perf_counter()
            nxt, _, view = serve(params, view, cur, pos)
            _sync(dev)
            dt = time.perf_counter() - ts
            pc.advance(active)
            tokens_out += len(active)
            token_lat.extend([dt] * len(active))
            made.append(nxt)
            cur = torch.where(live, nxt, 0)
        toks = torch.cat(made, dim=1).tolist()   # the round's one host read
        for i, s in enumerate(slots):
            if s in state:
                ids[state[s]["req"]["id"]].extend(toks[i])
                state[s]["tok"] = toks[i][-1]
                state[s]["made"] += steps
        if paged:
            pc.writeback(slots, bucket, view)
        else:
            pc.buf = view
        for s in list(active):
            if state[s]["made"] >= state[s]["req"]["out_len"]:
                pc.release(s)
                del state[s]

    wall = time.perf_counter() - t0
    lat = np.asarray(token_lat)
    now = _launch_counts()
    out = {
        "mode": mode,
        "page_size": page_size if paged else None,
        "requests": len(workload),
        "tokens": tokens_out,
        "wall_sec": wall,
        "throughput_tok_s": tokens_out / wall if wall > 0 else None,
        "token_lat_p50_ms": float(np.percentile(lat, 50) * 1e3) if lat.size else None,
        "token_lat_p99_ms": float(np.percentile(lat, 99) * 1e3) if lat.size else None,
        "ttft_p50_ms": float(np.percentile(ttft, 50) * 1e3) if ttft else None,
        "launches": {k: now[k] - launches0[k] for k in now},
    }
    out["kv_cache"] = peak
    if service is not None:
        service.attach_kv_cache(pc)
        tel = service.telemetry()
        out["dispatch"] = {k: tel[k] for k in
                           ("store_exact", "store_near", "store_default",
                            "exec_hit", "exec_miss", "build_failed",
                            "infeasible")}
    out["ids"] = {i: ids[i] for i in sorted(ids)}
    return out


# ---------------------------------------------------------------------------
# the inline decode-space campaign (mode "tuned")
# ---------------------------------------------------------------------------


def _decode_operands(BH: int, G: int, S: int, hd: int, dev: torch.device):
    return tuple(torch.from_numpy(a).to(dev) for a in init_decode_attention(BH, G, S, hd))


def decode_candidates(target: str, n_candidates: int, seed: int) -> list[dict]:
    """The tuned mode's candidates: the decode space's default, then
    distinct samples of it (seeded). A ``gpu``-space config has no ``page``;
    each gets one beside it, drawn from ``PAGE_SIZES_HOST`` by a generator
    of its own from ``seed`` (the default beside the host space's default
    page)."""
    cs = kernel_space("decode_attention", target=target, seed=seed)
    default_page = int(kernel_space("decode_attention",
                                    target="host").default_configuration()["page"])
    pages = np.random.default_rng(seed)

    def with_page(c: dict, page: int | None = None) -> dict:
        if "page" in c:
            return c
        return dict(c, page=int(page if page is not None else pages.choice(PAGE_SIZES_HOST)))

    cands = [with_page(dict(cs.default_configuration()), default_page)]
    while len(cands) < n_candidates:
        c = with_page(dict(cs.sample_configuration()))
        if c not in cands:
            cands.append(c)
    return cands


def tune_decode(cfg, *, max_batch: int, resident: int, n_candidates: int,
                seed: int, device=None) -> tuple[dict, list]:
    """Short timing campaign over the decode space at the serving signature.
    Each candidate is timed at *its own* seq bucket —
    ``ceil(resident/page)*page`` — so the ``page`` layout axis's padded
    attention work is part of the measured objective. On the card the
    candidates are the ``gpu`` space's, each beside a ``page`` drawn from
    ``PAGE_SIZES_HOST`` (the space default beside the host default page),
    gated by the feasibility pass for the card and timed by CUDA events
    (``torch_common.time_callable``); on the CPU the ``host`` space's, which
    holds ``page``, as the JAX package's."""
    dev = torch.device(device or "cuda")
    target = "gpu" if dev.type == "cuda" else "host"
    K, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    BH = max_batch * K
    trace, best, best_t = [], None, float("inf")
    for c in decode_candidates(target, n_candidates, seed):
        page = int(c["page"])
        s_eff = -(-resident // page) * page   # the bucket this page serves
        if not check_config("decode_attention", c,
                            dims=(BH, G, s_eff, hd), target=target).ok:
            continue
        args = _decode_operands(BH, G, s_eff, hd, dev)
        t = time_callable(decode_attention_builder(c), args, batches=3, warmup=1)
        trace.append({"config": c, "seconds": t})
        if t < best_t:
            best, best_t = c, t
    return best, trace


def seed_store(store, cfg, best: dict, *, max_batch: int, max_resident: int,
               alloc: int, backend: str = "gpu") -> int:
    """Publish the tuned config for every signature the serving loop will
    derive: batch ladder x page-aligned seq buckets (plus the prefill
    replay's full-allocation bucket), keyed by the serving service's
    ``backend`` (``gpu`` on the card, ``cpu`` off it)."""
    K, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    page = int(best["page"])
    buckets = set(range(page, -(-max_resident // page) * page + 1, page))
    buckets.add(-(-alloc // page) * page)
    batches = {1}
    b = 1
    while b < max_batch:
        b = min(b * 2, max_batch)
        batches.add(b)
    n = 0
    for bsz in sorted(batches):
        for s in sorted(buckets):
            sig = decode_attention_signature(bsz * K, G, s, hd)
            if store.put(TuningRecord("decode_attention", sig, backend,
                                      dict(best), 1.0)):
                n += 1
    return n


# ---------------------------------------------------------------------------
# obs probe: real execute-latency samples for prefill + decode kernels
# ---------------------------------------------------------------------------


def probe_kernels(service, cfg, *, max_batch: int, bucket: int,
                  prompt_len: int, reps: int = 20, device=None) -> None:
    """Dispatch calls at the serving shapes outside the model, each waited
    for, so the obs snapshot's ``dispatch_execute_seconds`` histograms carry
    per-call samples of both hot paths beside the serving run's (enqueue
    time on the card)."""
    dev = torch.device(device or "cuda")
    K, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    BH = max_batch * K
    args = _decode_operands(BH, G, bucket, hd, dev)
    fn = service.dispatch("decode_attention", *args, ring=False, window=0)
    for _ in range(reps):
        fn(*args)
        _sync(dev)
    fargs = tuple(torch.from_numpy(a).to(dev)
                  for a in init_flash_attention(BH, prompt_len, prompt_len, hd))
    fn = service.dispatch("flash_attention", *fargs, causal=True)
    for _ in range(reps):
        fn(*fargs)
        _sync(dev)


# ---------------------------------------------------------------------------
# guard phase (--inject-drift): shadow overhead + the drift-heal loop
# ---------------------------------------------------------------------------


def interleaved_calls(fn_a, fn_b, args: tuple, pairs: int) -> tuple[list, list]:
    """Seconds of ``pairs`` calls of each of ``fn_a`` and ``fn_b`` on
    ``args``, each waited for, interleaved and each side first in turn, so
    that host noise hits both alike."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    t_a, t_b = [], []
    pair = ((fn_a, t_a), (fn_b, t_b))
    for i in range(pairs):
        for f, times in (pair if i % 2 == 0 else pair[::-1]):
            t0 = time.perf_counter()
            f(*args)
            _sync(dev)
            times.append(time.perf_counter() - t0)
    return t_a, t_b



def guard_drift_phase(cfg, best: dict, *, store_root: str, max_batch: int,
                      bucket: int, quick: bool, device=None, trials: int = 1) -> dict:
    """Measure the guard's serving cost and prove the drift loop on the
    decode hot path.

    Shadow overhead: dispatch calls at the serving shape, each waited for.
    With ``epsilon=0.1`` nine of ten calls pay one counter check, so the
    least call is a non-shadow call and must stay within 2% of an unguarded
    service's — the shadow cost lands in the tail by design. Guarded and
    unguarded calls are interleaved, each side first every other pair, and
    the gate uses min-of-N: on a shared host, scheduler noise dwarfs a
    ~1us deterministic cost at the median (p50s of both are still
    reported). N is the JAX package's 400 pairs (100 under ``--quick``), and
    20000 on the card (about 3 s), where 400 pairs are too short a window
    for a stable least call. Then ``dispatch.latency`` is
    injected and the watcher must quarantine the served record and degrade
    to the default config two windows later. The watch reads
    ``dispatch_execute_seconds`` off the card (every call: a window is the
    JAX package's 12 calls) and the shadow samples' device time on it (an
    epsilon share: a window of ``min_samples / epsilon`` calls); there the
    injected latency is a spin of the call's stream (the dispatch service's
    ``dispatch.latency`` fault point).

    With ``trials`` above 1 the gate's measurement is repeated that many
    times at the JAX package's N and at this run's, for the guarded
    executable and, as the measurement's noise floor, for a second
    unguarded one, each against the unguarded executable: the spread the
    gate's N is read against (``overhead_trials``; the gate itself reads
    the first measurement alone)."""
    from repro_torch.guard import (GuardAgent, ShadowPolicy, WatchPolicy,
                                   guard_counters, inject)
    from repro_torch.guard.watch import SHADOW_HISTOGRAM

    dev = torch.device(device or "cuda")
    K, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    BH = max_batch * K
    args = _decode_operands(BH, G, bucket, hd, dev)
    sig = decode_attention_signature(BH, G, bucket, hd)
    # on the card a call is tens of microseconds: 400 interleaved pairs span
    # about 50 ms, too short a window for a stable least call on a shared
    # host (``trials`` measures the spread)
    reps = 100 if quick else (20000 if dev.type == "cuda" else 400)
    epsilon = 0.1

    def serve(svc):
        fn = svc.dispatch("decode_attention", *args, ring=False, window=0)
        fn(*args)    # build and warm outside the timing
        _sync(dev)
        return fn

    def service(name: str):
        store = TuningStore(os.path.join(store_root, name))
        svc = service_for(dev, store, metrics=MetricsRegistry())
        store.put(TuningRecord("decode_attention", sig, svc.backend, dict(best), 1.0))
        return svc

    # -- unguarded reference ------------------------------------------------
    fn_plain = serve(service("guard_plain"))

    # -- guarded service: shadow epsilon + drift watch ----------------------
    svc = service("guard")
    watch = WatchPolicy(drift_factor=3.0, hysteresis=2, cooldown_sec=0.0, min_samples=8)
    shadow = ShadowPolicy(epsilon=epsilon, challenger_fraction=0.0)
    guard = GuardAgent(svc, watch=watch, shadow=shadow)
    svc.attach_guard(guard)
    fn = serve(svc)

    # the guarded calls' shadow tells sharpen the seed
    t_plain, t_shadow = interleaved_calls(fn_plain, fn, args, reps)
    p50_plain = float(np.percentile(t_plain, 50))
    p50_shadow = float(np.percentile(t_shadow, 50))
    overhead = min(t_shadow) / min(t_plain) - 1.0

    spread = []
    if trials > 1:
        sides = (("unguarded", serve(service("guard_plain2"))), ("guarded", fn))
        for pairs in sorted({400, reps}):
            for side, fn_b in sides:
                ov = 100.0 * np.array([
                    min(t_b) / min(t_a) - 1.0 for t_a, t_b in
                    (interleaved_calls(fn_plain, fn_b, args, pairs) for _ in range(trials))])
                spread.append({"pairs": pairs, "b": side, "trials": trials,
                               "mean_pct": float(ov.mean()), "sd_pct": float(ov.std()),
                               "max_pct": float(ov.max()),
                               "past_2pct": int((ov > 2.0).sum())})

    # -- injected latency regression: the watcher must heal it --------------
    per_window = 12
    if guard.histogram == SHADOW_HISTOGRAM:
        per_window = max(per_window, watch.min_samples * shadow.shadow_period())
    guard.check_once()                       # window base
    delay = max(0.05, 10.0 * p50_plain)      # unambiguous drift
    with inject("dispatch.latency", delay_sec=delay,
                where={"kernel": "decode_attention"}):
        for _ in range(per_window):
            fn(*args)
        first = guard.check_once()           # breach 1 of 2: hysteresis
        for _ in range(per_window):
            fn(*args)
        decisions = guard.check_once()       # breach 2: quarantine
    _sync(dev)
    drift_ok = (first == [] and len(decisions) == 1
                and decisions[0]["reason"].startswith("drift:"))
    # degraded serving: the quarantined record must not resolve again
    before = svc.stats["store_default"]
    serve(svc)
    fallback_ok = svc.stats["store_default"] == before + 1

    return {
        "epsilon": epsilon,
        "p50_plain_ms": p50_plain * 1e3,
        "p50_shadow_ms": p50_shadow * 1e3,
        "min_plain_ms": min(t_plain) * 1e3,
        "min_shadow_ms": min(t_shadow) * 1e3,
        "shadow_overhead_frac": overhead,
        "overhead_trials": spread,
        "injected_delay_sec": delay,
        "calls_per_window": per_window,
        "watched_histogram": guard.histogram,
        "drift_ok": drift_ok,
        "fallback_ok": fallback_ok,
        "decisions": decisions,
        "shadow": guard.shadow.snapshot_stats(),
        "quarantines": guard.stats["quarantines"],
        "fallbacks": guard.stats["fallbacks"],
        "counters": guard_counters(svc.metrics.snapshot()),
    }


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def _line(name: str, r: dict, extra: str = "") -> str:
    return (f"{name:7s}: p50={r['token_lat_p50_ms']:.3f}ms "
            f"p99={r['token_lat_p99_ms']:.3f}ms ttft_p50={r['ttft_p50_ms']:.1f}ms "
            f"tput={r['throughput_tok_s']:.1f} tok/s launches={r['launches']}{extra}")


def main(argv=None, record: dict | None = None) -> int:
    """The benchmark; returns its exit code. With ``record``, a dict, the
    full results of every mode (each request's generated ids among them,
    which the JSON leaves out) are put there under ``modes``, and the
    written payload under ``payload``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke sizes (seconds, not minutes)")
    ap.add_argument("--inject-drift", action="store_true",
                    help="also run the guard phase: shadow-eval overhead "
                         "and an injected-latency drift-heal scenario")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--rate", type=float, default=None,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--candidates", type=int, default=None,
                    help="decode-space candidates for the tuned mode")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="where the modes' tuning stores go (default: a temporary "
                         "directory, removed after the run)")
    ap.add_argument("--overhead-trials", type=int, default=1,
                    help="with --inject-drift, repeat the shadow-overhead "
                         "measurement this many times at two N, beside its "
                         "noise floor (reported; the gate reads the first)")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (default: its full width)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--out", default="BENCH_torch_serve.json")
    ap.add_argument("--obs-out", default="BENCH_torch_serve.obs.jsonl")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.store is None:
        with tempfile.TemporaryDirectory(prefix="torch_serve_bench_") as tmp:
            return _run(args, dev, tmp, record)
    return _run(args, dev, args.store, record)


def _run(args, dev: torch.device, store_root: str, record: dict | None) -> int:
    quick = args.quick
    n_req = args.requests or (8 if quick else 24)
    max_len = args.max_len or (256 if quick else 1024)
    rate = args.rate or (50.0 if quick else 12.0)
    n_cand = args.candidates or (6 if quick else 12)
    prompt_lens = (8, 16) if quick else (16, 32, 48)
    out_mean, out_cap = (8, 12) if quick else (24, 48)

    base = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(base, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    workload = make_workload(n_req, rate, prompt_lens, out_mean, out_cap,
                             args.seed)
    max_resident = max(r["prompt_len"] + r["out_len"] for r in workload)
    resident_typ = int(np.median(
        [r["prompt_len"] + r["out_len"] // 2 for r in workload]))

    print(f"# torch_serve_bench: {cfg.name} ({'reduced' if args.reduced else 'full width'}, "
          f"f32) on {dev}, {n_req} requests, max_batch={args.max_batch}, "
          f"max_len={max_len}, rate={rate}/s, max_resident={max_resident}", flush=True)

    results: dict[str, dict] = {}

    # -- einsum baseline: dense full-allocation cache, no dispatch -----------
    results["einsum"] = run_mode(
        "einsum", cfg, params, workload, max_batch=args.max_batch,
        max_len=max_len, page_size=max_len, service=None)
    print(_line("einsum", results["einsum"]), flush=True)

    # -- default: paged cache + empty store (space-default decode config) ----
    default_page = int(kernel_space("decode_attention",
                                    target="host").default_configuration()["page"])
    svc = service_for(dev, TuningStore(os.path.join(store_root, "default")),
                      metrics=MetricsRegistry())
    results["default"] = run_mode(
        "default", cfg, params, workload, max_batch=args.max_batch,
        max_len=max_len, page_size=default_page, service=svc)
    print(_line("default", results["default"], f" (page={default_page})"), flush=True)

    # -- tuned: inline campaign over impl/bk/hg/page, store-seeded -----------
    best, trace = tune_decode(cfg, max_batch=args.max_batch,
                              resident=resident_typ, n_candidates=n_cand,
                              seed=args.seed, device=dev)
    store = TuningStore(os.path.join(store_root, "tuned"))
    n_rec = seed_store(store, cfg, best, max_batch=args.max_batch,
                       max_resident=max_resident, alloc=max_len, backend=svc.backend)
    print(f"tuned config {best} ({n_rec} store records)", flush=True)
    svc_t = service_for(dev, store, metrics=MetricsRegistry())
    results["tuned"] = run_mode(
        "tuned", cfg, params, workload, max_batch=args.max_batch,
        max_len=max_len, page_size=int(best["page"]), service=svc_t)
    results["tuned"]["decode_config"] = best
    results["tuned"]["campaign"] = trace
    results["tuned"]["page_axis"] = ("drawn by the bench" if dev.type == "cuda"
                                     else "the host space's")
    print(_line("tuned", results["tuned"], f" (page={best['page']})"), flush=True)

    # resolved-vs-default sanity: the tuned run must actually have served
    # store-resolved configs, not degraded to defaults
    disp = results["tuned"]["dispatch"]
    assert disp["store_exact"] >= 1, "tuned store records did not resolve"
    assert disp["build_failed"] == 0, "tuned config failed to build"

    # obs snapshot with per-call samples for both hot-path kernels
    bucket = min(-(-resident_typ // int(best["page"])) * int(best["page"]), max_len)
    probe_kernels(svc_t, cfg, max_batch=args.max_batch, bucket=bucket,
                  prompt_len=max(prompt_lens), device=dev)
    write_snapshot(args.obs_out, registry=svc_t.metrics, bench="serve",
                   mode="tuned", meta=bench_meta(dev))

    guard_payload = None
    if args.inject_drift:
        print("# guard phase: shadow overhead + injected-drift heal loop", flush=True)
        guard_payload = guard_drift_phase(
            cfg, best, store_root=store_root, max_batch=args.max_batch,
            bucket=bucket, quick=quick, device=dev, trials=args.overhead_trials)
        print(f"guard  : shadow p50 {guard_payload['p50_shadow_ms']:.4f}ms vs "
              f"plain {guard_payload['p50_plain_ms']:.4f}ms, min "
              f"{guard_payload['min_shadow_ms']:.4f}ms vs "
              f"{guard_payload['min_plain_ms']:.4f}ms "
              f"({guard_payload['shadow_overhead_frac']:+.2%}), "
              f"{guard_payload['shadow']['shadow_evals']} shadow evals, "
              f"{guard_payload['quarantines']} quarantine(s)", flush=True)
        for row in guard_payload["overhead_trials"]:
            print(f"guard  : {row['b']} at {row['pairs']} pairs, {row['trials']} trials: "
                  f"mean {row['mean_pct']:+.2f}% sd {row['sd_pct']:.2f}% largest "
                  f"{row['max_pct']:+.2f}%, {row['past_2pct']} past 2%", flush=True)

    ids = {mode: r.pop("ids") for mode, r in results.items()}
    payload = {
        "workload": {
            "requests": n_req, "rate_req_s": rate,
            "prompt_lens": list(prompt_lens), "out_mean": out_mean,
            "out_cap": out_cap, "max_batch": args.max_batch,
            "max_len": max_len, "seed": args.seed,
            "arch": cfg.name, "reduced": bool(args.reduced), "dtype": "float32",
        },
        "modes": results,
        "speedup_p50_tuned_vs_einsum":
            results["einsum"]["token_lat_p50_ms"]
            / results["tuned"]["token_lat_p50_ms"],
        "speedup_p50_tuned_vs_default":
            results["default"]["token_lat_p50_ms"]
            / results["tuned"]["token_lat_p50_ms"],
    }
    if guard_payload is not None:
        payload["guard"] = guard_payload
    write_bench_json(args.out, payload, device=dev)
    if record is not None:
        record["payload"] = payload
        record["modes"] = {mode: dict(r, ids=ids[mode]) for mode, r in results.items()}
    print(f"wrote {args.out} and {args.obs_out}")
    print(f"speedup p50 tuned vs einsum : "
          f"{payload['speedup_p50_tuned_vs_einsum']:.2f}x")
    print(f"speedup p50 tuned vs default: "
          f"{payload['speedup_p50_tuned_vs_default']:.2f}x", flush=True)

    # guard tripwires: shadow epsilon must be ~free at the least call, and
    # the injected regression must have been quarantined with fallback
    if guard_payload is not None:
        limit = 0.25 if quick else 0.02   # quick runs are too short to bound
        if guard_payload["shadow_overhead_frac"] > limit:
            print(f"FAIL: shadow epsilon costs "
                  f"{guard_payload['shadow_overhead_frac']:.1%} of the least call "
                  f"(limit {limit:.0%})")
            return 1
        if not (guard_payload["drift_ok"] and guard_payload["fallback_ok"]):
            print(f"FAIL: drift-heal loop incomplete: {guard_payload}")
            return 1

    # tripwire: p99 must exist, be finite, and be non-degenerate
    for mode, r in results.items():
        p99 = r["token_lat_p99_ms"]
        if p99 is None or not np.isfinite(p99) or p99 <= 0.0:
            print(f"FAIL: degenerate p99 for mode {mode}: {p99}")
            return 1
        if r["token_lat_p50_ms"] > p99:
            print(f"FAIL: p50 > p99 for mode {mode}")
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
