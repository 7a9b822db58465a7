"""How far a loaded host moves the device time a timed call reports.

A guard's shadow sample and an evaluator's run are timed by
:class:`repro_torch.core.plopper.LaunchClock` from the call's first device
operation to its last, behind a spin of ``LEAD_CYCLES`` (about 0.1 ms)
queued at the wrapper's first mark. Host work between that mark and the
launch that outlasts the spin leaves the device idle inside the timed span,
so a slow or loaded host reads as drift on a healthy record.

For the serving loop's kernels at the shapes of ``chip_smoke.py``'s phase 7
(qwen2-0.5b at batch 4: the decode step's attention and output projection,
the prefill's attention), on an idle host, with N busy host processes, and
with the host's path after the first mark made longer by a busy wait of D
microseconds (a slow host), each row gives:

* ``kernel_us``: device time a call, ten calls queued behind a spin;
* ``clock_p50_us``, ``clock_p90_us``, ``clock_p99_us``: LaunchClock samples
  at the clock's own lead spin (what the drift watch reads), and
  ``lead_us``, that spin after the samples;
* ``exposed_p50_us``, ``exposed_p90_us``: LaunchClock samples with no lead
  spin, less ``kernel_us``: the host's path from the first mark to the
  device's last operation that the spin has to cover.

On the card, from the repo root (``--src DIR`` puts another tree's
``repro_torch`` first on the path, to hold two trees against each other)::

    PYTHONPATH=src python benchmarks/torch_clock_load.py --busy 16 --delay-us 150 --out FILE

It gates nothing; the JSON carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import time


def _busy() -> None:
    """A host process that keeps one core busy until it is terminated."""
    x = 0
    while True:
        x = (x * 31 + 7) % 1_000_003


def _kernels(dev):
    """``{name: call}`` at phase 7's shapes on ``dev``."""
    import torch

    from repro_torch.kernels.decode_attention import CacheRows, decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul import tiled_matmul

    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev)

    q, kc, vc = rand(8, 7, 64), rand(4, 288, 2, 64), rand(4, 288, 2, 64)
    cp = torch.full((8,), 200, dtype=torch.int32, device=dev)
    fq, fk, fv = rand(8, 256, 64), rand(8, 256, 64), rand(8, 256, 64)
    a, b = rand(4, 896), rand(896, 896)
    return {
        "decode_attention 8x7x64;8x288x64 bk=128 hg=1":
            lambda: decode_attention(q, CacheRows(kc), CacheRows(vc), cp, bk=128, hg=1),
        "flash_attention 8x256x64 causal":
            lambda: flash_attention(fq, fk, fv, causal=True),
        "matmul 4x896;896x896":
            lambda: tiled_matmul(a, b),
    }


def _queued_us(fn, calls: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def _samples_us(fn, n: int, lead: bool, on_card) -> tuple[list[float], float]:
    """``n`` LaunchClock samples of ``fn`` (``on_card``: a CUDA tensor, which
    puts the clock on the device), with its lead spin or none; and the spin
    the clock would choose after them, in microseconds."""
    from repro_torch.core import plopper

    adaptive = getattr(plopper, "lead_cycles", None)  # a tree with a fixed spin has none
    saved = plopper.LEAD_CYCLES
    if adaptive is not None:
        plopper._lead_paths.clear()
    if not lead:
        plopper.LEAD_CYCLES = 0
        if adaptive is not None:
            plopper.lead_cycles = lambda: 0
    try:
        out = []
        for _ in range(n):
            clock = plopper.LaunchClock((on_card,))
            fn()
            out.append(clock.stop() * 1e6)
        cycles = adaptive() if adaptive is not None else plopper.LEAD_CYCLES
        return out, cycles / saved * 100.0
    finally:
        plopper.LEAD_CYCLES = saved
        if adaptive is not None:
            plopper.lead_cycles = adaptive


def _slow_host(delay_us: float):
    """Make the host's path after a timed call's first mark ``delay_us``
    longer (a busy wait, as a slow host spends it); returns the undo."""
    from repro_torch.kernels import build

    mark = build.mark_launch

    def slow_mark():
        first = build._marks.pending is not None
        mark()
        if first:
            t = time.perf_counter() + delay_us * 1e-6
            while time.perf_counter() < t:
                pass

    build.mark_launch = slow_mark
    return lambda: setattr(build, "mark_launch", mark)


def _pct(xs: list[float], q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--busy", type=int, default=16, help="busy host processes")
    ap.add_argument("--delay-us", type=float, default=150.0,
                    help="host microseconds added after the first mark")
    ap.add_argument("--samples", type=int, default=400)
    ap.add_argument("--src", default=None, help="a tree's src/ to import repro_torch from")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    import torch

    from repro_torch.launch.fidelity import card_name_and_power_limit

    if not torch.cuda.is_available():
        raise SystemExit("torch_clock_load: no CUDA device")
    import repro_torch

    dev = torch.device("cuda")
    on_card = torch.zeros(1, device=dev)
    kernels = _kernels(dev)
    rows = []
    for load, busy, delay in (("idle", 0, 0.0), (f"busy {args.busy}", args.busy, 0.0),
                              (f"host +{args.delay_us:g} us", 0, args.delay_us)):
        procs = [mp.get_context("spawn").Process(target=_busy, daemon=True)
                 for _ in range(busy)]
        undo = _slow_host(delay) if delay else None
        try:
            for p in procs:
                p.start()
            time.sleep(1.0 if procs else 0.0)
            for name, fn in kernels.items():
                kernel = _queued_us(fn)
                clock, lead_us = _samples_us(fn, args.samples, lead=True, on_card=on_card)
                bare, _ = _samples_us(fn, args.samples, lead=False, on_card=on_card)
                row = {"kernel": name, "load": load, "kernel_us": kernel,
                       "clock_p50_us": _pct(clock, 0.5), "clock_p90_us": _pct(clock, 0.9),
                       "clock_p99_us": _pct(clock, 0.99), "lead_us": lead_us,
                       "exposed_p50_us": _pct(bare, 0.5) - kernel,
                       "exposed_p90_us": _pct(bare, 0.9) - kernel}
                rows.append(row)
                print(json.dumps(row), flush=True)
        finally:
            if undo is not None:
                undo()
            for p in procs:
                p.terminate()
            for p in procs:
                p.join()
    result = {"card": card_name_and_power_limit(), "tree": os.path.dirname(
        os.path.dirname(os.path.abspath(repro_torch.__file__))), "samples": args.samples,
        "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
