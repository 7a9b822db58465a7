"""Cascade against a flat campaign on the port: the same answer for half
the full-size bill? The counterpart of ``benchmarks/fidelity_bench.py``.

The multi-fidelity claim (``repro_torch.fidelity``) is quantitative: a
cascade that screens on the Hopper cost model and promotes only its top-k
should reach an objective within a few percent of a flat campaign while
spending at most half its full-size evaluations. Per kernel:

  * **flat**: one ``Campaign`` timing every proposal at full size (LARGE
    on the card, ``BENCH_DIMS`` with ``--device cpu``), budget E;
  * **cascade**: a ``CascadeCampaign`` over the default ladder (cost ->
    proxy -> full size) whose full-size rung gets at most E/2.

Both run the same learner and seed; both winners are then re-timed with the
row timer (``benchmarks.torch_common.time_callable``), so the quality
verdict is one measurement, not the two campaigns' own numbers. Results go
to ``BENCH_torch_fidelity.json`` (stamped by ``bench_meta``) and an obs
snapshot beside it with the ``fidelity_screened_total`` /
``fidelity_promoted_total`` counters and the per-rung latency histograms.

    PYTHONPATH=src:. python -m benchmarks.torch_fidelity_bench [--device cpu]
    PYTHONPATH=src:. python -m benchmarks.torch_fidelity_bench --quick --no-check

Exits non-zero when a kernel misses the gate (full-size evaluations over
``--hw-frac`` of the flat campaign's, or the cascade's winner slower than
``--tol`` over the flat one's); ``--no-check`` reports without gating.
"""

from __future__ import annotations

import argparse
import os
import sys

from benchmarks.torch_common import time_callable, write_bench_json
from repro_torch.core.plopper import TimingEvaluator
from repro_torch.engine import Campaign
from repro_torch.fidelity import CascadeCampaign, default_ladder
from repro_torch.kernels.problems import BENCH_DIMS, LARGE_SHAPES, gpu_problem
from repro_torch.kernels.spaces import kernel_space
from repro_torch.obs.export import write_snapshot
from repro_torch.obs.metrics import MetricsRegistry, set_registry, summarize_histograms
from repro_torch.kernels.util import resolve_device


def bench_kernel(kernel: str, flat_evals: int, budgets: tuple, seed: int, learner: str,
                 device) -> dict:
    on_card = device.type == "cuda"
    target = "gpu" if on_card else "host"
    problem = gpu_problem(kernel, (LARGE_SHAPES if on_card else BENCH_DIMS)[kernel],
                          device=device)
    flat = Campaign(kernel_space(kernel, target=target, seed=seed),
                    TimingEvaluator(problem, repeats=2, warmup=1),
                    max_evals=flat_evals, learner=learner, seed=seed).run()
    ladder = default_ladder(kernel, budgets=budgets, device=device.type)
    cascade = CascadeCampaign(kernel_space(kernel, target=target, seed=seed), ladder,
                              learner=learner, seed=seed, kernel=kernel).run()
    # both winners re-timed by one timer, one after the other
    t_flat = time_callable(*problem(dict(flat.best.config)))
    t_cascade = time_callable(*problem(dict(cascade.best.config)))
    return {
        "kernel": kernel,
        "learner": learner,
        "seed": seed,
        "flat": {
            "budget": flat_evals,
            "hw_evals": flat.n_evaluated + flat.n_failed,
            "best_config": dict(flat.best.config),
            "best_sec": float(flat.best.objective),
            "retimed_sec": t_flat,
        },
        "cascade": {
            "ladder": ladder.describe(),
            "hw_evals": cascade.hw_evals,
            "screened": cascade.stats["screened"],
            "promoted": cascade.stats["promoted"],
            "calibration": cascade.stats["calibration"],
            "best_config": dict(cascade.best.config),
            "best_sec": float(cascade.best.objective),
            "retimed_sec": t_cascade,
        },
        "hw_eval_ratio": round(cascade.hw_evals / max(1, flat.n_evaluated + flat.n_failed), 4),
        "quality_ratio": round(t_cascade / t_flat, 4) if t_flat > 0 else float("inf"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", nargs="*", default=["matmul", "mm3"],
                    help="kernels to compare (default: the JAX package's two)")
    ap.add_argument("--flat-evals", type=int, default=30,
                    help="flat campaign budget E (the cascade's full-size rung gets "
                         "at most E/2)")
    ap.add_argument("--budgets", default=None, metavar="B0,B1[,B2]",
                    help="cascade rung budgets (default: 4E cost screens, E/2 proxy, "
                         "E/2 - 3 full size)")
    ap.add_argument("--learner", default="RF")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--tol", type=float, default=0.05,
                    help="allowed cascade slowdown over flat (0.05 = 5%%)")
    ap.add_argument("--hw-frac", type=float, default=0.5,
                    help="max cascade full-size evaluations as a fraction of flat's")
    ap.add_argument("--quick", action="store_true",
                    help="smoke run: flat budget 16, cost->full-size ladder (96, 8)")
    ap.add_argument("--no-check", action="store_true",
                    help="report without gating the exit code")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the campaigns run (default: the card)")
    ap.add_argument("--out", default="BENCH_torch_fidelity.json")
    args = ap.parse_args(argv)

    if args.quick:
        args.flat_evals = 16
    e = args.flat_evals
    if args.budgets:  # an explicit ladder wins over --quick's
        budgets = tuple(int(x) for x in args.budgets.split(","))
    elif args.quick:
        budgets = (96, 8)
    else:
        budgets = (4 * e, max(4, e // 2), max(3, e // 2 - 3))
    dev = resolve_device(args.device)

    registry = MetricsRegistry()
    prev = set_registry(registry)  # capture the fidelity counters of this run
    try:
        rows = [bench_kernel(k, args.flat_evals, budgets, args.seed, args.learner, dev)
                for k in args.kernels]
    finally:
        set_registry(prev)

    failures = []
    for r in rows:
        hw_ok = r["hw_eval_ratio"] <= args.hw_frac + 1e-9
        q_ok = r["quality_ratio"] <= 1.0 + args.tol
        r["gate"] = {"hw_ok": hw_ok, "quality_ok": q_ok, "pass": hw_ok and q_ok}
        if not r["gate"]["pass"]:
            failures.append(r["kernel"])
        print(f"[{r['kernel']}] flat {r['flat']['retimed_sec'] * 1e6:.1f}us "
              f"({r['flat']['hw_evals']} full-size evals) vs cascade "
              f"{r['cascade']['retimed_sec'] * 1e6:.1f}us "
              f"({r['cascade']['hw_evals']} full-size evals, "
              f"{r['cascade']['screened']} screened) "
              f"quality x{r['quality_ratio']:.3f} hw x{r['hw_eval_ratio']:.2f} "
              f"{'PASS' if r['gate']['pass'] else 'FAIL'}", flush=True)

    payload = {
        "flat_evals": args.flat_evals,
        "budgets": list(budgets),
        "tol": args.tol,
        "hw_frac": args.hw_frac,
        "kernels": rows,
        "gate_pass": not failures,
        "obs": summarize_histograms(registry.snapshot()),
    }
    write_bench_json(args.out, payload, device=dev)
    obs_out = os.path.splitext(args.out)[0] + ".obs.jsonl"
    write_snapshot(obs_out, registry=registry, bench="fidelity")
    print(f"wrote {args.out} and {obs_out}")

    if failures and not args.no_check:
        print(f"FAIL: gate missed for {', '.join(failures)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
