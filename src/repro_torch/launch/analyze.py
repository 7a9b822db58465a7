"""Static analysis CLI (see :mod:`repro_torch.analyze`) — a copy of
``repro.launch.analyze`` on the port's modules.

    # audit every kernel's config space against the canonical shape table:
    # what fraction of sampled configs is statically infeasible (errors) or
    # pathological (warnings: misaligned tiles, padding waste, huge grids)?
    python -m repro_torch.launch.analyze space [--kernel K] [--samples N] \
        [--seed S] [--json] [--out FILE]

    # concurrency lint over the port (lock order, guarded mutations,
    # monotonic clocks, daemon threads); non-zero exit when findings exceed
    # --max-findings — the CI gate
    python -m repro_torch.launch.analyze lint [PATH ...] [--max-findings N] [--json]

``space`` audits the ``host`` space at the bench dims (target ``host``) and
the ``gpu`` space at LARGE under the Hopper cost model (target ``cost``),
as the JAX package audits its host and TPU spaces; on a machine with a
card it also audits the ``gpu`` space at LARGE against the card's shared
memory per block (target ``gpu``). Without a card the ``gpu`` target is
reported as not audited: its shared-memory verdicts need the card's limit,
which the audit does not guess.

Both commands print JSON with ``--json``; ``space --out FILE`` additionally
writes the audit to FILE.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _default_lint_paths() -> list[str]:
    import repro_torch

    return [os.path.dirname(os.path.abspath(repro_torch.__file__))]


def cmd_lint(args) -> int:
    from repro_torch.analyze.lint import lint_paths

    paths = args.paths or _default_lint_paths()
    findings = lint_paths(paths)
    if args.json:
        print(json.dumps({
            "paths": paths,
            "n_findings": len(findings),
            "max_findings": args.max_findings,
            "findings": [f.to_dict() for f in findings],
        }, indent=2))
    else:
        for f in findings:
            print(f.format())
        print(f"{len(findings)} finding(s) "
              f"(budget: {args.max_findings})")
    return 0 if len(findings) <= args.max_findings else 1


def _audit_kernel(kernel: str, target: str, dims: tuple, samples: int,
                  seed: int) -> dict:
    from repro_torch.analyze.feasibility import check_config
    from repro_torch.kernels.spaces import kernel_space

    space = kernel_space(
        kernel, target="host" if target == "host" else "gpu", seed=seed)
    rng = np.random.default_rng(seed)
    cfgs = [space.default_configuration()]
    cfgs += space.sample_configurations(samples, rng)
    n_error = n_warn = 0
    codes: dict[str, int] = {}
    for cfg in cfgs:
        verdict = check_config(kernel, cfg, dims=dims, target=target)
        if not verdict.ok:
            n_error += 1
        elif verdict.warnings:
            n_warn += 1
        for f in verdict.findings:
            codes[f.code] = codes.get(f.code, 0) + 1
    n = len(cfgs)
    return {
        "kernel": kernel,
        "target": target,
        "dims": list(dims),
        "n_sampled": n,
        "n_infeasible": n_error,
        "n_pathological": n_warn,
        "infeasible_fraction": round(n_error / n, 4),
        "pathological_fraction": round(n_warn / n, 4),
        "codes": dict(sorted(codes.items(), key=lambda kv: -kv[1])),
    }


def _gpu_audit() -> dict:
    """Whether the ``gpu`` target is audited here, and against what."""
    from repro_torch.analyze.feasibility import smem_limit

    limit = smem_limit()
    if limit is None:
        return {"audited": False, "smem_limit": None,
                "reason": "no CUDA device: the gpu target's shared-memory "
                          "verdicts need the card's limit"}
    import torch

    return {"audited": True, "smem_limit": limit,
            "device": torch.cuda.get_device_name(torch.cuda.current_device())}


def cmd_space(args) -> int:
    from repro_torch.kernels.problems import (
        BENCH_DIMS,
        LARGE_SHAPES,
        fidelity_readiness,
    )

    kernels = [args.kernel] if args.kernel else sorted(BENCH_DIMS)
    gpu = _gpu_audit()
    rows = []
    for kernel in kernels:
        # host spaces at bench dims, gpu spaces at the paper's LARGE dims
        # under the Hopper cost model and, on a card, against its limits
        rows.append(_audit_kernel(kernel, "host", BENCH_DIMS[kernel],
                                  args.samples, args.seed))
        rows.append(_audit_kernel(kernel, "cost", LARGE_SHAPES[kernel],
                                  args.samples, args.seed))
        if gpu["audited"]:
            rows.append(_audit_kernel(kernel, "gpu", LARGE_SHAPES[kernel],
                                      args.samples, args.seed))
    # cost-model coverage (repro_torch.fidelity): a dispatch-registered
    # kernel without a cost-model entry cannot screen on the cascade's
    # analytic rung — surface it as a reviewable fact, per kernel
    coverage = fidelity_readiness()
    for r in rows:
        r["fidelity_ready"] = coverage.get(r["kernel"], False)
    out = {"samples_per_space": args.samples, "seed": args.seed, "audit": rows,
           "gpu": gpu,
           "fidelity": {
               "coverage": coverage,
               "missing_cost_model": sorted(
                   k for k, ok in coverage.items() if not ok),
           }}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=2)
    if args.json:
        print(json.dumps(out, indent=2))
    else:
        hdr = (f"{'kernel':<16} {'target':<6} {'infeasible':>10} "
               f"{'pathological':>12} {'fidelity':>8}  top codes")
        print(hdr)
        print("-" * len(hdr))
        for r in rows:
            top = ", ".join(f"{c}({n})" for c, n
                            in list(r["codes"].items())[:3]) or "-"
            ready = "ready" if r["fidelity_ready"] else "NO-COST"
            print(f"{r['kernel']:<16} {r['target']:<6} "
                  f"{r['infeasible_fraction']:>9.1%} "
                  f"{r['pathological_fraction']:>11.1%} {ready:>8}  {top}")
        if not gpu["audited"]:
            print(f"gpu: not audited ({gpu['reason']})")
        missing = out["fidelity"]["missing_cost_model"]
        if missing:
            print(f"fidelity: {len(missing)} dispatch-registered kernel(s) "
                  f"lack a cost model: {', '.join(missing)}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.analyze",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("space", help="config-space feasibility audit")
    sp.add_argument("--kernel", default=None,
                    help="audit one kernel (default: all registered)")
    sp.add_argument("--samples", type=int, default=512,
                    help="sampled configs per (kernel, target) space")
    sp.add_argument("--seed", type=int, default=1234)
    sp.add_argument("--json", action="store_true",
                    help="print the full audit as JSON")
    sp.add_argument("--out", default=None, metavar="FILE",
                    help="also write the JSON audit to FILE (CI artifact)")
    sp.set_defaults(fn=cmd_space)

    lp = sub.add_parser("lint", help="concurrency lint (REP101-REP105)")
    lp.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the repro_torch package)")
    lp.add_argument("--max-findings", type=int, default=0,
                    help="max findings before a non-zero exit (CI gate)")
    lp.add_argument("--json", action="store_true")
    lp.set_defaults(fn=cmd_lint)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
