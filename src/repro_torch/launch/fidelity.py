"""The multi-fidelity cascade's CLI (see :mod:`repro_torch.fidelity`), the
counterpart of ``repro.launch.fidelity``.

    # rank-correlation audit: does the Hopper cost model order configs the
    # way CUDA-event timing on the card does? Reports Spearman rho per
    # kernel and flags the ones too weak to screen on (screen_ok=false);
    # --strict turns a weak kernel into a non-zero exit (the CI gate)
    PYTHONPATH=src python -m repro_torch.launch.fidelity audit [--kernel K] \\
        [--samples N] [--rho-min R] [--full-dims | --proxy-dims] [--json] \\
        [--out FILE] [--strict]

    # describe a kernel's default cost -> proxy -> hardware ladder: per-rung
    # budgets, promotion counts, and the dims each rung evaluates at
    PYTHONPATH=src python -m repro_torch.launch.fidelity show --kernel K \\
        [--rung-budgets B0,B1,B2]

Both run on the card unless ``--device cpu`` is given. The audit measures
at the dims a campaign tunes at, which rung 0 screens at: the paper's LARGE
sizes over the ``gpu`` space on the card, the bench sizes over the ``host``
space on the CPU. ``--full-dims`` asks for those dims by name (the JAX
package's flag: its audit measures at its proxy dims unless given it);
``--proxy-dims`` measures at ``PROXY_DIMS``, the dims of the cascade's
proxy rung, so that rung can be audited too. The JSON names the dims used
(``"dims": "full"`` or ``"proxy"``, and each row its own). ``--out FILE``
also records every sampled pair, the card's description and its name and
power limit (``nvidia-smi``), the fixture ``tests/test_torch_fidelity.py``
recomputes rho from.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess


def card_name_and_power_limit() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card, or None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def cmd_audit(args) -> int:
    from repro_torch.fidelity.audit import audit_kernel
    from repro_torch.kernels.cost import KERNEL_COST_FNS, hopper
    from repro_torch.kernels.problems import PROXY_DIMS

    kernels = [args.kernel] if args.kernel else sorted(KERNEL_COST_FNS)
    rows = [audit_kernel(k, n_samples=args.samples, seed=args.seed,
                         repeats=args.repeats, rho_min=args.rho_min,
                         dims=PROXY_DIMS[k] if args.proxy_dims else None,
                         target=args.target, device=args.device)
            for k in kernels]
    weak = [r["kernel"] for r in rows if not r["screen_ok"]]
    out = {"rho_min": args.rho_min, "samples": args.samples, "seed": args.seed,
           "repeats": args.repeats, "dims": "proxy" if args.proxy_dims else "full",
           "device": args.device or "cuda",
           "card": card_name_and_power_limit() if args.device != "cpu" else None,
           "hw": hopper().to_dict(), "audit": rows, "weak_kernels": weak}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    if args.json:
        print(json.dumps(out, indent=2))
    else:
        hdr = f"{'kernel':<18} {'rho':>7} {'pairs':>6} {'dropped':>8}  verdict    dims"
        print(hdr)
        print("-" * len(hdr))
        for r in rows:
            rho = "nan" if r["rho"] is None else f"{r['rho']:.3f}"
            verdict = "screen_ok" if r["screen_ok"] else "WEAK"
            print(f"{r['kernel']:<18} {rho:>7} {r['n_paired']:>6} "
                  f"{r['n_dropped']:>8}  {verdict:<9}  {out['dims']} {tuple(r['dims'])}")
        if weak:
            print(f"weak: {', '.join(weak)} — cost-model ordering below "
                  f"rho_min={args.rho_min}; cascade these over the proxy "
                  f"rung instead of screening analytically")
    return 1 if (args.strict and weak) else 0


def cmd_show(args) -> int:
    from repro_torch.fidelity import default_ladder
    from repro_torch.kernels.problems import (
        BENCH_DIMS,
        LARGE_SHAPES,
        PROXY_DIMS,
        fidelity_ready,
    )

    kernel = args.kernel
    if not fidelity_ready(kernel):
        print(f"{kernel}: fidelity_ready=false (no cost-model entry; "
              f"cannot screen on rung 0)")
        return 1
    budgets = tuple(int(x) for x in args.rung_budgets.split(","))
    ladder = default_ladder(kernel, budgets=budgets, device=args.device)
    dims = (BENCH_DIMS if args.device == "cpu" else LARGE_SHAPES)[kernel]
    print(json.dumps({
        "kernel": kernel,
        "fidelity_ready": True,
        "device": args.device or "cuda",
        "dims": list(dims),
        "proxy_dims": list(PROXY_DIMS.get(kernel, dims)),
        "ladder": ladder.describe(),
    }, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.fidelity",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    aud = sub.add_parser("audit", help="cost-model rank-correlation audit")
    aud.add_argument("--kernel", default=None,
                     help="audit one kernel (default: every fidelity-ready one)")
    aud.add_argument("--samples", type=int, default=10,
                     help="configs sampled per kernel")
    aud.add_argument("--seed", type=int, default=7)
    aud.add_argument("--repeats", type=int, default=1,
                     help="timing repeats per config (min is taken)")
    aud.add_argument("--rho-min", type=float, default=0.2,
                     help="Spearman rho below which a kernel is flagged weak")
    aud.add_argument("--target", default=None, choices=["gpu", "host"],
                     help="config space flavor to sample (default: gpu on the "
                          "card, host on the CPU)")
    aud.add_argument("--device", default=None, choices=["cuda", "cpu"],
                     help="where to measure (default: the card)")
    which = aud.add_mutually_exclusive_group()
    which.add_argument("--full-dims", action="store_true",
                       help="measure at the dims a campaign tunes at (the default: "
                            "LARGE on the card, bench dims on the CPU)")
    which.add_argument("--proxy-dims", action="store_true",
                       help="measure at PROXY_DIMS, the cascade's proxy rung")
    aud.add_argument("--json", action="store_true")
    aud.add_argument("--out", default=None, metavar="FILE",
                     help="also write the JSON report to FILE (the recorded fixture)")
    aud.add_argument("--strict", action="store_true",
                     help="non-zero exit when any kernel is weak (CI gate)")
    aud.set_defaults(fn=cmd_audit)

    sh = sub.add_parser("show", help="describe a kernel's default ladder")
    sh.add_argument("--kernel", required=True)
    sh.add_argument("--rung-budgets", default="64,16,8", metavar="B0,B1,B2")
    sh.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the ladder's timed rungs run (default: the card)")
    sh.set_defaults(fn=cmd_show)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
