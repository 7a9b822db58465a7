"""Resilience-layer inspection CLI — a copy of ``repro.launch.guard`` on
the port's modules.

    # watch state from a store: drift quarantines, reasons, affected keys
    python -m repro_torch.launch.guard status --store results/store \
        [--obs results/obs.jsonl]

    # offline audit: re-run the drift policy over a recorded obs snapshot
    # log and print the decisions the live watcher made (or would make);
    # --histogram dispatch_shadow_seconds for a service on the gpu backend
    python -m repro_torch.launch.guard replay --obs results/obs.jsonl \
        --store results/store [--drift-factor 3.0] [--hysteresis 2] \
        [--min-samples 8] [--interval 10] [--histogram NAME]

    # the fault-point catalog; --spec validates a REPRO_FAULTS string
    python -m repro_torch.launch.guard faults [--spec "eval.hang:times=1"]

``status`` is the offline complement of the live view
(``DispatchService.telemetry()["guard"]``):
it reads only durable state — quarantine tombstones and, with ``--obs``,
the ``guard_*`` counters of the newest snapshot — so it works against a
store directory with no serving process attached. ``replay`` makes drift
decisions auditable: the policy core is pure, so the same snapshots and
baselines always reproduce the same quarantine calls. All commands print
JSON on stdout.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.dispatch import TuningStore
from repro_torch.dispatch.signature import signature_key
from repro_torch.guard import (
    CATALOG,
    WatchPolicy,
    guard_counters,
    install_env_faults,
    replay_decisions,
)
from repro_torch.guard.watch import EXECUTE_HISTOGRAM, SHADOW_HISTOGRAM


def _baselines(store: TuningStore) -> dict:
    store.refresh()
    return {(r.kernel, signature_key(r.signature), r.backend):
            float(r.objective) for r in store.records()}


def _read_snapshots(path: str) -> list[dict]:
    from repro_torch.obs.export import read_snapshot_file

    return read_snapshot_file(path, merge=False)


def _policy(args) -> WatchPolicy:
    return WatchPolicy(interval_sec=args.interval,
                       drift_factor=args.drift_factor,
                       hysteresis=args.hysteresis,
                       cooldown_sec=args.cooldown,
                       min_samples=args.min_samples)


def _add_policy_args(p: argparse.ArgumentParser) -> None:
    d = WatchPolicy()
    p.add_argument("--interval", type=float, default=d.interval_sec,
                   help="seconds per snapshot window (replay clock)")
    p.add_argument("--drift-factor", type=float, default=d.drift_factor,
                   help="quarantine when window p50 > factor x stored baseline")
    p.add_argument("--hysteresis", type=int, default=d.hysteresis,
                   help="consecutive breaching windows before acting")
    p.add_argument("--cooldown", type=float, default=d.cooldown_sec,
                   help="seconds between actions on the same key")
    p.add_argument("--min-samples", type=int, default=d.min_samples,
                   help="ignore windows with fewer executions")
    p.add_argument("--histogram", default=EXECUTE_HISTOGRAM,
                   choices=(EXECUTE_HISTOGRAM, SHADOW_HISTOGRAM),
                   help="the latency histogram the watch read (the gpu backend's "
                        "watch reads the shadow samples' device times)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.guard",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    st = sub.add_parser("status")
    st.add_argument("--store", required=True, help="TuningStore directory")
    st.add_argument("--obs", default=None,
                    help="obs snapshot JSONL: report guard_* counters")

    rp = sub.add_parser("replay")
    rp.add_argument("--store", required=True,
                    help="TuningStore directory (drift baselines)")
    rp.add_argument("--obs", required=True, help="obs snapshot JSONL to audit")
    _add_policy_args(rp)

    fl = sub.add_parser("faults")
    fl.add_argument("--spec", default=None,
                    help="validate a REPRO_FAULTS spec without running")

    args = ap.parse_args(argv)

    if args.cmd == "faults":
        out = {"catalog": {name: dict(meta) for name, meta in CATALOG.items()}}
        if args.spec is not None:
            try:
                n = install_env_faults(args.spec)
                from repro_torch.guard import active_faults, clear_faults

                out["spec"] = {"armed": n, "faults": [
                    {"point": f.point, "times": f.times, "every": f.every,
                     "delay_sec": f.delay_sec, "hang": f.hang,
                     "raises": f.raises, "where": f.where}
                    for f in active_faults().values()]}
                clear_faults()
            except Exception as e:  # noqa: BLE001 — validation must report
                print(json.dumps({"error": repr(e)}, indent=2))
                return 1
        print(json.dumps(out, indent=2))
        return 0

    store = TuningStore(args.store)

    if args.cmd == "status":
        quars = store.quarantines()
        drift = [q for q in quars if q["reason"].startswith("drift:")]
        out = {
            "quarantines": len(quars),
            "drift_quarantines": drift,
            "other_quarantines": [q for q in quars if q not in drift],
            "baseline_keys": len(_baselines(store)),
        }
        if args.obs:
            snaps = _read_snapshots(args.obs)
            out["obs_snapshots"] = len(snaps)
            if snaps:
                latest = snaps[-1].get("snapshot", snaps[-1])
                out["guard_counters"] = guard_counters(latest)
        print(json.dumps(out, indent=2))
        return 0

    # replay
    snaps = _read_snapshots(args.obs)
    decisions = replay_decisions(snaps, _baselines(store), _policy(args), args.histogram)
    print(json.dumps({
        "snapshots": len(snaps),
        "windows": max(0, len(snaps) - 1),
        "policy": {"histogram": args.histogram,
                   "drift_factor": args.drift_factor,
                   "hysteresis": args.hysteresis,
                   "cooldown_sec": args.cooldown,
                   "min_samples": args.min_samples},
        "decisions": decisions,
    }, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
