"""repro-obs — observability CLI: snapshots, traces, and a /metrics endpoint;
the counterpart of ``repro.launch.obs``, the same subcommands, JSON on
stdout and exit codes.

    # latest merged metrics view of a snapshot JSONL (or a live endpoint)
    python -m repro_torch.launch.obs snapshot --file results/obs/metrics.jsonl
    python -m repro_torch.launch.obs snapshot --url http://127.0.0.1:8710 --prom

    # human-readable tail of a trace file
    python -m repro_torch.launch.obs tail --trace results/obs/trace.jsonl -n 20

    # validate a trace + per-span-name latency stats; optionally export a
    # Perfetto-loadable JSON and require specific spans (CI assertion)
    python -m repro_torch.launch.obs summarize --trace results/obs/trace.jsonl \
        --perfetto results/obs/trace.perfetto.json \
        --require-spans campaign.ask,campaign.evaluate,campaign.tell

    # histogram summaries (count / p50 / p99) from a metrics snapshot file,
    # e.g. the serving benchmark's (benchmarks/torch_serve_bench.py)
    python -m repro_torch.launch.obs summarize --metrics results/obs/metrics.jsonl
    python -m repro_torch.launch.obs summarize --metrics BENCH_torch_serve.obs.jsonl

    # serve merged snapshot-file metrics as a Prometheus /metrics endpoint
    python -m repro_torch.launch.obs serve --file results/obs/metrics.jsonl --port 8710

All commands print a JSON summary on stdout (except ``snapshot --prom``,
which prints Prometheus text). Non-zero exit on failed validation or a
missing required span, so CI can assert on the timeline's shape.
"""

from __future__ import annotations

import argparse
import json
import urllib.request

from repro_torch.obs.export import ObsServer, prometheus_text, read_snapshot_file
from repro_torch.obs.metrics import merge_snapshots, summarize_histograms
from repro_torch.obs.trace import export_chrome_trace, iter_trace, validate_trace


def _scrape(url: str) -> dict:
    with urllib.request.urlopen(url.rstrip("/") + "/snapshot", timeout=10) as r:
        return json.loads(r.read())


def _load_snapshot(args) -> dict:
    snaps = []
    if args.file:
        snaps.append(read_snapshot_file(args.file))
    if args.url:
        snaps.append(_scrape(args.url))
    return merge_snapshots(*snaps)


def cmd_snapshot(args) -> int:
    snap = _load_snapshot(args)
    if args.prom:
        print(prometheus_text(snap), end="")
    else:
        print(json.dumps(snap, indent=2))
    return 0


def cmd_tail(args) -> int:
    events = [ev for ev in iter_trace(args.trace)]
    for ev in events[-args.n:]:
        dur = f"{ev.get('dur', 0) / 1e3:10.3f}ms" if ev.get("ph") == "X" else " " * 12
        attrs = json.dumps(ev.get("args", {})) if ev.get("args") else ""
        print(f"{ev.get('ts', 0):>16} {ev.get('ph', '?'):>2} {dur} "
              f"{ev.get('name', '?'):32s} {attrs}")
    return 0


def cmd_summarize(args) -> int:
    out: dict = {}
    ok = True
    if args.trace:
        report = validate_trace(args.trace)
        spans: dict[str, list[int]] = {}
        for ev in iter_trace(args.trace):
            if ev.get("ph") == "X" and "dur" in ev:
                spans.setdefault(str(ev["name"]), []).append(int(ev["dur"]))
        report["spans"] = {
            name: {
                "count": len(durs),
                "total_ms": round(sum(durs) / 1e3, 3),
                "max_ms": round(max(durs) / 1e3, 3),
            }
            for name, durs in sorted(spans.items())
        }
        if args.require_spans:
            missing = [s for s in args.require_spans.split(",")
                       if s and s not in spans]
            report["missing_spans"] = missing
            ok = ok and not missing
        if args.perfetto:
            report["perfetto"] = {
                "path": args.perfetto,
                "events": export_chrome_trace(args.trace, args.perfetto),
            }
        ok = ok and report["ok"]
        out["trace"] = report
    if args.metrics:
        snap = read_snapshot_file(args.metrics)
        out["metrics"] = {
            "counters": snap.get("counters", []),
            "histograms": summarize_histograms(snap),
        }
    if not out:
        print(json.dumps({"error": "nothing to summarize: pass --trace "
                                    "and/or --metrics"}))
        return 2
    print(json.dumps(out, indent=2))
    return 0 if ok else 1


def cmd_serve(args) -> int:
    if args.file:
        source = lambda: read_snapshot_file(args.file)  # noqa: E731 — re-read per scrape
    else:
        source = None  # live default registry (in-process embedding)
    server = ObsServer(source=source, host=args.host, port=args.port)
    print(json.dumps({"serving": server.url,
                      "endpoints": ["/metrics", "/snapshot"],
                      "file": args.file}))
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro-obs", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("snapshot", help="print a merged metrics snapshot")
    p.add_argument("--file", default=None, help="metrics snapshot JSONL")
    p.add_argument("--url", default=None, help="live /snapshot endpoint to scrape")
    p.add_argument("--prom", action="store_true",
                   help="print Prometheus text instead of JSON")

    p = sub.add_parser("tail", help="print the last N trace events")
    p.add_argument("--trace", required=True)
    p.add_argument("-n", type=int, default=20)

    p = sub.add_parser("summarize",
                       help="validate a trace / summarize metrics histograms")
    p.add_argument("--trace", default=None)
    p.add_argument("--metrics", default=None, help="metrics snapshot JSONL")
    p.add_argument("--perfetto", default=None, metavar="OUT",
                   help="also export a Perfetto-loadable trace JSON")
    p.add_argument("--require-spans", default=None, metavar="A,B,...",
                   help="exit non-zero unless every named span is present")

    p = sub.add_parser("serve", help="serve /metrics + /snapshot over HTTP")
    p.add_argument("--file", default=None,
                   help="snapshot JSONL to serve (merged, re-read per scrape)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8710)

    args = ap.parse_args(argv)
    if args.cmd == "snapshot":
        if not args.file and not args.url:
            ap.error("snapshot needs --file and/or --url")
        return cmd_snapshot(args)
    if args.cmd == "tail":
        return cmd_tail(args)
    if args.cmd == "summarize":
        return cmd_summarize(args)
    return cmd_serve(args)


if __name__ == "__main__":
    raise SystemExit(main())
