"""Cross-host TuningStore replication CLI — a copy of ``repro.launch.fleet``
on the port's modules.

    # one-shot anti-entropy cycle (pull + merge + push) through a shared dir
    python -m repro_torch.launch.fleet sync --store results/store \
        --transport file:/mnt/shared/fleet

    # push-only / pull-only halves of the cycle
    python -m repro_torch.launch.fleet push --store results/store --transport file:...
    python -m repro_torch.launch.fleet pull --store results/store --transport file:...

    # replication state: host id, version vector, pending ops, last-sync age
    python -m repro_torch.launch.fleet status --store results/store [--transport ...]

    # serve this host's oplog over localhost HTTP (peers use --transport
    # http://host:port); --interval N also runs the anti-entropy loop
    python -m repro_torch.launch.fleet serve --store results/store --port 8700

Transports: ``file:<dir>`` (shared directory, object-store idiom: one
append-only file per host) or ``http://host:port`` (a peer's ``serve``
endpoint). All commands print a JSON summary on stdout.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.dispatch import TuningStore
from repro_torch.fleet import Replica, SyncAgent, transport_from_spec


def _replica(args) -> Replica:
    return Replica(TuningStore(args.store))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.fleet", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, *, transport_required):
        p = sub.add_parser(name)
        p.add_argument("--store", required=True, help="TuningStore directory")
        p.add_argument("--transport", required=transport_required,
                       help="file:<dir> or http://host:port")
        return p

    add("push", transport_required=True)
    add("pull", transport_required=True)
    add("sync", transport_required=True)
    add("status", transport_required=False)
    serve = add("serve", transport_required=False)
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=8700)
    serve.add_argument("--interval", type=float, default=None, metavar="SEC",
                       help="also run the anti-entropy loop against "
                            "--transport every SEC seconds")
    args = ap.parse_args(argv)

    replica = _replica(args)
    transport = transport_from_spec(args.transport) if args.transport else None

    if args.cmd == "status":
        out = replica.status(transport)
        # an HTTP peer can report its own status (incl. the serving
        # process's obs histograms — the numbers that matter for a daemon
        # running `serve --interval`); file transports have no process to ask
        if transport is not None and hasattr(transport, "status"):
            try:
                out["peer"] = transport.status()
            except Exception as e:  # noqa: BLE001 — status must not fail hard
                out["peer"] = {"error": repr(e)}
        print(json.dumps(out, indent=2))
        return 0

    if args.cmd == "serve":
        from repro_torch.fleet import FleetServer

        agent = None
        if args.interval is not None:
            if transport is None:
                ap.error("--interval requires --transport")
            agent = SyncAgent(replica, transport,
                              interval_sec=args.interval).start()
        server = FleetServer(replica, host=args.host, port=args.port)
        print(json.dumps({"serving": server.url, "host": replica.host_id}))
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            if agent is not None:
                agent.stop()
            server.stop()
        return 0

    if args.cmd == "push":
        published = transport.push(replica.oplog)
        out = {"published": published, "pending": transport.pending(replica.oplog)}
    elif args.cmd == "pull":
        applied = replica.ingest(transport.pull(replica.oplog))
        out = {"applied": applied}
    else:  # sync: one full anti-entropy cycle
        out = SyncAgent(replica, transport).sync_once()
        if "error" in out:
            print(json.dumps(out, indent=2))
            return 1
    out["host"] = replica.host_id
    out["records"] = len(replica.store)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
