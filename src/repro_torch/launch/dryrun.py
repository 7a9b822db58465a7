"""Multi-pod dry-run: build every (architecture x input-shape x mesh) cell
with its params and inputs placed by the sharding rules, trace its step
without allocating (meta shards on a fake world of 256 / 512 ranks, in
place of the reference's ``XLA_FLAGS`` line), and record the per-device
cost, peak memory, Hopper roofline and whether the cell fits the card to a
JSON results file — the counterpart of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape decode_32k --mesh local            # the card's own (1, 1) mesh

Results append incrementally to --out (crash-safe: rerunning skips done
cells unless --force). Rows traced without a card use the H100 SXM5's
data-sheet figures (``perf.roofline.HW``); on a card, its own memory.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import ARCHS, SHAPES, cell_supported, get_config
from repro_torch.launch.cells import plan_cell
from repro_torch.launch.mesh import fake_world, local_mesh, make_production_mesh, mesh_name
from repro_torch.perf.roofline import trace_cell

__all__ = ["run_cell", "main"]


def run_cell(arch: str, shape_name: str, mesh, knobs: dict | None = None) -> dict:
    """One row: trace the cell on ``mesh`` (a mesh over the current world)."""
    cfg = get_config(arch)
    ok, reason = cell_supported(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
                "status": "skipped", "reason": reason}
    t0 = time.perf_counter()
    plan = plan_cell(arch, shape_name, mesh, knobs)
    trace, rep = trace_cell(plan, mesh)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name(mesh),
        "status": "ok",
        "seconds": {"build_and_trace": round(time.perf_counter() - t0, 1)},
        "knobs": dict(plan.knobs),
        "memory_analysis": {
            "argument_bytes": trace.arg_bytes,
            "temp_bytes": trace.peak_bytes - trace.arg_bytes,
            "peak_bytes": trace.peak_bytes,
        },
        "roofline": rep.row(),
        "fits_card": rep.fits_card,
        "ops": trace.ops,
    }


def _summary(row: dict) -> str:
    if row["status"] != "ok":
        return ""
    r = row["roofline"]
    u = r["useful_flops_ratio"]
    by_kind = ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in
                        sorted(r["collective_bytes_by_kind"].items())) or "none"
    return (f" dominant={r['dominant']} bound={r['bound_sec']:.4f}s"
            f" frac={r['roofline_fraction']:.2f} 6ND/counted={u and round(u, 3)}"
            f" collectives[{by_kind}]"
            f" peak/dev={r['peak_memory_per_device'] / 1e9:.2f}GB fits_card={row['fits_card']}")


def _meshes(args) -> list:
    """(name, world context factory, mesh factory) for each mesh to run."""
    if args.mesh == "local":
        return [("1x1", lambda: local_mesh(args.device), None)]
    pods = [False, True] if args.both_meshes else [args.multi_pod]
    return [("2x16x16" if mp else "16x16", lambda mp=mp: fake_world(512 if mp else 256),
             lambda mp=mp: make_production_mesh(multi_pod=mp)) for mp in pods]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the (2,16,16) 512-rank mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run each cell on single-pod AND multi-pod meshes")
    ap.add_argument("--all", action="store_true", help="all 40 cells")
    ap.add_argument("--mesh", choices=("production", "local"), default="production",
                    help="production: the (16,16)/(2,16,16) meshes over a fake world "
                         "(no device); local: the process's own (1,1) mesh")
    ap.add_argument("--device", default="cuda",
                    help="the local mesh's device (cuda, or cpu over gloo)")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--force", action="store_true", help="redo finished cells")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done: dict = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            for row in json.load(f):
                done[(row["arch"], row["shape"], row["mesh"])] = row
    results = list(done.values())

    n_fail = 0
    for name, world, make_mesh in _meshes(args):
        todo = [(a, s) for a in archs for s in shapes if (a, s, name) not in done]
        for a, s in [(a, s) for a in archs for s in shapes if (a, s, name) in done]:
            print(f"[skip-done] {(a, s, name)}")
        if not todo:
            continue
        with world() as local:
            mesh = local if make_mesh is None else make_mesh()
            for arch, shape in todo:
                print(f"[dryrun] {arch} x {shape} x {name} ...", flush=True)
                try:
                    row = run_cell(arch, shape, mesh)
                except Exception as e:  # noqa: BLE001 — a failed cell is a row
                    row = {"arch": arch, "shape": shape, "mesh": name,
                           "status": "error", "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc(limit=5)}
                    n_fail += 1
                results.append(row)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                print(f"[{row['status']}] {arch} x {shape} x {name}{_summary(row)}",
                      flush=True)

    print(f"done: {len(results)} rows, {n_fail} failures -> {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
