"""Roofline table generator of the port: results/dryrun_torch.json (written
by ``python -m repro_torch.launch.dryrun``) -> CSV rows and the markdown
roofline table, the counterpart of ``benchmarks/roofline_table.py`` (same
columns; "6ND/HLO" is the reference's name of the useful-FLOPs column, here
model FLOPs over the FLOPs the op-level counter counted).

    PYTHONPATH=src:. python -m benchmarks.torch_roofline_table [16x16|2x16x16]
"""

from __future__ import annotations

import json
import os

DRYRUN_JSON = os.environ.get("REPRO_TORCH_DRYRUN_JSON", "results/dryrun_torch.json")


def load(path: str = DRYRUN_JSON):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return json.load(f)


def csv_rows(path: str = DRYRUN_JSON, mesh: str = "16x16"):
    rows = []
    for r in load(path):
        if r.get("mesh") != mesh:
            continue
        name = f"roofline/{r['arch']}/{r['shape']}"
        if r["status"] != "ok":
            rows.append((name, 0.0, r.get("reason", r.get("error", r["status"]))))
            continue
        rf = r["roofline"]
        rows.append((
            name,
            rf["bound_sec"] * 1e6,
            f"dominant={rf['dominant']};frac={rf['roofline_fraction']:.3f};"
            f"useful={rf['useful_flops_ratio'] and round(rf['useful_flops_ratio'], 3)}",
        ))
    return rows


def markdown(path: str = DRYRUN_JSON, mesh: str = "16x16") -> str:
    out = [
        f"| arch | shape | compute s | memory s | collective s | dominant | "
        f"roofline frac | 6ND/HLO | bytes/dev | note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in load(path):
        if r.get("mesh") != mesh:
            continue
        if r["status"] != "ok":
            out.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | — | — | — | — | "
                f"{r.get('reason', r.get('error', r['status']))[:60]} |")
            continue
        rf = r["roofline"]
        u = rf["useful_flops_ratio"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_sec']:.4g} | "
            f"{rf['memory_sec']:.4g} | {rf['collective_sec']:.4g} | "
            f"{rf['dominant']} | {rf['roofline_fraction']:.3f} | "
            f"{u and round(u, 3)} | {rf['bytes_per_device']:.3g} | |")
    return "\n".join(out)


if __name__ == "__main__":
    import sys
    mesh = sys.argv[1] if len(sys.argv) > 1 else "16x16"
    print(markdown(mesh=mesh))
