"""Perf hillclimb of the port: drive the dominant roofline term down on
chosen cells by autotuning the distributed-config knob space with the
paper's BO engine (backend B2 objective = the roofline bound of the traced
step on the production mesh, with a feasibility penalty against the card's
memory) — the counterpart of ``benchmarks/hillclimb.py``.

This is the paper's method applied one level up — the "application/system
parameters" extension its Sec. 5 proposes as future work. Each evaluation
builds the cell on a fake world of 256 (or 512) ranks, traces one step
without allocating, and scores it with the Hopper roofline
(``repro_torch.core.CostModelEvaluator``).

Usage:
  PYTHONPATH=src:. python -m benchmarks.torch_hillclimb --arch qwen2-0.5b \\
      --shape train_4k --evals 12
  PYTHONPATH=src:. python -m benchmarks.torch_hillclimb --arch qwen2-0.5b \\
      --shape train_4k --probe
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import multiprocessing
import os


def knob_space(kind: str, is_moe: bool, seed: int = 1234):
    from repro_torch.core.space import Categorical, ConfigurationSpace, Ordinal

    cs = ConfigurationSpace(seed=seed)
    if kind == "train":
        cs.add_hyperparameters([
            Ordinal("accum", (1, 2, 4, 8, 16), default=8),
            Categorical("remat", ("none", "dots", "full"), default="full"),
            Ordinal("attn_chunk", (256, 512, 1024, 2048), default=512),
            Categorical("attn_f32", (True, False), default=True),
            Categorical("moment_dtype", ("float32", "bfloat16"),
                        default="float32"),
            Categorical("seq_parallel", (False, True), default=False),
        ])
    else:
        cs.add_hyperparameters([
            Ordinal("attn_chunk", (256, 512, 1024, 2048), default=512),
            Categorical("attn_f32", (True, False), default=True),
            Categorical("mla_absorb", (True, False), default=True),
        ])
    if is_moe:
        cs.add_hyperparameters([
            Ordinal("moe_group", (512, 1024, 2048, 4096, 8192), default=2048),
            Ordinal("capacity_factor", (1.0, 1.25, 1.5, 2.0), default=1.25),
        ])
    return cs


def config_to_knobs(config: dict) -> dict:
    knobs: dict = {}
    overrides: dict = {}
    for k, v in config.items():
        if k in ("attn_f32", "moe_group", "capacity_factor"):
            overrides[k] = v
        elif k == "accum":
            knobs["accum"] = int(v)
        elif k == "attn_chunk":
            knobs["attn_chunk"] = int(v)
        else:
            knobs[k] = v
    if overrides:
        knobs["cfg_overrides"] = overrides
    return knobs


def _cell_evaluator(arch: str, shape: str, mesh, layers: int | None = None):
    """The cell's :class:`CostModelEvaluator` with its default score, the
    roofline bound of the traced step (``perf.roofline.score_cell``).
    ``layers`` cuts the model's depth (a test's small size)."""
    from repro_torch.core.plopper import CostModelEvaluator
    from repro_torch.launch.cells import plan_cell

    def factory(config):
        knobs = config_to_knobs(dict(config))
        if layers:
            knobs.setdefault("cfg_overrides", {})["n_layers"] = int(layers)
        return lambda: (plan_cell(arch, shape, mesh, knobs), mesh)

    return CostModelEvaluator(factory)


def _evaluate_in_own_world(arch: str, shape: str, multi_pod: bool, layers, config: dict):
    """One evaluation in a worker process, on a fake world of its own."""
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        return _cell_evaluator(arch, shape, mesh, layers)(config)


def make_cell_evaluator(arch: str, shape: str, mesh, log: list, layers: int | None = None,
                        workers=None, multi_pod: bool = False):
    """The cell's evaluator: the roofline bound, times (peak bytes / the
    card's memory)**2 where the peak per device does not fit (the
    reference's quadratic pressure penalty, against the card's memory).
    ``workers`` (a process pool) runs each evaluation in a worker process on
    a fake world of its own (``multi_pod`` picks it), so that evaluations
    overlap: one process has one fake world, and a trace holds the GIL.
    ``layers`` cuts the model's depth (a test's small size)."""
    from repro_torch.core.plopper import EvalResult
    from repro_torch.perf.roofline import hardware

    hbm = hardware().memory_bytes
    inner = None if workers is not None else _cell_evaluator(arch, shape, mesh, layers)

    def evaluate(config):
        if inner is None:
            res = workers.submit(_evaluate_in_own_world, arch, shape, multi_pod, layers,
                                 dict(config)).result()
        else:
            res = inner(config)
        if not res.ok:
            log.append(dict(config=dict(config), error=res.info["error"]))
            return res
        dev_bytes = res.info["peak_memory_per_device"]
        obj = res.objective
        feasible = dev_bytes <= hbm
        if not feasible:  # quadratic pressure penalty: the OOM analog
            obj = obj * (dev_bytes / hbm) ** 2
        info = dict(objective=obj, feasible=feasible, device_bytes=dev_bytes, **res.info)
        log.append(dict(config=dict(config), **info))
        return EvalResult(obj, True, info)

    return evaluate


@contextlib.contextmanager
def _world(multi_pod: bool, parallel: int):
    """(mesh, workers): the production mesh on a fake world in this process
    and, for ``parallel`` > 1, a pool of that many worker processes."""
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        if parallel <= 1:
            yield mesh, None
            return
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(parallel, mp_context=ctx) as pool:
            yield mesh, pool


PROBES = [
    # hypothesis ladder: each row is one lower+compile (see EXPERIMENTS §Perf)
    ("baseline", {}),
    ("seq-parallel residual (activation mem & traffic / model-axis)",
     {"seq_parallel": True}),
    ("seq-parallel + bf16 moments (halve optimizer HBM)",
     {"seq_parallel": True, "moment_dtype": "bfloat16"}),
    ("seq-parallel + bf16 moments + accum 4 (fewer grad passes)",
     {"seq_parallel": True, "moment_dtype": "bfloat16", "accum": 4}),
    ("+ bf16 attention scores",
     {"seq_parallel": True, "moment_dtype": "bfloat16", "attn_f32": False}),
    ("+ tight MoE dispatch (group 1024, cf 1.0)",
     {"seq_parallel": True, "moment_dtype": "bfloat16",
      "moe_group": 1024, "capacity_factor": 1.0}),
]


def _mesh_name(mesh) -> str:
    return "x".join(map(str, tuple(mesh.shape)))


def run_probe(arch: str, shape: str, out: str, multi_pod: bool = False,
              parallel: int = 1, layers: int | None = None):
    """Hypothesis -> change -> re-trace -> record, one trace per row (the
    rows in ``parallel`` worker processes at once)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    with _world(multi_pod, parallel) as (mesh, workers):
        log: list = []
        ev = make_cell_evaluator(arch, shape, mesh, log, layers=layers, workers=workers,
                                 multi_pod=multi_pod)
        space = knob_space("train", is_moe=cfg.n_experts > 0)
        default = space.default_configuration()

        probes = []
        for label, delta in PROBES:
            if ("moe_group" in delta or "capacity_factor" in delta) and not cfg.n_experts:
                continue
            config = dict(default)
            config.update({k: v for k, v in delta.items() if k in default})
            probes.append((label, config))
        with concurrent.futures.ThreadPoolExecutor(max(parallel, 1)) as rows_in_flight:
            results = list(rows_in_flight.map(lambda p: ev(p[1]), probes))
        mesh_name = _mesh_name(mesh)

    rows = []
    for (label, config), res in zip(probes, results):
        row = dict(config=config, **(res.info if res.ok else {"error": res.info["error"]}))
        row["hypothesis"] = label
        rows.append(row)
        r = row if "error" not in row else {}
        print(f"  [{label[:52]:52s}] obj={row.get('objective', float('nan')):9.3f}"
              f" mem={r.get('memory_sec', 0):8.3f} coll={r.get('collective_sec', 0):7.3f}"
              f" bytes={r.get('device_bytes', 0)/1e9:6.1f}GB feas={r.get('feasible')}",
              flush=True)
    ok = [r for r in rows if "error" not in r]
    if not ok:
        raise RuntimeError(f"every probe of {arch} x {shape} failed: {rows[0]['error']}")
    best = min(ok, key=lambda r: r["objective"])
    payload = {"arch": arch, "shape": shape, "mode": "probe",
               "mesh": mesh_name, "layers": layers or cfg.n_layers,
               "baseline": rows[0], "best": best,
               "improvement": (rows[0]["objective"] - best["objective"])
               / max(rows[0]["objective"], 1e-12),
               "log": rows}
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"[probe] {arch} x {shape}: baseline {rows[0]['objective']:.3f}s -> "
          f"best {best['objective']:.3f}s ({payload['improvement']*100:.1f}%) "
          f"[{best['hypothesis']}]")
    return payload


def run(arch: str, shape: str, evals: int, out: str, multi_pod: bool = False,
        learner: str = "RF", parallel: int = 1, db_path: str | None = None,
        layers: int | None = None):
    """Thin adapter over :class:`repro_torch.engine.Campaign`: the campaign
    owns warm-start, budget, and (with ``db_path``) crash-safe resume; this
    driver only builds the evaluator and reports the payload. ``parallel``
    > 1 keeps that many evaluations in flight (the campaign's constant-liar
    batches), each in a worker process with a fake world of its own."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.engine import Campaign

    cfg = get_config(arch)
    kind = SHAPES[shape].kind
    with _world(multi_pod, parallel) as (mesh, workers):
        log: list = []
        ev = make_cell_evaluator(arch, shape, mesh, log, layers=layers, workers=workers,
                                 multi_pod=multi_pod)
        space = knob_space(kind, is_moe=cfg.n_experts > 0)

        # paper-faithful baseline first: the space's defaults, warm-starting the
        # search so 'best' can never regress below the known default schedule
        baseline_cfg = space.default_configuration()
        ev(baseline_cfg)
        baseline = dict(log[-1])
        if "error" in baseline:
            raise RuntimeError(f"the baseline of {arch} x {shape} failed: {baseline['error']}")

        res = Campaign(space, ev, max_evals=evals, learner=learner, seed=1234,
                       n_initial=max(4, evals // 3), parallel=parallel,
                       db_path=db_path, warm_start=[baseline_cfg]).run()
        mesh_name = _mesh_name(mesh)
    best = res.best
    payload = {
        "arch": arch, "shape": shape,
        "mesh": mesh_name, "layers": layers or cfg.n_layers,
        "baseline": baseline,
        "best": {"config": best.config, "objective": best.objective,
                 "info": best.info},
        "improvement": (baseline["objective"] - best.objective)
        / max(baseline["objective"], 1e-12),
        "log": log,
    }
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(payload, f, indent=1, default=str)
    print(f"[hillclimb] {arch} x {shape}: baseline {baseline['objective']:.4f}s"
          f" -> best {best.objective:.4f}s "
          f"({payload['improvement']*100:.1f}% better) config={best.config}")
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--evals", type=int, default=12)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--learner", default="RF")
    ap.add_argument("--parallel", type=int, default=1,
                    help="evaluations in flight, each in a worker process")
    ap.add_argument("--db", default=None,
                    help="campaign checkpoint dir (resume a killed hillclimb)")
    ap.add_argument("--probe", action="store_true",
                    help="hypothesis-ladder mode: one trace per probe")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = args.out or f"results/hillclimb_torch_{args.arch}_{args.shape}.json"
    if args.probe:
        return run_probe(args.arch, args.shape, out, args.multi_pod, args.parallel)
    return run(args.arch, args.shape, args.evals, out, args.multi_pod,
               args.learner, parallel=args.parallel, db_path=args.db)


if __name__ == "__main__":
    main()
