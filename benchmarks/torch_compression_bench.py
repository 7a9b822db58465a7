"""Gradient-compression traffic measurement of the port: a data-parallel
training step (replicated params, the batch split over the ``data``
ranks) whose gradients are all-reduced with an f32, bf16 or int8 payload,
counted by the op-level counter (``repro_torch.perf.op_cost.step_cost``) on
a fake world of 8 ranks — the counterpart of
``benchmarks/compression_bench.py``. The wire bytes per parameter must be
about 4 / 2 / 1 (the int8 path adds one scalar max a leaf), which is the
collective-term lever for collective-bound cells.

Error-feedback correctness of the compressed path is covered by
tests/test_torch_ckpt_ft.py; this file quantifies the traffic.

    PYTHONPATH=src:. python -m benchmarks.torch_compression_bench
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch
import torch.distributed as dist

MODES = ("f32", "bf16", "int8")
WORLD = 8
BATCH = (16, 64)   # global (sequences, tokens), the reference's


def build_step(cfg, mode: str):
    """Per-rank DP step: loss and gradients on this rank's rows, then each
    gradient leaf summed over the world with a ``mode`` payload; returns
    (mean loss over the world, reduced gradients)."""
    from repro_torch.ft.compression import compressed_psum
    from repro_torch.models.model import loss_fn
    from repro_torch.tree import tree_leaves, tree_unflatten

    def reduce_leaf(g):
        g32 = g.float()
        if mode == "f32":
            dist.all_reduce(g32)
            return g32
        if mode == "bf16":
            return compressed_psum(g32, dtype=torch.bfloat16)
        return compressed_psum(g32, dtype=torch.int8)  # int8 + max-scale combine

    def per_shard(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            total, _ = loss_fn(tree_unflatten(params, leaves), batch, cfg)
            grads = torch.autograd.grad(total, leaves)
        grads = [reduce_leaf(g) for g in grads]
        loss = total.detach().clone()
        dist.all_reduce(loss)
        return loss / dist.get_world_size(), tree_unflatten(params, grads)

    return per_shard


def main(argv=None) -> dict:
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import fake_world
    from repro_torch.models.model import abstract_params
    from repro_torch.perf.op_cost import step_cost
    from repro_torch.tree import tree_leaves

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/compression_bench_torch.json")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_reduced("qwen1.5-0.5b"), dtype=torch.float32)
    params = abstract_params(cfg)
    n_params = sum(x.numel() for x in tree_leaves(params))
    rows = {}
    with fake_world(WORLD):
        local = (BATCH[0] // WORLD, BATCH[1])  # this rank's rows of the batch
        batch = {"tokens": torch.empty(local, dtype=torch.int32, device="meta"),
                 "labels": torch.empty(local, dtype=torch.int32, device="meta")}
        for mode in MODES:
            cost = step_cost(build_step(cfg, mode), params, batch)
            ar = cost.coll_by_kind.get("all-reduce", 0.0)
            rows[mode] = {"all_reduce_bytes": ar,
                          "bytes_per_param": ar / n_params,
                          "total_collective_bytes": cost.collective_bytes}
            print(f"{mode:5s} all-reduce payload: {ar/1e6:8.2f} MB "
                  f"({ar/n_params:5.2f} B/param)")

    r = rows
    print(f"bf16 saves {1 - r['bf16']['all_reduce_bytes']/r['f32']['all_reduce_bytes']:.0%}, "
          f"int8 saves {1 - r['int8']['all_reduce_bytes']/r['f32']['all_reduce_bytes']:.0%} "
          f"of gradient all-reduce traffic")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
