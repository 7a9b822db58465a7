"""Replace the chunked-attention path with the port's flash kernel
(``kernels/flash_attention.py``, ``csrc/flash_attention.cu``) and recompute
a cell's roofline memory term — the counterpart of
``benchmarks/flash_adjust.py``.

Method (structural, as the reference's):
  1. count the bytes of the port's plain chunked attention
     (``models.attention.gqa_attention``), forward and forward+backward, at
     the cell's per-device/per-microbatch geometry with the op-level
     counter (``perf.op_cost.step_cost`` on meta tensors) -> A_fwd, A_fwdbwd;
  2. the flash kernel's traffic for the same geometry is its byte model
     (``flash_hbm_bytes``: the kernel's tiles, padded head size and one
     launch per query head); the backward re-streams k/v and writes
     dq/dk/dv: ~4x the forward traffic, still O(S);
  3. adjusted memory term = baseline - L * accum * (A_chunked - A_flash) / HBM_bw.

The kernel itself is held against its plain version in
tests/test_torch_attention.py and on the card in chip_smoke.py; this file
only does the accounting.

    PYTHONPATH=src:. python -m benchmarks.torch_flash_adjust --arch qwen2-0.5b
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_hbm_bytes
from repro_torch.models.attention import gqa_attention
from repro_torch.perf.op_cost import step_cost
from repro_torch.perf.roofline import HW


def attention_traffic(B, S, H, K, hd, chunk=512, dtype=torch.bfloat16):
    """Counted bytes of the chunked attention, fwd and fwd+bwd, at the given
    per-device geometry (meta tensors: nothing is allocated)."""
    def meta(*shape):
        return torch.empty(shape, dtype=dtype, device="meta", requires_grad=True)

    q, k, v = meta(B, S, H, hd), meta(B, S, K, hd), meta(B, S, K, hd)

    def fwd(q, k, v):
        return gqa_attention(q, k, v, causal=True, chunk=chunk).sum()

    def fwd_bwd(q, k, v):
        with torch.enable_grad():
            return torch.autograd.grad(fwd(q, k, v), (q, k, v))

    with torch.no_grad():
        a_fwd = step_cost(fwd, q, k, v).bytes
    a_fwdbwd = step_cost(fwd_bwd, q, k, v).bytes
    return a_fwd, a_fwdbwd


def adjust(arch: str, baseline_mem_sec: float, baseline_compute_sec: float,
           baseline_coll_sec: float, accum: int, mesh_model: int = 16,
           mesh_data: int = 16, global_batch: int = 256, S: int = 4096,
           layers: int | None = None):
    """``layers``: the depth the baseline was traced at (a hillclimb run
    with its depth cut), the config's own by default."""
    cfg = get_config(arch)
    # per-device, per-microbatch geometry (heads over model, batch over data)
    B_micro = max(global_batch // mesh_data // accum, 1)
    H_loc = max(cfg.n_heads // mesh_model, 1)
    K_loc = max(cfg.n_kv_heads // mesh_model, 1)
    hd = cfg.hd

    a_fwd, a_fwdbwd = attention_traffic(B_micro, S, H_loc, K_loc, hd)
    # remat=full replays the forward once during the backward pass
    a_xla_layer = a_fwdbwd + a_fwd

    f_fwd = flash_hbm_bytes(B_micro, H_loc, K_loc, S, S, hd, dtype_bytes=2, causal=True)
    f_layer = 4.0 * f_fwd  # fwd + bwd(re-stream k/v, write dq/dk/dv)

    L = layers or cfg.n_layers
    saved = L * accum * (a_xla_layer - f_layer)
    adj_mem = baseline_mem_sec - saved / HW.hbm_bw
    before_bound = max(baseline_mem_sec, baseline_compute_sec, baseline_coll_sec)
    after_bound = max(adj_mem, baseline_compute_sec, baseline_coll_sec)
    return {
        "arch": arch,
        "attention_xla_bytes_per_layer_micro": a_xla_layer,
        "attention_flash_bytes_per_layer_micro": f_layer,
        "traffic_ratio": a_xla_layer / max(f_layer, 1),
        "memory_sec_before": baseline_mem_sec,
        "memory_sec_after": adj_mem,
        "bound_before": before_bound,
        "bound_after": after_bound,
        "speedup": before_bound / max(after_bound, 1e-12),
        "roofline_fraction_after": baseline_compute_sec / max(after_bound, 1e-12),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--hillclimb-json", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    hc = args.hillclimb_json or f"results/hillclimb_torch_{args.arch}_train_4k.json"
    with open(hc) as f:
        d = json.load(f)
    base = d["baseline"]
    accum = int(base["config"].get("accum", 8))
    out = adjust(args.arch, base["memory_sec"], base["compute_sec"],
                 base["collective_sec"], accum, layers=d.get("layers"))
    print(json.dumps(out, indent=2))
    path = args.out or f"results/flash_adjust_torch_{args.arch}.json"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
