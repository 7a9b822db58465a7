"""The model matmul's routes on the card, timed at the served shapes.

Times ``repro_torch.kernels.matmul.tiled_matmul`` on bf16 operands (or f32
with ``--dtype f32``) at the serving default config
(``kernels.ops.DEFAULTS["matmul"]``: 64x64 tiles, a k chunk of 32, packed;
``--tile bm,bn,bk`` for another tile) at every product shape of ``PERF.md``'s
kernel table, rows 2a to 2ab: the catalog's decode steps (4 rows: output
projections and unembeds) and forwards (batch 4 x the prompt), f32 rows 2a-2u
with ``--dtype f32`` and bf16 rows 2v-2ab by default; each beside
``torch.matmul`` in the dtype (TF32 off) and the function's bound (the
larger of its bytes at the card's memory rate and its products at the
route's peak: the tensor cores' for the dtype past 8 rows, bf16 or 3xTF32,
the CUDA cores' FFMA at 4 rows). Each row names the route the tree's kernel
reported where its wrapper counts them (``tiled_matmul.route_launches``).

``--src`` picks the checkout whose ``repro_torch`` is imported (and built
into its own ``kernels/build``), so that two trees are timed on one card in
one run: unpack the other commit with ``git archive`` into an ignored
directory and run, in one session, the old tree, the new, the new again and
the old again::

    python benchmarks/torch_matmul_routes.py --src OLD/src --label parent
    python benchmarks/torch_matmul_routes.py --src src --label change

Each run prints the card (``nvidia-smi --query-gpu=name,power.limit``) and
one JSON object a shape. Each call is timed queued behind a spin, between
two CUDA events (CUDA events around back-to-back calls where the host fell
behind the spin)."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (row of PERF.md's kernel table, arch, product, K, N, forward rows): the
# decode step's 4 rows and the forward's (batch 4 x the prompt: 128, 64 for
# whisper, 520 for gemma3, 256 for qwen2's f32 prefill)
F32_PRODUCTS = (
    ("2a", "qwen2-0.5b", "tied unembed", 896, 151_936, None),
    ("2b", "qwen2-0.5b", "output projection", 896, 896, None),
    ("2c", "qwen2-0.5b", "prefill unembed", 896, 151_936, 1024),
    ("2d", "mixtral-8x7b", "output projection", 4096, 4096, None),
    ("2e", "mixtral-8x7b", "unembed", 4096, 32_000, None),
    ("2f", "deepseek-v2-236b", "unembed", 5120, 102_400, None),
    ("2g", "mixtral-8x7b", "forward output projection", 4096, 4096, 512),
    ("2h", "mixtral-8x7b", "forward unembed", 4096, 32_000, 512),
    ("2i", "deepseek-v2-236b", "forward unembed", 5120, 102_400, 512),
    ("2j", "mamba2-780m", "unembed", 1536, 50_280, 512),
    ("2k", "zamba2-1.2b", "output projection", 2048, 2048, 512),
    ("2l", "zamba2-1.2b", "unembed", 2048, 32_000, 512),
    ("2m", "qwen2-vl-7b", "output projection", 3584, 3584, 512),
    ("2n", "qwen2-vl-7b", "unembed", 3584, 152_064, 512),
    ("2o", "whisper-large-v3", "unembed", 1280, 51_866, 256),
    ("2p", "gemma3-1b", "output projection", 1024, 1152, 2080),
    ("2q", "gemma3-1b", "tied unembed", 1152, 262_144, 2080),
    ("2r", "minitron-4b", "output projection", 3072, 3072, 512),
    ("2s", "minitron-4b", "unembed", 3072, 256_000, 512),
    ("2t", "qwen1.5-0.5b", "output projection", 1024, 1024, 512),
    ("2u", "qwen1.5-0.5b", "tied unembed", 1024, 151_936, 512),
)
BF16_PRODUCTS = (
    ("2v", "qwen2-0.5b", "output projection", 896, 896, 512),
    ("2w", "qwen2-0.5b", "tied unembed", 896, 151_936, 512),
    ("2x", "qwen2-vl-7b", "output projection", 3584, 3584, 512),
    ("2y", "qwen2-vl-7b", "unembed", 3584, 152_064, 512),
    ("2z", "mixtral-8x7b", "output projection", 4096, 4096, 512),
    ("2aa", "mixtral-8x7b", "unembed", 4096, 32_000, 512),
    ("2ab", "mamba2-780m", "unembed", 1536, 50_280, 512),
)


def shapes(dtype: str):
    """(row, label, M, K, N) of the dtype's rows: the decode's 4 rows where
    the row is a decode product, and the forward's rows where it has one
    (2c, 2g-2i: the forward alone)."""
    out = []
    for row, arch, what, K, N, fwd in (BF16_PRODUCTS if dtype == "bf16" else F32_PRODUCTS):
        if not what.startswith(("forward", "prefill")):
            out.append((row, f"{arch} decode {what} (4 rows)", 4, K, N))
        if fwd is not None:
            name = what if what.startswith(("forward", "prefill")) else f"forward {what}"
            out.append((row, f"{arch} {name} ({fwd} rows)", fwd, K, N))
    return tuple(out)


def queued_ms(fn, calls: int = 10, spin_cycles: int = 20_000_000) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    queued = not start.query()
    end.synchronize()
    if queued:
        return start.elapsed_time(end) / calls
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default="src", help="the checkout's src directory")
    ap.add_argument("--label", default="", help="a name for the tree in each row")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--tile", default=None,
                    help="bm,bn,bk instead of the serving default's tile")
    ap.add_argument("--rows", default="all", choices=("all", "decode", "forward"),
                    help="the decode's 4-row products, the forward's, or both")
    ap.add_argument("--build-only", action="store_true",
                    help="build the tree's matmul library and exit")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    from repro_torch.kernels import build, cost, ops
    from repro_torch.kernels.matmul import tiled_matmul

    if not torch.cuda.is_available():
        print("torch_matmul_routes: no card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    build.build_all(["matmul"])
    if args.build_only:
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    cfg = dict(ops.DEFAULTS["matmul"])
    if args.tile:
        cfg.update(zip(("bm", "bn", "bk"), (int(v) for v in args.tile.split(","))))
    print(f"{args.label}: {card}; torch {torch.__version__}; tiled_matmul {cfg}", flush=True)
    dev = torch.device("cuda")
    dtype, tc_peak = ((torch.bfloat16, cost.BF16_FLOPS) if args.dtype == "bf16"
                      else (torch.float32, cost.TF32X3_FLOPS))
    g = torch.Generator(device=dev).manual_seed(0)
    for row, label, M, K, N in shapes(args.dtype):
        if args.rows != "all" and (M <= 8) != (args.rows == "decode"):
            continue
        a = (torch.randn(M, K, generator=g, device=dev) / K ** 0.5).to(dtype)
        b = (torch.randn(K, N, generator=g, device=dev) / N ** 0.5).to(dtype)
        counts = getattr(tiled_matmul, "route_launches", None)
        before = dict(counts) if counts is not None else None
        tiled_matmul(a, b, **cfg)
        route = ([k for k, v in tiled_matmul.route_launches.items() if v != before[k]][0]
                 if before is not None else None)
        ms = queued_ms(lambda: tiled_matmul(a, b, **cfg))
        lib_ms = queued_ms(lambda: torch.matmul(a, b))
        flops, nbytes = 2.0 * M * K * N, a.element_size() * (M * K + K * N + M * N)
        ops_ms = flops / (tc_peak if M > 8 else cost.FFMA_FLOPS) * 1e3
        bytes_ms = nbytes / cost.HBM_BYTES_PER_SEC * 1e3
        print(json.dumps(dict(
            tree=args.label, dtype=args.dtype, row=row, shape=label, M=M, K=K, N=N,
            tile=[cfg["bm"], cfg["bn"], cfg["bk"]], route=route, ms=ms, torch_matmul_ms=lib_ms,
            bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms > bytes_ms
            else "bytes", card=card)), flush=True)
        del a, b
    return 0


if __name__ == "__main__":
    sys.exit(main())
