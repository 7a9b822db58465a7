"""The model matmul's routes on the card, timed at the served shapes.

Times ``repro_torch.kernels.matmul.tiled_matmul`` on bf16 operands (or f32
with ``--dtype f32``) at the serving default config
(``kernels.ops.DEFAULTS["matmul"]``: 64x64 tiles, a k chunk of 32, packed)
at the product shapes the catalog's bf16 models serve: the decode step's
4 rows and the forward's 512 (batch 4, prompt 128), each beside
``torch.matmul`` in the dtype (TF32 off) and the function's bound (the
larger of its bytes at the card's memory rate and its products at the
tensor-core peak for the dtype: bf16, or 3xTF32 for f32).
Forward rows take the tensor cores where the tree's ``csrc/matmul.cu``
routes them there, and the FFMA loop where it does not; decode rows take
the FFMA loop in either.

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

# (label, M, K, N): the output projections and unembeds of qwen2-0.5b,
# qwen2-vl-7b, mixtral-8x7b and mamba2-780m, at a decode step's rows and a
# forward's
SHAPES = tuple(
    (f"{arch} {what} ({rows} rows)", rows, K, N)
    for arch, what, K, N in (
        ("qwen2-0.5b", "output projection", 896, 896),
        ("qwen2-0.5b", "tied unembed", 896, 151_936),
        ("qwen2-vl-7b", "output projection", 3584, 3584),
        ("qwen2-vl-7b", "unembed", 3584, 152_064),
        ("mixtral-8x7b", "output projection", 4096, 4096),
        ("mixtral-8x7b", "unembed", 4096, 32_000),
        ("mamba2-780m", "unembed", 1536, 50_280),
    )
    for rows in (4, 512))


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
    print(f"{args.label}: {card}; torch {torch.__version__}; tiled_matmul {cfg}", flush=True)
    dev = torch.device("cuda")
    dtype, peak = ((torch.bfloat16, cost.BF16_FLOPS) if args.dtype == "bf16"
                   else (torch.float32, cost.TF32X3_FLOPS))
    g = torch.Generator(device=dev).manual_seed(0)
    for label, M, K, N in SHAPES:
        a = (torch.randn(M, K, generator=g, device=dev) / K ** 0.5).to(dtype)
        b = (torch.randn(K, N, generator=g, device=dev) / N ** 0.5).to(dtype)
        ms = queued_ms(lambda: tiled_matmul(a, b, **cfg))
        lib_ms = queued_ms(lambda: torch.matmul(a, b))
        flops, nbytes = 2.0 * M * K * N, a.element_size() * (M * K + K * N + M * N)
        ops_ms = flops / peak * 1e3
        bytes_ms = nbytes / cost.HBM_BYTES_PER_SEC * 1e3
        print(json.dumps(dict(
            tree=args.label, dtype=args.dtype, shape=label, M=M, K=K, N=N, ms=ms,
            torch_matmul_ms=lib_ms,
            bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms > bytes_ms
            else "bytes", ffma_ops_ms=flops / cost.FFMA_FLOPS * 1e3, card=card)), flush=True)
        del a, b
    return 0


if __name__ == "__main__":
    sys.exit(main())
