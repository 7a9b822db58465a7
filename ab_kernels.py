#!/usr/bin/env python3
"""Time kernels of two checkouts on one card, in turns: the serving path's
flash_attention, decode_attention and tiled matmul, the blocked
Floyd-Warshall (its trailing min-plus update, a phase-2 panel, its in-block
closure helper, the whole call), the blocked LU (its diagonal-factor helper,
the whole call) and heat3d (one pass, the whole call) at the paper's LARGE
sizes, and the matmul at the MoE forward's shapes and a sweep of K.

    python3 ab_kernels.py OLD_TREE NEW_TREE [--out FILE]

Each tree is the root of a checkout of this repository (for example the
parent commit unpacked with ``git archive`` into a git-ignored directory).
The script runs the trees in the order OLD, NEW, NEW, OLD, each in a
process of its own that imports that tree's ``repro_torch`` and builds its
kernels, and prints one JSON line per run and case: the kernel's time by
CUDA events over back-to-back calls (``ms``, after warm-up, L2-warm), its
device time per call under torch.profiler (``device_ms``) and the device
kernels it ran per call (``device_kernels``), at the shapes the main paths
give the kernels, at the default configs (``ops.DEFAULTS``). A matmul case
also gives its error against the f64 product of its inputs, the largest
over the output's root mean square (``err``), beside torch.matmul's
(``library_err``). A phase-2 panel
is launched as each tree's driver launches it. A case the tree's wrapper
refuses is printed with its reason. The card's name and power limit head the
output. TF32 is off.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys

# (name, kernel, shape): flash (BH, S, hd) causal f32; decode (BH, G, S, hd)
# f32; matmul (M, K, N) f32; the helpers (bs,) on a block of the LARGE
# problem, each call on a fresh copy (lu) or the same block (the closure of a
# closed block takes as long)
CASES = (
    ("flash LARGE causal", "flash_attention", (16, 4096, 128)),
    ("flash hd 256 causal", "flash_attention", (8, 2048, 256)),
    ("flash model prefill causal", "flash_attention", (8, 256, 64)),
    ("flash hd 320 causal", "flash_attention", (8, 2048, 320)),
    ("decode model bucket cur_pos 260", "decode_attention", (8, 7, 288, 64)),
    ("decode hd 320 cur_pos 260", "decode_attention", (8, 7, 288, 320)),
    ("matmul mm3 P x Q @ Q x R", "matmul", (800, 900, 1000)),
    ("matmul prefill unembed", "matmul", (1024, 896, 151936)),
    ("matmul decode unembed", "matmul", (4, 896, 151936)),
    ("matmul decode output projection", "matmul", (4, 896, 896)),
    ("matmul K 512", "matmul", (512, 512, 4096)),
    ("matmul mixtral forward output projection", "matmul", (512, 4096, 4096)),
    ("matmul mixtral forward unembed", "matmul", (512, 4096, 32000)),
    ("matmul deepseek forward unembed", "matmul", (512, 5120, 102400)),
    ("matmul K 8192", "matmul", (512, 8192, 4096)),
    ("minplus trailing update", "minplus", (2800, 64)),
    ("minplus row panel", "minplus_panel", (2800, 64)),
    ("closure helper bs 64", "closure", (64,)),
    ("closure helper bs 128", "closure", (128,)),
    ("closure helper bs 256", "closure", (256,)),
    ("floyd_warshall blocked", "floyd_warshall", (2800,)),
    ("lu_factor_diag helper bs 64", "lu_factor_diag", (64,)),
    ("lu_factor_diag helper bs 128", "lu_factor_diag", (128,)),
    ("lu blocked", "lu", (2000,)),
    ("heat3d one pass", "heat3d_pass", (120,)),
    ("heat3d 500 passes", "heat3d", (120, 500)),
)


def _child(tree: str) -> None:
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops, problems
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul import tiled_matmul
    from repro_torch.kernels.util import ConfigRejected

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    fcfg = {k: ops.DEFAULTS["flash_attention"][k] for k in ("bq", "bk")}
    mcfg = {k: v for k, v in ops.DEFAULTS["matmul"].items() if k != "impl"}

    def events_ms(fn, iters):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    def device_ms(fn, n=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        return (sum(e.self_device_time_total for e in events) / 1e3 / n,
                sum(e.count for e in events) / n)

    def minplus_case(kernel, shape):
        from repro_torch.kernels import floyd_warshall as fw

        N, bs = shape
        (W,) = problems.problem_inputs("floyd_warshall", (N,), dev)
        Np = -(-N // bs) * bs
        Wp = torch.nn.functional.pad(W, (0, Np - N, 0, Np - N), value=1e18)
        cfg = {k: v for k, v in ops.DEFAULTS["floyd_warshall"].items() if k != "bs"}
        if kernel == "minplus":
            col, row = Wp[:, :bs].contiguous(), Wp[:bs].contiguous()
            return (lambda: fw.minplus_update(Wp, col, row, **cfg)), cfg
        diag = Wp[:bs, :bs].contiguous()
        row = Wp[:bs]
        if "out" in inspect.signature(fw.minplus_update).parameters:  # in place, panel tiles
            pcfg = dict(bi=bs, bj=fw.PANEL_TILE, unroll=cfg["unroll"])
            return (lambda: fw.minplus_update(row, diag, row, out=row, **pcfg)), pcfg
        pcfg = dict(bi=min(bs, fw.MAX_TILE), bj=cfg["bj"], unroll=cfg["unroll"])
        return (lambda: fw.minplus_update(row, diag, row, **pcfg)), pcfg

    for name, kernel, shape in CASES:
        if kernel == "flash_attention":
            BH, S, hd = shape
            q, k, v = (torch.randn(BH, S, hd, device=dev, generator=g) for _ in range(3))
            fn = lambda: flash_attention(q, k, v, causal=True, **fcfg)  # noqa: E731
            cfg = fcfg
        elif kernel == "matmul":
            M, K, N = shape
            a = torch.randn(M, K, device=dev, generator=g) / K ** 0.5
            b = torch.randn(K, N, device=dev, generator=g) / N ** 0.5
            fn = lambda: tiled_matmul(a, b, **mcfg)  # noqa: E731
            cfg = mcfg
        elif kernel in ("minplus", "minplus_panel"):
            fn, cfg = minplus_case(kernel, shape)
        elif kernel == "decode_attention":
            from repro_torch.kernels.decode_attention import decode_attention

            BH, G, S, hd = shape
            q = torch.randn(BH, G, hd, device=dev, generator=g)
            k, v = (torch.randn(BH, S, hd, device=dev, generator=g) for _ in range(2))
            cp = torch.full((BH,), 260, dtype=torch.int32, device=dev)
            cfg = {k_: v_ for k_, v_ in ops.DEFAULTS["decode_attention"].items() if k_ != "impl"}
            fn = lambda: decode_attention(q, k, v, cp, **cfg)  # noqa: E731
        elif kernel == "floyd_warshall":
            (W,) = problems.problem_inputs("floyd_warshall", shape, dev)
            fn = lambda: ops.floyd_warshall_op(W)  # noqa: E731
            cfg = ops.DEFAULTS["floyd_warshall"]
        elif kernel == "closure":
            from repro_torch.kernels.floyd_warshall import closure_in_block

            (bs,) = shape
            (W,) = problems.problem_inputs("floyd_warshall", (2800,), dev)
            blk = W[:bs, :bs].contiguous()
            fn = lambda: closure_in_block(blk, 0, bs)  # noqa: E731
            cfg = dict(bs=bs)
        elif kernel == "lu_factor_diag":
            from repro_torch.kernels.lu import lu_factor_diag

            (bs,) = shape
            (A,) = problems.problem_inputs("lu", (2000,), dev)
            # one fresh copy a call, made before timing: 3 + 50 calls by
            # events, 1 + 10 profiled (a further call raises StopIteration)
            fresh = iter([A[:bs, :bs].contiguous() for _ in range(3 + 50 + 1 + 10)])
            fn = lambda: lu_factor_diag(next(fresh), 0, bs)  # noqa: E731
            cfg = dict(bs=bs)
        elif kernel == "lu":
            (A,) = problems.problem_inputs("lu", shape, dev)
            fn = lambda: ops.lu_op(A)  # noqa: E731
            cfg = ops.DEFAULTS["lu"]
        else:
            from repro_torch.kernels.heat3d import heat3d_step

            (H,) = problems.problem_inputs("heat3d", (shape[0], 1), dev)
            cfg = ops.DEFAULTS["heat3d"]
            if kernel == "heat3d_pass":
                fn = lambda: heat3d_step(H, **cfg)  # noqa: E731
            else:
                fn = lambda: ops.heat3d_op(H, shape[1])  # noqa: E731
        rec = dict(tree=tree, case=name, shape=shape, config=cfg)
        if kernel == "matmul":
            want = a.double() @ b.double()
            rms = want.pow(2).mean().sqrt()
            rec["err"], rec["library_err"] = (
                float((out.double() - want).abs().max() / rms)
                for out in (fn(), torch.matmul(a, b)))
            del want
        big = kernel in ("floyd_warshall", "heat3d", "lu") or shape[0] * shape[-1] > 10 ** 7
        try:
            rec["ms"] = events_ms(fn, 10 if big else 50)
            rec["device_ms"], rec["device_kernels"] = device_ms(fn, 3 if big else 10)
        except ConfigRejected as e:
            rec["refused"] = str(e)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        _child(argv[1])
        return 0
    out = None
    if "--out" in argv:
        i = argv.index("--out")
        out, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (os.path.abspath(t) for t in argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    lines = [smi.splitlines()[0]]
    print(lines[0], flush=True)
    for tree in (old, new, new, old):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree],
                             capture_output=True, text=True, timeout=1200)
        sys.stdout.write(run.stdout)
        lines += run.stdout.splitlines()
        if run.returncode != 0:
            sys.stderr.write(run.stderr[-4000:])
            return run.returncode
    if out:
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
