"""Training CLI: end-to-end LM training on the card — the counterpart of
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 200 --batch 8 --seq 128 --ckpt-dir DIR
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced

It runs on the card unless ``--device cpu`` is given (without a card it
raises; nothing carries on on the CPU). The weights are random, drawn from
``--seed``, in f32, and the data is :class:`~repro_torch.data.SyntheticLM`'s
(``--fixed-batch`` trains on step 0's batch at every step: the loss of a
memorised batch must fall). The step (:func:`~repro_torch.train.
make_train_step`) passes no dispatch service, as the JAX package's does, so
no hand-written kernel runs: the products are ``torch.matmul``, attention
the chunked path. Fault tolerance: checkpoints every ``--ckpt-every`` steps
and at the end (async, the JAX package's format: a checkpoint of either
package resumes in the other), resumes from the latest one under
``--ckpt-dir`` at startup, flags straggler steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import torch

from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_config, get_reduced
from repro_torch.data import SyntheticLM, make_batch
from repro_torch.ft import StragglerMonitor
from repro_torch.kernels.util import resolve_device
from repro_torch.models import init_params, trainable
from repro_torch.train import init_train_state, make_train_step
from repro_torch.tree import tree_leaves

__all__ = ["main", "run"]


def run(arch: str = "qwen2-0.5b", *, reduced: bool = False, steps: int = 100,
        batch: int = 8, seq: int = 128, lr: float = 3e-3, accum: int = 1,
        remat: str = "none", ckpt_dir: str | None = None, ckpt_every: int = 50,
        log_every: int = 10, seed: int = 0, device=None, fixed_batch: bool = False) -> dict:
    """Train, printing as :func:`main` does, and return the run's summary:
    ``losses`` and ``grad_norms`` of the steps run, ``step_sec`` (each
    step's wall time, the device waited for), ``ms_per_step`` and
    ``tokens_per_sec`` (their median), ``peak_bytes`` (the card's peak
    allocation over the steps; None on the CPU), ``start`` (the step resumed
    from), ``params`` (the count) and ``stragglers``."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    cfg = get_reduced(arch) if reduced else get_config(arch)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = trainable(init_params(cfg, torch.Generator(device=dev).manual_seed(seed)))
    opt = init_train_state(params)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"[train] arch={cfg.name} device={dev} params={n / 1e6:.1f}M "
          f"steps={steps} batch={batch}x{seq}", flush=True)

    start = 0
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    try:
        if ckpt and latest_step(ckpt_dir) is not None:
            state, start = restore(ckpt_dir, {"params": params, "opt": opt})
            params, opt = state["params"], state["opt"]
            print(f"[train] resumed from step {start}", flush=True)

        step_fn = make_train_step(cfg, lr=lr, accum=accum, remat=remat)
        stream = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)
        mon = StragglerMonitor()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        losses, gnorms, secs = [], [], []
        t0 = time.perf_counter()
        for s in range(start, steps):
            b = make_batch(stream, 0 if fixed_batch else s, dev)
            mon.start()
            params, opt, m = step_fn(params, opt, b)
            if cuda:  # the step is queued on the card: time its work, not its enqueue
                torch.cuda.synchronize(dev)
            dur, slow = mon.stop()
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            secs.append(dur)
            if slow:
                print(f"[train] step {s}: straggler ({dur:.2f}s vs EWMA {mon.ewma:.2f}s)")
            if s % log_every == 0 or s == steps - 1:
                print(f"step {s:5d} loss {losses[-1]:.4f} gnorm {gnorms[-1]:.3f} "
                      f"{batch * seq / max(dur, 1e-9):,.0f} tok/s", flush=True)
            if ckpt and (s + 1) % ckpt_every == 0:
                ckpt.save({"params": params, "opt": opt}, s + 1)
        if ckpt:
            ckpt.save({"params": params, "opt": opt}, steps)
            ckpt.wait()
    finally:
        if ckpt:
            ckpt.close()
    wall = time.perf_counter() - t0
    print(f"[train] done in {wall:.1f}s", flush=True)
    med = statistics.median(secs) if secs else None
    return {
        "arch": cfg.name, "device": str(dev), "params": n, "start": start, "steps": steps,
        "batch": batch, "seq": seq, "losses": losses, "grad_norms": gnorms, "step_sec": secs,
        "ms_per_step": med * 1e3 if med else None,
        "tokens_per_sec": batch * seq / med if med else None,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
        "stragglers": mon.flagged, "wall_sec": wall,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description="LM training on synthetic data.")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=("none", "full", "dots"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--fixed-batch", action="store_true",
                    help="train on step 0's batch at every step")
    args = ap.parse_args(argv)
    run(args.arch, reduced=args.reduced, steps=args.steps, batch=args.batch, seq=args.seq,
        lr=args.lr, accum=args.accum, remat=args.remat, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, log_every=args.log_every, seed=args.seed,
        device=args.device, fixed_batch=args.fixed_batch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
