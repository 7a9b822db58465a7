"""Serving CLI: batched greedy decoding with a prefill + decode loop, on
the card through the dispatch service — the counterpart of
``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --batch 4 --prompt-len 256 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced

It runs on the card unless ``--device cpu`` is given (without a card it
raises). It always serves through a :class:`DispatchService` — otherwise no
kernel runs: prefill attention goes to the flash_attention kernel, every
decode step's attention to the decode_attention kernel, and the output
projection and tied unembed to the tiled matmul. The service has no store,
so the ``gpu`` space defaults apply, unless ``--store DIR`` names a tuning
store. Everything runs in f32, as the JAX package's serving CLI does.
Weights are random, drawn from ``--seed``; the prompt from ``--seed + 1``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.dispatch import DispatchService, TuningStore
from repro_torch.kernels.util import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import cache_bytes, greedy_decode

__all__ = ["main", "report", "serve"]


def serve(arch: str = "qwen2-0.5b", *, reduced: bool = False, batch: int = 4,
          prompt_len: int = 16, gen: int = 32, seed: int = 0, device=None,
          store: str | None = None) -> dict:
    """Build the model, serve one batch of random prompts, and return the
    generated ids with the run's numbers (see :func:`main`)."""
    dev = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    service = DispatchService(TuningStore(store) if store else None)
    max_len = prompt_len + gen
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g, device=dev)

    timings: dict = {}
    t0 = time.perf_counter()
    out = greedy_decode(params, cfg, prompt, steps=gen, max_len=max_len, service=service,
                        timings=timings)
    wall = time.perf_counter() - t0
    return {
        "arch": cfg.name, "device": str(dev), "batch": batch, "prompt_len": prompt_len,
        "gen": gen, "tokens": out, "cache_mb": cache_bytes(cfg, batch, max_len, 4) / 1e6,
        "prefill_ms": timings["prefill_sec"] * 1e3,
        "decode_ms_per_step": timings["decode_sec"] / gen * 1e3,
        "tokens_per_sec": batch * gen / wall, "wall_sec": wall,
        "stats": dict(service.stats),
    }


def report(r: dict) -> None:
    """Print what :func:`serve` returns."""
    print(f"[serve] arch={r['arch']} device={r['device']} batch={r['batch']} "
          f"cache={r['cache_mb']:.2f} MB")
    print(f"[serve] prefill {r['prefill_ms']:.2f} ms (prompt {r['prompt_len']}: forward + "
          f"cache fill, to the first token), decode {r['decode_ms_per_step']:.3f} ms/step, "
          f"{r['tokens_per_sec']:.1f} tok/s over {r['wall_sec']:.2f} s "
          f"({r['batch']}x{r['gen']} tokens)")
    print("[serve] dispatch stats:", json.dumps(r["stats"]))
    print("[serve] first request ids:", r["tokens"][0].tolist())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                 description="Batched greedy decoding through the "
                                             "dispatch service.")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="tuning store the dispatch service resolves configs from "
                         "(default: none, the gpu space defaults)")
    args = ap.parse_args(argv)

    report(serve(args.arch, reduced=args.reduced, batch=args.batch, prompt_len=args.prompt_len,
                 gen=args.gen, seed=args.seed, device=args.device, store=args.store))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
