"""Serving CLI: batched greedy decoding with a prefill + decode loop, on
the card through the dispatch service — the counterpart of
``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --batch 4 --prompt-len 256 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --device cpu --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --prompt-len 128 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 \
        --device cpu --reduced

``--arch`` takes the dense family, the MoE family (``mixtral-8x7b``,
``deepseek-v2-236b``), the SSM family (``mamba2-780m``), the hybrid
(``zamba2-1.2b``), the VLM family (``qwen2-vl-7b``) and the audio family
(``whisper-large-v3``). It runs on the card
unless ``--device cpu`` is given (without a card it raises). It always
serves through a :class:`DispatchService` — otherwise no kernel runs:
prefill attention goes to the flash_attention kernel, every decode step's
attention to the decode_attention kernel, and the output projection and the
unembed to the tiled matmul. As in the JAX package, an arch with a sliding
window (mixtral) keeps its attention on the plain path, and MLA (deepseek),
its output projection included, the routed experts and the Mamba2 mixers
are plain tensor operations, and so are whisper's encoder and decoder
layers. So per arch:

- mamba2-780m: only the unembed, on the tiled matmul (48 Mamba2 layers,
  no attention);
- zamba2-1.2b: its shared attention block at each of its 7 sites (38
  Mamba2 layers in segments of 6, the last of 2): flash_attention per site
  at prefill (32 heads, 32 KV heads: one call a site), decode_attention per
  site per step, the site's output projection and the unembed on the
  matmul;
- qwen2-vl-7b: as qwen2-0.5b (28 layers), at 7 query heads per KV head and
  head size 128 (7 flash calls a layer), with M-RoPE positions (the
  vision frontend is a config field no code reads, in both packages);
- whisper-large-v3: only the unembed, on the tiled matmul, once a forward
  and once a decode step (32 encoder layers over the frames, 32 decoder
  layers with cross-attention, all plain, as in the JAX package). Its
  frames, ``(batch, encoder_len, d_model)`` standard normal values, are
  drawn from ``--seed + 2`` (the conv frontend is stubbed in both
  packages); the prefill fills the cross-attention cache from the
  encoder's output.

The full MoE configs do not fit one card in f32 (``param_count()`` x 4
bytes: mixtral 187 GB, deepseek about 943 GB); ``chip_smoke.py`` serves
them with fewer layers. mamba2-780m, zamba2-1.2b, qwen2-vl-7b and
whisper-large-v3 fit whole (3.1, 4.4, 30.5 and 7.8 GB; whisper's
``param_count()`` leaves out the decoder's cross-attention, its leaves hold
1.95B values). The service has no store,
so the ``gpu`` space defaults apply, unless ``--store DIR`` names a tuning
store (records an ``autotune --store DIR`` campaign published, or earlier
runs' background campaigns). With ``--tune`` a store miss (or a too-distant
neighbor) also enqueues a background campaign for that signature
(:class:`~repro_torch.dispatch.BackgroundTuner`, on streams of its own),
whose winner is published to the store and hot-swapped into the serving
run; the CLI waits for the campaigns after the run and prints what they
published. Everything runs in f32, as the JAX package's serving CLI does.
Weights are random, drawn from ``--seed``; the prompt from ``--seed + 1``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.dispatch import BackgroundTuner, DispatchService, TuningStore
from repro_torch.kernels.util import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import cache_bytes, greedy_decode

__all__ = ["main", "report", "serve", "service_for"]


def serve(arch: str = "qwen2-0.5b", *, reduced: bool = False, batch: int = 4,
          prompt_len: int = 16, gen: int = 32, seed: int = 0, device=None,
          store: str | None = None, service: DispatchService | None = None) -> dict:
    """Build the model, serve one batch of random prompts, and return the
    generated ids with the run's numbers (see :func:`main`). ``service`` is
    the caller's own (a tuner or a guard attached, say); else one is made on
    ``store``."""
    dev = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    if service is None:
        service = service_for(dev, TuningStore(store) if store else None)
    max_len = prompt_len + gen
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g, device=dev)
    kw = {}
    if cfg.family == "audio":
        ge = torch.Generator(device=dev).manual_seed(seed + 2)
        kw["enc_embed"] = torch.randn(batch, cfg.encoder_len, cfg.d_model, generator=ge,
                                      device=dev)

    timings: dict = {}
    t0 = time.perf_counter()
    out = greedy_decode(params, cfg, prompt, steps=gen, max_len=max_len, service=service,
                        timings=timings, **kw)
    wall = time.perf_counter() - t0
    return {
        "arch": cfg.name, "device": str(dev), "batch": batch, "prompt_len": prompt_len,
        "gen": gen, "tokens": out, "cache_mb": cache_bytes(cfg, batch, max_len, 4) / 1e6,
        "prefill_ms": timings["prefill_sec"] * 1e3,
        "decode_ms_per_step": timings["decode_sec"] / gen * 1e3,
        "tokens_per_sec": batch * gen / wall, "wall_sec": wall,
        "stats": dict(service.stats),
    }


def service_for(device, store: TuningStore | None, tuner=None, **kw) -> DispatchService:
    """The dispatch service of a run on ``device``: records keyed by the
    ``gpu`` backend and the ``gpu`` spaces on the card, by ``cpu`` and the
    ``host`` spaces on the CPU (as ``launch.autotune --backend`` keys them).
    ``kw`` go to :class:`DispatchService` (``metrics=``, say)."""
    cpu = torch.device(device).type == "cpu"
    return DispatchService(store, backend="cpu" if cpu else "gpu",
                           target="host" if cpu else "gpu", tuner=tuner, **kw)


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
    ap.add_argument("--tune", action="store_true",
                    help="tune store misses in the background during the run and "
                         "publish the winners to --store")
    args = ap.parse_args(argv)
    if args.tune and not args.store:
        ap.error("--tune requires --store (where the campaigns publish)")

    store = TuningStore(args.store) if args.store else None
    tuner = BackgroundTuner(store) if args.tune else None
    service = service_for(resolve_device(args.device), store, tuner)
    try:
        report(serve(args.arch, reduced=args.reduced, batch=args.batch,
                     prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
                     device=args.device, service=service))
        if tuner is not None:
            published = [r for r in tuner.drain() if r is not None]
            print(f"[serve] background: {service.stats['bg_enqueued']} campaign(s), "
                  f"{len(published)} published, errors {len(tuner.errors)}")
            for r in published:
                print(f"[serve]   {r.kernel} {r.signature}: {r.config} "
                      f"{r.objective * 1e3:.4f} ms")
    finally:
        if tuner is not None:
            tuner.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
