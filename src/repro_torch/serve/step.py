"""Serving steps: prefill (forward over the prompt) + batched greedy decode
— the counterpart of ``repro.serve.step``.

``decode_step`` (one token against a filled cache) lives in
``repro_torch.models.model``; this module adds the request-batch loop used
by the serving CLI (``repro_torch.launch.serve``)."""

from __future__ import annotations

import time

import torch

from repro_torch.models.common import ArchConfig
from repro_torch.models.model import decode_step, forward, init_cache

__all__ = ["prefill", "greedy_decode", "make_serve_step"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill(params, batch, cfg: ArchConfig, max_len: int, service=None, **fw_kw):
    """Run the prompt through the model, then replay it through decode_step
    to fill the cache (the JAX package's simple, correct reference path; a
    fused prefill-with-cache is a later optimisation). ``service`` routes the
    prompt forward's attention (flash ``bq``/``bk``) and matmul call sites,
    and the replay's decode attention and matmuls, through
    :mod:`repro_torch.dispatch`."""
    logits, _ = forward(params, batch, cfg, service=service, **fw_kw)
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    for t in range(S):
        _, cache = decode_step(params, cache, tokens[:, t:t + 1], t, cfg, service=service)
    return logits, cache


def make_serve_step(cfg: ArchConfig, *, service=None):
    """serve_step(params, cache, token, pos) -> (next_token, logits, cache),
    the cache updated in place.

    With a :class:`repro_torch.dispatch.DispatchService`, the step is held in
    the service's executable cache — every caller asking for the same model
    config shares one entry — and the decode call sites inside resolve tuned
    variants from the service's store."""

    def serve_step(params, cache, token, pos):
        logits, cache = decode_step(params, cache, token, pos, cfg, service=service)
        nxt = torch.argmax(logits, dim=-1).to(token.dtype)[:, None]
        return nxt, logits, cache

    if service is not None:
        # key on the full dataclass repr: two configs sharing a name (e.g. a
        # full model and its reduced() variant) must not share a closure
        return service.jit_cached(f"serve_step/{cfg!r}", serve_step)
    return serve_step


def greedy_decode(params, cfg: ArchConfig, prompt: torch.Tensor, steps: int,
                  max_len: int, service=None, timings: dict | None = None, **fw_kw):
    """prompt: (B, S) int. Returns (B, steps) generated ids. ``service``
    routes prefill attention and the per-step matmuls through tuned dispatch
    variants and the decode step through the service's executable cache.

    With a ``timings`` dict, records ``prefill_sec`` (prompt forward and
    cache fill, up to the first token) and ``decode_sec`` (the ``steps``
    decode steps), host wall seconds each ending in a device synchronise."""
    if cfg.family == "audio":
        raise NotImplementedError("the audio family is not ported yet "
                                  "(ROADMAP.md Queue 1, item 5)")
    dev = prompt.device
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompt}, cfg, max_len, service=service, **fw_kw)
    S = prompt.shape[1]
    tok = torch.argmax(logits[:, -1, :], dim=-1).to(prompt.dtype)[:, None]
    if timings is not None:
        _sync(dev)
        t1 = time.perf_counter()
    serve = make_serve_step(cfg, service=service)
    toks = []
    for t in range(S, S + steps):
        toks.append(tok[:, 0])
        tok, _, cache = serve(params, cache, tok, t)
    out = torch.stack(toks, dim=1)
    if timings is not None:
        _sync(dev)
        timings["prefill_sec"] = t1 - t0
        timings["decode_sec"] = time.perf_counter() - t1
    return out
