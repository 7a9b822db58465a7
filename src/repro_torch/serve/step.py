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
    fused prefill-with-cache is a later optimisation). For the audio family
    (``batch["enc_embed"]``: the frames) the forward also writes each
    decoder layer's cross K/V, made from the encoder's one run, into
    ``cache["cross"]`` before the replay, which attends to them. The JAX
    package's prefill leaves that entry zeros, so its decode steps attend to
    no audio; the port follows the JAX package's decode step, which expects
    it filled (ROADMAP.md Queue 3). ``service`` routes the
    prompt forward's attention (flash ``bq``/``bk``) and matmul call sites,
    and the replay's decode attention and matmuls, through
    :mod:`repro_torch.dispatch`. MLA replays with the absorbed schedule, the
    JAX package's default. With capacity-limited routing the forward can
    drop tokens that the replay (one token a row) never drops, so its logits
    and the filled cache can differ by design. ``fw_kw`` reach the forward
    (``attn_chunk``; ``ssm_chunk``, the SSD scan's chunk, which a prompt
    longer than it must be a multiple of); the replay fills the Mamba2 state
    through the recurrence, as in the JAX package."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    if cfg.family == "audio":
        fw_kw = dict(fw_kw, cross_cache=cache["cross"])
    logits, _ = forward(params, batch, cfg, service=service, **fw_kw)
    for t in range(S):
        _, cache = decode_step(params, cache, tokens[:, t:t + 1], t, cfg, service=service)
    return logits, cache


def make_serve_step(cfg: ArchConfig, *, mla_absorb: bool = True, service=None):
    """serve_step(params, cache, token, pos) -> (next_token, logits, cache),
    the cache updated in place; ``mla_absorb`` picks MLA's decode schedule.

    With a :class:`repro_torch.dispatch.DispatchService`, the step is held in
    the service's executable cache — every caller asking for the same model
    config and schedule shares one entry — and the decode call sites inside
    resolve tuned variants from the service's store."""

    def serve_step(params, cache, token, pos):
        logits, cache = decode_step(params, cache, token, pos, cfg,
                                    mla_absorb=mla_absorb, service=service)
        nxt = torch.argmax(logits, dim=-1).to(token.dtype)[:, None]
        return nxt, logits, cache

    if service is not None:
        # key on the full dataclass repr: two configs sharing a name (e.g. a
        # full model and its reduced() variant) must not share a closure, nor
        # two schedules of one model
        return service.jit_cached(f"serve_step/{cfg!r}/absorb={mla_absorb}", serve_step)
    return serve_step


def greedy_decode(params, cfg: ArchConfig, prompt: torch.Tensor, steps: int,
                  max_len: int, service=None, timings: dict | None = None, **fw_kw):
    """prompt: (B, S) int. Returns (B, steps) generated ids. ``service``
    routes prefill attention and the per-step matmuls through tuned dispatch
    variants and the decode step through the service's executable cache.

    With a ``timings`` dict, records ``prefill_sec`` (prompt forward and
    cache fill, up to the first token) and ``decode_sec`` (the ``steps``
    decode steps), host wall seconds each ending in a device synchronise.
    The audio family takes its frames as ``enc_embed=`` (B, encoder_len,
    d_model)."""
    dev = prompt.device
    t0 = time.perf_counter()
    batch = {"tokens": prompt}
    if cfg.family == "audio":
        batch["enc_embed"] = fw_kw.pop("enc_embed")
    logits, cache = prefill(params, batch, cfg, max_len, service=service, **fw_kw)
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
