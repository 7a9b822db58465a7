"""Model assembly for the dense family: init / forward / cache / decode — the
counterpart of ``repro.models.model``.

Layers stay stacked on a leading ``L`` axis (the JAX package's layout, which
it drives with ``lax.scan``) and a Python loop walks them. The other
families (MoE, MLA, SSM, hybrid, VLM, audio) raise ``NotImplementedError``:
they are ROADMAP.md Queue 1, item 5.

Tied embeddings: the unembed is ``embed.T``, a transposed view the tiled
matmul kernel cannot take (it needs contiguous operands). The parameter set
therefore carries ``embed_t``, the contiguous transpose, made once by
:func:`init_params` (and ``models.convert.params_from_numpy``): vocab x
d_model values more, 544 MB in f32 at qwen2-0.5b's width, instead of that
copy on every forward and every decode step.
"""

from __future__ import annotations

import torch

from repro_torch.models import blocks as B
from repro_torch.models.common import ArchConfig, dense_init, rms_norm, service_matmul

__all__ = ["init_params", "forward", "init_cache", "decode_step", "make_batch_positions",
           "tied_unembed"]

_NOT_YET = ("the {fam} family is not ported yet (ROADMAP.md Queue 1, item 5: the port "
            "serves the dense family)")


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(_NOT_YET.format(fam=cfg.family))


def _layer(stack: dict, i: int) -> dict:
    """Layer ``i``'s parameters (views) out of the stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in stack.items()}


def tied_unembed(params: dict) -> dict:
    """``params`` with ``embed_t``, the contiguous transpose of the tied
    embedding, added (once; a parameter set that has it is returned as is)."""
    if "embed_t" not in params:
        params = dict(params, embed_t=params["embed"].T.contiguous())
    return params


def _unembed(params: dict, cfg: ArchConfig) -> torch.Tensor:
    if not cfg.tie_embeddings:
        return params["unembed"]
    if "embed_t" not in params:
        raise KeyError("tied embeddings need params['embed_t'] (models.model.tied_unembed)")
    return params["embed_t"]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Random parameters drawn from ``generator`` on its device, in the JAX
    package's tree (layers stacked on a leading L axis), plus ``embed_t``
    for tied embeddings."""
    _dense_only(cfg)
    dev = generator.device
    p: dict = {
        "embed": dense_init((cfg.vocab_size, cfg.d_model), generator, 1, cfg.dtype),
        "final_norm": torch.zeros(cfg.d_model, device=dev),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init((cfg.d_model, cfg.vocab_size), generator, 0, cfg.dtype)
    layers = [B.init_attn_layer(generator, cfg) for _ in range(cfg.n_layers)]

    def stack(trees):
        return {k: stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                else torch.stack([t[k] for t in trees]) for k in trees[0]}

    p["layers"] = stack(layers)
    return tied_unembed(p) if cfg.tie_embeddings else p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def make_batch_positions(cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    Bsz, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)[None, :].expand(Bsz, S)
    if cfg.mrope:
        return pos[:, None, :].expand(Bsz, 3, S)
    return pos


def forward(params: dict, batch: dict, cfg: ArchConfig, *, attn_chunk: int = 512,
            service=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) in f32, aux loss). ``service`` (a
    :class:`repro_torch.dispatch.DispatchService`) routes attention, the
    output projection and the unembed through tuned kernel variants. The aux
    loss is the MoE router's, 0 for the dense family."""
    _dense_only(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.name.startswith("gemma"):
        x = x * cfg.d_model ** 0.5
    positions = batch.get("positions", None)
    if positions is None:
        positions = make_batch_positions(cfg, tokens)
    windows = B.layer_windows(cfg)
    for i in range(cfg.n_layers):
        x = B.attn_layer_train(_layer(params["layers"], i), x, cfg=cfg, positions=positions,
                               window=int(windows[i]), chunk=attn_chunk, service=service)
    x = rms_norm(x, params["final_norm"])
    logits = service_matmul(x, _unembed(params, cfg), service)
    return logits.float(), torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# decode (serve_step): one new token against a filled cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, device=None) -> dict:
    """Stacked per-layer cache: ``{"layers": {"k", "v": (L, B, S, K, hd)}}``.
    Uniform-sliding-window archs get a ring buffer of window size instead of
    max_len, as in the JAX package."""
    _dense_only(cfg)
    dtype = dtype or cfg.dtype
    alloc = max_len
    if cfg.sliding_window and not cfg.local_global_ratio:
        alloc = min(max_len, cfg.sliding_window)
    shape = (cfg.n_layers, batch, alloc, cfg.n_kv_heads, cfg.hd)
    return {"layers": {"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)}}


def decode_step(params: dict, cache: dict, token: torch.Tensor, pos, cfg: ArchConfig, *,
                service=None):
    """token: (B, 1) int; pos: an int, or (B,) per-sequence positions
    (continuous batching). Returns (logits (B, V) f32, cache): the cache is
    updated in place (each layer's K/V written at ``pos``) and returned.
    ``service`` routes the output projection, the unembed and — where the
    arch's window schedule is statically empty — single-token attention
    through tuned dispatch variants."""
    _dense_only(cfg)
    x = params["embed"][token].to(cfg.dtype)
    if cfg.name.startswith("gemma"):
        x = x * cfg.d_model ** 0.5
    windows = B.layer_windows(cfg)
    layers = cache["layers"]
    for i in range(cfg.n_layers):
        x, _ = B.attn_layer_decode(_layer(params["layers"], i), x, _layer(layers, i), pos,
                                   cfg=cfg, window=int(windows[i]), service=service)
    x = rms_norm(x, params["final_norm"])
    logits = service_matmul(x, _unembed(params, cfg), service)
    return logits[:, 0, :].float(), cache
