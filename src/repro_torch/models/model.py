"""Model assembly for the dense, MoE, SSM, hybrid and VLM families: init /
forward / cache / decode — the counterpart of ``repro.models.model``.

Layers stay stacked on a leading ``L`` axis (the JAX package's layout, which
it drives with ``lax.scan``) and a Python loop walks them. DeepSeek-V2's
leading dense layer is a separate stage (``dense0``) before the stack, and
Zamba2's one shared attention block (``shared_attn``) closes every segment
of ``attn_every`` Mamba2 layers, as in the JAX package. The VLM family
(qwen2-vl) is the dense path with M-RoPE; its vision frontend is a config
field no code reads, in both packages. The audio family raises
``NotImplementedError``: it is ROADMAP.md Queue 1, item 5.

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
from repro_torch.models.mla import init_mla_cache
from repro_torch.models.ssm import init_ssm_cache

__all__ = ["init_params", "forward", "init_cache", "decode_step", "make_batch_positions",
           "tied_unembed"]

_NOT_YET = ("the {fam} family is not ported yet (ROADMAP.md Queue 1, item 5: the port "
            "serves the dense, MoE, SSM, hybrid and VLM families)")
_PORTED = ("dense", "moe", "ssm", "hybrid", "vlm")


def _ported_only(cfg: ArchConfig) -> None:
    if cfg.family not in _PORTED:
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


def _closes_segment(cfg: ArchConfig, i: int) -> bool:
    """Whether zamba2's shared attention block follows Mamba2 layer ``i``:
    it closes every segment of ``attn_every`` layers, the short last one
    included."""
    every = cfg.attn_every if cfg.family == "hybrid" else 0
    return bool(every) and ((i + 1) % every == 0 or i + 1 == cfg.n_layers)


def _unembed(params: dict, cfg: ArchConfig) -> torch.Tensor:
    if not cfg.tie_embeddings:
        return params["unembed"]
    if "embed_t" not in params:
        raise KeyError("tied embeddings need params['embed_t'] (models.model.tied_unembed)")
    return params["embed_t"]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _stack_init(init_one, n: int) -> dict:
    """``n`` layers drawn one after another by ``init_one()``, stacked on a
    leading axis. The stack is allocated once and each layer copied in and
    dropped, so the peak holds the stack and one layer (``torch.stack``
    would hold the stack and every layer: 30 GB more at DeepSeek-V2's
    width for two expert layers)."""
    def alloc(tree):
        return {k: alloc(v) if isinstance(v, dict) else v.new_empty((n, *v.shape))
                for k, v in tree.items()}

    def put(stack, tree, i):
        for k, v in tree.items():
            if isinstance(v, dict):
                put(stack[k], v, i)
            else:
                stack[k][i].copy_(v)

    stack = None
    for i in range(n):
        layer = init_one()
        if stack is None:
            stack = alloc(layer)
        put(stack, layer, i)
        del layer
    return stack


def _dense_ff(cfg: ArchConfig) -> int:
    # DeepSeek-V2's dense layers use the wide FFN (12288), not the expert width
    return 12288 if cfg.name.startswith("deepseek") else cfg.d_ff


def init_params(cfg: ArchConfig, generator: torch.Generator) -> dict:
    """Random parameters drawn from ``generator`` on its device, in the JAX
    package's tree (layers stacked on a leading L axis; the MoE family's
    leading dense layers as ``dense0``; Mamba2 layers for the SSM and hybrid
    families, and the hybrid's one ``shared_attn`` block), plus ``embed_t``
    for tied embeddings."""
    _ported_only(cfg)
    p: dict = {
        "embed": dense_init((cfg.vocab_size, cfg.d_model), generator, 1, cfg.dtype),
        "final_norm": torch.zeros(cfg.d_model, device=generator.device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init((cfg.d_model, cfg.vocab_size), generator, 0, cfg.dtype)
    if cfg.family == "moe":
        if cfg.first_dense_layers:
            p["dense0"] = B.init_attn_layer(generator, cfg, moe=False, d_ff=_dense_ff(cfg))
        p["layers"] = _stack_init(lambda: B.init_attn_layer(generator, cfg, moe=True),
                                  cfg.n_layers - cfg.first_dense_layers)
    elif cfg.family in ("ssm", "hybrid"):
        p["layers"] = _stack_init(lambda: B.init_mamba_layer(generator, cfg), cfg.n_layers)
        if cfg.family == "hybrid":
            p["shared_attn"] = B.init_attn_layer(generator, cfg)
    else:
        p["layers"] = _stack_init(lambda: B.init_attn_layer(generator, cfg), cfg.n_layers)
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
            ssm_chunk: int = 64, service=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) in f32, aux loss). ``service`` (a
    :class:`repro_torch.dispatch.DispatchService`) routes GQA attention, its
    output projection and the unembed through tuned kernel variants; the
    Mamba2 mixers stay plain tensor operations, as in the JAX package. The
    aux loss is the MoE routers' summed over the layers, 0 for the other
    families. ``ssm_chunk`` is the SSD scan's chunk: a prompt longer than
    it must be a multiple of it."""
    _ported_only(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.name.startswith("gemma"):
        x = x * cfg.d_model ** 0.5
    positions = batch.get("positions", None)
    if positions is None:
        positions = make_batch_positions(cfg, tokens)
    moe = cfg.family == "moe"
    aux = torch.zeros((), device=x.device)
    if cfg.family in ("ssm", "hybrid"):
        for i in range(cfg.n_layers):
            x = B.mamba_layer_train(_layer(params["layers"], i), x, cfg=cfg, chunk=ssm_chunk)
            if _closes_segment(cfg, i):
                x, _ = B.attn_layer_train(params["shared_attn"], x, cfg=cfg,
                                          positions=positions, window=None, chunk=attn_chunk,
                                          service=service)
    else:
        if "dense0" in params:
            x, a0 = B.attn_layer_train(params["dense0"], x, cfg=cfg, positions=positions,
                                       window=None, chunk=attn_chunk, service=service)
            aux = aux + a0
        windows = B.layer_windows(cfg)[cfg.first_dense_layers:]
        for i, w in enumerate(windows):
            x, a = B.attn_layer_train(_layer(params["layers"], i), x, cfg=cfg,
                                      positions=positions, window=int(w), moe=moe,
                                      chunk=attn_chunk, service=service)
            aux = aux + a
    x = rms_norm(x, params["final_norm"])
    logits = service_matmul(x, _unembed(params, cfg), service)
    return logits.float(), aux


# ---------------------------------------------------------------------------
# decode (serve_step): one new token against a filled cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, device=None) -> dict:
    """Stacked per-layer cache: ``{"layers": {"k", "v": (L, B, S, K, hd)}}``,
    or for MLA ``{"layers": {"c_kv": (L, B, S, kv_lora), "k_rope": (L, B, S,
    rope)}}``, with an unstacked ``dense0`` entry for the MoE family's
    leading dense layer; for the SSM and hybrid families ``{"layers":
    {"conv": (L, B, cw-1, Cd), "ssm": (L, B, H, P, N)}}`` in f32 whatever
    ``dtype`` is, and the hybrid's ``shared_attn`` K/V stacked over its
    sites. Uniform-sliding-window archs get a ring buffer of window size
    instead of max_len, as in the JAX package."""
    _ported_only(cfg)
    dtype = dtype or cfg.dtype
    alloc = max_len
    if cfg.sliding_window and not cfg.local_global_ratio:
        alloc = min(max_len, cfg.sliding_window)

    def kv(*lead):
        shape = (*lead, batch, alloc, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    if cfg.family in ("dense", "vlm"):
        return {"layers": kv(cfg.n_layers)}
    if cfg.family in ("ssm", "hybrid"):
        one = init_ssm_cache(cfg, batch, device=device)
        out = {"layers": {k: v.new_zeros((cfg.n_layers, *v.shape)) for k, v in one.items()}}
        if cfg.family == "hybrid":
            sites = sum(_closes_segment(cfg, i) for i in range(cfg.n_layers))
            out["shared_attn"] = kv(max(sites, 1))
        return out
    n_moe = cfg.n_layers - cfg.first_dense_layers
    out = {}
    if cfg.attn_type == "mla":
        one = init_mla_cache(cfg, batch, max_len, dtype, device)
        out["layers"] = {k: v.new_zeros((n_moe, *v.shape)) for k, v in one.items()}
        if cfg.first_dense_layers:
            out["dense0"] = one
    else:
        out["layers"] = kv(n_moe)
        if cfg.first_dense_layers:
            out["dense0"] = kv()
    return out


def decode_step(params: dict, cache: dict, token: torch.Tensor, pos, cfg: ArchConfig, *,
                mla_absorb: bool = True, service=None):
    """token: (B, 1) int; pos: an int, or for the GQA families (B,)
    per-sequence positions (continuous batching). Returns (logits (B, V)
    f32, cache): the cache is updated in place (each layer's entry written
    at ``pos``, each Mamba2 layer's state advanced) and returned.
    ``mla_absorb`` picks MLA's decode schedule. ``service`` routes the GQA
    output projection, the unembed and — where the arch's window schedule is
    statically empty — single-token attention through tuned dispatch
    variants."""
    _ported_only(cfg)
    x = params["embed"][token].to(cfg.dtype)
    if cfg.name.startswith("gemma"):
        x = x * cfg.d_model ** 0.5
    moe = cfg.family == "moe"
    layers = cache["layers"]
    if cfg.family in ("ssm", "hybrid"):
        site = 0
        for i in range(cfg.n_layers):
            x, _ = B.mamba_layer_decode(_layer(params["layers"], i), x, _layer(layers, i),
                                        cfg=cfg)
            if _closes_segment(cfg, i):
                x, _, _ = B.attn_layer_decode(params["shared_attn"], x,
                                              _layer(cache["shared_attn"], site), pos,
                                              cfg=cfg, window=None, service=service)
                site += 1
    else:
        if "dense0" in params:
            x, _, _ = B.attn_layer_decode(params["dense0"], x, cache["dense0"], pos, cfg=cfg,
                                          window=None, mla_absorb=mla_absorb, service=service)
        windows = B.layer_windows(cfg)[cfg.first_dense_layers:]
        for i, w in enumerate(windows):
            x, _, _ = B.attn_layer_decode(_layer(params["layers"], i), x, _layer(layers, i),
                                          pos, cfg=cfg, window=int(w), moe=moe,
                                          mla_absorb=mla_absorb, service=service)
    x = rms_norm(x, params["final_norm"])
    logits = service_matmul(x, _unembed(params, cfg), service)
    return logits[:, 0, :].float(), cache
