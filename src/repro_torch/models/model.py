"""Model assembly for the dense, MoE, SSM, hybrid and VLM families: init /
forward / loss / cache / decode — the counterpart of ``repro.models.model``.

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
copy on every forward and every decode step. Only a call with a dispatch
service reads it; without one (training, which passes no service, as in the
JAX package) the unembed is the view ``embed.T``, so that a gradient flows
into ``embed`` alone. A train state holds no ``embed_t`` (:func:`trainable`);
serving trained weights makes it anew with :func:`tied_unembed`, and a call
with a service refuses an ``embed_t`` made before ``embed`` was last updated
in place.

In :func:`forward` each stacked leaf is split into its layers by one
``torch.unbind``, whose backward stacks the layers' gradients once; indexing
layer ``i`` out of the stack would write a zero tensor the size of the whole
stack per layer and leaf in the backward.
"""

from __future__ import annotations

import functools
import weakref

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import blocks as B
from repro_torch.models.common import ArchConfig, dense_init, rms_norm, service_matmul
from repro_torch.models.mla import init_mla_cache
from repro_torch.models.ssm import init_ssm_cache

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "decode_step",
           "make_batch_positions", "tied_unembed", "trainable", "MOE_AUX_COEF"]

MOE_AUX_COEF = 0.01

_NOT_YET = ("the {fam} family is not ported yet (ROADMAP.md Queue 1, item 5: the port "
            "serves the dense, MoE, SSM, hybrid and VLM families)")
_PORTED = ("dense", "moe", "ssm", "hybrid", "vlm")


def _ported_only(cfg: ArchConfig) -> None:
    if cfg.family not in _PORTED:
        raise NotImplementedError(_NOT_YET.format(fam=cfg.family))


def _layer(stack: dict, i: int) -> dict:
    """Layer ``i``'s parameters (views) out of the stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in stack.items()}


def _layers(stack: dict, n: int) -> list[dict]:
    """The ``n`` layers' parameters out of the stacked tree, each leaf split
    once by ``torch.unbind`` (see the module's docstring)."""
    out = [{} for _ in range(n)]
    for k, v in stack.items():
        parts = _layers(v, n) if isinstance(v, dict) else torch.unbind(v)
        for layer, part in zip(out, parts):
            layer[k] = part
    return out


def trainable(params: dict) -> dict:
    """``params`` without ``embed_t``: the leaves a train state holds, exactly
    the JAX package's."""
    return {k: v for k, v in params.items() if k != "embed_t"}


def _current(params: dict) -> bool:
    """Whether ``params`` holds an ``embed_t`` made from its ``embed`` as it
    is now: the same tensor, not updated in place since (its version
    counter unchanged). A copy moved to another device carries no record
    and counts as current."""
    if "embed_t" not in params:
        return False
    made_from = getattr(params["embed_t"], "_made_from", None)
    if made_from is None:
        return True
    ref, version = made_from
    return ref() is params["embed"] and params["embed"]._version == version


def tied_unembed(params: dict) -> dict:
    """``params`` with ``embed_t``, the contiguous transpose of the tied
    embedding: returned as is when its ``embed_t`` is current, else with a
    new one made from ``embed`` (a stale copy, after training updated
    ``embed`` in place, is replaced)."""
    if _current(params):
        return params
    embed = params["embed"]
    embed_t = embed.detach().T.contiguous()
    embed_t._made_from = (weakref.ref(embed), embed._version)
    return dict(trainable(params), embed_t=embed_t)


def _closes_segment(cfg: ArchConfig, i: int) -> bool:
    """Whether zamba2's shared attention block follows Mamba2 layer ``i``:
    it closes every segment of ``attn_every`` layers, the short last one
    included."""
    every = cfg.attn_every if cfg.family == "hybrid" else 0
    return bool(every) and ((i + 1) % every == 0 or i + 1 == cfg.n_layers)


def _unembed(params: dict, cfg: ArchConfig, service) -> torch.Tensor:
    if not cfg.tie_embeddings:
        return params["unembed"]
    if service is None:
        return params["embed"].T
    if "embed_t" not in params:
        raise KeyError("tied embeddings need params['embed_t'] (models.model.tied_unembed)")
    if not _current(params):
        raise ValueError("params['embed_t'] is stale: 'embed' changed after it was made "
                         "(models.model.tied_unembed makes it anew)")
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


def _save_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of the products without batch
    dimensions (``aten.mm``/``aten.addmm``: a 2-D weight against the
    flattened activations), as ``jax.checkpoint_policies.
    checkpoint_dots_with_no_batch_dims`` does; recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, remat: str):
    """``fn`` (a layer body) under the remat policy: ``"none"``, ``"full"``
    (keep the body's inputs, recompute the rest in the backward) or
    ``"dots"`` (keep the products without batch dimensions too)."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, _save_products)
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=ctx)
    raise ValueError(f"unknown remat policy {remat!r}")


def forward(params: dict, batch: dict, cfg: ArchConfig, *, remat: str = "none",
            attn_chunk: int = 512, ssm_chunk: int = 64,
            service=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) in f32, aux loss). ``service`` (a
    :class:`repro_torch.dispatch.DispatchService`) routes GQA attention, its
    output projection and the unembed through tuned kernel variants; the
    Mamba2 mixers stay plain tensor operations, as in the JAX package. The
    aux loss is the MoE routers' summed over the layers, 0 for the other
    families. ``ssm_chunk`` is the SSD scan's chunk: a prompt longer than
    it must be a multiple of it. ``remat`` applies to each layer of the
    stack (each Mamba2 layer, each attention layer), where the JAX package
    applies it: not to DeepSeek's ``dense0`` nor to zamba2's shared block."""
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
        body = _maybe_remat(functools.partial(B.mamba_layer_train, cfg=cfg, chunk=ssm_chunk),
                            remat)
        for i, p_l in enumerate(_layers(params["layers"], cfg.n_layers)):
            x = body(p_l, x)
            if _closes_segment(cfg, i):
                x, _ = B.attn_layer_train(params["shared_attn"], x, cfg=cfg,
                                          positions=positions, window=None, chunk=attn_chunk,
                                          service=service)
    else:
        def attn_body(p_l, x, window):
            return B.attn_layer_train(p_l, x, cfg=cfg, positions=positions, window=window,
                                      moe=moe, chunk=attn_chunk, service=service)

        body = _maybe_remat(attn_body, remat)
        if "dense0" in params:
            x, a0 = B.attn_layer_train(params["dense0"], x, cfg=cfg, positions=positions,
                                       window=None, chunk=attn_chunk, service=service)
            aux = aux + a0
        windows = B.layer_windows(cfg)[cfg.first_dense_layers:]
        for p_l, w in zip(_layers(params["layers"], len(windows)), windows):
            x, a = body(p_l, x, int(w))
            aux = aux + a
    x = rms_norm(x, params["final_norm"])
    logits = service_matmul(x, _unembed(params, cfg, service), service)
    return logits.float(), aux


def loss_fn(params: dict, batch: dict, cfg: ArchConfig, **fw_kw):
    """Next-token loss: log-softmax NLL over the positions with ``labels >=
    0``, plus ``MOE_AUX_COEF`` times the routers' aux loss. Returns (total,
    {"loss", "aux"}); ``fw_kw`` go to :func:`forward`."""
    logits, aux = forward(params, batch, cfg, **fw_kw)
    labels = batch["labels"]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).float()
    loss = (nll * mask).sum() / mask.sum().clamp(min=1.0)
    total = loss + MOE_AUX_COEF * aux
    return total, {"loss": loss, "aux": aux}


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
    logits = service_matmul(x, _unembed(params, cfg, service), service)
    return logits[:, 0, :].float(), cache
