"""Model assembly for the dense, MoE, SSM, hybrid, VLM and audio families:
init / forward / loss / cache / decode — the counterpart of
``repro.models.model``.

Layers stay stacked on a leading ``L`` axis (the JAX package's layout, which
it drives with ``lax.scan``) and a Python loop walks them. DeepSeek-V2's
leading dense layer is a separate stage (``dense0``) before the stack, and
Zamba2's one shared attention block (``shared_attn``) closes every segment
of ``attn_every`` Mamba2 layers, as in the JAX package. The VLM family
(qwen2-vl) is the dense path with M-RoPE; its vision frontend is a config
field no code reads, in both packages. The audio family (whisper) is an
encoder stack (``enc_layers``: non-causal GQA layers over the frame
embeddings ``batch["enc_embed"]``, the conv frontend stubbed as in the JAX
package) and a decoder stack (``dec_layers``) whose layers add
cross-attention to the encoder's output; its cache holds the decoder's
self-attention K/V and the cross K/V, which :func:`forward` fills when
given ``cross_cache`` (``serve.step.prefill`` does).

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

import dataclasses
import functools
import weakref

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import blocks as B
from repro_torch.models.common import (
    ArchConfig,
    constrain,
    dense_init,
    replicate_like,
    rms_norm,
    service_matmul,
)
from repro_torch.models.mla import init_mla_cache
from repro_torch.models.ssm import init_ssm_cache
from repro_torch.tree import tree_map

__all__ = ["init_params", "abstract_params", "forward", "loss_fn", "init_cache",
           "decode_step", "make_batch_positions", "tied_unembed", "trainable",
           "MOE_AUX_COEF"]

MOE_AUX_COEF = 0.01

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _known_family(cfg: ArchConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


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


def _vocab_offset(mesh, placements, dim: int, rows: int) -> int:
    """The first index, along ``dim``, of this device's shard of ``rows``
    rows a shard (the mesh dims that shard ``dim``, in mesh order)."""
    coord, shard = mesh.get_coordinate(), 0
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            shard = shard * mesh.size(i) + coord[i]
    return shard * rows


class _VocabParallelEmbed(torch.autograd.Function):
    """Rows of a DTensor table (V, d) sharded over the vocabulary (``d``
    whole), at DTensor ``tokens`` sharded over the batch: each device looks
    up the tokens its vocabulary shard holds (zeros elsewhere), a sum over
    the vocabulary's mesh dims completes the rows; the backward adds each
    row's gradient into the device's own shard, a partial sum over the
    batch's mesh dims (Megatron's vocab-parallel embedding)."""

    @staticmethod
    def forward(ctx, table, tokens):
        from torch.distributed import _functional_collectives as funcol

        _refuse_partial(table, tokens)
        mesh, tpl, kpl = table.device_mesh, tuple(table.placements), tuple(tokens.placements)
        tab = table.to_local()
        rows_here = tab.shape[0]
        local = tokens.to_local().long() - _vocab_offset(mesh, tpl, 0, rows_here)
        inside = (local >= 0) & (local < rows_here)
        local = local.clamp(0, rows_here - 1)
        out = tab[local] * inside[..., None].to(tab.dtype)
        for i, p in enumerate(tpl):
            if p.is_shard(0):
                out = funcol.all_reduce(out, "sum", (mesh, i))
                if isinstance(out, funcol.AsyncCollectiveTensor):
                    out = out.wait()
        ctx.save_for_backward(local, inside)
        ctx.layout = (mesh, tpl, kpl, table.shape, table.stride())
        return DTensor.from_local(out, mesh, kpl, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        local, inside = ctx.saved_tensors
        mesh, tpl, kpl, shape, stride = ctx.layout
        g = grad.redistribute(mesh, kpl).to_local()
        g = (g * inside[..., None].to(g.dtype)).reshape(-1, g.shape[-1])
        gt = torch.zeros((shape[0] // _shards(mesh, tpl, 0), shape[1]), dtype=g.dtype,
                         device=g.device)
        gt.index_add_(0, local.reshape(-1), g)
        placements = [Shard(0) if p.is_shard(0) else Partial() if q.is_shard() else Replicate()
                      for p, q in zip(tpl, kpl)]
        return DTensor.from_local(gt, mesh, placements, run_check=False, shape=shape,
                                  stride=stride), None


def _summed(t: torch.Tensor) -> torch.Tensor:
    """A DTensor ``t`` with its partial sums reduced (``Partial`` mesh dims
    made ``Replicate``): the vocab-parallel functions below read each
    device's shard as it is."""
    pl = list(t.placements)
    if not any(p.is_partial() for p in pl):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p for p in pl])


def _refuse_partial(*ts) -> None:
    for t in ts:
        if any(p.is_partial() for p in t.placements):
            raise ValueError(f"a vocab-parallel operand holds partial sums: {t.placements}")


def _shards(mesh, placements, dim: int) -> int:
    n = 1
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            n *= mesh.size(i)
    return n


def _embed(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``embed`` at ``tokens``. A DTensor table is gathered over
    the mesh dims that shard ``d`` (FSDP's gather) and looked up on its
    vocabulary shards (:class:`_VocabParallelEmbed`): DTensor's own
    index and embedding rules replicate the table, or have no rule for the
    backward's scatter before torch 2.13."""
    if not isinstance(embed, DTensor):
        return embed[tokens]
    mesh = embed.device_mesh
    table = embed.redistribute(mesh, [Replicate() if p.is_shard(1) or p.is_partial() else p
                                      for p in embed.placements])
    tokens = replicate_like(tokens, table)
    tokens = tokens.redistribute(mesh, [Replicate() if p.is_shard(0) else q
                                        for p, q in zip(table.placements, tokens.placements)])
    return _VocabParallelEmbed.apply(table, tokens)


def _gather_fsdp(tree: dict, act_spec) -> dict:
    """A layer's parameters with each DTensor matrix gathered over the mesh
    dims that split the batch (``act_spec``'s ``Shard(0)``): FSDP's gather
    at use, whose backward reduce-scatters the gradients, as the reference's
    SPMD partitioner places it. Expert tensors (3-D) keep their shards.
    DTensor left to itself contracts over the gathered dim's shards instead
    in the backward, and all-gathers the batch."""
    if act_spec is None:
        return tree
    batch = {i for i, p in enumerate(act_spec) if p.is_shard(0)}

    def one(t):
        if not isinstance(t, DTensor) or t.ndim != 2:
            return t
        pl = [Replicate() if i in batch and p.is_shard() else p
              for i, p in enumerate(t.placements)]
        return t if pl == list(t.placements) else t.redistribute(t.device_mesh, pl)

    return tree_map(one, tree)


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
    families, and the hybrid's one ``shared_attn`` block; the audio family's
    ``enc_layers`` and ``dec_layers``), plus ``embed_t`` for tied
    embeddings."""
    _known_family(cfg)
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
    elif cfg.family == "audio":
        p["enc_layers"] = _stack_init(lambda: B.init_attn_layer(generator, cfg),
                                      cfg.n_encoder_layers)
        p["dec_layers"] = _stack_init(lambda: B.init_cross_layer(generator, cfg), cfg.n_layers)
    else:
        p["layers"] = _stack_init(lambda: B.init_attn_layer(generator, cfg), cfg.n_layers)
    return tied_unembed(p) if cfg.tie_embeddings else p


class _MetaDraws:
    """Stands in for a generator on the meta device: ``dense_init`` gives an
    empty meta tensor for it and draws nothing (no meta generator exists)."""

    device = torch.device("meta")


def abstract_params(cfg: ArchConfig) -> dict:
    """The JAX package's parameter tree (:func:`trainable`'s) as meta
    tensors of its shapes and dtypes: nothing is drawn or allocated, even
    at DeepSeek-V2's width (the dry-run's parameters)."""
    return trainable(init_params(cfg, _MetaDraws()))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def make_batch_positions(cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) positions, (B, 3, S) for M-RoPE; for DTensor tokens a DTensor
    placed as they are (each shard makes its own rows)."""
    if isinstance(tokens, DTensor):
        local = make_batch_positions(cfg, tokens.to_local()).contiguous()
        return DTensor.from_local(local, tokens.device_mesh, tokens.placements,
                                  run_check=False)
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


def _embed_scale(cfg: ArchConfig) -> float:
    """Gemma's embedding scale, sqrt(d_model) rounded to ``cfg.dtype`` first
    as the JAX package's ``jnp.asarray(d_model ** 0.5, cfg.dtype)`` is (in
    bf16 33.94 becomes 34.0). Both factors are then ``cfg.dtype`` values, so
    the product rounds once to the same number in either package; in f32
    the scale is the same f32 number as before."""
    return float(torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype))


def forward(params: dict, batch: dict, cfg: ArchConfig, *, remat: str = "none",
            attn_chunk: int = 512, ssm_chunk: int = 64, act_spec=None, logits_spec=None,
            service=None, cross_cache: dict | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) in f32, aux loss). ``service`` (a
    :class:`repro_torch.dispatch.DispatchService`) routes GQA attention, its
    output projection and the unembed through tuned kernel variants; the
    Mamba2 mixers stay plain tensor operations, as in the JAX package. The
    aux loss is the MoE routers' summed over the layers, 0 for the other
    families. ``ssm_chunk`` is the SSD scan's chunk: a prompt longer than
    it must be a multiple of it. ``remat`` applies to each layer of the
    stack (each Mamba2 layer, each attention layer, each of the audio
    family's encoder and decoder layers with its cross K/V products), where
    the JAX package applies it: not to DeepSeek's ``dense0`` nor to
    zamba2's shared block. The audio family reads the frame embeddings
    ``batch["enc_embed"]`` (B, encoder_len, d_model); its encoder and
    decoder pass no service (as in the JAX package), so only the unembed
    dispatches. ``cross_cache``, an audio cache's ``"cross"`` entry, gets
    each decoder layer's cross K/V written into it (prefill's use: the
    encoder runs once for the logits and the cache). ``act_spec`` and
    ``logits_spec`` (DTensor placements, for DTensor parameters and inputs)
    constrain the residual stream after the embedding and after each
    layer body of a stack, and the logits, where the JAX package's ``_cst``
    does (:func:`models.common.constrain`)."""
    _known_family(cfg)
    tokens = batch["tokens"]
    x = constrain(_embed(params["embed"], tokens).to(cfg.dtype), act_spec)
    if cfg.name.startswith("gemma"):
        x = x * _embed_scale(cfg)
    positions = batch.get("positions", None)
    if positions is None:
        positions = make_batch_positions(cfg, tokens)
    moe = cfg.family == "moe"
    aux = torch.zeros((), device=x.device)
    if cfg.family == "audio":
        x = _encoder_decoder(params, x, batch["enc_embed"], cfg, positions=positions,
                             remat=remat, attn_chunk=attn_chunk, cross_cache=cross_cache,
                             act_spec=act_spec)
    elif cfg.family in ("ssm", "hybrid"):
        def mamba_body(p_l, x):
            p_l = _gather_fsdp(p_l, act_spec)
            return constrain(B.mamba_layer_train(p_l, x, cfg=cfg, chunk=ssm_chunk), act_spec)

        body = _maybe_remat(mamba_body, remat)
        for i, p_l in enumerate(_layers(params["layers"], cfg.n_layers)):
            x = body(p_l, x)
            if _closes_segment(cfg, i):
                x, _ = B.attn_layer_train(_gather_fsdp(params["shared_attn"], act_spec), x,
                                          cfg=cfg, positions=positions, window=None,
                                          chunk=attn_chunk, service=service,
                                          act_spec=act_spec)
    else:
        def attn_body(p_l, x, window):
            x, a = B.attn_layer_train(_gather_fsdp(p_l, act_spec), x, cfg=cfg,
                                      positions=positions, window=window, moe=moe,
                                      chunk=attn_chunk, service=service, act_spec=act_spec)
            return constrain(x, act_spec), a

        body = _maybe_remat(attn_body, remat)
        if "dense0" in params:
            x, a0 = B.attn_layer_train(_gather_fsdp(params["dense0"], act_spec), x,
                                       cfg=cfg, positions=positions, window=None,
                                       chunk=attn_chunk, service=service, act_spec=act_spec)
            aux = aux + a0
        windows = B.layer_windows(cfg)[cfg.first_dense_layers:]
        for p_l, w in zip(_layers(params["layers"], len(windows)), windows):
            x, a = body(p_l, x, int(w))
            aux = aux + a
    x = rms_norm(x, params["final_norm"])
    unembed = _gather_fsdp({"w": _unembed(params, cfg, service)}, act_spec)["w"]
    logits = constrain(service_matmul(x, unembed, service), logits_spec)
    return logits.float(), aux


def _encoder_decoder(params: dict, x: torch.Tensor, enc: torch.Tensor, cfg: ArchConfig, *,
                     positions, remat: str, attn_chunk: int, cross_cache: dict | None,
                     act_spec=None):
    """The audio family's stacks: the encoder over the frames ``enc`` at
    positions ``arange(Se)``, non-causal, then each decoder layer with its
    cross K/V made from the encoder's output inside the layer's body."""
    enc = enc.to(cfg.dtype)
    Be, Se = enc.shape[:2]
    enc_pos = torch.arange(Se, device=enc.device)[None, :].expand(Be, Se)
    if isinstance(enc, DTensor):  # placed as the frames are (each shard its own rows)
        enc_pos = make_batch_positions(dataclasses.replace(cfg, mrope=False), enc[..., 0])

    def enc_body(p_l, h):
        h, _ = B.attn_layer_train(_gather_fsdp(p_l, act_spec), h, cfg=cfg, positions=enc_pos,
                                  window=None, causal=False, chunk=attn_chunk,
                                  act_spec=act_spec)
        return constrain(h, act_spec)

    def dec_body(p_l, x, enc):
        p_l = _gather_fsdp(p_l, act_spec)
        kv = B.cross_kv(p_l, enc, cfg)
        return constrain(B.cross_layer_train(p_l, x, kv, cfg=cfg, positions=positions,
                                             act_spec=act_spec), act_spec), kv

    enc_body, dec_body = _maybe_remat(enc_body, remat), _maybe_remat(dec_body, remat)
    for p_l in _layers(params["enc_layers"], cfg.n_encoder_layers):
        enc = enc_body(p_l, enc)
    for i, p_l in enumerate(_layers(params["dec_layers"], cfg.n_layers)):
        x, kv = dec_body(p_l, x, enc)
        if cross_cache is not None:
            cross_cache["k"][i].copy_(kv["k"].detach())
            cross_cache["v"][i].copy_(kv["v"].detach())
    return x


class _VocabParallelNLL(torch.autograd.Function):
    """Per-position NLL of DTensor logits (N, V), the vocabulary sharded or
    not, on each device's shard (Megatron's vocab-parallel cross-entropy): the
    row max, the sum of exponentials and the target's logit reduce over the
    vocabulary's mesh dims, N values each, and the backward is the local
    softmax less the target's one-hot. The logits are never gathered, and
    no DTensor operator chooses the layout (torch's ``loss_parallel`` takes
    a 1-D mesh only)."""

    @staticmethod
    def forward(ctx, logits, target):
        from torch.distributed import _functional_collectives as funcol

        _refuse_partial(logits, target)
        mesh, pl = logits.device_mesh, tuple(logits.placements)
        vocab = [i for i, p in enumerate(pl) if p.is_shard(1)]
        rows = [Shard(0) if p.is_shard(0) else Replicate() for p in pl]
        x = logits.to_local().float()
        t = target.redistribute(mesh, rows).to_local()
        local_t = t - _vocab_offset(mesh, pl, 1, x.shape[1])
        inside = (local_t >= 0) & (local_t < x.shape[1])
        local_t = local_t.clamp(0, x.shape[1] - 1)

        def over_vocab(v, op):
            for i in vocab:
                v = funcol.all_reduce(v, op, (mesh, i))
                if isinstance(v, funcol.AsyncCollectiveTensor):
                    v = v.wait()
            return v

        m = over_vocab(x.amax(1), "max")
        e = torch.exp(x - m[:, None])
        total = over_vocab(e.sum(1), "sum")
        picked = over_vocab(torch.gather(x, 1, local_t[:, None])[:, 0] * inside, "sum")
        ctx.save_for_backward(e, total, local_t, inside)
        ctx.layout = (mesh, pl, rows, logits.shape, logits.stride())
        nll = torch.log(total) + m - picked
        return DTensor.from_local(nll, mesh, rows, run_check=False,
                                  shape=(logits.shape[0],), stride=(1,))

    @staticmethod
    def backward(ctx, grad):
        e, total, local_t, inside = ctx.saved_tensors
        mesh, pl, rows, shape, stride = ctx.layout
        g = grad.redistribute(mesh, rows).to_local()
        d = e / total[:, None]
        d.scatter_add_(1, local_t[:, None], -inside[:, None].to(d.dtype))
        d = d * g[:, None]
        return DTensor.from_local(d, mesh, pl, run_check=False, shape=shape,
                                  stride=stride), None


def loss_fn(params: dict, batch: dict, cfg: ArchConfig, **fw_kw):
    """Next-token loss: log-softmax NLL over the positions with ``labels >=
    0``, plus ``MOE_AUX_COEF`` times the routers' aux loss. Returns (total,
    {"loss", "aux"}); ``fw_kw`` go to :func:`forward`. DTensor logits take
    the vocab-parallel NLL (:class:`_VocabParallelNLL`), which gathers no
    logits (DTensor's gather replicates its backward's zeros); partial sums
    (a product that contracted a sharded dim, where no ``logits_spec``
    placed the logits) are reduced first."""
    logits, aux = forward(params, batch, cfg, **fw_kw)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    if isinstance(logits, DTensor):
        nll = _VocabParallelNLL.apply(_summed(logits).flatten(0, 1), labels.flatten().long())
        loss = (nll * mask.flatten()).sum() / mask.sum().clamp(min=1.0)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None].long())[..., 0]
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
    sites; for the audio family ``{"dec_layers": {"k", "v": (L, B, S, K,
    hd)}, "cross": {"k", "v": (L, B, encoder_len, K, hd)}}``, the cross K/V
    zeros until a prefill fills them. Uniform-sliding-window archs get a
    ring buffer of window size instead of max_len, as in the JAX package."""
    _known_family(cfg)
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
    if cfg.family == "audio":
        shape = (cfg.n_layers, batch, cfg.encoder_len, cfg.n_kv_heads, cfg.hd)
        return {"dec_layers": kv(cfg.n_layers),
                "cross": {"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)}}
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
                mla_absorb: bool = True, service=None, act_spec=None, logits_spec=None):
    """token: (B, 1) int; pos: an int, or for the GQA families (B,)
    per-sequence positions (continuous batching). Returns (logits (B, V)
    f32, cache): the cache is updated in place (each layer's entry written
    at ``pos``, each Mamba2 layer's state advanced) and returned.
    ``mla_absorb`` picks MLA's decode schedule. ``service`` routes the GQA
    output projection, the unembed and — where the arch's window schedule is
    statically empty — single-token attention through tuned dispatch
    variants; the audio family's decoder layers pass none (as in the JAX
    package), so only its unembed dispatches, and its ``pos`` is an int.
    ``act_spec`` and ``logits_spec`` (DTensor placements) constrain the
    residual stream after the embedding and after each layer, and the
    logits, as in :func:`forward` (the JAX package's decode takes none: XLA
    carries the cache's batch sharding into the token's stream)."""
    _known_family(cfg)
    x = constrain(_embed(params["embed"], token).to(cfg.dtype), act_spec)
    if cfg.name.startswith("gemma"):
        x = x * _embed_scale(cfg)
    moe = cfg.family == "moe"

    def layer(stack: dict, i: int) -> dict:
        return _gather_fsdp(_layer(stack, i), act_spec)

    if cfg.family == "audio":
        for i in range(cfg.n_layers):
            x, _ = B.cross_layer_decode(layer(params["dec_layers"], i), x,
                                        _layer(cache["dec_layers"], i),
                                        _layer(cache["cross"], i), pos, cfg=cfg)
            x = constrain(x, act_spec)
    elif cfg.family in ("ssm", "hybrid"):
        site = 0
        for i in range(cfg.n_layers):
            x, _ = B.mamba_layer_decode(layer(params["layers"], i), x,
                                        _layer(cache["layers"], i), cfg=cfg)
            x = constrain(x, act_spec)
            if _closes_segment(cfg, i):
                x, _, _ = B.attn_layer_decode(_gather_fsdp(params["shared_attn"], act_spec), x,
                                              _layer(cache["shared_attn"], site), pos,
                                              cfg=cfg, window=None, service=service)
                x = constrain(x, act_spec)
                site += 1
    else:
        if "dense0" in params:
            x, _, _ = B.attn_layer_decode(_gather_fsdp(params["dense0"], act_spec), x,
                                          cache["dense0"], pos, cfg=cfg, window=None,
                                          mla_absorb=mla_absorb, service=service)
            x = constrain(x, act_spec)
        windows = B.layer_windows(cfg)[cfg.first_dense_layers:]
        for i, w in enumerate(windows):
            x, _, _ = B.attn_layer_decode(layer(params["layers"], i), x,
                                          _layer(cache["layers"], i),
                                          pos, cfg=cfg, window=int(w), moe=moe,
                                          mla_absorb=mla_absorb, service=service)
            x = constrain(x, act_spec)
    x = rms_norm(x, params["final_norm"])
    unembed = _gather_fsdp({"w": _unembed(params, cfg, service)}, act_spec)["w"]
    logits = constrain(service_matmul(x, unembed, service), logits_spec)
    return logits[:, 0, :].float(), cache
