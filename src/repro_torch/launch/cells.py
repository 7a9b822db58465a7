"""Dry-run cells: input specs (meta-tensor stand-ins) and the step per
(architecture x shape x mesh) — shared by dryrun.py, the roofline harness,
and the distributed-config autotuner; the counterpart of
``repro.launch.cells``.

:func:`build_cell` is the counterpart of the reference's ``lower_cell``:
it places the parameters, the optimizer state, the batch and the cache on
the mesh as DTensors by the sharding rules (``repro_torch.parallel``) and
returns the step to trace, with ``aux`` for reporting. On a mesh over a
fake world (``launch.mesh.fake_world``) every local shard is a meta tensor,
so nothing is allocated: ``repro_torch.perf.op_cost.trace_step`` runs the
cell and counts one device's work. No dispatch service is passed, as in the
reference, so no hand-written kernel is on this path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs import SHAPES, ShapeSpec, cell_supported, get_config
from repro_torch.models.common import ArchConfig
from repro_torch.models.model import abstract_params, decode_step, forward, init_cache
from repro_torch.parallel.sharding import (
    ShardingProfile,
    Spec,
    axis_sizes,
    batch_specs,
    cache_specs,
    distribute,
    make_profile,
    named,
    param_specs,
    placement_mesh,
)
from repro_torch.train.optim import adamw_init
from repro_torch.train.step import make_train_step

__all__ = ["CellPlan", "Cell", "input_specs", "plan_cell", "build_cell", "model_flops",
           "activation_placements", "DEFAULT_KNOBS"]

# per-cell tunable knobs (the distributed-config autotuner's space)
DEFAULT_KNOBS = dict(
    accum=1,            # gradient-accumulation microbatches
    remat="full",       # none | dots | full
    attn_chunk=512,     # flash-style query chunk
    ssm_chunk=128,      # SSD chunk length
    mla_absorb=True,    # MLA decode schedule
    moment_dtype="float32",
    seq_parallel=False, # shard the residual stream's seq dim over `model`
)


def _accum_default(cfg: ArchConfig, shape: ShapeSpec, n_data: int) -> int:
    """Keep per-microbatch device tokens <= ~8k for the big archs."""
    per_dev_batch = max(shape.global_batch // max(n_data, 1), 1)
    tokens = per_dev_batch * shape.seq_len
    if cfg.param_count() > 30e9:
        target = 8_192
    elif cfg.param_count() > 3e9:
        target = 16_384
    else:
        target = 65_536
    accum = 1
    while tokens // accum > target and per_dev_batch % (accum * 2) == 0:
        accum *= 2
    return accum


@dataclasses.dataclass
class CellPlan:
    arch: str
    shape: ShapeSpec
    cfg: ArchConfig
    profile: ShardingProfile
    knobs: dict
    chips: int

    @property
    def kind(self) -> str:
        return self.shape.kind


@dataclasses.dataclass
class Cell:
    """The cell's step and its arguments (DTensors on the mesh):
    ``trace_step(cell.fn, *cell.args)`` counts it, ``cell()`` runs it."""

    fn: Callable
    args: tuple

    def __call__(self):
        return self.fn(*self.args)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Meta-tensor stand-ins for every model input of this cell."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": meta((B, S), i32)}
        if shape.kind == "train":
            specs["labels"] = meta((B, S), i32)
        if cfg.mrope:
            specs["positions"] = meta((B, 3, S), i32)
        if cfg.family == "audio":
            specs["enc_embed"] = meta((B, cfg.encoder_len, cfg.d_model), cfg.dtype)
        return specs
    # decode: one new token against a seq-length cache
    return {"token": meta((B, 1), i32), "pos": meta((), i32)}


def plan_cell(arch: str, shape_name: str, mesh, knobs: dict | None = None) -> CellPlan:
    cfg = get_config(arch)
    if knobs and "cfg_overrides" in knobs:
        cfg = dataclasses.replace(cfg, **knobs["cfg_overrides"])
    shape = SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape_name)
    if not ok:
        raise ValueError(f"{arch} x {shape_name}: {reason}")
    profile = make_profile(mesh, shape.kind, shape.global_batch)
    merged = dict(DEFAULT_KNOBS)
    sizes = axis_sizes(mesh)
    n_data = 1
    for a in profile.batch_axes:
        n_data *= sizes[a]
    merged["accum"] = _accum_default(cfg, shape, n_data)
    if knobs:
        merged.update(knobs)
    chips = 1
    for a in sizes:
        chips *= sizes[a]
    return CellPlan(arch, shape, cfg, profile, merged, chips)


def model_flops(plan: CellPlan) -> float:
    """6*N_active*D for train; 2*N_active*D for a forward/prefill; 2*N_active
    per token for decode."""
    cfg = plan.cfg
    n = cfg.active_param_count()
    B, S = plan.shape.global_batch, plan.shape.seq_len
    if plan.kind == "train":
        return 6.0 * n * B * S
    if plan.kind == "prefill":
        return 2.0 * n * B * S
    return 2.0 * n * B  # decode: one token per request


def activation_placements(plan: CellPlan, mesh, *, seq_parallel: bool = False):
    """(act_spec, logits_spec) as DTensor placements on ``mesh``'s placement
    mesh (``parallel.sharding.placement_mesh``): the residual stream (batch
    axes, the sequence over ``model`` under ``seq_parallel``, None) and the
    logits (batch axes, None, vocab over ``model`` where it divides), the
    reference's ``P(...)`` at ``lower_cell``."""
    profile, cfg = plan.profile, plan.cfg
    b_axes = profile.batch_axes or None
    tp = profile.tp_axis
    act = Spec(b_axes, tp if seq_parallel else None, None)
    logits = Spec(b_axes, None, tp if cfg.vocab_size % axis_sizes(mesh)[tp] == 0 else None)
    dmesh, join = placement_mesh(mesh)
    return named(dmesh, join(act)), named(dmesh, join(logits))


def build_cell(plan: CellPlan, mesh, params: dict | None = None) -> tuple[Cell, dict]:
    """The cell's step on ``mesh`` (the counterpart of ``lower_cell``):
    params (``params``, a parameter tree of the global shapes, or the meta
    tree of ``abstract_params``) and, for train, the AdamW moments in the
    knobs' ``moment_dtype``, placed by ``param_specs``; the batch by
    ``batch_specs``; a decode cell's cache (``init_cache`` on meta) by
    ``cache_specs``, its step given the residual stream's and the logits'
    placements too (the reference's decode takes none). The specs are the
    reference's, taken on ``mesh``; the DTensors live on its placement mesh.
    Returns (cell, aux): aux has chips / model_flops / arch / shape / kind /
    knobs, the reference's keys."""
    cfg, shape, profile, knobs = plan.cfg, plan.shape, plan.profile, plan.knobs
    dmesh, join = placement_mesh(mesh)
    params_g = abstract_params(cfg) if params is None else params
    p_specs = param_specs(params_g, mesh, profile, cfg)
    params_d = distribute(params_g, dmesh, join(p_specs))
    inputs = input_specs(cfg, shape)

    def placed(tree):
        return distribute(tree, dmesh, join(batch_specs(tree, mesh, profile)))

    if plan.kind == "train":
        opt = adamw_init(params_g, getattr(torch, knobs["moment_dtype"]))
        opt_d = distribute(opt, dmesh, join({"m": p_specs, "v": p_specs, "step": Spec()}))
        act_spec, logits_spec = activation_placements(
            plan, mesh, seq_parallel=bool(knobs.get("seq_parallel")))
        step = make_train_step(cfg, accum=knobs["accum"], remat=knobs["remat"],
                               attn_chunk=knobs["attn_chunk"], ssm_chunk=knobs["ssm_chunk"],
                               act_spec=act_spec, logits_spec=logits_spec)
        cell = Cell(step, (params_d, opt_d, placed(inputs)))
    elif plan.kind == "prefill":
        act_spec, logits_spec = activation_placements(plan, mesh)

        def prefill_fn(params, batch):
            with torch.no_grad():
                logits, _ = forward(params, batch, cfg, remat="none",
                                    attn_chunk=knobs["attn_chunk"],
                                    ssm_chunk=knobs["ssm_chunk"],
                                    act_spec=act_spec, logits_spec=logits_spec)
            return logits

        cell = Cell(prefill_fn, (params_d, placed(inputs)))
    else:  # decode
        B, S = shape.global_batch, shape.seq_len
        cache = init_cache(cfg, B, S, device="meta")
        cache_d = distribute(cache, dmesh, join(cache_specs(cache, mesh, profile, cfg)))
        act_spec, logits_spec = activation_placements(plan, mesh)

        def serve_step(params, cache, token):
            with torch.no_grad():
                return decode_step(params, cache, token, S - 1, cfg,
                                   mla_absorb=knobs["mla_absorb"], act_spec=act_spec,
                                   logits_spec=logits_spec)

        cell = Cell(serve_step, (params_d, cache_d, placed(inputs["token"])))

    aux = {
        "chips": plan.chips,
        "model_flops": model_flops(plan),
        "arch": plan.arch,
        "shape": shape.name,
        "kind": plan.kind,
        "knobs": dict(knobs),
    }
    return cell, aux
