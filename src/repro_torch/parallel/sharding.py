"""Sharding rules: logical layout -> DTensor placements for params, batches,
optimizer state and caches, per mesh and per shape-kind profile — the
counterpart of ``repro.parallel.sharding``, whose rules this module keeps
verbatim in logic.

Layout policy (the reference's):

  * ``model`` axis — tensor parallelism: attention heads / FFN columns /
    expert hidden dims / vocab (Megatron 2-collective pattern);
  * ``data`` (+ ``pod``) axes — batch parallelism AND parameter storage
    sharding (FSDP/ZeRO-3): weight matrices shard their contraction dim over
    the fsdp axes; DTensor's sharding propagation inserts the all-gathers at
    use and the reductions on the gradients. Optimizer state inherits the
    param sharding (ZeRO);
  * experts shard over the largest divisible combination of (pod, data),
    falling back to FSDP on d_model when E doesn't divide (mixtral's 8
    experts on a 16-wide data axis);
  * decode profiles shard batch over (pod, data); the batch=1 long-context
    profile parks everything on model/fsdp axes instead.

A spec (:class:`Spec`) is a tuple with one entry per tensor dim, each entry
``None``, a mesh axis name, or a tuple of names; it equals the reference's
``PartitionSpec`` entry by entry. A mesh is anything with axis names and a
size per name: the reference's duck-typed meshes (``axis_names`` and a
``shape`` dict) or torch's ``DeviceMesh`` (``mesh_dim_names`` and a tuple
``shape``), read through :func:`axis_sizes`. :func:`named` turns specs into
DTensor placements: ``Shard(d)`` on each mesh dim that names tensor dim
``d``, ``Replicate()`` elsewhere.

Specs are taken on the reference's tree, ``models.trainable(params)``. A
served parameter set's ``embed_t`` (the tied unembed's contiguous
transpose, ``(d_model, V)``) is placed as the reference places an untied
``unembed`` of that shape (:func:`param_specs` reads the leaf name
``embed_t`` as ``unembed``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.common import ArchConfig
from repro_torch.tree import tree_map, tree_map_with_path

__all__ = ["Spec", "ShardingProfile", "make_profile", "param_specs", "batch_specs",
           "cache_specs", "named", "mesh_axis_size", "axis_sizes", "distribute",
           "local_shape", "placement_mesh", "OnMesh"]


class Spec(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis name, or
    a tuple of axis names)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _ax(a):
    """Canonical spec entry: a singleton axis tuple means the same sharding
    as the bare axis name — unwrap it so specs compare cleanly."""
    if isinstance(a, tuple) and len(a) == 1:
        return a[0]
    return a


def axis_sizes(mesh) -> dict:
    """{axis name: size} of ``mesh``: a torch ``DeviceMesh`` (names in
    ``mesh_dim_names``, sizes in the tuple ``shape``) or a mesh with
    ``axis_names`` and a ``shape`` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _axis_names(mesh) -> tuple:
    return tuple(axis_sizes(mesh))


def mesh_axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


@dataclasses.dataclass(frozen=True)
class ShardingProfile:
    """Resolved layout choice for one (mesh, shape-kind, batch) cell."""

    batch_axes: tuple          # shards the global batch dimension
    fsdp_axes: tuple           # shards parameter storage (ZeRO-3)
    tp_axis: str = "model"

    def batch_spec(self, extra_dims: int = 1) -> Spec:
        return Spec(_ax(self.batch_axes) if self.batch_axes else None,
                    *([None] * extra_dims))


def make_profile(mesh, kind: str, global_batch: int) -> ShardingProfile:
    axes = list(_axis_names(mesh))
    dp_axes = tuple(a for a in ("pod", "data") if a in axes)
    dp = mesh_axis_size(mesh, dp_axes)

    if kind in ("train", "prefill"):
        batch_axes = dp_axes if global_batch % dp == 0 else _divisible_prefix(
            mesh, dp_axes, global_batch)
    else:  # decode / long
        batch_axes = _divisible_prefix(mesh, dp_axes, global_batch)
    return ShardingProfile(batch_axes=batch_axes, fsdp_axes=dp_axes)


def _divisible_prefix(mesh, axes: tuple, n: int) -> tuple:
    """Largest leading subset of ``axes`` whose product divides n."""
    sizes = axis_sizes(mesh)
    out: list = []
    prod = 1
    for a in axes:
        if n % (prod * sizes[a]) == 0:
            out.append(a)
            prod *= sizes[a]
        else:
            break
    return tuple(out)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

_IN_TP = {"wo", "wd", "xo", "out_proj"}           # contraction dim is TP'd
_OUT_TP = {"wq", "wk", "wv", "wu", "wg", "xq", "xk", "xv", "in_proj",
           "wq_a", "wq_b", "wkv_a", "wkv_b"}       # output dim is TP'd


def _divides(n: int, mesh, axes) -> bool:
    return n % mesh_axis_size(mesh, axes) == 0 if n else False


def _expert_axes(E: int, mesh, profile: ShardingProfile):
    names = _axis_names(mesh)
    for cand in (profile.fsdp_axes, ("data",), ("pod",)):
        cand = tuple(a for a in cand if a in names)
        if cand and _divides(E, mesh, cand):
            return cand
    return None


def _leaf_spec(path: tuple, shape: tuple, mesh, profile: ShardingProfile,
               cfg: ArchConfig) -> Spec:
    names = [str(k) for k in path]
    leaf = "unembed" if names[-1] == "embed_t" else names[-1]
    stacked = "layers" in names[:-1] or "enc_layers" in names[:-1] \
        or "dec_layers" in names[:-1]
    tp = profile.tp_axis
    fsdp = profile.fsdp_axes or None
    rank = len(shape)
    body = rank - 1 if stacked else rank  # dims excluding the leading L

    def with_stack(spec_dims: list) -> Spec:
        spec_dims = [_ax(d) for d in spec_dims]
        return Spec(None, *spec_dims) if stacked else Spec(*spec_dims)

    # embeddings: (V, d) — vocab over tp, d over fsdp
    if leaf in ("embed",):
        return Spec(tp if _divides(shape[0], mesh, tp) else None,
                    _ax(fsdp) if _divides(shape[1], mesh, fsdp) else None)
    if leaf == "unembed":
        return Spec(_ax(fsdp) if _divides(shape[0], mesh, fsdp) else None,
                    tp if _divides(shape[1], mesh, tp) else None)

    # MoE expert tensors: (L?, E, d_in, d_out)
    if "moe" in names and leaf in ("wg", "wu", "wd") and body == 3:
        E, d_in, d_out = shape[-3:]
        ep = _expert_axes(E, mesh, profile)
        used_fsdp = ep == (profile.fsdp_axes or ())
        din_ax = None
        if not used_fsdp and _divides(d_in, mesh, fsdp):
            remaining = tuple(a for a in (profile.fsdp_axes or ()) if not ep or a not in ep)
            if remaining and _divides(d_in, mesh, remaining):
                din_ax = remaining
        if leaf == "wd":  # (E, eff, d): eff is the TP dim
            dims = [ep, tp if _divides(d_in, mesh, tp) else None, None]
        else:             # (E, d, eff)
            dims = [ep, din_ax, tp if _divides(d_out, mesh, tp) else None]
        return with_stack(dims)
    if leaf == "router":
        return with_stack([fsdp if _divides(shape[-2], mesh, fsdp) else None, None])

    # 2D projection matrices
    if body == 2 and leaf in _OUT_TP:
        d_in, d_out = shape[-2:]
        return with_stack([
            fsdp if _divides(d_in, mesh, fsdp) else None,
            tp if _divides(d_out, mesh, tp) else None,
        ])
    if body == 2 and leaf in _IN_TP:
        d_in, d_out = shape[-2:]
        return with_stack([
            tp if _divides(d_in, mesh, tp) else None,
            fsdp if _divides(d_out, mesh, fsdp) else None,
        ])
    if body == 2 and leaf == "conv_w":
        return with_stack([None, tp if _divides(shape[-1], mesh, tp) else None])

    # everything else (norm scales, biases, A_log, ...): replicate
    return with_stack([None] * body)


def param_specs(abstract_params: Any, mesh, profile: ShardingProfile, cfg: ArchConfig):
    """Spec tree mirroring the (abstract) parameter tree."""
    return tree_map_with_path(
        lambda path, leaf: _leaf_spec(path, tuple(leaf.shape), mesh, profile, cfg),
        abstract_params)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------


def batch_specs(batch_abstract: Any, mesh, profile: ShardingProfile):
    b = _ax(profile.batch_axes) if profile.batch_axes else None

    def spec(path, leaf):
        return Spec(b, *([None] * (len(leaf.shape) - 1)))

    return tree_map_with_path(spec, batch_abstract)


def cache_specs(cache_abstract: Any, mesh, profile: ShardingProfile, cfg: ArchConfig):
    """KV caches: (L, B, S, K, hd) — batch over batch_axes, then K over tp if
    divisible else hd; MLA latents: (L, B, S, lora) — lora over tp; SSM state:
    (L, B, H, P, N) — H over tp."""
    b = _ax(profile.batch_axes) if profile.batch_axes else None
    tp = profile.tp_axis
    ntp = axis_sizes(mesh)[tp]

    def spec(path, leaf):
        names = [str(k) for k in path]
        leafname = names[-1]
        shp = tuple(leaf.shape)
        stacked = len(shp) >= 1 and any(
            n in ("layers", "dec_layers", "enc_layers", "cross", "shared_attn")
            for n in names)
        if leafname in ("k", "v"):
            L, B, S, K, hd = shp if stacked else ((1,) + shp)[-5:]
            head_ax = tp if K % ntp == 0 else None
            hd_ax = tp if head_ax is None and hd % ntp == 0 else None
            dims = [b, None, head_ax, hd_ax]
            return Spec(None, *dims) if stacked else Spec(*dims)
        if leafname in ("c_kv", "k_rope"):
            dims = [b, None, tp if shp[-1] % ntp == 0 else None]
            return Spec(*([None] * (len(shp) - 3)), *dims)
        if leafname == "conv":
            dims = [b, None, tp if shp[-1] % ntp == 0 else None]
            return Spec(*([None] * (len(shp) - 3)), *dims)
        if leafname == "ssm":
            dims = [b, tp if shp[-3] % ntp == 0 else None, None, None]
            return Spec(*([None] * (len(shp) - 4)), *dims)
        return Spec(*([None] * len(shp)))

    return tree_map_with_path(spec, cache_abstract)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------


def _placements(mesh, spec: Spec) -> tuple:
    names = _axis_names(mesh)
    dim_of: dict = {}
    for d, entry in enumerate(spec):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            # DTensor splits a dim over several mesh dims in mesh order
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not in the mesh's "
                             f"order {names}")
        for a in axes:
            if a in dim_of:
                raise ValueError(f"spec {spec}: mesh axis {a!r} shards dims {dim_of[a]} "
                                 f"and {d}")
            dim_of[a] = d
    # a mesh dim of size 1 (the card's own (1, 1) mesh) splits nothing:
    # Replicate, the same layout, which every DTensor operator takes
    sizes = axis_sizes(mesh)
    return tuple(Shard(dim_of[a]) if a in dim_of and sizes[a] > 1 else Replicate()
                 for a in names)


def named(mesh, spec_tree):
    """The DTensor placements (one per mesh dim) of each spec in
    ``spec_tree`` (an :class:`OnMesh` spec's on its own mesh)."""
    if isinstance(spec_tree, Spec):
        return _placements(getattr(spec_tree, "mesh", mesh), spec_tree)
    return tree_map(lambda s: named(mesh, s), spec_tree)


def local_shape(shape: tuple, mesh, spec: Spec) -> tuple:
    """The shape of one device's shard of a ``shape`` tensor under ``spec``;
    every sharded dim must divide."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = mesh_axis_size(mesh, entry)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {entry} ({n})")
        out[d] //= n
    return tuple(out)


def distribute(tree: Any, mesh, spec_tree: Any):
    """``tree``'s tensors as DTensors on the torch ``DeviceMesh`` ``mesh``,
    placed by ``spec_tree``. This process's shard is its slice of each
    global tensor (a view; no communication), or for a meta tensor an empty
    meta tensor of the shard's shape, so a device-free trace allocates
    nothing. An :class:`OnMesh` spec places its tensor on its own mesh."""

    def one(t, spec):
        mesh_t = getattr(spec, "mesh", mesh)
        coord, names = mesh_t.get_coordinate(), _axis_names(mesh_t)
        spec = Spec(*spec, *([None] * (t.ndim - len(spec))))
        shard = local_shape(tuple(t.shape), mesh_t, spec)
        if t.device.type == "meta":
            local = torch.empty(shard, dtype=t.dtype, device="meta")
        else:
            local = t
            for d, entry in enumerate(spec):
                if entry is None:
                    continue
                axes = (entry,) if isinstance(entry, str) else tuple(entry)
                idx = 0
                for a in axes:  # mesh order: the first axis is the outermost split
                    idx = idx * axis_sizes(mesh_t)[a] + coord[names.index(a)]
                local = local.narrow(d, idx * shard[d], shard[d])
        stride = tuple(math.prod(t.shape[i + 1:]) for i in range(t.ndim))
        return DTensor.from_local(local, mesh_t, _placements(mesh_t, spec), run_check=False,
                                  shape=t.shape, stride=stride)

    return tree_map(one, tree, spec_tree)


# ---------------------------------------------------------------------------
# the multi-pod mesh: (pod, data) joined
# ---------------------------------------------------------------------------

POD_DATA = "pod+data"


class OnMesh(Spec):
    """A spec whose tensor lives on ``mesh``, a mesh of its own, instead of
    the placement mesh of the tree around it (:func:`distribute` and
    :func:`named` read ``mesh``). It compares equal to the plain spec."""

    mesh: Any

    def __new__(cls, spec: Spec, mesh):
        out = super().__new__(cls, *spec)
        out.mesh = mesh
        return out


def _axes_of(entry) -> tuple:
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


def _join_spec(spec: Spec, mesh=None) -> Spec:
    """``spec`` on the joined mesh; or, for an expert tensor (``mesh``
    given: the multi-pod mesh itself) that shards a dim over ``pod`` or
    ``data`` alone, the spec as it is on ``mesh``, where each tensor dim is
    sharded by one mesh dim (``models.moe`` runs the experts' products
    there). Raises ``ValueError`` for a spec neither mesh can place."""
    out = []
    for entry in spec:
        axes = _axes_of(entry)
        dp = tuple(a for a in axes if a in ("pod", "data"))
        if dp and dp != ("pod", "data"):
            if mesh is None:
                raise ValueError(f"spec {spec} shards a dim over {dp} alone; the multi-pod "
                                 f"placement joins pod and data into one mesh dim, and only "
                                 f"the experts' tensors are placed on (pod, data, model)")
            if any(len(_axes_of(e)) > 1 for e in spec):
                raise ValueError(f"spec {spec} shards a dim over {dp} alone and another "
                                 f"over two mesh dims: the joined mesh cannot place the "
                                 f"first, and DTensor's operators refuse the second on the "
                                 f"(pod, data, model) mesh")
            return OnMesh(spec, mesh)
        rest = tuple(a for a in axes if a not in ("pod", "data"))
        joined = ((POD_DATA,) if dp else ()) + rest
        out.append(_ax(joined) if joined else None)
    return Spec(*out)


def placement_mesh(mesh):
    """(the mesh to place a cell's DTensors on, the map of its specs onto
    that mesh). For the multi-pod ``("pod", "data", "model")`` mesh, a
    ``("pod+data", "model")`` mesh over the same ranks in the same order,
    where every spec's ``("pod", "data")`` becomes the one joined dim: the
    same layout, and a dim sharded over one mesh dim instead of two
    (DTensor's operators refuse most tensors sharded twice on one dim,
    ``[Shard(0), Shard(0)]``, in the torch releases before 2.13). The
    experts' tensors of a tree (the leaves under a ``moe`` key) that shard
    over ``pod`` or ``data`` alone (mixtral's 8 experts on ``pod``) stay on
    the multi-pod mesh itself, as :class:`OnMesh` specs; any other spec
    that does (a bare spec included) raises ``ValueError``. Any other mesh
    is its own placement mesh."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if names != ("pod", "data", "model"):
        return mesh, lambda tree: tree
    from torch.distributed.device_mesh import init_device_mesh

    sizes = axis_sizes(mesh)
    flat = init_device_mesh(mesh.device_type, (sizes["pod"] * sizes["data"], sizes["model"]),
                            mesh_dim_names=(POD_DATA, "model"))

    def join(tree):
        if isinstance(tree, Spec):
            return _join_spec(tree)
        return tree_map_with_path(
            lambda path, spec: _join_spec(spec, mesh if "moe" in path else None), tree)

    return flat, join
