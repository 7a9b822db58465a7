"""Static config feasibility — the counterpart of
``repro.analyze.feasibility``.

Declarative per-kernel constraint rules that judge a configuration against
the problem dimensions *without building or launching anything*: structural
validity (required params present, tiles positive integers, variant choices
known, fuse factors dividing the step count, pages dividing the seq
bucket), the card's resource limit (:class:`SmemBudget`: the kernel's own
shared memory per block against the device's, target ``gpu``), schedule
smells on Hopper (:class:`TileAlign`: tile extents off the CUDA kernels'
padding grids; :class:`PaddingWaste`: padded work against useful work,
targets ``gpu`` and ``cost``), and grid-size sanity.

The structural rules and :class:`GridBound` are copies of the JAX
package's. Its TPU rules (``VmemBudget``, ``MxuAlign``, ``LcmPadding``)
read the v5e model of ``repro.kernels.cost``; the port's cost model
(:mod:`repro_torch.kernels.cost`) models Hopper. :class:`SmemBudget` stands
for ``VmemBudget`` (its numbers, :func:`smem_needs`, are the ones the cost
model's infeasibility reads), :class:`TileAlign` for ``MxuAlign`` and
:class:`PaddingWaste` for ``LcmPadding``. The ``host`` target keeps no
``LcmPadding``: the port's kernels never pad a dim to ``lcm(bi, bj)``, so
its ``host`` warnings are the JAX package's less ``padding_waste``.

Findings carry a stable machine-readable ``code`` (e.g.
``tile_not_positive:bi``, ``smem_overflow``) and a ``severity``:

  * ``"error"`` — the config is invalid: its builder would fail, or the
    kernel's wrapper would refuse it before launch (``ConfigRejected``).
    Errors make :attr:`Feasibility.ok` false; the search path prunes these
    before acquisition scoring and ``DispatchService`` quarantines matching
    store records before its build guard runs.
  * ``"warn"`` — the config builds but is pathological: misaligned tiles,
    heavy padding waste, oversized grids. Warnings never prune or
    quarantine; they feed the ``launch.analyze space`` audit.

The severity split is what keeps the pass zero-false-positive: a config is
only ever rejected for a reason that is *provably* fatal for that builder,
which the accepted-implies-builds property test pins for every registered
kernel.

Rules for new kernels go through :func:`register_rules`; kernels with no
registered rules (toy test kernels, third-party registrations) are treated
as feasible — the pass never guesses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, Mapping, Sequence

__all__ = [
    "Feasibility",
    "Finding",
    "KERNEL_RULES",
    "check_config",
    "feasibility_filter",
    "kernel_rules",
    "register_rules",
    "smem_findings",
    "smem_limit",
    "smem_needs",
]

ERROR = "error"
WARN = "warn"

# grid-step budget before a schedule is flagged as pathological: the kernel
# still runs above this, it just spends its life in per-step overhead
# (warn-only)
GRID_WARN_STEPS = 1 << 20
# the padded tiles' operations (the cost model's, kernels/cost.py) over the
# useful ones above which a schedule is flagged (warn-only): the JAX
# package's PAD_WASTE_RATIO
PAD_WASTE_RATIO = 1.5


@dataclass(frozen=True)
class Finding:
    """One rule hit. ``code`` is stable across releases (tests and
    quarantine records key on it); ``message`` is for humans."""

    code: str
    severity: str
    message: str
    param: str | None = None

    def to_dict(self) -> dict:
        d = {"code": self.code, "severity": self.severity,
             "message": self.message}
        if self.param is not None:
            d["param"] = self.param
        return d


@dataclass(frozen=True)
class Feasibility:
    """Verdict for one (kernel, config, dims, target) combination."""

    findings: tuple[Finding, ...] = field(default_factory=tuple)

    @property
    def ok(self) -> bool:
        return not any(f.severity == ERROR for f in self.findings)

    @property
    def errors(self) -> tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == ERROR)

    @property
    def warnings(self) -> tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == WARN)

    @property
    def reasons(self) -> tuple[str, ...]:
        """Stable error codes — what lands in quarantine records."""
        return tuple(f.code for f in self.errors)

    def reason(self) -> str:
        """Single machine-readable reason string (codes joined by ``,``)."""
        return ",".join(self.reasons)


FEASIBLE = Feasibility()


@dataclass(frozen=True)
class RuleContext:
    """What a rule may consult besides the config itself."""

    kernel: str
    dims: tuple | None    # problem dims (kernels.problems order), if known
    target: str           # "gpu" | "host"
    # the operands' dtype where the caller knows it (a signature carries
    # none, and a store record serves both f32 and bf16 calls): None, either
    dtype: object = None


class Rule:
    """Base class: a rule inspects (config, context) and yields findings.

    Rules must be total — any config dict, any dims (including ``None``)
    — and must never launch anything at check time."""

    def check(self, cfg: Mapping, ctx: RuleContext) -> Iterator[Finding]:
        raise NotImplementedError

    def describe(self) -> str:
        return self.__class__.__name__


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


class RequiredParams(Rule):
    """Params the builder reads with ``cfg[name]`` — absence is a KeyError
    at build time, so it is an error here."""

    def __init__(self, *names: str):
        self.names = names

    def check(self, cfg, ctx):
        for name in self.names:
            if name not in cfg:
                yield Finding(f"missing_param:{name}", ERROR,
                              f"builder requires {name!r}", name)

    def describe(self):
        return f"required params: {', '.join(self.names)}"


class PositiveIntTiles(Rule):
    """Tile/block params must be positive integers: ``cdiv`` by zero and
    negative reshapes are build-time failures."""

    def __init__(self, *names: str):
        self.names = names

    def check(self, cfg, ctx):
        for name in self.names:
            if name not in cfg:
                continue  # RequiredParams owns absence
            v = cfg[name]
            if not _is_int(v):
                yield Finding(f"tile_not_int:{name}", ERROR,
                              f"{name}={v!r} is not an integer tile", name)
            elif v <= 0:
                yield Finding(f"tile_not_positive:{name}", ERROR,
                              f"{name}={v} must be positive", name)

    def describe(self):
        return f"positive integer tiles: {', '.join(self.names)}"


class ChoiceIn(Rule):
    """Variant-selector params the builder dispatches on (and raises for
    unknown values)."""

    def __init__(self, name: str, choices: Sequence):
        self.name = name
        self.choices = tuple(choices)

    def check(self, cfg, ctx):
        if self.name in cfg and cfg[self.name] not in self.choices:
            yield Finding(
                f"invalid_choice:{self.name}", ERROR,
                f"{self.name}={cfg[self.name]!r} not in {self.choices}",
                self.name)

    def describe(self):
        return f"{self.name} in {self.choices}"


class FuseDivides(Rule):
    """heat-3d: the builder asserts ``(2 * tsteps) % fuse_t == 0`` — a
    non-dividing fuse factor is a hard build failure."""

    def __init__(self, name: str = "fuse_t"):
        self.name = name

    def check(self, cfg, ctx):
        h = cfg.get(self.name, 1)
        if not _is_int(h) or h <= 0:
            yield Finding(f"fuse_not_positive:{self.name}", ERROR,
                          f"{self.name}={h!r} must be a positive integer",
                          self.name)
            return
        if ctx.dims is None or len(ctx.dims) < 2:
            return
        total = 2 * int(ctx.dims[1])
        if total % h != 0:
            yield Finding(
                f"fuse_indivisible:{self.name}", ERROR,
                f"{self.name}={h} does not divide 2*tsteps={total}",
                self.name)

    def describe(self):
        return f"{self.name} divides 2*tsteps"


class PageDividesSeq(Rule):
    """Paged-KV layout contract: the dispatch signature's seq dim is the
    paged cache's *bucket* — by construction a multiple of the config's
    ``page`` (``serve.kvcache`` rounds every view up to page granularity).
    A record whose ``page`` does not divide the signature's S describes a
    layout that cannot have produced this signature: serving it would pair
    a tuned page size with buckets it never sees, so the mismatch is fatal
    for the (cache layout, kernel) pair even though the builder itself —
    which only reads the view it is handed — would trace fine."""

    def __init__(self, name: str = "page", dim_index: int = 2):
        self.name = name
        self.dim_index = dim_index

    def check(self, cfg, ctx):
        v = cfg.get(self.name)
        if not (_is_int(v) and v > 0):
            return  # PositiveIntTiles owns malformed values
        if ctx.dims is None or self.dim_index >= len(ctx.dims):
            return
        s = int(ctx.dims[self.dim_index])
        if s % v != 0:
            yield Finding(
                f"page_indivisible:{self.name}", ERROR,
                f"{self.name}={v} does not divide the seq bucket S={s}",
                self.name)

    def describe(self):
        return f"{self.name} divides the signature's seq bucket"


class SmemBudget(Rule):
    """Target ``gpu`` only: the shared memory one block of the kernel needs
    for this config at these dims, from the kernel's own
    ``*_smem_bytes(..., limit)``, against the device's per-block limit
    (:func:`~repro_torch.kernels.util.max_shared_memory_per_block`) — the
    same numbers the wrappers raise ``ConfigRejected`` on. ``smem_overflow``
    where even one ring stage does not fit, ``smem_unsupported`` where the
    kernel has no register tile for the tile (the functions' -1).

    The PolyBench kernels are f32 only. The model kernels' (flash and decode
    attention, matmul) bytes depend on the operands' dtype, ``ctx.dtype``
    where the caller knows it. Where it does not (a signature carries none,
    and a store record serves f32 and bf16 calls alike), the attention
    kernels are asked for bf16 operands, their smallest staging, and the
    matmul for both dtypes, the smaller answer (a bf16 tile past 8 rows
    answers the larger of its wgmma and mma.sync layouts, f32 its mma.sync
    layout or, where that stage does not fit, the FFMA loop's; tiles of at
    most 8 rows the split stream's), so the rule never refuses a config that
    fits; the build guard still catches a tile that does not fit the call's
    own dtype.

    Like the JAX package's ``VmemBudget`` on the host, the rule is inert
    where no card is present: the functions need the built library."""

    def check(self, cfg, ctx):
        if ctx.target != "gpu" or ctx.dims is None:
            return
        limit = smem_limit()
        if limit is None:
            return
        needs = (smem_needs(ctx.kernel, cfg, ctx.dims, limit) if ctx.dtype is None
                 else smem_needs(ctx.kernel, cfg, ctx.dims, limit, ctx.dtype))
        yield from smem_findings(needs, limit)

    def describe(self):
        return "shared memory per block within the device's limit (gpu)"


def smem_limit() -> int | None:
    """The current card's shared memory per block, or None without a card
    (the kernels' ``*_smem_bytes`` need the built library)."""
    import torch

    if not torch.cuda.is_available():
        return None
    from repro_torch.kernels.util import max_shared_memory_per_block

    return max_shared_memory_per_block(torch.device("cuda", torch.cuda.current_device()))


def smem_needs(kernel: str, cfg: Mapping, dims, limit: int,
               dtype=None) -> list[tuple[str, int]] | None:
    """``[(what, bytes), ...]``: the shared memory one block of each launch
    of ``kernel``'s schedule needs for ``cfg`` at ``dims`` under a per-block
    ``limit`` for operands of ``dtype`` (None: unknown, as
    :class:`SmemBudget` reads it; the PolyBench kernels are f32 only), from
    the kernels' own ``*_smem_bytes`` (-1 where the kernel has no register
    tile for the tile). None for a kernel without a table or a structurally
    invalid config (other rules' findings). Needs the built library: ask
    :func:`smem_limit` first."""
    needs = _SMEM_NEEDS.get(kernel)
    if needs is None:
        return None
    dims = tuple(int(d) for d in dims)
    try:
        if kernel in _MODEL_KERNELS:
            return needs(cfg, dims, limit, dtype)
        return needs(cfg, dims, limit)
    except (KeyError, TypeError, ValueError):
        # structurally invalid configs (a ConfigRejected for a non-positive
        # tile included) are other rules' findings
        return None


def smem_findings(parts, limit: int) -> Iterator[Finding]:
    """:class:`SmemBudget`'s verdict on :func:`smem_needs`'s parts:
    ``smem_unsupported`` for a -1, ``smem_overflow`` past ``limit``."""
    for what, smem in parts or ():
        if smem < 0:
            yield Finding("smem_unsupported", ERROR,
                          f"{what}: a tile the kernel has no register tile for")
        elif smem > limit:
            yield Finding("smem_overflow", ERROR,
                          f"{what} needs {smem:,} B of shared memory, the device "
                          f"allows {limit:,} B per block")


def _tiles(cfg, name: str, *keys: str) -> dict:
    """``cfg`` merged over the kernel's ``ops.DEFAULTS``, tiles as ints."""
    from repro_torch.kernels.ops import config_of

    kw = config_of(name, cfg)
    return {k: int(kw[k]) if k in keys else kw[k] for k in kw}


def _syr2k_smem(cfg, dims, limit):
    from repro_torch.kernels.syr2k import syr2k_smem_bytes

    N, M = dims
    c = _tiles(cfg, "syr2k", "bi", "bj", "bk")
    return [("syr2k", syr2k_smem_bytes(min(c["bi"], N), min(c["bj"], N), min(c["bk"], M),
                                       c["pack_a"], c["pack_b"], limit))]


def _matmul_smem(m, k, n, bm, bn, bk, limit, dtype):
    from repro_torch.kernels.matmul import matmul_smem_bytes

    return (f"matmul ({m}, {k}) @ ({k}, {n})",
            matmul_smem_bytes(min(bm, max(m, 1)), min(bn, max(n, 1)), min(bk, max(k, 1)),
                              dtype, limit))


def _mm3_smem(cfg, dims, limit):
    import torch

    P, Q, R, S, T = dims
    c = _tiles(cfg, "mm3", "bm", "bn", "bk")
    return [_matmul_smem(m, k, n, c["bm"], c["bn"], c["bk"], limit, torch.float32)
            for m, k, n in ((P, Q, R), (R, S, T), (P, R, T))]


def _lu_smem(cfg, dims, limit):
    import torch

    from repro_torch.kernels.lu import lu_factor_diag_smem_bytes

    (N,) = dims
    c = _tiles(cfg, "lu", "bs", "bm", "bn")
    bs = min(c["bs"], N)
    out = [(f"lu diagonal block {bs}", lu_factor_diag_smem_bytes(bs))]
    rest = -(-N // bs) * bs - bs
    if rest > 0:
        out.append(_matmul_smem(rest, bs, rest, c["bm"], c["bn"], bs, limit, torch.float32))
    return out


def _heat3d_smem(cfg, dims, limit):
    from repro_torch.kernels.heat3d import FUSE_T, heat3d_smem_bytes

    N, _ = dims
    c = _tiles(cfg, "heat3d", "bi", "fuse_t")
    if c["fuse_t"] not in FUSE_T:
        return []  # ChoiceIn owns it
    return [("heat3d", heat3d_smem_bytes((N, N, N), min(c["bi"], N), c["fuse_t"]))]


def _covariance_smem(cfg, dims, limit):
    from repro_torch.kernels.covariance import covariance_smem_bytes

    N, M = dims
    c = _tiles(cfg, "covariance", "bi", "bj", "bk")
    return [("covariance", covariance_smem_bytes(min(c["bi"], M), min(c["bj"], M),
                                                 min(c["bk"], N), limit))]


def _floyd_warshall_smem(cfg, dims, limit):
    from repro_torch.kernels.floyd_warshall import PANEL_TILE, minplus_smem_bytes

    (N,) = dims
    c = _tiles(cfg, "floyd_warshall", "bs", "bi", "bj")
    bs = min(c["bs"], N)
    Np = -(-N // bs) * bs
    bi, bj, pt = min(c["bi"], Np), min(c["bj"], Np), min(PANEL_TILE, Np)
    return [(f"min-plus tile {ti}x{tj} (bs={bs})", minplus_smem_bytes(ti, tj, bs, limit))
            for ti, tj in ((bi, bj), (bs, pt), (pt, bs))]


def _flash_smem(cfg, dims, limit, dtype):
    import torch

    from repro_torch.kernels.flash_attention import STEP, flash_attention_smem_bytes

    if cfg.get("impl", "pallas") != "pallas":
        return []
    _, Sq, Sk, hd = dims
    bq = min(int(cfg.get("bq", 128)), -(-Sq // STEP) * STEP)
    bk = min(int(cfg.get("bk", 128)), -(-Sk // STEP) * STEP)
    if bq < 1 or bk < 1:
        return []  # PositiveIntTiles owns it
    return [("flash_attention",
             flash_attention_smem_bytes(bq, bk, hd, dtype or torch.bfloat16, limit))]


def _decode_smem(cfg, dims, limit, dtype):
    import torch

    from repro_torch.kernels.decode_attention import (
        decode_attention_head_groups,
        decode_attention_smem_bytes,
    )

    if cfg.get("impl", "pallas") != "pallas":
        return []
    _, G, S, hd = dims
    bk = min(int(cfg.get("bk", 128)), S)
    if bk < 1:
        return []
    Gl = max(g1 - g0 for g0, g1 in decode_attention_head_groups(G, hd))
    return [("decode_attention",
             decode_attention_smem_bytes(Gl, bk, hd, dtype or torch.bfloat16))]


def _model_matmul_smem(cfg, dims, limit, dtype):
    import torch

    M, K, N = dims
    bm, bn, bk = (int(cfg.get(k, 128)) for k in ("bm", "bn", "bk"))
    if min(bm, bn, bk) < 1:
        return []
    asks = [_matmul_smem(M, K, N, bm, bn, bk, limit, dt)
            for dt in ((dtype,) if dtype is not None else (torch.float32, torch.bfloat16))]
    fits = [a for a in asks if a[1] >= 0]
    return [min(fits, key=lambda a: a[1]) if fits else asks[0]]


# the kernels whose shared memory depends on the operands' dtype (the
# PolyBench kernels are f32 only)
_MODEL_KERNELS = ("flash_attention", "decode_attention", "matmul")
_SMEM_NEEDS = {
    "syr2k": _syr2k_smem,
    "mm3": _mm3_smem,
    "lu": _lu_smem,
    "heat3d": _heat3d_smem,
    "covariance": _covariance_smem,
    "floyd_warshall": _floyd_warshall_smem,
    "flash_attention": _flash_smem,
    "decode_attention": _decode_smem,
    "matmul": _model_matmul_smem,
}


class TileAlign(Rule):
    """Targets ``gpu`` and ``cost``, the Hopper counterpart of the JAX
    package's ``MxuAlign``: the tile kernels on ``csrc/gemm_f32.cuh`` pad
    each tile extent to a multiple of its ``ALIGN`` (8). A matmul tile
    (``tc`` names its rows, columns and k chunk params) pads as the route
    ``csrc/matmul.cu`` takes for it (``kernels/cost.py:matmul_route``):
    past 8 rows, ``wgmma`` (bf16, pack on, K and N multiples of 8) pads
    rows and columns to ``WG_ROWS`` x ``WG_COLS`` (64) and rounds the chunk
    up with the operands' own k (no padding); ``mma.sync`` pads rows and
    columns to its warps' ``TC_PIECE`` (32) pieces and the chunk to its k
    (``MMA_K``: 8 for f32 operands, 16 for bf16; mm3 and lu are f32 only);
    the split stream (at most 8 rows) pads no chunk. Where ``ctx.dtype``
    is unknown each param is held to the smaller padding of the dtypes'
    routes (mm3's and lu's products, ``f32_only``, are f32). A tile off its
    grid computes padding in every block. ``axes``
    maps each tile param to the dim it tiles: a tile that covers its whole
    dim pads only the dim's own remainder, which no config avoids, so it is
    not flagged. One stable code a param, ``tile_misaligned:<name>``.
    Warn-only — the kernels pad and run."""

    def __init__(self, axes: Mapping[str, int], tc: tuple[str, str, str] | None = None,
                 f32_only: bool = False):
        self.axes = dict(axes)
        self.tc = tc
        self.f32_only = f32_only

    def _matmul_grids(self, cfg, ctx) -> dict:
        """param -> (grid, where) of the matmul's route for ``ctx.dtype``,
        the smaller grid of the two dtypes' routes where it is unknown."""
        from repro_torch.kernels.cost import MMA_K, TC_PIECE, WG_COLS, WG_ROWS, matmul_route

        rows, cols, k = self.tc
        rows_v = cfg.get(rows)
        if not (_is_int(rows_v) and rows_v > 0):
            return {}
        dims = ctx.dims if ctx.dims is not None and len(ctx.dims) == 3 else None
        M, K, N = dims if dims is not None else (rows_v, 8, 8)  # unknown dims: aligned
        pack = bool(cfg.get("pack", False))
        per_dtype = []
        sizes = ((4,) if self.f32_only else (ctx.dtype.itemsize,) if ctx.dtype is not None
                 else (4, 2))
        for size in sizes:
            route = matmul_route(int(M), int(K), int(N), int(rows_v), pack, size)
            if route == "wgmma":
                per_dtype.append({rows: (WG_ROWS, "the wgmma route's 64-row warpgroups"),
                                  cols: (WG_COLS, "the wgmma route's 64-column boxes"),
                                  k: (1, "")})
            elif route == "mma_sync":
                per_dtype.append({rows: (TC_PIECE, f"the mma.sync route's {TC_PIECE} x "
                                                   f"{TC_PIECE} warp pieces"),
                                  cols: (TC_PIECE, f"the mma.sync route's {TC_PIECE} x "
                                                   f"{TC_PIECE} warp pieces"),
                                  k: (MMA_K[size], f"the mma.sync route's k of "
                                                   f"{MMA_K[size]}")})
            else:  # the split stream: no chunk padding
                per_dtype.append({k: (1, "")})
        out = {}
        for name in (rows, cols, k):
            cands = [d[name] for d in per_dtype if name in d]
            if len(cands) == len(per_dtype):
                out[name] = min(cands)
            elif cands:  # a route that does not pad this param: the smaller padding
                out[name] = (1, "")
        return out

    def check(self, cfg, ctx):
        if ctx.target not in ("gpu", "cost"):
            return
        from repro_torch.kernels.cost import ALIGN

        def tile(name):
            v = cfg.get(name)
            if not (_is_int(v) and v > 0):
                return None  # PositiveIntTiles owns malformed values
            di = self.axes[name]
            if ctx.dims is not None and di < len(ctx.dims) and v >= int(ctx.dims[di]):
                return None
            return v

        grids = {name: (ALIGN, "") for name in self.axes}
        if self.tc is not None:
            del grids[self.tc[2]]  # a matmul chunk pads only as its route does
            grids.update({n: g for n, g in self._matmul_grids(cfg, ctx).items() if g[0] > 1})
        for name, (grid, where) in grids.items():
            v = tile(name)
            if v is None:
                continue
            if v % ALIGN:
                yield Finding(f"tile_misaligned:{name}", WARN,
                              f"{name}={v} pads to {-(-v // ALIGN) * ALIGN} on the "
                              f"tile kernels' {ALIGN}-element grid", name)
            elif v % grid:
                yield Finding(f"tile_misaligned:{name}", WARN,
                              f"{name}={v} pads to {-(-v // grid) * grid} in {where}", name)

    def describe(self):
        return f"tile alignment on Hopper: {', '.join(self.axes)} (gpu/cost)"


class PaddingWaste(Rule):
    """Targets ``gpu`` and ``cost``, the Hopper counterpart of the JAX
    package's ``LcmPadding``: the operations of the padded tiles the
    kernel's launches run (the cost model's ``info["padded_work"]``, tiles
    padded to their grids, whole diagonal tiles of the symmetric kernels,
    heat3d's recomputed halos) against the useful operations
    (``info["flops"]``), in the layout the kernel runs for ``ctx.dtype``
    where it is known, else the smaller ratio of f32's and bf16's. Past
    :data:`PAD_WASTE_RATIO` a third of the work or more is padding.
    Warn-only: the padded kernel is correct, just wasteful."""

    def check(self, cfg, ctx):
        if ctx.target not in ("gpu", "cost") or ctx.dims is None:
            return
        import torch

        from repro_torch.kernels.cost import KERNEL_COST_FNS, kernel_cost

        if ctx.kernel not in KERNEL_COST_FNS:
            return
        dtypes = (ctx.dtype,) if ctx.dtype is not None else (torch.float32, torch.bfloat16)
        try:
            infos = [kernel_cost(ctx.kernel, cfg, *ctx.dims, dtype=dt)[1] for dt in dtypes]
        except (KeyError, TypeError, ValueError, ZeroDivisionError):
            # structurally invalid configs are other rules' findings
            return
        if not all(i.get("padded_work") and i.get("flops") for i in infos):
            return  # refused on shared memory: SmemBudget's finding
        info = min(infos, key=lambda i: i["padded_work"] / i["flops"])
        work, flops = info["padded_work"], info["flops"]
        ratio = work / flops
        if ratio > PAD_WASTE_RATIO:
            yield Finding(
                "padding_waste", WARN,
                f"the padded tiles' {work:.3g} operations are {ratio:.2f}x the "
                f"{flops:.3g} useful ones")

    def describe(self):
        return "padded work vs useful work (gpu/cost)"


class GridBound(Rule):
    """Grid-size sanity: the number of block steps the schedule implies,
    after the builder's ``min(tile, dim)`` clamp. Oversized grids compile
    but drown in per-step overhead. ``axes`` maps tile params to the dim
    index they divide."""

    def __init__(self, axes: Mapping[str, int], steps: int = 1):
        self.axes = dict(axes)
        self.steps = steps  # outer sequential multiplier (e.g. FW rounds)

    def check(self, cfg, ctx):
        if ctx.dims is None:
            return
        total = self.steps
        for name, di in self.axes.items():
            v = cfg.get(name)
            if not (_is_int(v) and v > 0) or di >= len(ctx.dims):
                return
            n = int(ctx.dims[di])
            total *= -(-n // min(v, n))
        if total > GRID_WARN_STEPS:
            yield Finding(
                "grid_too_large", WARN,
                f"~{total:,} grid steps exceeds the {GRID_WARN_STEPS:,} "
                f"sanity bound")

    def describe(self):
        return f"grid steps over {', '.join(self.axes)} within sanity bound"


# ---------------------------------------------------------------------------
# per-kernel rule tables
# ---------------------------------------------------------------------------
# dims follow kernels.problems.BENCH_DIMS order for each kernel.

KERNEL_RULES: dict[str, tuple[Rule, ...]] = {
    "syr2k": (
        RequiredParams("bi", "bj", "bk"),
        PositiveIntTiles("bi", "bj", "bk"),
        SmemBudget(),
        TileAlign({"bi": 0, "bj": 0}),
        PaddingWaste(),
        GridBound({"bi": 0, "bj": 0, "bk": 1}),
    ),
    "mm3": (
        RequiredParams("bm", "bn", "bk"),
        PositiveIntTiles("bm", "bn", "bk"),
        SmemBudget(),
        TileAlign({"bm": 0, "bn": 4, "bk": 2}, tc=("bm", "bn", "bk"), f32_only=True),
        PaddingWaste(),
        GridBound({"bm": 0, "bn": 4, "bk": 2}),
    ),
    "lu": (
        RequiredParams("bs"),
        PositiveIntTiles("bs", "bm", "bn"),
        SmemBudget(),
        TileAlign({"bm": 0, "bn": 0, "bs": 0}, tc=("bm", "bn", "bs"), f32_only=True),
        PaddingWaste(),
        GridBound({"bs": 0}),
    ),
    "heat3d": (
        RequiredParams("bi"),
        PositiveIntTiles("bi"),
        FuseDivides("fuse_t"),
        SmemBudget(),
        PaddingWaste(),
        GridBound({"bi": 0}, steps=2),
    ),
    "covariance": (
        RequiredParams("bi", "bj", "bk"),
        PositiveIntTiles("bi", "bj", "bk"),
        SmemBudget(),
        TileAlign({"bi": 1, "bj": 1}),
        PaddingWaste(),
        GridBound({"bi": 1, "bj": 1, "bk": 0}),
    ),
    "floyd_warshall": (
        RequiredParams("bs", "bi", "bj"),
        PositiveIntTiles("bs", "bi", "bj"),
        ChoiceIn("unroll", (1, 2, 4, 8)),
        SmemBudget(),
        PaddingWaste(),
        GridBound({"bs": 0, "bi": 0, "bj": 0}),
    ),
    "flash_attention": (
        ChoiceIn("impl", ("pallas", "xla")),
        PositiveIntTiles("bq", "bk"),
        SmemBudget(),
        PaddingWaste(),
        GridBound({"bq": 1, "bk": 2}),
    ),
    "decode_attention": (
        ChoiceIn("impl", ("pallas", "xla")),
        PositiveIntTiles("bk", "hg", "page"),
        PageDividesSeq("page", dim_index=2),
        SmemBudget(),
        PaddingWaste(),
        GridBound({"hg": 0, "bk": 2}),
    ),
    "matmul": (
        PositiveIntTiles("bm", "bn", "bk"),
        SmemBudget(),
        TileAlign({"bm": 0, "bn": 2, "bk": 1}, tc=("bm", "bn", "bk")),
        PaddingWaste(),
        GridBound({"bm": 0, "bk": 1, "bn": 2}),
    ),
}


def kernel_rules(kernel: str) -> tuple[Rule, ...]:
    """The rule tuple for ``kernel`` (empty for unknown kernels)."""
    return KERNEL_RULES.get(kernel, ())


def register_rules(kernel: str, rules: Iterable[Rule],
                   *, replace: bool = False) -> None:
    """Attach feasibility rules to a kernel (tests, third-party kernels).
    Appends to any existing table unless ``replace``."""
    rules = tuple(rules)
    if replace or kernel not in KERNEL_RULES:
        KERNEL_RULES[kernel] = rules
    else:
        KERNEL_RULES[kernel] = KERNEL_RULES[kernel] + rules


def _dims_for(kernel: str, signature, dims) -> tuple | None:
    if dims is not None:
        return tuple(dims)
    if signature is None:
        return None
    from repro_torch.kernels.problems import dims_from_signature

    try:
        return tuple(dims_from_signature(kernel, signature))
    except Exception:
        return None  # runtime signature shapes this table doesn't know


def check_config(
    kernel: str,
    config: Mapping,
    *,
    dims: tuple | None = None,
    signature=None,
    target: str = "host",
    dtype=None,
) -> Feasibility:
    """Statically judge ``config`` for ``kernel``.

    ``dims`` are the problem dims in
    :data:`~repro_torch.kernels.problems.BENCH_DIMS` order; alternatively
    pass the store/runtime ``signature`` and the dims are recovered via
    ``dims_from_signature`` (unknown kernels or shapes degrade to
    dimension-independent rules only). ``dtype``: the operands' where the
    caller knows it (None: either). Kernels with no registered rules are
    feasible by construction."""
    rules = KERNEL_RULES.get(kernel)
    if not rules:
        return FEASIBLE
    ctx = RuleContext(kernel=kernel, dims=_dims_for(kernel, signature, dims),
                      target=target, dtype=dtype)
    findings: list[Finding] = []
    for rule in rules:
        findings.extend(rule.check(config, ctx))
    if not findings:
        return FEASIBLE
    return Feasibility(tuple(findings))


def feasibility_filter(
    kernel: str,
    *,
    dims: tuple | None = None,
    signature=None,
    target: str = "host",
) -> Callable[[Mapping], bool] | None:
    """A ``config -> bool`` predicate for the search path (True = keep), or
    ``None`` when the kernel has no rules — callers skip the filtering pass
    entirely in that case. Only errors prune; warnings survive so the
    optimizer can still learn the pathological region is bad."""
    if not KERNEL_RULES.get(kernel):
        return None
    ctx_dims = _dims_for(kernel, signature, dims)

    def accept(cfg: Mapping) -> bool:
        return check_config(kernel, cfg, dims=ctx_dims, target=target).ok

    return accept
