"""Per-kernel ConfigurationSpaces — the paper's pragma parameter spaces,
re-targeted at the CUDA kernels' schedule knobs.

Two flavors per kernel:

  * ``target="gpu"``  — tile sequences that suit the CUDA kernels
    (``csrc/syr2k.cu``, ``csrc/matmul.cu``): output tiles of 8..128, which
    the kernels pad to multiples of 8 and cover with one thread per 4x4
    (past 64: 8x8) accumulators, including extents that are not multiples of
    16 so ragged tiles are part of the search; contraction chunks of 4..256,
    staged through a ring of up to three shared-memory stages that gives up
    stages first, so only chunks whose single stage exceeds the device's
    shared memory per block are refused (the wrappers reject them before
    launch, and the campaign records a penalty);
  * ``target="host"`` — the paper's literal 11-entry tile sequences
    ('4'...'2048'), identical to ``repro.kernels.spaces``'s host flavour, for
    the CPU backend (plain versions) and the parity tests.

Space sizes mirror the paper: syr2k 2*2*2*11^3 = 10,648 (with the
pack_b-in-pack_a InCondition); 3mm 2^7 * 11^3 = 170,368. The ``gpu``
flavours of lu (2*5*11*11 = 1,210), covariance (2*2*11^3 = 5,324), heat3d
(6*2 = 12) and floyd_warshall (5*11*11*4 = 2,420) take the JAX package's own
lists for ``bs``, ``bi`` (heat3d), ``fuse_t`` and ``unroll``, and the CUDA
tile sequences where it has TPU tiles; their defaults are ``ops.DEFAULTS``.

The serving path's kernels (flash_attention, decode_attention, matmul) keep
the JAX package's knobs and its ``impl`` axis; the ``gpu`` flavour takes
tiles the CUDA kernels run and defaults to the kernel (``impl="pallas"``),
the ``host`` flavour is the JAX package's host flavour.
"""

from __future__ import annotations

from repro_torch.core.space import (
    Categorical,
    ConfigurationSpace,
    InCondition,
    Ordinal,
)
from repro_torch.kernels.ops import DEFAULTS

__all__ = ["kernel_space", "KERNEL_SPACES", "TARGETS"]

TARGETS = ("gpu", "host")

# the paper's tile sequences (Sec. 4.1)
HOST_TILES_A = (4, 8, 16, 20, 32, 50, 64, 80, 96, 100, 128)
HOST_TILES_B = (4, 8, 16, 20, 32, 50, 64, 80, 100, 128, 2048)
HOST_TILES_C = (4, 8, 16, 20, 32, 50, 64, 80, 100, 128, 256)
# CUDA-kernel sequences (11 entries, like the paper): output tiles up to the
# kernels' 128-wide register tile, contraction chunks up to 256
GPU_TILES = (8, 16, 24, 32, 40, 48, 64, 80, 96, 112, 128)
GPU_TILES_K = (4, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _tiles(target: str, which: str):
    if target not in TARGETS:
        raise ValueError(f"target must be one of {TARGETS}, got {target!r}")
    if target == "host":
        return {"a": HOST_TILES_A, "b": HOST_TILES_B, "c": HOST_TILES_C}[which]
    return {"a": GPU_TILES, "b": GPU_TILES_K, "c": GPU_TILES}[which]


def _tile_defaults(target: str) -> tuple[int, int, int]:
    """(row tile, contraction chunk, column tile) defaults: the host flavour
    keeps repro's, the GPU flavour uses the ops.DEFAULTS tiles."""
    if target == "host":
        return _tiles(target, "a")[8], _tiles(target, "b")[-1], _tiles(target, "c")[-1]
    return 64, 32, 64


def syr2k_space(target: str = "gpu", seed: int = 1234) -> ConfigurationSpace:
    ti, tk, tj = _tile_defaults(target)
    pack = target == "gpu"
    cs = ConfigurationSpace(seed=seed)
    cs.add_hyperparameters([
        Categorical("pack_a", (True, False), default=pack),
        Categorical("pack_b", (True, False), default=pack),
        Categorical("interchange", (True, False), default=False),
        Ordinal("bi", _tiles(target, "a"), default=ti),
        Ordinal("bk", _tiles(target, "b"), default=tk),
        Ordinal("bj", _tiles(target, "c"), default=tj),
    ])
    # the paper's CS.InCondition: consider packing B only when A is packed
    cs.add_condition(InCondition("pack_b", "pack_a", (True,)))
    return cs


def mm3_space(target: str = "gpu", seed: int = 1234) -> ConfigurationSpace:
    ti, tk, tj = _tile_defaults(target)
    cs = ConfigurationSpace(seed=seed)
    cs.add_hyperparameters([
        Categorical("pack1", (True, False), default=True),
        Categorical("pack2", (True, False), default=True),
        Categorical("pack3", (True, False), default=True),
        Categorical("inter1", (True, False), default=False),
        Categorical("inter2", (True, False), default=False),
        Categorical("inter3", (True, False), default=False),
        Categorical("fuse_second", (True, False), default=False),
        Ordinal("bm", _tiles(target, "a"), default=ti),
        Ordinal("bk", _tiles(target, "b"), default=tk),
        Ordinal("bn", _tiles(target, "c"), default=tj),
    ])
    return cs


def lu_space(target: str = "gpu", seed: int = 1234) -> ConfigurationSpace:
    panel = (8, 16, 32, 64, 128) if target == "gpu" else (4, 8, 16, 32, 64)
    if target == "gpu":
        d = DEFAULTS["lu"]
    else:
        d = dict(pack=True, bs=panel[2], bm=_tiles(target, "a")[8],
                 bn=_tiles(target, "c")[-1])
    cs = ConfigurationSpace(seed=seed)
    cs.add_hyperparameters([
        Categorical("pack", (True, False), default=d["pack"]),
        Ordinal("bs", panel, default=d["bs"]),
        Ordinal("bm", _tiles(target, "a"), default=d["bm"]),
        Ordinal("bn", _tiles(target, "c"), default=d["bn"]),
    ])
    return cs


def heat3d_space(target: str = "gpu", seed: int = 1234) -> ConfigurationSpace:
    if target not in TARGETS:
        raise ValueError(f"target must be one of {TARGETS}, got {target!r}")
    d = DEFAULTS["heat3d"] if target == "gpu" else dict(bi=8, fuse_t=1)
    cs = ConfigurationSpace(seed=seed)
    cs.add_hyperparameters([
        Ordinal("bi", (1, 2, 4, 8, 16, 32), default=d["bi"]),
        Categorical("fuse_t", (1, 2), default=d["fuse_t"]),
    ])
    return cs


def covariance_space(target: str = "gpu", seed: int = 1234) -> ConfigurationSpace:
    if target == "gpu":
        d = DEFAULTS["covariance"]
    else:
        d = dict(fuse_center=True, interchange=False, bi=_tiles(target, "a")[8],
                 bk=_tiles(target, "b")[-1], bj=_tiles(target, "c")[-1])
    cs = ConfigurationSpace(seed=seed)
    cs.add_hyperparameters([
        Categorical("fuse_center", (True, False), default=d["fuse_center"]),
        Categorical("interchange", (True, False), default=d["interchange"]),
        Ordinal("bi", _tiles(target, "a"), default=d["bi"]),
        Ordinal("bk", _tiles(target, "b"), default=d["bk"]),
        Ordinal("bj", _tiles(target, "c"), default=d["bj"]),
    ])
    return cs


def floyd_warshall_space(target: str = "gpu", seed: int = 1234) -> ConfigurationSpace:
    blocks = (16, 32, 64, 128, 256) if target == "gpu" else (4, 8, 16, 32, 64, 100)
    if target == "gpu":
        d = DEFAULTS["floyd_warshall"]
    else:
        d = dict(bs=blocks[2], bi=_tiles(target, "a")[8], bj=_tiles(target, "c")[-1],
                 unroll=1)
    cs = ConfigurationSpace(seed=seed)
    cs.add_hyperparameters([
        Ordinal("bs", blocks, default=d["bs"]),
        Ordinal("bi", _tiles(target, "a"), default=d["bi"]),
        Ordinal("bj", _tiles(target, "c"), default=d["bj"]),
        Ordinal("unroll", (1, 2, 4, 8), default=d["unroll"]),
    ])
    return cs


# ---------------------------------------------------------------------------
# model-kernel spaces: the serving path's schedule knobs
# ---------------------------------------------------------------------------

# flash-attention q/k tiles: multiples of the CUDA kernel's 16x16 thread block
# up to its 128-row register tile; the host entries are the JAX package's
FLASH_TILES_GPU = (16, 32, 64, 128)
FLASH_TILES_HOST = (16, 32, 64, 128, 256, 512)
# decode KV blocks (up to one slot per thread of the CUDA kernel's 256);
# paged-cache page sizes, an axis of the host flavour only (below; the
# serving benchmark draws them beside the gpu flavour's configs)
DECODE_TILES_GPU = (32, 64, 128, 256)
DECODE_TILES_HOST = (8, 16, 32, 64, 128, 256)
PAGE_SIZES_HOST = (8, 16, 32, 64, 128)
# the implementation axis: the host flavour keeps the JAX package's two
# values; the gpu flavour holds only the kernel, so that no campaign on the
# card can put the chunked torch variant on the serving path
IMPLS_HOST = ("pallas", "xla")
IMPLS_GPU = ("pallas",)


def _model_defaults(name: str, target: str, host: dict) -> dict:
    if target not in TARGETS:
        raise ValueError(f"target must be one of {TARGETS}, got {target!r}")
    return DEFAULTS[name] if target == "gpu" else host


def flash_attention_space(target: str = "gpu", seed: int = 1234) -> ConfigurationSpace:
    """``bq``/``bk`` tiles plus the implementation axis: the hand-written
    kernel (``"pallas"``) vs the chunked torch variant (``"xla"``, which
    reads only ``bq``; host flavour only)."""
    d = _model_defaults("flash_attention", target, dict(impl="xla", bq=128, bk=128))
    tiles = FLASH_TILES_GPU if target == "gpu" else FLASH_TILES_HOST
    cs = ConfigurationSpace(seed=seed)
    cs.add_hyperparameters([
        Categorical("impl", IMPLS_GPU if target == "gpu" else IMPLS_HOST,
                    default=d["impl"]),
        Ordinal("bq", tiles, default=d["bq"]),
        Ordinal("bk", tiles, default=d["bk"]),
    ])
    return cs


def decode_attention_space(target: str = "gpu", seed: int = 1234) -> ConfigurationSpace:
    """KV block ``bk``, rows per block ``hg`` and the ``impl`` axis. The
    host flavour, the JAX package's, also holds the paged KV cache's
    ``page`` size. The gpu flavour leaves it out: the kernel never reads
    ``page``, and this space is also what background campaigns and the
    guard's challengers sample, where the axis would only spread their
    evaluations over configs that launch the same kernel. The serving
    benchmark (``benchmarks/torch_serve_bench.py``) tunes ``page`` all the
    same: it draws one from :data:`PAGE_SIZES_HOST` beside each gpu-space
    candidate and times the candidate at that page's bucket. Store records
    that carry ``page`` still resolve (lookup does not consult the space),
    and the feasibility pass holds a record's ``page`` to the signature's
    bucket."""
    gpu = target == "gpu"
    d = _model_defaults("decode_attention", target,
                        dict(impl="xla", bk=128, hg=1, page=PAGE_SIZES_HOST[-1]))
    cs = ConfigurationSpace(seed=seed)
    cs.add_hyperparameters([
        Categorical("impl", IMPLS_GPU if gpu else IMPLS_HOST, default=d["impl"]),
        Ordinal("bk", DECODE_TILES_GPU if gpu else DECODE_TILES_HOST, default=d["bk"]),
        Ordinal("hg", (1, 2, 4, 8), default=d["hg"]),
    ])
    if not gpu:
        cs.add_hyperparameters([Ordinal("page", PAGE_SIZES_HOST, default=d["page"])])
    return cs


def matmul_space(target: str = "gpu", seed: int = 1234) -> ConfigurationSpace:
    """Tiled-matmul space for the model's output projection and unembed."""
    d = _model_defaults("matmul", target, dict(
        pack=False, interchange=False, bm=_tiles("host", "a")[8],
        bk=_tiles("host", "b")[-1], bn=_tiles("host", "c")[-1]))
    cs = ConfigurationSpace(seed=seed)
    cs.add_hyperparameters([
        Categorical("pack", (True, False), default=d["pack"]),
        Categorical("interchange", (True, False), default=d["interchange"]),
        Ordinal("bm", _tiles(target, "a"), default=d["bm"]),
        Ordinal("bk", _tiles(target, "b"), default=d["bk"]),
        Ordinal("bn", _tiles(target, "c"), default=d["bn"]),
    ])
    return cs


KERNEL_SPACES = {
    "syr2k": syr2k_space,
    "mm3": mm3_space,
    "lu": lu_space,
    "heat3d": heat3d_space,
    "covariance": covariance_space,
    "floyd_warshall": floyd_warshall_space,
    "flash_attention": flash_attention_space,
    "decode_attention": decode_attention_space,
    "matmul": matmul_space,
}


def kernel_space(name: str, target: str = "gpu", seed: int = 1234) -> ConfigurationSpace:
    return KERNEL_SPACES[name](target=target, seed=seed)
