"""Public entry points for the ported kernels.

Each op takes an optional ``config`` dict in the schema the autotuner
searches (see spaces.py), merged over :data:`DEFAULTS`. The defaults are
chosen for the CUDA kernels on an H100 at the paper's LARGE sizes:

  * 64x64 output tiles: 256 threads of 4x4 accumulators a block (mm3's
    f32 matmuls: 4 tensor-core warps of 32x32); mm3's
    products launch 208-300 blocks, syr2k 361 of which the 190 on or below
    the diagonal work (the others exit at once), one to two and a half
    blocks per SM over 132 SMs; 128x128 tiles give 55-100 working blocks
    and leave SMs idle, tiles below 32 re-read the operands many more times;
  * a 32-deep contraction chunk with every operand staged in shared memory
    (``pack*=True``): a three-stage ring of 108 KB (syr2k's four chunks) or
    54 KB (each mm3 matmul) per block, so two syr2k or four matmul blocks
    fit an SM's 228 KB;
  * no interchange: consecutive blocks share a row tile, as the TPU grid's
    order does.

For the kernels of the second slice, at their LARGE sizes:

  * lu (N=2000): a 64-wide panel, so 32 block steps (at bs=32, 63: every
    step costs a diagonal-factor launch, two triangular solves and a GEMM
    launch from the host), and 64x64 trailing tiles with the whole 64-deep
    contraction staged (pack): 35 KB of shared memory per block, and 900 to
    4 blocks as the trailing matrix shrinks;
  * covariance (1400 x 1200): as syr2k, 64x64 output tiles (361 blocks of
    which the 190 on or below the diagonal work, one product per mirrored
    pair) and 32-row chunks of the data in a six-stage ring (97 KB, two
    blocks an SM), centred in shared memory as they land (fuse_center), so
    no separate centring pass reads and writes the data;
  * floyd_warshall (N=2800): 64-wide blocks, so 44 rounds of 4 launches
    (bs=16 would be 175 rounds, bs=256 a 256-step single-block closure per
    round), 64x64 tiles (1,936 blocks in the trailing update), and the k
    loop unrolled by 4 so that the next k's shared-memory loads overlap
    this k's 64 add/min pairs;
  * heat3d (N=120, 500 steps): 8-row slabs (15 x 64 = 960 blocks of 256
    threads a pass) and fuse_t=2, which halves the passes and their
    launches (500, not 1000) at the cost of recomputing a one-deep halo.

For the serving path's kernels:

  * flash_attention: 64x64 tiles, 256 threads a block. At the LARGE shape
    (BH=16, S=4096, hd=128) that is 1,024 blocks and 112 KB of shared
    memory a block (two blocks an SM); at hd 256, 208 KB (one); at the
    model's prefill (BH=8, S=256, hd=64), 32 blocks per call (the model's
    G = 7 query groups are 7 calls);
  * decode_attention: 32-slot KV blocks, one row per block (``hg=1``). The
    kernel splits the key axis across blocks in whole ``bk`` blocks (about
    four blocks per SM, at most 32 splits), so ``bk`` sets how finely a
    short cache can split: 32, the kernel's ring chunk, gives the model's
    bucket of 288 nine splits (72 blocks) where 128 gives three (24 blocks,
    each walking four chunks in turn), and LARGE 32 splits of four blocks
    (512 blocks) either way (``chip_smoke.py`` phase 4 times both);
  * matmul (the model's output projection and unembed): mm3's tiles and
    f32 accumulation in registers (``pack=True``), on the tensor cores in
    3xTF32 (4 warps of 32x32 a 64x64 tile); at the decode's 4 rows the
    64-row tile clamps to 4, an 8-row tile of 128 threads on the FFMA loop
    (one row of four columns each) that streams its 64 columns of the
    weight.

These are reasoned, not tuned: the campaign's job is to beat them.
"""

from __future__ import annotations

from typing import Any, Mapping

from repro_torch.kernels.covariance import covariance
from repro_torch.kernels.floyd_warshall import floyd_warshall
from repro_torch.kernels.heat3d import heat3d
from repro_torch.kernels.lu import lu
from repro_torch.kernels.m3mm import mm3
from repro_torch.kernels.syr2k import syr2k

__all__ = ["syr2k_op", "mm3_op", "lu_op", "heat3d_op", "covariance_op",
           "floyd_warshall_op", "DEFAULTS"]

DEFAULTS: dict[str, dict[str, Any]] = {
    "syr2k": dict(bi=64, bj=64, bk=32, interchange=False,
                  pack_a=True, pack_b=True),
    "mm3": dict(bm=64, bn=64, bk=32, pack1=True, pack2=True, pack3=True,
                inter1=False, inter2=False, inter3=False, fuse_second=False),
    "lu": dict(bs=64, bm=64, bn=64, pack=True),
    "heat3d": dict(bi=8, fuse_t=2),
    "covariance": dict(bi=64, bj=64, bk=32, fuse_center=True, interchange=False),
    "floyd_warshall": dict(bs=64, bi=64, bj=64, unroll=4),
    "flash_attention": dict(impl="pallas", bq=64, bk=64),
    "decode_attention": dict(impl="pallas", bk=32, hg=1),
    "matmul": dict(bm=64, bn=64, bk=32, pack=True, interchange=False),
}


def _merged(name: str, config: Mapping[str, Any] | None) -> dict:
    out = dict(DEFAULTS[name])
    if config:
        out.update({k: v for k, v in config.items() if k in out})
    return out


def syr2k_op(C, A, B, alpha=1.5, beta=1.2, config=None):
    cfg = _merged("syr2k", config)
    # the space's InCondition: pack_b is only active with pack_a, and a
    # sampled config leaves the inactive pack_b out — it means "not packed"
    if not cfg["pack_a"]:
        cfg["pack_b"] = False
    return syr2k(C, A, B, alpha, beta, **cfg)


def mm3_op(A, B, C, D, config=None):
    return mm3(A, B, C, D, **_merged("mm3", config))


def lu_op(A, config=None):
    return lu(A, **_merged("lu", config))


def heat3d_op(A, tsteps, config=None):
    return heat3d(A, tsteps, **_merged("heat3d", config))


def covariance_op(data, config=None):
    return covariance(data, **_merged("covariance", config))


def floyd_warshall_op(path, config=None):
    return floyd_warshall(path, **_merged("floyd_warshall", config),
                          allow_semiring_reassociation=True)
