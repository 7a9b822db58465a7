"""Public entry points for the ported kernels.

Each op takes an optional ``config`` dict in the schema the autotuner
searches (see spaces.py), merged over :data:`DEFAULTS`. The defaults are
chosen for the CUDA kernels on an H100 at the paper's LARGE sizes:

  * 64x64 output tiles: at N=1200 (syr2k) or 800-1200 (mm3) that is 208-361
    blocks of 256 threads, one and a half to three waves over 132 SMs, with
    16 accumulators per thread; 128x128 tiles give 56-100 blocks and leave
    SMs idle, tiles below 32 re-read the operands many more times;
  * a 32-deep contraction chunk with every operand staged in shared memory
    (``pack*=True``): 34 KB (syr2k) or 17 KB (each mm3 matmul) per block,
    small enough for several resident blocks per SM;
  * no interchange: consecutive blocks share a row tile, as the TPU grid's
    order does.

These are reasoned, not tuned: the campaign's job is to beat them.
"""

from __future__ import annotations

from typing import Any, Mapping

from repro_torch.kernels.m3mm import mm3
from repro_torch.kernels.syr2k import syr2k

__all__ = ["syr2k_op", "mm3_op", "DEFAULTS"]

DEFAULTS: dict[str, dict[str, Any]] = {
    "syr2k": dict(bi=64, bj=64, bk=32, interchange=False,
                  pack_a=True, pack_b=True),
    "mm3": dict(bm=64, bn=64, bk=32, pack1=True, pack2=True, pack3=True,
                inter1=False, inter2=False, inter3=False, fuse_second=False),
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
