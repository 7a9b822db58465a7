"""3mm: G = (A@B) @ (C@D), Sec. 4.2.

Three :func:`~repro_torch.kernels.matmul.tiled_matmul` launches sharing one
tile triple (bm, bn, bk) — the paper's 3mm space is 7 binary pragma choices
x 3 shared tile ordinals (2^7 * 11^3 = 170,368 configurations). The 7
binaries: per-matmul ``pack`` (3), per-matmul ``interchange`` (3), and
``fuse_second``, which keeps E = A@B and F = C@D in f32 and feeds them to the
third product without the round trip through the input dtype.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.matmul import tiled_matmul

__all__ = ["mm3"]


def mm3(
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    *,
    bm: int = 128,
    bn: int = 128,
    bk: int = 128,
    pack1: bool = True,
    pack2: bool = True,
    pack3: bool = True,
    inter1: bool = False,
    inter2: bool = False,
    inter3: bool = False,
    fuse_second: bool = False,
) -> torch.Tensor:
    mid = torch.float32 if fuse_second else None
    E = tiled_matmul(A, B, bm=bm, bn=bn, bk=bk, pack=pack1, interchange=inter1,
                     out_dtype=mid)
    F = tiled_matmul(C, D, bm=bm, bn=bn, bk=bk, pack=pack2, interchange=inter2,
                     out_dtype=mid)
    return tiled_matmul(E, F, bm=bm, bn=bn, bk=bk, pack=pack3, interchange=inter3,
                        out_dtype=A.dtype)
