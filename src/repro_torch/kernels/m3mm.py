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


def _chain(A, B, C, D, matmul, *, fuse_second: bool = False):
    """The three products; ``matmul(a, b, which, out_dtype)`` is the kernel's
    wrapper at product ``which`` (0, 1, 2)'s knobs, or a stand-in that
    records the launches (``repro_torch.kernels.cost`` counts them so)."""
    mid = torch.float32 if fuse_second else None
    E = matmul(A, B, 0, mid)
    F = matmul(C, D, 1, mid)
    return matmul(E, F, 2, A.dtype)


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
    packs, inters = (pack1, pack2, pack3), (inter1, inter2, inter3)

    def matmul(a, b, which, out_dtype):
        return tiled_matmul(a, b, bm=bm, bn=bn, bk=bk, pack=packs[which],
                            interchange=inters[which], out_dtype=out_dtype)

    return _chain(A, B, C, D, matmul, fuse_second=fuse_second)
