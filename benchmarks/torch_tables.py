"""The paper's Tables 1-7 on the port: one entry per PolyBench benchmark,
the counterpart of ``benchmarks/tables.py``.

On the card every table runs at the paper's LARGE sizes
(``repro_torch.kernels.problems.LARGE_SHAPES``) with the hand-written CUDA
kernels as the tuned programs over the ``gpu`` spaces; on the CPU
(``device="cpu"``) at ``BENCH_DIMS``, the JAX package's "small" sizes, with
the plain versions over the ``host`` spaces. Rows, heuristic and paper
configs are the JAX package's (``benchmarks/torch_common.py`` says what
each row runs here). The orderings are the claims under test: autotuning
gives the smallest time, and Floyd-Warshall regresses under the smallest
("heuristic") tiles.

    PYTHONPATH=src:. python -m benchmarks.torch_run [--device cpu]
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from benchmarks.torch_common import DEFAULT_EVALS, Row, f32_matmuls, run_table
from repro_torch.core.space import ConfigurationSpace
from repro_torch.kernels import problems, ref
from repro_torch.kernels import variants as V
from repro_torch.kernels.spaces import kernel_space
from repro_torch.kernels.util import resolve_device

__all__ = ["ALL_TABLES", "Table", "make_table", "table1_syr2k", "table2_mm3",
           "table3_lu", "table4_heat3d", "table5_covariance", "table67_floyd_warshall"]

# paper row-4 defaults: tiling (96, 2048, 256) + interchange + packing
_PAPER = dict(bi=96, bk=2048, bj=256, bm=96, bn=256, interchange=True)
# row-3 "compiler heuristic" defaults: 128-cubed
_HEUR = dict(bi=128, bk=128, bj=128, bm=128, bn=128, interchange=False)


@dataclasses.dataclass
class Table:
    """What one table runs: its row prefix, kernel, inputs, the three
    reference computations and the two fixed configs."""

    name: str
    kernel: str
    args: tuple
    naive: Callable
    library: Callable
    factory: Callable
    space: ConfigurationSpace
    heur: dict
    paper: dict

    def run(self, max_evals: int = DEFAULT_EVALS, learner: str = "RF") -> list[Row]:
        with f32_matmuls():
            want = self.library(*self.args)
        return run_table(self.name, self.naive, self.library, self.args, self.factory,
                         self.space, self.heur, self.paper, max_evals=max_evals,
                         learner=learner, check_against=want)


def make_table(kernel: str, device=None) -> Table:
    """``kernel``'s table on ``device`` (the card unless ``"cpu"``): its
    inputs drawn with numpy from seed 0 at LARGE (card) or BENCH_DIMS (CPU)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    dims = (problems.LARGE_SHAPES if on_card else problems.BENCH_DIMS)[kernel]
    args = problems.problem_inputs(kernel, dims, dev)
    space = kernel_space(kernel, target="gpu" if on_card else "host")
    naive = V.naive_fns()[kernel]
    if kernel == "syr2k":
        return Table("table1_syr2k", kernel, args, naive, ref.syr2k_ref, V.syr2k_host(args),
                     space, dict(_HEUR, pack_a=False, pack_b=False),
                     dict(_PAPER, pack_a=True, pack_b=True))
    if kernel == "mm3":
        return Table("table2_3mm", kernel, args, naive, ref.mm3_ref, V.mm3_host(args), space,
                     dict(bm=128, bn=128, bk=128),
                     dict(bm=96, bn=256, bk=2048, pack1=True, pack2=True, pack3=True))
    if kernel == "lu":
        return Table("table3_lu", kernel, args, naive, ref.lu_ref, V.lu_host(args), space,
                     dict(bs=32), dict(bs=64, bm=96, bn=256))
    if kernel == "heat3d":
        tsteps = dims[1]
        heat = functools.partial(ref.heat3d_ref, tsteps=tsteps)
        return Table("table4_heat3d", kernel, args, heat, heat,
                     V.heat3d_host(args, tsteps=tsteps), space, dict(bi=8, fuse_t=1),
                     dict(bi=16, fuse_t=1))
    if kernel == "covariance":
        return Table("table5_covariance", kernel, args, naive, ref.covariance_ref,
                     V.covariance_host(args), space, dict(bi=128, bj=128, bk=128),
                     dict(bi=96, bj=256, bk=2048, interchange=True))
    if kernel == "floyd_warshall":
        # Tables 6+7, the heuristic-regression case: row 3's deliberately
        # tiny tiles are the Polly-regression analog; the autotuner recovers
        return Table("table67_floyd_warshall", kernel, args, naive, ref.floyd_warshall_ref,
                     V.floyd_warshall_host(args), space,
                     dict(bs=4, bi=8, bj=8, unroll=1),      # regression analog
                     dict(bs=100, bi=16, bj=8, unroll=1))   # paper best (100, 16, 8)
    raise KeyError(f"no table for {kernel!r}")


def table1_syr2k(device=None, max_evals=DEFAULT_EVALS, learner="RF") -> list[Row]:
    return make_table("syr2k", device).run(max_evals, learner)


def table2_mm3(device=None, max_evals=DEFAULT_EVALS, learner="RF") -> list[Row]:
    return make_table("mm3", device).run(max_evals, learner)


def table3_lu(device=None, max_evals=DEFAULT_EVALS, learner="RF") -> list[Row]:
    return make_table("lu", device).run(max_evals, learner)


def table4_heat3d(device=None, max_evals=DEFAULT_EVALS, learner="RF") -> list[Row]:
    return make_table("heat3d", device).run(max_evals, learner)


def table5_covariance(device=None, max_evals=DEFAULT_EVALS, learner="RF") -> list[Row]:
    return make_table("covariance", device).run(max_evals, learner)


def table67_floyd_warshall(device=None, max_evals=DEFAULT_EVALS, learner="RF") -> list[Row]:
    return make_table("floyd_warshall", device).run(max_evals, learner)


ALL_TABLES = [table1_syr2k, table2_mm3, table3_lu, table4_heat3d, table5_covariance,
              table67_floyd_warshall]
