"""Collective traffic of a traced step: the counterpart of
``repro.perf.hlo``.

The reference compiles each step with XLA and parses the post-partitioning
HLO text for its communication ops. The port runs eager PyTorch: there is
no compiled module and no HLO text to parse. Its collectives are the c10d
operators that DTensor's redistributions and ``torch.distributed`` calls
issue, one dispatcher call each, on the local shards. A dispatch mode
(:mod:`repro_torch.perf.op_cost`) sees every one of them; this module names
them by the reference's kinds and sizes their payloads by the reference's
``parse_collectives`` convention: max(result, operand) per op, in bytes of
the local tensors.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["CollectiveStats", "COLLECTIVE_KINDS", "DTYPE_BYTES", "C10D_KINDS",
           "collective_kind", "payload_bytes", "tensor_bytes"]

DTYPE_BYTES = {
    torch.bool: 1,
    torch.int8: 1, torch.uint8: 1, torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.int16: 2, torch.float16: 2, torch.bfloat16: 2,
    torch.int32: 4, torch.float32: 4,
    torch.int64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16,
}

COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# c10d operator (schema name) -> the reference's kind: the functional ops
# DTensor issues, and the in-place ones torch.distributed's calls issue
# (ft/compression.py:compressed_psum's dist.all_reduce is c10d::allreduce_)
C10D_KINDS = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_reduce_coalesced_": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_out": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::send": "collective-permute",
    "c10d::recv_": "collective-permute",
}


def collective_kind(func) -> str | None:
    """The reference's kind of the operator ``func``, None for any other
    operator (``wait_tensor`` too: a wait moves nothing)."""
    schema = getattr(func, "_schema", None)
    return C10D_KINDS.get(schema.name) if schema is not None else None


def tensor_bytes(x) -> float:
    """Bytes of the tensors in ``x`` (a tensor, or lists/tuples of them)."""
    if isinstance(x, torch.Tensor):
        return float(x.numel() * DTYPE_BYTES.get(x.dtype, x.element_size()))
    if isinstance(x, (list, tuple)):
        return float(sum(tensor_bytes(e) for e in x))
    return 0.0


def payload_bytes(args, result) -> float:
    """max(result, operand): the larger of the result's bytes and of any one
    argument's (an argument list of tensors, a coalesced call, counts
    whole). An in-place all-gather passes its output as an argument, so its
    payload is the gathered tensor, as the reference's."""
    return max([tensor_bytes(result), *(tensor_bytes(a) for a in args)])


@dataclasses.dataclass
class CollectiveStats:
    """Per-kind collective byte counts for one traced step (per device)."""

    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    @property
    def total_count(self) -> int:
        return int(sum(self.count_by_kind.values()))

    def summary(self) -> str:
        parts = [
            f"{k}: {self.count_by_kind[k]} ops / {self.bytes_by_kind[k]/1e6:.2f} MB"
            for k in sorted(self.bytes_by_kind)
        ]
        return "; ".join(parts) if parts else "<no collectives>"
