"""The assigned input-shape set and per-cell applicability rules.

Every (arch x shape) pair is a dry-run cell. ``train_4k`` lowers train_step,
``prefill_32k`` lowers prefill (forward), ``decode_32k``/``long_500k`` lower
serve_step (one token against a seq_len cache). long_500k requires
sub-quadratic attention (see DESIGN.md §Arch-applicability).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.common import ArchConfig

__all__ = ["ShapeSpec", "SHAPES", "cell_supported"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def cell_supported(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """(supported, reason-if-not). Encoder-only archs would skip decode, but
    none are assigned; whisper is enc-dec so its decoder decodes."""
    shape = SHAPES[shape_name]
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "skip(full-attn): long_500k needs sub-quadratic attention"
    return True, ""
