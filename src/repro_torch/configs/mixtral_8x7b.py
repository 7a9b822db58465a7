"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    moe_d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    n_experts=8,
    top_k=2,
    rope_theta=1.0e6,
    tie_embeddings=False,
    notes="SWA 4096 makes long_500k decode eligible (sub-quadratic).",
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, moe_d_ff=96, vocab_size=256, n_experts=4, top_k=2,
        sliding_window=16)
