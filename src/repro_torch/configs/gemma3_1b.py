"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144; 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    sliding_window=512,
    local_global_ratio=5,     # 5 local layers per global layer
    qk_norm=True,
    rope_theta=1.0e6,
    tie_embeddings=True,
    notes="local:global layout is the long-context mechanism -> long_500k eligible.",
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, sliding_window=8, local_global_ratio=2)
