"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H d_ff=8192 vocab=32000,
ssm_state=64; Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    attn_type="none",         # backbone layers are Mamba2
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    attn_every=6,             # one shared attention block per 6 mamba layers
    tie_embeddings=True,
    notes="Shared attn block params reused at every site (Zamba weight sharing).",
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, ssm_state=16, ssm_head_dim=16, attn_every=2)
