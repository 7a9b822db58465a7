"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064; M-RoPE, dynamic resolution (vision frontend stubbed).
[arXiv:2409.12191; hf]"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    mrope=True,
    rope_theta=1.0e6,
    tie_embeddings=False,
    frontend="vision_stub",
    notes="M-RoPE 3-section rotary; patch embeddings arrive precomputed (stub).",
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256)
