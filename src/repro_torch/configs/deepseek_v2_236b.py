"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400, MoE 160e top-6, MLA kv_lora=512, 2 shared experts.
[arXiv:2405.04434; hf]"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,          # MLA: all heads share the latent KV
    d_ff=1536,               # routed-expert hidden width
    moe_d_ff=1536,
    vocab_size=102400,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    first_dense_layers=1,
    tie_embeddings=False,
    notes="MLA latent cache (512+64/token/layer); dense layer 0 uses d_ff=12288.",
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, d_ff=32, moe_d_ff=32,
        vocab_size=256, q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8,
        qk_nope_dim=16, v_head_dim=16, n_experts=8, n_shared_experts=1,
        top_k=2, first_dense_layers=1, n_kv_heads=4)
