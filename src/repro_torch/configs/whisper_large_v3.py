"""whisper-large-v3 [audio] — 32L(+32 enc) d_model=1280 20H d_ff=5120
vocab=51866; enc-dec, conv frontend stubbed (frame embeddings precomputed).
[arXiv:2212.04356; unverified]"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,              # decoder layers
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    is_encdec=True,
    encoder_len=1500,
    frontend="audio_stub",
    tie_embeddings=True,
    notes=("Decoder shapes exercise the backbone beyond the model's native "
           "448-token decoder context (documented stress test). RoPE used in "
           "place of learned/sinusoidal positions — hardware adaptation note."),
)


def reduced() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256, encoder_len=24)
