"""whisper-medium [audio]: enc-dec, 24+24L d=1024 16H (MHA kv=16) d_ff=4096
vocab=51865; conv frontend is a STUB (input_specs provides precomputed frame
embeddings). [arXiv:2212.04356; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096, vocab=51865,
    mlp_act="gelu", arch_kind="encdec", n_enc_layers=24,
    frontend="audio_stub",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-reduced", family="audio", n_layers=3,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        vocab=512, mlp_act="gelu", arch_kind="encdec", n_enc_layers=3,
        frontend="audio_stub", scan_chunk=8, attn_q_chunk=32)
