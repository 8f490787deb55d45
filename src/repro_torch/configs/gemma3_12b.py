"""gemma3-12b [dense]: 48L d=3840 16H (GQA kv=8, head_dim 256) d_ff=15360
vocab=262144; 5:1 local(window 1024):global attention, 128k-class context.
[hf:google/gemma-3 family; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense", n_layers=48, d_model=3840,
    n_heads=16, n_kv_heads=8, head_dim=256, d_ff=15360, vocab=262144,
    attn_kind="mixed", window=1024, global_every=6, mlp_act="gelu_glu",
    rope_theta=1_000_000.0, tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b-reduced", family="dense", n_layers=6, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        attn_kind="mixed", window=8, global_every=6, mlp_act="gelu_glu",
        tie_embeddings=True, scan_chunk=8, attn_q_chunk=32)
