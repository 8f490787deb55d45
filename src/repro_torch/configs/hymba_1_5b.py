"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5, head_dim 64) d_ff=5504
vocab=32001, ssm_state=16; parallel attention + mamba(SSD) heads per layer,
sliding-window attention with periodic global layers.
[arXiv:2411.13676; hf]  Meta-tokens omitted, as in the JAX package."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, head_dim=64, d_ff=5504, vocab=32001,
    attn_kind="mixed", window=1024, global_every=8, ssm=True, ssm_state=16,
    mlp_act="silu_glu", scan_chunk=16, tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hymba-reduced", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        attn_kind="mixed", window=8, global_every=4, ssm=True, ssm_state=4,
        mlp_act="silu_glu", scan_chunk=8, attn_q_chunk=32,
        tie_embeddings=True)
