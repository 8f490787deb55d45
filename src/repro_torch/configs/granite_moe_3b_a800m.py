"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8, head_dim 64)
expert d_ff=512 vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0 family; hf]

The expert count is the configuration field's, 40 (the JAX package's
``repro.configs.granite_moe_3b_a800m``).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, head_dim=64, d_ff=512, vocab=49155,
    n_experts=40, top_k=8, d_expert=512, mlp_act="silu_glu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-reduced", family="moe", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64, vocab=512,
        n_experts=8, top_k=2, d_expert=64, mlp_act="silu_glu",
        tie_embeddings=True, scan_chunk=8, attn_q_chunk=32)
