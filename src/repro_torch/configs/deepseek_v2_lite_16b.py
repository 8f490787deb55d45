"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H, MLA kv_lora=512 (+64 RoPE),
expert d_ff=1408, 64 routed experts top-6 + 2 shared, first layer dense
(d_ff 10944), vocab=102400. [arXiv:2405.04434; hf]

The lite model has 64 routed experts (160 is DeepSeek-V2's full model),
as the JAX package's ``repro.configs.deepseek_v2_lite_16b``.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, vocab=102400,
    n_experts=64, top_k=6, d_expert=1408, n_shared_experts=2,
    first_k_dense=1, dense_d_ff=10944, mla=True, kv_lora_rank=512,
    rope_head_dim=64, mlp_act="silu_glu",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-reduced", family="moe", n_layers=4,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=96,
        vocab=512, n_experts=8, top_k=2, d_expert=48, n_shared_experts=1,
        first_k_dense=1, dense_d_ff=96, mla=True, kv_lora_rank=32,
        rope_head_dim=8, mlp_act="silu_glu", scan_chunk=8, attn_q_chunk=32)
