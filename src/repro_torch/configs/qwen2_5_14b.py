"""qwen2.5-14b [dense]: 48L d=5120 40H (GQA kv=8) d_ff=13824 vocab=152064;
QKV bias. [hf:Qwen/Qwen2.5 family; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=13824, vocab=152064,
    qkv_bias=True, mlp_act="silu_glu", rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b-reduced", family="dense", n_layers=4, d_model=64,
        n_heads=8, n_kv_heads=2, head_dim=8, d_ff=160, vocab=512,
        qkv_bias=True, mlp_act="silu_glu", scan_chunk=8, attn_q_chunk=32)
