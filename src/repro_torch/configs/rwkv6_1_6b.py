"""rwkv6-1.6b (Finch) [ssm]: 24L d=2048 attention-free (32 heads of 64),
d_ff=7168 vocab=65536; data-dependent per-channel decay.
[arXiv:2404.05892; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, head_dim=64, d_ff=7168, vocab=65536,
    rwkv=True, mlp_act="relu2", scan_chunk=16,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-reduced", family="ssm", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=512,
        rwkv=True, mlp_act="relu2", scan_chunk=8, attn_q_chunk=32)
