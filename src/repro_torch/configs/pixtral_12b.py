"""pixtral-12b [vlm]: 40L d=5120 32H (GQA kv=8, head_dim 128) d_ff=14336
vocab=131072; pixtral-ViT frontend is a STUB delivering patch embeddings
prepended to the text sequence. [hf:mistralai/Pixtral-12B-2409; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab=131072,
    mlp_act="silu_glu", rope_theta=1_000_000.0, frontend="vision_stub",
    n_frontend_tokens=256,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b-reduced", family="vlm", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        mlp_act="silu_glu", frontend="vision_stub", n_frontend_tokens=8,
        scan_chunk=8, attn_q_chunk=32)
