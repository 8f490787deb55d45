"""minitron-8b [dense]: 32L d=4096 32H (GQA kv=8) d_ff=16384 vocab=256000;
pruned nemotron lineage (squared-ReLU MLP). [arXiv:2407.14679; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=16384, vocab=256000,
    mlp_act="relu2",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b-reduced", family="dense", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=256, vocab=512,
        mlp_act="relu2", scan_chunk=8, attn_q_chunk=32)
