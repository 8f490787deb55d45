"""nemotron-4-340b [dense]: 96L d=18432 96H (GQA kv=8, head_dim 192)
d_ff=73728 vocab=256000; squared-ReLU MLP. [arXiv:2402.16819; unverified]

The 96 layers (~680 GB in bf16) do not fit one 80 GB card: ``chip_smoke.py``
runs its full widths at a depth of 4 layers.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense", n_layers=96, d_model=18432,
    n_heads=96, n_kv_heads=8, head_dim=192, d_ff=73728, vocab=256000,
    mlp_act="relu2",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b-reduced", family="dense", n_layers=6,
        d_model=96, n_heads=6, n_kv_heads=2, head_dim=16, d_ff=384,
        vocab=512, mlp_act="relu2", scan_chunk=8, attn_q_chunk=32)
