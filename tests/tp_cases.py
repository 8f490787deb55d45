"""The cases of ``test_torch_tp.py``, shared by its two sides: the JAX
reference (``tp_reference.py``, one process of 4 host devices) and the
port's ranks (``tp_ranks.py``, gloo processes at world 2 and 4).  numpy
only: each side imports its own package.

Weights and inputs are made from seeds with numpy, so both sides build the
same ones: every parameter leaf from its own generator (seeded by the case
seed and the leaf's path), a normal leaf ``N(0, 1) * scale`` and a
constant one (norm scales, biases) drawn around its value, 0.1 normal or
as ``SPREAD`` says.
"""
import zlib

import numpy as np

SEED = 0
B, S, STEPS = 4, 16, 2        # batch, prompt, decode steps
TRAIN_B, TRAIN_S, MICRO = 8, 16, 2
MOE_B, MOE_S = 4, 16
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# RWKV6's bonus and decay base drawn wider (as ``chip_smoke.rwkv_live``
# draws them): a head's first position has a zero state, so near zero the
# bonus leaves its group norm almost nothing but rounding to scale, and
# the training step's gradients carry that rounding
SPREAD = {"bonus_u": 0.5, "decay_base": 0.5}

SP = {"seq_parallel": True}
# name -> (arch, (data, model), rules kwargs, mla_absorb, config overrides)
FORWARD = {
    "qwen-1x2": ("qwen2.5-14b", (1, 2), {}, False, {}),
    "qwen-2x2": ("qwen2.5-14b", (2, 2), {}, False, {}),
    "nemotron-1x4": ("nemotron-4-340b", (1, 4), {}, False, {}),
    "nemotron-1x2-sp": ("nemotron-4-340b", (1, 2), SP, False, {}),
    "gemma3-1x2": ("gemma3-12b", (1, 2), {}, False, {}),
    "minitron-1x2": ("minitron-8b", (1, 2), {}, False, {}),
    "granite-1x2": ("granite-moe-3b-a800m", (1, 2), {}, False, {}),
    "pixtral-1x2": ("pixtral-12b", (1, 2), {}, False, {}),
    "deepseek-1x2": ("deepseek-v2-lite-16b", (1, 2), {}, False, {}),
    "deepseek-1x2-absorbed": ("deepseek-v2-lite-16b", (1, 2), {}, True, {}),
    "whisper-1x2": ("whisper-medium", (1, 2), {}, False, {}),
    "rwkv6-1x2": ("rwkv6-1.6b", (1, 2), {}, False, {}),
    "rwkv6-1x4": ("rwkv6-1.6b", (1, 4), {}, False, {}),     # a head a rank
    "rwkv6-1x2-sp": ("rwkv6-1.6b", (1, 2), SP, False, {}),
    "hymba-1x2": ("hymba-1.5b", (1, 2), {}, False, {}),     # SSD heads split
    # 5 heads do not split in 2: attention and SSD whole, the MLP split
    "hymba-1x2-h5": ("hymba-1.5b", (1, 2), {}, False,
                     {"n_heads": 5, "n_kv_heads": 5}),
}
# name -> ((data, model), config overrides): granite's MoE block
MOE = {
    "granite-1x2": ((1, 2), {}),                   # expert parallel
    "granite-2x2": ((2, 2), {"capacity_factor": 0.5}),   # pairs drop
    "granite-1x4-e6": ((1, 4), {"n_experts": 6}),  # 6 % 4: hidden split
}
# name -> (arch, (data, model), rules kwargs, state dtype): train steps of
# 2 microbatches
TRAIN = {
    "qwen-2x2-fsdp": ("qwen2.5-14b", (2, 2), {"fsdp": True}, "float32"),
    "qwen-2x2-fsdp-int8": ("qwen2.5-14b", (2, 2), {"fsdp": True}, "int8"),
    "rwkv6-1x2": ("rwkv6-1.6b", (1, 2), {}, "float32"),
    "hymba-2x2": ("hymba-1.5b", (2, 2), {}, "float32"),
    "whisper-1x2": ("whisper-medium", (1, 2), {}, "float32"),
}


def world(shape) -> int:
    return shape[0] * shape[1]


def numpy_params(metas, seed: int = SEED):
    """A parameter tree of numpy fp32 leaves from ``metas``, a tree (the
    template's ``_finalize``) of (shape, init, scale) leaves."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in t.items()}
        shape, init, scale = t
        rng = np.random.default_rng([seed, zlib.crc32(path.encode())])
        z = rng.standard_normal(shape).astype(np.float32)
        if init == "normal":
            return (z * np.float32(scale)).astype(np.float32)
        base = 1.0 if init == "ones" else 0.0
        spread = SPREAD.get(path.rsplit("/", 1)[-1], 0.1)
        return (base + spread * z).astype(np.float32)
    return walk(metas, "")


def forward_inputs(cfg, seed: int = SEED):
    """Prompt tokens (B, S), the decode steps' tokens (STEPS, B, 1), and
    the stub frontends' embeddings where ``cfg`` has one."""
    rng = np.random.default_rng([seed, 1])
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "steps": rng.integers(0, cfg.vocab, (STEPS, B, 1)).astype(
               np.int32)}
    if cfg.frontend == "vision_stub":
        out["frontend_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "audio_stub":
        out["enc_embeds"] = (0.1 * rng.standard_normal(
            (B, 12, cfg.d_model))).astype(np.float32)
    return out


def moe_input(cfg, seed: int = SEED):
    rng = np.random.default_rng([seed, 2])
    return rng.standard_normal((MOE_B, MOE_S, cfg.d_model)).astype(
        np.float32)


def train_batch(cfg, seed: int = SEED):
    rng = np.random.default_rng([seed, 3])
    labels = rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S)).astype(np.int32)
    labels[0, :3] = -1
    out = {"tokens": rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S)).astype(
        np.int32), "labels": labels}
    if cfg.frontend == "audio_stub":
        out["enc_embeds"] = (0.1 * rng.standard_normal(
            (TRAIN_B, 12, cfg.d_model))).astype(np.float32)
    return out
