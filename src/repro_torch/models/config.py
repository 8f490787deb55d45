"""The model configuration: one frozen dataclass for every architecture of
the JAX package (dense GQA decoders, mixed local/global attention, QKV
bias, MoE, MLA, encoder-decoder, RWKV6, hybrid SSM).  The port's copy of
``repro.models.config.ModelConfig``, field for field, so a configuration
means the same in both packages.  The port's model stack runs every
architecture of ``configs.ARCHS``: the GQA decoders (mixed local / global
windows, QKV bias, a stub frontend, an encoder-decoder), MoE with MLA,
RWKV6, and hymba's SSD heads beside its attention.  ``ShapeConfig``,
``SHAPES`` and ``shapes_for`` are the reference's input-shape cells, which
``launch.specs.make_rules`` reads.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | audio | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # ---- attention pattern
    attn_kind: str = "full"      # full | sliding | mixed (local + periodic global)
    window: int = 0              # sliding-window size (local layers)
    global_every: int = 0        # mixed: layer i is global iff (i+1) % global_every == 0
    qkv_bias: bool = False
    logit_softcap: float = 0.0

    # ---- MLP
    mlp_act: str = "silu_glu"    # silu_glu | gelu_glu | gelu | relu2

    # ---- MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0       # leading layers with a dense MLP (deepseek)
    dense_d_ff: int = 0          # d_ff of those dense layers
    capacity_factor: float = 1.25

    # ---- MLA (deepseek)
    mla: bool = False
    kv_lora_rank: int = 0
    rope_head_dim: int = 0       # decoupled RoPE key dim

    # ---- sequence mixers beyond attention
    rwkv: bool = False           # RWKV6: attention-free linear attention
    ssm: bool = False            # hymba: parallel SSM (SSD) heads next to attn
    ssm_state: int = 0

    # ---- topology
    arch_kind: str = "decoder"   # decoder | encdec
    n_enc_layers: int = 0
    frontend: str = "none"       # none | audio_stub | vision_stub
    n_frontend_tokens: int = 0   # patches/frames prepended by the stub

    # ---- numerics / runtime
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = True
    attn_q_chunk: int = 1024     # query-chunked attention (memory-bounded)
    attn_kv_chunk: int = 0       # >0: online-softmax flash_xla path (§Perf)
    kv_cache_int8: bool = False  # int8 KV/latent cache (per-position absmax)
    scan_chunk: int = 64         # rwkv/ssm chunk length

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0 or self.rwkv

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_is_global(self, i: int) -> bool:
        if self.attn_kind == "full":
            return True
        if self.attn_kind == "sliding":
            return False
        return (i + 1) % max(self.global_every, 1) == 0

    # ------------------------------------------------------- parameter counts
    def param_count(self) -> int:
        """Exact dense parameter count (embeddings included)."""
        d, ff, hd = self.d_model, self.d_ff, self.head_dim
        n_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.mla:
            nope = hd
            n_attn = (d * self.n_heads * (nope + self.rope_head_dim)  # W_Q
                      + d * (self.kv_lora_rank + self.rope_head_dim)  # W_DKV
                      + self.kv_lora_rank * self.n_heads * nope * 2   # W_UK/UV
                      + self.n_heads * nope * d)                      # W_O
        glu = self.mlp_act.endswith("_glu")
        def mlp(dff):
            return d * dff * (3 if glu else 2)
        if self.rwkv:
            n_mix = 4 * d * d + d * d  # r,k,v,g(+decay lora approx) + out
            n_layer = n_mix + mlp(ff)
        elif self.n_experts:
            n_router = d * self.n_experts
            n_exp = self.n_experts * mlp(self.d_expert)
            n_shared = self.n_shared_experts * mlp(self.d_expert)
            n_layer = n_attn + n_router + n_exp + n_shared
        else:
            n_layer = n_attn + mlp(ff)
        if self.ssm:
            P = self.q_dim // max(self.n_heads, 1)
            n_layer += d * self.q_dim + self.q_dim * d \
                + 2 * d * self.ssm_state * self.n_heads + d * self.n_heads
        total = self.n_layers * n_layer
        if self.first_k_dense:
            total += self.first_k_dense * (mlp(self.dense_d_ff or ff)
                                           - (d * self.n_experts
                                              + self.n_experts * mlp(self.d_expert)
                                              + self.n_shared_experts * mlp(self.d_expert)))
        if self.arch_kind == "encdec":
            enc_layer = n_attn + mlp(ff)
            cross = n_attn
            total += self.n_enc_layers * enc_layer + self.n_layers * cross
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        glu = self.mlp_act.endswith("_glu")
        per_expert = self.d_model * self.d_expert * (3 if glu else 2)
        inactive = (self.n_experts - self.top_k) * per_expert * \
            (self.n_layers - self.first_k_dense)
        return int(self.param_count() - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell: the reference's, which its
    ``launch/specs.py`` sizes the sharding rules by."""

    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k only for the sub-quadratic architectures
LONG_CONTEXT_ARCHS = ("rwkv6-1.6b", "hymba-1.5b", "gemma3-12b")


def shapes_for(arch_name: str) -> Tuple[str, ...]:
    base = ("train_4k", "prefill_32k", "decode_32k")
    if arch_name in LONG_CONTEXT_ARCHS:
        return base + ("long_500k",)
    return base
