"""Per-architecture sharding choices and the cache layout: the part of the
port's ``repro.launch.specs`` that lowers nothing.

``MICROBATCHES``, ``SEQ_PARALLEL``, ``INT8_OPT``, ``BF16_ACCUM``,
``make_rules`` and ``opt_config`` are the reference's.  The reference's
``Cell`` and ``build_cell`` lower XLA for its dry run; they are ROADMAP
Queue 1 item 9, as are its abstract batch and cache specs.

``cache_placements`` is the port's own cache layout, which differs from the
reference's dry-run layout (ROADMAP, "Where the port differs"): the batch
over the data axes where it divides, the kv heads over "model" where
``n_kv_heads`` divides it, and no sequence sharding.  Where the kv heads
stay whole in the weights but the query heads are split, each rank's cache
holds the kv heads its query heads read (``models.attention.kv_heads_for``),
which is no partition of the whole cache and is marked ``"select"``.
RWKV6's and the SSD's recurrent states go over "model" on their heads
where ``n_heads`` divides it, as the reference's ``cache_specs`` puts
them.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..models.config import ModelConfig, ShapeConfig
from ..models.sharding import ShardingRules, axis_sizes
from ..train.optimizer import OptConfig

# global-batch microbatch count for train_4k (per-device micro batch of 1-2)
MICROBATCHES = {
    "nemotron-4-340b": 16, "qwen2.5-14b": 16, "gemma3-12b": 16,
    "minitron-8b": 16, "pixtral-12b": 16, "deepseek-v2-lite-16b": 8,
    "granite-moe-3b-a800m": 8, "rwkv6-1.6b": 8, "hymba-1.5b": 8,
    "whisper-medium": 4,
}
# sequence parallelism: required for nemotron's 18k residual to fit 16GB
SEQ_PARALLEL = {"nemotron-4-340b"}
# int8 optimizer states: required for 340B x AdamW on a 16GB chip
INT8_OPT = {"nemotron-4-340b"}
# bf16 gradient accumulator (Megatron-style): 340B fp32 grads don't fit
BF16_ACCUM = {"nemotron-4-340b"}


def make_rules(cfg: ModelConfig, shape: ShapeConfig, multi_pod: bool,
               *, fsdp: Optional[bool] = None,
               seq_parallel: Optional[bool] = None) -> ShardingRules:
    dp = ("pod", "data") if multi_pod else ("data",)
    if fsdp is None:
        fsdp = True   # params 2D-sharded everywhere (340B must; others cheap)
    if seq_parallel is None:
        seq_parallel = shape.kind in ("train", "prefill") \
            and cfg.name in SEQ_PARALLEL
    return ShardingRules(fsdp=fsdp, expert_parallel=True,
                         seq_parallel=seq_parallel, data_axes=dp,
                         fsdp_vocab_tables=shape.is_train)


def opt_config(cfg: ModelConfig) -> OptConfig:
    return OptConfig(state_dtype="int8" if cfg.name in INT8_OPT else "float32")


def cache_placements(cfg: ModelConfig, batch: int, mesh,
                     rules: ShardingRules) -> Dict[str, tuple]:
    """A placement for each leaf of ``init_cache(cfg, batch, ...)``:
    ``"k"``, ``"v"``, ``"k_q"``, ``"v_q"``, ``"k_s"``, ``"v_s"`` (L, B,
    Smax, KV, hd|1); ``"lat"`` (L, B, Smax, lora + r); ``"state"`` /
    ``"ssm"`` (L, B, H, *, *); ``"shift_a"`` / ``"shift_f"`` (L, B, d);
    ``"enc_out"`` (B, Se, d)."""
    sizes = axis_sizes(mesh)
    n_data = 1
    for a in rules.data_axes:
        n_data *= sizes[a]
    b_ax = rules.data_axes if batch % n_data == 0 else None
    m = sizes["model"]
    h_ax = None if cfg.n_heads % m else "model"
    kv_ax = h_ax and ("model" if cfg.n_kv_heads % m == 0 else "select")
    out = {}
    for name in ("k", "v", "k_q", "v_q", "k_s", "v_s"):
        out[name] = (None, b_ax, None, kv_ax, None)
    out["lat"] = (None, b_ax, None, None)
    for name in ("state", "ssm"):
        out[name] = (None, b_ax, h_ax, None, None)
    for name in ("shift_a", "shift_f"):
        out[name] = (None, b_ax, None)
    out["enc_out"] = (b_ax, None, None)
    return out
