"""Parameter templates and random initialisation of the GQA and MLA
decoders (dense MLPs or MoE, whisper's encoder and cross-attention, hymba's
SSD branch) and of RWKV6: the port's copy of ``repro.models.params``
(``template``, ``stack_counts``, ``_finalize``, ``init_params``) for the
architectures ``configs.ARCHS`` lists.

The tree is the reference's: ``embed``, ``final_norm``, ``lm_head`` (unless
tied) and ``layers``, a dict whose every entry carries a leading layer axis;
an encoder-decoder adds ``enc_layers`` (stacked ``n_enc_layers`` deep) and
``enc_norm``, and its decoder layers ``ln_x`` and ``x_wq`` .. ``x_wo``.  An
MoE layer holds the ``router``, the experts' ``we_in`` / ``we_gate`` /
``we_out`` stacked over experts and the shared experts' ``shared_*``; its
first ``first_k_dense`` layers (deepseek) are the stack ``dense_layers``,
with a dense MLP of ``dense_d_ff``.  An MLA layer holds ``wq`` of ``H * (hd
+ r)`` columns, ``w_dkv``, ``kv_norm``, ``w_uk``, ``w_uv`` and ``wo``.  A
hybrid layer (hymba) adds the SSD branch: ``ws_in``, ``ws_dt``,
``dt_bias``, ``ws_B``, ``ws_C``, ``A_log``, ``ssm_D``, ``ssm_norm`` and
``ws_out``.
Initialisers and scales are the reference's too: ``normal`` times
``scale / sqrt(fan_in)`` for a dense weight (an expert's by its own fan
in), ones for a norm, RWKV6's ``gn_scale`` and the SSD's ``ssm_D``, zeros for
the QKV biases, RWKV6's token-shift mixes, ``decay_base`` and ``bonus_u``,
and the SSD's ``dt_bias`` and ``A_log``.  Each leaf names its dims' logical axes
as the reference's does (``vocab``, ``embed``, ``heads``, ``kv_heads``,
``mlp``, ``expert``, ``kv_lora`` or None; ``logical_axes`` adds
``layers`` on a stacked leaf).  The numbers differ (a ``torch.Generator``
is not a JAX key); ``params_from_reference`` carries the JAX package's own
weights across.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import ModelConfig


Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: Tuple[int, ...]
    axes: Axes                 # logical axis names, len == len(shape)
    init: str = "normal"       # normal | zeros | ones
    scale: float = 1.0         # stddev multiplier for "normal"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} has {len(self.shape)} "
                             f"dims, axes {self.axes} name {len(self.axes)}")


def _norm(d: int) -> ParamMeta:
    return ParamMeta((d,), (None,), "ones")


def _dense(fan_in: int, fan_out: int, axes: Axes) -> ParamMeta:
    return ParamMeta((fan_in, fan_out), axes, "normal",
                     1.0 / math.sqrt(fan_in))


def _rwkv_block(cfg: ModelConfig) -> Dict[str, ParamMeta]:
    """RWKV6's layer: static token-shift mixes, the r/k/v/g projections,
    the data-dependent decay as a rank-64 LoRA over ``decay_base``, the
    bonus ``u``, the per-head group norm's scale, and a relu^2 MLP with no
    gate."""
    d, a = cfg.d_model, cfg.q_dim
    EH, HE = ("embed", "heads"), ("heads", "embed")
    return {"ln1": _norm(d),
            **{f"mix_{n}": ParamMeta((d,), (None,), "zeros")
               for n in "rkvgw"},
            "w_r": _dense(d, a, EH), "w_k": _dense(d, a, EH),
            "w_v": _dense(d, a, EH), "w_g": _dense(d, a, EH),
            "decay_a": _dense(d, 64, ("embed", None)),
            "decay_b": _dense(64, a, (None, "heads")),
            "decay_base": ParamMeta((a,), ("heads",), "zeros"),
            "bonus_u": ParamMeta((a,), ("heads",), "zeros"),
            "gn_scale": ParamMeta((a,), ("heads",), "ones"),
            "wo": _dense(a, d, HE), "ln2": _norm(d),
            "mix_f": ParamMeta((d,), (None,), "zeros"),
            **_mlp_block(cfg, cfg.d_ff)}


def _ssm_block(cfg: ModelConfig) -> Dict[str, ParamMeta]:
    """The SSD branch (hymba's mamba heads, state N): the input, step,
    B and C projections, the step's bias, the per-head decay rate's log,
    the skip ``D``, the branch's norm and its output projection."""
    d, H, N, P = cfg.d_model, cfg.n_heads, cfg.ssm_state, cfg.head_dim
    EH = ("embed", "heads")
    return {"ws_in": _dense(d, H * P, EH), "ws_dt": _dense(d, H, EH),
            "dt_bias": ParamMeta((H,), ("heads",), "zeros"),
            "ws_B": _dense(d, H * N, EH), "ws_C": _dense(d, H * N, EH),
            "A_log": ParamMeta((H,), ("heads",), "zeros"),
            "ssm_D": ParamMeta((H,), ("heads",), "ones"),
            "ssm_norm": _norm(H * P),
            "ws_out": _dense(H * P, d, ("heads", "embed"))}


def _attention_block(cfg: ModelConfig,
                     cross: bool = False) -> Dict[str, ParamMeta]:
    d = cfg.d_model
    EH, HE = ("embed", "heads"), ("heads", "embed")
    if cfg.mla and not cross:
        lora, r = cfg.kv_lora_rank, cfg.rope_head_dim
        return {"wq": _dense(d, cfg.n_heads * (cfg.head_dim + r), EH),
                "w_dkv": _dense(d, lora + r, ("embed", None)),
                "kv_norm": _norm(lora),
                "w_uk": _dense(lora, cfg.q_dim, ("kv_lora", "heads")),
                "w_uv": _dense(lora, cfg.q_dim, ("kv_lora", "heads")),
                "wo": _dense(cfg.q_dim, d, HE)}
    EK = ("embed", "kv_heads")
    blk = {"wq": _dense(d, cfg.q_dim, EH), "wk": _dense(d, cfg.kv_dim, EK),
           "wv": _dense(d, cfg.kv_dim, EK), "wo": _dense(cfg.q_dim, d, HE)}
    if cfg.qkv_bias:
        blk["bq"] = ParamMeta((cfg.q_dim,), ("heads",), "zeros")
        blk["bk"] = ParamMeta((cfg.kv_dim,), ("kv_heads",), "zeros")
        blk["bv"] = ParamMeta((cfg.kv_dim,), ("kv_heads",), "zeros")
    return blk


def _mlp_block(cfg: ModelConfig, d_ff: int) -> Dict[str, ParamMeta]:
    d = cfg.d_model
    blk = {"w_in": _dense(d, d_ff, ("embed", "mlp")),
           "w_out": _dense(d_ff, d, ("mlp", "embed"))}
    if cfg.mlp_act.endswith("_glu"):
        blk["w_gate"] = _dense(d, d_ff, ("embed", "mlp"))
    return blk


def _moe_block(cfg: ModelConfig) -> Dict[str, ParamMeta]:
    """The router, E experts' MLPs stacked over experts, and the shared
    experts as one MLP of ``n_shared_experts * d_expert``."""
    d, E, fe = cfg.d_model, cfg.n_experts, cfg.d_expert
    s = 1.0 / math.sqrt(d)
    EEM = ("expert", "embed", "mlp")
    blk = {"router": _dense(d, E, ("embed", None)),
           "we_in": ParamMeta((E, d, fe), EEM, "normal", s),
           "we_out": ParamMeta((E, fe, d), ("expert", "mlp", "embed"),
                               "normal", 1.0 / math.sqrt(fe))}
    if cfg.mlp_act.endswith("_glu"):
        blk["we_gate"] = ParamMeta((E, d, fe), EEM, "normal", s)
    if cfg.n_shared_experts:
        blk.update({f"shared_{k}": m for k, m in
                    _mlp_block(cfg, cfg.n_shared_experts * fe).items()})
    return blk


def _decoder_layer(cfg: ModelConfig, moe: bool) -> Dict[str, ParamMeta]:
    """Self-attention (GQA or MLA) and an MLP, or the MoE block where
    ``moe``; a dense layer of an MoE configuration (deepseek's first) takes
    ``dense_d_ff``.  With SSM heads, the SSD branch; with an encoder, the
    cross-attention's norm ``ln_x`` and its projections ``x_wq`` ..
    ``x_wo``."""
    blk = {"ln1": _norm(cfg.d_model), **_attention_block(cfg),
           "ln2": _norm(cfg.d_model)}
    if moe:
        blk.update(_moe_block(cfg))
    else:
        blk.update(_mlp_block(cfg, cfg.dense_d_ff if cfg.first_k_dense and
                              cfg.n_experts else cfg.d_ff))
    if cfg.ssm:
        blk.update(_ssm_block(cfg))
    if cfg.arch_kind == "encdec":
        blk["ln_x"] = _norm(cfg.d_model)
        blk.update({f"x_{k}": m for k, m in
                    _attention_block(cfg, cross=True).items()})
    return blk


def _encoder_layer(cfg: ModelConfig) -> Dict[str, ParamMeta]:
    return {"ln1": _norm(cfg.d_model), **_attention_block(cfg, cross=True),
            "ln2": _norm(cfg.d_model), **_mlp_block(cfg, cfg.d_ff)}


def template(cfg: ModelConfig) -> Dict:
    """The parameter template.  The layer dicts are *unstacked*; each entry
    of ``stack_counts(cfg)`` gets a leading axis of that many layers
    (``_finalize``)."""
    tpl = {"embed": ParamMeta((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                             "normal", 1.0),
           "final_norm": _norm(cfg.d_model),
           "layers": _rwkv_block(cfg) if cfg.rwkv else
           _decoder_layer(cfg, moe=bool(cfg.n_experts))}
    if not cfg.tie_embeddings:
        tpl["lm_head"] = _dense(cfg.d_model, cfg.vocab, ("embed", "vocab"))
    if cfg.first_k_dense:
        tpl["dense_layers"] = _decoder_layer(cfg, moe=False)
    if cfg.arch_kind == "encdec":
        tpl["enc_layers"] = _encoder_layer(cfg)
        tpl["enc_norm"] = _norm(cfg.d_model)
    return tpl


def stack_counts(cfg: ModelConfig) -> Dict[str, int]:
    """Depth of each stacked entry of the template."""
    out = {"layers": cfg.n_layers - cfg.first_k_dense}
    if cfg.first_k_dense:
        out["dense_layers"] = cfg.first_k_dense
    if cfg.arch_kind == "encdec":
        out["enc_layers"] = cfg.n_enc_layers
    return out


def _finalize(cfg: ModelConfig, leaf_fn) -> Dict:
    """Apply ``leaf_fn(meta, stacked_n)`` over the template, ``stacked_n``
    the depth from ``stack_counts`` for a stacked entry's leaves and None
    elsewhere."""
    stacks = stack_counts(cfg)
    out = {}
    for key, sub in template(cfg).items():
        if isinstance(sub, dict):
            out[key] = {k: leaf_fn(m, stacks[key]) for k, m in sub.items()}
        else:
            out[key] = leaf_fn(sub, None)
    return out


def logical_axes(cfg: ModelConfig) -> Dict:
    """Each leaf's logical axis names, ``"layers"`` first on a stacked
    leaf: the names ``models.sharding.tree_placements`` maps onto mesh
    axes."""
    return _finalize(cfg, lambda m, n: (("layers",) + m.axes) if n
                     else m.axes)


def _dtype(cfg: ModelConfig, dtype) -> torch.dtype:
    if dtype is None:
        dtype = cfg.dtype
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


# elements of one fp32 draw (1 GB): a larger leaf is drawn in blocks of rows
_DRAW_ELEMS = 1 << 28


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype=None) -> Dict:
    """Random parameters made directly on ``device`` in ``dtype`` (default
    ``cfg.dtype``) from one ``torch.Generator`` seeded with ``seed`` on that
    device.  A normal weight is drawn in fp32, a layer at a time and, past
    ``_DRAW_ELEMS`` elements, in blocks of rows, scaled in place and cast:
    no fp32 copy of a whole stack or of a whole large matrix (nemotron's
    256000 x 18432 ``lm_head``) is ever held."""
    from ..kernels.ops import resolve_device
    dev = resolve_device(device)
    dt = _dtype(cfg, dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def leaf(meta: ParamMeta, n: Optional[int]):
        shape = ((n,) + meta.shape) if n else meta.shape
        if meta.init == "zeros":
            return torch.zeros(shape, dtype=dt, device=dev)
        if meta.init == "ones":
            return torch.ones(shape, dtype=dt, device=dev)
        out = torch.empty(shape, dtype=dt, device=dev)
        rows, rest = meta.shape[0], meta.shape[1:]
        step = max(1, _DRAW_ELEMS // max(1, math.prod(rest)))
        for part in (out if n else [out]):
            for r0 in range(0, rows, step):
                blk = torch.randn((min(step, rows - r0),) + rest,
                                  generator=gen, device=dev,
                                  dtype=torch.float32)
                part[r0:r0 + blk.shape[0]].copy_(blk.mul_(meta.scale))
        return out

    return _finalize(cfg, leaf)


def params_from_reference(tree: Dict, cfg: ModelConfig, *, device="cuda",
                          dtype=None) -> Dict:
    """The JAX package's parameters of ``cfg`` (its ``init_params`` tree,
    leaves as numpy arrays) as the port's, on ``device`` in ``dtype``
    (default ``cfg.dtype``).  The two trees have the same keys and shapes;
    anything else raises."""
    from ..kernels.ops import resolve_device
    dev = resolve_device(device)
    dt = _dtype(cfg, dtype)

    def leaf(meta: ParamMeta, n: Optional[int], arr):
        shape = ((n,) + meta.shape) if n else meta.shape
        arr = np.array(arr, np.float32)   # a writable copy
        if arr.shape != shape:
            raise ValueError(f"reference leaf of shape {arr.shape}, the "
                             f"template wants {shape}")
        return torch.from_numpy(arr).to(device=dev, dtype=dt)

    tpl, stacks = template(cfg), stack_counts(cfg)
    if set(tree) != set(tpl):
        raise ValueError(f"reference tree has keys {sorted(tree)}, the "
                         f"template {sorted(tpl)}")
    out = {}
    for key, sub in tpl.items():
        if isinstance(sub, dict):
            if set(tree[key]) != set(sub):
                raise ValueError(f"{key}: reference keys "
                                 f"{sorted(tree[key])}, template "
                                 f"{sorted(sub)}")
            out[key] = {k: leaf(m, stacks[key], tree[key][k])
                        for k, m in sub.items()}
        else:
            out[key] = leaf(sub, None, tree[key])
    return out


def param_count(params: Dict) -> int:
    """Elements in a parameter tree."""
    return sum(v.numel() if isinstance(v, torch.Tensor) else param_count(v)
               for v in params.values())
