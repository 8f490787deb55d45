"""Parameter templates and random initialisation of the dense GQA decoder
and of RWKV6: the port's copy of ``repro.models.params`` (``template``,
``_finalize``, ``init_params``) for the architectures ``configs.ARCHS``
lists.

The tree is the reference's: ``embed``, ``final_norm``, ``lm_head`` (unless
tied) and ``layers``, a dict whose every entry carries a leading layer axis.
Initialisers and scales are the reference's too: ``normal`` times
``scale / sqrt(fan_in)`` for a dense weight, ones for a norm and RWKV6's
``gn_scale``, zeros for the QKV biases and for RWKV6's token-shift mixes,
``decay_base`` and ``bonus_u``.  The numbers differ (a ``torch.Generator``
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


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: Tuple[int, ...]
    init: str = "normal"       # normal | zeros | ones
    scale: float = 1.0         # stddev multiplier for "normal"


def _norm(d: int) -> ParamMeta:
    return ParamMeta((d,), "ones")


def _dense(fan_in: int, fan_out: int) -> ParamMeta:
    return ParamMeta((fan_in, fan_out), "normal", 1.0 / math.sqrt(fan_in))


def _supported(cfg: ModelConfig) -> None:
    if cfg.mla or cfg.ssm or cfg.n_experts or \
            cfg.arch_kind != "decoder" or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the port's model stack runs the dense GQA decoder "
            "and RWKV6 only; MoE, MLA, SSM heads, encoder-decoder and "
            "frontends are ROADMAP Queue 1 item 8")


def _rwkv_block(cfg: ModelConfig) -> Dict[str, ParamMeta]:
    """RWKV6's layer: static token-shift mixes, the r/k/v/g projections,
    the data-dependent decay as a rank-64 LoRA over ``decay_base``, the
    bonus ``u``, the per-head group norm's scale, and a relu^2 MLP with no
    gate."""
    d, a = cfg.d_model, cfg.q_dim
    return {"ln1": _norm(d),
            **{f"mix_{n}": ParamMeta((d,), "zeros") for n in "rkvgw"},
            "w_r": _dense(d, a), "w_k": _dense(d, a), "w_v": _dense(d, a),
            "w_g": _dense(d, a),
            "decay_a": _dense(d, 64), "decay_b": _dense(64, a),
            "decay_base": ParamMeta((a,), "zeros"),
            "bonus_u": ParamMeta((a,), "zeros"),
            "gn_scale": ParamMeta((a,), "ones"),
            "wo": _dense(a, d), "ln2": _norm(d),
            "mix_f": ParamMeta((d,), "zeros"),
            "w_in": _dense(d, cfg.d_ff), "w_out": _dense(cfg.d_ff, d)}


def _decoder_layer(cfg: ModelConfig) -> Dict[str, ParamMeta]:
    d = cfg.d_model
    blk = {"ln1": _norm(d),
           "wq": _dense(d, cfg.q_dim), "wk": _dense(d, cfg.kv_dim),
           "wv": _dense(d, cfg.kv_dim), "wo": _dense(cfg.q_dim, d)}
    if cfg.qkv_bias:
        blk["bq"] = ParamMeta((cfg.q_dim,), "zeros")
        blk["bk"] = ParamMeta((cfg.kv_dim,), "zeros")
        blk["bv"] = ParamMeta((cfg.kv_dim,), "zeros")
    blk["ln2"] = _norm(d)
    blk["w_in"] = _dense(d, cfg.d_ff)
    blk["w_out"] = _dense(cfg.d_ff, d)
    if cfg.mlp_act.endswith("_glu"):
        blk["w_gate"] = _dense(d, cfg.d_ff)
    return blk


def template(cfg: ModelConfig) -> Dict:
    """The parameter template.  The layer dict is *unstacked*; every entry
    of ``layers`` gets a leading axis of ``cfg.n_layers`` (``_finalize``)."""
    _supported(cfg)
    tpl = {"embed": ParamMeta((cfg.vocab, cfg.d_model), "normal", 1.0),
           "final_norm": _norm(cfg.d_model),
           "layers": _rwkv_block(cfg) if cfg.rwkv else _decoder_layer(cfg)}
    if not cfg.tie_embeddings:
        tpl["lm_head"] = _dense(cfg.d_model, cfg.vocab)
    return tpl


def _finalize(cfg: ModelConfig, leaf_fn) -> Dict:
    """Apply ``leaf_fn(meta, stacked_n)`` over the template, ``stacked_n``
    the layer count for the entries of ``layers`` and None elsewhere."""
    out = {}
    for key, sub in template(cfg).items():
        if isinstance(sub, dict):
            out[key] = {k: leaf_fn(m, cfg.n_layers) for k, m in sub.items()}
        else:
            out[key] = leaf_fn(sub, None)
    return out


def _dtype(cfg: ModelConfig, dtype) -> torch.dtype:
    if dtype is None:
        dtype = cfg.dtype
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype=None) -> Dict:
    """Random parameters made directly on ``device`` in ``dtype`` (default
    ``cfg.dtype``) from one ``torch.Generator`` seeded with ``seed`` on that
    device.  A normal weight is drawn in fp32, scaled and cast one layer
    at a time, so no fp32 copy of the whole stack is ever held."""
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
        for part in (out if n else [out]):
            part.copy_(torch.randn(meta.shape, generator=gen, device=dev,
                                   dtype=torch.float32) * meta.scale)
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

    tpl = template(cfg)
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
            out[key] = {k: leaf(m, cfg.n_layers, tree[key][k])
                        for k, m in sub.items()}
        else:
            out[key] = leaf(sub, None, tree[key])
    return out


def param_count(params: Dict) -> int:
    """Elements in a parameter tree."""
    return sum(v.numel() if isinstance(v, torch.Tensor) else param_count(v)
               for v in params.values())
