"""The dense decoder's forward pass: the port's ``repro.models.transformer``
(``Runtime``, ``mlp``, ``layer_windows``, the dense path of ``_std_layer``,
``init_cache`` for the k/v cache, and ``forward``) for the architectures
``configs.ARCHS`` lists.

Modes: "train" (causal, no cache, logits for every position), "prefill"
(fills the cache from position 0 and keeps only the last position's
logits), "decode" (one token per row against the cache, ``cache_pos`` a
scalar or a (B,) vector of per-row depths).  The layers are stacked along
a leading axis as in the reference; a Python loop over them takes the
place of ``lax.scan``.  The cache is written in place and returned.

The reference's dtype sequence is kept: embeddings and each layer's
matrices in ``cfg.dtype``, the norms and ``rope`` in fp32 and cast back.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .attention import _rms, attention_block
from .config import ModelConfig
from .params import _dtype, _supported


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution context threaded through the forward pass.  The reference
    carries a device mesh, sharding rules and MoE / MLA switches in it; the
    port runs the dense decoder on one card and needs none of them yet."""


def _act(cfg: ModelConfig, gate, up):
    """The MLP activation (the reference's ``models.moe._act``) for the
    port's configurations: ``silu_glu``."""
    if cfg.mlp_act != "silu_glu":
        raise NotImplementedError(f"mlp_act {cfg.mlp_act!r} is ROADMAP "
                                  "Queue 1 item 8")
    return F.silu(gate) * up


def mlp(blk, x, cfg: ModelConfig):
    up = x @ blk["w_in"].to(x.dtype)
    gate = x @ blk["w_gate"].to(x.dtype) if "w_gate" in blk else None
    return _act(cfg, gate, up) @ blk["w_out"].to(x.dtype)


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention window (0 = full attention)."""
    return np.array([0 if cfg.layer_is_global(i) else cfg.window
                     for i in range(cfg.n_layers)], np.int32)


def _std_layer(blk, x, cfg, rt: Runtime, *, positions, window, cache,
               cache_pos):
    """Attention + MLP layer of the dense decoder."""
    xn = _rms(x, blk["ln1"], cfg.norm_eps)
    attn, new_cache = attention_block(blk, xn, cfg, positions=positions,
                                      window=window, cache=cache,
                                      cache_pos=cache_pos)
    x = x + attn
    xn2 = _rms(x, blk["ln2"], cfg.norm_eps)
    return x + mlp(blk, xn2, cfg), new_cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Dict:
    """Stacked (leading layer axis) k/v decode cache, zeros, on
    ``device``."""
    from ..kernels.ops import resolve_device
    _supported(cfg)
    if cfg.kv_cache_int8:
        raise NotImplementedError("the int8 KV cache is ROADMAP Queue 1 "
                                  "item 8")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    dt = _dtype(cfg, dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def forward(params, cfg: ModelConfig, rt: Runtime, tokens: torch.Tensor, *,
            mode: str = "train", cache: Optional[Dict] = None,
            cache_pos=None):
    """tokens: (B, S) integer.  Returns (logits, cache or None, aux loss),
    as the reference does (the aux loss is 0: no MoE here)."""
    _supported(cfg)
    B, S = tokens.shape
    dev = tokens.device
    cdt = _dtype(cfg, None)
    x = params["embed"].to(cdt)[tokens]
    if cache_pos is None:
        cache_pos = 0
    pos0 = torch.as_tensor(cache_pos, dtype=torch.int32, device=dev)
    if pos0.dim() == 1:
        pos0 = pos0[:, None]   # per-slot depths (continuous batching)
    positions = pos0 + torch.arange(S, dtype=torch.int32, device=dev)[None, :] \
        + torch.zeros((B, 1), dtype=torch.int32, device=dev)
    windows = layer_windows(cfg)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        # the layer's matrices in the compute type, as the reference's scan
        # body casts its layer slice
        blk = {k: (w[i].to(cdt) if w.dim() >= 3 and w.is_floating_point()
                   else w[i]) for k, w in layers.items()}
        csl = None if cache is None else {k: c[i] for k, c in cache.items()}
        x, _ = _std_layer(blk, x, cfg, rt, positions=positions,
                          window=int(windows[i]), cache=csl,
                          cache_pos=cache_pos)
    if mode == "prefill":
        x = x[:, -1:]   # serving needs only the next token's logits
    x = _rms(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    return logits, cache, torch.zeros((), dtype=torch.float32, device=dev)
