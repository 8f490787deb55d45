"""Chunked linear-attention recurrences: the port's
``repro.models.linear_scan`` for RWKV6 (per-channel data-dependent decay
plus the bonus ``u``) and the SSD-style selective SSM (a scalar decay per
head, broadcast over its channels; hymba's SSM heads).

State:  S_t = diag(w_t) S_{t-1} + k_t v_t^T           (S: (K, V) per head)
RWKV6:  y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)       (pre-update + bonus)
SSD:    y_t = C_t S_t                                  (post-update)

``chunked_linear_attention`` computes both, with or without the bonus and
from a zero or a carried initial state, through the hand-written kernel
``kernels.ops.rwkv6_chunked`` (its post-update variant for the SSD).
``linear_attention_step``, the one-token decode, is plain torch ops: the
JAX package has no kernel for it either.  fp32 throughout.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.ops import rwkv6_chunked
from ..kernels.rwkv6 import LOG_DECAY_MIN


def chunked_linear_attention(r, k, v, logw, *, u=None,
                             post_update: bool = False, chunk: int = 16,
                             initial_state: Optional[torch.Tensor] = None):
    """r, k, logw (B, S, H, K) (SSD: the decay broadcast over K); v (B, S,
    H, V); u (H, K) bonus or None; ``initial_state`` (B, H, K, V) or None
    (zeros).  Returns (y (B, S, H, V) fp32, final state (B, H, K, V)
    fp32).  r, k and v of one type go to the kernel as they are (it widens
    them to fp32 as it loads them); of mixed types (the SSD's fp32 ``k =
    B dt`` beside bf16 C and x) all three are widened first, as the
    reference widens them."""
    f32 = torch.float32
    if not r.dtype == k.dtype == v.dtype:
        r, k, v = r.to(f32), k.to(f32), v.to(f32)
    return rwkv6_chunked(
        r, k, v, logw.to(f32).contiguous(),
        None if u is None else u.to(f32).contiguous(), chunk=chunk,
        post_update=post_update,
        initial_state=None if initial_state is None else
        initial_state.to(f32).contiguous())


def linear_attention_step(r, k, v, logw, state, *, u=None,
                          post_update: bool = False):
    """Single-token decode.  r, k: (B, H, K); v: (B, H, V); state (B, H, K,
    V) fp32.  Returns (y (B, H, V), new state)."""
    f32 = torch.float32
    r, k, v = r.to(f32), k.to(f32), v.to(f32)
    w = torch.exp(logw.to(f32).clamp(LOG_DECAY_MIN, 0.0))
    kv = k[..., :, None] * v[..., None, :]
    new_state = w[..., None] * state + kv
    read = new_state if post_update else state
    y = torch.einsum("bhk,bhkv->bhv", r, read)
    if u is not None:
        y = y + torch.einsum("bhk,hk->bh", r * k, u.to(f32))[..., None] * v
    return y, new_state
