"""Chunked linear-attention recurrences: the port's
``repro.models.linear_scan`` for RWKV6 (per-channel data-dependent decay
plus the bonus ``u``).

State:  S_t = diag(w_t) S_{t-1} + k_t v_t^T           (S: (K, V) per head)
RWKV6:  y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)       (pre-update + bonus)

``chunked_linear_attention`` computes the RWKV6 case from a zero state, the
only one the port's engine forms (a prefill starts its slot afresh; see
``transformer._rwkv_layer``), through the hand-written kernel
``kernels.ops.rwkv6_chunked``.  The SSD case (post-update output, hymba's
SSM heads) and a carried initial state (chunked prefill) raise
``NotImplementedError`` naming their ROADMAP item, on the CPU too.
``linear_attention_step``, the one-token decode, is plain torch ops: the
JAX package has no kernel for it either.  fp32 throughout.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.ops import rwkv6_chunked
from ..kernels.rwkv6 import LOG_DECAY_MIN

_ROADMAP = "ROADMAP Queue 1 item 8"


def chunked_linear_attention(r, k, v, logw, *, u=None,
                             post_update: bool = False, chunk: int = 16,
                             initial_state: Optional[torch.Tensor] = None):
    """r, k, logw (B, S, H, K); v (B, S, H, V); u (H, K) bonus.  Returns
    (y (B, S, H, V) fp32, final state (B, H, K, V) fp32)."""
    if post_update:
        raise NotImplementedError(f"the SSD recurrence (hymba's SSM heads) "
                                  f"is {_ROADMAP}")
    if u is None:
        raise NotImplementedError(f"linear attention without the RWKV6 "
                                  f"bonus is {_ROADMAP}")
    if initial_state is not None:
        raise NotImplementedError(f"a carried initial state (chunked "
                                  f"prefill) is {_ROADMAP}")
    return rwkv6_chunked(r, k, v, logw.float(), u.float().contiguous(),
                         chunk=chunk)


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
