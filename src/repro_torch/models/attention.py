"""GQA attention of the dense decoder: the port's ``repro.models.attention``
(``rope``, ``_proj``, ``_rms``, ``_cache_update``, ``attention_block``).

Every attention call goes through a hand-written kernel (``kernels.ops``):

- no cache (a training-style forward), or the engine's prefill
  (``cache_pos == 0``, the prompt's keys written from position 0): causal
  attention of the ``S`` new positions over themselves, which is
  ``flash_attention(q, k, v, causal=True, window=window)``;
- one new token against the cache (``S == 1``, ``cache_pos`` a scalar or a
  (B,) vector of per-slot depths): ``kv_len = cache_pos + 1`` and no causal
  mask is needed, which is ``decode_attention(q[:, 0], ck, cv, kv_len,
  window=window)``: the layer's window keeps the keys at positions
  ``>= kv_len - window``, the reference's ``q_pos - k_pos < window``;
- cross-attention onto ``cross_states`` (whisper's decoder onto the
  encoder's output, and its encoder's bidirectional self-attention, which
  the reference writes as cross-attention onto the layer's own normed
  input): no rope, no mask, every query against all ``Se`` states.  ``S >
  1`` queries are ``flash_attention(q, k, v, causal=False)``; one query (a
  decode step) is ``decode_attention`` with ``kv_len = Se``, whose splits
  spread the ``Se`` keys over the card where a flash call with one query
  row would run ``H`` CTAs.

These are the cases ``serving.engine`` and the encoder-decoder form, and
the functions the JAX package's XLA path (``gqa_attention``) computes
there.  Every other case raises ``NotImplementedError`` naming its ROADMAP
item, on the CPU too, so nothing runs quietly outside the kernels on the
card.

The reference's dtype sequence is kept: projections in the activations'
type, ``rope`` and ``_rms`` in fp32 and cast back.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.ops import decode_attention, flash_attention

_ROADMAP = "ROADMAP Queue 1 item 8"


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    f32 = torch.float32
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=f32,
                                          device=x.device) / half))
    angles = positions[..., None].to(f32) * freqs        # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _proj(x, w, b=None):
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _rms(x, scale, eps):
    x32 = x.to(torch.float32)
    n = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (n * scale.to(torch.float32)).to(x.dtype)


def _cache_update(ck, cv, k, v, cache_pos):
    """Write the new K/V into the cache at ``cache_pos`` (an int, or a (B,)
    tensor for continuous batching, where each slot sits at its own
    depth), in place: the JAX package returns new arrays, the port saves
    the copy of the whole cache each layer and step."""
    S = k.shape[1]
    if not isinstance(cache_pos, torch.Tensor) or cache_pos.dim() == 0:
        p = int(cache_pos)
        ck[:, p:p + S] = k
        cv[:, p:p + S] = v
        return
    rows = torch.arange(ck.shape[0], device=ck.device)[:, None]
    cols = cache_pos.to(ck.device).long()[:, None] + \
        torch.arange(S, device=ck.device)[None, :]
    ck[rows, cols] = k.to(ck.dtype)
    cv[rows, cols] = v.to(cv.dtype)


def _cross_attention(q, k, v):
    """Every query against every key, no mask: q (B, S, H, hd), k / v (B,
    Se, KV, hd)."""
    B, S = q.shape[:2]
    if S == 1:
        kv_len = torch.full((B,), k.shape[1], dtype=torch.int32,
                            device=q.device)
        return decode_attention(q[:, 0], k, v, kv_len)[:, None]
    return flash_attention(q, k, v, causal=False)


def attention_block(blk, x, cfg, *, positions, window: int, cache=None,
                    cache_pos=None, cross_states=None,
                    prefix: str = "") -> Tuple:
    """Standard GQA attention of one layer, or cross-attention onto
    ``cross_states`` (B, Se, d).  x (B, S, d); cache None or a dict {"k",
    "v"} of (B, Smax, KV, hd), written in place; returns (out, the cache or
    None).  ``window`` is the layer's window (0: full attention);
    ``prefix`` picks the block's weights (``"x_"``: the decoder's cross
    projections).  As in the reference, the query bias applies only without
    a prefix and the cross keys and values take none."""
    if cfg.mla:
        raise NotImplementedError(f"MLA attention is {_ROADMAP}")
    if cfg.logit_softcap > 0:
        raise NotImplementedError(f"attention logit softcap is {_ROADMAP}")
    if cache is not None and "k_q" in cache:
        raise NotImplementedError(f"the int8 KV cache is {_ROADMAP}")
    B, S, _ = x.shape
    H, KVh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bias = cfg.qkv_bias

    def g(name):
        return blk[prefix + name]

    q = _proj(x, g("wq"), g("bq") if bias and not prefix else None
              ).reshape(B, S, H, hd)
    if cross_states is not None:
        e = cross_states.to(x.dtype)
        Se = e.shape[1]
        k = _proj(e, g("wk")).reshape(B, Se, KVh, hd)
        v = _proj(e, g("wv")).reshape(B, Se, KVh, hd)
        out = _cross_attention(q, k, v)
        return _proj(out.reshape(B, S, H * hd), g("wo")), None
    k = _proj(x, g("wk"), g("bk") if bias else None).reshape(B, S, KVh, hd)
    v = _proj(x, g("wv"), g("bv") if bias else None).reshape(B, S, KVh, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        return _proj(flash_attention(q, k, v, causal=True,
                                     window=int(window)).reshape(B, S, H * hd),
                     g("wo")), None
    prefill = not isinstance(cache_pos, torch.Tensor) and int(cache_pos) == 0
    if not prefill and S != 1:
        raise NotImplementedError(
            f"{S} tokens against a cache at a nonzero position (chunked "
            f"prefill) is {_ROADMAP}")
    ck, cv = cache["k"], cache["v"]
    _cache_update(ck, cv, k, v, cache_pos)
    if prefill:
        # the prompt from position 0: causal over the keys just written,
        # which are k and v themselves (ck[:, :S], cv[:, :S])
        out = flash_attention(q, k, v, causal=True, window=int(window))
    else:
        kv_len = (torch.zeros((B,), dtype=torch.int32, device=x.device)
                  + torch.as_tensor(cache_pos, device=x.device) + 1
                  ).to(torch.int32)
        out = decode_attention(q[:, 0], ck, cv, kv_len,
                               window=int(window))[:, None]
    return _proj(out.reshape(B, S, H * hd), g("wo")), {"k": ck, "v": cv}
