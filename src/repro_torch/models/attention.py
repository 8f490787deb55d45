"""Attention of the decoders: the port's ``repro.models.attention``
(``rope``, ``_proj``, ``_rms``, the cache update, ``attention_block`` for
GQA, and ``mla_attention_block``, DeepSeek-V2's latent attention on the
reference's path without absorption).

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

MLA takes the first two cases with q and k of ``hd + r`` columns (the
head's ``hd`` and the shared rope key's ``r``) and V zero-padded from
``hd`` to the same width (see ``mla_attention_block``).

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
import torch.nn.functional as F

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


def _write_rows(c, u, cache_pos):
    """Write ``u`` (B, S, ...) into the cache ``c`` (B, Smax, ...) at
    ``cache_pos`` (an int, or a (B,) tensor for continuous batching, where
    each slot sits at its own depth), in place: the JAX package returns new
    arrays, the port saves the copy of the whole cache each layer and
    step."""
    S = u.shape[1]
    if not isinstance(cache_pos, torch.Tensor) or cache_pos.dim() == 0:
        p = int(cache_pos)
        c[:, p:p + S] = u
        return
    rows = torch.arange(c.shape[0], device=c.device)[:, None]
    cols = cache_pos.to(c.device).long()[:, None] + \
        torch.arange(S, device=c.device)[None, :]
    c[rows, cols] = u.to(c.dtype)


def _is_prefill(cache_pos) -> bool:
    """A scalar position 0: the engine's prefill, which starts its slot
    afresh (the rule of every layer kind: attention, SSM, RWKV6)."""
    return not isinstance(cache_pos, torch.Tensor) and int(cache_pos) == 0


def _decode_lens(B: int, cache_pos, device) -> torch.Tensor:
    """(B,) int32 keys a decode step reads: its position plus one (a
    scalar position is filled in on the card: no copy, no sync)."""
    if not isinstance(cache_pos, torch.Tensor):
        return torch.full((B,), int(cache_pos) + 1, dtype=torch.int32,
                          device=device)
    return (torch.zeros((B,), dtype=torch.int32, device=device)
            + cache_pos.to(device) + 1).to(torch.int32)


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
    if cfg.mla and not prefix and cross_states is None:
        raise ValueError(f"{cfg.name}: MLA self-attention is "
                         "mla_attention_block")
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
    prefill = _is_prefill(cache_pos)
    if not prefill and S != 1:
        raise NotImplementedError(
            f"{S} tokens against a cache at a nonzero position (chunked "
            f"prefill) is {_ROADMAP}")
    ck, cv = cache["k"], cache["v"]
    _write_rows(ck, k, cache_pos)
    _write_rows(cv, v, cache_pos)
    if prefill:
        # the prompt from position 0: causal over the keys just written,
        # which are k and v themselves (ck[:, :S], cv[:, :S])
        out = flash_attention(q, k, v, causal=True, window=int(window))
    else:
        out = decode_attention(q[:, 0], ck, cv,
                               _decode_lens(B, cache_pos, x.device),
                               window=int(window))[:, None]
    return _proj(out.reshape(B, S, H * hd), g("wo")), {"k": ck, "v": cv}


def mla_attention_block(blk, x, cfg, *, positions, cache=None,
                        cache_pos=None, absorb: bool = False) -> Tuple:
    """DeepSeek-V2's Multi-head Latent Attention, the reference's path
    without absorption.  x (B, S, d); cache None or {"lat": (B, Smax, lora
    + r)}, the compressed latent ``[c_kv, k_rope]`` of each position,
    written in place at ``cache_pos`` (an int, or a (B,) tensor of per-slot
    depths); returns (out, the cache or None).

    K and V are up-projected per head from the latent of every cached
    position (the whole ``Smax`` on a decode step, as the reference does);
    the key is ``[k_nope, k_rope]`` with the one rope key broadcast over the
    heads.  The kernels take q, k and v of one head dim, so V's ``hd``
    columns are padded with zeros to ``hd + r`` (through ``w_uv`` padded per
    head) and the output's first ``hd`` columns kept: the zero columns add
    nothing to the others.  The kernels' scale ``q.shape[-1] ** -0.5`` is
    the reference's ``(hd + r) ** -0.5``.

    ``absorb=True`` (the reference's absorbed decode: one latent kv head of
    ``lora + r`` columns, past the kernels' 256) is ROADMAP Queue 1 item 8
    and raises."""
    if absorb:
        raise NotImplementedError(f"absorbed MLA decode is {_ROADMAP}")
    B, S, _ = x.shape
    H, hd, r, lora = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim, \
        cfg.kv_lora_rank
    q = _proj(x, blk["wq"]).reshape(B, S, H, hd + r)
    q_rope = rope(q[..., hd:], positions, cfg.rope_theta)
    q_cat = torch.cat([q[..., :hd], q_rope], dim=-1)
    c = _proj(x, blk["w_dkv"])                            # (B, S, lora + r)
    c_kv = _rms(c[..., :lora], blk["kv_norm"], cfg.norm_eps)
    k_rope = rope(c[..., lora:][:, :, None, :], positions, cfg.rope_theta)
    lat = torch.cat([c_kv, k_rope[:, :, 0, :]], dim=-1)

    prefill = cache is None or _is_prefill(cache_pos)
    if not prefill and S != 1:
        raise NotImplementedError(
            f"{S} tokens against a cache at a nonzero position (chunked "
            f"prefill) is {_ROADMAP}")
    if cache is not None:
        _write_rows(cache["lat"], lat, cache_pos)
        if not prefill:
            lat = cache["lat"]      # every cached position, as the reference
    wuk = blk["w_uk"].to(x.dtype)
    wuv = F.pad(blk["w_uv"].to(x.dtype).reshape(lora, H, hd),
                (0, r)).reshape(lora, H * (hd + r))
    Sk = lat.shape[1]
    c_all = lat[..., :lora]
    k_nope = (c_all @ wuk).reshape(B, Sk, H, hd)
    k_cat = torch.cat([k_nope, lat[..., None, lora:].expand(B, Sk, H, r)],
                      dim=-1)
    v = (c_all @ wuv).reshape(B, Sk, H, hd + r)
    if prefill:
        # the prompt from position 0: causal over the keys just computed,
        # which are the cache's first S rows
        out = flash_attention(q_cat, k_cat, v, causal=True)
    else:
        out = decode_attention(q_cat[:, 0], k_cat, v,
                               _decode_lens(B, cache_pos, x.device))[:, None]
    out = out[..., :hd].reshape(B, S, H * hd)
    return _proj(out, blk["wo"]), cache

