"""Attention of the decoders: the port's ``repro.models.attention``
(``rope``, ``_proj``, ``_rms``, the cache update, ``quant_kv`` for the int8
cache (from ``kernels.attention``), ``attention_block`` for GQA, and
``mla_attention_block``,
DeepSeek-V2's latent attention, with and without absorption).

Every attention call goes through a hand-written kernel (``kernels.ops``):

- no cache (a training-style forward), or the engine's prefill
  (``cache_pos == 0`` into a bf16 / fp32 cache, the prompt's keys written
  from position 0): causal attention of the ``S`` new positions over
  themselves, which is ``flash_attention(q, k, v, causal=True,
  window=window)``;
- one new token against the cache (``S == 1`` at a nonzero
  ``cache_pos``, a scalar or a (B,) vector of per-slot depths): ``kv_len =
  cache_pos + 1`` and no causal mask is needed, which is
  ``decode_attention(q[:, 0], ck, cv, kv_len, window=window)``: the
  layer's window keeps the keys at positions ``>= kv_len - window``, the
  reference's ``q_pos - k_pos < window``;
- every other call with a cache: ``S > 1`` tokens at a nonzero position
  (a chunked prefill, at a scalar or a per-slot ``cache_pos``), and any
  prefill into an int8 cache (the reference attends over the dequantized
  cache rows, not over the fresh k and v): the new rows are written at
  ``cache_pos``, then ``flash_attention(q, ck, cv, q_offset=cache_pos,
  kv_len=cache_pos + S, window=window)``, query ``i`` at ``cache_pos + i``
  over the cache's keys, causal;
- cross-attention onto ``cross_states`` (whisper's decoder onto the
  encoder's output, and its encoder's bidirectional self-attention, which
  the reference writes as cross-attention onto the layer's own normed
  input): no rope, no mask, every query against all ``Se`` states.  ``S >
  1`` queries are ``flash_attention(q, k, v, causal=False)``; one query (a
  decode step) is ``decode_attention`` with ``kv_len = Se``, whose splits
  spread the ``Se`` keys over the card where a flash call with one query
  row would run ``H`` CTAs.

An int8 cache (``cfg.kv_cache_int8``: ``k_q`` / ``v_q`` int8 with fp32
scales ``k_s`` / ``v_s`` a (position, kv head)) is written through
``quant_kv`` and read by the kernels as int8, each element dequantized in
the kernel as the reference's ``dequant_kv`` rounds it.  The blocks apply
no ``cfg.logit_softcap``, as the reference's pass none to its
``gqa_attention``; the flash and decode kernels take the cap as an
argument (``softcap``), as ``gqa_attention`` does.

MLA without absorption takes the first three cases with q and k of ``hd +
r`` columns (the head's ``hd`` and the shared rope key's ``r``) and V
zero-padded from ``hd`` to the same width; with absorption
(``Runtime(mla_absorb=True)``) every mode is ``latent_attention`` over the
latent rows (see ``mla_attention_block``).

These are the cases ``serving.engine``, the encoder-decoder form and the
reference's ``forward`` form, and the functions the JAX package's XLA path
(``gqa_attention``) computes there.

The reference's dtype sequence is kept: projections in the activations'
type, ``rope`` and ``_rms`` in fp32 and cast back.

Under a model axis (``sharding.TensorParallel``) each block computes its
rank's heads and the kernels take the local shapes, nothing else changed.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels.attention import quant_kv
from ..kernels.ops import decode_attention, flash_attention, latent_attention
from .sharding import LOCAL, TensorParallel


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


def _cache_lens(B: int, S: int, cache_pos, device) -> torch.Tensor:
    """(B,) int32 keys a call of ``S`` new tokens at ``cache_pos`` reads:
    its position plus ``S`` (a scalar position is filled in on the card:
    no copy, no sync)."""
    if not isinstance(cache_pos, torch.Tensor):
        return torch.full((B,), int(cache_pos) + S, dtype=torch.int32,
                          device=device)
    return (torch.zeros((B,), dtype=torch.int32, device=device)
            + cache_pos.to(device) + S).to(torch.int32)


def _cross_attention(q, k, v):
    """Every query against every key, no mask: q (B, S, H, hd), k / v (B,
    Se, KV, hd)."""
    B, S = q.shape[:2]
    if S == 1:
        kv_len = torch.full((B,), k.shape[1], dtype=torch.int32,
                            device=q.device)
        return decode_attention(q[:, 0], k, v, kv_len)[:, None]
    return flash_attention(q, k, v, causal=False)


def kv_heads_for(H: int, KV: int, H_loc: int, r: int) -> list:
    """The kv heads model rank ``r``'s query heads ``[r * H_loc, (r + 1) *
    H_loc)`` read, in the order a GQA call over them takes: each once where
    the local query heads fall into groups of one size (``H_loc`` a multiple
    of the group ``H // KV``, or within one group), else one for each local
    query head (a group of 1).  The kv weights stay whole in this case (the
    kv heads do not divide the model axis); a rank's cache holds these."""
    G = H // KV
    need = [h // G for h in range(r * H_loc, (r + 1) * H_loc)]
    if H_loc % G == 0 or G % H_loc == 0:
        return sorted(set(need))
    return need


def _head_cols(w: torch.Tensor, heads, hd: int) -> torch.Tensor:
    """The columns of heads ``heads`` (of ``hd`` each) of ``w``'s last
    dim, in that order."""
    idx = (torch.as_tensor(heads, device=w.device)[:, None] * hd +
           torch.arange(hd, device=w.device)[None, :]).reshape(-1)
    return w.index_select(-1, idx)


def attention_block(blk, x, cfg, *, positions, window: int, cache=None,
                    cache_pos=None, cross_states=None, prefix: str = "",
                    tp: TensorParallel = LOCAL) -> Tuple:
    """Standard GQA attention of one layer, or cross-attention onto
    ``cross_states`` (B, Se, d).  x (B, S, d); cache None, a dict {"k",
    "v"} of (B, Smax, KV, hd), or an int8 one {"k_q", "v_q", "k_s", "v_s"}
    (the scales (B, Smax, KV, 1)), written in place at ``cache_pos`` (an
    int, or a (B,) tensor of per-slot depths); returns (out, the cache or
    None).  ``window`` is the layer's window (0: full attention);
    ``prefix`` picks the block's weights (``"x_"``: the decoder's cross
    projections).  As in the reference, the query bias applies only without
    a prefix and the cross keys and values take none.

    Under a model axis (``tp``) the block runs on the query heads of its
    weights' shard (``wq``'s columns, ``H / model`` heads) and on the kv
    heads they read: the shard of ``wk`` / ``wv`` where the kv heads divide
    the model axis, else those ``kv_heads_for`` picks from the whole
    weights; the cache holds those kv heads.  ``wo`` is row-parallel, its
    partial products all-reduced.  Cross-attention (whisper's encoder and
    its decoder's cross block) splits the same way, every rank projecting
    the whole ``cross_states`` onto its kv heads.  A shard of ``wq`` that
    does not hold whole heads reaches the block gathered, and every rank
    computes all heads."""
    if cfg.mla and not prefix and cross_states is None:
        raise ValueError(f"{cfg.name}: MLA self-attention is "
                         "mla_attention_block")
    B, S, _ = x.shape
    H, KVh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bias = cfg.qkv_bias

    def g(name):
        return blk[prefix + name]

    H = g("wq").shape[-1] // hd              # this rank's query heads
    split = H < cfg.n_heads
    xq = tp.enter(x) if split else x
    q = _proj(xq, g("wq"), g("bq") if bias and not prefix else None
              ).reshape(B, S, H, hd)
    wk, wv = g("wk"), g("wv")
    bk, bv = (g("bk"), g("bv")) if bias and cross_states is None \
        else (None, None)
    if split and wk.shape[-1] == KVh * hd:
        # whole kv weights: the kv heads this rank's query heads read
        heads = kv_heads_for(cfg.n_heads, KVh, H, tp.r)
        wk, wv = (_head_cols(tp.enter(w), heads, hd) for w in (wk, wv))
        if bk is not None:
            bk, bv = (_head_cols(tp.enter(b), heads, hd) for b in (bk, bv))
    KVh = wk.shape[-1] // hd

    def out_proj(o):
        y = _proj(o.reshape(B, S, H * hd), g("wo"))
        return tp.reduce(y) if split else y

    if cross_states is not None:
        # every rank reads the whole states for its own heads
        e = cross_states.to(x.dtype)
        e = tp.enter(e) if split else e
        Se = e.shape[1]
        k = _proj(e, wk).reshape(B, Se, KVh, hd)
        v = _proj(e, wv).reshape(B, Se, KVh, hd)
        return out_proj(_cross_attention(q, k, v)), None
    k = _proj(xq, wk, bk).reshape(B, S, KVh, hd)
    v = _proj(xq, wv, bv).reshape(B, S, KVh, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = int(window)

    if cache is None:
        return out_proj(flash_attention(q, k, v, causal=True,
                                        window=window)), None
    if "k_q" in cache:
        ck, cv = cache["k_q"], cache["v_q"]
        (kq, ks), (vq, vs) = quant_kv(k), quant_kv(v)
        for name, u in (("k_q", kq), ("k_s", ks), ("v_q", vq), ("v_s", vs)):
            _write_rows(cache[name], u, cache_pos)
        kv = dict(k_scale=cache["k_s"], v_scale=cache["v_s"])
    else:
        ck, cv = cache["k"], cache["v"]
        _write_rows(ck, k, cache_pos)
        _write_rows(cv, v, cache_pos)
        kv = {}
    if _is_prefill(cache_pos) and not kv:
        # the prompt from position 0: causal over the keys just written,
        # which are k and v themselves (ck[:, :S], cv[:, :S])
        out = flash_attention(q, k, v, causal=True, window=window)
    elif S == 1 and not _is_prefill(cache_pos):
        out = decode_attention(q[:, 0], ck, cv,
                               _cache_lens(B, 1, cache_pos, x.device),
                               window=window, **kv)[:, None]
    else:
        out = flash_attention(q, ck, cv, causal=True, window=window,
                              q_offset=cache_pos,
                              kv_len=_cache_lens(B, S, cache_pos, x.device),
                              **kv)
    return out_proj(out), cache


def mla_attention_block(blk, x, cfg, *, positions, cache=None,
                        cache_pos=None, absorb: bool = False,
                        tp: TensorParallel = LOCAL) -> Tuple:
    """DeepSeek-V2's Multi-head Latent Attention.  x (B, S, d); cache None
    or {"lat": (B, Smax, lora + r)}, the compressed latent ``[c_kv,
    k_rope]`` of each position, written in place at ``cache_pos`` (an int,
    or a (B,) tensor of per-slot depths); returns (out, the cache or
    None).

    Without absorption (the reference's default) K and V are up-projected
    per head from the latent of every position the call reads (the whole
    ``Smax`` with a cache past a prefill, as the reference does); the key
    is ``[k_nope, k_rope]`` with the one rope key broadcast over the heads.
    The kernels take q, k and v of one head dim, so V's ``hd`` columns are
    padded with zeros to ``hd + r`` (through ``w_uv`` padded per head) and
    the output's first ``hd`` columns kept: the zero columns add nothing to
    the others.  The kernels' scale ``q.shape[-1] ** -0.5`` is the
    reference's ``(hd + r) ** -0.5``.

    With ``absorb=True`` (``Runtime(mla_absorb=True)``, every mode) the
    queries are absorbed through ``W_UK``: ``[q_nope W_UK^T, q_rope]`` of
    ``lora + r`` columns attends over the latent rows themselves, one kv
    head shared by all ``H`` heads, V the latent's first ``lora`` columns
    (``latent_attention``, scale ``(hd + r) ** -0.5``), and ``W_UV`` is
    applied to the attended latent: no per-position up-projection.

    Under a model axis (``tp``) the per-head projections (``wq``, ``w_uk``,
    ``w_uv``) are the shard of this rank's heads and ``wo`` is
    row-parallel, its partial products all-reduced; ``w_dkv`` and the
    latent (and its cache) stay whole on every rank, absorbed or not."""
    B, S, _ = x.shape
    H, hd, r, lora = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim, \
        cfg.kv_lora_rank
    H = blk["w_uk"].shape[-1] // hd           # this rank's heads
    split = H < cfg.n_heads
    q = _proj(tp.enter(x) if split else x, blk["wq"]).reshape(B, S, H,
                                                              hd + r)
    q_nope = q[..., :hd]
    q_rope = rope(q[..., hd:], positions, cfg.rope_theta)
    c = _proj(x, blk["w_dkv"])                            # (B, S, lora + r)
    c_kv = _rms(c[..., :lora], blk["kv_norm"], cfg.norm_eps)
    k_rope = rope(c[..., lora:][:, :, None, :], positions, cfg.rope_theta)
    lat = torch.cat([c_kv, k_rope[:, :, 0, :]], dim=-1)

    # a prefill from 0 reads the latents just computed (the cache's first S
    # rows); any other call with a cache reads the cache, bounded
    prefill = cache is None or _is_prefill(cache_pos)
    if cache is not None:
        _write_rows(cache["lat"], lat, cache_pos)
        if not prefill:
            lat = cache["lat"]      # every cached position, as the reference
    if split:
        lat = tp.enter(lat)
    at = {} if prefill else dict(
        q_offset=cache_pos, kv_len=_cache_lens(B, S, cache_pos, x.device))
    if absorb:
        wuk = blk["w_uk"].to(x.dtype).reshape(lora, H, hd)
        wuv = blk["w_uv"].to(x.dtype).reshape(lora, H, hd)
        q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope, wuk)
        q_cat = torch.cat([q_lat, q_rope], dim=-1)        # (B, S, H, lora + r)
        ctx = latent_attention(q_cat, lat, at.get("kv_len"),
                               q_offset=at.get("q_offset"), hd_v=lora,
                               scale=(hd + r) ** -0.5)
        out = torch.einsum("bqhl,lhd->bqhd", ctx, wuv).reshape(B, S, H * hd)
        y = _proj(out, blk["wo"])
        return (tp.reduce(y) if split else y), cache
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    wuk = blk["w_uk"].to(x.dtype)
    wuv = F.pad(blk["w_uv"].to(x.dtype).reshape(lora, H, hd),
                (0, r)).reshape(lora, H * (hd + r))
    Sk = lat.shape[1]
    c_all = lat[..., :lora]
    k_nope = (c_all @ wuk).reshape(B, Sk, H, hd)
    k_cat = torch.cat([k_nope, lat[..., None, lora:].expand(B, Sk, H, r)],
                      dim=-1)
    v = (c_all @ wuv).reshape(B, Sk, H, hd + r)
    if S == 1 and not prefill:
        out = decode_attention(q_cat[:, 0], k_cat, v, at["kv_len"])[:, None]
    else:
        out = flash_attention(q_cat, k_cat, v, causal=True, **at)
    out = out[..., :hd].reshape(B, S, H * hd)
    y = _proj(out, blk["wo"])
    return (tp.reduce(y) if split else y), cache
