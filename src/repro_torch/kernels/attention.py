"""Plain PyTorch versions of the attention kernels: the counterparts of
the JAX package's ``kernels/ref.py::flash_attention_ref`` and
``decode_attention_ref``, with the semantics of its Pallas kernels where
the two differ, widened to the cases its XLA path (``models/attention.py::
gqa_attention``) computes around them: queries at an offset over a cache
bounded by ``kv_len`` (a chunked prefill), the logit softcap, an int8
cache, and the absorbed MLA's latent attention (``latent_attention_ref``).

All take the JAX package's layout and compute in fp32 for fp32 and bf16
inputs alike: scores ``(q . k) * scale``, then (flash and decode) with
``softcap > 0`` ``tanh(s * (1 / softcap)) * softcap`` (the reference's ``s
/ softcap`` as its jitted code computes it), masked positions at ``NEG_INF``, softmax
statistics and the ``p . v`` product in fp32, the result cast to q's type.
A masked position contributes ``p = 0`` and its V row is never used (the
Pallas kernels zero such rows: ``0 * garbage`` may be NaN), and a row with
no valid key gives zeros.  That is the Pallas decode kernel's answer at
``kv_len = 0``, where ``decode_attention_ref`` returns the mean of V.

An int8 cache is ``k_q`` / ``v_q`` int8 with fp32 scales ``k_s`` / ``v_s``
of shape (B, S, KV, 1); each element reads as ``(q.float() * s).to(dtype)``
in the activations' type (``dequant_kv``, the reference's rounding) before
it enters a product.

The CUDA kernels (``csrc/flash_attention.cu``, ``flash_attention_sm90.cu``,
``decode_attention.cu``, ``latent_attention.cu``) are held to these on the
card within the JAX tests' tolerances.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def inv_f32(c: float) -> float:
    """1 / c rounded to fp32: a division by a constant ``x / c`` is ``x *
    inv_f32(c)`` in the reference's jitted code (XLA's rewrite), an ulp
    apart from the division at some ``x``."""
    return float(torch.tensor(1.0) / torch.tensor(float(c)))


_INV_127 = inv_f32(127)


def quant_kv(x: torch.Tensor, row_max=None):
    """Per-row (last-axis) absmax int8 quantization (the reference's
    ``quant_kv``, and its optimizer's ``_quant``): ``torch.round`` rounds
    half to even, as ``jnp.round`` does, and ``absmax / 127`` is taken as
    the reference's jitted code computes it (``absmax * inv_f32(127)``).
    ``row_max``, where given, maps the rows' absmax to the one the scale
    takes (the optimizer's max across the shards of a row).  Returns (int8
    values, fp32 scales of one a row)."""
    x32 = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    if row_max is not None:
        absmax = row_max(absmax)
    scale = torch.where(absmax > 0, absmax * _INV_127, 1.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequant_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """An int8 cache's values in ``dtype``: ``(q * scale)`` in fp32, then
    rounded (the reference's ``dequant_kv``)."""
    return (q.to(torch.float32) * scale).to(dtype)


def softcapped(s: torch.Tensor, softcap: float) -> torch.Tensor:
    """The reference's ``tanh(s / softcap) * softcap`` (none at 0)."""
    if softcap <= 0:
        return s
    return torch.tanh(s * inv_f32(softcap)) * softcap


def heads(t: torch.Tensor, KV: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, KV, G, S, hd) in fp32: query head h is row
    ``h % G`` of kv head ``h // G``."""
    B, S, H, hd = t.shape
    return t.to(torch.float32).reshape(B, S, KV, H // KV, hd).permute(
        0, 2, 3, 1, 4)


def flash_mask(B: int, Sq: int, Skv: int, *, causal: bool, window: int,
               q_offset=None, kv_len=None, device=None):
    """(B, 1, 1, Sq, Skv) bool: the keys each query sees.  Query ``i`` of
    row ``b`` sits at ``qpos = q_offset[b] + i`` (``q_offset`` None: 0; an
    int; or a (B,) tensor) and key ``j`` at ``j``: causal keeps ``j <=
    qpos``, ``window > 0`` keeps ``qpos - j < window``, ``kv_len`` (an int
    or (B,), None: ``Skv``) keeps ``j < kv_len[b]`` (the reference's
    ``_mask``)."""
    qpos = torch.arange(Sq, device=device)[None, :, None] + \
        torch.zeros((B, 1, 1), dtype=torch.long, device=device)
    if isinstance(q_offset, torch.Tensor):
        qpos = qpos + q_offset.to(device).long().reshape(-1, 1, 1)
    elif q_offset is not None:
        qpos = qpos + int(q_offset)
    kpos = torch.arange(Skv, device=device)[None, None, :]
    valid = torch.ones((B, Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        valid &= kpos <= qpos
    if window > 0:
        valid &= qpos - kpos < window
    if kv_len is not None:
        n = kv_len.to(device).long().reshape(-1, 1, 1) \
            if isinstance(kv_len, torch.Tensor) else int(kv_len)
        valid &= kpos < n
    return valid[:, None, None]


def flash_probs(qg, kt, *, causal: bool, window: int, scale: float,
                q_offset=None, kv_len=None, softcap: float = 0.0):
    """The softmax of ``flash_attention_ref`` before its division: qg (B,
    KV, G, Sq, hd) and kt (B, KV, 1, Skv, hd) in fp32 -> (p, its row sums
    clamped from 0), p zero where the mask (``flash_mask``) drops a key."""
    B, Sq, Skv = qg.shape[0], qg.shape[-2], kt.shape[-2]
    s = softcapped((qg @ kt.transpose(-1, -2)) * scale, softcap)
    valid = flash_mask(B, Sq, Skv, causal=causal, window=window,
                       q_offset=q_offset, kv_len=kv_len, device=qg.device)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    return p, torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)


def _kv_values(k, v, k_scale, v_scale, dtype):
    """k and v as the products read them: an int8 cache dequantized to
    ``dtype`` (``dequant_kv``), any other as it is."""
    if k_scale is None:
        return k, v
    return dequant_kv(k, k_scale, dtype), dequant_kv(v, v_scale, dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale=None, q_offset=None, kv_len=None,
                        softcap: float = 0.0, k_scale=None, v_scale=None):
    """q (B, Sq, H, hd); k (B, Skv, KV, hd), v (B, Skv, KV, hd_v) -> (B,
    Sq, H, hd_v) in q's type.  Query head h reads kv head ``h // (H //
    KV)``; query ``i`` of row ``b`` sits at ``q_offset[b] + i`` (0 + i
    without an offset: the causal mask top-left aligned) and key ``j`` at
    ``j``; causal masks ``kpos > qpos``, ``window > 0`` masks ``qpos - kpos
    >= window``, ``kv_len`` masks ``kpos >= kv_len[b]`` (see
    ``flash_mask``).  With ``k_scale`` / ``v_scale``, k and v are an int8
    cache (``dequant_kv`` to q's type)."""
    B, Sq, H, hd = q.shape
    KV, hd_v = k.shape[2], v.shape[3]
    scale = hd ** -0.5 if scale is None else scale
    k, v = _kv_values(k, v, k_scale, v_scale, q.dtype)
    f32 = torch.float32
    kt = k.to(f32).permute(0, 2, 1, 3)[:, :, None]      # (B, KV, 1, Skv, hd)
    vt = v.to(f32).permute(0, 2, 1, 3)[:, :, None]
    p, denom = flash_probs(heads(q, KV), kt, causal=causal, window=window,
                           scale=scale, q_offset=q_offset, kv_len=kv_len,
                           softcap=softcap)
    # a key no query reads (a cache row past kv_len) is never used
    read = (p.amax(dim=(2, 3), keepdim=True) > 0).transpose(-1, -2)
    o = (p @ torch.where(read, vt, 0.0)) / denom
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd_v).to(q.dtype)


def decode_attention_ref(q, k, v, kv_len, *, window: int = 0, scale=None,
                         softcap: float = 0.0, k_scale=None, v_scale=None):
    """q (B, H, hd), one token per row; k, v (B, S, KV, hd); kv_len (B,)
    int -> (B, H, hd) in q's type.  Positions ``>= min(kv_len[b], S)`` are
    masked, and with ``window > 0`` those ``< kv_len[b] - window`` too (the
    query sits at position ``kv_len[b] - 1``: the reference's ``q_pos -
    k_pos < window``); a row with no valid position gives zeros.  With
    ``k_scale`` / ``v_scale`` (B, S, KV, 1) fp32, k and v are an int8 cache
    (``dequant_kv`` to q's type)."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5 if scale is None else scale
    k, v = _kv_values(k, v, k_scale, v_scale, q.dtype)
    f32 = torch.float32
    qg = q.to(f32).reshape(B, KV, G, hd)
    kt = k.to(f32).permute(0, 2, 1, 3)                  # (B, KV, S, hd)
    vt = v.to(f32).permute(0, 2, 1, 3)
    s = softcapped((qg @ kt.transpose(-1, -2)) * scale, softcap)
    pos = torch.arange(S, device=q.device)[None, :]
    n = kv_len.to(q.device).long()[:, None]
    valid = pos < n
    if window > 0:
        valid &= pos >= n - window
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    o = (p @ torch.where(valid.transpose(-1, -2), vt, 0.0)) / \
        torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    return o.reshape(B, H, hd).to(q.dtype)


def latent_attention_ref(q, lat, kv_len=None, *, q_offset=None, hd_v: int,
                         scale: float):
    """The absorbed MLA's attention: q (B, Sq, H, D) (the queries absorbed
    through ``W_UK``, then their rope part), lat (B, Sk, D) (one latent row
    a position, shared by every head: K is the whole row, V its first
    ``hd_v`` columns) -> (B, Sq, H, hd_v) in q's type.  Causal at the
    offset: query ``i`` of row ``b`` sees keys ``j <= q_offset[b] + i`` and
    ``j < kv_len[b]`` (None: ``Sk``); ``scale`` is the caller's (the
    reference's ``(hd + r) ** -0.5``, not ``D ** -0.5``)."""
    kv = lat[:, :, None, :]
    return flash_attention_ref(q, kv, kv[..., :hd_v], causal=True,
                               scale=scale, q_offset=q_offset,
                               kv_len=kv_len)
