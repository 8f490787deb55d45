"""Plain PyTorch versions of the two attention kernels: the counterparts of
the JAX package's ``kernels/ref.py::flash_attention_ref`` and
``decode_attention_ref``, with the semantics of its Pallas kernels where
the two differ.

Both take the JAX package's layout and compute in fp32 for fp32 and bf16
inputs alike: scores ``(q . k) * scale``, masked positions at ``NEG_INF``,
softmax statistics and the ``p . v`` product in fp32, the result cast to
q's type.  A masked position contributes ``p = 0`` and its V row is never
used (the Pallas kernels zero such rows: ``0 * garbage`` may be NaN), and
a row with no valid key gives zeros.  That is the Pallas decode kernel's
answer at ``kv_len = 0``, where ``decode_attention_ref`` returns the mean
of V.

The CUDA kernels (``csrc/flash_attention.cu``, ``csrc/decode_attention.cu``)
are held to these on the card within the JAX tests' tolerances.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def heads(t: torch.Tensor, KV: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, KV, G, S, hd) in fp32: query head h is row
    ``h % G`` of kv head ``h // G``."""
    B, S, H, hd = t.shape
    return t.to(torch.float32).reshape(B, S, KV, H // KV, hd).permute(
        0, 2, 3, 1, 4)


def flash_probs(qg, kt, *, causal: bool, window: int, scale: float):
    """The softmax of ``flash_attention_ref`` before its division: qg (B,
    KV, G, Sq, hd) and kt (B, KV, 1, Skv, hd) in fp32 -> (p, its row sums
    clamped from 0), p zero where the mask drops a key."""
    Sq, Skv = qg.shape[-2], kt.shape[-2]
    s = (qg @ kt.transpose(-1, -2)) * scale             # (B, KV, G, Sq, Skv)
    qpos = torch.arange(Sq, device=qg.device)[:, None]
    kpos = torch.arange(Skv, device=qg.device)[None, :]
    valid = torch.ones((Sq, Skv), dtype=torch.bool, device=qg.device)
    if causal:
        valid &= kpos <= qpos
    if window > 0:
        valid &= qpos - kpos < window
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    return p, torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale=None):
    """q (B, Sq, H, hd); k, v (B, Skv, KV, hd) -> (B, Sq, H, hd) in q's
    type.  Query head h reads kv head ``h // (H // KV)``; the causal mask is
    top-left aligned (``kpos <= qpos``, both from 0); ``window > 0`` masks
    ``qpos - kpos >= window``."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    f32 = torch.float32
    kt = k.to(f32).permute(0, 2, 1, 3)[:, :, None]      # (B, KV, 1, Skv, hd)
    vt = v.to(f32).permute(0, 2, 1, 3)[:, :, None]
    p, denom = flash_probs(heads(q, KV), kt, causal=causal, window=window,
                           scale=scale)
    o = (p @ vt) / denom
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention_ref(q, k, v, kv_len, *, window: int = 0, scale=None):
    """q (B, H, hd), one token per row; k, v (B, S, KV, hd); kv_len (B,)
    int -> (B, H, hd) in q's type.  Positions ``>= min(kv_len[b], S)`` are
    masked, and with ``window > 0`` those ``< kv_len[b] - window`` too (the
    query sits at position ``kv_len[b] - 1``: the reference's ``q_pos -
    k_pos < window``); a row with no valid position gives zeros."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5 if scale is None else scale
    f32 = torch.float32
    qg = q.to(f32).reshape(B, KV, G, hd)
    kt = k.to(f32).permute(0, 2, 1, 3)                  # (B, KV, S, hd)
    vt = v.to(f32).permute(0, 2, 1, 3)
    s = (qg @ kt.transpose(-1, -2)) * scale             # (B, KV, G, S)
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
