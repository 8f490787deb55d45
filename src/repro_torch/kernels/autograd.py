"""Gradients through the hand-written kernels: ``FlashAttention`` over
``ops.flash_launch``, ``LatentAttention`` over ``ops.latent_launch`` and
``ChunkedScan`` over ``ops.rwkv6_launch``.

A launch fills a fresh tensor, which autograd cannot see: without these
Functions a training forward on the card would give q, k, v (and r, k, v,
logw, u) no gradient, silently.  The wrappers ``ops.flash_attention`` and
``ops.latent_attention`` and ``ops.rwkv6_chunked`` route a call here when
grad mode is on and an input requires grad; the forward is always the kernel (counted in
``ops.launches`` as any launch).

The JAX package has no backward for its Pallas kernels (it trains by
differentiating its XLA code), so there is no TPU backward kernel to port:
the backward is torch ops, recomputed from the saved inputs, and these are
the only torch-ops attention and scan that run on the card.

- Attention: P recomputed in fp32 from q and k (the kernel's scale
  ``hd ** -0.5``, causal mask, window and softcap), then ``dV = P^T dO``,
  ``dS = P * (dO V^T - rowsum(dO * O))``, with a softcap ``c`` times ``1 -
  tanh^2(s / c)`` (the derivative of ``tanh(s / c) * c``), ``dQ = scale dS
  K`` and ``dK = scale dS^T Q``, ``dK`` and ``dV`` summed over the G query
  heads of each kv head.
- The absorbed MLA's latent attention (the reference's ``Runtime(
  mla_absorb=True)`` in training): autograd over ``latent_attention_ref``
  recomputed from the saved inputs; the latent's gradient gathers its K
  and V parts.
- The chunked scan: autograd over ``rwkv6_chunked_ref`` recomputed from the
  saved inputs, the plain version's fp32 op order; its clamp at
  ``LOG_DECAY_MIN`` passes no gradient outside its range.
"""
from __future__ import annotations

import torch

from . import ops
from .attention import (NEG_INF, flash_mask, heads, inv_f32,
                        latent_attention_ref)
from .rwkv6 import rwkv6_chunked_ref


def flash_attention_bwd(q, k, v, o, do, *, causal: bool, window: int,
                        softcap: float = 0.0):
    """(dq, dk, dv) of ``flash_attention_ref(q, k, v)`` at output ``o`` and
    its gradient ``do``, in fp32 (q (B, Sq, H, hd), k / v (B, Skv, KV,
    hd)); P is the plain version's (its scores, softcap and mask)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    f32 = torch.float32
    qg, og, dog = heads(q, KV), heads(o, KV), heads(do, KV)
    kt = k.to(f32).permute(0, 2, 1, 3)[:, :, None]      # (B, KV, 1, Skv, hd)
    vt = v.to(f32).permute(0, 2, 1, 3)[:, :, None]
    s = (qg @ kt.transpose(-1, -2)) * scale
    if softcap > 0:
        t = torch.tanh(s * inv_f32(softcap))
        s = t * softcap
    valid = flash_mask(B, Sq, Skv, causal=causal, window=window,
                       device=q.device)
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    p = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    del s
    dv = (p.transpose(-1, -2) @ dog).sum(2)             # (B, KV, Skv, hd)
    dp = dog @ vt.transpose(-1, -2)
    ds = p * (dp - (dog * og).sum(-1, keepdim=True))
    del p, dp
    if softcap > 0:
        ds = ds * (1.0 - t * t)
        del t
    dq = (ds @ kt) * scale                              # (B, KV, G, Sq, hd)
    dk = (ds.transpose(-1, -2) @ qg).sum(2) * scale     # (B, KV, Skv, hd)
    return (dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd),
            dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3))


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the kernel forward, the
    recomputed torch-ops backward (``flash_attention_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap=0.0):
        o = ops.flash_launch(q, k, v, causal=causal, window=window,
                             softcap=softcap)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.window, ctx.softcap = causal, window, softcap
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, causal=ctx.causal,
                                         window=ctx.window,
                                         softcap=ctx.softcap)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


class LatentAttention(torch.autograd.Function):
    """``latent_attention`` with a gradient: the kernel forward; the
    backward recomputes ``latent_attention_ref`` from the saved inputs and
    runs autograd through it."""

    @staticmethod
    def forward(ctx, q, lat, hd_v, scale):
        ctx.save_for_backward(q, lat)
        ctx.hd_v, ctx.scale = hd_v, scale
        return ops.latent_launch(q, lat, hd_v=hd_v, scale=scale)

    @staticmethod
    def backward(ctx, do):
        q, lat = ctx.saved_tensors
        with torch.enable_grad():
            qi = q.detach().requires_grad_()
            li = lat.detach().requires_grad_()
            o = latent_attention_ref(qi, li, hd_v=ctx.hd_v, scale=ctx.scale)
            dq, dlat = torch.autograd.grad(o, (qi, li), do)
        return dq, dlat, None, None


class ChunkedScan(torch.autograd.Function):
    """``rwkv6_chunked`` with a gradient: the kernel forward; the backward
    recomputes ``rwkv6_chunked_ref`` from the saved inputs and runs
    autograd through it.  A gradient of None (the final state, which
    training never reads) adds nothing."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, initial_state, chunk, post_update):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, logw, u, initial_state)
        ctx.chunk, ctx.post_update = chunk, post_update
        return ops.rwkv6_launch(r, k, v, logw, u, chunk=chunk,
                                post_update=post_update,
                                initial_state=initial_state)

    @staticmethod
    def backward(ctx, gy, gstate):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:6]
        outs_grads = [(i, g) for i, g in enumerate((gy, gstate))
                      if g is not None]
        if not outs_grads or not any(need):
            return (None,) * 8
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(saved, need)]
            r, k, v, logw, u, s0 = ins
            outs = rwkv6_chunked_ref(r, k, v, logw, u, chunk=ctx.chunk,
                                     post_update=ctx.post_update,
                                     initial_state=s0)
            wrt = [t for t, n in zip(ins, need) if n]
            grads = torch.autograd.grad([outs[i] for i, _ in outs_grads],
                                        wrt, [g for _, g in outs_grads],
                                        allow_unused=True)
        it = iter(grads)
        return tuple(next(it) if n else None for n in need) + (None, None)
