"""Plain PyTorch version of the chunked linear-attention kernel: the
counterpart of the JAX package's ``kernels/rwkv6_scan.py::_kernel`` (the
Pallas kernel behind ``rwkv6_chunked``), step for step in fp32, and of the
SSD case of its ``models/linear_scan.py::chunked_linear_attention``.

Per (batch row, head), from the (K, V) state ``S_0`` (zeros, or
``initial_state``):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,  w_t = exp(clip(logw_t, -4, 0))
    RWKV6 (pre-update):  y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    SSD (post-update):   y_t = r_t . S_t

in chunks of ``L = min(chunk, S)`` steps, the chunk-factorized form: with
``cum`` the inclusive cumsum of the clipped log-decay over the chunk,
``cum_exc = cum - logw`` and ``tot = cum[-1]``, the query side's decay
``lq`` is ``cum_exc`` before the update and ``cum`` after it, and

    A    = (r e^{lq}) (k e^{-cum})^T, kept where j < i
    y    = A v + (r e^{lq}) S + (r . d . k) v
    S   <- e^{tot} S + (k e^{tot - cum})^T v

The diagonal's weight ``d`` is ``u`` before the update (the RWKV6 bonus;
zero without one) and ``1 + u`` after it: the step's own ``k v^T``, whose
decay ``e^{cum_i} e^{-cum_i}`` is exactly 1, taken without the rounding of
the two factors, plus any bonus.  The clip at ``LOG_DECAY_MIN`` keeps the
factorized exponentials inside fp32's range for chunks up to 20 steps.  A
length that is not a multiple of ``L`` is padded with identity rows (r = k
= v = 0, logw = 0: no output, no decay, nothing added to the state), as
``models/linear_scan.py`` of the JAX package pads; ``y`` is cut back, and
the final state is the unpadded recurrence's.

The CUDA kernel ``csrc/rwkv6_chunked.cu`` is held to this on the card
within 1e-4 (the JAX kernel test's tolerance).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LOG_DECAY_MIN = -4.0   # per-step clamp; chunk <= 20 keeps |exponent| < 88


def rwkv6_chunked_ref(r, k, v, logw, u=None, *, chunk: int = 16,
                      post_update: bool = False, initial_state=None):
    """r, k, logw (B, S, H, K); v (B, S, H, V); u (H, K) or None (no
    bonus), any float type.  ``post_update``: the SSD output y_t = r_t S_t;
    ``initial_state``: (B, H, K, V), or None for zeros.  Returns (y (B, S,
    H, V) fp32, final state (B, H, K, V) fp32)."""
    B, S, H, K = k.shape
    V = v.shape[-1]
    L = max(1, min(chunk, S))
    f32 = torch.float32
    r, k, v = (t.to(f32) for t in (r, k, v))
    d = u.to(f32) if u is not None else \
        torch.zeros((H, K), dtype=f32, device=r.device)
    if post_update:
        d = d + 1.0
    lw = logw.to(f32).clamp(LOG_DECAY_MIN, 0.0)
    pad = (-S) % L
    if pad:   # identity rows at the tail
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    N = (S + pad) // L

    def lay(t):   # (B, N*L, H, F) -> (B, H, N, L, F)
        return t.reshape(B, N, L, H, t.shape[-1]).permute(0, 3, 1, 2, 4)

    r, k, v, lw = lay(r), lay(k), lay(v), lay(lw)
    cum = torch.cumsum(lw, dim=3)                 # inclusive
    lq = cum if post_update else cum - lw         # the query side's decay
    tot = cum[:, :, :, -1:]                       # (B, H, N, 1, K)
    r_dec = r * torch.exp(lq)
    k_idec = k * torch.exp(-cum)
    k_dec = k * torch.exp(tot - cum)
    below = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    A = torch.where(below, r_dec @ k_idec.transpose(-1, -2), 0.0)
    y = A @ v + (r * d[None, :, None, None, :] * k).sum(-1, keepdim=True) * v
    upd = k_dec.transpose(-1, -2) @ v             # (B, H, N, K, V)
    decay = torch.exp(tot[:, :, :, 0])[..., None]  # (B, H, N, K, 1)
    state = torch.zeros((B, H, K, V), dtype=f32, device=r.device) \
        if initial_state is None else initial_state.to(f32)
    cross = []
    # the state carried across chunks (``unbind``: one stack in autograd's
    # backward where per-chunk indexing would add a zero-filled whole a
    # chunk)
    for r_n, decay_n, upd_n in zip(r_dec.unbind(2), decay.unbind(2),
                                   upd.unbind(2)):
        cross.append(r_n @ state)
        state = decay_n * state + upd_n
    if N:
        y = y + torch.stack(cross, dim=2)
    y = y.permute(0, 2, 3, 1, 4).reshape(B, N * L, H, V)[:, :S]
    return y.contiguous(), state
