"""Plain PyTorch version of the RWKV6 chunked linear-attention kernel: the
counterpart of the JAX package's ``kernels/rwkv6_scan.py::_kernel`` (the
Pallas kernel behind ``rwkv6_chunked``), step for step in fp32.

Per (batch row, head), from a zero (K, V) state ``S``:

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,  w_t = exp(clip(logw_t, -4, 0))

in chunks of ``L = min(chunk, S)`` steps, the chunk-factorized form: with
``cum`` the inclusive cumsum of the clipped log-decay over the chunk,
``cum_exc = cum - logw`` and ``tot = cum[-1]``,

    A    = (r e^{cum_exc}) (k e^{-cum})^T, kept where j < i
    y    = A v + (r e^{cum_exc}) S + (r . u . k) v
    S   <- e^{tot} S + (k e^{tot - cum})^T v

The clip at ``LOG_DECAY_MIN`` keeps the factorized exponentials inside
fp32's range for chunks up to 20 steps.  A length that is not a multiple of
``L`` is padded with identity rows (r = k = v = 0, logw = 0: no output, no
decay, nothing added to the state), as ``models/linear_scan.py`` of the
JAX package pads; ``y`` is cut back, and the final state is the unpadded
recurrence's.

The CUDA kernel ``csrc/rwkv6_chunked.cu`` is held to this on the card
within 1e-4 (the JAX kernel test's tolerance).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LOG_DECAY_MIN = -4.0   # per-step clamp; chunk <= 20 keeps |exponent| < 88


def rwkv6_chunked_ref(r, k, v, logw, u, *, chunk: int = 16):
    """r, k, logw (B, S, H, K); v (B, S, H, V); u (H, K), any float type.
    Returns (y (B, S, H, V) fp32, final state (B, H, K, V) fp32)."""
    B, S, H, K = k.shape
    V = v.shape[-1]
    L = max(1, min(chunk, S))
    f32 = torch.float32
    r, k, v, u = (t.to(f32) for t in (r, k, v, u))
    lw = logw.to(f32).clamp(LOG_DECAY_MIN, 0.0)
    pad = (-S) % L
    if pad:   # identity rows at the tail
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    N = (S + pad) // L

    def lay(t):   # (B, N*L, H, F) -> (B, H, N, L, F)
        return t.reshape(B, N, L, H, t.shape[-1]).permute(0, 3, 1, 2, 4)

    r, k, v, lw = lay(r), lay(k), lay(v), lay(lw)
    cum = torch.cumsum(lw, dim=3)                 # inclusive
    cum_exc = cum - lw                            # exclusive
    tot = cum[:, :, :, -1:]                       # (B, H, N, 1, K)
    r_dec = r * torch.exp(cum_exc)
    k_idec = k * torch.exp(-cum)
    k_dec = k * torch.exp(tot - cum)
    below = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    A = torch.where(below, r_dec @ k_idec.transpose(-1, -2), 0.0)
    y = A @ v + (r * u[None, :, None, None, :] * k).sum(-1, keepdim=True) * v
    upd = k_dec.transpose(-1, -2) @ v             # (B, H, N, K, V)
    decay = torch.exp(tot[:, :, :, 0])[..., None]  # (B, H, N, K, 1)
    state = torch.zeros((B, H, K, V), dtype=f32, device=r.device)
    cross = []
    for n in range(N):   # the state carried across chunks
        cross.append(r_dec[:, :, n] @ state)
        state = decay[:, :, n] * state + upd[:, :, n]
    if N:
        y = y + torch.stack(cross, dim=2)
    y = y.permute(0, 2, 3, 1, 4).reshape(B, N * L, H, V)[:, :S]
    return y.contiguous(), state
