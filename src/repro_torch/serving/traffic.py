"""Synthetic heavy-traffic request generators for the serving front end
(the port's ``repro.serving.traffic``; the same seed gives the same
requests, draw for draw).

Open-loop arrival processes at control-plane rates (1e4 - 1e6 req/s):

  * ``poisson_requests`` - homogeneous Poisson arrivals (exponential
    gaps), the classic open-loop load model,
  * ``diurnal_requests`` - an inhomogeneous Poisson process whose rate
    follows a raised-cosine day curve (peak ``rate``, trough
    ``rate * (1 - depth)``), generated by thinning, so batched admission
    sees both the rush-hour bursts and the overnight trickle.

Both are seeded and fully deterministic (``np.random.default_rng``), share
the fleet simulation's log-normal decode-length model (paper Fig. 1:
VM lifetimes are log-normal; decode lengths are the serving analogue) and
emit plain ``serving.Request`` streams, so the same trace drives the
batched front end, the sequential oracle and the throughput benches.

``tps`` here is the *decode* speed used to turn token counts into service
times; at control-plane arrival rates the fleet stays bounded only when
mean service time is of order ``concurrency / rate``, so the defaults pair
a high ``tps`` with the high rates (the knobs are free - the README's
"Online serving" section has the sizing arithmetic).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .scheduler import Request


def _finish(rng, t: np.ndarray, n: int, decode_mu: float,
            decode_sigma: float, prompt_lo: int, prompt_hi: int,
            sigma_pred: Optional[float]) -> List[Request]:
    prompts = rng.integers(prompt_lo, prompt_hi, n)
    decodes = np.clip(rng.lognormal(decode_mu, decode_sigma, n),
                      8, 8192).astype(int)
    preds = None
    if sigma_pred is not None:
        delta = np.exp(rng.normal(0.0, sigma_pred, n)) if sigma_pred > 0 \
            else np.ones(n)
        preds = np.maximum(1, (decodes * delta)).astype(int)
    return [Request(i, float(t[i]), int(prompts[i]), int(decodes[i]),
                    None if preds is None else int(preds[i]))
            for i in range(n)]


def poisson_requests(n: int, *, rate: float = 5e4, seed: int = 0,
                     decode_mu: float = 5.0, decode_sigma: float = 1.2,
                     prompt_lo: int = 32, prompt_hi: int = 512,
                     sigma_pred: Optional[float] = 0.0) -> List[Request]:
    """``n`` open-loop Poisson arrivals at ``rate`` req/s.  With
    ``sigma_pred`` set (0 = clairvoyant) every request carries a
    log-normally-perturbed ``predicted_decode_len``; None leaves the
    stream non-clairvoyant."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.0 / rate, n))
    return _finish(rng, t, n, decode_mu, decode_sigma, prompt_lo,
                   prompt_hi, sigma_pred)


def diurnal_requests(n: int, *, rate: float = 5e4, period: float = 86400.0,
                     depth: float = 0.8, phase: float = 0.0, seed: int = 0,
                     decode_mu: float = 5.0, decode_sigma: float = 1.2,
                     prompt_lo: int = 32, prompt_hi: int = 512,
                     sigma_pred: Optional[float] = 0.0) -> List[Request]:
    """``n`` arrivals from an inhomogeneous Poisson process with rate
    ``rate * (1 - depth/2 * (1 - cos(2 pi (t/period - phase))))`` - peak
    ``rate`` at the period start, trough ``rate * (1 - depth)`` half a
    period in.  Standard thinning: candidate arrivals at the peak rate,
    each kept with probability rate(t)/rate, so the process is exact and
    the stream deterministic per seed."""
    if not 0.0 <= depth < 1.0:
        raise ValueError(f"depth {depth}: the trough's fractional dip, in "
                         "[0, 1)")
    rng = np.random.default_rng(seed)
    t, kept = 0.0, []
    while len(kept) < n:
        gaps = rng.exponential(1.0 / rate, 4 * n)
        u = rng.random(4 * n)
        for g, ui in zip(gaps, u):
            t += g
            frac = 0.5 * (1.0 - np.cos(
                2.0 * np.pi * (t / period - phase)))
            if ui <= 1.0 - depth * frac:
                kept.append(t)
                if len(kept) == n:
                    break
    return _finish(rng, np.asarray(kept), n, decode_mu, decode_sigma,
                   prompt_lo, prompt_hi, sigma_pred)


def make_traffic(kind: str, n: int, **kw) -> List[Request]:
    """Name-keyed constructor (``python -m repro serve --traffic ...``)."""
    if kind == "poisson":
        return poisson_requests(n, **kw)
    if kind == "diurnal":
        return diurnal_requests(n, **kw)
    raise KeyError(f"unknown traffic kind {kind!r}; "
                   "known: poisson, diurnal")
