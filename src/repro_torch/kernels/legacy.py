"""The legacy single-pool scorer: the plain PyTorch version of
``csrc/fitscore.cu``, the counterpart of the JAX package's Pallas kernel
``repro.kernels.fitscore.fitscore``.

One arriving item against ``N`` bins of one pool: feasibility (``after =
remaining - item >= -EPS`` on every dim, and ``alive``), a residual score
per bin (the l1, l2 or l_inf norm of ``after``, or for ``first_fit`` the
bin's opening order), and the chosen bin: the lexicographic (score,
open_seq, row) minimum over the feasible bins, or -1 when none is.  Ties
fall to the earliest-opened bin, the oracle's rule.  All arithmetic is
float32; the sums over the dims are ordered loops (``torch.sum`` reorders
them), the op order the CUDA kernel repeats, so the two agree bit for bit.
"""
from __future__ import annotations

import torch

EPS = 1e-9       # feasibility tolerance (the reference's legacy EPS)
BIG = 3.0e38     # infeasible score inside the kernel; +inf once returned
NORMS = ("l1", "l2", "linf", "first_fit")


def fitscore_ref(remaining, alive, item, open_seq=None, *,
                 norm: str = "linf"):
    """remaining (N, d) f32, alive (N,) bool (or nonzero ints), item (d,)
    f32, open_seq (N,) int32 opening-order keys (None: the slot index).
    Returns (scores (N,) f32, +inf where infeasible; best int32 0-dim
    tensor, -1 when no bin is feasible)."""
    if norm not in NORMS:
        raise ValueError(f"norm {norm!r} not in {NORMS}")
    f32 = torch.float32
    remaining = remaining.to(f32)
    N, d = remaining.shape
    dev = remaining.device
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    oseq = rows if open_seq is None else open_seq.to(torch.int32)
    after = remaining - item.to(f32)[None, :]
    feasible = (after >= -EPS).all(dim=1) & (alive > 0)
    if norm == "l1":
        s = torch.zeros(N, dtype=f32, device=dev)
        for k in range(d):
            s = s + after[:, k]
    elif norm == "l2":
        q = torch.zeros(N, dtype=f32, device=dev)
        for k in range(d):
            q = q + after[:, k] * after[:, k]
        s = torch.sqrt(q)
    elif norm == "linf":
        s = after.amax(dim=1)
    else:
        s = oseq.to(f32)
    s = torch.where(feasible, s, BIG)
    scores = torch.where(s >= BIG, torch.inf, s)
    cand = s < BIG
    smin = torch.where(cand, s, torch.inf).min()
    tied = cand & (s == smin)
    omin = torch.where(tied, oseq, torch.iinfo(torch.int32).max).min()
    best = torch.where(tied & (oseq == omin), rows,
                       torch.iinfo(torch.int32).max).min()
    best = torch.where(cand.any(), best, -1).to(torch.int32)
    return scores, best
