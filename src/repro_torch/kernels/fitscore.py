"""The placement select of the DVBP replay: constants, layout and the plain
PyTorch version.

This module is the port's single definition site of the scoring and replay
encodings (the JAX package keeps its own in ``repro.kernels.fitscore``; a
test holds the two equal).  It also holds ``select_ref``, the plain eager
PyTorch version of the hand-written CUDA select in ``csrc/select.cu``: the
same function, op for op in the same fp32 rounding, used by the CPU tests
and as the yardstick the kernel is compared with on the card.

Layout of the select's state (``select_pad_geometry``): ``Np`` is the slot
pool size ``max_bins`` exactly, and the resource dimension is zero-padded
to ``DPAD = 8`` (two ``float4`` per slot row).  Padded dims hold zero size
and zero load, so they are always feasible and are masked out of every
best-fit norm through ``dmask``.
"""
from __future__ import annotations

import torch

# --- scoring semantics -----------------------------------------------------
SELECT_POLICIES = ("first_fit", "best_fit_l1", "best_fit_l2", "best_fit_linf",
                   "mru", "greedy", "nrt_standard", "nrt_prioritized")
SCORE_BIG = 1e30     # +BIG == infeasible slot
SCORE_NEG = -1e30    # closes sentinel for virgin/closed slots
F32_EPS = 1e-6       # fp32 capacity tolerance
IBIG = 2 ** 30       # int sentinel for (open_seq, row) tie-break argmins

# --- replay encodings ------------------------------------------------------
ARRIVAL_KIND = 1
DEPARTURE_KIND = 0
PAD_KIND = -1        # no-op filler event (the carry passes through)
MIGRATE_KIND = 2     # consolidation re-place (not replayed by this package)

# Bin-role tags carried per slot by the category families.
TAG_VIRGIN, TAG_GENERAL, TAG_BASE, TAG_LARGE = -1, -2, -3, -4
TAG_NONE = -99

# RCP/PPE item locations.
LOC_G, LOC_B, LOC_C, LOC_L = 0, 1, 2, 3

# Dense bound for RCP/PPE's per-category aggregates.
KCAT = 64

# Padded resource width of the select's state: two float4 loads per row.
DPAD = 8


def select_pad_geometry(n: int, d: int):
    """Select layout for an ``n``-slot, ``d``-dim pool: ``(Np, dpad)``."""
    if not 1 <= d <= DPAD:
        raise ValueError(f"resource dimension d={d} outside 1..{DPAD}")
    return n, DPAD


def policy_code(policy: str) -> int:
    """Index of a score policy in ``SELECT_POLICIES`` (the kernel's code)."""
    try:
        return SELECT_POLICIES.index(policy)
    except ValueError:
        raise ValueError(f"{policy!r} is not a select policy; known: "
                         f"{SELECT_POLICIES}") from None


def _fma_f32(a, b, c):
    """fp32 ``fmaf(a, b, c)``: the f64 product of two f32 is exact, so one
    f64 add and one rounding to f32 give the fused result except in the
    double-rounding corner (a sum whose f64 rounding lands exactly on an
    f32 tie); none was seen in the random cases of the tests."""
    return (a.double() * b.double() + c.double()).float()


def score_ref(loads, alive, open_seq, access_seq, closes, size, pdep, now,
              dmask, cmask=None, *, policy: str):
    """Per-slot scores (L, Np) f32 of ``select_ref``: lower is better,
    ``SCORE_BIG`` marks an infeasible slot.  For ``nrt_prioritized`` the
    case-(b) scores stand only where no slot of the lane is in case (a).

    Every sum over the dims is an explicit ordered loop (``torch.sum``
    reorders it), and the l2 norm is an FMA chain ``q = fma(a_k, a_k, q)``:
    the rounding of the JAX package's jitted select."""
    L, Np, D = loads.shape
    f32 = torch.float32
    # elementwise compares and differences round alike in any order
    free_cap = 1.0 - loads
    feasible = (size[:, None, :] <= free_cap + F32_EPS).all(dim=2)
    feasible = feasible & (alive if cmask is None else alive & cmask)

    if policy == "first_fit":
        s = open_seq.to(f32)
    elif policy == "mru":
        s = -access_seq.to(f32)
    elif policy.startswith("best_fit"):
        after = (free_cap - size[:, None, :]) * dmask[:, None, :]
        if policy == "best_fit_l1":
            s = torch.zeros((L, Np), dtype=f32, device=loads.device)
            for k in range(D):
                s = s + after[:, :, k]
        elif policy == "best_fit_l2":
            a64 = after.double()
            q = torch.zeros((L, Np), dtype=f32, device=loads.device)
            for k in range(D):
                q = _fma_f32(a64[:, :, k], a64[:, :, k], q)
            # f64 sqrt of an f32 rounds correctly back to f32
            s = torch.sqrt(q.double()).float()
        elif policy == "best_fit_linf":
            # a max is exact in any order; masked dims never win
            s = torch.where(dmask[:, None, :] > 0, after,
                            SCORE_NEG).amax(dim=2)
        else:
            raise ValueError(f"{policy!r} is not a select policy")
    elif policy == "greedy":
        s = -torch.maximum(closes, now[:, None])
    elif policy == "nrt_standard":
        s = torch.abs(torch.maximum(closes, now[:, None]) - pdep[:, None])
    elif policy == "nrt_prioritized":
        # case (a) bins strictly before case (b): a two-stage select
        gap = torch.maximum(closes, now[:, None]) - pdep[:, None]
        sa = torch.where(feasible & (gap >= 0), gap, SCORE_BIG)
        sb = torch.where(feasible & (gap < 0), -gap, SCORE_BIG)
        return torch.where((sa < SCORE_BIG).any(dim=1, keepdim=True), sa, sb)
    else:
        raise ValueError(f"{policy!r} is not a select policy")
    return torch.where(feasible, s, SCORE_BIG)


def select_ref(loads, counts, alive, open_seq, access_seq, closes, size,
               pdep, now, dmask, cmask=None, *, policy: str):
    """The fused placement decision over ``L`` lanes, in eager torch ops.

    loads (L, Np, D) f32; counts/open_seq/access_seq (L, Np) int32; alive
    (L, Np) bool; closes (L, Np) f32; size/dmask (L, D) f32; pdep/now (L,)
    f32; cmask (L, Np) bool or None (None = every slot eligible).

    Feasibility is ``size <= 1 - loads + F32_EPS`` on every dim, AND alive,
    AND cmask.  The chosen slot is the lexicographic minimum of (score,
    open_seq, row) over feasible slots (``score_ref``).  Without a feasible
    slot the first free slot (counts == 0) is chosen, and slot 0 with
    ``no_free`` set when none is free.  Returns (slot int32, found bool,
    no_free bool), each (L,)."""
    Np = loads.shape[1]
    s = score_ref(loads, alive, open_seq, access_seq, closes, size, pdep,
                  now, dmask, cmask, policy=policy)
    smin = s.min(dim=1, keepdim=True).values
    best = torch.argmin(torch.where(s <= smin, open_seq, IBIG), dim=1)
    found = smin[:, 0] < SCORE_BIG
    rows = torch.arange(Np, device=loads.device)
    free = torch.argmin(torch.where(counts == 0, rows, Np + 1), dim=1)
    no_free = counts.gather(1, free[:, None])[:, 0] != 0
    slot = torch.where(found, best, free).to(torch.int32)
    return slot, found, no_free
