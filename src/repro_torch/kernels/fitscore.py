"""The placement select and the replay step of the DVBP replay: constants,
layouts and the plain PyTorch versions of the port's two kernels.

This module is the port's single definition site of the scoring and replay
encodings (the JAX package keeps its own in ``repro.kernels.fitscore``; a
test holds the two equal).  It holds the plain eager PyTorch versions of
the hand-written CUDA kernels in ``csrc/``, op for op in the same fp32
rounding, which the CPU tests run and the card check compares the kernels
with:

* ``select_ref`` - the fused placement select (``csrc/select.cu``);
* ``replay_stepper`` - one event of the replay for every lane, all six
  kernel families (score, cbd, hybrid, rcp, la, adaptive), on the
  unpacked carry.  The per-event replay (``core.torchsim``) runs it with
  the select kernel; ``replay_block_ref`` runs it ``T`` times on the packed
  carry with ``select_ref`` - the plain version of the event-blocked
  megakernel (``csrc/replay_block.cu``).  The category semantics are
  written once, here.

Layout of the select's state (``select_pad_geometry``): ``Np`` is the slot
pool size ``max_bins`` exactly, and the resource dimension is zero-padded
to ``DPAD = 8`` (two ``float4`` per slot row).  Padded dims hold zero size
and zero load, so they are always feasible and are masked out of every
best-fit norm through ``dmask``.
"""
from __future__ import annotations

import torch

from ..core.algorithms import LA_BINARY_SPLIT, geo_class_jnp

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
MIGRATE_KIND = 2     # consolidation: leave the bin, re-place via the select
#                      (replayed where the replay is asked for ``migrate``)

# Bin-role tags carried per slot by the category families.
TAG_VIRGIN, TAG_GENERAL, TAG_BASE, TAG_LARGE = -1, -2, -3, -4
TAG_NONE = -99

# RCP/PPE item locations.
LOC_G, LOC_B, LOC_C, LOC_L = 0, 1, 2, 3

# Dense bound for RCP/PPE's per-category aggregates.
KCAT = 64

# Padded resource width of the select's state: two float4 loads per row.
DPAD = 8

# --- packed carry of the event-blocked replay (the reference's layout, with
# d padded to DPAD and Np = max_bins) -----------------------------------------
#   loads  (L, Np, DPAD) f32    per-slot load vectors
#   slotf  (L, Np, 8)    f32    cols: SLOTF_CLOSES, SLOTF_OPEN_TIME
#   sloti  (L, Np, 8)    i32    cols: counts, alive, open_seq, access_seq, tag
#   itemi  (L, R, 8)     i32    cols: placements, family aux (hybrid ingen /
#                               rcp location); R = item rows (n_max)
#   sf     (L, 8)        f32    cols: usage, PPE alpha, adaptive error
#   si     (L, 8)        i32    cols: seq, opened, overflow, rcp base slot
#   hagg   (L, R, DPAD)  f32    hybrid per-key aggregates (hybrid only)
#   ragg   (L, RAGG_ROWS, DPAD) f32  rcp aggregates: gen | cat | bcat rows,
#                               the base row at RAGG_BASE (rcp only)
#   ron    (L, KCAT, 8)  i32    rcp per-category ON flags (rcp only)
SLOTF_CLOSES, SLOTF_OPEN_TIME, SLOTF_COLS = 0, 1, 8
(SLOTI_COUNTS, SLOTI_ALIVE, SLOTI_OSEQ, SLOTI_ASEQ, SLOTI_TAG,
 SLOTI_COLS) = 0, 1, 2, 3, 4, 8
ITEMI_PLACE, ITEMI_AUX, ITEMI_COLS = 0, 1, 8
SF_USAGE, SF_ALPHA, SF_ERR, SF_COLS = 0, 1, 2, 8
SI_SEQ, SI_OPENED, SI_OVERFLOW, SI_BASE, SI_COLS = 0, 1, 2, 3, 8
RAGG_BASE = 3 * KCAT           # rcp aggregate row holding the base bin
RAGG_ROWS = 3 * KCAT + 8
RON_COLS = 8

REPLAY_FAMILIES = ("score", "cbd", "hybrid", "rcp", "la", "adaptive")
# per-family extra per-event streams (beyond kind/item and t/pdep)
REPLAY_EV_I = {"score": (), "cbd": ("cat",), "hybrid": ("key", "cls"),
               "rcp": ("cat", "large", "x"), "la": ("cat",),
               "adaptive": ()}
REPLAY_EV_F = {"score": (), "cbd": (), "hybrid": ("thr",),
               "rcp": ("p2err",), "la": (), "adaptive": ("errmax",)}
_REPLAY_EXTRA_CARRY = {"hybrid": ("hagg",), "rcp": ("ragg", "ron")}

# RCP/PPE's threshold coef / sqrt(x), x = 1..KCAT distinct categories, is
# compiled by XLA into coef * rsqrt(x), whose float32 result differs from
# the correctly rounded 1/sqrt(x) at x in {39, 42, 53, 58, 61} (and from
# fp32 1/sqrt(x) at eleven x).  The reference's values, bit for bit
# (tests/test_torch_categories.py holds them against jax.lax.rsqrt):
_RCP_RSQRT_BITS = (
    0x3F800000, 0x3F3504F3, 0x3F13CD3A, 0x3F000000, 0x3EE4F92E, 0x3ED105EC,
    0x3EC1848F, 0x3EB504F3, 0x3EAAAAAB, 0x3EA1E89B, 0x3E9A5FB2, 0x3E93CD3A,
    0x3E8E00D5, 0x3E88D677, 0x3E8432A5, 0x3E800000, 0x3E785B42, 0x3E715BEF,
    0x3E6AEBF5, 0x3E64F92E, 0x3E5F7483, 0x3E5A514A, 0x3E5584CD, 0x3E5105EC,
    0x3E4CCCCD, 0x3E48D2AB, 0x3E4511A3, 0x3E41848F, 0x3E3E26EB, 0x3E3AF4BA,
    0x3E37EA74, 0x3E3504F3, 0x3E32416A, 0x3E2F9D53, 0x3E2D166C, 0x3E2AAAAB,
    0x3E285835, 0x3E261D5F, 0x3E23F8A3, 0x3E21E89B, 0x3E1FEC04, 0x3E1E01B2,
    0x3E1C2896, 0x3E1A5FB2, 0x3E18A61F, 0x3E16FB06, 0x3E155DA2, 0x3E13CD3A,
    0x3E124925, 0x3E10D0C3, 0x3E0F6381, 0x3E0E00D5, 0x3E0CA840, 0x3E0B5948,
    0x3E0A137D, 0x3E08D677, 0x3E07A1D2, 0x3E067531, 0x3E05503E, 0x3E0432A5,
    0x3E031C19, 0x3E020C52, 0x3E01030A, 0x3E000000)
RCP_RSQRT = torch.tensor(_RCP_RSQRT_BITS, dtype=torch.int64).to(
    torch.int32).view(torch.float32)


def replay_carry_names(family: str):
    """Ordered packed-carry array names for one kernel family."""
    if family not in REPLAY_FAMILIES:
        raise ValueError(f"{family!r} is not a replay family; known: "
                         f"{REPLAY_FAMILIES}")
    return (("loads", "slotf", "sloti", "itemi", "sf", "si") +
            _REPLAY_EXTRA_CARRY.get(family, ()))


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


# ======================================================================
# The replay step: one event for every lane, all six kernel families
# ======================================================================

# the unpacked carry's core entries, in the order of the per-event replay's
# 12-entry carry (the reference's core tuple)
CORE_NAMES = ("loads", "counts", "alive", "open_seq", "access_seq", "closes",
              "open_time", "placements", "usage", "seq", "opened",
              "overflow")


def replay_stepper(family: str, policy: str, *, L: int, Np: int, R: int,
                   d: int, dmask, select, large_bins: bool = True,
                   adaptive_alpha: bool = False, direct_sum: bool = False,
                   la_mode: str = "binary",
                   la_split: float = LA_BINARY_SPLIT, low: float = 2.0,
                   high: float = 16.0):
    """The replay's event step for ``L`` lanes of one kernel family, as a
    function ``step(S, t, is_arr, is_dep, j, size, pdep, ex, is_mig=None)``.

    ``S`` is the unpacked carry: the ``CORE_NAMES`` tensors (loads (L, Np,
    DPAD); counts/alive/open_seq/access_seq/closes/open_time (L, Np);
    placements (L, R); usage/seq/opened/overflow (L,)) plus the family's
    category state under the reference's names (``tag``; hybrid ``agg``
    (L, R, DPAD) / ``ingen``; rcp ``agg_gen`` / ``agg_cat`` / ``agg_bcat``
    (L, KCAT, DPAD), ``agg_base`` (L, DPAD), ``on``, ``base``, ``alpha``,
    ``loc``; adaptive ``err``).  The step updates ``S`` - the slot state
    in place, the rest by replacing entries.  Per event: ``t`` / ``pdep``
    (L,) f32, ``is_arr`` / ``is_dep`` (L,) bool (neither: a PAD no-op),
    ``j`` (L,) int64 item, ``size`` (L, DPAD), and ``ex`` the family's
    extra streams (``REPLAY_EV_I`` / ``REPLAY_EV_F``; integer ones int64,
    ``large`` bool).

    Every lane computes its departure and its arrival and keeps the one
    its event asks for: the fp32 op sequence of the reference's per-event
    jnp step (``repro.core.jaxsim._replay_batch``), with the placement
    decision made by ``select`` (``select_ref`` or the CUDA select's
    wrapper).  RCP/PPE's threshold reads ``RCP_RSQRT``.

    ``is_mig`` (L,) bool marks MIGRATE events (consolidation; None: no lane
    migrates, the exact step without the branch).  A MIGRATE is the item's
    full departure with the learning updates skipped (PPE's alpha, the
    adaptive switch's error: a migration is no departure observation), then
    the arrival machinery on the post-departure state with the item's source
    slot kept out of feasibility - folded into the select's category mask,
    and RCP's base-bin test - but not out of the free-slot stage, which may
    reopen that very slot.  The step then runs in two passes: the departures
    and the migrants' departures, then the arrivals and the migrants'
    re-places; each lane takes part in the pass of its own event."""
    if family not in REPLAY_FAMILIES:
        raise ValueError(f"{family!r} is not a replay family")
    dev = dmask.device
    f32, i32 = torch.float32, torch.int32
    lanes = torch.arange(L, device=dev)
    slot_base, item_base, cat_base = lanes * Np, lanes * R, lanes * KCAT
    rows_k = torch.arange(KCAT, device=dev)[None, :]
    neg = torch.tensor(SCORE_NEG, dtype=f32, device=dev)
    zero = torch.tensor(0.0, dtype=f32, device=dev)
    rsqrt = RCP_RSQRT.to(dev)
    rows_n = torch.arange(Np, device=dev)[None, :]
    no_pick = (torch.zeros(L, dtype=i32, device=dev),
               torch.zeros(L, dtype=torch.bool, device=dev),
               torch.zeros(L, dtype=torch.bool, device=dev))

    def event(S, t, is_arr, is_dep, j, size, pdep, ex, learn, excl,
              decide=True):
        """One event pass: ``learn`` (L,) bool gates the departure's
        learning updates, ``excl`` (L,) int32 is the slot each lane's
        select must not pick (-1: none; None: no lane has one), and
        ``decide=False`` skips the select (a pass without arrivals)."""
        loads, counts, alive = S["loads"], S["counts"], S["alive"]
        open_seq, access_seq, closes = (S["open_seq"], S["access_seq"],
                                        S["closes"])

        def sel(pol, cmask=None):
            if not decide:
                return no_pick
            if excl is not None:
                em = rows_n != excl[:, None]
                cmask = em if cmask is None else cmask & em
            return select(loads, counts, alive, open_seq, access_seq, closes,
                          size, pdep, t, dmask, cmask, policy=pol)

        # ---- the placement decision, on the pre-event state
        if family == "score":
            slot, found, no_free = sel(policy)
        elif family == "cbd":
            catj = ex["cat"]
            open_tag = catj
            slot, found, no_free = sel("first_fit",
                                       S["tag"] == catj[:, None])
        elif family == "hybrid":
            keyj, clsj = ex["key"], ex["cls"]
            agg_f = S["agg"].view(L * R, DPAD)
            kr = item_base + keyj
            aggrow = agg_f.index_select(0, kr)
            after = aggrow + size
            norm = after.gather(1, clsj[:, None])[:, 0] if direct_sum \
                else after.amax(dim=1)
            is_gen = norm <= ex["thr"] + F32_EPS
            open_tag = torch.where(is_gen, clsj, d + keyj)
            slot, found, no_free = sel("first_fit",
                                       S["tag"] == open_tag[:, None])
        elif family == "rcp":
            catj = ex["cat"]
            ci = cat_base + catj
            gen_row = S["agg_gen"].view(-1, DPAD).index_select(0, ci)
            thr = rsqrt[ex["x"].clamp(1, KCAT) - 1]
            if adaptive_alpha:
                thr = S["alpha"] * thr
            fits_gen = (gen_row + size).amax(dim=1) <= thr + F32_EPS
            base = S["base"]
            has_base = base >= 0
            base_loads = loads.view(L * Np, DPAD).index_select(
                0, slot_base + base.clamp_min(0))
            base_fits = ~has_base | (size <= 1.0 - base_loads + F32_EPS
                                     ).all(dim=1)
            if excl is not None:
                # a migrant off the base bin must not re-place into it
                base_fits = base_fits & ((excl < 0) | (base != excl))
            is_on = S["on"].view(-1).index_select(0, ci)
            d_large = ex["large"] if large_bins else \
                torch.zeros_like(is_on)
            fall = ~d_large & ~fits_gen
            d_gen = ~d_large & fits_gen
            d_cat = fall & is_on
            d_base = fall & ~is_on & base_fits
            d_catf = fall & ~is_on & ~base_fits      # "C!": turns ON
            wanted = torch.where(
                d_gen, TAG_GENERAL,
                torch.where(d_cat, catj, torch.where(d_base & has_base,
                                                     TAG_BASE, TAG_NONE)))
            open_tag = torch.where(
                d_large, TAG_LARGE,
                torch.where(d_gen, TAG_GENERAL,
                            torch.where(d_base, TAG_BASE, catj)))
            slot, found, no_free = sel("first_fit",
                                       S["tag"] == wanted[:, None])
        elif family == "la":
            # Best Fit (l_inf) within the item's lifetime class; bins are
            # classed by predicted remaining usage; class-0 items fit
            # anywhere, others fall back to foreign-class bins
            icat = ex["cat"]
            remt = torch.maximum(closes, t[:, None]) - t[:, None]
            bincat = (remt >= la_split).to(i32) if la_mode == "binary" \
                else geo_class_jnp(remt)
            same = bincat == icat[:, None]
            short = (icat == 0)[:, None]
            ra = sel("best_fit_linf", short | same)
            rb = sel("best_fit_linf", ~short & ~same)
            found = ra[1] | rb[1]
            slot = torch.where(ra[1], ra[0], rb[0])
            no_free = ra[2]
        else:   # adaptive: regime switch on the running departure error
            err = S["err"]
            k = torch.where(err < low, 0, torch.where(err < high, 1, 2))
            r0, r1, r2 = (sel("nrt_prioritized"), sel("greedy"),
                          sel("first_fit"))
            slot = torch.where(k == 0, r0[0],
                               torch.where(k == 1, r1[0], r2[0]))
            found = torch.where(k == 0, r0[1],
                                torch.where(k == 1, r1[1], r2[1]))
            no_free = r0[2]

        # ---- the shared slot bookkeeping: each lane touches one slot row,
        # the chosen slot of an arrival, the item's slot of a departure
        # (for a lane without an event in this pass the row is read and
        # written back unchanged: its item's slot, or the select's while the
        # item has none, as in the migrants' pass for an arriving item)
        loads_f = loads.view(L * Np, DPAD)
        slot_f = [S[nm].view(-1) for nm in CORE_NAMES[1:7]]
        place_f = S["placements"].view(-1)
        pj = item_base + j
        b32 = torch.where(is_arr, slot, place_f.index_select(0, pj))
        r = slot_base + torch.where(is_arr | is_dep | (b32 >= 0), b32, slot)
        row = loads_f.index_select(0, r)
        cnt, alv, osq, asq, cls, otm = (a.index_select(0, r)
                                        for a in slot_f)
        seq = S["seq"]

        # departure: the item leaves; the bin closes when it empties
        cnt_d = cnt - 1
        closing = cnt_d == 0
        row_d = torch.where(closing[:, None], zero, row - size)
        # arrival: into the chosen bin, which opens unless it was found
        row_a = row + size
        cls_a = torch.maximum(torch.where(found, cls, neg),
                              torch.maximum(pdep, t))

        opening = is_arr & ~found
        arr_c, dep_c = is_arr[:, None], is_dep[:, None]
        loads_f.index_copy_(0, r, torch.where(
            arr_c, row_a, torch.where(dep_c, row_d, row)))
        for a, new in zip(slot_f, (
                torch.where(is_arr, cnt + 1, torch.where(is_dep, cnt_d, cnt)),
                torch.where(is_dep, alv & ~closing, alv | is_arr),
                torch.where(opening, seq, osq),
                torch.where(is_arr, seq, asq),
                torch.where(
                    is_arr, cls_a, torch.where(is_dep & closing, neg, cls)),
                torch.where(opening, t, otm))):
            a.index_copy_(0, r, new)
        place_f.index_copy_(0, pj, b32)
        S["usage"] = torch.where(
            is_dep, S["usage"] + torch.where(closing, t - otm, zero),
            S["usage"])
        S["overflow"] = S["overflow"] | (opening & no_free)
        S["opened"] = S["opened"] + opening.to(i32)
        S["seq"] = seq + is_arr.to(i32)
        if family in ("score", "la"):
            return

        # ---- the family's category state
        if family == "adaptive":
            S["err"] = torch.where(
                learn, torch.maximum(S["err"], ex["errmax"]), S["err"])
            return
        tag_f = S["tag"].view(-1)
        tag_row = tag_f.index_select(0, r)
        new_tag = torch.where(opening, open_tag.to(i32), tag_row)
        if family == "hybrid":
            ingen_f = S["ingen"].view(-1)
            wasg = ingen_f.index_select(0, pj)
            row_d = torch.clamp_min(
                aggrow - torch.where(wasg[:, None], size, zero), 0.0)
            row_a = aggrow + torch.where(is_gen[:, None], size, zero)
            agg_f.index_copy_(0, kr, torch.where(
                arr_c, row_a, torch.where(dep_c, row_d, aggrow)))
            ingen_f.index_copy_(0, pj, torch.where(is_arr, is_gen, wasg))
        elif family == "rcp":
            # departure: per-location aggregate decrements, the category
            # turns OFF below 1/2, alpha guess-and-double, base-close reset
            gen_f = S["agg_gen"].view(-1, DPAD)
            loc_f = S["loc"].view(-1)
            locd = loc_f.index_select(0, pj)
            sz_g, sz_b, sz_c = (torch.where((locd == v)[:, None], size, zero)
                                for v in (LOC_G, LOC_B, LOC_C))
            cat_row = S["agg_cat"].view(-1, DPAD).index_select(0, ci)
            bcat_row = S["agg_bcat"].view(-1, DPAD).index_select(0, ci)
            gen_d = torch.clamp_min(gen_row - sz_g, 0.0)
            cat_d = torch.clamp_min(cat_row - sz_c, 0.0)
            turn_off = (locd == LOC_C) & is_on & (cat_d.amax(dim=1) < 0.5)
            base_closed = closing & has_base & (b32 == base)
            hot = rows_k == catj[:, None]                    # (L, KCAT)
            hot3 = hot[:, :, None]
            bcat_d = torch.where(
                base_closed[:, None, None], zero,
                torch.where(hot3, torch.clamp_min(bcat_row - sz_b, 0.0)
                            [:, None, :], S["agg_bcat"]))
            base_agg_d = torch.where(
                base_closed[:, None], zero,
                torch.clamp_min(S["agg_base"] - sz_b, 0.0))
            on_d = S["on"] & ~(hot & turn_off[:, None])

            # arrival: aggregate adds, a fresh base bin zeroes the base
            # aggregates, then the base conversion (paper SVI-A): a base
            # bin past 1/2 becomes a bin of its dominant member category,
            # which turns ON
            new_base = d_base & ~has_base
            base_a = torch.where(new_base, b32, base)
            base_agg_a = torch.where(new_base[:, None], zero,
                                     S["agg_base"]) + \
                torch.where(d_base[:, None], size, zero)
            bcat_a = torch.where(
                hot3, (torch.where(new_base[:, None], zero, bcat_row) +
                       torch.where(d_base[:, None], size, zero))[:, None, :],
                torch.where(new_base[:, None, None], zero, S["agg_bcat"]))
            gen_a = gen_row + torch.where(d_gen[:, None], size, zero)
            cat_a = cat_row + torch.where((d_cat | d_catf)[:, None], size,
                                          zero)
            on_a = S["on"] | (hot & d_catf[:, None])
            conv = is_arr & d_base & (base_agg_a.amax(dim=1) > 0.5)
            dom = bcat_a.amax(dim=2).argmax(dim=1)          # first maximum
            on_a = on_a | ((rows_k == dom[:, None]) & conv[:, None])
            new_tag = torch.where(conv, dom.to(i32), new_tag)

            gen_f.index_copy_(0, ci, torch.where(
                arr_c, gen_a, torch.where(dep_c, gen_d, gen_row)))
            cat_m = torch.where(hot3, torch.where(
                arr_c, cat_a, torch.where(dep_c, cat_d, cat_row))[:, None, :],
                S["agg_cat"])
            conv3 = conv[:, None, None]
            S["agg_cat"] = torch.where(conv3, cat_m + bcat_a, cat_m)
            arr3, dep3 = arr_c[:, :, None], dep_c[:, :, None]
            S["agg_bcat"] = torch.where(
                arr3, torch.where(conv3, zero, bcat_a),
                torch.where(dep3, bcat_d, S["agg_bcat"]))
            S["agg_base"] = torch.where(
                arr_c, torch.where(conv[:, None], zero, base_agg_a),
                torch.where(dep_c, base_agg_d, S["agg_base"]))
            S["on"] = torch.where(arr_c, on_a,
                                  torch.where(dep_c, on_d, S["on"]))
            S["base"] = torch.where(
                is_arr, torch.where(conv, -1, base_a),
                torch.where(is_dep & base_closed, -1, base)).to(i32)
            if adaptive_alpha:
                S["alpha"] = torch.where(
                    learn, torch.maximum(S["alpha"], ex["p2err"]),
                    S["alpha"])
            locv = torch.where(d_gen, LOC_G, torch.where(
                d_base, LOC_B, torch.where(d_large, LOC_L, LOC_C)))
            loc_f.index_copy_(0, pj, torch.where(is_arr, locv.to(i32),
                                                 locd))
            S["loc"].masked_fill_(conv[:, None] & (S["loc"] == LOC_B),
                                  LOC_C)
        tag_f.index_copy_(0, r, new_tag)

    def step(S, t, is_arr, is_dep, j, size, pdep, ex, is_mig=None):
        if is_mig is None:
            event(S, t, is_arr, is_dep, j, size, pdep, ex, is_dep, None)
            return
        src = S["placements"].view(-1).index_select(0, item_base + j)
        none = torch.zeros_like(is_mig)
        event(S, t, none, is_dep | is_mig, j, size, pdep, ex, is_dep, None,
              decide=False)
        event(S, t, is_arr | is_mig, none, j, size, pdep, ex, none,
              torch.where(is_mig, src, -1))

    return step


# ======================================================================
# The plain version of the event-blocked replay megakernel
# ======================================================================

def unpack_carry(carry, family: str):
    """The packed carry's state as ``replay_stepper``'s unpacked dict.
    ``loads`` and ``hagg`` are the carry's own tensors (the step updates
    them in place); every other entry is a copy."""
    sloti, slotf, itemi = carry["sloti"], carry["slotf"], carry["itemi"]
    sf, si = carry["sf"], carry["si"]

    def col(a, c):
        return a[..., c].contiguous()

    S = {"loads": carry["loads"], "counts": col(sloti, SLOTI_COUNTS),
         "alive": sloti[..., SLOTI_ALIVE] > 0,
         "open_seq": col(sloti, SLOTI_OSEQ),
         "access_seq": col(sloti, SLOTI_ASEQ),
         "closes": col(slotf, SLOTF_CLOSES),
         "open_time": col(slotf, SLOTF_OPEN_TIME),
         "placements": col(itemi, ITEMI_PLACE), "usage": col(sf, SF_USAGE),
         "seq": col(si, SI_SEQ), "opened": col(si, SI_OPENED),
         "overflow": si[:, SI_OVERFLOW] > 0}
    if family in ("cbd", "hybrid", "rcp"):
        S["tag"] = col(sloti, SLOTI_TAG)
    if family == "hybrid":
        S["agg"] = carry["hagg"]
        S["ingen"] = itemi[..., ITEMI_AUX] > 0
    elif family == "rcp":
        ragg = carry["ragg"]
        S.update(agg_gen=ragg[:, :KCAT].contiguous(),
                 agg_cat=ragg[:, KCAT:2 * KCAT].contiguous(),
                 agg_bcat=ragg[:, 2 * KCAT:3 * KCAT].contiguous(),
                 agg_base=ragg[:, RAGG_BASE].contiguous(),
                 on=carry["ron"][..., 0] > 0, base=col(si, SI_BASE),
                 alpha=col(sf, SF_ALPHA), loc=col(itemi, ITEMI_AUX))
    elif family == "adaptive":
        S["err"] = col(sf, SF_ERR)
    return S


def pack_carry(S, carry, family: str) -> None:
    """Write ``unpack_carry``'s dict back into the packed carry."""
    sloti, slotf, itemi = carry["sloti"], carry["slotf"], carry["itemi"]
    sf, si = carry["sf"], carry["si"]
    for a, c, nm in ((sloti, SLOTI_COUNTS, "counts"),
                     (sloti, SLOTI_ALIVE, "alive"),
                     (sloti, SLOTI_OSEQ, "open_seq"),
                     (sloti, SLOTI_ASEQ, "access_seq"),
                     (slotf, SLOTF_CLOSES, "closes"),
                     (slotf, SLOTF_OPEN_TIME, "open_time"),
                     (itemi, ITEMI_PLACE, "placements"),
                     (sf, SF_USAGE, "usage"), (si, SI_SEQ, "seq"),
                     (si, SI_OPENED, "opened"), (si, SI_OVERFLOW, "overflow"),
                     (sloti, SLOTI_TAG, "tag"), (itemi, ITEMI_AUX, "ingen"),
                     (si, SI_BASE, "base"), (sf, SF_ALPHA, "alpha"),
                     (itemi, ITEMI_AUX, "loc"), (sf, SF_ERR, "err")):
        if nm in S:
            a[..., c].copy_(S[nm])
    if family == "rcp":
        ragg = carry["ragg"]
        ragg[:, :KCAT].copy_(S["agg_gen"])
        ragg[:, KCAT:2 * KCAT].copy_(S["agg_cat"])
        ragg[:, 2 * KCAT:3 * KCAT].copy_(S["agg_bcat"])
        ragg[:, RAGG_BASE].copy_(S["agg_base"])
        carry["ron"][..., 0].copy_(S["on"])


def event_extras(family: str, ev_i, ev_f):
    """The family's extra per-event streams by name, from the stacked
    ``ev_i`` / ``ev_f`` rows past kind/item and t/pdep, in the dtypes the
    step takes (int64 indices, bool ``large``, f32 floats)."""
    ex = {}
    for k, nm in enumerate(REPLAY_EV_I[family]):
        v = ev_i[2 + k]
        ex[nm] = v > 0 if nm == "large" else v.long()
    for k, nm in enumerate(REPLAY_EV_F[family]):
        ex[nm] = ev_f[2 + k]
    return ex


def replay_block_ref(carry, ev_i, ev_f, ev_size, dmask, *, family: str,
                     policy: str, n: int, d: int, large_bins: bool = True,
                     adaptive_alpha: bool = False, direct_sum: bool = False,
                     la_mode: str = "binary",
                     la_split: float = LA_BINARY_SPLIT, low: float = 2.0,
                     high: float = 16.0, migrate: bool = False):
    """One block of ``T`` events for ``L`` lanes on the packed carry, in
    eager torch ops: the plain version of the CUDA megakernel
    (``csrc/replay_block.cu``) and the counterpart of the reference's
    ``fitscore_replay_block``.

    ``carry``: the dict of ``replay_carry_names(family)`` arrays (the
    layout above), updated in place and returned.  ``ev_i`` (2 + ni, L, T)
    int32 holds the streams ``("kind", "item") + REPLAY_EV_I[family]``,
    ``ev_f`` (2 + nf, L, T) f32 the streams ``("t", "pdep") +
    REPLAY_EV_F[family]``; ``ev_size`` (L, T, DPAD) the items' sizes,
    ``dmask`` (L, DPAD) the real-dimension mask.  ``n`` is the slot-pool
    size (the carry's Np), ``d`` the real dimension count (hybrid tags
    encode ``d + key``).  PAD events leave the carry unchanged, and so do
    MIGRATE events unless ``migrate`` is set (the reference's megakernel
    compiles its MIGRATE branch only then)."""
    L, Np, _ = carry["loads"].shape
    if Np != n:
        raise ValueError(f"replay_block_ref: the carry has {Np} slots, n={n}")
    step = replay_stepper(
        family, policy, L=L, Np=Np, R=carry["itemi"].shape[1], d=d,
        dmask=dmask, select=select_ref, large_bins=large_bins,
        adaptive_alpha=adaptive_alpha, direct_sum=direct_sum,
        la_mode=la_mode, la_split=la_split, low=low, high=high)
    S = unpack_carry(carry, family)
    ex_all = event_extras(family, ev_i, ev_f)
    for e in range(ev_size.shape[1]):
        kind = ev_i[0, :, e]
        step(S, ev_f[0, :, e], kind == ARRIVAL_KIND, kind == DEPARTURE_KIND,
             ev_i[1, :, e].long(), ev_size[:, e], ev_f[1, :, e],
             {nm: v[:, e] for nm, v in ex_all.items()},
             (kind == MIGRATE_KIND) if migrate else None)
    pack_carry(S, carry, family)
    return carry
