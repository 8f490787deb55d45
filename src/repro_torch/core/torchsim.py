"""Batched DVBP trace replay in PyTorch; counterpart of
``repro.core.jaxsim``.

The replay walks the precomputed event sequence (2n events per lane,
departures before arrivals at equal times) with a fixed pool of bin slots
per lane.  ``_replay_batch`` replays ``L`` lanes in lockstep: a Python loop
over the event axis whose step processes every lane at once, with the
placement decision made by one call of ``kernels.ops.fitscore_select`` per
step - the hand-written CUDA select on the card, its plain version
``kernels.fitscore.select_ref`` on the CPU.  On the card the whole state
stays on the device and the host reads it once, at the end.

This slice replays the 8 score policies (``POLICIES``).  The 13
category-structured policies parse (``policy_spec``) but raise
``NotImplementedError`` in the replay; they are the next slice of the port.

Scoring and tie-break live in ``kernels.fitscore`` (``score_ref`` and
``select_ref`` are the counterparts of jaxsim's ``_score`` and
``_select_slot``).  The carry is jaxsim's 12-tuple in the same order (see
``_core_state0``), with the load vectors zero-padded to ``DPAD = 8``;
``carry_from_reference`` / ``carry_to_reference`` convert a jaxsim carry so
a replay can start in one package and finish in the other.

Rounding: times, predicted departures and sizes are cast once to float32,
where jaxsim casts them (``jnp.asarray`` with x64 off), and every update is
the same single fp32 operation as in jaxsim, so both packages make the same
decisions and accumulate the same usage bit for bit.
"""
from __future__ import annotations

import collections
import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..kernels.fitscore import (ARRIVAL_KIND, DEPARTURE_KIND, DPAD,
                                SCORE_BIG, SCORE_NEG, SELECT_POLICIES,
                                select_pad_geometry)
from ..kernels.ops import fitscore_select, resolve_device
from .types import Instance

POLICIES = SELECT_POLICIES
NEG = SCORE_NEG
BIG = SCORE_BIG

# Category-structured policies of the reference: they parse here, and the
# replay raises NotImplementedError for them until their slice is ported.
CATEGORY_POLICIES = ("cbd", "cbdt", "hybrid", "reduced_hybrid",
                     "hybrid_direct_sum", "reduced_hybrid_direct_sum",
                     "rcp", "ppe", "rcp_modified", "ppe_modified",
                     "la_binary", "la_geometric", "adaptive")
SCAN_POLICIES = POLICIES + CATEGORY_POLICIES

# Default CBDT window: 0.25 days, the paper's best fixed rho (Fig. 4/8).
CBDT_DEFAULT_RHO = 0.25 * 86400.0

# Ceiling of the slot-pool escalation ladder (simulate and sweep.runner).
MAX_BINS_CAP = int(os.environ.get("REPRO_MAX_BINS_CAP", "65536"))

# "scan_steps": replay steps run since the caller last cleared it (one
# select per step; the card's select launches must equal it).
counters: collections.Counter = collections.Counter()


class CapacityError(RuntimeError):
    """The overflow-escalation ladder hit its ceiling and the replay still
    overflows.  Carries the policy, instance and final pool size."""

    def __init__(self, message: str, *, policy: str = "", max_bins: int = 0,
                 instance: str = ""):
        super().__init__(message)
        self.policy = policy
        self.max_bins = max_bins
        self.instance = instance


def grow_max_bins(max_bins: int, cap: int = MAX_BINS_CAP) -> int:
    """Next rung of the overflow-escalation ladder (doubling, capped)."""
    return min(max(2 * max_bins, 1), cap)


# ======================================================================
# Policy specs: one name space over both families
# ======================================================================

@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Static description of how a policy replays in the scan."""

    family: str                 # score | cbd | cbdt | hybrid | rcp | la |
    #                             adaptive
    beta: float = 2.0           # cbd duration base
    rho: float = CBDT_DEFAULT_RHO   # cbdt departure-window width (seconds)
    reduced: bool = False       # hybrid: duration-only categories
    direct_sum: bool = False    # hybrid: per-max-dimension sub-instances
    large_bins: bool = True     # rcp/ppe: dedicated bins for items > 1/2
    adaptive_alpha: bool = False    # ppe: guess-and-double threshold
    la_mode: str = "binary"     # lifetime alignment class structure
    low: float = 2.0            # adaptive regime thresholds
    high: float = 16.0


def _policy_param(policy: str, text: str, what: str) -> float:
    """One numeric parameter of a parametric policy name; malformed text is
    a KeyError (the "not a policy" signal)."""
    try:
        return float(text)
    except ValueError as e:
        raise KeyError(
            f"malformed scan policy {policy!r} ({what}): {e}") from e


def policy_spec(policy: str) -> PolicySpec:
    """Parse a scan policy name (parametric variants included).

    KeyError for unknown or malformed names; ValueError, naming the valid
    range, for a recognized parametric name whose parameter is out of range
    ("cbd_beta-1", "cbdt_rho0", "adaptive_8_2")."""
    if policy in SELECT_POLICIES:
        return PolicySpec("score")
    if policy == "cbd" or policy.startswith("cbd_beta"):
        beta = 2.0 if policy == "cbd" else \
            _policy_param(policy, policy[len("cbd_beta"):], "beta")
        if not beta > 1.0:
            raise ValueError(
                f"{policy!r}: cbd beta must be > 1 (duration classes are "
                f"[beta^(i-1), beta^i)); got {beta:g}")
        return PolicySpec("cbd", beta=beta)
    if policy == "cbdt" or policy.startswith("cbdt_rho"):
        rho = CBDT_DEFAULT_RHO if policy == "cbdt" else \
            _policy_param(policy, policy[len("cbdt_rho"):], "rho")
        if not rho > 0.0:
            raise ValueError(
                f"{policy!r}: cbdt rho must be > 0 seconds (the departure-"
                f"window width); got {rho:g}")
        return PolicySpec("cbdt", rho=rho)
    if policy in ("hybrid", "reduced_hybrid", "hybrid_direct_sum",
                  "reduced_hybrid_direct_sum"):
        return PolicySpec("hybrid", reduced="reduced" in policy,
                          direct_sum="direct_sum" in policy)
    if policy in ("rcp", "ppe", "rcp_modified", "ppe_modified"):
        return PolicySpec("rcp", large_bins="modified" not in policy,
                          adaptive_alpha=policy.startswith("ppe"))
    if policy in ("la_binary", "la_geometric"):
        return PolicySpec("la", la_mode=policy[3:])
    if policy == "adaptive" or policy.startswith("adaptive_"):
        if policy == "adaptive":
            return PolicySpec("adaptive")
        parts = policy[len("adaptive_"):].split("_")
        if len(parts) != 2:
            raise KeyError(f"malformed scan policy {policy!r}: expected "
                           "adaptive_LOW_HIGH")
        low = _policy_param(policy, parts[0], "low")
        high = _policy_param(policy, parts[1], "high")
        if not 1.0 <= low <= high:
            raise ValueError(
                f"{policy!r}: adaptive thresholds need 1 <= low <= high "
                f"(departure error is >= 1 by construction); got "
                f"low={low:g} high={high:g}")
        return PolicySpec("adaptive", low=low, high=high)
    raise KeyError(f"unknown scan policy {policy!r}; known: {SCAN_POLICIES}")


def known_policy(policy: str) -> bool:
    """True when ``policy`` parses as a scan policy.  A recognized
    parametric name with an out-of-range parameter raises its ValueError."""
    try:
        policy_spec(policy)
        return True
    except KeyError:
        return False


def require_score_policy(policy: str) -> None:
    """Raise NotImplementedError for a policy this port cannot replay yet."""
    if policy_spec(policy).family != "score":
        raise NotImplementedError(
            f"{policy!r} is a category-structured policy; its replay is not "
            "ported yet (ROADMAP.md, Queue 1: category families and the "
            "classifier twins).  Score policies: " + ", ".join(POLICIES))


@dataclasses.dataclass
class TorchSimResult:
    usage_time: float
    n_bins_opened: int
    placements: np.ndarray
    overflowed: bool
    max_bins: int = 0   # slot-pool size that produced this result


# ======================================================================
# The carry
# ======================================================================

def _core_state0(L: int, Np: int, item_rows: int, device):
    """The fresh carry, jaxsim's order: (loads (L, Np, DPAD) f32, counts
    i32, alive bool, open_seq i32, access_seq i32, closes f32, open_time
    f32 - all (L, Np) -, placements (L, item_rows) i32, usage (L,) f32,
    seq i32, opened i32, overflow bool)."""
    f32, i32 = torch.float32, torch.int32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return [full((L, Np, DPAD), 0.0, f32), full((L, Np), 0, i32),
            full((L, Np), False, torch.bool), full((L, Np), 0, i32),
            full((L, Np), -1, i32), full((L, Np), NEG, f32),
            full((L, Np), 0.0, f32), full((L, item_rows), -1, i32),
            full((L,), 0.0, f32), full((L,), 0, i32), full((L,), 0, i32),
            full((L,), False, torch.bool)]


_CARRY_DTYPES = (np.float32, np.int32, bool, np.int32, np.int32, np.float32,
                 np.float32, np.int32, np.float32, np.int32, np.int32, bool)


def carry_from_reference(core, device="cuda"):
    """jaxsim's core carry (the 12-tuple of ``_replay_batch(...,
    return_carry=True)`` on the jnp backend: loads (L, max_bins, d)) ->
    this package's carry on ``device``."""
    device = resolve_device(device)
    out = []
    for k, (a, dt) in enumerate(zip(core, _CARRY_DTYPES)):
        a = np.asarray(a).astype(dt)
        if k == 0:
            L, Np, d = a.shape
            pad = np.zeros((L, Np, DPAD), np.float32)
            pad[:, :, :d] = a
            a = pad
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return out


def carry_to_reference(carry, d: int):
    """This package's carry -> jaxsim's core 12-tuple of numpy arrays
    (loads cut back to its ``d`` real columns)."""
    out = [a.cpu().numpy() for a in carry]
    out[0] = np.ascontiguousarray(out[0][:, :, :d])
    return tuple(out)


# ======================================================================
# The replay
# ======================================================================

def _replay_batch(sizes, times, kinds, items, pdeps, dmask, arrivals=None,
                  rdeps=None, n_items=None, *, policy: str, max_bins: int,
                  device="cuda", carry0=None, return_carry: bool = False):
    """``L`` lanes' event replays in lockstep.

    sizes (L, n_max, d); times / kinds / items (L, E); pdeps (L, n_max)
    predicted departures; ``dmask`` (L, d) real-dimension mask or None.
    Numpy arrays or tensors; float64 inputs are cast once to float32.
    ``arrivals`` / ``rdeps`` / ``n_items`` are read only by the category
    families (not ported yet) and are accepted for the reference's call
    shape.  Events with ``kind == PAD_KIND`` leave the carry untouched.

    Returns (usage (L,) f32, opened (L,) i32, placements (L, n_max) i32,
    overflow (L,) bool) as tensors on ``device``; with ``return_carry`` the
    final carry is appended.  ``carry0`` resumes from a carry (this
    package's layout, e.g. from ``carry_from_reference``)."""
    require_score_policy(policy)
    dev = resolve_device(device)
    f32, i32 = torch.float32, torch.int32

    def tens(a, dt):
        if not torch.is_tensor(a):   # read-only arrays (e.g. from JAX) copy
            a = torch.from_numpy(np.require(a, requirements="W"))
        return a.to(device=dev, dtype=dt)

    sizes_t = tens(sizes, f32)
    L, n_max, d = sizes_t.shape
    Np, dpad = select_pad_geometry(max_bins, d)
    sizes_p = torch.zeros((L, n_max, dpad), dtype=f32, device=dev)
    sizes_p[:, :, :d] = sizes_t
    dmask_p = torch.zeros((L, dpad), dtype=f32, device=dev)
    dmask_p[:, :d] = 1.0 if dmask is None else tens(dmask, f32)
    pdeps_t = tens(pdeps, f32)
    # event-major streams, each step reads one row; the item's size and
    # predicted departure are gathered for every event up front
    items_t = tens(items, torch.int64)
    ev_t = tens(times, f32).T.contiguous()
    ev_kind = tens(kinds, i32).T
    ev_arr = (ev_kind == ARRIVAL_KIND).contiguous()
    ev_dep = (ev_kind == DEPARTURE_KIND).contiguous()
    ev_item = items_t.T.contiguous()
    ev_size = torch.gather(
        sizes_p, 1, items_t[:, :, None].expand(-1, -1, dpad)
    ).transpose(0, 1).contiguous()                       # (E, L, dpad)
    ev_pdep = torch.gather(pdeps_t, 1, items_t).T.contiguous()   # (E, L)

    carry = _core_state0(L, Np, n_max, dev) if carry0 is None else \
        [torch.as_tensor(a, device=dev).clone(
            memory_format=torch.contiguous_format) for a in carry0]
    (loads, counts, alive, open_seq, access_seq, closes, open_time,
     placements, usage, seq, opened, overflow) = carry
    # flat views of the per-slot state: each step reads and writes one
    # slot row per lane through index_select / index_copy_ (lanes are
    # distinct, so the rows written are distinct)
    loads_f = loads.view(L * Np, dpad)
    slot_f = [a.view(-1) for a in (counts, alive, open_seq, access_seq,
                                   closes, open_time)]
    place_f = placements.view(-1)
    lanes = torch.arange(L, device=dev)
    slot_base, item_base = lanes * Np, lanes * placements.shape[1]
    neg = torch.tensor(NEG, dtype=f32, device=dev)
    zero = torch.tensor(0.0, dtype=f32, device=dev)

    E = ev_t.shape[0]
    for e in range(E):
        t, j, size, pdep_j = ev_t[e], ev_item[e], ev_size[e], ev_pdep[e]
        is_arr, is_dep = ev_arr[e], ev_dep[e]
        slot, found, no_free = fitscore_select(
            loads, counts, alive, open_seq, access_seq, closes, size,
            pdep_j, t, dmask_p, policy=policy)
        # each lane touches one slot row: the chosen slot of an arrival,
        # the item's slot of a departure (for a pad event the row is read
        # and written back unchanged)
        pj = item_base + j
        b32 = torch.where(is_arr, slot, place_f.index_select(0, pj))
        r = slot_base + b32
        row = loads_f.index_select(0, r)
        cnt, alv, osq, asq, cls, otm = (a.index_select(0, r)
                                        for a in slot_f)

        # departure: the item leaves; the bin closes when it empties
        cnt_d = cnt - 1
        closing = cnt_d == 0
        row_d = torch.where(closing[:, None], zero, row - size)
        # arrival: into the chosen bin, which opens unless it was found
        row_a = row + size
        cls_a = torch.maximum(torch.where(found, cls, neg),
                              torch.maximum(pdep_j, t))

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
        usage = torch.where(is_dep,
                            usage + torch.where(closing, t - otm, zero),
                            usage)
        overflow = overflow | (opening & no_free)
        opened = opened + opening.to(i32)
        seq = seq + is_arr.to(i32)
    counters["scan_steps"] += E

    out = (usage, opened, placements, overflow)
    if return_carry:
        return out + ([loads, counts, alive, open_seq, access_seq, closes,
                       open_time, placements, usage, seq, opened,
                       overflow],)
    return out


def event_sequence(inst: Instance):
    """(times, kinds, items): departures sorted before arrivals at equal
    times (half-open [arrival, departure) intervals).  Shared by simulate()
    and the batching layer."""
    n = inst.n_items
    times = np.concatenate([inst.arrivals, inst.departures])
    kinds = np.concatenate([np.full(n, ARRIVAL_KIND, np.int32),
                            np.full(n, DEPARTURE_KIND, np.int32)])
    items = np.concatenate([np.arange(n), np.arange(n)]).astype(np.int32)
    order = np.lexsort((np.arange(2 * n), kinds, times))
    return times[order], kinds[order], items[order]


def simulate(inst: Instance, policy: str = "first_fit",
             predicted_durations: Optional[np.ndarray] = None,
             max_bins: int = 256, auto_grow: bool = True,
             max_bins_cap: int = MAX_BINS_CAP,
             device="cuda") -> TorchSimResult:
    """Replay one instance under a score policy.  If the slot pool
    overflows and ``auto_grow`` is set, retry with a doubled ``max_bins``
    (up to ``max_bins_cap``, then ``CapacityError``)."""
    if not known_policy(policy):
        raise KeyError(f"{policy!r} is not a scan policy; known: "
                       f"{SCAN_POLICIES}")
    require_score_policy(policy)
    pdeps = inst.departures if predicted_durations is None \
        else inst.arrivals + predicted_durations
    times, kinds, items = event_sequence(inst)
    while True:
        usage, opened, placements, overflow = _replay_batch(
            inst.sizes[None], times[None], kinds[None], items[None],
            pdeps[None], None, policy=policy, max_bins=max_bins,
            device=device)
        if not bool(overflow[0]) or not auto_grow:
            break
        if max_bins >= max_bins_cap:
            raise CapacityError(
                f"slot pool exhausted replaying {inst.name!r} with "
                f"{policy!r}: still overflowing at max_bins={max_bins} "
                f"(cap {max_bins_cap}; raise REPRO_MAX_BINS_CAP or pass "
                f"a larger max_bins_cap)",
                policy=policy, max_bins=max_bins, instance=inst.name)
        max_bins = grow_max_bins(max_bins, max_bins_cap)
    return TorchSimResult(float(usage[0]), int(opened[0]),
                          placements[0].cpu().numpy(), bool(overflow[0]),
                          max_bins)
