"""Batched DVBP trace replay in PyTorch; counterpart of
``repro.core.jaxsim``.

The replay walks the precomputed event sequence (2n events per lane,
departures before arrivals at equal times) with a fixed pool of bin slots
per lane, for every policy of ``SCAN_POLICIES``: the 8 score policies and
the 13 category-structured ones (CBD/CBDT, the Hybrids, RCP/PPE, Lifetime
Alignment, adaptive).  ``_replay_batch`` replays ``L`` lanes in lockstep,
on one of two paths with the same decisions:

* per event (the default): a loop over the event axis whose step
  (``kernels.fitscore.replay_stepper``) processes every lane at once, with
  the placement decision made by ``kernels.ops.fitscore_select`` - the
  hand-written CUDA select on the card, ``select_ref`` on the CPU; the
  category families pass their compatibility mask as ``cmask``.  On the
  card the loop runs in windows of ``STEP_WINDOW`` steps, each window one
  replay of a CUDA graph of the unchanged steps (``replay_windows``); on
  the CPU it is the plain Python loop;
* event-blocked (``block_events=T > 1``): a host loop over blocks of T
  events, each replayed by one launch of the CUDA megakernel
  ``kernels.ops.fitscore_replay_block`` (its plain version on the CPU)
  with the packed carry on the device.

``migrate=True`` replays MIGRATE events on either path (consolidation:
``repro_torch.consolidate``); without it they are no-ops.

``_replay_batch`` is its two halves in turn: ``event_streams`` builds the
per-event streams on the host, ``replay_streams`` replays them on the
device.  The streamed replay (``repro_torch.stream``) calls them apart, to
build and stage a chunk's streams while the card replays the one before.

``trace_level >= 1`` takes the per-event path (as the reference bypasses
its blocked kernel) and also writes each event's post-event state into
(L, E, ...) tensors allocated before the loop (``traced_stepper``): the
decision series of ``repro_torch.obs.ReplayTrace``.  On the card the
traced steps run inside the same CUDA graphs of event windows.

On the card the whole state stays on the device and the host reads it
once, at the end.  Per-item category constants (classes, thresholds,
errors, hybrid key ids) and RCP's running distinct-category count are pure
functions of the (predicted) durations: ``_category_setup`` computes them
once per replay, on the CPU, with the float32 classifiers of
``core.algorithms``.

The per-event carry is jaxsim's 12-tuple in the same order (see
``_core_state0``), with the load vectors zero-padded to ``DPAD = 8``,
followed by the category dict for families that carry category state;
the blocked path's carry is the packed dict of ``kernels.fitscore``.
``carry_from_reference`` / ``carry_to_reference`` and
``packed_carry_from_reference`` / ``packed_carry_to_reference`` convert
the reference's carries, so a replay can start in one package and finish
in the other.

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

from ..kernels import fitscore as fk
from ..kernels.fitscore import (ARRIVAL_KIND, DEPARTURE_KIND, DPAD, KCAT,
                                MIGRATE_KIND, PAD_KIND, REPLAY_EV_F,
                                REPLAY_EV_I, SCORE_BIG, SCORE_NEG,
                                SELECT_POLICIES, TAG_VIRGIN,
                                select_pad_geometry)
from ..kernels.ops import (fitscore_select, launches, replay_chunk,
                           resolve_device)
from .. import obs
from .algorithms import (LA_BINARY_SPLIT, to_i32, departure_window_jnp,
                         dur_exponent_jnp, duration_class_jnp,
                         geo_class_jnp, hybrid_threshold_jnp, la_class_jnp,
                         prediction_error_jnp, pow2_ceiling_jnp)
from .types import Instance

POLICIES = SELECT_POLICIES
NEG = SCORE_NEG
BIG = SCORE_BIG

# Category-structured policies of the reference (parametric variants parse
# too: "cbd_beta4", "cbdt_rho3600", "adaptive_2_16").
CATEGORY_POLICIES = ("cbd", "cbdt", "hybrid", "reduced_hybrid",
                     "hybrid_direct_sum", "reduced_hybrid_direct_sum",
                     "rcp", "ppe", "rcp_modified", "ppe_modified",
                     "la_binary", "la_geometric", "adaptive")
SCAN_POLICIES = POLICIES + CATEGORY_POLICIES

# Default CBDT window: 0.25 days, the paper's best fixed rho (Fig. 4/8).
CBDT_DEFAULT_RHO = 0.25 * 86400.0

# Ceiling of the slot-pool escalation ladder (simulate and sweep.runner).
MAX_BINS_CAP = int(os.environ.get("REPRO_MAX_BINS_CAP", "65536"))

# Since the caller last cleared it: "scan_steps", per-event replay steps
# run (one select per step for the score family); "replay_blocks", blocks
# of the event-blocked replay (one megakernel launch each).
counters: collections.Counter = collections.Counter()

# Steps of the per-event replay that one CUDA graph replays on the card (a
# window; see ``replay_windows``).  Chosen on the card from the wall time a
# step of a whole main-path scan at windows of 64, 128 and 256 steps: the
# first window runs eagerly and the capture at the eager cost, so the
# smallest window was the fastest (PERF.md, PR 18).
STEP_WINDOW = 64


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


def host_algorithm(policy: str):
    """The oracle engine's algorithm (``core.engine.run``) equivalent to a
    scan policy: the parity reference the replay is held to."""
    from .algorithms import get_algorithm
    spec = policy_spec(policy)
    if spec.family == "score":
        if policy.startswith("best_fit_"):
            return get_algorithm("best_fit", norm=policy.split("_")[-1])
        return get_algorithm(policy)
    if spec.family == "cbd":
        return get_algorithm("cbd", beta=spec.beta)
    if spec.family == "cbdt":
        return get_algorithm("cbdt", rho=spec.rho)
    if spec.family == "la":
        return get_algorithm("lifetime_alignment", mode=spec.la_mode)
    if spec.family == "adaptive":
        return get_algorithm("adaptive", low=spec.low, high=spec.high)
    return get_algorithm(policy)


@dataclasses.dataclass
class TorchSimResult:
    usage_time: float
    n_bins_opened: int
    placements: np.ndarray
    overflowed: bool
    max_bins: int = 0   # slot-pool size that produced this result


# ======================================================================
# Category set-up: per-item constants and per-event extra streams
# ======================================================================

# policy_spec family -> kernel family (cbd and cbdt share the class-
# restricted First Fit; only the per-item class constant differs)
_KERNEL_FAMILY = {"score": "score", "cbd": "cbd", "cbdt": "cbd",
                  "hybrid": "hybrid", "rcp": "rcp", "la": "la",
                  "adaptive": "adaptive"}


def _dense_key_ids(i, cls, win):
    """Dense hybrid key ids per lane: key[l, j] = the smallest item index
    whose (i, cls, win) triple equals item j's (a valid row of an item-
    sized aggregate table).  A lexicographic sort plus a segment minimum,
    O(n log n) per lane; all (L, n) int tensors."""
    L, n = i.shape
    order = torch.arange(n).expand(L, n)
    for key in (win, cls, i):       # stable sorts, least significant first
        k = key.gather(1, order)
        order = order.gather(1, torch.sort(k, dim=1, stable=True).indices)
    si, sc, sw = (a.gather(1, order) for a in (i, cls, win))
    new = torch.ones((L, n), dtype=torch.bool)
    new[:, 1:] = (si[:, 1:] != si[:, :-1]) | (sc[:, 1:] != sc[:, :-1]) | \
        (sw[:, 1:] != sw[:, :-1])
    grp = torch.cumsum(new.to(torch.int64), dim=1) - 1
    first = torch.full((L, n), n, dtype=torch.int64).scatter_reduce(
        1, grp, order, "amin")
    return torch.empty((L, n), dtype=torch.int32).scatter_(
        1, order, first.gather(1, grp).to(torch.int32))


def _category_setup(spec, sizes, pdeps, arrivals, rdeps, n_items, kinds,
                    items):
    """Per-item category constants (L, n_max) and per-event extra streams
    (L, E) of one policy family, on the CPU: pure functions of the
    (predicted) durations, computed once before the replay, in float32 as
    the reference computes them (``repro.core.jaxsim._category_setup``).
    Returns ``(consts, xs_extra)``; RCP's ``xs_extra`` is its running
    distinct-category count over the arrival events."""
    L, n_max, d = sizes.shape
    i32 = torch.int32
    if spec.family == "score":
        return {}, ()
    if arrivals is None or rdeps is None or n_items is None:
        raise ValueError(f"{spec.family} lanes need arrivals, rdeps and "
                         "n_items")
    pdur = pdeps - arrivals
    if spec.family == "cbd":
        return {"cat": duration_class_jnp(pdur, spec.beta)}, ()
    if spec.family == "cbdt":
        return {"cat": departure_window_jnp(pdeps, spec.rho)}, ()
    if spec.family == "hybrid":
        rdur = rdeps - arrivals
        real = torch.arange(n_max)[None, :] < n_items[:, None]
        min_dur = torch.where(real, rdur, torch.inf).amin(dim=1)
        z = dur_exponent_jnp(min_dur)
        jexp = dur_exponent_jnp(pdur)
        i = torch.clamp_min(jexp - z[:, None] + 1, 1)   # scaled index >= 1
        thr = hybrid_threshold_jnp(i)
        cls = torch.argmax(sizes, dim=2).to(i32) if spec.direct_sum \
            else torch.zeros((L, n_max), dtype=i32)
        win = torch.zeros((L, n_max), dtype=i32) if spec.reduced else \
            to_i32(torch.floor(arrivals / torch.ldexp(
                torch.ones_like(arrivals), jexp)))
        return {"key": _dense_key_ids(i, cls, win), "thr": thr,
                "cls": cls}, ()
    if spec.family == "rcp":
        rdur = rdeps - arrivals
        cat = torch.clamp(geo_class_jnp(torch.clamp_min(pdur, 0.0)), 0,
                          KCAT - 1)
        large = sizes.amax(dim=2) > 0.5
        p2err = pow2_ceiling_jnp(prediction_error_jnp(rdur, pdur))
        # x of the 1/sqrt(x) threshold: the running count of distinct
        # categories over the arrival events, a cumsum of first-arrival
        # flags over the whole event axis
        E = kinds.shape[1]
        is_arr = kinds == ARRIVAL_KIND
        ev_cat = cat.gather(1, items).long()
        eidx = torch.arange(E).expand(L, E)
        first = torch.full((L, KCAT), E, dtype=torch.int64).scatter_reduce(
            1, ev_cat, torch.where(is_arr, eidx, E), "amin")
        newflag = is_arr & (eidx == first.gather(1, ev_cat))
        xcount = torch.cumsum(newflag.to(torch.int64), dim=1).to(i32)
        return {"cat": cat, "large": large, "p2err": p2err}, (xcount,)
    if spec.family == "la":
        return {"cat": la_class_jnp(torch.clamp_min(pdur, 0.0),
                                    spec.la_mode)}, ()
    rdur = rdeps - arrivals
    return {"errmax": prediction_error_jnp(rdur, pdur)}, ()


def _cpu_inputs(sizes, times, kinds, items, pdeps, dmask, arrivals, rdeps,
                n_items):
    """The replay's inputs as CPU tensors: floats cast once to float32 (as
    the reference casts them), event kinds and items int32/int64."""
    def tens(a, dt):
        if a is None:
            return None
        if not torch.is_tensor(a):   # read-only arrays (e.g. from JAX) copy
            a = torch.from_numpy(np.require(np.asarray(a),
                                            requirements="W"))
        return a.to(device="cpu", dtype=dt)

    f32 = torch.float32
    return (tens(sizes, f32), tens(times, f32), tens(kinds, torch.int32),
            tens(items, torch.int64), tens(pdeps, f32), tens(dmask, f32),
            tens(arrivals, f32), tens(rdeps, f32),
            tens(n_items, torch.int64))


def replay_event_extras(policy, sizes, pdeps, dmask, arrivals, rdeps,
                        n_items, times, kinds, items):
    """The per-event extra inputs of one policy over the *full* event axis
    (a tuple of (L, E) int32 tensors, empty but for RCP/PPE's running
    distinct-category count), for a replay cut into segments: pass them as
    ``ev_extra`` to every segment, since the count must not restart."""
    spec = policy_spec(policy)
    sizes, times, kinds, items, pdeps, dmask, arrivals, rdeps, n_items = \
        _cpu_inputs(sizes, times, kinds, items, pdeps, dmask, arrivals,
                    rdeps, n_items)
    return _category_setup(spec, sizes, pdeps, arrivals, rdeps, n_items,
                           kinds, items)[1]


def _event_streams(policy, sizes, times, kinds, items, pdeps, dmask,
                   arrivals, rdeps, n_items, ev_extra):
    """The replay's per-event streams, on the CPU: ``ev_i`` (2 + ni, L, E)
    int32 and ``ev_f`` (2 + nf, L, E) f32 in the order of
    ``("kind", "item") + REPLAY_EV_I[fam]`` / ``("t", "pdep") +
    REPLAY_EV_F[fam]``, the items' sizes (L, E, DPAD), the dim mask
    (L, DPAD), the kernel family and the real dimension count."""
    spec = policy_spec(policy)
    fam = _KERNEL_FAMILY[spec.family]
    sizes, times, kinds, items, pdeps, dmask, arrivals, rdeps, n_items = \
        _cpu_inputs(sizes, times, kinds, items, pdeps, dmask, arrivals,
                    rdeps, n_items)
    L, n_max, d = sizes.shape
    select_pad_geometry(1, d)            # refuses d > DPAD
    consts, xs_extra = _category_setup(spec, sizes, pdeps, arrivals, rdeps,
                                       n_items, kinds, items)
    if ev_extra is not None:
        xs_extra = tuple(torch.as_tensor(np.asarray(x)) for x in ev_extra)

    def g(a):
        return a.gather(1, items)

    ints = {nm: xs_extra[0] if nm == "x" else g(consts[nm])
            for nm in REPLAY_EV_I[fam]}
    floats = {nm: g(consts[nm]) for nm in REPLAY_EV_F[fam]}
    ev_i, ev_f = fk.stack_event_streams(
        fam, dict(ints, kind=kinds, item=items),
        dict(floats, t=times, pdep=g(pdeps)))
    sizes_p = torch.zeros((L, n_max, DPAD), dtype=torch.float32)
    sizes_p[:, :, :d] = sizes
    dmask_p = torch.zeros((L, DPAD), dtype=torch.float32)
    dmask_p[:, :d] = 1.0 if dmask is None else dmask
    ev_size = sizes_p.gather(1, items[:, :, None].expand(-1, -1, DPAD))
    return ev_i, ev_f, ev_size, dmask_p, fam, d


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


def _category_state0(spec, L: int, item_rows: int, Np: int, device):
    """The fresh category state of one policy family: the reference's dict
    (``jaxsim._category_state0``) with the aggregates' d padded to DPAD."""
    f32, i32 = torch.float32, torch.int32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    if spec.family in ("score", "la"):
        return {}
    tag = full((L, Np), TAG_VIRGIN, i32)
    if spec.family in ("cbd", "cbdt"):
        return {"tag": tag}
    if spec.family == "hybrid":
        return {"tag": tag, "agg": full((L, item_rows, DPAD), 0.0, f32),
                "ingen": full((L, item_rows), False, torch.bool)}
    if spec.family == "rcp":
        return {"tag": tag,
                "agg_gen": full((L, KCAT, DPAD), 0.0, f32),
                "agg_cat": full((L, KCAT, DPAD), 0.0, f32),
                "agg_bcat": full((L, KCAT, DPAD), 0.0, f32),
                "agg_base": full((L, DPAD), 0.0, f32),
                "on": full((L, KCAT), False, torch.bool),
                "base": full((L,), -1, i32), "alpha": full((L,), 1.0, f32),
                "loc": full((L, item_rows), 0, i32)}
    return {"err": full((L,), 1.0, f32)}


_CARRY_DTYPES = (np.float32, np.int32, bool, np.int32, np.int32, np.float32,
                 np.float32, np.int32, np.float32, np.int32, np.int32, bool)
# category arrays whose last axis is the resource dimension
_CAT_DIM_KEYS = ("agg", "agg_gen", "agg_cat", "agg_bcat", "agg_base")


def _pad_dims(a: np.ndarray) -> np.ndarray:
    out = np.zeros(a.shape[:-1] + (DPAD,), np.float32)
    out[..., :a.shape[-1]] = a
    return out


def carry_from_reference(core, device="cuda", cat=None):
    """jaxsim's per-event carry -> this package's, on ``device``.

    ``core`` is the 12-tuple of ``_replay_batch(..., return_carry=True)``
    on the jnp backend (loads (L, max_bins, d)), ``cat`` its category dict.
    Returns the 12 core tensors as a list, with the category dict (the
    aggregates padded to DPAD) appended as a 13th entry when ``cat`` holds
    any state - the carry ``_replay_batch`` takes as ``carry0``."""
    device = resolve_device(device)
    out = []
    for k, (a, dt) in enumerate(zip(core, _CARRY_DTYPES)):
        a = np.asarray(a).astype(dt)
        if k == 0:
            a = _pad_dims(a)
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    if cat:
        out.append({k: torch.from_numpy(
            _pad_dims(np.asarray(v)) if k in _CAT_DIM_KEYS
            else np.array(v)).to(device) for k, v in cat.items()})
    return out


def carry_to_reference(carry, d: int):
    """This package's per-event carry -> jaxsim's: the core 12-tuple of
    numpy arrays (loads cut back to ``d`` columns) for a carry of 12
    entries, ``(core, cat)`` - the form jaxsim's ``carry0`` takes - for
    one that carries category state."""
    core = [a.cpu().numpy() for a in carry[:12]]
    core[0] = np.ascontiguousarray(core[0][:, :, :d])
    if len(carry) == 12:
        return tuple(core)
    cat = {k: np.ascontiguousarray(v.cpu().numpy()[..., :d])
           if k in _CAT_DIM_KEYS else v.cpu().numpy()
           for k, v in carry[12].items()}
    return tuple(core), cat


def packed_init_carry(fam: str, L: int, item_rows: int, max_bins: int,
                      device="cuda"):
    """A fresh packed carry of the event-blocked replay (the layout in
    ``kernels.fitscore``): slot closes at ``SCORE_NEG`` (virgin), tags
    ``TAG_VIRGIN``, placements -1, PPE alpha / adaptive err at 1.0, RCP
    base slot -1."""
    dev = resolve_device(device)
    f32, i32 = torch.float32, torch.int32

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    carry = {"loads": zeros((L, max_bins, DPAD), f32),
             "slotf": zeros((L, max_bins, fk.SLOTF_COLS), f32),
             "sloti": zeros((L, max_bins, fk.SLOTI_COLS), i32),
             "itemi": zeros((L, item_rows, fk.ITEMI_COLS), i32),
             "sf": zeros((L, fk.SF_COLS), f32),
             "si": zeros((L, fk.SI_COLS), i32)}
    carry["slotf"][:, :, fk.SLOTF_CLOSES] = NEG
    carry["sloti"][:, :, fk.SLOTI_TAG] = TAG_VIRGIN
    carry["itemi"][:, :, fk.ITEMI_PLACE] = -1
    carry["sf"][:, fk.SF_ALPHA] = 1.0
    carry["sf"][:, fk.SF_ERR] = 1.0
    carry["si"][:, fk.SI_BASE] = -1
    if fam == "hybrid":
        carry["hagg"] = zeros((L, item_rows, DPAD), f32)
    elif fam == "rcp":
        carry["ragg"] = zeros((L, fk.RAGG_ROWS, DPAD), f32)
        carry["ron"] = zeros((L, KCAT, fk.RON_COLS), i32)
    return carry


def make_live_carry(policy: str, max_bins: int, d: int,
                    max_items: int = 256, device="cuda"):
    """A fresh one-lane packed carry for an *open-ended* event stream: the
    serving front end's live fleet (``serving.dispatch.BlockDispatcher``),
    ``packed_init_carry`` at L=1 over ``max_bins`` slots and ``max_items``
    item rows, so ``kernels.ops.fitscore_replay_dispatch`` replays event
    blocks on it as the blocked sweep does.  Hybrid has no live form: its
    key table is built from the whole instance up front."""
    fam = _KERNEL_FAMILY[policy_spec(policy).family]
    if fam == "hybrid":
        raise ValueError(f"{policy!r} is clairvoyant-only (whole-instance "
                         "key table); no live serving carry")
    select_pad_geometry(max_bins, d)
    return packed_init_carry(fam, 1, max_items, max_bins, device)


def grow_live_carry(carry, max_bins: int, d: int):
    """A live carry with its slot axis padded to ``max_bins`` slots (the
    serving overflow rung).  The new slots are virgin (zero loads and
    counts, closes ``SCORE_NEG``, tags ``TAG_VIRGIN``), so a stream that
    did not overflow the old pool makes the same decisions on the grown
    one.  Returns ``carry`` itself when it already has the slots."""
    select_pad_geometry(max_bins, d)
    loads = carry["loads"]
    L, Np, _ = loads.shape
    if max_bins <= Np:
        return carry

    def wide(a, fill=None, col=None):
        tail = a.new_zeros((L, max_bins - Np) + a.shape[2:])
        if col is not None:
            tail[:, :, col] = fill
        return torch.cat([a, tail], dim=1)

    return dict(carry, loads=wide(loads),
                slotf=wide(carry["slotf"], NEG, fk.SLOTF_CLOSES),
                sloti=wide(carry["sloti"], TAG_VIRGIN, fk.SLOTI_TAG))


def grow_live_items(carry, max_items: int):
    """A packed carry with its item axis padded to ``max_items`` rows
    (placements -1, RCP's slot memo 0): fresh rows are virgin, so any
    stream that names them only after it assigns them replays the same.
    Returns ``carry`` itself when it already has the rows."""
    itemi = carry["itemi"]
    L, n, _ = itemi.shape
    if max_items <= n:
        return carry
    if "hagg" in carry:
        raise ValueError("grow_live_items: hybrid's key table is sized by "
                         "the whole instance and does not grow")
    tail = torch.zeros((L, max_items - n, fk.ITEMI_COLS), dtype=itemi.dtype,
                       device=itemi.device)
    tail[:, :, fk.ITEMI_PLACE] = -1
    return dict(carry, itemi=torch.cat([itemi, tail], dim=1))


def grow_item_rows(carry, item_rows: int):
    """Either carry of ``replay_init_carry`` with its item axis padded to
    ``item_rows`` rows: the packed dict through ``grow_live_items``, the
    per-event list by its placements (-1) and RCP's slot memo ``loc`` (0).
    Decisions are unchanged.  Hybrid's carry does not grow."""
    if isinstance(carry, dict):
        return grow_live_items(carry, item_rows)
    place = carry[7]
    L, n = place.shape
    if item_rows <= n:
        return carry
    out = list(carry)
    out[7] = torch.cat([place, place.new_full((L, item_rows - n), -1)], 1)
    if len(carry) > 12:
        cat = dict(carry[12])
        if "agg" in cat:
            raise ValueError("grow_item_rows: hybrid's key table is sized "
                             "by the whole instance and does not grow")
        if "loc" in cat:
            cat["loc"] = torch.cat(
                [cat["loc"], cat["loc"].new_zeros((L, item_rows - n))], 1)
        out[12] = cat
    return out


def replay_init_carry(policy: str, max_bins: int, d: int, item_rows: int,
                      *, L: int = 1, block_events: int = 0, device="cuda"):
    """The fresh carry ``_replay_batch`` starts from for this
    ``block_events``: the packed dict when it is > 1, else the per-event
    list (12 core tensors, plus the category dict for families that carry
    category state).  ``d`` is checked against DPAD."""
    spec = policy_spec(policy)
    select_pad_geometry(max_bins, d)
    if block_events and block_events > 1:
        return packed_init_carry(_KERNEL_FAMILY[spec.family], L, item_rows,
                                 max_bins, device)
    dev = resolve_device(device)
    carry = _core_state0(L, max_bins, item_rows, dev)
    cat = _category_state0(spec, L, item_rows, max_bins, dev)
    return carry + [cat] if cat else carry


# the reference's packed layout: d padded to 128 lanes, slots to a multiple
# of its 256-slot tile (repro/kernels/fitscore.py::select_pad_geometry)
def _reference_pad_geometry(n: int, d: int):
    dpad = max(128, -(-d // 128) * 128)
    bn = min(256, max(n, 8))
    return -(-n // bn) * bn, dpad


def packed_carry_from_reference(carry, d: int, max_bins: int,
                                device="cuda"):
    """The reference's packed carry (numpy or JAX arrays; loads (L, Np_ref,
    128) with rows >= ``max_bins`` layout padding) -> this package's
    (loads (L, max_bins, DPAD)) on ``device``.  ``d`` is the real
    dimension count; the columns past it are zero in both layouts."""
    dev = resolve_device(device)
    out = {}
    for k, v in carry.items():
        a = np.asarray(v)
        if k in ("loads", "slotf", "sloti"):
            a = a[:, :max_bins]
        if k in ("loads", "hagg", "ragg"):
            if np.any(a[..., d:]):
                raise ValueError(f"{k}: nonzero columns past d={d}")
            a = a[..., :DPAD]
        out[k] = torch.from_numpy(np.array(a)).to(dev)
    return out


def packed_carry_to_reference(carry, d: int):
    """This package's packed carry -> the reference's (numpy): d padded to
    128 lanes, slots to the reference's tiling with virgin rows (zero
    loads, ``SCORE_NEG`` closes, ``TAG_VIRGIN`` tags)."""
    Np = carry["loads"].shape[1]
    Np_ref, dpad = _reference_pad_geometry(Np, d)
    out = {}
    for k, v in carry.items():
        a = v.cpu().numpy()
        if k in ("loads", "hagg", "ragg"):
            w = np.zeros(a.shape[:-1] + (dpad,), a.dtype)
            w[..., :DPAD] = a
            a = w
        if k in ("loads", "slotf", "sloti") and Np_ref > Np:
            tail = np.zeros((a.shape[0], Np_ref - Np) + a.shape[2:], a.dtype)
            if k == "slotf":
                tail[:, :, fk.SLOTF_CLOSES] = NEG
            elif k == "sloti":
                tail[:, :, fk.SLOTI_TAG] = TAG_VIRGIN
            a = np.concatenate([a, tail], axis=1)
        out[k] = np.ascontiguousarray(a)
    return out


# ======================================================================
# The replay
# ======================================================================

def _resume(carry0, dev):
    """A private copy of a carry (the replay updates its carry in place)."""
    def own(a):
        return torch.as_tensor(a, device=dev).clone(
            memory_format=torch.contiguous_format)

    if isinstance(carry0, dict):
        return {k: own(v) for k, v in carry0.items()}
    out = [own(a) for a in carry0[:12]]
    if len(carry0) > 12:
        out.append({k: own(v) for k, v in carry0[12].items()})
    return out


def _replay_batch(sizes, times, kinds, items, pdeps, dmask, arrivals=None,
                  rdeps=None, n_items=None, *, policy: str, max_bins: int,
                  device="cuda", block_events: int = 0, carry0=None,
                  return_carry: bool = False, ev_extra=None,
                  migrate: bool = False, trace_level: int = 0):
    """``L`` lanes' event replays in lockstep, any ``SCAN_POLICIES`` name.

    sizes (L, n_max, d); times / kinds / items (L, E); pdeps (L, n_max)
    predicted departures; ``dmask`` (L, d) real-dimension mask or None;
    the category policies also read ``arrivals`` / ``rdeps`` (real
    departures) (L, n_max) and ``n_items`` (L,).  Numpy arrays or tensors;
    float64 inputs are cast once to float32.  Events with ``kind ==
    PAD_KIND`` leave the carry untouched.

    ``block_events=T > 1`` replays through the event-blocked megakernel
    (``_replay_batch_blocked``); otherwise a loop over the events whose
    step (``kernels.fitscore.replay_stepper``) selects with one or more
    calls of ``fitscore_select`` (the CUDA select on the card), replayed
    on the card in windows of ``STEP_WINDOW`` steps as CUDA graphs
    (``replay_windows``).

    Returns (usage (L,) f32, opened (L,) i32, placements (L, n_max) i32,
    overflow (L,) bool) as tensors on ``device``; with ``return_carry`` the
    final carry is appended.  ``carry0`` resumes from a carry (this
    package's layout for the path taken: see ``replay_init_carry``), and
    ``ev_extra`` gives the full event axis' extra streams
    (``replay_event_extras``) to a replay of a segment of it.

    ``migrate=True`` replays events with ``kind == MIGRATE_KIND``: the
    item's departure without the learning updates, then its re-placement
    with its source slot kept out of the select's feasibility (see
    ``kernels.fitscore.replay_stepper``).  Without it they are no-ops, as
    in the reference's megakernel.

    ``trace_level >= 1`` appends a fifth output, the per-event decision
    series as a dict of (L, E, ...) tensors on ``device`` (see
    ``traced_stepper``), and replays per event whatever ``block_events``
    says; ``trace_level=0`` is the untraced replay, unchanged.  A traced
    replay does not return its carry."""
    if trace_level and return_carry:
        raise ValueError("a traced replay does not return its carry")
    T = int(block_events) if block_events and block_events > 1 and \
        not trace_level else 0
    streams = event_streams(policy, sizes, times, kinds, items, pdeps, dmask,
                            arrivals, rdeps, n_items, ev_extra,
                            block_events=T)
    return replay_streams(*streams, policy=policy, max_bins=max_bins,
                          n_max=sizes.shape[1], device=device,
                          block_events=T, carry0=carry0,
                          return_carry=return_carry, migrate=migrate,
                          trace_level=trace_level)


def event_streams(policy, sizes, times, kinds, items, pdeps, dmask,
                  arrivals=None, rdeps=None, n_items=None, ev_extra=None, *,
                  block_events: int = 0):
    """The host half of ``_replay_batch`` (same arguments): the replay's
    per-event streams on the CPU, ``(ev_i, ev_f, ev_size, dmask_p, d)`` as
    ``_event_streams`` builds them, padded with PAD events to a multiple of
    ``block_events`` when it is > 1.  ``replay_streams`` replays them, on
    the CPU or from copies on the card."""
    ev_i, ev_f, ev_size, dmask_p, _fam, d = _event_streams(
        policy, sizes, times, kinds, items, pdeps, dmask, arrivals, rdeps,
        n_items, ev_extra)
    T = int(block_events)
    pad = (-ev_size.shape[1]) % T if T > 1 else 0
    if pad:
        L = ev_size.shape[0]
        fill_i = torch.zeros((ev_i.shape[0], L, pad), dtype=torch.int32)
        fill_i[0] = PAD_KIND
        ev_i = torch.cat([ev_i, fill_i], dim=2)
        ev_f = torch.cat([ev_f, ev_f.new_zeros(ev_f.shape[:2] + (pad,))],
                         dim=2)
        ev_size = torch.cat([ev_size, ev_size.new_zeros((L, pad, DPAD))],
                            dim=1)
    return ev_i, ev_f, ev_size, dmask_p, d


def replay_streams(ev_i, ev_f, ev_size, dmask_p, d: int, *, policy: str,
                   max_bins: int, n_max: int, device="cuda",
                   block_events: int = 0, carry0=None,
                   return_carry: bool = False, migrate: bool = False,
                   trace_level: int = 0):
    """The device half of ``_replay_batch``: the replay of streams that
    ``event_streams`` built (on the CPU or already copied to ``device``;
    with ``block_events > 1`` padded to its multiple) over ``n_max`` item
    rows, per event or, for ``block_events > 1``, blocked.  Returns what
    ``_replay_batch`` returns."""
    if block_events and block_events > 1 and not trace_level:
        return _replay_batch_blocked(
            ev_i, ev_f, ev_size, dmask_p, d, policy=policy,
            max_bins=max_bins, n_max=n_max, device=device,
            block_events=block_events, carry0=carry0,
            return_carry=return_carry, migrate=migrate)
    spec = policy_spec(policy)
    fam = _KERNEL_FAMILY[spec.family]
    dev = resolve_device(device)
    L = ev_size.shape[0]
    # event-major streams on the device: each step reads one row of each
    ev_kind = ev_i[0].T.to(dev)
    ev_arr = (ev_kind == ARRIVAL_KIND).contiguous()
    ev_dep = (ev_kind == DEPARTURE_KIND).contiguous()
    ev_mig = (ev_kind == MIGRATE_KIND).contiguous() if migrate else None
    ev_item = ev_i[1].T.to(device=dev, dtype=torch.int64).contiguous()
    ev_t = ev_f[0].T.contiguous().to(dev)
    ev_pdep = ev_f[1].T.contiguous().to(dev)
    ev_sz = ev_size.transpose(0, 1).contiguous().to(dev)     # (E, L, DPAD)
    ev_ex = {nm: v.T.contiguous().to(dev)
             for nm, v in fk.event_extras(fam, ev_i, ev_f).items()}
    dmask_p = dmask_p.to(dev)

    if carry0 is None:
        carry = _core_state0(L, max_bins, n_max, dev)
        cat = _category_state0(spec, L, n_max, max_bins, dev)
    else:
        carry = _resume(carry0, dev)
        cat = carry.pop() if len(carry) > 12 else {}
    S = dict(zip(fk.CORE_NAMES, carry), **cat)
    step = fk.replay_stepper(
        fam, policy if fam == "score" else "first_fit", L=L, Np=max_bins,
        R=n_max, d=d, dmask=dmask_p, select=fitscore_select,
        large_bins=spec.large_bins, adaptive_alpha=spec.adaptive_alpha,
        direct_sum=spec.direct_sum, la_mode=spec.la_mode, low=spec.low,
        high=spec.high)
    ev = {"t": ev_t, "arr": ev_arr, "dep": ev_dep, "item": ev_item,
          "size": ev_sz, "pdep": ev_pdep}
    if ev_mig is not None:
        ev["mig"] = ev_mig
    trace = None
    if trace_level:
        step, trace = traced_stepper(step, S, ev_t.shape[0], d, trace_level)
        ev_ex = dict(ev_ex, trace_pad=(ev_kind == PAD_KIND).contiguous())
    _run_events(step, S, ev, ev_ex, dev)
    counters["scan_steps"] += ev_t.shape[0]

    out = (S["usage"], S["opened"], S["placements"], S["overflow"])
    if trace is not None:
        return out + (trace,)
    if return_carry:
        carry = [S[nm] for nm in fk.CORE_NAMES]
        if cat:
            carry.append({k: S[k] for k in cat})
        return out + (carry,)
    return out


def traced_stepper(step, S, E: int, d: int, trace_level: int = 1):
    """``step`` wrapped to record each event's post-event state, the
    reference's trace series (``repro.core.jaxsim._replay_batch``):

    * ``slot`` (L, E) int32: the slot an arrival chose, the slot a
      departure (or a MIGRATE event) left; -1 on PAD events;
    * ``open_bins`` (L, E) int32: open slots after the event;
    * ``load`` (L, E, d) f32: the aggregate load over all slots;
    * ``tag`` (L, E) int32: the touched slot's category tag (-1 for the
      families without tags, and on PAD events);
    * ``usage`` (L, E) f32: the running usage;
    * ``alive`` (L, E, Np) bool, at ``trace_level >= 2``.

    The tensors are allocated here, before the loop, on the carry's
    device, and written at a step counter held on that device, so a CUDA
    graph of a window of traced steps records the writes and each replay
    of it fills the next window's columns.  The wrapped step reads PAD
    events from its extra stream ``trace_pad`` (L,) bool.  Returns
    ``(traced_step, trace)``."""
    place = S["placements"]
    L, Np = S["alive"].shape
    dev = place.device
    i32 = torch.int32

    def new(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    trace = {"slot": new((L, E), i32), "open_bins": new((L, E), i32),
             "load": new((L, E, d), torch.float32), "tag": new((L, E), i32),
             "usage": new((L, E), torch.float32)}
    if trace_level >= 2:
        trace["alive"] = new((L, E, Np), torch.bool)
    at = new((1,), torch.int64)
    none = torch.full((L,), -1, dtype=i32, device=dev)

    def traced(S, t, is_arr, is_dep, j, size, pdep, ex, is_mig=None):
        src = place.gather(1, j[:, None])[:, 0]
        step(S, t, is_arr, is_dep, j, size, pdep, ex, is_mig)
        dst = place.gather(1, j[:, None])[:, 0]
        slot = torch.where(ex["trace_pad"], none,
                           torch.where(is_arr, dst, src))
        if "tag" in S:
            tag = S["tag"].gather(1, slot.clamp_min(0)[:, None])[:, 0]
            tag = torch.where(slot >= 0, tag, none)
        else:
            tag = none
        row = {"slot": slot, "open_bins": S["alive"].sum(dim=1, dtype=i32),
               "load": S["loads"].sum(dim=1)[:, :d], "tag": tag,
               "usage": S["usage"]}
        if trace_level >= 2:
            row["alive"] = S["alive"]
        for nm, v in row.items():
            trace[nm].index_copy_(1, at, v.unsqueeze(1))
        at.add_(1)

    return traced, trace


def run_steps(step, S, ev, ex, lo: int, hi: int) -> None:
    """Steps ``lo`` to ``hi - 1`` of the per-event replay on the unpacked
    carry ``S``: ``ev`` holds the event-major streams (``t``, ``arr``,
    ``dep``, ``item``, ``size``, ``pdep`` and, for a replay with
    ``migrate``, ``mig``; (E, L, ...) each), ``ex`` the family's extra
    streams by name; step ``e`` reads row ``e`` of each."""
    mig = ev.get("mig")
    for e in range(lo, hi):
        step(S, ev["t"][e], ev["arr"][e], ev["dep"][e], ev["item"][e],
             ev["size"][e], ev["pdep"][e], {nm: v[e] for nm, v in ex.items()},
             None if mig is None else mig[e])


def step_windows(E: int, K: int):
    """The schedule of ``replay_windows`` for ``E`` events in windows of
    ``K`` steps, a pure function of the shape: ``(start, stop, how)`` in
    event order, covering every event once.  ``how`` is "warm" (the first
    window, run eagerly through the window body), "capture" (the second,
    captured into a CUDA graph, then replayed), "replay" (a replay of that
    graph) or "eager" (the steps as they stand: the tail of fewer than
    ``K`` events, or a whole call of fewer than ``2 K``)."""
    if K < 1:
        raise ValueError(f"step_windows: a window of {K} steps")
    if E < 2 * K:
        return [(0, E, "eager")] if E > 0 else []
    n = E // K
    out = [(0, K, "warm"), (K, 2 * K, "capture")]
    out += [(w * K, (w + 1) * K, "replay") for w in range(2, n)]
    if E % K:
        out.append((n * K, E, "eager"))
    return out


def window_body(step, S, buf, bex, K: int) -> None:
    """One window: ``K`` steps reading rows 0 to ``K - 1`` of the static
    window buffers ``buf`` / ``bex`` (``run_steps``' layout), then every
    carry entry the steps replaced (the step updates the slot state in
    place and replaces the rest: usage, overflow, opened, seq, adaptive's
    err, RCP's aggregates, flags and base) copied back into the tensor the
    window's first step read.  So ``S`` ends holding the tensors it began
    with, and a CUDA graph of the body, which reads the addresses it
    captured, starts each replay from the state the last one left."""
    start = dict(S)
    run_steps(step, S, buf, bex, 0, K)
    for nm, v in S.items():
        if v is not start[nm]:
            start[nm].copy_(v)
            S[nm] = start[nm]


class _Graph:
    """A CUDA graph of one window body, captured on a side stream: the
    capture runs nothing on the device.  ``replay`` launches it on the
    current stream, ``reset`` releases it and its private memory pool.
    (Not ``torch.cuda.graph``, which also collects garbage and empties the
    allocator's cache at each capture; a replay with an overflow ladder or
    a segmented one captures once a call.)"""

    def __init__(self, body, dev):
        self.graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.graph.capture_begin()
            try:
                body()
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)

    def replay(self):
        self.graph.replay()

    def reset(self):
        self.graph.reset()


def replay_windows(step, S, ev, ex, K: int) -> None:
    """The per-event replay of all ``E`` events of ``ev`` / ``ex``
    (``run_steps``' layout) in windows of ``K`` steps, on the schedule of
    ``step_windows``: each window's rows go into static window buffers (one
    copy a stream), then ``window_body`` runs on them.  The first window
    runs eagerly, the second is captured into one CUDA graph (``_Graph``)
    and every later full window is a replay of it.  The result is the eager
    loop's, bit for bit: the same kernels on the same data.

    A capture runs nothing, so the launches that the steps count while it
    records them (``kernels.ops.launches``) are taken back and added once a
    replay instead; ``launches["replay_step_graph"]`` counts the replays,
    ``launches["replay_step_capture"]`` the captures.  A failed capture or
    replay raises.  The graph and its memory pool are released before the
    function returns."""
    E = ev["t"].shape[0]
    sched = step_windows(E, K)
    if E < 2 * K:   # one eager piece: no window buffers
        run_steps(step, S, ev, ex, 0, E)
        return
    buf = {nm: v.new_empty((K,) + v.shape[1:]) for nm, v in ev.items()}
    bex = {nm: v.new_empty((K,) + v.shape[1:]) for nm, v in ex.items()}
    graph, delta = None, collections.Counter()
    try:
        for lo, hi, how in sched:
            if how == "eager":
                run_steps(step, S, ev, ex, lo, hi)
                continue
            for b, src in ((buf, ev), (bex, ex)):
                for nm, v in b.items():
                    v.copy_(src[nm][lo:hi])
            if how == "warm":
                window_body(step, S, buf, bex, K)
                continue
            if how == "capture":
                before = collections.Counter(launches)
                graph = _Graph(lambda: window_body(step, S, buf, bex, K),
                               ev["t"].device)
                delta = launches - before
                launches.clear()
                launches.update(before)
                launches["replay_step_capture"] += 1
            graph.replay()
            launches.update(delta)
            launches["replay_step_graph"] += 1
    finally:
        if graph is not None:
            graph.reset()


def _run_events(step, S, ev, ex, dev) -> None:
    """The per-event loop over every event of ``ev``: windows of
    ``STEP_WINDOW`` steps replayed as CUDA graphs on the card, the plain
    loop on the CPU."""
    if dev.type == "cuda":
        replay_windows(step, S, ev, ex, STEP_WINDOW)
    else:
        run_steps(step, S, ev, ex, 0, ev["t"].shape[0])


def replay_block_kwargs(policy: str, max_bins: int, d: int) -> dict:
    """The keyword arguments of ``kernels.ops.fitscore_replay_block`` (and
    ``replay_block_ref``) for one policy on a ``max_bins``-slot, ``d``-dim
    pool."""
    spec = policy_spec(policy)
    fam = _KERNEL_FAMILY[spec.family]
    return dict(family=fam, policy=policy if fam == "score" else "first_fit",
                n=max_bins, d=d, large_bins=spec.large_bins,
                adaptive_alpha=spec.adaptive_alpha,
                direct_sum=spec.direct_sum, la_mode=spec.la_mode,
                la_split=LA_BINARY_SPLIT, low=spec.low, high=spec.high)


def _replay_batch_blocked(ev_i, ev_f, ev_size, dmask_p, d: int, *,
                          policy: str, max_bins: int, n_max: int, device,
                          block_events: int, carry0=None,
                          return_carry: bool = False, migrate: bool = False):
    """Event-blocked replay of ``event_streams``' streams (padded to a
    multiple of ``T``): a host loop over blocks of ``T`` events, each
    block replayed by one launch of the megakernel
    (``kernels.ops.fitscore_replay_block``; its plain version on the CPU)
    with the packed carry on the device.  Decision for decision the
    per-event replay's."""
    spec = policy_spec(policy)
    fam = _KERNEL_FAMILY[spec.family]
    dev = resolve_device(device)
    L = ev_size.shape[0]
    T = int(block_events)
    NB = ev_size.shape[1] // T
    carry = packed_init_carry(fam, L, n_max, max_bins, dev) \
        if carry0 is None else _resume(carry0, dev)
    replay_chunk(carry, ev_i.to(dev), ev_f.to(dev), ev_size.to(dev),
                 dmask_p.to(dev), block_events=T, migrate=migrate,
                 **replay_block_kwargs(policy, max_bins, d))
    counters["replay_blocks"] += NB
    out = (carry["sf"][:, fk.SF_USAGE].clone(),
           carry["si"][:, fk.SI_OPENED].clone(),
           carry["itemi"][:, :, fk.ITEMI_PLACE].clone(),
           carry["si"][:, fk.SI_OVERFLOW] > 0)
    return out + (carry,) if return_carry else out


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
             max_bins_cap: int = MAX_BINS_CAP, device="cuda",
             block_events: int = 0) -> TorchSimResult:
    """Replay one instance (any ``SCAN_POLICIES`` policy).  If the slot
    pool overflows and ``auto_grow`` is set, retry with a doubled
    ``max_bins`` (up to ``max_bins_cap``, then ``CapacityError``).
    ``block_events > 1`` replays through the event-blocked megakernel; it
    never changes the result."""
    if not known_policy(policy):
        raise KeyError(f"{policy!r} is not a scan policy; known: "
                       f"{SCAN_POLICIES}")
    pdeps = inst.departures if predicted_durations is None \
        else inst.arrivals + predicted_durations
    times, kinds, items = event_sequence(inst)
    while True:
        usage, opened, placements, overflow = _replay_batch(
            inst.sizes[None], times[None], kinds[None], items[None],
            pdeps[None], None, inst.arrivals[None], inst.departures[None],
            np.array([inst.n_items]), policy=policy, max_bins=max_bins,
            device=device, block_events=block_events)
        if not bool(overflow[0]) or not auto_grow:
            break
        if max_bins >= max_bins_cap:
            raise CapacityError(
                f"slot pool exhausted replaying {inst.name!r} with "
                f"{policy!r}: still overflowing at max_bins={max_bins} "
                f"(cap {max_bins_cap}; raise REPRO_MAX_BINS_CAP or pass "
                f"a larger max_bins_cap)",
                policy=policy, max_bins=max_bins, instance=inst.name)
        obs.counter_add("sweep.overflow_rungs")
        max_bins = grow_max_bins(max_bins, max_bins_cap)
    return TorchSimResult(float(usage[0]), int(opened[0]),
                          placements[0].cpu().numpy(), bool(overflow[0]),
                          max_bins)
