"""Chunked batched replay with interleaved consolidation planning;
counterpart of ``repro.consolidate.driver``.

The replay cannot decide migrations itself - the planner needs a global
look at the pool (which bins are nearly empty, where their items could
go) - so the driver alternates device and host:

    [K-event replay chunk] -> host planner on the carry -> [MIGRATE chunk]
        -> [next K-event chunk] -> ...

Each chunk threads the replay carry (``torchsim._replay_batch(...,
carry0=, return_carry=True)``), per event or event-blocked as
``block_events`` says; MIGRATE chunks replay with ``migrate=True`` (the
megakernel's MIGRATE branch), the base chunks without it.  PAD no-ops make
ragged per-lane migration counts rectangular, as the tail padding of the
base stream does.

The planner input is the carry itself (loads / counts / alive / open_seq /
item placements), copied to the host and viewed in float64 - the snapshot
the JAX package's driver and its sequential oracle take, so with
fp32-exact instances the three emit identical MIGRATE events.

The whole replay is one ``consolidate.replay`` span, each planning
boundary a ``consolidate.plan`` instant, and the churn also lands in the
counters ``consolidate.migrations``, ``consolidate.bins_closed`` and
``consolidate.budget_exhausted`` (``repro_torch.obs``), as in the
reference.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import obs
from ..core.torchsim import _replay_batch, replay_event_extras
from ..kernels import fitscore as fk
from ..kernels.fitscore import (ARRIVAL_KIND, DEPARTURE_KIND, MIGRATE_KIND,
                                PAD_KIND)
from .planner import plan_migrations, should_plan
from .spec import ConsolidationSpec

# MIGRATE chunk widths round up to a multiple of this (PAD-filled): the
# reference's width buckets, kept so both replay the same event streams.
_MIG_PAD = 8


def _host(a, dtype) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.cpu().numpy()
    return np.asarray(a).astype(dtype, copy=False)


def _pool_view(carry, d: int) -> Dict[str, np.ndarray]:
    """Planner-facing float64 view of either replay carry: the packed dict
    of the event-blocked path or the per-event list (12 core tensors, then
    the category dict), copied to the host."""
    if isinstance(carry, dict):
        sloti = carry["sloti"].cpu().numpy()
        return {"loads": carry["loads"][..., :d].cpu().numpy()
                .astype(np.float64),
                "counts": sloti[..., fk.SLOTI_COUNTS],
                "alive": sloti[..., fk.SLOTI_ALIVE] > 0,
                "open_seq": sloti[..., fk.SLOTI_OSEQ],
                "placements": carry["itemi"][..., fk.ITEMI_PLACE]
                .cpu().numpy()}
    return {"loads": carry[0][..., :d].cpu().numpy().astype(np.float64),
            "counts": carry[1].cpu().numpy(),
            "alive": carry[2].cpu().numpy(),
            "open_seq": carry[3].cpu().numpy(),
            "placements": carry[7].cpu().numpy()}


def consolidated_replay(sizes, times, kinds, items, pdeps, dmask,
                        arrivals, rdeps, n_items, *, policy: str,
                        max_bins: int, device="cuda", block_events: int = 0,
                        spec: ConsolidationSpec):
    """Batched replay of ``L`` lanes with consolidation interleaved.

    Same array contract as ``torchsim._replay_batch`` (numpy arrays or
    tensors); returns ``(usage, opened, placements, overflow, stats)``,
    the first four as tensors on ``device``, where ``stats`` holds per-lane
    churn: ``migrations``, ``bins_closed``, ``budget_exhausted``,
    ``migration_cost`` and the emitted ``events`` (per lane, ``(t, item)``
    in emission order)."""
    if not spec.enabled:
        raise ValueError("consolidated_replay needs an enabled spec; "
                         "disabled runs go straight through _replay_batch")
    # the host's view of the inputs as the replay sees them: float32
    sizes64 = _host(sizes, np.float32).astype(np.float64)
    L, R, d = sizes64.shape
    times32 = _host(times, np.float32)
    times64 = times32.astype(np.float64)
    kinds_np = _host(kinds, np.int32)
    items_np = _host(items, np.int64)
    E = times32.shape[1]
    K = int(spec.every)

    # full-event-axis per-event extras (RCP's distinct-category count must
    # span chunks)
    extras = replay_event_extras(policy, sizes, pdeps, dmask, arrivals,
                                 rdeps, n_items, times, kinds, items)
    base = (pdeps, dmask, arrivals, rdeps, n_items)

    def segment(t, k, it, carry, ex, migrate):
        return _replay_batch(sizes, t, k, it, *base, policy=policy,
                             max_bins=max_bins, device=device,
                             block_events=block_events, carry0=carry,
                             return_carry=True,
                             ev_extra=ex if extras else None,
                             migrate=migrate)

    live = np.zeros((L, R), bool)
    last_t = np.zeros(L)
    budget_left = np.full(L, spec.budget, np.int64)
    t_next = np.zeros(L)
    migrations = np.zeros(L, np.int64)
    bins_closed = np.zeros(L, np.int64)
    budget_exh = np.zeros(L, np.int64)
    events: List[List] = [[] for _ in range(L)]

    carry = None
    out = None
    with obs.span("consolidate.replay", cat="consolidate", policy=policy,
                  spec=spec.canonical(), lanes=L):
        for s in range(0, E, K):
            e = min(s + K, E)
            out = segment(times32[:, s:e], kinds_np[:, s:e], items_np[:, s:e],
                          carry, tuple(x[:, s:e] for x in extras), False)
            carry = out[4]
            # host aliveness and lane clocks from the chunk's events: an item's
            # last arrival or departure in the chunk decides whether it lives
            k = kinds_np[:, s:e]
            real = (k == ARRIVAL_KIND) | (k == DEPARTURE_KIND)
            ln, col = np.nonzero(real)                  # lane-major, in order
            key = ln * R + items_np[:, s:e][ln, col]
            uk, from_end = np.unique(key[::-1], return_index=True)
            at = len(key) - 1 - from_end                # each key's last event
            live.flat[uk] = k[ln[at], col[at]] == ARRIVAL_KIND
            last = np.where(real, np.arange(s, e), -1).max(axis=1)
            has = last >= 0
            last_t[has] = times64[has, last[has]]
            if e >= E:
                break   # never plan after the final chunk
            view = _pool_view(carry, d)
            plans: List[List[int]] = []
            for lane in range(L):
                run, t_next[lane] = should_plan(
                    spec, float(last_t[lane]), float(t_next[lane]))
                members = np.flatnonzero(live[lane])
                if not run or not len(members):
                    plans.append([])
                    continue
                place = view["placements"][lane, members]
                order = np.argsort(place, kind="stable")
                rows, starts = np.unique(place[order], return_index=True)
                bin_items = {int(r): members[order[a:b]].tolist()
                             for r, a, b in zip(rows, starts,
                                                list(starts[1:]) +
                                                [len(order)])}
                plan = plan_migrations(
                    view["loads"][lane], view["counts"][lane],
                    view["alive"][lane], view["open_seq"][lane], bin_items,
                    sizes64[lane], threshold=spec.threshold,
                    budget=int(budget_left[lane]))
                bins_closed[lane] += plan.bins_closed
                budget_exh[lane] += plan.budget_exhausted
                migrations[lane] += len(plan.items)
                if budget_left[lane] >= 0:
                    budget_left[lane] -= len(plan.items)
                events[lane].extend(
                    (float(last_t[lane]), it) for it in plan.items)
                plans.append(plan.items)
            w = max(len(p) for p in plans)
            if not w:
                continue
            wp = -(-w // _MIG_PAD) * _MIG_PAD
            m_times = np.repeat(last_t[:, None], wp, axis=1).astype(np.float32)
            m_kinds = np.full((L, wp), PAD_KIND, np.int32)
            m_items = np.zeros((L, wp), np.int64)
            for lane, p in enumerate(plans):
                m_kinds[lane, :len(p)] = MIGRATE_KIND
                m_items[lane, :len(p)] = p
            # extras at a migrate boundary: the running value as of the
            # chunk's last event (MIGRATE events never advance them)
            m_ex = tuple(x[:, e - 1:e].repeat(1, wp) for x in extras)
            out = segment(m_times, m_kinds, m_items, carry, m_ex, True)
            carry = out[4]
            obs.instant("consolidate.plan", chunk_end=int(e),
                        migrations=int(sum(len(p) for p in plans)),
                        bins_closed=int(bins_closed.sum()))
    obs.counter_add("consolidate.migrations", int(migrations.sum()))
    obs.counter_add("consolidate.bins_closed", int(bins_closed.sum()))
    obs.counter_add("consolidate.budget_exhausted", int(budget_exh.sum()))
    usage, opened, placements, overflow = out[:4]
    stats = {"migrations": migrations, "bins_closed": bins_closed,
             "budget_exhausted": budget_exh,
             "migration_cost": spec.cost * migrations.astype(np.float64),
             "events": events}
    return usage, opened, placements, overflow, stats
