"""The sequential consolidating host oracle; the port's
``repro.consolidate.oracle``.

``core.engine.run`` replays one instance under one ``Algorithm``;
``run_consolidating`` is its consolidation-aware twin and the parity
reference for ``consolidate.consolidated_replay``: it walks the
exact event order the replay sees (``core.torchsim.event_sequence``), runs
the SAME planner on the same cadence, and applies each migration as a
removal (``on_migrated_out`` - no learning observation) followed by a
policy re-place with the source bin masked infeasible for the select.

Category policies re-categorize a migrant from its *original* arrival
clock (``types.MigrantArrival``): an item's duration class was fixed at
first arrival, mirroring the replay's per-item category constants.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.bins import BinPool
from ..core.torchsim import event_sequence
from ..core.types import Arrival, Instance, MigrantArrival, PackingResult
from ..kernels.fitscore import ARRIVAL_KIND, DEPARTURE_KIND
from .planner import plan_migrations, should_plan
from .spec import ConsolidationSpec


def run_consolidating(instance: Instance, algorithm,
                      spec: ConsolidationSpec,
                      predicted_durations: Optional[np.ndarray] = None,
                      clairvoyant: Optional[bool] = None):
    """Replay ``instance`` under ``algorithm`` with consolidation.

    Returns ``(PackingResult, stats)``; ``stats`` mirrors
    ``consolidated_replay``'s:
    ``migrations``, ``bins_closed``, ``budget_exhausted``,
    ``migration_cost`` and the emitted ``events`` (``(t, item)`` pairs in
    emission order).  With ``spec.kind == "none"`` the replay is exactly
    ``core.engine.run`` (the planner never fires).
    """
    inst = instance
    n = inst.n_items
    reveal = algorithm.requires_predictions if clairvoyant is None \
        else clairvoyant
    if predicted_durations is not None:
        pdeps = inst.arrivals + predicted_durations
        reveal = True
    else:
        pdeps = inst.departures

    pool = BinPool(inst.d)
    algorithm.bind(pool, inst)

    placements = np.full(n, -1, np.int64)
    opened_at: Dict[int, float] = {}
    usage = 0.0
    span = 0.0
    span_start: Optional[float] = None
    peak_open = 0
    live: Dict[int, int] = {}          # item -> current bin
    events: List[Tuple[float, int]] = []
    bins_closed = 0
    budget_exh = 0
    budget_left = spec.budget          # < 0 = unlimited
    t_next = 0.0

    def remove_item(item: int, idx: int, t: float, migrated: bool):
        nonlocal usage, span, span_start
        size = inst.sizes[item]
        pool.remove(idx, size)
        if migrated:
            algorithm.on_migrated_out(item, idx, t, size)
        else:
            algorithm.on_departed(item, idx, t, size)
        if pool.n_active[idx] == 0:
            usage += t - opened_at.pop(idx)
            pool.close_bin(idx)
            algorithm.on_closed(idx, t)
            if not pool._open_list:
                span += t - span_start
                span_start = None

    def place_item(item: int, arr: Arrival, excl: Optional[int] = None):
        nonlocal span_start, peak_open
        saved = None
        if excl is not None and pool.alive[excl]:
            # the select must not re-pick the migration source: mask it
            # infeasible for the duration of the decision (the replay's
            # slot-exclusion twin)
            saved = pool.used[excl].copy()
            pool.used[excl] = 2.0
        idx = algorithm.select_bin(arr)
        if saved is not None:
            pool.used[excl] = saved
        opened = idx < 0
        if opened:
            if span_start is None and not pool._open_list:
                span_start = arr.now
            idx = pool.open_bin(arr.now)
            opened_at[idx] = arr.now
        else:
            assert pool.alive[idx], f"algorithm chose closed bin {idx}"
            assert idx != excl, "select returned the migration source"
        pool.place(idx, arr.size, float(pdeps[item]), arr.now)
        algorithm.on_placed(arr, idx, opened)
        placements[item] = idx
        live[item] = idx
        peak_open = max(peak_open, len(pool._open_list))

    times, kinds, items = event_sequence(inst)
    E = len(times)
    K = int(spec.every)
    for e in range(E):
        t, kind, item = float(times[e]), int(kinds[e]), int(items[e])
        if kind == DEPARTURE_KIND:
            remove_item(item, live.pop(item), t, migrated=False)
        else:
            assert kind == ARRIVAL_KIND
            place_item(item, Arrival(item, inst.sizes[item], t,
                                     float(pdeps[item]) if reveal else None))
        # planning boundary: the cadence of consolidated_replay's chunks
        if not spec.enabled or (e + 1) % K or e + 1 >= E:
            continue
        run, t_next = should_plan(spec, t, t_next)
        if not run or not live:
            continue
        nb = pool.n_bins
        bin_items: Dict[int, List[int]] = {}
        for it in sorted(live):
            bin_items.setdefault(live[it], []).append(it)
        plan = plan_migrations(
            pool.used[:nb], pool.n_active[:nb], pool.alive[:nb],
            pool.open_seq[:nb], bin_items, inst.sizes,
            threshold=spec.threshold, budget=budget_left)
        bins_closed += plan.bins_closed
        budget_exh += plan.budget_exhausted
        if budget_left >= 0:
            budget_left -= len(plan.items)
        for it in plan.items:
            src = live.pop(it)
            remove_item(it, src, t, migrated=True)
            place_item(
                it, MigrantArrival(it, inst.sizes[it], t,
                                   float(pdeps[it]) if reveal else None,
                                   orig_now=float(inst.arrivals[it])),
                excl=src)
            events.append((t, it))

    assert not pool._open_list, "all bins must close once every item departed"
    result = PackingResult(
        usage_time=usage, n_bins_opened=pool.n_bins,
        peak_open_bins=peak_open, placements=placements,
        algorithm=algorithm.name, instance=inst.name, span=span)
    stats = {"migrations": len(events), "bins_closed": bins_closed,
             "budget_exhausted": budget_exh,
             "migration_cost": spec.cost * len(events), "events": events}
    return result, stats
