"""Event-driven oracle simulator for MinUsageTime DVBP.

This is the exact reference engine: a heap-driven replay of one instance under
one online packing algorithm.  It owns bin state (``BinPool``), drives real
arrivals/departures, accounts accumulated bin usage time, and verifies the
capacity invariant after every placement.

Departures at time t are processed before arrivals at time t because item
intervals are half-open [arrival, departure).  Pure float64 numpy; the
port's copy of ``repro.core.engine``, and the oracle the batched replay
(``core.torchsim``) is held to on fp32-exact instances.
"""
from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

from .bins import BinPool
from .types import Arrival, Instance, PackingResult


def run(instance: Instance, algorithm, predicted_durations: Optional[np.ndarray] = None,
        clairvoyant: Optional[bool] = None) -> PackingResult:
    """Replay ``instance`` under ``algorithm``.

    predicted_durations:
      * None and algorithm.requires_predictions  -> clairvoyant (pdep = real)
      * None otherwise                           -> non-clairvoyant (pdep hidden)
      * array (n,)                               -> learning-augmented
    ``clairvoyant`` forces pdep visibility regardless of the algorithm flag.
    """
    inst = instance
    n = inst.n_items
    reveal = algorithm.requires_predictions if clairvoyant is None else clairvoyant
    if predicted_durations is not None:
        pdeps = inst.arrivals + predicted_durations
        reveal = True
    else:
        pdeps = inst.departures  # perfect predictions == clairvoyant

    pool = BinPool(inst.d)
    algorithm.bind(pool, inst)

    placements = np.full(n, -1, np.int64)
    opened_at = {}
    usage = 0.0
    span = 0.0
    span_start = None
    peak_open = 0
    heap = []  # (real departure, tiebreak, item idx, bin idx)
    i = 0
    while i < n or heap:
        next_arr = inst.arrivals[i] if i < n else np.inf
        if heap and heap[0][0] <= next_arr:
            t, _, item, idx = heapq.heappop(heap)
            pool.remove(idx, inst.sizes[item])
            algorithm.on_departed(item, idx, t, inst.sizes[item])
            if pool.n_active[idx] == 0:
                usage += t - opened_at.pop(idx)
                pool.close_bin(idx)
                algorithm.on_closed(idx, t)
                if not pool._open_list:
                    span += t - span_start
                    span_start = None
            continue
        # --- arrival of item i
        now = float(inst.arrivals[i])
        arr = Arrival(i, inst.sizes[i], now, float(pdeps[i]) if reveal else None)
        idx = algorithm.select_bin(arr)
        opened = idx < 0
        if opened:
            if span_start is None and not pool._open_list:
                span_start = now
            idx = pool.open_bin(now)
            opened_at[idx] = now
        else:
            assert pool.alive[idx], f"algorithm chose closed bin {idx}"
        # indicated_close is always maintained from the prediction clock
        # (pdeps); non-clairvoyant algorithms never read it.
        pool.place(idx, arr.size, float(pdeps[i]), now)
        algorithm.on_placed(arr, idx, opened)
        placements[i] = idx
        heapq.heappush(heap, (float(inst.departures[i]), i, i, idx))
        peak_open = max(peak_open, len(pool._open_list))
        i += 1

    assert not pool._open_list, "all bins must close once every item departed"
    return PackingResult(usage_time=usage, n_bins_opened=pool.n_bins,
                         peak_open_bins=peak_open, placements=placements,
                         algorithm=algorithm.name, instance=inst.name, span=span)
