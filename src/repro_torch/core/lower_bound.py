"""Lower bound (Eq. 1) on the optimal accumulated bin usage time;
counterpart of ``repro.core.lower_bound``.

    LB = integral over t of  ceil( || sum_{active r} s(r) ||_inf )  dt

computed exactly in f64 on the host by a sweep line over the events; also
the time span in which at least one item is active (a second lower bound
the competitive analyses use).
"""
from __future__ import annotations

import numpy as np

from .types import EPS, Instance


def lower_bound(inst: Instance) -> float:
    n, _ = inst.sizes.shape
    if n == 0:
        return 0.0
    times = np.concatenate([inst.arrivals, inst.departures])
    deltas = np.concatenate([inst.sizes, -inst.sizes])
    order = np.argsort(times, kind="stable")
    times, deltas = times[order], deltas[order]
    # aggregate load right after each event; simultaneous events collapse
    agg = np.cumsum(deltas, axis=0)
    load = np.max(agg[:-1], axis=1)            # ||aggregate||_inf per segment
    bins_needed = np.maximum(np.ceil(load - EPS), 0.0)   # EPS: float residue
    return float(np.sum(bins_needed * (times[1:] - times[:-1])))


def span(inst: Instance) -> float:
    """Total duration in which at least one item is active."""
    if inst.n_items == 0:
        return 0.0
    times = np.concatenate([inst.arrivals, inst.departures])
    deltas = np.concatenate([np.ones(inst.n_items), -np.ones(inst.n_items)])
    order = np.argsort(times, kind="stable")
    times, deltas = times[order], deltas[order]
    count = np.cumsum(deltas)
    active = count[:-1] > 0
    return float(np.sum((times[1:] - times[:-1])[active]))
