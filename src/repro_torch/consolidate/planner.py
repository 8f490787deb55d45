"""The consolidation planner: a copy of ``repro.consolidate.planner``,
the same numpy decisions in float64.  The batched driver reads the replay
carry between scan chunks and hands it here; the JAX package's driver and
its sequential host oracle call their copy on the same snapshot, so the
MIGRATE events of the three are identical.

Plan shape: *whole-bin-or-skip* underload drain.

  * candidates = alive bins holding items whose max-dim load is at or
    below the threshold, ordered (load fraction ascending, open order
    ascending) - emptiest-first, oldest breaking ties,
  * a candidate drains only if ALL of its live items fit (sequential
    First Fit by bin open order) into non-candidate alive bins; partial
    drains would leave the source open and gain nothing,
  * destination simulation is a feasibility pre-check only: the emitted
    events carry just ``(item)`` and the replay policy re-places each
    migrant through its own select (category policies may route a
    migrant into a fresh bin - that is the policy's decision to make),
  * a per-lane migration ``budget`` is enforced whole-bin-wise; a
    candidate whose item count exceeds the remaining budget is skipped
    (``budget_exhausted``), smaller candidates later in the order may
    still drain.

All arithmetic is float64 on both sides; parity tests pin fp32-exact
instances (1/64-grid sizes) so the driver's float32 carry view is exact.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np

# The feasibility tolerance of the host engine (core.types.EPS).
PLAN_EPS = 1e-9


@dataclasses.dataclass
class PlanResult:
    items: List[int]          # migrant item indices, in emission order
    bins_closed: int          # candidate bins accepted for draining
    budget_exhausted: int     # candidates skipped for lack of budget


def plan_migrations(loads: np.ndarray, counts: np.ndarray,
                    alive: np.ndarray, open_seq: np.ndarray,
                    bin_items: Dict[int, Sequence[int]],
                    sizes: np.ndarray, *, threshold: float,
                    budget: int = -1) -> PlanResult:
    """Plan one consolidation pass over a pool snapshot.

    ``loads`` (B, d) per-bin load, ``counts`` / ``alive`` / ``open_seq``
    (B,), ``bin_items`` maps a bin row to its live item indices
    (ascending), ``sizes`` (n, d) item demands.  ``budget < 0`` means
    unlimited.  Returns the migrant items in emission order (candidate
    bins in drain order, items ascending within a bin).
    """
    loads = np.asarray(loads, np.float64)
    sizes = np.asarray(sizes, np.float64)
    occupied = np.asarray(alive, bool) & (np.asarray(counts) > 0)
    rows = np.where(occupied)[0]
    if not len(rows):
        return PlanResult([], 0, 0)
    frac = loads[rows].max(axis=1)
    cand = rows[frac <= threshold + PLAN_EPS]
    is_cand = np.zeros(len(loads), bool)
    is_cand[cand] = True
    # emptiest first, oldest (First Fit order) breaking ties
    cand = cand[np.lexsort((open_seq[cand], loads[cand].max(axis=1)))]
    # drain targets: occupied NON-candidate bins, in open order
    targets = rows[~is_cand[rows]]
    targets = list(targets[np.argsort(open_seq[targets], kind="stable")])

    scratch = {int(t): loads[t].copy() for t in targets}
    items_out: List[int] = []
    closed = 0
    exhausted = 0
    left = math.inf if budget < 0 else int(budget)
    for src in cand:
        members = list(bin_items.get(int(src), ()))
        if not members:
            continue
        if len(members) > left:
            exhausted += 1
            continue
        # whole-bin-or-skip: simulate a First Fit drain on a scratch copy
        trial = {t: v.copy() for t, v in scratch.items()}
        ok = True
        for item in members:
            s = sizes[item]
            for t in targets:
                if np.all(s <= 1.0 - trial[t] + PLAN_EPS):
                    trial[t] = trial[t] + s
                    break
            else:
                ok = False
                break
        if not ok:
            continue
        scratch = trial
        items_out.extend(int(i) for i in members)
        closed += 1
        left -= len(members)
    return PlanResult(items_out, closed, exhausted)


def should_plan(spec, t: float, t_next: float):
    """Shared cadence gate: (run planner now?, next periodic deadline).

    ``underload`` plans at every boundary; ``periodic`` only once the
    lane clock crossed ``t_next``, then re-arms to the next Δt multiple.
    """
    if spec.kind == "none":
        return False, t_next
    if spec.kind == "periodic":
        if t < t_next:
            return False, t_next
        return True, (math.floor(t / spec.dt) + 1) * spec.dt
    return True, t_next
