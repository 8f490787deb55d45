"""Replay decision traces: the per-event time series the replay computes;
the port's ``repro.obs.trace``.

The batched replay already tracks open bins, aggregate loads and running
usage per event - it just discards everything but the final values.  With
``trace_level >= 1`` the per-event replay (``core.torchsim``) also writes
its post-event state into (L, E, ...) tensors allocated before the loop,
at a step counter held on the device (so the CUDA graphs of the event
windows record it too), which land here as a ``ReplayTrace``: usage /
open-bin time series for every lane, and decision-for-decision comparisons
via ``diff_traces`` ("which event diverged first" instead of bisection).

Everything in this module is host-side numpy; the device only pays for the
trace tensors and the few kernels a step that fill them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from ..kernels.fitscore import (ARRIVAL_KIND, DEPARTURE_KIND,  # noqa: F401
                                MIGRATE_KIND, PAD_KIND)

# Comparison order for diff_traces: a slot disagreement is the decision
# divergence itself; the rest are downstream symptoms.
TRACE_FIELDS = ("slot", "tag", "open_bins", "load", "usage")


@dataclasses.dataclass(frozen=True)
class ReplayTrace:
    """Per-event decision series for ``L`` replay lanes of ``E`` events.

    Lane order matches the runner's flattening: lane ``b * S + s`` is
    instance ``b``, prediction-seed row ``s``.  Event columns follow the
    padded event tensor (real events first, ``PAD_KIND`` filler after).
    """

    times: np.ndarray      # (L, E) event times
    kinds: np.ndarray      # (L, E) 1 arrival / 0 departure / -1 pad
    #                                (2 migrate)
    items: np.ndarray      # (L, E) item index per event
    slot: np.ndarray       # (L, E) slot chosen (arrival) / freed
                           #        (departure, migrate); -1 on pad events
    open_bins: np.ndarray  # (L, E) open-bin count after the event
    load: np.ndarray       # (L, E, d) aggregate open-bin load after
    tag: np.ndarray        # (L, E) category tag of the touched slot
                           #        (-1: untagged policy family / pad)
    usage: np.ndarray      # (L, E) running usage total after the event
    policy: str = ""
    S: int = 1             # seed rows per instance (lane = b * S + s)
    alive: Optional[np.ndarray] = None  # (L, E, Np) trace_level >= 2 only

    @property
    def L(self) -> int:
        return self.slot.shape[0]

    @property
    def E(self) -> int:
        return self.slot.shape[1]

    def lane(self, i: int) -> "ReplayTrace":
        """Single-lane view (L == 1), keeping every series aligned."""
        pick = lambda a: None if a is None else a[i:i + 1]
        return dataclasses.replace(
            self, times=self.times[i:i + 1], kinds=self.kinds[i:i + 1],
            items=self.items[i:i + 1], slot=self.slot[i:i + 1],
            open_bins=self.open_bins[i:i + 1], load=self.load[i:i + 1],
            tag=self.tag[i:i + 1], usage=self.usage[i:i + 1],
            alive=pick(self.alive), S=1)

    def series(self, lane: int = 0) -> Dict[str, np.ndarray]:
        """One lane's real-event series (pad events dropped): the
        paper-style ``time -> open_bins / load / usage`` curves."""
        m = self.kinds[lane] != PAD_KIND
        out = {"time": self.times[lane][m], "kind": self.kinds[lane][m],
               "item": self.items[lane][m]}
        for f in TRACE_FIELDS:
            out[f] = getattr(self, f)[lane][m]
        return out


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def from_scan(ys: Dict[str, Any], times, kinds, items, policy: str = "",
              S: int = 1) -> ReplayTrace:
    """Wrap the replay's trace tensors (each ``(L, E, ...)``, numpy or
    torch) plus the event tensor into a host-side ``ReplayTrace``; the
    event tensor's rows repeat ``S`` times (lane = b * S + s)."""
    rep = lambda a: np.repeat(_host(a), S, axis=0) if S > 1 \
        else _host(a)
    return ReplayTrace(times=rep(times), kinds=rep(kinds), items=rep(items),
                       slot=_host(ys["slot"]),
                       open_bins=_host(ys["open_bins"]),
                       load=_host(ys["load"]),
                       tag=_host(ys["tag"]),
                       usage=_host(ys["usage"]),
                       alive=None if "alive" not in ys
                       else _host(ys["alive"]),
                       policy=policy, S=S)


@dataclasses.dataclass(frozen=True)
class TraceDivergence:
    """First event where two traces disagree."""
    lane: int
    event: int
    field: str        # "kind"/"time"/"item" (structural) or a TRACE_FIELDS
    a_value: Any
    b_value: Any
    time: float       # event time in trace ``a``
    kind: int         # event kind in trace ``a``
    item: int

    def __str__(self):
        what = {ARRIVAL_KIND: "arrival", DEPARTURE_KIND: "departure",
                MIGRATE_KIND: "migrate", PAD_KIND: "pad"}.get(int(self.kind),
                                                               "?")
        return (f"lane {self.lane} event {self.event} "
                f"(t={self.time:g}, {what} of item {self.item}): "
                f"{self.field} {self.a_value!r} != {self.b_value!r}")


def diff_traces(a: ReplayTrace, b: ReplayTrace) -> Optional[TraceDivergence]:
    """Pinpoint the first diverging event between two replay traces.

    Returns ``None`` when the traces agree on every field of every event,
    else the earliest (event, then lane) disagreement with the field
    chosen by decision priority (``slot`` before downstream aggregates).
    Structural mismatches (different event tensors) are reported as
    ``kind`` / ``time`` / ``item`` divergences.
    """
    if a.slot.shape != b.slot.shape:
        raise ValueError(
            f"trace shapes differ: {a.slot.shape} vs {b.slot.shape}")
    fields = ("kind", "time", "item") + TRACE_FIELDS
    arrays = {"kind": (a.kinds, b.kinds), "time": (a.times, b.times),
              "item": (a.items, b.items)}
    arrays.update({f: (getattr(a, f), getattr(b, f))
                   for f in TRACE_FIELDS})
    neq = {}
    any_neq = np.zeros(a.slot.shape, bool)
    for f, (xa, xb) in arrays.items():
        d = xa != xb
        if d.ndim == 3:          # per-dim load: any component differs
            d = d.any(axis=2)
        neq[f] = d
        any_neq |= d
    if not any_neq.any():
        return None
    # earliest diverging event across all lanes; lowest lane breaks ties
    ev_first = np.where(any_neq.any(axis=0))[0][0]
    lane = np.where(any_neq[:, ev_first])[0][0]
    for f in fields:
        if neq[f][lane, ev_first]:
            xa, xb = arrays[f]
            return TraceDivergence(
                lane=int(lane), event=int(ev_first), field=f,
                a_value=xa[lane, ev_first], b_value=xb[lane, ev_first],
                time=float(a.times[lane, ev_first]),
                kind=int(a.kinds[lane, ev_first]),
                item=int(a.items[lane, ev_first]))
    raise AssertionError("unreachable: any_neq set but no field differs")
