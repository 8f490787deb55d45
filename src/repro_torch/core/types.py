"""Core data types for MinUsageTime Dynamic Vector Bin Packing (DVBP).

An instance is a set of items r with d-dimensional size vectors s(r) in
(0, 1]^d and active intervals I(r) = [arrival, departure); bins have unit
capacity.  Instances are struct-of-arrays (numpy): the replay moves them to
the device once per batch.  Counterpart of ``repro.core.types``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Feasibility tolerance of the f64 host-side checks (instance validation,
# the Eq.(1) bound, the host algorithms and the oracle engine's capacity
# checks); the fp32 replay uses ``kernels.fitscore.F32_EPS``.
EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class Instance:
    """A MinUsageTime DVBP instance (struct of arrays, sorted by arrival)."""

    sizes: np.ndarray       # (n, d) float64, each component in (0, 1]
    arrivals: np.ndarray    # (n,) float64
    departures: np.ndarray  # (n,) float64, departures > arrivals
    name: str = "instance"

    def __post_init__(self):
        n, d = self.sizes.shape
        if self.arrivals.shape != (n,) or self.departures.shape != (n,):
            raise ValueError(f"{self.name}: arrivals/departures must be ({n},)")
        if n:
            if not np.all(self.departures > self.arrivals):
                raise ValueError(f"{self.name}: empty intervals")
            if not np.all(self.sizes > 0):
                raise ValueError(f"{self.name}: item sizes must be positive")
            if not np.all(self.sizes <= 1 + EPS):
                raise ValueError(f"{self.name}: item sizes must be <= capacity")
            if not np.all(np.diff(self.arrivals) >= 0):
                raise ValueError(f"{self.name}: must be sorted by arrival")

    @property
    def n_items(self) -> int:
        return self.sizes.shape[0]

    @property
    def d(self) -> int:
        return self.sizes.shape[1]

    @property
    def durations(self) -> np.ndarray:
        return self.departures - self.arrivals

    def sorted_by_arrival(self) -> "Instance":
        order = np.argsort(self.arrivals, kind="stable")
        return Instance(self.sizes[order], self.arrivals[order],
                        self.departures[order], self.name)

    def subset(self, mask: np.ndarray,
               name: Optional[str] = None) -> "Instance":
        return Instance(self.sizes[mask], self.arrivals[mask],
                        self.departures[mask], name or self.name)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """The information revealed to an online algorithm when an item arrives.

    ``pdep`` is the *predicted* departure time (clairvoyant setting: equal to
    the real departure; learning-augmented: arrival + predicted duration;
    non-clairvoyant: None and algorithms must not read it).
    """

    idx: int
    size: np.ndarray      # (d,)
    now: float            # == arrival time
    pdep: Optional[float]  # predicted departure time, or None

    @property
    def pdur(self) -> Optional[float]:
        return None if self.pdep is None else self.pdep - self.now


@dataclasses.dataclass(frozen=True)
class MigrantArrival(Arrival):
    """A consolidation re-place: an already-known item leaving its bin.

    ``now`` is the migration time (scoring and bin bookkeeping happen on the
    current clock), but categorization stays anchored to the item's
    original arrival - its duration class was fixed when it first arrived -
    so ``pdur`` derives from ``orig_now``, not ``now``.  Mirrors the
    batched replay, whose per-item category constants are computed once
    from the original arrivals (``core.torchsim._category_setup``).
    """

    orig_now: float = 0.0

    @property
    def pdur(self) -> Optional[float]:
        return None if self.pdep is None else self.pdep - self.orig_now


@dataclasses.dataclass
class PackingResult:
    """Outcome of one engine run (``core.engine.run``)."""

    usage_time: float            # accumulated bin usage time (the objective)
    n_bins_opened: int
    peak_open_bins: int
    placements: np.ndarray       # (n,) absolute bin index per item
    algorithm: str
    instance: str
    span: float                  # duration during which >=1 item is active

    def ratio(self, lower_bound: float) -> float:
        return self.usage_time / lower_bound if lower_bound > 0 \
            else float("inf")
