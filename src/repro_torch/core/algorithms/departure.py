"""Clairvoyant policies driven by *departure time* information:
Classify-By-Departure-Time, Nearest Remaining Time (new), Greedy.

All read ``arr.pdep`` (real departure in the clairvoyant setting, predicted
in the learning-augmented setting) and the bins' indicated closing times,
clamped to >= now per the paper's §VI adaptation.
"""
from __future__ import annotations

import numpy as np

from ..types import Arrival
from .base import Algorithm, register


def departure_window(pdep, rho: float):
    """CBDT class: index of the rho-wide horizon window holding a
    (predicted) departure time, vectorized, in f64.  Shared by the host
    class and the serving scheduler's category mask, so both agree on the
    window boundary (the replay's fp32 twin is
    ``algorithms.departure_window_jnp``)."""
    return np.floor(np.asarray(pdep) / rho).astype(np.int64)


@register("cbdt")
class ClassifyByDepartureTime(Algorithm):
    """Partition the horizon into rho-wide windows; items whose departure
    falls in the same window share a dedicated First-Fit bin class (paper §V-A).
    Not Any Fit.  O(sqrt(mu)) competitive in 1-d with the optimal rho.
    """

    requires_predictions = True

    def __init__(self, rho: float):
        assert rho > 0
        self.rho = rho
        self.name = f"cbdt_rho{rho:g}"

    def select_bin(self, arr: Arrival) -> int:
        cat = int(departure_window(arr.pdep, self.rho))
        self._cat = cat
        open_idx = self.pool.open_indices()
        same = open_idx[self.pool.tag[open_idx] == cat]
        mask = self.pool.fits_mask(same, arr.size)
        feas = same[mask]
        return int(feas[0]) if len(feas) else -1

    def on_placed(self, arr: Arrival, idx: int, opened: bool):
        if opened:
            self.pool.tag[idx] = self._cat


class _NRTBase(Algorithm):
    requires_predictions = True

    def _closes(self, feas, now):
        return self.pool.effective_close(feas, now)


@register("nrt_standard")
class StandardNRT(_NRTBase):
    """NEW (paper §V-B): place into the feasible bin whose indicated closing
    time is nearest to the item's departure time.  Unbounded CR."""

    name = "nrt_standard"

    def select_bin(self, arr: Arrival) -> int:
        feas = self._feasible(arr)
        if not len(feas):
            return -1
        closes = self._closes(feas, arr.now)
        return int(feas[np.argmin(np.abs(closes - arr.pdep))])


@register("nrt_prioritized")
class PrioritizedNRT(_NRTBase):
    """NEW (paper §V-B): prefer bins that need no closing-time extension
    (indicated close >= item departure); nearest within each case.
    CR <= (mu+2)d + 1 (paper Appendix B).  Best clairvoyant performer."""

    name = "nrt_prioritized"

    def select_bin(self, arr: Arrival) -> int:
        feas = self._feasible(arr)
        if not len(feas):
            return -1
        closes = self._closes(feas, arr.now)
        gap = closes - arr.pdep
        case_a = gap >= 0
        if case_a.any():
            cand = feas[case_a]
            return int(cand[np.argmin(gap[case_a])])
        return int(feas[np.argmax(gap)])   # case b: least extension needed


@register("greedy")
class Greedy(Algorithm):
    """Li et al. [17]: place into the feasible bin with the *latest* indicated
    closing time.  CR <= (mu+2)d + 1 (improved analysis, paper Appendix B).
    Conservative; the most error-robust of the closing-time family (§VI-C)."""

    name = "greedy"
    requires_predictions = True

    def select_bin(self, arr: Arrival) -> int:
        feas = self._feasible(arr)
        if not len(feas):
            return -1
        closes = self.pool.effective_close(feas, arr.now)
        return int(feas[np.argmax(closes)])
