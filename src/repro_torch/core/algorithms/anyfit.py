"""Non-clairvoyant policies: First Fit, MRU, Best Fit, Next Fit, RR Next Fit.

First Fit, MRU, Best Fit and Round-Robin Next Fit are Any Fit algorithms
(never open a new bin when the item fits in some open bin).  Next Fit is not.
"""
from __future__ import annotations

import numpy as np

from ..types import Arrival
from .base import Algorithm, register


@register("first_fit")
class FirstFit(Algorithm):
    """Place into the earliest-opened feasible bin.  CR = (mu+2)d + 1."""

    name = "first_fit"

    def select_bin(self, arr: Arrival) -> int:
        feas = self._feasible(arr)   # open_indices is already in opening order
        return int(feas[0]) if len(feas) else -1


@register("mru")
class MostRecentlyUsed(Algorithm):
    """Move-to-Front: most recently *accessed* feasible bin.  CR = (2mu+1)d+1."""

    name = "mru"

    def select_bin(self, arr: Arrival) -> int:
        feas = self._feasible(arr)
        if not len(feas):
            return -1
        return int(feas[np.argmax(self.pool.access_seq[feas])])


@register("best_fit")
class BestFit(Algorithm):
    """Least remaining capacity after placement, under an l_p norm fit score.

    norm in {"l1", "l2", "linf"} (paper §IV-C; linf is best on Azure data).
    Unbounded competitive ratio, strong empirically.
    """

    def __init__(self, norm: str = "linf"):
        assert norm in ("l1", "l2", "linf")
        self.norm = norm
        self.name = f"best_fit_{norm}"

    def select_bin(self, arr: Arrival) -> int:
        feas = self._feasible(arr)
        if not len(feas):
            return -1
        rem = self.pool.remaining(feas) - arr.size  # leftover after placement
        if self.norm == "l1":
            score = rem.sum(axis=1)
        elif self.norm == "l2":
            score = np.sqrt((rem * rem).sum(axis=1))
        else:
            score = rem.max(axis=1)
        return int(feas[np.argmin(score)])


@register("next_fit")
class NextFit(Algorithm):
    """Single receiving bin; on misfit the bin stops receiving forever.

    Not Any Fit.  CR = 2*mu*d + 1.
    """

    name = "next_fit"

    def bind(self, pool, inst):
        super().bind(pool, inst)
        self.current = -1   # absolute idx of the only receiving bin

    def select_bin(self, arr: Arrival) -> int:
        cur = self.current
        if cur >= 0 and self.pool.alive[cur]:
            if self.pool.fits_mask(np.array([cur]), arr.size)[0]:
                return cur
        return -1   # old bin (if any) is abandoned for future placements

    def on_placed(self, arr: Arrival, idx: int, opened: bool):
        self.current = idx


@register("rr_next_fit")
class RoundRobinNextFit(Algorithm):
    """NEW (paper §IV-B): Next Fit made Any Fit via round-robin search.

    Bins are kept in opening order; the cursor starts at the bin that received
    the last item and walks circularly; a new bin is opened only if no open
    bin fits.  CR <= (2mu+1)d + 1, and >= 2*mu*d (paper Appendix A).
    """

    name = "rr_next_fit"

    def bind(self, pool, inst):
        super().bind(pool, inst)
        self.cursor = -1   # absolute idx of bin that received the last item

    def select_bin(self, arr: Arrival) -> int:
        open_idx = self.pool.open_indices()
        if not len(open_idx):
            return -1
        mask = self.pool.fits_mask(open_idx, arr.size)
        if not mask.any():
            return -1
        # rotate so that the scan starts at the cursor bin (or the next open
        # bin after a closed cursor), preserving opening order.
        pos = np.searchsorted(open_idx, self.cursor)
        if pos == len(open_idx):
            pos = 0
        order = np.roll(np.arange(len(open_idx)), -pos)
        for j in order:
            if mask[j]:
                return int(open_idx[j])
        return -1  # unreachable

    def on_placed(self, arr: Arrival, idx: int, opened: bool):
        self.cursor = idx
