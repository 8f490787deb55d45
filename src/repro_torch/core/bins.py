"""Open-bin bookkeeping shared by the engine and all packing algorithms.

The pool is a struct-of-arrays over *absolute* bin indices (monotonically
assigned; a closed bin index is never reused, matching the paper's semantics
where the usage time of a bin is one contiguous episode).  Algorithms operate
on the set of currently-open bins through vectorized views.

All capacity checks use ``types.EPS`` so exact fits are accepted.  The
port's copy of ``repro.core.bins``.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .types import EPS


class BinPool:
    """Vectorized state for every bin ever opened during one engine run."""

    def __init__(self, d: int, init_cap: int = 64):
        self.d = d
        self._cap = init_cap
        self.used = np.zeros((init_cap, d))          # current load per dim
        self.n_active = np.zeros(init_cap, np.int64)  # active items in bin
        self.open_time = np.full(init_cap, np.nan)
        self.open_seq = np.full(init_cap, -1, np.int64)   # FF ordering key
        self.access_seq = np.full(init_cap, -1, np.int64)  # MRU ordering key
        self.indicated_close = np.full(init_cap, -np.inf)  # max predicted dep
        self.alive = np.zeros(init_cap, bool)
        self.tag = np.full(init_cap, -1, np.int64)   # algorithm-owned label
        self.n_bins = 0          # total ever opened
        self._seq = 0            # placement sequence counter
        self._open_list: List[int] = []   # open bins in opening order

    # ------------------------------------------------------------------ admin
    def _grow(self):
        new_cap = self._cap * 2
        for name in ("used", "n_active", "open_time", "open_seq", "access_seq",
                     "indicated_close", "alive", "tag"):
            arr = getattr(self, name)
            new = np.zeros((new_cap,) + arr.shape[1:], arr.dtype)
            if name == "open_time":
                new[:] = np.nan
            elif name == "indicated_close":
                new[:] = -np.inf
            elif name in ("open_seq", "access_seq", "tag"):
                new[:] = -1
            new[: self._cap] = arr
            setattr(self, name, new)
        self._cap = new_cap

    def open_bin(self, now: float, tag: int = -1) -> int:
        if self.n_bins == self._cap:
            self._grow()
        idx = self.n_bins
        self.n_bins += 1
        self.used[idx] = 0.0
        self.n_active[idx] = 0
        self.open_time[idx] = now
        self.open_seq[idx] = self._seq
        self.alive[idx] = True
        self.tag[idx] = tag
        self._open_list.append(idx)
        return idx

    def close_bin(self, idx: int):
        assert self.alive[idx] and self.n_active[idx] == 0
        self.alive[idx] = False
        self._open_list.remove(idx)

    # ------------------------------------------------------------ item events
    def place(self, idx: int, size: np.ndarray, pdep: float, now: float):
        self.used[idx] += size
        assert np.all(self.used[idx] <= 1 + EPS), (
            f"capacity violated in bin {idx}: {self.used[idx]}")
        self.n_active[idx] += 1
        self.access_seq[idx] = self._seq
        self._seq += 1
        if pdep is not None:
            # Paper §VI adaptation: a bin's indicated closing time is never in
            # the past; underestimated items are predicted to depart "now".
            self.indicated_close[idx] = max(self.indicated_close[idx], pdep, now)

    def remove(self, idx: int, size: np.ndarray):
        self.used[idx] -= size
        self.n_active[idx] -= 1
        assert self.n_active[idx] >= 0
        if self.n_active[idx] == 0:
            self.used[idx] = 0.0   # kill float residue for exact reuse checks

    # ------------------------------------------------------------------ views
    def open_indices(self) -> np.ndarray:
        """Open bins in opening order (stable; the First Fit order)."""
        return np.asarray(self._open_list, np.int64)

    def fits_mask(self, open_idx: np.ndarray, size: np.ndarray) -> np.ndarray:
        """Feasibility of ``size`` in each of ``open_idx`` (all dims)."""
        if len(open_idx) == 0:
            return np.zeros(0, bool)
        rem = 1.0 - self.used[open_idx]
        return np.all(size <= rem + EPS, axis=1)

    def remaining(self, open_idx: np.ndarray) -> np.ndarray:
        return 1.0 - self.used[open_idx]

    def effective_close(self, open_idx: np.ndarray, now: float) -> np.ndarray:
        """Indicated closing times clamped to >= now (paper §VI adaptation)."""
        return np.maximum(self.indicated_close[open_idx], now)
