"""Learning-augmented policies: RCP, PPE, their modified (no-large-bin)
variants (new, paper §VI-A), and Lifetime Alignment (binary / geometric).

Item categories use *predicted* durations with absolute geometric ranges
X_0 = [0,1)s, X_i = [2^(i-1), 2^i)s.  Thresholds: RCP 1/sqrt(x); PPE
alpha/sqrt(x) with alpha a guess-and-double online estimate of the maximum
multiplicative prediction error observed on departed items (the shared
``adaptive.DepartureErrorEstimator``).

The categorization functions (``geo_class`` / ``la_class``) are pure
float64 numpy; the batched replay (``core.torchsim``) replays every policy
in this module as category-structured lanes through their float32 twins
(``core.algorithms.geo_class_jnp`` / ``la_class_jnp``), decision for
decision equal on fp32-exact instances.  The port's copy of
``repro.core.algorithms.learned``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..types import EPS, Arrival
from .adaptive import DepartureErrorEstimator
from .base import Algorithm, register
from .duration import dur_exponent

# bin roles (stored in pool.tag as negative numbers; category tags are >= 0)
_GENERAL, _BASE, _LARGE = -2, -3, -4

LA_BINARY_SPLIT = 7200.0   # 120 min, as deployed at Azure


def geo_class(dur):
    """0 if dur < 1s else i with dur in [2^(i-1), 2^i) seconds, vectorized
    (exact at power-of-two boundaries via frexp)."""
    return np.where(np.asarray(dur) < 1.0, 0, dur_exponent(dur))




def la_class(dur, mode: str = "binary"):
    """Lifetime Alignment class of a (predicted or remaining) duration."""
    if mode == "binary":
        return (np.asarray(dur) >= LA_BINARY_SPLIT).astype(np.int64)
    return geo_class(dur)




def _geo_cat(dur: float) -> int:
    return int(geo_class(dur))


class _RCPBase(Algorithm):
    """Shared machinery for RCP / PPE and the modified variants.

    Bin roles: general (First Fit, all categories below threshold), at most
    one *base* bin (overflow items of OFF categories), per-category bins
    (First Fit within the category once it is ON), and - original variants
    only - one *large* bin per item of size > 1/2.

    A category turns ON when the base bin exceeds total size 1/2 and is
    converted into a category bin (of its dominant category), or - modified
    variants - when a large item opens a category bin directly.  It turns OFF
    when the aggregate active size in its category bins falls below 1/2.
    """

    requires_predictions = True
    large_bins = True      # original RCP/PPE; modified variants set False
    adaptive_alpha = False  # PPE

    def bind(self, pool, inst):
        super().bind(pool, inst)
        self._seen_cats = set()
        self._on: Dict[int, bool] = {}
        self._agg_general: Dict[int, np.ndarray] = {}
        self._agg_catbins: Dict[int, np.ndarray] = {}
        self._agg_base = np.zeros(pool.d)
        self._base_idx = -1
        # item idx -> (category, location, predicted duration)
        self._items: Dict[int, tuple] = {}
        # alpha == pow2_ceiling(max observed error): the guess-and-double
        # estimate, backed by the shared departure-error estimator
        self._estimator = DepartureErrorEstimator()
        # category tags: cat -> tag id (>= 0)
        self._cat_tag: Dict[int, int] = {}
        self._next_tag = 0

    # ---------------------------------------------------------------- helpers
    def _tag_of(self, cat: int) -> int:
        if cat not in self._cat_tag:
            self._cat_tag[cat] = self._next_tag
            self._next_tag += 1
        return self._cat_tag[cat]

    def _threshold(self) -> float:
        x = max(len(self._seen_cats), 1)
        alpha = self._estimator.pow2_alpha() if self.adaptive_alpha else 1.0
        return alpha / np.sqrt(x)

    def _ff_tag(self, arr: Arrival, tag: int) -> int:
        open_idx = self.pool.open_indices()
        same = open_idx[self.pool.tag[open_idx] == tag]
        feas = same[self.pool.fits_mask(same, arr.size)]
        return int(feas[0]) if len(feas) else -1

    def _base_fits(self, size: np.ndarray) -> bool:
        if self._base_idx < 0 or not self.pool.alive[self._base_idx]:
            return True   # a fresh base bin always fits any item
        return bool(self.pool.fits_mask(np.array([self._base_idx]), size)[0])

    # -------------------------------------------------------------- placement
    def select_bin(self, arr: Arrival) -> int:
        cat = _geo_cat(max(arr.pdur, 0.0))
        self._seen_cats.add(cat)
        thr = self._threshold()
        large = float(arr.size.max()) > 0.5
        agg = self._agg_general.get(cat, np.zeros(self.pool.d))

        if self.large_bins and large:
            self._dest = ("L", cat)
            return -1   # one dedicated large bin per large item

        if float((agg + arr.size).max()) <= thr + EPS:
            self._dest = ("G", cat)
            return self._ff_tag(arr, _GENERAL)

        if self._on.get(cat, False):
            self._dest = ("C", cat)
            return self._ff_tag(arr, self._tag_of(cat))

        if self._base_fits(arr.size):
            self._dest = ("B", cat)
            if self._base_idx >= 0 and self.pool.alive[self._base_idx]:
                return self._base_idx
            return -1
        # modified variants only: a large item that cannot join the base bin
        # opens a category bin directly and turns its category ON.
        self._dest = ("C!", cat)
        return -1

    def on_placed(self, arr: Arrival, idx: int, opened: bool):
        kind, cat = self._dest
        if kind == "L":
            self.pool.tag[idx] = _LARGE
            self._items[arr.idx] = (cat, "L", arr.pdur, arr.size)
        elif kind == "G":
            if opened:
                self.pool.tag[idx] = _GENERAL
            self._agg_general[cat] = self._agg_general.get(
                cat, np.zeros(self.pool.d)) + arr.size
            self._items[arr.idx] = (cat, "G", arr.pdur, arr.size)
        elif kind in ("C", "C!"):
            if opened:
                self.pool.tag[idx] = self._tag_of(cat)
            if kind == "C!":
                self._on[cat] = True
            self._agg_catbins[cat] = self._agg_catbins.get(
                cat, np.zeros(self.pool.d)) + arr.size
            self._items[arr.idx] = (cat, "C", arr.pdur, arr.size)
        else:  # base bin
            if opened:
                self.pool.tag[idx] = _BASE
                self._base_idx = idx
                self._agg_base = np.zeros(self.pool.d)
            self._agg_base = self._agg_base + arr.size
            self._items[arr.idx] = (cat, "B", arr.pdur, arr.size)
            if float(self._agg_base.max()) > 0.5:
                self._convert_base(idx)

    def _convert_base(self, idx: int):
        """Base bin exceeded 1/2: convert to a category bin of its dominant
        category and turn that category ON (paper §VI-A).  Member sizes come
        from the per-item record (not ``inst.sizes``), so the conversion
        also works on open-ended streams (serving request ids)."""
        members = {c: np.zeros(self.pool.d) for c in self._seen_cats}
        for item, (cat, loc, _, sz) in self._items.items():
            if loc == "B":
                members[cat] = members[cat] + sz
        chosen = max(self._seen_cats, key=lambda c: float(members[c].max()))
        self.pool.tag[idx] = self._tag_of(chosen)
        self._on[chosen] = True
        for item, (cat, loc, pd, sz) in list(self._items.items()):
            if loc == "B":
                self._items[item] = (cat, "C", pd, sz)
                self._agg_catbins[cat] = self._agg_catbins.get(
                    cat, np.zeros(self.pool.d)) + sz
        self._agg_base = np.zeros(self.pool.d)
        self._base_idx = -1

    def _remove_item(self, item: int, size: np.ndarray):
        """Aggregate bookkeeping for an item leaving its bin (departure or
        migration): location decrements and the category turn-OFF check."""
        cat, loc, pdur, _ = self._items.pop(item)
        if loc == "G":
            self._agg_general[cat] = np.maximum(
                self._agg_general[cat] - size, 0.0)
        elif loc == "B":
            self._agg_base = np.maximum(self._agg_base - size, 0.0)
        elif loc == "C":
            self._agg_catbins[cat] = np.maximum(
                self._agg_catbins.get(cat, np.zeros(self.pool.d)) - size, 0.0)
            if self._on.get(cat, False) and \
                    float(self._agg_catbins[cat].max()) < 0.5:
                self._on[cat] = False   # category load fell low: turn OFF
        return pdur

    def on_departed(self, item: int, idx: int, now: float, size: np.ndarray):
        pdur = self._remove_item(item, size)
        if self.adaptive_alpha and pdur is not None and \
                item < len(self.inst.departures):
            # guess-and-double (PPE, [14]): alpha = pow2_ceiling(max err).
            # An open-ended stream (serving request ids past the instance)
            # has no ground-truth duration to score, as in AdaptiveSwitch;
            # the reference's copy indexes past its instance there.
            rdur = float(self.inst.departures[item] - self.inst.arrivals[item])
            self._estimator.observe(rdur, pdur)

    def on_migrated_out(self, item: int, idx: int, now: float,
                        size: np.ndarray):
        # no error observation: the item has not actually departed
        self._remove_item(item, size)

    def on_closed(self, idx: int, now: float):
        if idx == self._base_idx:
            self._base_idx = -1
            self._agg_base = np.zeros(self.pool.d)


@register("rcp")
class RCP(_RCPBase):
    """Robust & Consistent Packing [13]: O(mu) consistency,
    O(sqrt(log mu)) robustness."""

    name = "rcp"


@register("ppe")
class PPE(_RCPBase):
    """Packing with Prediction Error [14]: threshold alpha/sqrt(x); tight
    O(min{max{eps sqrt(log mu), eps^2}, mu}) over the error spectrum."""

    name = "ppe"
    adaptive_alpha = True


@register("rcp_modified")
class ModifiedRCP(_RCPBase):
    """NEW (paper §VI-A): RCP without dedicated large bins - large items share
    general/base/category bins, improving utilization."""

    name = "rcp_modified"
    large_bins = False


@register("ppe_modified")
class ModifiedPPE(_RCPBase):
    """NEW (paper §VI-A): PPE without dedicated large bins.  Best performer at
    high prediction error alongside First Fit (paper Fig. 12)."""

    name = "ppe_modified"
    large_bins = False
    adaptive_alpha = True


@register("lifetime_alignment")
class LifetimeAlignment(Algorithm):
    """Barbalho et al. [23]: Classify-By-(predicted)-Duration for items plus
    *dynamic* bin categories = predicted remaining usage time, Best Fit (l_inf)
    within the preferred class.  Any Fit; unbounded CR.

    mode="binary":    X0=[0,120min), X1=[120min,inf)   (as deployed at Azure)
    mode="geometric": X0=[0,1s), Xi=[2^(i-1),2^i)s     (as in RCP/PPE)
    """

    requires_predictions = True

    def __init__(self, mode: str = "binary"):
        assert mode in ("binary", "geometric")
        self.mode = mode
        self.name = f"la_{mode}"

    def _cat(self, dur: float) -> int:
        return int(la_class(dur, self.mode))

    def _best_fit(self, cand: np.ndarray, size: np.ndarray) -> int:
        feas = cand[self.pool.fits_mask(cand, size)]
        if not len(feas):
            return -1
        rem = self.pool.remaining(feas) - size
        return int(feas[np.argmin(rem.max(axis=1))])

    def select_bin(self, arr: Arrival) -> int:
        open_idx = self.pool.open_indices()
        if not len(open_idx):
            return -1
        cat = self._cat(max(arr.pdur, 0.0))
        if cat == 0:
            # shortest items fill leftover capacity anywhere
            return self._best_fit(open_idx, arr.size)
        remaining = self.pool.effective_close(open_idx, arr.now) - arr.now
        bin_cats = np.array([self._cat(r) for r in remaining])
        same = open_idx[bin_cats == cat]
        chosen = self._best_fit(same, arr.size)
        if chosen >= 0:
            return chosen
        other = open_idx[bin_cats != cat]
        return self._best_fit(other, arr.size)
