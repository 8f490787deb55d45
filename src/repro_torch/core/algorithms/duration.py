"""Clairvoyant policies driven by *duration* information:
Classify-By-Duration, Hybrid, Reduced Hybrid, and their direct-sum variants.

Multi-dimensional adaptation follows the paper: the "total size" of a set of
items is the l_inf norm of their aggregate size vector (Theorem 4 gives
O(d sqrt(log mu)) for both hybrids under this adaptation).  The direct-sum
variant [17] instead splits items into d classes by their largest dimension
and runs an independent single-dimensional copy per class (within a class,
feasibility in the max dimension implies feasibility in all dimensions).

The *categorization* math (duration exponents, CBD duration classes, hybrid
thresholds) lives in pure float64 numpy functions here; the batched replay
(``core.torchsim``) uses their float32 twins in ``core.algorithms``
(``dur_exponent_jnp`` ...), the same op sequence, so the host classes and
the replay agree decision for decision on fp32-exact instances.  Power-of-
two class boundaries are computed via ``frexp`` (exact for every
representable float) rather than ``log2`` (whose rounding can misclassify
durations that are exact powers of two).  The port's copy of
``repro.core.algorithms.duration``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

from ..types import EPS, Arrival
from .base import Algorithm, register


# ---------------------------------------------------------------- categories
def dur_exponent(dur):
    """j with dur in [2^(j-1), 2^j), vectorized; exact via frexp.

    ``frexp(d) = (m, e)`` with ``d = m 2^e``, ``m in [0.5, 1)``, so
    ``floor(log2 d) + 1 == e`` exactly - no log rounding at the class
    boundaries (``log2(2^k)`` may round to just under ``k`` in fp32)."""
    return np.frexp(np.maximum(dur, 1e-12))[1]




def duration_class(dur, beta: float = 2.0):
    """CBD class i with dur in [beta^(i-1), beta^i), vectorized.

    beta == 2 uses the exact frexp path (bit-exact in both twins at every
    precision).  Other bases fall back to the log ratio, where this f64
    host path and the replay's f32 twin can round a duration sitting
    essentially on a power-of-beta boundary into adjacent classes - the
    decision-for-decision parity guarantee is only for beta == 2."""
    if beta == 2.0:
        return dur_exponent(dur)
    dur = np.maximum(dur, 1e-12)
    return (np.floor(np.log(dur) / math.log(beta)) + 1).astype(np.int64)




def hybrid_threshold(i):
    """General-vs-category routing threshold 1/(2 sqrt(i)), vectorized."""
    return 1.0 / (2.0 * np.sqrt(i))




def _dur_exponent(dur: float) -> int:
    """Scalar j such that dur in [2^(j-1), 2^j)."""
    return int(dur_exponent(dur))


@register("cbd")
class ClassifyByDuration(Algorithm):
    """Items with durations in [beta^(i-1), beta^i) share a First-Fit bin
    class (paper §V-D).  O(log mu) competitive in 1-d.  Not Any Fit."""

    requires_predictions = True

    def __init__(self, beta: float = 2.0):
        assert beta > 1
        self.beta = beta
        self.name = f"cbd_beta{beta:g}"

    def select_bin(self, arr: Arrival) -> int:
        cat = int(duration_class(arr.pdur, self.beta))
        self._cat = cat
        open_idx = self.pool.open_indices()
        same = open_idx[self.pool.tag[open_idx] == cat]
        feas = same[self.pool.fits_mask(same, arr.size)]
        return int(feas[0]) if len(feas) else -1

    def on_placed(self, arr: Arrival, idx: int, opened: bool):
        if opened:
            self.pool.tag[idx] = self._cat


class _HybridBase(Algorithm):
    """Shared machinery for Hybrid / Reduced Hybrid (+ direct-sum variants).

    Bins carry an integer tag identifying either a per-class *general* pool or
    a specific item category's pool.  Per-category aggregate loads inside the
    general bins decide general-vs-category routing (threshold 1/(2 sqrt(i))).
    """

    requires_predictions = True
    reduced = False
    direct_sum = False

    def bind(self, pool, inst):
        super().bind(pool, inst)
        # Paper §V-E: rescale duration exponents so the minimum duration maps
        # to category i=1 (keeps sqrt(i) well defined).
        min_dur = float(inst.durations.min()) if inst.n_items else 1.0
        self._z = _dur_exponent(min_dur)
        self._tag_ids: Dict[Tuple, int] = {}
        self._agg: Dict[Tuple, np.ndarray] = {}      # key -> aggregate in general bins
        self._item_state: Dict[int, Tuple[Tuple, bool]] = {}

    # ------------------------------------------------------------- categories
    def _categorize(self, arr: Arrival) -> Tuple[Tuple, int, int]:
        """Return (category key, scaled index i>=1, class)."""
        cls = int(np.argmax(arr.size)) if self.direct_sum else 0
        j = _dur_exponent(max(arr.pdur, 1e-12))
        i = max(j - self._z + 1, 1)   # clamp: mispredictions below min duration
        if self.reduced:
            key = (cls, i)
        else:
            width = 2.0 ** j
            # consolidation re-places carry their original arrival clock
            # (``MigrantArrival.orig_now``): the arrival window was fixed
            # when the item first arrived
            c = int(math.floor(getattr(arr, "orig_now", arr.now) / width))
            key = (cls, i, c)
        return key, i, cls

    def _tag(self, key) -> int:
        if key not in self._tag_ids:
            self._tag_ids[key] = len(self._tag_ids)
        return self._tag_ids[key]

    def _norm(self, vec: np.ndarray, cls: int) -> float:
        # direct-sum sub-instances are single-dimensional in their max dim
        return float(vec[cls]) if self.direct_sum else float(vec.max())

    def _ff_among_tag(self, arr: Arrival, tag: int) -> int:
        open_idx = self.pool.open_indices()
        same = open_idx[self.pool.tag[open_idx] == tag]
        feas = same[self.pool.fits_mask(same, arr.size)]
        return int(feas[0]) if len(feas) else -1

    # -------------------------------------------------------------- placement
    def select_bin(self, arr: Arrival) -> int:
        key, i, cls = self._categorize(arr)
        agg = self._agg.get(key)
        after = arr.size if agg is None else agg + arr.size
        if self._norm(after, cls) <= hybrid_threshold(i) + EPS:
            self._dest = ("G", key, cls)
            return self._ff_among_tag(arr, self._tag(("G", cls)))
        self._dest = ("C", key, cls)
        return self._ff_among_tag(arr, self._tag(("C", key)))

    def on_placed(self, arr: Arrival, idx: int, opened: bool):
        kind, key, cls = self._dest
        if opened:
            tag_key = ("G", cls) if kind == "G" else ("C", key)
            self.pool.tag[idx] = self._tag(tag_key)
        if kind == "G":
            self._agg[key] = self._agg.get(key, np.zeros(self.pool.d)) + arr.size
            self._item_state[arr.idx] = (key, True)
        else:
            self._item_state[arr.idx] = (key, False)

    def on_departed(self, item: int, idx: int, now: float, size: np.ndarray):
        key, in_general = self._item_state.pop(item)
        if in_general:
            self._agg[key] = np.maximum(self._agg[key] - size, 0.0)


@register("hybrid")
class Hybrid(_HybridBase):
    """Azar & Vainstein's Hybrid [8]; categories (duration range, arrival
    window).  O(d sqrt(log mu)) with the l_inf adaptation (Theorem 4)."""

    name = "hybrid"


@register("reduced_hybrid")
class ReducedHybrid(_HybridBase):
    """Liu & Tang's simplification [13]: duration-only categories.
    Same O(d sqrt(log mu)) bound; empirically much better (paper Fig. 7)."""

    name = "reduced_hybrid"
    reduced = True


@register("hybrid_direct_sum")
class HybridDirectSum(_HybridBase):
    name = "hybrid_direct_sum"
    direct_sum = True


@register("reduced_hybrid_direct_sum")
class ReducedHybridDirectSum(_HybridBase):
    name = "reduced_hybrid_direct_sum"
    reduced = True
    direct_sum = True
