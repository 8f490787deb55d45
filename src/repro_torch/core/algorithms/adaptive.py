"""Adaptive policy switching - the paper's future direction (1), implemented.

The paper's §VI-C finding: Prioritized NRT wins near perfect predictions,
Greedy wins at medium error, and at high error modified PPE converges to
First Fit (its threshold alpha/sqrt(x) grows past every aggregate).
``AdaptiveSwitch`` monitors the maximum multiplicative prediction error over
departed items (the same online signal PPE's guess-and-double uses - no
extra information assumed) and routes each arrival to the strongest policy
for the current regime:

    err < low   (default 2)  -> nrt_prioritized  (aggressive; consistency)
    err < high  (default 16) -> greedy           (conservative closing times)
    else                     -> first_fit        (error-oblivious; what PPE
                                                  degenerates to anyway)

The error signal itself lives in ``DepartureErrorEstimator`` - one shared
running-max estimator consumed by AdaptiveSwitch, by PPE's guess-and-double
alpha (``learned._RCPBase``), and - via the float32 twins
``core.algorithms.prediction_error_jnp`` / ``pow2_ceiling_jnp`` - by the
batched replay's carried err/alpha values (``core.torchsim``).  The
estimator is updated once per *departure*; arrivals only read it (O(1) per
event: no per-arrival recomputation and no per-item dict churn).

All three sub-policies are *pool-stateless* (they read bin state from the
shared BinPool and keep no private structures), so switching between them
mid-stream is exactly an Any Fit algorithm and inherits Greedy/NRT's
(mu+2)d+1 competitive bound in each regime.  The port's copy of
``repro.core.algorithms.adaptive``.
"""
from __future__ import annotations

import math

import numpy as np

from ..types import Arrival
from .base import Algorithm, register
from .anyfit import FirstFit
from .departure import Greedy, PrioritizedNRT


def prediction_error(rdur, pdur):
    """Multiplicative misprediction max(rdur/pdur, pdur/rdur), vectorized."""
    pdur = np.maximum(pdur, 1e-12)
    return np.maximum(rdur / pdur, pdur / rdur)




def pow2_ceiling(x: float) -> float:
    """Smallest power of two >= x - the fixed point of guess-and-double
    starting from any power of two <= x.  Exact via frexp."""
    m, e = math.frexp(x)
    return math.ldexp(0.5 if m == 0.5 else 1.0, e)




class DepartureErrorEstimator:
    """Running max multiplicative prediction error over departed items.

    The single online error signal the paper's §VI-C machinery consumes:
    PPE's guess-and-double alpha is ``pow2_ceiling(err)`` and
    AdaptiveSwitch's regime is a piecewise-constant function of ``err``.
    ``observe`` is called once per departure; reading ``err`` is O(1).
    """

    def __init__(self):
        self.err = 1.0

    def observe(self, rdur: float, pdur: float) -> float:
        self.err = max(self.err, float(prediction_error(rdur, pdur)))
        return self.err

    def pow2_alpha(self) -> float:
        """Guess-and-double alpha: smallest power of two >= err."""
        return pow2_ceiling(self.err)


@register("adaptive")
class AdaptiveSwitch(Algorithm):
    requires_predictions = True

    def __init__(self, low: float = 2.0, high: float = 16.0):
        assert 1.0 <= low <= high
        self.low = low
        self.high = high
        self.name = f"adaptive_{low:g}_{high:g}"
        self._subs = (PrioritizedNRT(), Greedy(), FirstFit())

    def bind(self, pool, inst):
        super().bind(pool, inst)
        for s in self._subs:
            s.bind(pool, inst)
        self.estimator = DepartureErrorEstimator()
        # predicted durations recorded at arrival (the estimator may only
        # use information the online algorithm has seen); dense array for
        # instance replays, dict overflow for open-ended streams whose
        # caller-chosen ids may be sparse (serving request ids)
        self._pdur = np.zeros(max(inst.n_items, 1))
        self._pdur_extra = {}
        self.regime_switches = 0
        self._last = 0

    @property
    def _err(self) -> float:   # kept for tests/introspection
        return self.estimator.err

    def _active_index(self) -> int:
        err = self.estimator.err
        if err < self.low:
            return 0
        if err < self.high:
            return 1
        return 2

    def select_bin(self, arr: Arrival) -> int:
        if arr.idx < len(self._pdur):
            self._pdur[arr.idx] = max(arr.pdur, 1e-12)
        else:                              # open-ended stream (serving)
            self._pdur_extra[arr.idx] = max(arr.pdur, 1e-12)
        k = self._active_index()
        if k != self._last:
            self.regime_switches += 1
            self._last = k
        return self._subs[k].select_bin(arr)

    def on_departed(self, item: int, idx: int, now: float, size: np.ndarray):
        if item >= len(self.inst.departures):
            self._pdur_extra.pop(item, None)
            return   # open-ended stream: no ground-truth duration to score
        rdur = float(self.inst.departures[item] - self.inst.arrivals[item])
        self.estimator.observe(rdur, self._pdur[item])

    def on_migrated_out(self, item: int, idx: int, now: float,
                        size: np.ndarray):
        pass   # a migration is not a departure: no error observation
