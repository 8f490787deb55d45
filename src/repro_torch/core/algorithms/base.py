"""Algorithm base class and registry for the DVBP zoo (the port's copy of
``repro.core.algorithms.base``)."""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from ..bins import BinPool
from ..types import Arrival, Instance


class Algorithm:
    """Online packing policy.  The engine owns bin state; the policy selects.

    Contract:
      * ``select_bin(arr)`` returns an *open, feasible* absolute bin index, or
        -1 to request a new bin.  The engine then calls ``on_placed``.
      * ``on_departed`` / ``on_closed`` keep policy-private structures in sync.
      * ``requires_predictions``: True for clairvoyant / learning-augmented
        policies (they read ``arr.pdep`` and ``pool.indicated_close``).
    """

    name = "abstract"
    requires_predictions = False

    def bind(self, pool: BinPool, inst: Instance):
        self.pool = pool
        self.inst = inst

    def select_bin(self, arr: Arrival) -> int:
        raise NotImplementedError

    def on_placed(self, arr: Arrival, idx: int, opened: bool):
        pass

    def on_departed(self, item: int, idx: int, now: float, size: np.ndarray):
        pass

    def on_migrated_out(self, item: int, idx: int, now: float,
                        size: np.ndarray):
        """Consolidation removed ``item`` from ``idx`` ahead of a re-place.

        Defaults to the departure bookkeeping; policies that *learn* from
        departures (prediction-error estimators) override, because a
        migration reveals nothing about the item's real duration.
        """
        self.on_departed(item, idx, now, size)

    def on_closed(self, idx: int, now: float):
        pass

    # -------- helpers shared by most policies
    def _feasible(self, arr: Arrival):
        open_idx = self.pool.open_indices()
        mask = self.pool.fits_mask(open_idx, arr.size)
        return open_idx[mask]


REGISTRY: Dict[str, Callable[..., Algorithm]] = {}


def register(name: str):
    def deco(factory):
        REGISTRY[name] = factory
        return factory
    return deco


def get_algorithm(name: str, **kwargs) -> Algorithm:
    if name not in REGISTRY:
        raise KeyError(f"unknown algorithm {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)
