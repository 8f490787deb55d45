"""Prediction-error models for the learning-augmented setting (paper §VI-C,
Appendix E); counterpart of ``repro.core.predictions``.  The noise is drawn
with numpy from the same seeds as the reference, so both packages replay
identical predictions.

Log-normal: delta ~ LogNormal(0, sigma); Pdur = delta * Rdur.
Uniform: delta ~ U[1, eps], fair coin for under/over-estimation;
Pdur = Rdur / delta or delta * Rdur.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .types import Instance


def lognormal_predictions(inst: Instance, sigma: float,
                          seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    delta = np.exp(rng.normal(0.0, sigma, inst.n_items)) if sigma > 0 else \
        np.ones(inst.n_items)
    return inst.durations * delta


def uniform_predictions(inst: Instance, eps: float,
                        seed: int = 0) -> np.ndarray:
    if eps < 1:
        raise ValueError(f"uniform prediction error needs eps >= 1; got {eps}")
    rng = np.random.default_rng(seed)
    delta = rng.uniform(1.0, eps, inst.n_items)
    over = rng.random(inst.n_items) < 0.5
    return np.where(over, inst.durations * delta, inst.durations / delta)


def lognormal_predictions_batch(inst: Instance, sigma: float,
                                seeds: Sequence[int]) -> np.ndarray:
    """(n_seeds, n_items): row ``s`` is ``lognormal_predictions(inst,
    sigma, seed=seeds[s])``, so results stay stable as the seed list grows."""
    return np.stack([lognormal_predictions(inst, sigma, seed=s)
                     for s in seeds])


def uniform_predictions_batch(inst: Instance, eps: float,
                              seeds: Sequence[int]) -> np.ndarray:
    """(n_seeds, n_items) stack of ``uniform_predictions``, one seed per
    row."""
    return np.stack([uniform_predictions(inst, eps, seed=s) for s in seeds])
