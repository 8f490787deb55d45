"""Box-plot statistics of performance ratios (paper §III); counterpart of
``repro.core.metrics``."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np


@dataclasses.dataclass
class BoxStats:
    """The paper's box-plot summary across instances."""

    mean: float
    median: float
    q1: float
    q3: float
    lo_whisker: float
    hi_whisker: float
    n: int

    @classmethod
    def from_ratios(cls, ratios: Sequence[float]) -> "BoxStats":
        r = np.asarray(sorted(ratios), float)
        q1, med, q3 = np.percentile(r, [25, 50, 75])
        iqr = q3 - q1
        lo = float(r[r >= q1 - 1.5 * iqr].min())
        hi = float(r[r <= q3 + 1.5 * iqr].max())
        return cls(float(r.mean()), float(med), float(q1), float(q3),
                   lo, hi, len(r))

    def row(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def summarize(per_instance_ratios: Dict[str, List[float]]
              ) -> Dict[str, BoxStats]:
    """algorithm name -> BoxStats over its per-instance ratios."""
    return {name: BoxStats.from_ratios(r)
            for name, r in per_instance_ratios.items() if len(r)}
