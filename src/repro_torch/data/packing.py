"""Document -> training-sequence packing: the static bin-packing special case
of the paper's problem, applied to the data pipeline; the port's copy of
``repro.data.packing`` (the same bins, the same efficiency).

Documents are items whose single dimension is token count; sequences are
bins of capacity seq_len.  Any-Fit heuristics (First/Best Fit, and their
decreasing variants for offline batches) minimize the number of sequences
== padding waste.  Returns pack assignments + achieved token efficiency.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def pack_documents(lengths: List[int], seq_len: int,
                   policy: str = "first_fit_decreasing"
                   ) -> Tuple[List[List[int]], float]:
    order = np.argsort(lengths)[::-1] if policy.endswith("decreasing") \
        else np.arange(len(lengths))
    bins: List[List[int]] = []
    space: List[int] = []
    for i in order:
        li = lengths[i]
        if li > seq_len:
            continue   # caller chunks over-length docs first
        choice = -1
        if policy.startswith("first_fit"):
            for b, s in enumerate(space):
                if s >= li:
                    choice = b
                    break
        else:   # best fit: tightest remaining space
            feas = [(s - li, b) for b, s in enumerate(space) if s >= li]
            if feas:
                choice = min(feas)[1]
        if choice < 0:
            bins.append([int(i)])
            space.append(seq_len - li)
        else:
            bins[choice].append(int(i))
            space[choice] -= li
    used = sum(lengths[i] for b in bins for i in b)
    efficiency = used / (len(bins) * seq_len) if bins else 1.0
    return bins, float(efficiency)
