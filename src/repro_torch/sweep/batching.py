"""Pad a list of DVBP ``Instance``s into one batched event tensor;
counterpart of ``repro.sweep.batching``.

  * **Items** are padded to ``n_max = max(n_items)``: zero sizes, pdep 0,
    never in the event stream, so never placed (placement stays ``-1``).
  * **Dimensions** are zero-padded to ``d_max = max(d)``; ``dmask[b, k]``
    is 1.0 for the real dims of lane ``b`` (best-fit norms skip the rest).
  * **Events** are padded to ``2 n_max`` at the end with ``PAD_KIND``,
    item 0 and a time after the lane's last real event; they are no-ops.

Each lane's real event prefix is ``torchsim.event_sequence``, memoized on
the instance content (the lexsort is packing's only O(n log n) step); the
memo's hits, misses and bytes are the counters ``pack.evseq_hit`` /
``pack.evseq_miss`` / ``pack.evseq_bytes``, and a packing is one
``pack.instances`` span (``repro_torch.obs``).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..core.torchsim import event_sequence
from ..core.types import Instance
from ..kernels.fitscore import PAD_KIND

# Event sequences keyed by instance content digest, LRU-bounded by entry
# count and total bytes (real-trace instances hold MBs of event arrays).
_EVSEQ_CACHE: "OrderedDict[str, Tuple]" = OrderedDict()
_EVSEQ_CACHE_MAX = 4096
_EVSEQ_CACHE_MAX_BYTES = 256 * 1024 * 1024


def instance_digest(inst: Instance) -> str:
    """Content digest of one instance (sizes, arrivals, departures)."""
    h = hashlib.blake2b(digest_size=16)
    for a in (inst.sizes, inst.arrivals, inst.departures):
        a = np.ascontiguousarray(a)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def event_sequence_cached(inst: Instance):
    """``torchsim.event_sequence`` memoized on the instance content."""
    key = instance_digest(inst)
    hit = _EVSEQ_CACHE.get(key)
    if hit is not None:
        _EVSEQ_CACHE.move_to_end(key)
        obs.counter_add("pack.evseq_hit")
        return hit
    obs.counter_add("pack.evseq_miss")
    val = event_sequence(inst)
    _EVSEQ_CACHE[key] = val
    obs.counter_add("pack.evseq_bytes", sum(a.nbytes for a in val))
    nbytes = sum(sum(a.nbytes for a in v) for v in _EVSEQ_CACHE.values())
    while len(_EVSEQ_CACHE) > 1 and (len(_EVSEQ_CACHE) > _EVSEQ_CACHE_MAX
                                     or nbytes > _EVSEQ_CACHE_MAX_BYTES):
        _, old = _EVSEQ_CACHE.popitem(last=False)
        nbytes -= sum(a.nbytes for a in old)
        obs.counter_add("pack.evseq_bytes", -sum(a.nbytes for a in old))
    return val


@dataclasses.dataclass(frozen=True)
class InstanceBatch:
    """Struct-of-padded-arrays view of ``B`` instances (see module doc)."""

    sizes: np.ndarray     # (B, n_max, d_max)
    arrivals: np.ndarray  # (B, n_max)  padded with 0
    pdeps: np.ndarray     # (B, n_max)  real departures; padded with 0
    times: np.ndarray     # (B, 2 n_max)
    kinds: np.ndarray     # (B, 2 n_max) int32: 1 arrival / 0 departure / -1 pad
    items: np.ndarray     # (B, 2 n_max) int32
    dmask: np.ndarray     # (B, d_max) 1.0 real dim, 0.0 padding
    n_items: np.ndarray   # (B,) int32 real item counts
    names: tuple          # (B,) instance names

    @property
    def B(self) -> int:
        return self.sizes.shape[0]

    @property
    def n_max(self) -> int:
        return self.sizes.shape[1]

    @property
    def d_max(self) -> int:
        return self.sizes.shape[2]


def pack_instances(instances: Sequence[Instance]) -> InstanceBatch:
    if not instances:
        raise ValueError("cannot pack an empty instance list")
    with obs.span("pack.instances", B=len(instances)):
        return _pack_instances(instances)


def _pack_instances(instances: Sequence[Instance]) -> InstanceBatch:
    B = len(instances)
    n_max = max(i.n_items for i in instances)
    d_max = max(i.d for i in instances)

    sizes = np.zeros((B, n_max, d_max))
    arrivals = np.zeros((B, n_max))
    pdeps = np.zeros((B, n_max))
    times = np.zeros((B, 2 * n_max))
    kinds = np.full((B, 2 * n_max), PAD_KIND, np.int32)
    items = np.zeros((B, 2 * n_max), np.int32)
    dmask = np.zeros((B, d_max))
    n_items = np.zeros(B, np.int32)

    for b, inst in enumerate(instances):
        n, d = inst.n_items, inst.d
        sizes[b, :n, :d] = inst.sizes
        arrivals[b, :n] = inst.arrivals
        pdeps[b, :n] = inst.departures
        t, k, j = event_sequence_cached(inst)
        times[b, :2 * n] = t
        kinds[b, :2 * n] = k
        items[b, :2 * n] = j
        # pad events idle after the lane's replay at a finite time
        times[b, 2 * n:] = (t[-1] if n else 0.0) + 1.0
        dmask[b, :d] = 1.0
        n_items[b] = n
    return InstanceBatch(sizes, arrivals, pdeps, times, kinds, items, dmask,
                         n_items, tuple(i.name for i in instances))


def pad_predictions(batch: InstanceBatch,
                    predicted_durations: Sequence[Optional[np.ndarray]]
                    ) -> np.ndarray:
    """Stack per-lane predicted durations into pdeps ``(B, S, n_max)``
    (predicted departure = arrival + predicted duration).  Each element is
    None (real departures), ``(n_b,)`` or ``(S, n_b)``; all lanes agree on
    ``S`` (None broadcasts)."""
    if len(predicted_durations) != batch.B:
        raise ValueError(f"{len(predicted_durations)} prediction rows for "
                         f"{batch.B} lanes")
    S = 1
    for p in predicted_durations:
        if p is not None and np.asarray(p).ndim == 2:
            S = max(S, np.asarray(p).shape[0])
    out = np.zeros((batch.B, S, batch.n_max))
    for b, p in enumerate(predicted_durations):
        n = int(batch.n_items[b])
        if p is None:
            out[b, :, :n] = batch.pdeps[b, :n]
            continue
        p = np.asarray(p)
        if p.ndim == 1:
            p = p[None, :]
        if p.shape[0] not in (1, S) or p.shape[1] != n:
            raise ValueError(f"lane {b}: predictions of shape {p.shape}, "
                             f"expected ({S} or 1, {n})")
        out[b, :, :n] = batch.arrivals[b, None, :n] + p
    return out


def instances_pdeps(batch: InstanceBatch) -> np.ndarray:
    """Default (B, 1, n_max) pdeps tensor: the real departures."""
    return batch.pdeps[:, None, :]
