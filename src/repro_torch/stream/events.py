"""Bounded-memory event sources and the fixed-geometry chunk builder;
counterpart of ``repro.stream.events``.

The in-memory replay materializes one padded ``(L, 2 n_max)`` event tensor
per lane, so memory grows with trace *length*.  This module turns a
request stream (arrival-sorted ``(size, arrival, departure[, predicted])``
records) into a sequence of fixed-geometry :class:`EventChunk` s of ``C``
events each, with item metadata held in a recycled *row pool*: an arriving
VM is assigned a pool row, a departing VM frees it, and a freed row becomes
allocatable again from the *next* chunk on (never inside the chunk that
freed it, so the chunk's pool scatter happens once, up front).  Peak pool
size is therefore O(max concurrently alive VMs), not O(trace length).

Event ordering is bit-compatible with ``core.torchsim.event_sequence``:
events sort by time (compared in float64, exactly as the in-memory
``np.lexsort`` does before the device cast to float32), departures before
arrivals at equal times, equal-time departures by item sequence number and
equal-time arrivals in source order.  Chunks are padded to ``C`` with
``PAD_KIND`` no-op events - the replay carry passes through them unchanged,
so padding never affects decisions and every chunk has one geometry.

Two policy families need care beyond the elementwise per-item constants
(``torchsim._category_setup`` derives those from the pool's size / arrival
/ departure rows, so a correctly scattered pool reproduces them exactly):

  * RCP's running distinct-category count is a cumsum over the whole event
    axis; the builder maintains it on the host (``geo_class`` twin on
    float32 durations, the exact dtype path of the device computation) and
    ships it per chunk as the ``ev_extra`` stream.
  * Hybrid builds its key table from the *whole* instance up front
    (clairvoyant), so it streams in *identity* mode: events are chunked but
    the item table is the full instance - memory O(n_items), still free of
    the O(2 n_max) event tensor.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
from typing import Iterator, Optional, Tuple

import numpy as np

from ..core.algorithms.learned import geo_class
from ..core.torchsim import policy_spec
from ..core.types import Instance
from ..kernels.fitscore import ARRIVAL_KIND, DEPARTURE_KIND, KCAT, PAD_KIND

# Row index of the padding entries of a chunk's pool update and freed-row
# list: far out of range, masked out where the replay scatters and gathers.
POOL_SENTINEL = np.int32(2 ** 30)


@dataclasses.dataclass(frozen=True)
class StreamMeta:
    """Static facts about a request stream.

    ``fingerprint`` identifies the stream content + order (checkpoint
    digests); ``n_items`` is the total request count when the source knows
    it up front, else -1 (a CSV stream discovers it only by draining)."""
    d: int
    fingerprint: str
    n_items: int = -1


class InstanceSource:
    """Stream one in-memory :class:`Instance` (arrival-sorted), optionally
    with predicted durations - the bit-equality reference source and the
    bridge from every existing suite generator."""

    def __init__(self, inst: Instance,
                 predicted_durations: Optional[np.ndarray] = None):
        assert np.all(np.diff(inst.arrivals) >= 0), \
            f"{inst.name!r} is not arrival-sorted; use .sorted_by_arrival()"
        self.inst = inst
        self.pdeps = inst.departures if predicted_durations is None \
            else inst.arrivals + np.asarray(predicted_durations, np.float64)

    def meta(self) -> StreamMeta:
        from ..sweep.batching import instance_digest
        h = hashlib.blake2b(digest_size=8)
        h.update(instance_digest(self.inst).encode())
        h.update(np.ascontiguousarray(self.pdeps).tobytes())
        return StreamMeta(self.inst.d, h.hexdigest(), self.inst.n_items)

    def records(self) -> Iterator[Tuple[np.ndarray, float, float, float]]:
        inst = self.inst
        for i in range(inst.n_items):
            yield (inst.sizes[i], float(inst.arrivals[i]),
                   float(inst.departures[i]), float(self.pdeps[i]))

    def full_arrays(self):
        """(sizes, arrivals, rdeps, pdeps) float64 - identity (hybrid)
        mode's whole-instance item table."""
        return (self.inst.sizes, self.inst.arrivals, self.inst.departures,
                np.asarray(self.pdeps, np.float64))


class CsvSource:
    """Stream Azure-format requests (``data.traces.iter_azure_requests``)
    for one machineId without ever materializing the trace."""

    def __init__(self, root: str, machine_id: int = 0):
        self.root, self.machine_id = root, int(machine_id)

    def meta(self) -> StreamMeta:
        from ..data.traces import azure_stream_meta
        d = azure_stream_meta(self.root, self.machine_id)
        return StreamMeta(
            d, f"azure:{self.root}:pm{self.machine_id}", -1)

    def records(self):
        from ..data.traces import iter_azure_requests
        for size, arr, dep in iter_azure_requests(self.root,
                                                  self.machine_id):
            yield size, arr, dep, dep   # clairvoyant predictions


@dataclasses.dataclass
class EventChunk:
    """One fixed-geometry unit of device work: ``C`` merged events plus the
    pool-row scatter that makes their item metadata resolvable.

    ``times``/``kinds``/``items`` are the (C,) event streams (float32 /
    int32, PAD-padded); ``upd_*`` the (C,)-shaped pool update for rows
    first written in this chunk (``POOL_SENTINEL`` index padding - a row's
    constants are scattered exactly once, in the chunk its VM arrives);
    ``extras`` the per-event ``ev_extra`` streams (RCP's running count);
    ``freed``/``freed_seqs`` the rows released by this chunk's departures
    and the global item sequence numbers that owned them (placement
    harvest - those rows may be recycled from the next chunk on).
    ``item_rows`` is the pool size this chunk's rows require (mid-chunk
    growth included - the driver grows pool + carry *before* replaying
    the chunk whenever it increases)."""
    times: np.ndarray
    kinds: np.ndarray
    items: np.ndarray
    n_events: int
    upd_idx: np.ndarray
    upd_size: np.ndarray
    upd_arrival: np.ndarray
    upd_rdep: np.ndarray
    upd_pdep: np.ndarray
    extras: Tuple[np.ndarray, ...]
    freed: np.ndarray
    freed_seqs: np.ndarray
    item_rows: int
    final: bool


class ChunkedWorkload:
    """Merge a request stream into arrival/departure events and cut them
    into :class:`EventChunk` s over a recycled row pool.

    The pending-departure heap is keyed ``(departure_time, item_seq)`` -
    together with "drain every departure whose time <= the next arrival's
    time first", this reproduces the in-memory event order exactly (time,
    then departures-before-arrivals, then source position).  ``grow``
    doubles the pool when the alive population outruns it (the driver
    pads pool and carry once per growth); identity mode disables recycling
    and pins ``item_rows`` to the full item count."""

    def __init__(self, source, policy: str, *, chunk_events: int = 2048,
                 item_rows: int = 256, grow: bool = True,
                 identity: bool = False):
        spec = policy_spec(policy)
        self.source = source
        self.spec = spec
        self.chunk_events = int(chunk_events)
        self.identity = bool(identity or spec.family == "hybrid")
        if self.identity:
            n = source.meta().n_items
            assert n >= 0, \
                f"{policy!r} streams in identity (whole-table) mode, " \
                "which needs a source with a known item count"
            item_rows = max(int(n), 1)
            grow = False
        self.item_rows = max(int(item_rows), 1)
        self.grow = bool(grow)
        self.d = source.meta().d
        # live pool state (populated while chunks() runs)
        self._row_seq = {}          # pool row -> global item seq, alive only
        self._seq_count = 0
        self._done = False

    # ------------------------------------------------------------ builder
    def chunks(self) -> Iterator[EventChunk]:
        C, d = self.chunk_events, self.d
        rcp = self.spec.family == "rcp"
        free: list = []             # allocatable rows (min-heap)
        next_fresh = 0
        heap: list = []             # (dep_time f64, seq, row) pending deps
        seen_cats = [False] * KCAT
        xcount = 0
        last_arr = -np.inf

        ev_t = np.zeros(C, np.float32)
        ev_k = np.full(C, PAD_KIND, np.int32)
        ev_i = np.zeros(C, np.int32)
        ev_x = np.zeros(C, np.int32)
        upd_idx = np.full(C, POOL_SENTINEL, np.int32)
        upd_size = np.zeros((C, d), np.float32)
        upd_arr = np.zeros(C, np.float32)
        upd_rdep = np.zeros(C, np.float32)
        upd_pdep = np.zeros(C, np.float32)
        freed: list = []            # rows released by this chunk's deps
        freed_seqs: list = []
        fill = 0                    # events in the open chunk
        nupd = 0                    # pool updates in the open chunk

        def cut(final: bool) -> EventChunk:
            nonlocal fill, nupd
            # freed rows padded to the fixed (C,) geometry too, so every
            # chunk's placement harvest has one shape
            fr = np.full(C, POOL_SENTINEL, np.int32)
            fr[:len(freed)] = freed
            fseq = np.full(C, -1, np.int64)
            fseq[:len(freed_seqs)] = freed_seqs
            chunk = EventChunk(
                ev_t.copy(), ev_k.copy(), ev_i.copy(), fill,
                upd_idx.copy(), upd_size.copy(), upd_arr.copy(),
                upd_rdep.copy(), upd_pdep.copy(),
                (ev_x.copy(),) if rcp else (),
                fr, fseq, self.item_rows, final)
            # rows freed by this chunk become allocatable from the next
            # chunk on - never inside it (the pool scatter is chunk-start)
            for r in freed:
                heapq.heappush(free, int(r))
            freed.clear()
            freed_seqs.clear()
            ev_t[:] = 0.0
            ev_k[:] = PAD_KIND
            ev_i[:] = 0
            ev_x[:] = xcount
            upd_idx[:] = POOL_SENTINEL
            upd_size[:] = 0.0
            upd_arr[:] = upd_rdep[:] = upd_pdep[:] = 0.0
            fill = nupd = 0
            return chunk

        def put(t: float, kind: int, row: int) -> Optional[EventChunk]:
            nonlocal fill, xcount
            ev_t[fill] = np.float32(t)
            ev_k[fill] = kind
            ev_i[fill] = row
            ev_x[fill] = xcount
            fill += 1
            return cut(False) if fill == C else None

        def alloc(seq: int) -> int:
            nonlocal next_fresh
            if not self.identity and free:
                return heapq.heappop(free)
            if next_fresh >= self.item_rows:
                if not self.grow:
                    raise RuntimeError(
                        f"item-row pool exhausted ({self.item_rows} rows) "
                        f"at request #{seq} with grow=False; pass a larger "
                        "item_rows or grow=True")
                self.item_rows *= 2
            row = next_fresh
            next_fresh += 1
            return row

        for size, arr, rdep, pdep in self.source.records():
            if arr < last_arr:
                raise ValueError(
                    f"stream not arrival-sorted: {arr} after {last_arr}")
            assert rdep > arr, f"departure {rdep} <= arrival {arr}"
            last_arr = arr
            # every departure at or before this arrival's time goes first
            # (equal times: departures precede arrivals, by item seq)
            while heap and heap[0][0] <= arr:
                dt, dseq, drow = heapq.heappop(heap)
                freed.append(drow)
                freed_seqs.append(dseq)
                del self._row_seq[drow]
                out = put(dt, DEPARTURE_KIND, drow)
                if out is not None:
                    yield out
            seq = self._seq_count
            self._seq_count += 1
            row = seq if self.identity else alloc(seq)
            if rcp:
                # host twin of the device category: float32 duration
                # arithmetic end to end, frexp-exact class boundaries
                pdur = np.float32(pdep) - np.float32(arr)
                cat = int(np.clip(geo_class(max(pdur, np.float32(0.0))),
                                  0, KCAT - 1))
                if not seen_cats[cat]:
                    seen_cats[cat] = True
                    xcount += 1
            self._row_seq[row] = seq
            upd_idx[nupd] = row
            upd_size[nupd] = np.asarray(size, np.float32)[:d]
            upd_arr[nupd] = np.float32(arr)
            upd_rdep[nupd] = np.float32(rdep)
            upd_pdep[nupd] = np.float32(pdep)
            nupd += 1
            heapq.heappush(heap, (float(rdep), seq, row))
            out = put(arr, ARRIVAL_KIND, row)
            if out is not None:
                yield out
        while heap:                 # drain the tail departures
            dt, dseq, drow = heapq.heappop(heap)
            freed.append(drow)
            freed_seqs.append(dseq)
            del self._row_seq[drow]
            out = put(dt, DEPARTURE_KIND, drow)
            if out is not None:
                yield out
        self._done = True
        yield cut(True)

    # ----------------------------------------------------------- queries
    @property
    def n_items(self) -> int:
        """Items streamed so far (total once the stream is drained)."""
        return self._seq_count

    def live_rows(self):
        """{pool row: global item seq} still alive (empty after a full
        drain; non-empty only if iteration stopped early)."""
        return dict(self._row_seq)


def synthetic_source(n_items: int, d: int = 4, seed: int = 0,
                     pm_cores: int = 64, med_lifetime: float = 1800.0,
                     sigma_lifetime: float = 1.6,
                     name: str = "stream_synth") -> InstanceSource:
    """A calibrated synthetic request stream (the azure-like generator),
    sized for benchmarks: ``n_items`` VMs => ``2 n_items`` events."""
    from ..data.traces import _one_instance
    return InstanceSource(_one_instance(seed, n_items, d, pm_cores,
                                        med_lifetime, sigma_lifetime, name))


def chunk_instance_events(times, kinds, items, chunk_events: int,
                          extras: Tuple[np.ndarray, ...] = ()):
    """Cut pre-materialized single-lane event arrays (any kinds, including
    MIGRATE) into PAD-padded fixed-geometry slices - the low-level chunking
    used by ``stream.replay.replay_chunked_events`` and the chunk-boundary
    tests.  Yields (times, kinds, items, extras, final) per chunk."""
    C = int(chunk_events)
    E = len(times)
    times = np.asarray(times, np.float32)
    kinds = np.asarray(kinds, np.int32)
    items = np.asarray(items, np.int32)
    nchunks = max(-(-E // C), 1)
    for s in range(0, nchunks * C, C):
        e = min(s + C, E)
        t = np.zeros(C, np.float32)
        k = np.full(C, PAD_KIND, np.int32)
        i = np.zeros(C, np.int32)
        t[:e - s] = times[s:e]
        k[:e - s] = kinds[s:e]
        i[:e - s] = items[s:e]
        ex = []
        for x in extras:
            xa = np.asarray(x)
            pad = np.zeros(C, xa.dtype)
            pad[:e - s] = xa[s:e]
            if e > s:               # PAD events carry the running value
                pad[e - s:] = xa[e - 1]
            ex.append(pad)
        yield t, k, i, tuple(ex), e >= E
