"""The streamed replay driver: chunked device work on a carried state;
counterpart of ``repro.stream.replay``.

``replay_stream`` drives one policy over one request stream in
fixed-geometry chunks (see ``stream.events``).  Each chunk is one step:

  1. its newly arrived items are scattered into the row pool, in place,
     the ``POOL_SENTINEL`` padding of the update masked out;
  2. its per-event streams are built on the host from the pool
     (``torchsim.event_streams``: the items' sizes, predicted departures
     and category constants gathered per event, RCP's running count from
     the builder) and staged on the device;
  3. the C events are replayed by ``torchsim.replay_streams`` - the device
     half of ``_replay_batch`` - with the carry threaded in and out
     (``carry0`` / ``return_carry``, the checkpoint machinery): per event
     through the graphed select, or blocked through the megakernel
     (``ops.replay_chunk``);
  4. the placements of the rows the chunk freed are read back before the
     rows are recycled (``collect_placements``).

Usage, opened bins and overflow accumulate in the carry, so the last
chunk's outputs are the whole run's, bit for bit those of the in-memory
replay of the same events.

The row pool lives on the host: the port's replay reads items' sizes and
constants per event from the streams of step 2, never from an item table
on the device.  So the device holds the carry (O(slots + pool rows)) and
at most ``prefetch + 1`` staged chunks, whatever the trace's length;
``StreamResult.peak_device_bytes`` accounts for them.

Staging: with ``prefetch=1`` the host builds the next chunk while the
device replays this one, copies it into pinned host buffers and from
there to the device on a second CUDA stream, and the replay stream waits
on the copy's event.  All of it runs on the replay's own
host thread: a CUDA graph capture (the per-event path captures one a
chunk) forbids CUDA calls from other threads.  A staged tensor is
allocated on the copy stream and marked used on the replay stream
(``record_stream``), and a pinned buffer is refilled only once its copy
has completed.  ``prefetch=0`` is the synchronous mode (the host waits
for each chunk).  Results never depend on ``prefetch``, ``chunk_events``,
``item_rows`` or ``block_events``.

The depth stops at one chunk because of checkpoints: a chunk's rows are
scattered into the pool when it is built, so a snapshot taken after chunk
k holds the pool of chunk k + ``prefetch``.  Resuming rebuilds chunk k+1's
streams from that pool.  One chunk ahead is safe (chunk k+1 reuses only
rows whose items left by chunk k); two are not, as chunk k+2 may reuse
rows that chunk k+1 still reads.

Overflow keeps the in-memory escalation ladder: the stream is replayed
again from the source with a doubled slot pool, up to the cap
(``CapacityError``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..core import torchsim
from ..core.torchsim import CapacityError, MAX_BINS_CAP, grow_max_bins
from ..kernels.ops import resolve_device
from .events import (POOL_SENTINEL, ChunkedWorkload, InstanceSource,
                     chunk_instance_events)


@dataclasses.dataclass(frozen=True)
class StreamResult:
    """Outcome of one streamed replay (a single lane)."""
    usage: float
    opened: int
    overflow: bool
    max_bins: int
    n_items: int
    n_events: int
    n_chunks: int
    item_rows: int
    peak_device_bytes: int
    placements: Optional[np.ndarray] = None


def _pool0(item_rows: int, d: int):
    f32 = np.float32
    return {"sizes": np.zeros((1, item_rows, d), f32),
            "arrivals": np.zeros((1, item_rows), f32),
            "rdeps": np.zeros((1, item_rows), f32),
            "pdeps": np.zeros((1, item_rows), f32)}


def _pool_full(source: InstanceSource):
    """Identity (hybrid) mode: the whole item table up front."""
    sizes, arrivals, rdeps, pdeps = source.full_arrays()
    return {"sizes": np.asarray(sizes, np.float32)[None],
            "arrivals": np.asarray(arrivals, np.float32)[None],
            "rdeps": np.asarray(rdeps, np.float32)[None],
            "pdeps": np.asarray(pdeps, np.float32)[None]}


def _grow_pool(pool, item_rows: int):
    n = pool["sizes"].shape[1]
    if item_rows <= n:
        return pool
    return {k: np.concatenate(
        [v, np.zeros((1, item_rows - n) + v.shape[2:], v.dtype)], axis=1)
        for k, v in pool.items()}


def _carry_rows(carry) -> int:
    return carry["itemi"].shape[1] if isinstance(carry, dict) \
        else carry[7].shape[1]


def _scatter(pool, ch) -> None:
    """The chunk's new rows into the pool, in place; the update's
    ``POOL_SENTINEL`` padding is masked out."""
    m = ch.upd_idx != POOL_SENTINEL
    rows = ch.upd_idx[m]
    pool["sizes"][0, rows] = ch.upd_size[m]
    pool["arrivals"][0, rows] = ch.upd_arrival[m]
    pool["rdeps"][0, rows] = ch.upd_rdep[m]
    pool["pdeps"][0, rows] = ch.upd_pdep[m]


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) \
        else 0


class _Stager:
    """Host streams of a chunk onto the replay's device.

    On the CPU the host tensors are used as they are.  On the card each
    chunk's tensors go through a set of pinned host buffers (one set a
    staged chunk, refilled only once its last copy has completed) to
    device tensors allocated on a copy stream, and ``wait`` makes the
    replay stream wait for the copy and marks the tensors as used there
    (``record_stream``), so their memory is not reused before the replay
    has read them."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.copy = torch.cuda.Stream(dev)
            # (pinned buffers, the event of their last copy) a staged chunk:
            # the one replayed and the one prefetched
            self.free = deque([(None, None)] * 2)

    def stage(self, tensors):
        if not self.cuda:
            return tensors, None
        bufs, done = self.free.popleft()
        if done is not None:
            done.synchronize()          # its last copy has completed
        if bufs is None or any(b.shape != t.shape or b.dtype != t.dtype
                               for b, t in zip(bufs, tensors)):
            bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in tensors]
        for b, t in zip(bufs, tensors):
            b.copy_(t)
        with torch.cuda.stream(self.copy):
            out = [b.to(self.dev, non_blocking=True) for b in bufs]
            event = torch.cuda.Event()
            event.record(self.copy)
        self.free.append((bufs, event))
        return out, event

    def wait(self, staged, event):
        if event is None:
            return staged
        cur = torch.cuda.current_stream(self.dev)
        cur.wait_event(event)
        for t in staged:
            t.record_stream(cur)
        return staged


def _replay_once(source, policy, *, chunk_events, item_rows, max_bins,
                 dev, block_events, prefetch, grow_pool, collect_placements,
                 checkpointer):
    wl = ChunkedWorkload(source, policy, chunk_events=chunk_events,
                         item_rows=item_rows, grow=grow_pool)
    d = wl.d
    T = int(block_events) if block_events and block_events > 1 else 0
    carry = torchsim.replay_init_carry(policy, max_bins, d, wl.item_rows,
                                       L=1, block_events=T, device=dev)
    pool = _pool_full(source) if wl.identity else _pool0(wl.item_rows, d)
    gen = wl.chunks()
    resumed = 0
    ckpt_key = None
    if checkpointer is not None:
        if collect_placements:
            raise ValueError("a checkpointed streamed replay does not "
                             "collect placements (the freed rows' log is "
                             "not in the snapshot)")
        from ..resilience.checkpoint import to_device
        ckpt_key = checkpointer.key(
            source.meta().fingerprint, policy=policy, max_bins=max_bins,
            device_type=dev.type, block_events=T,
            chunk_events=chunk_events)
        state = checkpointer.load(ckpt_key)
        if state is not None:
            carry, pool, resumed = state
            carry = to_device(carry, dev)
            for _ in range(resumed):    # the host builder, fast-forwarded
                next(gen)

    depth = int(prefetch)
    stager = _Stager(dev)
    staged: deque = deque()
    harvest = []                # (freed_seqs, freed placements) a chunk
    last = None
    nchunks = resumed
    peak = 0
    done = False
    while True:
        while not done and len(staged) <= depth:
            try:
                ch = next(gen)
            except StopIteration:
                done = True
                break
            # the builder may have outgrown the pool: pad it before the
            # scatter (the carry is padded when the chunk is replayed)
            pool = _grow_pool(pool, ch.item_rows)
            _scatter(pool, ch)
            n1 = np.array([pool["sizes"].shape[1]])
            ev_i, ev_f, ev_size, dmask_p, _ = torchsim.event_streams(
                policy, pool["sizes"], ch.times[None], ch.kinds[None],
                ch.items[None], pool["pdeps"], None, pool["arrivals"],
                pool["rdeps"], n1,
                tuple(x[None] for x in ch.extras) or None, block_events=T)
            dev_t, event = stager.stage([ev_i, ev_f, ev_size, dmask_p])
            staged.append((ch, dev_t, event))
            peak = max(peak, _nbytes(carry) +
                       sum(_nbytes(s[1]) for s in staged))
        if not staged:
            break
        ch, dev_t, event = staged.popleft()
        if ch.item_rows > _carry_rows(carry):
            # fresh rows are virgin (placements -1, zero category state):
            # a row is named only once the builder has assigned it
            obs.counter_add("stream.pool_growths")
            carry = torchsim.grow_item_rows(carry, ch.item_rows)
        ev_i, ev_f, ev_size, dmask_p = stager.wait(dev_t, event)
        usage, opened, placements, overflow, carry = \
            torchsim.replay_streams(
                ev_i, ev_f, ev_size, dmask_p, d, policy=policy,
                max_bins=max_bins, n_max=_carry_rows(carry), device=dev,
                block_events=T, carry0=carry, return_carry=True)
        if collect_placements:
            m = ch.freed != POOL_SENTINEL
            rows = torch.from_numpy(ch.freed[m].astype(np.int64)).to(dev)
            harvest.append((ch.freed_seqs[m], placements[0, rows]))
        last = (usage, opened, overflow)
        nchunks += 1
        if depth == 0 and dev.type == "cuda":
            torch.cuda.synchronize(dev)   # the synchronous mode
        if checkpointer is not None:
            checkpointer.maybe_save(ckpt_key, carry, pool, nchunks,
                                    final=ch.final)

    usage, opened, overflow = (x.cpu() for x in last)
    out = None
    if collect_placements:
        out = np.full(wl.n_items, -1, np.int32)
        for seqs, fp in harvest:
            out[seqs] = fp.cpu().numpy()
        live = wl.live_rows()
        if live:                   # items still alive at the stream's end
            final = (carry["itemi"][0, :, torchsim.fk.ITEMI_PLACE]
                     if isinstance(carry, dict) else carry[7][0]).cpu()
            for row, seq in live.items():
                out[seq] = int(final[row])
    return StreamResult(float(usage[0]), int(opened[0]), bool(overflow[0]),
                        max_bins, wl.n_items, 2 * wl.n_items, nchunks,
                        _carry_rows(carry), int(peak), out)


def replay_stream(source, policy: str, *, chunk_events: int = 2048,
                  item_rows: int = 256, max_bins: int = 64,
                  max_bins_cap: int = MAX_BINS_CAP, auto_grow: bool = True,
                  device="cuda", block_events: int = 0, prefetch: int = 1,
                  grow_pool: bool = True, collect_placements: bool = False,
                  checkpointer=None) -> StreamResult:
    """Replay one request stream under one policy in bounded memory, on
    ``device`` ("cuda" unless the caller asks for "cpu").

    Equal bit for bit to ``torchsim.simulate`` on the materialized
    instance (the same events, the same carry, the same escalation
    ladder); device memory O(item-row pool + slot pool + staged chunks).
    ``block_events > 1`` replays each chunk through the megakernel.
    ``checkpointer`` (a ``resilience.StreamCheckpointer``) snapshots the
    carry and the pool at chunk boundaries and resumes from the last one.
    ``prefetch`` is 1 (build and stage the next chunk while this one
    replays) or 0 (synchronous); see the module docstring for why it goes
    no deeper."""
    if prefetch not in (0, 1):
        raise ValueError(f"prefetch={prefetch!r}: 0 (synchronous) or 1 "
                         "(one chunk staged ahead)")
    dev = resolve_device(device)
    torchsim.policy_spec(policy)     # refuse a bad name before any work
    with obs.span("stream.replay", cat="stream", policy=policy,
                  device=dev.type, chunk_events=int(chunk_events)):
        while True:
            res = _replay_once(
                source, policy, chunk_events=chunk_events,
                item_rows=item_rows, max_bins=max_bins, dev=dev,
                block_events=block_events, prefetch=prefetch,
                grow_pool=grow_pool, collect_placements=collect_placements,
                checkpointer=checkpointer)
            if not res.overflow or not auto_grow:
                return res
            if max_bins >= max_bins_cap:
                raise CapacityError(
                    f"slot pool exhausted streaming with {policy!r}: "
                    f"still overflowing at max_bins={max_bins} "
                    f"(cap {max_bins_cap})", policy=policy,
                    max_bins=max_bins)
            obs.counter_add("stream.overflow_rungs")
            max_bins = grow_max_bins(max_bins, max_bins_cap)


def replay_chunked_events(sizes, times, kinds, items, pdeps, arrivals,
                          rdeps, *, policy: str, chunk_events: int,
                          max_bins: int, device="cuda",
                          block_events: int = 0, migrate: bool = False,
                          ev_extra=None):
    """Replay one lane's pre-materialized event arrays (any kinds, MIGRATE
    included) in fixed-geometry chunks with the carry threaded across the
    boundaries: the chunked path of the chunk-boundary tests, on the full
    item table.  ``ev_extra`` (full event axis, e.g. ``torchsim.
    replay_event_extras``) is sliced per chunk as the checkpointed replay
    slices segments.  Returns numpy (usage, opened, placements, overflow)
    of the lane, as ``_replay_batch`` gives them."""
    dev = resolve_device(device)
    sizes = np.asarray(sizes, np.float32)
    n_max, d = sizes.shape
    T = int(block_events) if block_events and block_events > 1 else 0
    carry = torchsim.replay_init_carry(policy, max_bins, d, n_max, L=1,
                                       block_events=T, device=dev)
    pool = [np.asarray(a, np.float32)[None] for a in (pdeps, arrivals,
                                                       rdeps)]
    extras = tuple(np.asarray(x)[0] if np.asarray(x).ndim == 2 else
                   np.asarray(x) for x in (ev_extra or ()))
    out = None
    for t, k, i, ex, _final in chunk_instance_events(
            times, kinds, items, chunk_events, extras):
        streams = torchsim.event_streams(
            policy, sizes[None], t[None], k[None], i[None], pool[0], None,
            pool[1], pool[2], np.array([n_max]),
            tuple(x[None] for x in ex) or None, block_events=T)
        out = torchsim.replay_streams(
            *streams, policy=policy, max_bins=max_bins, n_max=n_max,
            device=dev, block_events=T, carry0=carry, return_carry=True,
            migrate=migrate)
        carry = out[4]
    usage, opened, placements, overflow = (v.cpu().numpy()[0]
                                           for v in out[:4])
    return usage, opened, placements, overflow
