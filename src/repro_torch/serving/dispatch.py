"""Batched admission: double-buffered block placement for the serving
front end (the port's ``repro.serving.dispatch``).

``DVBPScheduler.place`` places ONE request a decision.  This module is the
throughput path: the ``AdmissionQueue`` accumulates pending requests and
``BlockDispatcher`` drains them as ONE ``fitscore_replay_block`` launch -
a block of T pending arrivals (plus the departures that fired since the
last block) placed by the replay megakernel in one pass, on the fleet's
carry, as the sweep's blocked replay places a block of a trace.

**Live carry.**  The dispatcher owns a persistent one-lane packed carry
(``core.torchsim.make_live_carry``).  Unlike the scheduler's T=1 snapshot
select (which disables the kernel's free-slot stage and lets the host
``BinPool`` open bins), the live carry keeps real slot counts: the kernel
opens and closes slots itself, and the host keeps only a mirror mapping
kernel slots to replica ids for the fleet accounting (replica-seconds,
opened, peak).  Item rows come from a host free list and are recycled only
when the departure's block *resolves*: the host reads the arrival's
placement from the block's copy of ``itemi[:, ITEMI_PLACE]`` after the
fact.

**The carry is updated in place.**  The megakernel (and its plain version
on the CPU) writes the carry it is given.  So before each block the
dispatcher copies the carry (device to device, tens of KB at L=1): that
copy is the block's pre-block carry, from which an overflow or an
injected fault replays the block and every newer one.

**Double buffering.**  ``flush`` stages a block's host streams through
pinned buffers, launches it, queues non-blocking copies of its placements
and status into pinned host memory and records a CUDA event behind them,
and returns: the card places block k while the host assembles block k+1.
Up to ``depth`` blocks stay in flight; ``_resolve`` waits only on the
oldest block's event, when the pipeline is full or results are demanded.
Each in-flight block keeps its pinned streams and device copies alive
until it resolves.  On the CPU every block runs as it is dispatched.

**Fixed T geometries.**  Blocks pad with ``PAD_KIND`` no-op events to a
small fixed set of sizes (default 1/8/32/256), so the set of launch
geometries stays bounded; the ``serving.jit_trace`` /
``serving.jit_cache_hit`` counters (off ``kernels.ops.
dispatch_trace_count``, the reference's names) say whether a block added
one.

**Degradation ladder.**  Each block crosses the ``serving.select`` fault
seam once a rung: ``block`` (the megakernel at T), ``events`` (the same
megakernel at T=1, one launch an event) and, on a card, ``cpu``
(``replay_block_ref`` on a CPU copy of the carry, copied back), each step
counted ``resilience.degrade_dispatch_<from>_<to>``.  Only an injected
fault steps down (``resilience.guard.is_degradable``): a real OOM is
retried and then raises, any other real error raises at once.  Before a
retry or a lower rung the carry is restored from the block's copy, since
a rung that failed part way may have replayed part of the block.  An
overflow (the pool ran out of slots) doubles the pool
(``grow_live_carry``) and replays the failed block and every newer one
from its pre-block carry; past ``ops.REPLAY_WARP_MAX_SLOTS`` slots the
blocks take the global kernel instead of the warp one, on the same
carry layout.

**Equivalence.**  Events enter the stream in global time order (the front
end drains the admission queue before it enqueues a departure), the
blocked kernel replays them one at a time, and its decisions equal the
per-event replay's and the host algorithm zoo's - so a block of 256
requests lands every request where one-at-a-time placement would have.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core import torchsim
from ..core.algorithms.departure import departure_window
from ..core.algorithms.duration import duration_class
from ..core.algorithms.learned import geo_class, la_class
from ..kernels import fitscore as fk
from ..kernels import ops
from ..resilience import faults, guard
from .admission import AdmissionQueue
from .scheduler import ReplicaCapacity, Request

DEFAULT_GEOMETRIES = (1, 8, 32, 256)


@dataclasses.dataclass
class _Event:
    kind: int            # ARRIVAL_KIND / DEPARTURE_KIND / MIGRATE_KIND
    rid: int
    row: int             # item row in the carry
    t: float
    pdep: float          # absolute (predicted) departure time
    size: np.ndarray
    cat: int = 0         # family category (cbd/cbdt/rcp/la)
    large: int = 0       # rcp: size exceeds 1/2 in some dimension
    x: int = 0           # rcp: running distinct-category count


@dataclasses.dataclass
class _Inflight:
    """One dispatched, unresolved block: what reads its placements back,
    and what replays it after an overflow or an injected fault."""
    events: List[_Event]
    streams: tuple        # (ev_i, ev_f, ev_size) host tensors, padded to T
    T: int
    migrate: bool = False  # consolidation drain block (MIGRATE events)
    carry_in: Optional[dict] = None   # a copy of the pre-block carry
    staged: tuple = ()     # the streams on the carry's device
    place: Optional[torch.Tensor] = None   # itemi[0, :, PLACE] after it
    status: Optional[torch.Tensor] = None  # si[0] after it
    done: Optional[torch.cuda.Event] = None   # recorded behind the copies


def _copy(carry: dict) -> dict:
    return {k: v.clone() for k, v in carry.items()}


def _restore(carry: dict, src: dict) -> None:
    for k, v in carry.items():
        v.copy_(src[k])


class BlockDispatcher:
    """Blocks of pending events -> one megakernel launch on a live carry,
    on ``device`` (the card unless the caller passes "cpu")."""

    def __init__(self, policy: str, caps: ReplicaCapacity = ReplicaCapacity(),
                 tps: float = 50.0, d: int = 3, max_bins: int = 64,
                 max_items: int = 1024,
                 geometries: Sequence[int] = DEFAULT_GEOMETRIES,
                 device="cuda", depth: int = 2):
        self.policy = policy
        self.caps = caps
        self.tps = tps
        self.d = d
        self.max_bins = max_bins
        self.depth = depth
        self.geometries = tuple(sorted(set(int(g) for g in geometries)))
        if not self.geometries or self.geometries[0] < 1:
            raise ValueError(f"block geometries {geometries}: each >= 1")
        spec = torchsim.policy_spec(policy)
        self._spec = spec
        self.family = torchsim._KERNEL_FAMILY[spec.family]
        if spec.adaptive_alpha:
            raise ValueError(
                f"{policy!r} (PPE guess-and-double) scores real durations at "
                "departure - not observable on a live stream; use rcp / "
                "rcp_modified")
        self._needs_pred = self.family in ("cbd", "rcp", "la")
        self.dev = ops.resolve_device(device)
        self._carry = torchsim.make_live_carry(policy, max_bins, d,
                                               max_items, self.dev)
        self._dmask = torch.zeros((1, fk.DPAD), dtype=torch.float32)
        self._dmask[0, :d] = 1.0
        self._dmask_dev = self._dmask.to(self.dev)
        self._n_items = max_items
        self._free = list(range(max_items - 1, -1, -1))   # pop() -> row 0..
        self._pending: List[_Event] = []
        self._inflight: List[_Inflight] = []
        self._rid_arrival: Dict[int, _Event] = {}
        self._rcp_seen: set = set()
        # host mirror: kernel slot -> fleet accounting
        self._slot_count = np.zeros(max_bins, np.int64)
        self._slot_replica = np.full(max_bins, -1, np.int64)
        self._slot_opened_at = np.zeros(max_bins)
        self._next_replica = 0
        self._rid_slot: Dict[int, int] = {}
        self._rid_wall: Dict[int, float] = {}
        self.placements: Dict[int, int] = {}
        self.latencies: List[float] = []
        self.replica_seconds = 0.0
        self.replicas_opened = 0
        self.peak_replicas = 0
        self._open_now = 0

    # --------------------------------------------------------- event intake
    def _categorize(self, pdur: Optional[float], t: float,
                    size: np.ndarray) -> Tuple[int, int, int]:
        """Per-arrival family constants from the host's float64
        classifiers - the ones ``DVBPScheduler`` and the host zoo use, so
        all paths agree on class boundaries."""
        if self._needs_pred and pdur is None:
            raise ValueError(f"{self.policy!r} needs predicted decode "
                             "lengths")
        if self._spec.family == "cbd":
            return int(duration_class(pdur, self._spec.beta)), 0, 0
        if self._spec.family == "cbdt":
            return int(departure_window(t + pdur, self._spec.rho)), 0, 0
        if self.family == "rcp":
            cat = int(np.clip(geo_class(max(pdur, 0.0)), 0, fk.KCAT - 1))
            self._rcp_seen.add(cat)
            return cat, int(float(size.max()) > 0.5), len(self._rcp_seen)
        if self.family == "la":
            return int(la_class(pdur, self._spec.la_mode)), 0, 0
        return 0, 0, 0

    def enqueue_arrival(self, req: Request, now: float,
                        wall_t: Optional[float] = None) -> None:
        size = req.size(self.caps)
        pdur = None if req.predicted_decode_len is None else \
            req.predicted_decode_len / self.tps
        pdep = now if pdur is None else now + pdur
        cat, large, x = self._categorize(pdur, now, size)
        if not self._free:
            self._grow_items()
        row = self._free.pop()
        self._rid_wall[req.rid] = time.perf_counter() if wall_t is None \
            else wall_t
        ev = _Event(fk.ARRIVAL_KIND, req.rid, row, now, pdep, size, cat,
                    large, x)
        self._rid_arrival[req.rid] = ev
        self._pending.append(ev)
        if len(self._pending) >= self.geometries[-1]:
            self.flush()

    def enqueue_departure(self, rid: int, now: float) -> None:
        """The request finished: append its departure event.  Its arrival
        must already be enqueued (the front end drains admission before
        finishing, keeping the event stream in global time order)."""
        arr = self._rid_arrival.pop(rid, None)
        if arr is None:
            raise KeyError(
                f"finish({rid}) before its arrival was dispatched; the "
                "front end must drain admission first")
        self._pending.append(dataclasses.replace(
            arr, kind=fk.DEPARTURE_KIND, t=now,
            x=len(self._rcp_seen) if self.family == "rcp" else 0))
        # the row is freed when the departure's block resolves, not here:
        # a newer arrival must not take it while an older block that names
        # it is still in flight
        if len(self._pending) >= self.geometries[-1]:
            self.flush()

    def _grow_items(self) -> None:
        self.sync()   # nothing in flight: no pre-block carry to widen
        new = 2 * self._n_items
        self._carry = torchsim.grow_live_items(self._carry, new)
        self._free = list(range(new - 1, self._n_items - 1, -1)) + self._free
        self._n_items = new

    # ------------------------------------------------------------- dispatch
    def _geometry(self, m: int) -> int:
        for g in self.geometries:
            if m <= g:
                return g
        return self.geometries[-1]

    def _streams(self, events: List[_Event], T: int) -> tuple:
        """A block's host streams in the megakernel's layout
        (``fitscore.stack_event_streams``: the channels of
        ``REPLAY_EV_I_NAMES`` / ``REPLAY_EV_F_NAMES`` of the family, as
        ``torchsim.event_streams`` builds them), PAD filler to ``T``."""
        m = len(events)

        def col(name, dtype, fill=0):
            a = np.full((1, T), fill, dtype)
            a[0, :m] = [getattr(ev, name) for ev in events]
            return a

        size = np.zeros((1, T, fk.DPAD), np.float32)
        size[0, :m, :self.d] = np.stack([ev.size for ev in events])
        ones = np.ones((1, T), np.float32)
        ev_i, ev_f = fk.stack_event_streams(
            self.family,
            {"kind": col("kind", np.int32, fk.PAD_KIND),
             "item": col("row", np.int32), "cat": col("cat", np.int32),
             "large": col("large", np.int32), "x": col("x", np.int32)},
            # open-ended streams never observe real durations: RCP's
            # prediction error and adaptive's departure error stay 1, the
            # host classes' behaviour on serving request ids
            {"t": col("t", np.float32), "pdep": col("pdep", np.float32),
             "p2err": ones, "errmax": ones})
        return ev_i, ev_f, torch.from_numpy(size)

    def _stage(self, rec: _Inflight) -> None:
        """The block's streams on the carry's device, once: on the card
        through pinned buffers and non-blocking copies (the record keeps
        both alive until the block resolves), as they are on the CPU."""
        if rec.staged:
            return
        if self.dev.type != "cuda":
            rec.staged = rec.streams
            return
        rec.streams = tuple(s.pin_memory() for s in rec.streams)
        rec.staged = tuple(s.to(self.dev, non_blocking=True)
                           for s in rec.streams)

    def _rungs(self) -> List[str]:
        return ["block", "events"] + (["cpu"] if self.dev.type == "cuda"
                                      else [])

    def _run_rung(self, label: str, carry: dict, rec: _Inflight) -> None:
        kw = dict(policy=self.policy, n=self.max_bins, d=self.d,
                  migrate=rec.migrate)
        ev_i, ev_f, ev_size = rec.staged
        if label == "block":
            ops.fitscore_replay_dispatch(carry, ev_i, ev_f, ev_size,
                                         self._dmask_dev, **kw)
        elif label == "events":
            # the same kernel, one event a launch
            for j in range(rec.T):
                ops.fitscore_replay_dispatch(
                    carry, ev_i[:, :, j:j + 1], ev_f[:, :, j:j + 1],
                    ev_size[:, j:j + 1], self._dmask_dev, **kw)
        else:
            # the plain version on a CPU copy, copied back to the card
            host = {k: v.cpu() for k, v in carry.items()}
            ops.fitscore_replay_dispatch(host, *rec.streams, self._dmask,
                                         **kw)
            _restore(carry, host)

    def _dispatch(self, carry: dict, rec: _Inflight) -> None:
        """Replay ``rec``'s block on ``carry`` in place, down the ladder:
        each rung crosses the ``serving.select`` seam and retries an OOM
        (``guard.guarded_call``); an injected fault steps down, counted
        ``resilience.degrade_dispatch_<from>_<to>``."""
        rungs = self._rungs()
        touched = False

        def attempt(label):
            nonlocal touched
            if touched:   # a failed try may have replayed part of the block
                _restore(carry, rec.carry_in)
            touched = True
            faults.fire("serving.select")
            self._run_rung(label, carry, rec)

        for i, label in enumerate(rungs):
            before = ops.dispatch_trace_count()
            try:
                guard.guarded_call(lambda: attempt(label),
                                   site="serving.dispatch")
            except Exception as e:
                if not guard.is_degradable(e) or i + 1 >= len(rungs):
                    raise
                nxt = rungs[i + 1]
                obs.counter_add(f"resilience.degrade_dispatch_{label}_{nxt}")
                obs.instant("resilience.degrade_dispatch", frm=label,
                            to=nxt, error=str(e)[:200])
                continue
            added = ops.dispatch_trace_count() - before
            if added:
                obs.counter_add("serving.jit_trace", added)
            else:
                obs.counter_add("serving.jit_cache_hit")
            return
        raise AssertionError("unreachable: the last rung re-raises")

    def _launch(self, rec: _Inflight, carry: dict) -> None:
        """Copy the pre-block carry, replay the block on ``carry`` and
        queue the copies of its placements and status behind it."""
        rec.carry_in = _copy(carry)
        self._stage(rec)
        self._dispatch(carry, rec)
        place = carry["itemi"][0, :, fk.ITEMI_PLACE]
        status = carry["si"][0]
        if self.dev.type == "cuda":
            rec.place = torch.empty(place.shape, dtype=place.dtype,
                                    pin_memory=True)
            rec.status = torch.empty(status.shape, dtype=status.dtype,
                                     pin_memory=True)
            rec.place.copy_(place, non_blocking=True)
            rec.status.copy_(status, non_blocking=True)
            rec.done = torch.cuda.Event()
            rec.done.record()
        else:
            rec.place, rec.status = place.clone(), status.clone()

    def flush(self) -> None:
        """Dispatch the pending events as one (or, past the largest
        geometry, several) padded block(s); returns without waiting for
        the card - the block runs while the host assembles the next."""
        while self._pending:
            chunk = self._pending[:self.geometries[-1]]
            del self._pending[:len(chunk)]
            T = self._geometry(len(chunk))
            obs.counter_hist("serving.dispatch_batch_size", len(chunk))
            rec = _Inflight(chunk, self._streams(chunk, T), T)
            with obs.span("serving.dispatch", T=T, events=len(chunk),
                          policy=self.policy):
                self._launch(rec, self._carry)
            self._inflight.append(rec)
            while len(self._inflight) > self.depth:
                self._resolve()

    # -------------------------------------------------------------- resolve
    def _readback(self, rec: _Inflight) -> np.ndarray:
        """Wait for the block's event; returns its per-row placements.
        Raises ``CapacityError`` when the block overflowed the pool."""
        if rec.done is not None:
            rec.done.synchronize()
        if int(rec.status[fk.SI_OVERFLOW]) > 0:
            raise torchsim.CapacityError(
                f"live carry overflowed {self.max_bins} slots",
                policy=self.policy, max_bins=self.max_bins)
        return rec.place.numpy()

    def _resolve(self) -> None:
        """Retire the oldest in-flight block: read back its placements and
        update the host replica mirror.  An overflow regrows the pool and
        replays the block and every newer one from the block's pre-block
        carry.  No fault seam is crossed here: the ladder runs when a block
        is dispatched, and an error in the readback is a real one."""
        rec = self._inflight[0]
        while True:
            try:
                with obs.span("serving.resolve", T=rec.T,
                              events=len(rec.events)):
                    place = self._readback(rec)
                break
            except torchsim.CapacityError:
                if self.max_bins >= torchsim.MAX_BINS_CAP:
                    raise
                self.max_bins = torchsim.grow_max_bins(self.max_bins)
                obs.counter_add("serving.carry_regrow")
                self._replay_grown()
            rec = self._inflight[0]
        self._inflight.pop(0)
        now_wall = time.perf_counter()
        for ev in rec.events:
            if ev.kind == fk.ARRIVAL_KIND:
                slot = int(place[ev.row])
                if slot < 0:
                    raise RuntimeError(f"request {ev.rid} unplaced without "
                                       "an overflow")
                self._mirror_place(slot, ev)
                t0 = self._rid_wall.pop(ev.rid, None)
                if t0 is not None:
                    self.latencies.append(now_wall - t0)
            elif ev.kind == fk.MIGRATE_KIND:
                # departure half: leave the source slot (closing it if the
                # migrant was its last occupant) ...
                self._mirror_depart(self._rid_slot.pop(ev.rid), ev.t)
                # ... arrival half: land on the kernel's re-placement (the
                # source slot was kept out of its select)
                slot = int(place[ev.row])
                if slot < 0:
                    raise RuntimeError(f"migrant {ev.rid} unplaced without "
                                       "an overflow")
                self._mirror_place(slot, ev)
            else:
                self._mirror_depart(self._rid_slot.pop(ev.rid), ev.t)
                self._free.append(ev.row)

    def _mirror_place(self, slot: int, ev: _Event) -> None:
        if self._slot_count[slot] == 0:
            self._slot_replica[slot] = self._next_replica
            self._next_replica += 1
            self._slot_opened_at[slot] = ev.t
            self.replicas_opened += 1
            self._open_now += 1
            self.peak_replicas = max(self.peak_replicas, self._open_now)
        self._slot_count[slot] += 1
        self._rid_slot[ev.rid] = slot
        self.placements[ev.rid] = int(self._slot_replica[slot])

    def _mirror_depart(self, slot: int, t: float) -> None:
        self._slot_count[slot] -= 1
        if self._slot_count[slot] == 0:
            self.replica_seconds += t - self._slot_opened_at[slot]
            self._open_now -= 1

    def _replay_grown(self) -> None:
        """Grow the pool to ``max_bins`` and re-dispatch every in-flight
        block from the oldest one's pre-block carry."""
        carry = torchsim.grow_live_carry(self._inflight[0].carry_in,
                                         self.max_bins, self.d)
        pad = self.max_bins - self._slot_count.shape[0]
        if pad > 0:   # the mirror tracks slots: grow it alongside
            self._slot_count = np.concatenate(
                [self._slot_count, np.zeros(pad, np.int64)])
            self._slot_replica = np.concatenate(
                [self._slot_replica, np.full(pad, -1, np.int64)])
            self._slot_opened_at = np.concatenate(
                [self._slot_opened_at, np.zeros(pad)])
        # the streams do not depend on the pool's size: replay them as-is
        for rec in self._inflight:
            self._launch(rec, carry)
        self._carry = carry

    def sync(self) -> None:
        """Flush pending events and resolve every in-flight block."""
        self.flush()
        while self._inflight:
            self._resolve()

    # -------------------------------------------------------- consolidation
    def consolidate(self, now: float, spec) -> Dict[str, int]:
        """Opt-in consolidation drain pass over the live fleet.

        Quiesces the pipeline (``sync``), runs the planner of the batched
        driver and the host oracle (``consolidate.plan_migrations``) on the
        live carry's pool, and dispatches the plan as MIGRATE blocks (the
        megakernel's MIGRATE branch runs only here).  Each migrant leaves
        its source replica (closing it when it was the last occupant) and
        is re-placed by the policy's own select with the source slot
        excluded.  Resolves before returning, so ``placements`` /
        ``replica_seconds`` reflect the drain; returns the churn stats
        (``migrations`` / ``bins_closed`` / ``budget_exhausted``)."""
        from ..consolidate import ConsolidationSpec, plan_migrations
        if isinstance(spec, str):
            spec = ConsolidationSpec.parse(spec)
        if not spec.enabled:
            raise ValueError("consolidate() needs an active spec")
        self.sync()   # plan on a quiesced carry: nothing in flight
        sloti = self._carry["sloti"][0].cpu().numpy()
        loads = self._carry["loads"][0, :, :self.d].cpu().numpy().astype(
            np.float64)
        bin_items: Dict[int, List[int]] = {}
        row_ev: Dict[int, _Event] = {}
        sizes = np.zeros((self._n_items, self.d))
        for rid in sorted(self._rid_slot):
            arr = self._rid_arrival[rid]
            bin_items.setdefault(int(self._rid_slot[rid]), []).append(
                arr.row)
            row_ev[arr.row] = arr
            sizes[arr.row] = arr.size
        plan = plan_migrations(
            loads, sloti[:, fk.SLOTI_COUNTS], sloti[:, fk.SLOTI_ALIVE] > 0,
            sloti[:, fk.SLOTI_OSEQ], bin_items, sizes,
            threshold=spec.threshold, budget=spec.budget)
        stats = {"migrations": len(plan.items),
                 "bins_closed": plan.bins_closed,
                 "budget_exhausted": plan.budget_exhausted}
        obs.counter_add("consolidate.migrations", len(plan.items))
        obs.counter_add("consolidate.bins_closed", plan.bins_closed)
        obs.counter_add("consolidate.budget_exhausted",
                        plan.budget_exhausted)
        if not plan.items:
            return stats
        events = [dataclasses.replace(
            row_ev[row], kind=fk.MIGRATE_KIND, t=now,
            x=len(self._rcp_seen) if self.family == "rcp" else 0)
            for row in plan.items]
        with obs.span("serving.consolidate", policy=self.policy,
                      migrations=len(events),
                      bins_closed=plan.bins_closed):
            while events:
                chunk = events[:self.geometries[-1]]
                del events[:len(chunk)]
                T = self._geometry(len(chunk))
                rec = _Inflight(chunk, self._streams(chunk, T), T,
                                migrate=True)
                self._launch(rec, self._carry)
                self._inflight.append(rec)
            while self._inflight:
                self._resolve()
        return stats


class BatchedFrontEnd:
    """Admission -> batched dispatch: the online serving pipeline.

    ``submit`` feeds the bounded ``AdmissionQueue``; ``tick`` drains up to
    ``batch_max`` survivors into the dispatcher as one block; ``finish``
    drains admission first (keeping the event stream in global time
    order - the equivalence precondition) and then enqueues the departure.
    ``sync`` waits for the pipeline; decisions land in ``placements`` (rid
    -> replica id in opening order, comparable to ``DVBPScheduler.place``'s
    absolute bin indices)."""

    def __init__(self, policy: str,
                 caps: ReplicaCapacity = ReplicaCapacity(),
                 tps: float = 50.0, max_pending: int = 4096,
                 deadline: float = 1e9, batch_max: int = 256,
                 geometries: Sequence[int] = DEFAULT_GEOMETRIES,
                 device="cuda", max_bins: int = 64,
                 max_items: int = 1024, depth: int = 2):
        self.dispatcher = BlockDispatcher(
            policy, caps, tps, max_bins=max_bins, max_items=max_items,
            geometries=geometries, device=device, depth=depth)
        self.queue = AdmissionQueue(None, max_pending=max_pending,
                                    deadline=deadline, batch_max=batch_max)
        self.batch_max = batch_max
        # admission wall clock per rid: the admission-to-placement latency
        # starts here, not at dispatcher enqueue
        self._wall: Dict[int, float] = {}
        # arrivals handed to the dispatcher since its last flush: ``finish``
        # drains admission continuously (keeping the queue short), so the
        # batch trigger counts hand-overs, not queue depth
        self._since_flush = 0

    def submit(self, req: Request, now: float) -> bool:
        wall = time.perf_counter()
        ok = self.queue.submit(req, now)
        if ok:
            self._wall[req.rid] = wall
            if len(self.queue) >= self.batch_max:
                self.tick(now)
        return ok

    def _hand_over(self, req: Request, t_in: float) -> None:
        # the arrival event carries the request's own (submit) time, not
        # the drain time - what the sequential oracle sees when it places
        # each request at its arrival
        self.dispatcher.enqueue_arrival(req, t_in,
                                        wall_t=self._wall.pop(req.rid, None))
        self.queue.stats.placed += 1
        self._since_flush += 1

    def tick(self, now: float) -> int:
        """Drain one admission batch into the dispatcher; returns how many
        requests were dispatched."""
        obs.counter_hist("serving.queue_depth", len(self.queue))
        batch = self.queue.take(now)
        for req, t_in in batch:
            self._hand_over(req, t_in)
        if batch:
            self.dispatcher.flush()
            self._since_flush = 0
        return len(batch)

    def finish(self, rid: int, now: float) -> None:
        """The request's decode completed.  Every queued arrival precedes
        this departure in sim time, so drain them all first."""
        while len(self.queue):
            for req, t_in in self.queue.take(now, limit=len(self.queue)):
                self._hand_over(req, t_in)
        self.dispatcher.enqueue_departure(rid, now)
        if self._since_flush >= self.batch_max:
            self.dispatcher.flush()
            self._since_flush = 0

    def sync(self) -> None:
        self.dispatcher.sync()

    def consolidate(self, now: float, spec) -> Dict[str, int]:
        """One consolidation drain pass on the dispatcher (see
        ``BlockDispatcher.consolidate``)."""
        return self.dispatcher.consolidate(now, spec)

    @property
    def placements(self) -> Dict[int, int]:
        return self.dispatcher.placements

    @property
    def latencies(self) -> List[float]:
        return self.dispatcher.latencies


@dataclasses.dataclass
class ServeReport:
    policy: str
    n_requests: int
    placed: int
    shed: int
    replica_seconds: float
    replicas_opened: int
    peak_replicas: int
    wall_seconds: float
    latencies: List[float]
    placements: Dict[int, int]
    metrics: Dict[str, float]

    @property
    def throughput(self) -> float:
        return self.placed / self.wall_seconds if self.wall_seconds else 0.0

    def latency_quantiles(self, qs=(0.5, 0.99)) -> List[float]:
        lat = np.sort(np.asarray(self.latencies))
        if lat.size == 0:
            return [0.0 for _ in qs]
        return [float(np.quantile(lat, q)) for q in qs]


def serve_traffic(reqs: List[Request], policy: str,
                  caps: ReplicaCapacity = ReplicaCapacity(),
                  tps: float = 50.0, batch_max: int = 256,
                  geometries: Sequence[int] = DEFAULT_GEOMETRIES,
                  device="cuda", max_bins: int = 64,
                  max_items: int = 1024, deadline: float = 1e9,
                  depth: int = 2) -> ServeReport:
    """Drive the batched front end through a request trace, event-driven
    like the sequential oracle (``fleet.simulate_fleet``): departures with
    earlier sim time fire before the next arrival, so the dispatcher's
    event stream - and so every placement - matches one-at-a-time
    placement decision for decision."""
    counters0 = obs.counters()
    fe = BatchedFrontEnd(policy, caps, tps, batch_max=batch_max,
                         geometries=geometries, device=device,
                         max_bins=max_bins, max_items=max_items,
                         deadline=deadline, depth=depth)
    t0 = time.perf_counter()
    heap: List[Tuple[float, int]] = []
    for r in sorted(reqs, key=lambda x: x.arrival):
        while heap and heap[0][0] <= r.arrival:
            ft, rid = heapq.heappop(heap)
            fe.finish(rid, ft)
        if fe.submit(r, r.arrival):
            heapq.heappush(heap, (r.arrival + r.decode_len / tps, r.rid))
    while heap:
        ft, rid = heapq.heappop(heap)
        fe.finish(rid, ft)
    fe.sync()
    wall = time.perf_counter() - t0
    dp = fe.dispatcher
    return ServeReport(
        policy=policy, n_requests=len(reqs),
        placed=len(dp.placements), shed=fe.queue.stats.shed,
        replica_seconds=dp.replica_seconds,
        replicas_opened=dp.replicas_opened,
        peak_replicas=dp.peak_replicas, wall_seconds=wall,
        latencies=list(dp.latencies), placements=dict(dp.placements),
        metrics=obs.counter_deltas(counters0))
