"""Bounded admission in front of ``DVBPScheduler``: deadlines + shedding
(the port's ``repro.serving.admission``).

A production placement loop cannot let a slow or failing select stall
admission unboundedly.  ``AdmissionQueue`` is the hardening layer between
raw traffic and the scheduler:

  * **bounded queue** - at most ``max_pending`` requests wait for
    placement.  When a new arrival would overflow the bound, queued
    requests whose deadline already lapsed are shed first
    (``resilience.shed_deadline``) - they could never be placed usefully
    anyway - and only if the queue is still full of *live* requests is
    the fresh arrival shed (``resilience.shed_queue_full``).  The two
    counters therefore distinguish "queue full of viable work" from
    "queue full of corpses" deterministically,
  * **per-request deadlines** - a request that waited longer than
    ``deadline`` seconds by drain time is shed
    (``resilience.shed_deadline``) rather than placed uselessly late,
  * **batched drain** - ``drain(now)`` places up to ``batch_max`` queued
    requests per call; the caller owns the cadence (every event-loop
    tick, every batch boundary).  ``take(now)`` is the batched front
    end's flavor: it pops the surviving requests without placing them,
    so ``serving.dispatch.BatchedFrontEnd`` can hand the whole batch to
    the block dispatcher as ONE kernel call.  Both drain in **deadline
    order** (earliest expiry first, submission order breaking ties): a
    request about to lapse is placed before one with slack, so mixed
    per-request deadlines (``submit(..., deadline=...)``) shed strictly
    less than insertion-order draining would.  With the uniform default
    deadline, expiry order == submission order and the drain is exactly
    the legacy FIFO.

Placement itself goes through ``DVBPScheduler.place``, which sits behind
the serving degradation ladder (``scheduler._select_guarded``) - so under
an injected kernel fault the queue keeps draining on the lower rungs, just
slower; the queue's job is to bound *how much* work piles up while that
happens.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Tuple

from .. import obs
from .scheduler import DVBPScheduler, Request


@dataclasses.dataclass
class AdmissionStats:
    submitted: int = 0
    placed: int = 0
    shed_queue_full: int = 0
    shed_deadline: int = 0

    @property
    def shed(self) -> int:
        return self.shed_queue_full + self.shed_deadline


class AdmissionQueue:
    """Bounded earliest-deadline-first admission in front of a placement
    engine.  The pending set is a heap keyed (expiry, submission seq), so
    drains pop the most urgent request first and uniform deadlines
    degenerate to exact FIFO.

    ``scheduler`` may be None when the queue only feeds ``take()`` (the
    batched front end owns placement); ``drain()`` then raises."""

    def __init__(self, scheduler: Optional[DVBPScheduler],
                 max_pending: int = 1024, deadline: float = 5.0,
                 batch_max: int = 64):
        if not (max_pending >= 1 and batch_max >= 1 and deadline > 0):
            raise ValueError(f"AdmissionQueue: max_pending={max_pending}, "
                             f"batch_max={batch_max}, deadline={deadline}")
        self.scheduler = scheduler
        self.max_pending = max_pending
        self.deadline = deadline
        self.batch_max = batch_max
        self.stats = AdmissionStats()
        # (expiry, seq, request, t_in); heap order == drain order
        self._pending: List[Tuple[float, int, Request, float]] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._pending)

    def _shed_one(self, now: float) -> None:
        _, _, req, t_in = heapq.heappop(self._pending)
        self.stats.shed_deadline += 1
        obs.counter_add("resilience.shed_deadline")
        obs.instant("resilience.shed", rid=req.rid, why="deadline",
                    waited=now - t_in)

    def _shed_expired(self, now: float) -> int:
        """Drop queued requests whose deadline lapsed (earliest expiry
        first - the heap root is always the most-expired entry).  Returns
        how many were shed."""
        n = 0
        while self._pending and now > self._pending[0][0]:
            self._shed_one(now)
            n += 1
        return n

    def submit(self, req: Request, now: float,
               deadline: Optional[float] = None) -> bool:
        """Enqueue a request; False means shed (queue saturated with
        still-viable requests).  Deadline-expired entries are evicted
        before a fresh arrival is ever rejected.  ``deadline`` overrides
        the queue-wide patience for this request (seconds from now)."""
        self.stats.submitted += 1
        if len(self._pending) >= self.max_pending:
            self._shed_expired(now)
        if len(self._pending) >= self.max_pending:
            self.stats.shed_queue_full += 1
            obs.counter_add("resilience.shed_queue_full")
            obs.instant("resilience.shed", rid=req.rid, why="queue_full")
            return False
        expiry = now + (self.deadline if deadline is None else deadline)
        heapq.heappush(self._pending, (expiry, self._seq, req, now))
        self._seq += 1
        return True

    def take(self, now: float, limit: Optional[int] = None
             ) -> List[Tuple[Request, float]]:
        """Pop up to ``limit`` (default ``batch_max``) queued requests in
        deadline order (earliest expiry first, submission order breaking
        ties), shedding expired entries along the way.  Returns the
        surviving ``(request, submit_time)`` pairs - the batched front
        end's drain primitive (placement happens in the block dispatcher,
        not here)."""
        budget = self.batch_max if limit is None else limit
        out: List[Tuple[Request, float]] = []
        while self._pending and budget:
            if now > self._pending[0][0]:
                self._shed_one(now)
                continue
            _, _, req, t_in = heapq.heappop(self._pending)
            out.append((req, t_in))
            budget -= 1
        return out

    def drain(self, now: float) -> List[Tuple[int, int]]:
        """Place up to ``batch_max`` queued requests; returns
        ``[(rid, replica), ...]`` for the requests actually placed.
        Requests whose deadline lapsed while queued are shed, not placed."""
        if self.scheduler is None:
            raise ValueError("drain() needs a scheduler; batched front ends "
                             "use take()")
        placed: List[Tuple[int, int]] = []
        for req, _ in self.take(now):
            idx = self.scheduler.place(req, now)
            placed.append((req.rid, idx))
            self.stats.placed += 1
        return placed
