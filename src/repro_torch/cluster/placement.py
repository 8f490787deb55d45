"""Fleet-level job->host placement: the literal paper problem at the
cluster layer.

Jobs (training pods, batch inference, development environments) demand
<chips, HBM, host-RAM, NIC> fractions of a host; hosts are unit bins; the
minimized objective is host-occupancy seconds (energy/lease cost).  Faults
re-enter a job as a new item (its checkpoint restart), which is exactly the
dynamic arrival/departure model of the paper.  The port's
``repro.cluster.placement``: host-side float64 numpy on the same algorithm
zoo (``core.algorithms``).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional

import numpy as np

from ..core.bins import BinPool
from ..core.types import Arrival
from ..core.algorithms import get_algorithm


@dataclasses.dataclass
class Job:
    jid: int
    submit: float
    runtime: float                  # remaining runtime (shrinks on failures)
    demand: np.ndarray              # (4,): chips, hbm, host-ram, nic
    predicted_runtime: Optional[float] = None
    checkpoint_period: float = 600.0
    progress: float = 0.0


@dataclasses.dataclass
class ClusterStats:
    host_seconds: float = 0.0
    hosts_opened: int = 0
    peak_hosts: int = 0
    failures_recovered: int = 0
    lost_work: float = 0.0


class ClusterScheduler:
    """Online gang placement with failure re-entry and checkpoint restart."""

    def __init__(self, policy: str = "first_fit",
                 policy_kwargs: Optional[Dict] = None):
        self.pool = BinPool(d=4)
        self.alg = get_algorithm(policy, **(policy_kwargs or {}))

        class _Inst:
            durations = np.array([1.0])
        self.alg.bind(self.pool, _Inst())
        self.stats = ClusterStats()
        self._open_at: Dict[int, float] = {}
        self._placed: Dict[int, tuple] = {}

    def place(self, job: Job, now: float) -> int:
        pdep = None if job.predicted_runtime is None else \
            now + job.predicted_runtime
        arr = Arrival(job.jid, job.demand, now, pdep)
        idx = self.alg.select_bin(arr)
        opened = idx < 0
        if opened:
            idx = self.pool.open_bin(now)
            self._open_at[idx] = now
            self.stats.hosts_opened += 1
        self.pool.place(idx, job.demand, pdep if pdep else now, now)
        self.alg.on_placed(arr, idx, opened)
        self._placed[job.jid] = (idx, job.demand)
        self.stats.peak_hosts = max(self.stats.peak_hosts,
                                    len(self.pool._open_list))
        return idx

    def release(self, jid: int, now: float) -> None:
        idx, demand = self._placed.pop(jid)
        self.pool.remove(idx, demand)
        self.alg.on_departed(jid, idx, now, demand)
        if self.pool.n_active[idx] == 0:
            self.stats.host_seconds += now - self._open_at.pop(idx)
            self.pool.close_bin(idx)
            self.alg.on_closed(idx, now)

    def host_of(self, jid: int) -> int:
        return self._placed[jid][0]


def simulate_cluster(jobs: List[Job], policy: str = "first_fit", *,
                     mtbf: Optional[float] = None, seed: int = 0) -> Dict:
    """Event-driven cluster replay with host failures.

    A failing host kills its jobs; each loses work back to its last
    checkpoint and re-enters the queue immediately (restart) - item
    departure + new arrival in DVBP terms.
    """
    rng = np.random.default_rng(seed)
    sched = ClusterScheduler(policy)
    heap = []   # (time, kind, ident) kind: 0 finish, 1 failure
    for j in jobs:
        heapq.heappush(heap, (j.submit, 2, j.jid))
    by_id = {j.jid: j for j in jobs}
    running: Dict[int, float] = {}     # jid -> started at
    next_fail = rng.exponential(mtbf) if mtbf else np.inf
    now = 0.0
    while heap:
        now, kind, ident = heapq.heappop(heap)
        while mtbf and next_fail < now and sched.pool._open_list:
            # fail a random open host at time next_fail
            tf = next_fail
            hosts = list(sched.pool._open_list)
            victim = hosts[rng.integers(len(hosts))]
            victims = [jid for jid, (idx, _) in sched._placed.items()
                       if idx == victim and jid in running]
            for jid in victims:
                job = by_id[jid]
                ran = tf - running.pop(jid)
                ckpt = (ran // job.checkpoint_period) * job.checkpoint_period
                sched.stats.lost_work += ran - ckpt
                sched.stats.failures_recovered += 1
                job.runtime -= ckpt
                sched.release(jid, tf)
                heapq.heappush(heap, (tf, 2, jid))    # restart immediately
            next_fail = tf + rng.exponential(mtbf)
        if kind == 2:   # submit / resubmit
            job = by_id[ident]
            sched.place(job, now)
            running[ident] = now
            heapq.heappush(heap, (now + job.runtime, 0, ident))
        elif kind == 0 and ident in running:   # finish (if not failed since)
            started = running.pop(ident)
            if abs((started + by_id[ident].runtime) - now) < 1e-9:
                sched.release(ident, now)
            else:   # stale finish event from a pre-failure schedule
                heapq.heappush(heap, (started + by_id[ident].runtime, 0,
                                      ident))
                running[ident] = started
    s = sched.stats
    return {"policy": policy, "host_seconds": s.host_seconds,
            "hosts_opened": s.hosts_opened, "peak_hosts": s.peak_hosts,
            "failures_recovered": s.failures_recovered,
            "lost_work": s.lost_work}
