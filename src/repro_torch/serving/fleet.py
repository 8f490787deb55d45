"""Fleet-level serving simulation: DVBP placement vs. baselines (the port's
``repro.serving.fleet``).

Drives a replica fleet on a simulated clock under a request trace (real
``ReplicaEngine``s: ``launch.serve.serve_real``).  The objective is replica-occupancy
seconds - the paper's accumulated bin usage time - which is what an
autoscaler pays for.  ``round_robin`` and ``pack_all`` baselines bracket the
DVBP policies.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional

import numpy as np

from .scheduler import DVBPScheduler, ReplicaCapacity, Request


def synth_requests(n: int, *, seed: int = 0, rate: float = 8.0,
                   tps: float = 50.0) -> List[Request]:
    """Poisson arrivals, log-normal decode lengths (the VM-lifetime analogue
    for serving: paper Fig. 1 shows log-normal lifetimes)."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.0 / rate, n))
    prompts = rng.integers(32, 512, n)
    decodes = np.clip(rng.lognormal(5.0, 1.2, n), 8, 8192).astype(int)
    return [Request(i, float(t[i]), int(prompts[i]), int(decodes[i]))
            for i in range(n)]


def attach_predictions(reqs: List[Request], sigma: float, seed: int = 0
                       ) -> List[Request]:
    rng = np.random.default_rng(seed)
    out = []
    for r in reqs:
        delta = float(np.exp(rng.normal(0.0, sigma))) if sigma > 0 else 1.0
        out.append(dataclasses.replace(
            r, predicted_decode_len=max(1, int(r.decode_len * delta))))
    return out


def simulate_fleet(reqs: List[Request], policy: str = "greedy",
                   caps: ReplicaCapacity = ReplicaCapacity(),
                   tps: float = 50.0, policy_kwargs: Optional[Dict] = None
                   ) -> Dict:
    """Event-driven fleet simulation; service time = decode_len / tps.

    Legacy entry point: the host-side implementation.  Batched capacity
    planning (same decisions, replay lanes, sweep store) lives in
    ``repro_torch.api``: ``Experiment(serving_requests(reqs, caps, tps),
    policies, settings).run()``.  The host baselines (round_robin /
    pack_all) only exist here."""
    if policy in ("round_robin", "pack_all"):
        # the host baselines have no api replacement: no migration warning
        return _baseline(reqs, policy, caps, tps)
    from ..api._migration import warn_legacy
    warn_legacy("serving.fleet.simulate_fleet",
                "repro_torch.api.Experiment(api.serving_requests(...))")
    sched = DVBPScheduler(policy, caps, policy_kwargs, tokens_per_second=tps)
    heap = []   # (finish time, rid)
    for r in sorted(reqs, key=lambda x: x.arrival):
        while heap and heap[0][0] <= r.arrival:
            ft, rid = heapq.heappop(heap)
            sched.finish(rid, ft)
        sched.place(r, r.arrival)
        heapq.heappush(heap, (r.arrival + r.decode_len / tps, r.rid))
    while heap:
        ft, rid = heapq.heappop(heap)
        sched.finish(rid, ft)
    s = sched.stats
    return {"policy": policy, "replica_seconds": s.replica_seconds,
            "replicas_opened": s.replicas_opened,
            "peak_replicas": s.peak_replicas}


def _baseline(reqs, policy: str, caps: ReplicaCapacity, tps: float) -> Dict:
    """round_robin: spray over replicas opened on demand, close when idle.
    pack_all: single unbounded replica (lower-bound-ish reference)."""
    active: Dict[int, List] = {}        # replica -> [(finish, rid, size)...]
    opened_at: Dict[int, float] = {}
    usage = 0.0
    opened = 0
    peak = 0
    rr = 0
    heap = []
    load = {}

    def fits(rep, r):
        s = r.size(caps)
        return np.all(load[rep] + s <= 1.0 + 1e-9)

    for r in sorted(reqs, key=lambda x: x.arrival):
        while heap and heap[0][0] <= r.arrival:
            ft, rid, rep, s = heapq.heappop(heap)
            load[rep] -= s
            active[rep].remove(rid)
            if not active[rep]:
                usage += ft - opened_at.pop(rep)
                del active[rep]
                del load[rep]
        reps = sorted(active)
        placed = None
        if policy == "pack_all":
            # single unbounded replica: capacity intentionally not enforced,
            # so replica-seconds degenerate to the activity span (the
            # lower-bound-ish reference the DVBP policies are judged against)
            placed = reps[0] if reps else None
        elif reps:
            for k in range(len(reps)):
                cand = reps[(rr + k) % len(reps)]
                if fits(cand, r):
                    placed = cand
                    rr = (rr + k + 1) % len(reps)
                    break
        if placed is None:
            placed = opened
            opened += 1
            active[placed] = []
            load[placed] = np.zeros(3)
            opened_at[placed] = r.arrival
        s = r.size(caps)
        load[placed] += s
        active[placed].append(r.rid)
        peak = max(peak, len(active))
        heapq.heappush(heap, (r.arrival + r.decode_len / tps, r.rid,
                              placed, s))
    while heap:
        ft, rid, rep, s = heapq.heappop(heap)
        load[rep] -= s
        active[rep].remove(rid)
        if not active[rep]:
            usage += ft - opened_at.pop(rep)
            del active[rep]
            del load[rep]
    return {"policy": policy, "replica_seconds": usage,
            "replicas_opened": opened, "peak_replicas": peak}
