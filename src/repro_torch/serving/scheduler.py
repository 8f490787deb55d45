"""DVBP request->replica placement: the paper's technique as the serving
control plane (the port's ``repro.serving.scheduler``).

Replicas are *bins* with capacity vector <batch slots, KV tokens,
prefill budget>; requests are *items* whose duration is their decode
length - unknown, known or predicted.  The autoscaler's objective is
replica-occupancy seconds, the paper's accumulated bin usage time; a
replica with no active request is released ("bin closed").

The scheduler drives ``core.bins.BinPool`` and the host algorithm zoo
(``core.algorithms``: every registry policy, from First Fit to modified
PPE and the adaptive switch), as the reference does.  With
``select_backend="device"`` the decision of the score policies
(``first_fit``, ``best_fit``, ``mru``, ``greedy``, ``nrt_standard``,
``nrt_prioritized``) and of CBD and CBDT (First Fit within the request's
duration class / departure window, as a category mask) runs through
``kernels.ops.fitscore_select``: the CUDA select on the card, its plain
version on the CPU.  The class comes from the host class's own float64
function (``duration_class`` / ``departure_window``), so both paths agree
on its boundary.  Both apply the same (score, opening-order) rule, so they
agree decision for decision on fp32-exact sizes.

Each decision is a ``serving.select`` span and a ``serving.select_<tag>``
counter, ``tag`` naming what decided: ``host`` (the numpy zoo), ``cuda``
(the CUDA select) or ``torch`` (its plain version on the CPU,
``ops.resolved_select_impl``); the demand-vector memo counts
``serving.size_memo_hit`` / ``serving.size_memo_miss`` (``repro_torch.
obs``).

The device select runs behind a two-rung ladder (``_select_guarded``):
each decision crosses the fault seam ``serving.select``, and when the
device select fails with an injected fault or an OOM, the host zoo
decides instead (counted ``resilience.degrade_select_<tag>_host``), so
the scheduler never stops placing.  Only an injected fault degrades: an
OOM is retried on the device and then raises, and any other failure (a
CUDA error, a bug) raises at once, as ``resilience.guard`` classifies
it.  The reference's
megakernel route (``select_block``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..resilience import faults, guard
from ..core.algorithms import get_algorithm
from ..core.algorithms.departure import departure_window
from ..core.algorithms.duration import duration_class
from ..core.bins import BinPool
from ..core.types import Arrival
from ..kernels.fitscore import DPAD
from ..kernels.ops import resolved_select_impl

# scheduler policies with an on-device select
_DEVICE_POLICIES = ("first_fit", "best_fit", "mru", "greedy",
                    "nrt_standard", "nrt_prioritized")
# category-structured policies with an on-device masked select
_DEVICE_CATEGORY_POLICIES = ("cbd", "cbdt")

# Demand-vector memo: requests quantize to a small set of (prompt, decode,
# caps) keys, so admission mostly re-derives vectors it already built.  A
# bounded OrderedDict; entries are read-only, so a cached vector can be
# handed out by reference.
_SIZE_CACHE: "OrderedDict[Tuple, np.ndarray]" = OrderedDict()
_SIZE_CACHE_MAX = 65536


def _demand_vector(prompt_len: int, decode_len: int,
                   caps: "ReplicaCapacity") -> np.ndarray:
    key = (prompt_len, decode_len, caps.slots, caps.kv_tokens,
           caps.prefill_budget)
    hit = _SIZE_CACHE.get(key)
    if hit is not None:
        _SIZE_CACHE.move_to_end(key)
        obs.counter_add("serving.size_memo_hit")
        return hit
    obs.counter_add("serving.size_memo_miss")
    kv = (prompt_len + decode_len) / caps.kv_tokens
    size = np.array([1.0 / caps.slots, min(kv, 1.0),
                     prompt_len / caps.prefill_budget])
    size.flags.writeable = False
    _SIZE_CACHE[key] = size
    while len(_SIZE_CACHE) > _SIZE_CACHE_MAX:
        _SIZE_CACHE.popitem(last=False)
    return size


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float
    prompt_len: int
    decode_len: int                    # ground truth (revealed at finish)
    predicted_decode_len: Optional[int] = None

    def size(self, caps: "ReplicaCapacity") -> np.ndarray:
        return _demand_vector(self.prompt_len, self.decode_len, caps)


@dataclasses.dataclass(frozen=True)
class ReplicaCapacity:
    slots: int = 8                 # concurrent sequences per replica
    kv_tokens: int = 65536         # KV-cache token pool
    prefill_budget: float = 262144  # prompt tokens/s headroom


@dataclasses.dataclass
class PlacementStats:
    replica_seconds: float = 0.0
    replicas_opened: int = 0
    peak_replicas: int = 0
    rejected: int = 0


class DVBPScheduler:
    """Online request placement over an elastic replica fleet.

    ``select_backend``: "host" (the numpy algorithm zoo, the default) or
    "device" (``ops.fitscore_select`` on ``device``: the CUDA kernel on a
    card, the plain version on the CPU)."""

    def __init__(self, policy="nrt_prioritized",
                 caps: ReplicaCapacity = ReplicaCapacity(),
                 policy_kwargs: Optional[Dict] = None,
                 tokens_per_second: float = 50.0,
                 select_backend: str = "host", device="cuda"):
        if select_backend not in ("host", "device"):
            raise ValueError(f"select_backend {select_backend!r}: 'host' or "
                             "'device'")
        self.caps = caps
        self.tps = tokens_per_second
        self.pool = BinPool(d=3)
        self.alg = get_algorithm(policy, **(policy_kwargs or {}))
        self.select_backend = select_backend
        self._policy = policy
        self._category_policy = policy in _DEVICE_CATEGORY_POLICIES
        if policy == "best_fit":
            norm = (policy_kwargs or {}).get("norm", "linf")
            self._device_policy = f"best_fit_{norm}"
        elif self._category_policy:
            self._device_policy = "first_fit"   # First Fit within the class
        else:
            self._device_policy = policy
        self.device = None
        if select_backend == "device":
            if policy not in _DEVICE_POLICIES + _DEVICE_CATEGORY_POLICIES:
                raise ValueError(f"{policy!r} has no on-device select")
            from ..kernels.ops import resolve_device
            self.device = resolve_device(device)

        class _Inst:   # minimal instance facade for algorithm.bind
            durations = np.array([1.0])
            n_items = 0
            sizes = np.zeros((0, 3))
            arrivals = np.zeros(0)
            departures = np.zeros(0)
        self.alg.bind(self.pool, _Inst())
        self.stats = PlacementStats()
        self.last_select_backend: Optional[str] = None  # set by place()
        self._open_at: Dict[int, float] = {}
        self._active: Dict[int, tuple] = {}   # rid -> (bin idx, size)
        self.placements: Dict[int, int] = {}

    # ------------------------------------------------------ device fast path
    def _request_category(self, pdep: Optional[float],
                          now: float) -> Optional[int]:
        """The arriving request's CBD duration class or CBDT window (None
        for score policies), from the host class's own float64 function,
        so both paths agree on the boundary."""
        if not self._category_policy:
            return None
        if pdep is None:
            raise ValueError(f"{self.alg.name} needs predicted decode "
                             "lengths")
        if self._policy == "cbd":
            return int(duration_class(pdep - now, self.alg.beta))
        return int(departure_window(pdep, self.alg.rho))

    def _select_device(self, size: np.ndarray, pdep: Optional[float],
                       now: float, cat: Optional[int]) -> int:
        """The placement decision over the whole pool state through
        ``ops.fitscore_select`` (one lane).  The pool's bin indices are
        absolute and never reused, so the free-slot stage is disabled
        (counts = 1) and only the best feasible slot is read; -1 means
        "open a new bin", the host algorithms' contract.  ``cat`` (CBD /
        CBDT) becomes the category mask: only same-class replicas are
        eligible."""
        from ..kernels.ops import fitscore_select
        p, dev, n = self.pool, self.device, self.pool._cap
        f32, i32 = torch.float32, torch.int32
        loads = np.zeros((1, n, DPAD), np.float32)
        loads[0, :, :3] = p.used
        sz = np.zeros((1, DPAD), np.float32)
        sz[0, :3] = size
        dmask = np.zeros((1, DPAD), np.float32)
        dmask[0, :3] = 1.0

        def t(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=dev, dtype=dt)
        t_at = float(pdep) if pdep is not None else float(now)
        slot, found, _ = fitscore_select(
            t(loads, f32), torch.ones((1, n), dtype=i32, device=dev),
            t(p.alive[None], torch.bool), t(p.open_seq[None], i32),
            t(p.access_seq[None], i32),
            t(np.maximum(p.indicated_close, -1e30)[None], f32),
            t(sz, f32), torch.tensor([t_at], dtype=f32, device=dev),
            torch.tensor([float(now)], dtype=f32, device=dev), t(dmask, f32),
            None if cat is None else t((p.tag == cat)[None], torch.bool),
            policy=self._device_policy)
        return int(slot[0]) if bool(found[0]) else -1

    def _select_guarded(self, size: np.ndarray, pdep: Optional[float],
                        now: float, arr: Arrival):
        """The placement decision behind the serving ladder: the device
        select, then the host zoo.  An OOM is retried
        (``guard.guarded_call``); a device select that fails with a
        degradable error (``guard.is_degradable``: an injected fault)
        steps down to the host zoo, counted
        ``resilience.degrade_select_<tag>_host``; anything else propagates.
        Returns ``(idx, tag)``, ``tag`` naming what decided."""
        if self.select_backend == "host":
            return self.alg.select_bin(arr), "host"
        tag = resolved_select_impl(self.device)
        cat = self._request_category(pdep, now)
        def attempt():
            faults.fire("serving.select")
            return self._select_device(size, pdep, now, cat)
        try:
            idx = guard.guarded_call(attempt, site="serving.select")
        except Exception as e:
            if not guard.is_degradable(e):
                raise
            obs.counter_add(f"resilience.degrade_select_{tag}_host")
            obs.instant("resilience.degrade_select", frm=tag, to="host",
                        error=str(e)[:200])
            return self.alg.select_bin(arr), "host"
        if cat is not None:
            self.alg._cat = cat   # the host class's tag bookkeeping
        return idx, tag

    # ------------------------------------------------------------------- api
    def place(self, req: Request, now: float) -> int:
        """Place a request; returns the replica (bin) index."""
        size = req.size(self.caps)
        pdur = None
        if req.predicted_decode_len is not None:
            pdur = req.predicted_decode_len / self.tps
        pdep = None if pdur is None else now + pdur
        arr = Arrival(req.rid, size, now, pdep)
        with obs.span("serving.select", policy=self._policy,
                      rid=req.rid) as sp:
            idx, tag = self._select_guarded(size, pdep, now, arr)
            sp.set(backend=tag)
        self.last_select_backend = tag
        obs.counter_add(f"serving.select_{tag}")
        opened = idx < 0
        if opened:
            idx = self.pool.open_bin(now)
            self._open_at[idx] = now
            self.stats.replicas_opened += 1
        self.pool.place(idx, size, pdep if pdep is not None else now, now)
        self.alg.on_placed(arr, idx, opened)
        self._active[req.rid] = (idx, size)
        self.placements[req.rid] = idx
        self.stats.peak_replicas = max(self.stats.peak_replicas,
                                       len(self.pool._open_list))
        return idx

    def finish(self, rid: int, now: float) -> None:
        idx, size = self._active.pop(rid)
        self.pool.remove(idx, size)
        self.alg.on_departed(rid, idx, now, size)
        if self.pool.n_active[idx] == 0:
            self.stats.replica_seconds += now - self._open_at.pop(idx)
            self.pool.close_bin(idx)
            self.alg.on_closed(idx, now)

    def open_replicas(self) -> List[int]:
        return list(self.pool._open_list)
