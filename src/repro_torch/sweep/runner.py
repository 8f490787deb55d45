"""Batched DVBP replay: one lane-batched replay per (grid, policy);
counterpart of ``repro.sweep.runner``.

``run_batch`` flattens the (B, S) grid of instances x prediction-seed rows
to L = B*S lanes (lane = b*S + s, b-major: the store's records depend on
this order) and replays them in one ``torchsim._replay_batch`` call, for
any ``SCAN_POLICIES`` policy.  ``block_events=T > 1`` replays through the
event-blocked megakernel, T events per launch; it never changes a result.

Each replay dispatch crosses the fault seam ``sweep.scan`` and runs
behind the resilience ladder (``resilience.guard``): an OOM is retried on
the same plan; an injected fault degrades the plan blocked -> per event
-> one device (from a lane split) -> the CPU, with the same results.
Only injected faults degrade: a real OOM whose retries are spent, a CUDA
launch or runtime error, a build failure or a bug raises.  ``checkpoint``
replays in checkpointed segments instead
(``resilience.checkpointed_replay``), so a killed run resumes bit for bit.

Lane split: with more than one local device (``lane_devices``: the CUDA
devices of the host, one CPU device on a ``cpu`` run), the L lanes are
padded to a multiple of the device count by repeating whole copies of the
lane axis (wrapping around when there are fewer lanes than padding) and
each device replays its contiguous shard through the single-device path;
the shards are all launched before any is read back, the outputs are
gathered in lane order and the padding dropped.  Lanes never interact, so
the split changes no result.  ``shard="never"`` keeps one device,
``"always"`` refuses a host of one.  Trace-level, checkpointed and
consolidating replays stay on one device, as in the reference.

Overflow handling mirrors ``torchsim.simulate(auto_grow=True)`` lane-wise:
any instance whose slot pool overflowed (in any seed row) is re-run with
``max_bins`` doubled, rung after rung, up to ``max_bins_cap``; each rung
re-pads and re-splits the surviving lanes.

``consolidate`` (an enabled ``ConsolidationSpec``) replays through the
chunked consolidating driver (``consolidate.consolidated_replay``) on the
same ladder, and the result gains per-cell ``migrations`` /
``migration_cost``.

``trace_level`` >= 1 replays per event and returns the per-event decision
series as ``result.trace`` (an ``obs.ReplayTrace``).  The reference's
spans (``sweep.run_batch``, ``sweep.flatten``, ``sweep.scan``) and
counters (``sweep.device_transfer_bytes``, ``sweep.scan_calls``,
``sweep.overflow_rungs``) are emitted under the same names; its jit
counters have nothing to count here (no compiled traces).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..consolidate import ConsolidationSpec, consolidated_replay
from ..core.torchsim import (MAX_BINS_CAP, _replay_batch, grow_max_bins,
                             known_policy)
from ..kernels.ops import resolve_device
from ..obs.trace import ReplayTrace, from_scan
from ..resilience import faults, guard
from ..resilience.checkpoint import ReplayCheckpointer, checkpointed_replay
from .batching import InstanceBatch, instances_pdeps


def _flatten_lanes(sizes, times, kinds, items, pdeps, dmask, arrivals,
                   rdeps, n_items):
    """Flatten the (B, S) grid to L = B*S lanes, lane = b*S + s: per-lane
    arrays repeat b-major to match ``pdeps.reshape``'s row order."""
    B, S, n_max = pdeps.shape
    rep = (lambda a: np.repeat(a, S, axis=0)) if S > 1 else (lambda a: a)
    return (rep(sizes), rep(times), rep(kinds), rep(items),
            pdeps.reshape(B * S, n_max), rep(dmask), rep(arrivals),
            rep(rdeps), rep(n_items))


def lane_devices(device) -> List[torch.device]:
    """The local devices a replay on ``device`` may split its lanes across:
    every CUDA device of the host for a card, the one CPU device for a
    ``cpu`` run."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _on(dev: torch.device):
    """``dev`` as the current CUDA device (the kernels launch on its
    current stream); nothing for the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def _sharded_replay(sub, devices, **kw):
    """``_replay_batch`` of the L flat lanes of ``sub`` split across
    ``devices``: L padded to a multiple of their count with whole copies of
    the lane axis (wrapping around when the padding exceeds L), one
    contiguous shard a device, every shard launched before any is read
    back; returns (usage, opened, overflow) of the L lanes on the host."""
    ndev = len(devices)
    L = sub[1].shape[0]
    total = L + (-L) % ndev
    if total > L:
        reps = -(-total // L)
        sub = tuple(np.concatenate([a] * reps, axis=0)[:total] for a in sub)
    per = total // ndev
    outs = []
    for i, dev in enumerate(devices):
        with _on(dev):
            outs.append(_replay_batch(
                *(a[i * per:(i + 1) * per] for a in sub), device=dev, **kw))
    return tuple(np.concatenate([o[k].cpu().numpy() for o in outs])[:L]
                 for k in (0, 1, 3))


def _dispatch(sub, *, policy: str, max_bins: int, device, devices,
              block_events: int, trace_level: int):
    """One replay dispatch behind the resilience ladder
    (``guard.replay_rungs``): an OOM retries on the same plan, an injected
    fault moves down blocked -> per event -> one device -> the CPU, each
    rung with the same decisions.  ``devices`` are the lane split's (one
    for a single-device replay).  The results are read to the host inside
    the ladder, so a failure at execution surfaces there."""
    ndev = 1 if trace_level else len(devices)
    rungs = guard.replay_rungs(device, 0 if trace_level else block_events,
                               ndev)

    def attempt(rung):
        faults.fire("sweep.scan")
        kw = dict(policy=policy, max_bins=max_bins,
                  block_events=rung.block_events)
        if rung.ndev > 1:
            u, o, ov = _sharded_replay(sub, devices[:rung.ndev], **kw)
            return u, o, None, ov
        out = _replay_batch(*sub, device=rung.device,
                            trace_level=trace_level, **kw)
        # placements stay on the device: the sweep reads usage, bins and
        # overflow only
        host = tuple(None if k == 2 else v.cpu().numpy()
                     for k, v in enumerate(out[:4]))
        if trace_level:
            host += ({k: v.cpu().numpy() for k, v in out[4].items()},)
        return host

    rung, out = guard.run_ladder(attempt, rungs, site="sweep.scan")
    if rung is not rungs[0]:
        obs.annotate(degraded_to=rung.label)
    return out


def _run_checkpointed(sub, *, policy: str, max_bins: int, device,
                      block_events: int, ckpt: ReplayCheckpointer,
                      key: str):
    """One replay dispatch through the segmented checkpointed replay
    (untraced; ``resilience.checkpoint``)."""
    faults.fire("sweep.scan")
    out = checkpointed_replay(sub, policy=policy, max_bins=max_bins,
                              device=device, block_events=block_events,
                              ckpt=ckpt, key=key)
    return tuple(None if k == 2 else v.cpu().numpy()
                 for k, v in enumerate(out))


@dataclasses.dataclass
class BatchRunResult:
    usage_time: np.ndarray     # (B, S) float
    n_bins_opened: np.ndarray  # (B, S) int
    overflowed: np.ndarray     # (B, S) bool (True only if the cap was hit)
    max_bins: np.ndarray       # (B,) slot-pool size that produced each lane
    trace: Optional[ReplayTrace] = None          # trace_level >= 1 only
    migrations: Optional[np.ndarray] = None      # (B, S), consolidate only
    migration_cost: Optional[np.ndarray] = None  # (B, S), consolidate only

    @property
    def S(self) -> int:
        return self.usage_time.shape[1]


def run_batch(batch: InstanceBatch, policy: str,
              pdeps: Optional[np.ndarray] = None, max_bins: int = 64,
              max_bins_cap: int = MAX_BINS_CAP, auto_grow: bool = True,
              device="cuda", block_events: int = 0,
              consolidate: Optional[ConsolidationSpec] = None,
              trace_level: int = 0,
              checkpoint: Optional[ReplayCheckpointer] = None,
              checkpoint_key: str = "", shard: str = "auto"
              ) -> BatchRunResult:
    """Replay every lane of ``batch`` under ``policy`` (any
    ``SCAN_POLICIES`` name).

    ``pdeps``: (B, S, n_max) predicted departure times (see
    ``batching.pad_predictions``); defaults to the real departures.
    ``device``: where the replay runs ("cuda" unless the caller asks for
    "cpu").  ``shard``: "auto" splits the lanes across ``lane_devices``
    when there is more than one, "never" keeps one device, "always"
    raises unless there are several.  ``block_events`` > 1 replays whole
    blocks of that many events per megakernel launch; the rungs of the
    overflow ladder rerun the overflowing lanes from a fresh carry either
    way.  Both are execution arguments: they change no result.
    ``consolidate`` (an enabled ``ConsolidationSpec``; None for the plain
    replay) interleaves the consolidation planner and its MIGRATE chunks
    with the replay.

    ``trace_level`` >= 1 also returns the per-event decision series as
    ``result.trace`` (level >= 2 adds the per-slot alive mask).  Tracing
    never changes decisions, but it changes the execution plan: the replay
    runs per event (``block_events`` is not used).  The consolidating path
    is untraced.  ``trace_level=0`` runs the untraced replay unchanged.

    ``checkpoint`` (a ``resilience.ReplayCheckpointer``) replays in
    checkpointed segments so that a killed run resumes bit for bit
    (untraced; ``checkpoint_key`` names the snapshot file).  Without it,
    each dispatch runs behind the resilience ladder: under an injected
    fault on ``device="cuda"`` a degraded dispatch may finish on the CPU,
    with the same results; a real failure raises."""
    if not known_policy(policy):
        raise KeyError(f"{policy!r} is not a scan policy")
    if shard not in ("auto", "never", "always"):
        raise ValueError(f"shard={shard!r}: auto, never or always")
    dev = resolve_device(device)
    devices = [] if shard == "never" else lane_devices(dev)
    if shard == "always" and len(devices) < 2:
        raise ValueError("shard='always' requires multiple local devices")
    if len(devices) < 2:
        devices = [dev]
    if pdeps is None:
        pdeps = instances_pdeps(batch)
    B, S, _ = pdeps.shape
    if B != batch.B:
        raise ValueError(f"pdeps has {B} lanes, the batch {batch.B}")

    usage = np.zeros((B, S))
    opened = np.zeros((B, S), np.int64)
    over = np.ones((B, S), bool)
    mb_used = np.full(B, max_bins, np.int64)
    migrations = migration_cost = None
    if consolidate is not None:
        if not consolidate.enabled:
            raise ValueError("pass consolidate=None for non-consolidating "
                             "runs")
        migrations = np.zeros((B, S), np.int64)
        migration_cost = np.zeros((B, S))
    arrays = (batch.sizes, batch.times, batch.kinds, batch.items, pdeps,
              batch.dmask, batch.arrivals, batch.pdeps, batch.n_items)
    lanes = np.arange(B)
    mb = max_bins
    trace_np = None
    with obs.span("sweep.run_batch", policy=policy, device=dev.type, B=B,
                  S=S) as rb_span:
        rungs = 0
        while True:
            with obs.span("sweep.flatten"):
                sub = _flatten_lanes(*(a[lanes] for a in arrays))
            obs.counter_add("sweep.device_transfer_bytes",
                            sum(int(x.nbytes) for x in sub))
            n = lanes.size
            tr = None
            with obs.span("sweep.scan", policy=policy, max_bins=mb,
                          lanes=int(n) * S), obs.torch_profile():
                if consolidate is not None:
                    faults.fire("sweep.scan")
                    u, o, _placements, ov, stats = consolidated_replay(
                        *sub, policy=policy, max_bins=mb,
                        device=dev,
                        block_events=block_events, spec=consolidate)
                    u, o, ov = (v.cpu().numpy() for v in (u, o, ov))
                    migrations[lanes] = stats["migrations"].reshape(n, S)
                    migration_cost[lanes] = \
                        stats["migration_cost"].reshape(n, S)
                elif checkpoint is not None and not trace_level:
                    u, o, _placements, ov = _run_checkpointed(
                        sub, policy=policy, max_bins=mb, device=dev,
                        block_events=block_events, ckpt=checkpoint,
                        key=f"{checkpoint_key or policy}-mb{mb}")
                else:
                    out = _dispatch(sub, policy=policy, max_bins=mb,
                                    device=dev, devices=devices,
                                    block_events=block_events,
                                    trace_level=trace_level)
                    u, o, _placements, ov = out[:4]
                    if trace_level:
                        tr = out[4]
                usage[lanes] = u.reshape(n, S)
                opened[lanes] = o.reshape(n, S)
                ov = ov.reshape(n, S)
            obs.counter_add("sweep.scan_calls")
            over[lanes] = ov
            mb_used[lanes] = mb
            if tr is not None:
                if trace_np is None:
                    trace_np = {k: np.zeros((B * S,) + v.shape[1:], v.dtype)
                                for k, v in tr.items()}
                rows = (lanes[:, None] * S + np.arange(S)).ravel()
                for k, v in tr.items():
                    if k == "alive" and v.shape[2] != trace_np[k].shape[2]:
                        # a grown pool: widen the earlier rungs' masks
                        wide = np.zeros(trace_np[k].shape[:2] + v.shape[2:],
                                        bool)
                        wide[:, :, :trace_np[k].shape[2]] = trace_np[k]
                        trace_np[k] = wide
                    trace_np[k][rows] = v
            lanes = lanes[ov.any(axis=1)]
            if lanes.size == 0 or not auto_grow or mb >= max_bins_cap:
                break
            mb = grow_max_bins(mb, max_bins_cap)
            rungs += 1
            obs.counter_add("sweep.overflow_rungs")
        if rungs:
            rb_span.set(overflow_rungs=rungs)
    trace = None if trace_np is None else from_scan(
        trace_np, batch.times, batch.kinds, batch.items, policy=policy, S=S)
    return BatchRunResult(usage, opened, over, mb_used, trace=trace,
                          migrations=migrations,
                          migration_cost=migration_cost)


def run_grid(batch: InstanceBatch, policies: Sequence[str],
             pdeps: Optional[np.ndarray] = None, max_bins: int = 64,
             max_bins_cap: int = MAX_BINS_CAP, device="cuda",
             block_events: int = 0,
             shard: str = "auto") -> Dict[str, BatchRunResult]:
    """One batched run per policy over the same instance batch."""
    return {p: run_batch(batch, p, pdeps, max_bins, max_bins_cap,
                         device=device, block_events=block_events,
                         shard=shard)
            for p in policies}
