"""Declarative experiment grids: suites x policies x prediction models x
seeds, expanded to batched runs and aggregated into performance ratios;
counterpart of ``repro.sweep.grid``.

A ``SweepSpec`` is a frozen, canonically hashable description of the grid.
Its ``spec_hash`` / ``suites_hash`` and the records ``run_sweep`` writes
equal the reference's for the same spec, so the two packages share a
result store.  ``run_sweep`` drives ``runner.run_batch`` once per (suite,
policy, consolidation, prediction model), divides usage by the Eq.(1)
lower bound and, given a ``SweepStore``, skips every group already stored.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..consolidate import ConsolidationSpec
from ..core import (BoxStats, lognormal_predictions_batch, lower_bound,
                    uniform_predictions_batch)
from ..core.torchsim import MAX_BINS_CAP, POLICIES, known_policy
from ..core.types import Instance
from ..data import (load_azure_csv, make_azure_like_suite,
                    make_huawei_like_suite)
from .batching import pack_instances, pad_predictions

PRED_KINDS = ("none", "clairvoyant", "lognormal", "uniform")


@dataclasses.dataclass(frozen=True)
class SuiteSpec:
    """One instance family: which generator, how many instances, how big.
    ``family="azure_trace"`` loads the real Azure Packing2020 dump from
    ``trace_root`` (``n_instances`` / ``n_items`` cap it; 0 = no cap)."""

    family: str = "azure"      # "azure" | "huawei" | "azure_trace"
    n_instances: int = 6
    n_items: int = 500
    seed: int = 2026
    trace_root: str = "data/azure"   # only read by family="azure_trace"

    def build(self) -> List[Instance]:
        if self.family == "azure":
            return make_azure_like_suite(self.n_instances, self.n_items,
                                         self.seed)
        if self.family == "huawei":
            return make_huawei_like_suite(self.n_instances, self.n_items,
                                          self.seed)
        if self.family == "azure_trace":
            insts = load_azure_csv(self.trace_root)
            if insts is None:
                raise FileNotFoundError(
                    f"no Azure Packing2020 dump under {self.trace_root!r} "
                    "(expected vmtype.csv + vmrequest.csv)")
            insts = insts[:self.n_instances] if self.n_instances else insts
            if self.n_items:
                insts = [i.subset(np.arange(i.n_items) < self.n_items)
                         for i in insts]
            return insts
        raise ValueError(f"unknown suite family {self.family!r}")

    def label(self) -> str:
        return f"{self.family}-{self.n_instances}x{self.n_items}-s{self.seed}"


@dataclasses.dataclass(frozen=True)
class PredModel:
    """Prediction setting: "none" / "clairvoyant" (real departures),
    "lognormal" (delta ~ LogNormal(0, param)) or "uniform" (delta ~
    U[1, param], fair coin)."""

    kind: str = "clairvoyant"
    param: float = 0.0

    def __post_init__(self):
        if self.kind not in PRED_KINDS:
            raise ValueError(f"prediction kind {self.kind!r} not in "
                             f"{PRED_KINDS}")

    @property
    def noisy(self) -> bool:
        return self.kind in ("lognormal", "uniform")

    def label(self) -> str:
        if self.kind == "lognormal":
            return f"lognormal{self.param:g}"
        if self.kind == "uniform":
            return f"uniform{self.param:g}"
        return self.kind

    def durations(self, inst: Instance,
                  seeds: Sequence[int]) -> Optional[np.ndarray]:
        """(n_seeds, n_items) predicted durations, or None for the exact
        (real departures) settings."""
        if self.kind == "lognormal":
            return lognormal_predictions_batch(inst, self.param, seeds)
        if self.kind == "uniform":
            return uniform_predictions_batch(inst, self.param, seeds)
        return None


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """The full declarative grid."""

    suites: Tuple[SuiteSpec, ...] = (SuiteSpec(),)
    policies: Tuple[str, ...] = POLICIES
    predictions: Tuple[PredModel, ...] = (PredModel("clairvoyant"),)
    seeds: Tuple[int, ...] = (0,)        # used by noisy prediction models
    max_bins: int = 64                   # initial slot pool per lane
    max_bins_cap: int = 8192             # escalation ladder ceiling
    consolidations: Tuple[ConsolidationSpec, ...] = (ConsolidationSpec(),)

    def __post_init__(self):
        for p in self.policies:
            if not known_policy(p):
                raise KeyError(f"{p!r} is not a scan policy")
        if self.max_bins_cap > MAX_BINS_CAP:
            raise ValueError(f"max_bins_cap {self.max_bins_cap} above "
                             f"MAX_BINS_CAP {MAX_BINS_CAP}")

    def canonical(self) -> Dict:
        blob = dataclasses.asdict(self)
        # the consolidation axis enters the hash only when on: a spec with
        # every consolidation disabled hashes as one without the axis
        cons = [c.canonical() for c in self.consolidations if c.enabled]
        if cons:
            blob["consolidations"] = cons
        else:
            blob.pop("consolidations")
        return blob

    def spec_hash(self) -> str:
        blob = json.dumps(self.canonical(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def suites_hash(self) -> str:
        """Hash of the instances only: records are keyed per (instance,
        policy, pred, seed), so specs sharing suites share a store file."""
        blob = json.dumps([dataclasses.asdict(s) for s in self.suites],
                          sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


def result_key(suite: SuiteSpec, instance_name: str, policy: str,
               pred: PredModel, seed: int,
               cons: Optional[ConsolidationSpec] = None) -> str:
    key = (f"{suite.label()}/{instance_name}/{policy}/"
           f"{pred.label()}/seed{seed}")
    if cons is not None and cons.enabled:
        key += f"/{cons.canonical()}"
    return key


def _group_cached(records: Dict[str, Dict], suite: SuiteSpec, policy: str,
                  pred: PredModel, seeds: Sequence[int],
                  cons: ConsolidationSpec = ConsolidationSpec()) -> bool:
    """True when every (instance, seed) record of the group is present.
    Suites of uncounted size (n_instances == 0) always recompute.  A record
    without a ``consolidate`` field counts as ``"none"``."""
    expected = suite.n_instances * len(seeds)
    if expected <= 0:
        return False
    have = sum(1 for r in records.values()
               if r["suite"] == suite.label() and r["policy"] == policy
               and r["pred"] == pred.label() and r["seed"] in seeds
               and r.get("consolidate", "none") == cons.canonical())
    return have >= expected


def _cell_label(policy: str, cons: ConsolidationSpec) -> str:
    return f"{policy}+{cons.canonical()}" if cons.enabled else policy


# Built suites (instances, Eq.(1) bounds, packed batch) are deterministic
# functions of their spec: shared across run_sweep calls, bounded.
_SUITE_CACHE: "OrderedDict[str, Tuple]" = OrderedDict()
_SUITE_CACHE_MAX = 4


def _built_suite(suite: SuiteSpec):
    key = json.dumps(dataclasses.asdict(suite), sort_keys=True)
    if key in _SUITE_CACHE:
        _SUITE_CACHE.move_to_end(key)
        obs.counter_add("sweep.suite_cache_hit")
        return _SUITE_CACHE[key]
    obs.counter_add("sweep.suite_cache_miss")
    with obs.span("suite.build", suite=suite.label()):
        insts = suite.build()
        built = (insts, [lower_bound(i) for i in insts],
                 pack_instances(insts))
    _SUITE_CACHE[key] = built
    while len(_SUITE_CACHE) > _SUITE_CACHE_MAX:
        _SUITE_CACHE.popitem(last=False)
    return built


def run_sweep(spec: SweepSpec, store=None, force: bool = False,
              progress=None, device="cuda", block_events: int = 0,
              trace_level: int = 0, traces: Optional[Dict] = None,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 2048, shard: str = "auto",
              host_index: Optional[int] = None,
              host_count: Optional[int] = None) -> Dict[str, Dict]:
    """Expand and run the grid on ``device``; returns {result_key: record}.
    ``block_events`` > 1 replays through the event-blocked megakernel and
    ``shard`` splits each replay's lanes across the local devices
    (``runner.run_batch``): execution arguments, so records and store files
    are the same for any value.

    ``trace_level`` >= 1 also captures each replay's per-event decision
    series (``obs.ReplayTrace``): pass a dict as ``traces`` and it is
    filled with one single-lane trace per ``result_key``.  Traced groups
    always recompute (the trace exists only by replaying), so the cached
    group skip is bypassed; records still land in the store.

    ``checkpoint_dir`` turns on checkpointed replay: the carry is
    snapshotted every ``checkpoint_every`` events
    (``resilience.checkpoint``), so a killed sweep rerun over the same spec
    continues mid-scan bit for bit; the store's group journal already
    makes whole finished groups resumable.  Each group crosses the fault
    seam ``sweep.group``.

    ``host_index`` / ``host_count`` split the grid across processes: every
    host numbers the same (suite, pred, policy, consolidation) cell
    sequence - globally, before the cache check - and runs only the cells
    with ``cell_no % host_count == host_index``, journaling its groups into
    the shared store as a single process would (``SweepStore`` merges
    under its lock), so N partial runs leave exactly the single-process
    store.  ``python -m repro_torch sweep --hosts N`` starts N such
    processes.

    record: usage_time, lower_bound, ratio, n_bins_opened, overflowed,
    max_bins, suite, instance, policy, pred, seed - the reference's schema;
    consolidating cells (``spec.consolidations`` entries that are
    ``enabled``) add ``consolidate`` (the canonical spec string),
    ``migrations`` and ``migration_cost``.  With a store, cached groups are
    skipped and every finished group is saved (journaled first).  The
    reference's spans and counters are emitted under its names
    (``store.load``, ``suite.build``, ``sweep.pad``, ``store.save``,
    ``experiment.cache_hit`` / ``cache_miss``, ``sweep.suite_cache_*``)."""
    from ..resilience import faults
    from ..resilience.checkpoint import ReplayCheckpointer
    from .runner import run_batch
    ckpt = None if checkpoint_dir is None else \
        ReplayCheckpointer(checkpoint_dir, every_events=checkpoint_every)
    say = progress or (lambda *_: None)
    if host_count is not None:
        host_count = int(host_count)
        host_index = int(host_index or 0)
        assert 0 <= host_index < host_count, (host_index, host_count)
    records: Dict[str, Dict] = {}
    if store is not None and not force:
        with obs.span("store.load", spec=spec.suites_hash()):
            records.update(store.load(spec))
        obs.counter_add("store.load")

    cell_no = -1   # the global cell counter: the same on every host
    for suite in spec.suites:
        insts = lbs = batch = None   # built lazily: cached suites stay free
        for pred in spec.predictions:
            seeds = tuple(spec.seeds) if pred.noisy else (spec.seeds[0],)
            todo = []
            for p in spec.policies:
                for cons in spec.consolidations:
                    cell_no += 1
                    if host_count is not None and \
                            cell_no % host_count != host_index:
                        continue
                    if not trace_level and _group_cached(
                            records, suite, p, pred, seeds, cons):
                        say(f"skip {suite.label()}/{_cell_label(p, cons)}/"
                            f"{pred.label()} (cached)")
                        obs.counter_add("experiment.cache_hit")
                    else:
                        todo.append((p, cons))
            if not todo:
                continue
            if insts is None:
                insts, lbs, batch = _built_suite(suite)
            with obs.span("sweep.pad", suite=suite.label(),
                          pred=pred.label()):
                pdeps = pad_predictions(
                    batch, [pred.durations(i, seeds) for i in insts])
            for policy, cons in todo:
                say(f"run  {suite.label()}/{_cell_label(policy, cons)}/"
                    f"{pred.label()} B={batch.B} S={len(seeds)}")
                obs.counter_add("experiment.cache_miss")
                faults.fire("sweep.group")
                ckpt_key = "-".join((spec.suites_hash(), suite.label(),
                                     _cell_label(policy, cons),
                                     pred.label()))
                res = run_batch(batch, policy, pdeps, spec.max_bins,
                                spec.max_bins_cap, device=device,
                                block_events=block_events,
                                trace_level=trace_level,
                                consolidate=cons if cons.enabled else None,
                                checkpoint=ckpt, checkpoint_key=ckpt_key,
                                shard=shard)
                if traces is not None and res.trace is not None:
                    S = len(seeds)
                    for bi, inst in enumerate(insts):
                        for si, seed in enumerate(seeds):
                            traces[result_key(suite, inst.name, policy,
                                              pred, seed, cons)] = \
                                res.trace.lane(bi * S + si)
                group_recs = {}
                for bi, inst in enumerate(insts):
                    for si, seed in enumerate(seeds):
                        u = res.usage_time[bi, si]
                        rec = {
                            "suite": suite.label(),
                            "instance": inst.name,
                            "policy": policy,
                            "pred": pred.label(),
                            "seed": int(seed),
                            "usage_time": float(u),
                            "lower_bound": float(lbs[bi]),
                            "ratio": float(u / lbs[bi])
                            if lbs[bi] > 0 else float("inf"),
                            "n_bins_opened": int(res.n_bins_opened[bi, si]),
                            "overflowed": bool(res.overflowed[bi, si]),
                            "max_bins": int(res.max_bins[bi]),
                        }
                        if cons.enabled:
                            rec["consolidate"] = cons.canonical()
                            rec["migrations"] = int(res.migrations[bi, si])
                            rec["migration_cost"] = \
                                float(res.migration_cost[bi, si])
                        group_recs[result_key(suite, inst.name, policy,
                                              pred, seed, cons)] = rec
                records.update(group_recs)
                if store is not None:
                    with obs.span("store.save", spec=spec.suites_hash()):
                        store.save(spec, records, group_records=group_recs)
                    obs.counter_add("store.save")
    return records


def summarize_sweep(records: Dict[str, Dict]
                    ) -> Dict[Tuple[str, str], BoxStats]:
    """(policy, pred label) -> BoxStats over per-(instance, seed) ratios.
    Consolidating records summarize under ``policy+consspec``, so the
    consolidated and plain variants of a policy stay separate rows."""
    groups: Dict[Tuple[str, str], List[float]] = {}
    for rec in records.values():
        pol = rec["policy"]
        cons = rec.get("consolidate", "none")
        if cons != "none":
            pol = f"{pol}+{cons}"
        groups.setdefault((pol, rec["pred"]), []).append(rec["ratio"])
    return {k: BoxStats.from_ratios(v) for k, v in sorted(groups.items())}
