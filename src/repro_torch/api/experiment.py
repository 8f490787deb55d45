"""``Experiment`` / ``Results``: the single way to run anything (the port's
``repro.api.experiment``).

One workload x one policy x one information setting -> one comparable
usage-time ratio (the paper's Eq. (1) performance ratio).  ``Experiment``
is a facade over the batched sweep engine (``sweep.runner.run_batch`` via
``sweep.grid.run_sweep``): it expands (workloads x policies x settings x
seeds), replays every cell as batched lanes on the card (or, when the
caller asks, the CPU), caches per-(instance, policy, prediction, seed)
records in the ``SweepStore`` (the reference's ``result_key`` strings and
store files, so a store written by either package resolves for the
other), and returns tidy records plus box-stat summaries.

    from repro_torch import api
    exp = api.Experiment(api.synthetic("azure", 6, 500),
                         policies=("first_fit", "greedy", "cbd_beta2"),
                         settings=(api.Setting.clairvoyant(),
                                   api.Setting.predicted("lognormal", 1.0)),
                         seeds=(0, 1))
    res = exp.run(store="experiments/sweeps")
    for row in res.summary_rows():
        print(row)
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .. import obs
from ..core.metrics import BoxStats
from ..core.torchsim import CapacityError
from ..obs.trace import ReplayTrace
from ..sweep.grid import SweepSpec, run_sweep, summarize_sweep
from ..sweep.store import SweepStore
from .policy import Policy
from .workload import Setting, Workload

DEFAULT_STORE = "experiments/sweeps"


@dataclasses.dataclass
class Results:
    """Per-(workload, policy, setting, instance, seed) records.

    ``records`` keeps the legacy ``result_key`` -> record mapping (the
    sweep-store schema); ``rows()`` returns the tidy per-record view with
    explicit ``workload`` / ``setting`` columns; ``summary()`` aggregates
    Eq. (1) ratios into box stats per (workload, policy, setting).

    ``metrics`` is the obs-counter delta of the producing ``run()`` (cache
    hits/misses, device-transfer bytes, ...); ``traces`` maps
    ``result_key`` ->
    single-lane ``obs.ReplayTrace`` when the run asked for
    ``trace_level >= 1``."""

    records: Dict[str, Dict]
    _workload_by_suite: Dict[str, str]
    _setting_by_pred: Dict[Tuple[str, str, str], str]
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    traces: Dict[str, ReplayTrace] = dataclasses.field(default_factory=dict)

    def rows(self) -> List[Dict]:
        out = []
        for key in sorted(self.records):
            r = dict(self.records[key])
            r["workload"] = self._workload_by_suite.get(r["suite"],
                                                        r["suite"])
            r["setting"] = self._setting_by_pred.get(
                (r["suite"], r["pred"], r.get("consolidate", "none")),
                r["pred"])
            out.append(r)
        return out

    def summary(self) -> Dict[Tuple[str, str, str], BoxStats]:
        """(workload, policy, setting) -> BoxStats over ratios."""
        groups: Dict[Tuple[str, str, str], List[float]] = {}
        for r in self.rows():
            groups.setdefault((r["workload"], r["policy"], r["setting"]),
                              []).append(r["ratio"])
        return {k: BoxStats.from_ratios(v) for k, v in
                sorted(groups.items())}

    def summary_rows(self) -> List[str]:
        return [f"{w:<24} {p:<18} {s:<22} n={st.n:<4} mean={st.mean:.4f} "
                f"median={st.median:.4f} q1={st.q1:.4f} q3={st.q3:.4f}"
                for (w, p, s), st in self.summary().items()]

    def ratios(self, policy: Optional[str] = None,
               workload: Optional[str] = None,
               setting: Optional[str] = None,
               instance: Optional[str] = None) -> List[float]:
        return [r["ratio"] for r in self.rows()
                if (policy is None or r["policy"] == policy)
                and (workload is None or r["workload"] == workload)
                and (setting is None or r["setting"] == setting)
                and (instance is None or r["instance"] == instance)]

    def usage_total(self, **filters) -> float:
        keep = {k: v for k, v in filters.items() if v is not None}
        return sum(r["usage_time"] for r in self.rows()
                   if all(r[k] == v for k, v in keep.items()))

    def merge(self, other: "Results") -> "Results":
        self.records.update(other.records)
        self._workload_by_suite.update(other._workload_by_suite)
        self._setting_by_pred.update(other._setting_by_pred)
        for k, v in other.metrics.items():
            self.metrics[k] = self.metrics.get(k, 0) + v
        self.traces.update(other.traces)
        return self


@dataclasses.dataclass(frozen=True)
class Experiment:
    """The declarative experiment: workloads x policies x settings."""

    workloads: Union[Workload, Sequence[Workload]]
    policies: Sequence[Union[Policy, str]] = ("first_fit",)
    settings: Sequence[Union[Setting, str]] = (Setting.clairvoyant(),)
    seeds: Sequence[int] = (0,)
    max_bins: int = 64
    max_bins_cap: int = 8192

    def __post_init__(self):
        wl = self.workloads
        if isinstance(wl, Workload):
            wl = (wl,)
        object.__setattr__(self, "workloads", tuple(wl))
        object.__setattr__(self, "policies",
                           tuple(Policy.parse(p) for p in self.policies))
        object.__setattr__(self, "settings",
                           tuple(Setting.parse(s) for s in self.settings))
        object.__setattr__(self, "seeds", tuple(int(s) for s in self.seeds))
        for p in self.policies:
            if not p.scan:
                raise ValueError(
                    f"{p.name!r} has no batched scan lane (host-only); run "
                    "it through core.run / the oracle engine instead")
        # Suite workloads have no way to hide durations from policies that
        # read the predicted-departure clock (the engine's "none" model
        # feeds them the real departures, i.e. clairvoyant numbers), so a
        # nonclairvoyant cell with such a policy is an error, not a
        # silently mislabeled result.  Serving workloads are exempt: they
        # replay nonclairvoyant with pdep == arrival (the scheduler's
        # actual no-prediction behavior).
        for wl in self.workloads:
            for s in self.settings:
                if getattr(wl.pred_model(s), "kind", "") == "none":
                    bad = [p.name for p in self.policies
                           if p.needs_predictions]
                    if bad:
                        raise ValueError(
                            f"Setting.nonclairvoyant() hides durations, "
                            f"but {bad} read the predicted-departure "
                            f"clock on {wl.label()!r}; use "
                            "Setting.clairvoyant() or Setting.predicted()")

    def spec_for(self, *workloads: Workload) -> SweepSpec:
        """The engine-level SweepSpec the given workloads expand to
        (suites and prediction models are the workloads' own duck types,
        so legacy suites hashes / result keys are preserved for
        SuiteSpec-backed workloads).  All workloads must map the
        experiment's settings to the same prediction models."""
        preds = {tuple(wl.pred_model(s) for s in self.settings)
                 for wl in workloads}
        if len(preds) != 1:
            raise ValueError("workloads disagree on prediction models")
        # dedup prediction models AND consolidation scenarios, preserving
        # order; settings mixing both axes expand to the cross product in
        # run_sweep and run()'s keep-filter trims back to the requested
        # (pred, consolidation) pairs
        pred_list = list(OrderedDict.fromkeys(preds.pop()))
        cons = tuple(OrderedDict.fromkeys(
            s.consolidation for s in self.settings))
        return SweepSpec(
            suites=tuple(wl.suite() for wl in workloads),
            policies=tuple(p.name for p in self.policies),
            predictions=tuple(pred_list),
            seeds=self.seeds, max_bins=self.max_bins,
            max_bins_cap=self.max_bins_cap,
            consolidations=cons)

    def _spec_groups(self):
        """Workloads sharing prediction models run as ONE multi-suite
        SweepSpec - the same spec (and therefore the same store file /
        suites hash) a legacy multi-suite ``run_sweep`` produced, so
        stores written by either entry point resolve for the other.
        Workloads with their own prediction mapping (e.g. serving streams
        with attached predictions) get their own spec."""
        groups: "OrderedDict[Tuple, List[Workload]]" = OrderedDict()
        for wl in self.workloads:
            key = tuple(wl.pred_model(s) for s in self.settings)
            groups.setdefault(key, []).append(wl)
        return [(self.spec_for(*wls), wls) for wls in groups.values()]

    def run(self, store: Union[None, str, SweepStore] = None,
            force: bool = False, progress=None, device="cuda",
            block_events: int = 0, trace_level: int = 0,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 2048) -> Results:
        """Run (or resolve from the store) every cell of the grid.

        ``store``: a ``SweepStore``, a directory path, or None (no
        persistence).  ``device`` / ``block_events`` pick where the replay
        runs (the card unless the caller passes "cpu") and its event-block
        size exactly as in ``run_batch`` - execution arguments, never part
        of the cached identity.  ``trace_level`` >= 1 replays every cell with per-event
        decision traces captured into ``Results.traces`` (cells recompute
        even when cached - the trace only exists by replaying).

        ``checkpoint_dir`` enables mid-replay checkpoint/resume
        (``resilience.checkpoint``): the scan carry is snapshotted every
        ``checkpoint_every`` events so a killed run resumes bit-identically.

        The returned ``Results.metrics`` holds the obs-counter deltas of
        this call (always on - no ``obs.enable()`` needed)."""
        if isinstance(store, str):
            store = SweepStore(store)
        res = Results({}, {}, {})
        polnames = {p.name for p in self.policies}
        counters0 = obs.counters()
        with obs.span("experiment.run", cells=len(self.workloads) *
                      len(self.policies) * len(self.settings)):
            for spec, wls in self._spec_groups():
                traces: Dict[str, ReplayTrace] = {}
                records = run_sweep(spec, store=store, force=force,
                                    progress=progress, device=device,
                                    block_events=block_events,
                                    trace_level=trace_level, traces=traces,
                                    checkpoint_dir=checkpoint_dir,
                                    checkpoint_every=checkpoint_every)
                # run_sweep returns everything the shared store file holds
                # for these suites; Results only reports THIS experiment's
                # cells - exactly the requested (pred, consolidation)
                # pairs, not the engine's cross product
                want = {(wl.suite().label(), wl.pred_model(s).label(),
                         s.consolidation.canonical())
                        for wl in wls for s in self.settings}
                keep = lambda r: ((r["suite"], r["pred"],
                                   r.get("consolidate", "none")) in want
                                  and r["policy"] in polnames
                                  and r["seed"] in self.seeds)
                records = {k: r for k, r in records.items() if keep(r)}
                wlmap = {wl.suite().label(): wl.label() for wl in wls}
                for r in records.values():
                    if r["overflowed"]:
                        raise CapacityError(
                            f"slot pool exhausted at max_bins="
                            f"{r['max_bins']} (cap {self.max_bins_cap}) "
                            f"for workload "
                            f"{wlmap.get(r['suite'], r['suite'])!r} "
                            f"instance {r['instance']!r}, policy "
                            f"{r['policy']!r}, setting {r['pred']!r}"
                            + (f"+{r['consolidate']}"
                               if "consolidate" in r else "")
                            + "; raise max_bins_cap or shrink the "
                            "workload",
                            policy=r["policy"], max_bins=r["max_bins"],
                            instance=r["instance"])
                res.merge(Results(
                    records,
                    wlmap,
                    {(wl.suite().label(), wl.pred_model(s).label(),
                      s.consolidation.canonical()): s.label()
                     for wl in wls for s in self.settings},
                    traces={k: t for k, t in traces.items()
                            if k in records}))
        res.metrics = obs.counter_deltas(counters0)
        return res


def run_experiment(workloads, policies, settings=(Setting.clairvoyant(),),
                   seeds=(0,), store: Union[None, str, SweepStore] = None,
                   **run_kw) -> Results:
    """One-call convenience wrapper around ``Experiment(...).run(...)``."""
    return Experiment(workloads, policies, settings, seeds).run(
        store=store, **run_kw)


__all__ = ["Experiment", "Results", "run_experiment", "summarize_sweep",
           "DEFAULT_STORE"]
