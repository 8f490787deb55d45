"""Input validation + quarantine: malformed workload rows never crash a
run; counterpart of ``repro.resilience.validate``.

Real traces carry garbage - NaN durations, departures before arrivals,
demands above machine capacity, duplicated request ids.  ``Instance``
*asserts* these invariants, so one bad row aborts a whole sweep at
construction time.  This module checks the raw row arrays *before*
construction (``validate_rows``), and ``sanitize_rows`` drops the bad rows
into a quarantine report - counted per reason as
``resilience.quarantine_<reason>`` plus the total
``resilience.quarantine_rows`` - and builds the ``Instance`` from the
surviving rows, sorted by arrival.

``python -m repro_torch validate`` runs the same checks over a suite spec
(the generators and the real-trace loader both funnel through
``Instance``, so a clean pass proves the whole pipeline yields well-formed
workloads); exit status 1 means quarantined rows or an unbuildable suite.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from .. import obs
from ..core.types import EPS, Instance

# reason -> human description, in report order
REASONS = (
    ("nan", "non-finite size / arrival / departure"),
    ("nonpos_size", "size component <= 0"),
    ("oversize", "size component > capacity"),
    ("nonpos_duration", "departure <= arrival (empty interval)"),
    ("dup_id", "duplicate item id (first occurrence kept)"),
)


@dataclasses.dataclass
class ValidationReport:
    """Outcome of one ``validate_rows`` pass."""

    n_rows: int
    keep: np.ndarray                      # (n,) bool - rows that survive
    reasons: Dict[str, np.ndarray]        # reason -> (n,) bool

    @property
    def n_bad(self) -> int:
        return int(self.n_rows - self.keep.sum())

    @property
    def ok(self) -> bool:
        return self.n_bad == 0

    def counts(self) -> Dict[str, int]:
        return {r: int(m.sum()) for r, m in self.reasons.items()
                if m.any()}

    def summary(self) -> str:
        if self.ok:
            return f"{self.n_rows} rows ok"
        parts = ", ".join(f"{r}={c}" for r, c in self.counts().items())
        return (f"{self.n_rows} rows, {self.n_bad} quarantined "
                f"({parts})")


def validate_rows(sizes, arrivals, departures, ids=None,
                  capacity: float = 1.0) -> ValidationReport:
    """Check raw workload rows against the ``Instance`` invariants.

    ``sizes`` (n, d), ``arrivals`` / ``departures`` (n,); ``ids`` (n,)
    optional item identifiers (duplicates past the first occurrence are
    flagged).  A row failing several checks counts once per reason but is
    quarantined once."""
    sizes = np.asarray(sizes, np.float64)
    if sizes.ndim == 1:
        sizes = sizes[:, None]
    arrivals = np.asarray(arrivals, np.float64)
    departures = np.asarray(departures, np.float64)
    n = sizes.shape[0]
    nan = ~(np.isfinite(sizes).all(axis=1) & np.isfinite(arrivals) &
            np.isfinite(departures))
    # comparisons involving NaN are False, so gate the value checks on the
    # finite rows - a NaN row is "nan", not also "nonpos_size"
    fin = ~nan
    nonpos_size = fin & (np.where(fin[:, None], sizes, 1.0) <= 0).any(axis=1)
    oversize = fin & (np.where(fin[:, None], sizes, 0.0) >
                      capacity + EPS).any(axis=1)
    nonpos_duration = fin & (departures <= arrivals)
    if ids is not None:
        ids = np.asarray(ids)
        _, first = np.unique(ids, return_index=True)
        dup = np.ones(n, bool)
        dup[first] = False
    else:
        dup = np.zeros(n, bool)
    reasons = {"nan": nan, "nonpos_size": nonpos_size,
               "oversize": oversize, "nonpos_duration": nonpos_duration,
               "dup_id": dup}
    keep = ~(nan | nonpos_size | oversize | nonpos_duration | dup)
    return ValidationReport(n, keep, reasons)


def sanitize_rows(sizes, arrivals, departures, ids=None,
                  capacity: float = 1.0, name: str = "instance",
                  ) -> Tuple[Instance, ValidationReport]:
    """Quarantine bad rows (counted) and build an ``Instance`` from the
    survivors, sorted by arrival.  The counters are the always-on record;
    callers decide whether a non-empty quarantine is fatal."""
    rep = validate_rows(sizes, arrivals, departures, ids, capacity)
    if not rep.ok:
        obs.counter_add("resilience.quarantine_rows", rep.n_bad)
        for reason, count in rep.counts().items():
            obs.counter_add(f"resilience.quarantine_{reason}", count)
        obs.instant("resilience.quarantine", instance=name,
                    **rep.counts())
    sizes = np.asarray(sizes, np.float64)
    if sizes.ndim == 1:
        sizes = sizes[:, None]
    arrivals = np.asarray(arrivals, np.float64)[rep.keep]
    departures = np.asarray(departures, np.float64)[rep.keep]
    sizes = sizes[rep.keep]
    order = np.argsort(arrivals, kind="stable")
    inst = Instance(sizes[order], arrivals[order], departures[order], name)
    return inst, rep


def validate_instance(inst: Instance) -> ValidationReport:
    """Re-check a built ``Instance`` (defense in depth - the constructor
    asserts the same invariants)."""
    return validate_rows(inst.sizes, inst.arrivals, inst.departures)


def main(argv=None, prog: str = "python -m repro_torch validate") -> None:
    """Validate every instance a suite spec builds; exit 1 on bad rows."""
    import argparse
    from ..sweep.grid import SuiteSpec
    from ..sweep.__main__ import SUITE_DEFAULT_SEED

    ap = argparse.ArgumentParser(
        prog=prog,
        description="Check workload suites for malformed rows (NaN or "
                    "negative durations, departure < arrival, oversize "
                    "demands, duplicate ids).")
    ap.add_argument("--suites", nargs="+", default=["azure"],
                    choices=["azure", "huawei", "azure_trace"])
    ap.add_argument("--n-instances", type=int, default=6)
    ap.add_argument("--n-items", type=int, default=500)
    ap.add_argument("--suite-seed", type=int, default=None)
    ap.add_argument("--trace-root", default="data/azure")
    args = ap.parse_args(argv)

    bad = 0
    for fam in args.suites:
        suite = SuiteSpec(fam, args.n_instances, args.n_items,
                          args.suite_seed if args.suite_seed is not None
                          else SUITE_DEFAULT_SEED[fam],
                          trace_root=args.trace_root)
        try:
            insts = suite.build()
        except (FileNotFoundError, AssertionError, ValueError) as e:
            print(f"{suite.label()}: BUILD FAILED: {e}")
            bad += 1
            continue
        for inst in insts:
            rep = validate_instance(inst)
            status = "ok" if rep.ok else "BAD"
            print(f"{suite.label()}/{inst.name}: {rep.summary()} [{status}]")
            bad += rep.n_bad
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
