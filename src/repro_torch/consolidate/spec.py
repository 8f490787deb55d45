"""ConsolidationSpec - the consolidation scenario knobs; counterpart of
``repro.consolidate.spec``, whose ``canonical()`` strings it reproduces
character for character (they enter the sweep store hash).

A frozen value object so it can ride inside ``SweepSpec`` and enter the
sweep store hash.  ``kind`` controls *when* the planner
runs (never / at every planning boundary / when Δt elapsed); the
load-fraction ``threshold`` controls *what* drains; ``budget`` bounds
per-lane churn; ``cost`` is the reported per-migration price (it never
changes decisions); ``every`` is the planning cadence in replay events
(the scan chunk size between planner invocations).
"""
from __future__ import annotations

import dataclasses

KINDS = ("none", "underload", "periodic")


@dataclasses.dataclass(frozen=True)
class ConsolidationSpec:
    kind: str = "none"        # none | underload | periodic
    threshold: float = 0.25   # drain candidates: max-dim load <= threshold
    dt: float = 0.0           # periodic sweep interval (periodic only)
    budget: int = -1          # max migrations per lane; -1 = unlimited
    cost: float = 0.0         # reported per-migration cost (never decides)
    every: int = 256          # planning cadence in events (chunk size)

    def __post_init__(self):
        assert self.kind in KINDS, \
            f"unknown consolidation kind {self.kind!r}; known: {KINDS}"
        assert self.every >= 1, "planning cadence must be >= 1 event"
        if self.kind == "periodic":
            assert self.dt > 0, "periodic consolidation needs dt > 0"
        if self.enabled:
            assert 0.0 < self.threshold <= 1.0, \
                "drain threshold is a load fraction in (0, 1]"
        assert self.cost >= 0.0

    @property
    def enabled(self) -> bool:
        return self.kind != "none"

    def canonical(self) -> str:
        """Stable string form - the piece that enters the sweep store
        hash.  ``"none"`` stays literally ``"none"`` so pre-consolidation
        spec hashes are unchanged when the axis is off."""
        if not self.enabled:
            return "none"
        parts = [self.kind]
        if self.kind == "periodic":
            parts.append(f"dt{self.dt:g}")
        parts.append(f"t{self.threshold:g}")
        parts.append(f"b{self.budget}")
        parts.append(f"e{self.every}")
        if self.cost:
            parts.append(f"c{self.cost:g}")
        return ":".join(parts)

    def __str__(self) -> str:
        return self.canonical()

    @classmethod
    def parse(cls, s: str, **overrides) -> "ConsolidationSpec":
        """Parse a CLI flag value.

        Grammar (fields optional left-to-right, ``key``-prefixed fields
        accepted anywhere after the kind):

          none
          underload[:THRESHOLD[:BUDGET]]
          periodic:DT[:THRESHOLD[:BUDGET]]
          underload:t0.25:b64:e128:c0.5   (tagged form)
        """
        parts = [p for p in s.strip().split(":") if p]
        assert parts, "empty consolidation spec"
        kind = parts[0]
        kw = dict(kind=kind)
        pos = []
        for p in parts[1:]:
            tag, rest = p[0], p[1:]
            if tag == "t" and _floatable(rest):
                kw["threshold"] = float(rest)
            elif tag == "b" and _intable(rest):
                kw["budget"] = int(rest)
            elif tag == "e" and _intable(rest):
                kw["every"] = int(rest)
            elif tag == "c" and _floatable(rest):
                kw["cost"] = float(rest)
            elif p[:2] == "dt" and _floatable(p[2:]):
                kw["dt"] = float(p[2:])
            else:
                pos.append(p)
        order = ("dt", "threshold", "budget") if kind == "periodic" \
            else ("threshold", "budget")
        for name, val in zip(order, pos):
            kw[name] = int(val) if name == "budget" else float(val)
        kw.update(overrides)
        return cls(**kw)


def _floatable(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _intable(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False
