"""``Policy``: first-class policy objects replacing stringly-typed names
(the port's ``repro.api.policy``).

Every placement policy the repo knows - the 8 score-based Any Fit
policies, the category-structured families (CBD/CBDT, Hybrid variants,
RCP/PPE, Lifetime Alignment, the adaptive switch, parametric variants
included) and the host-only extras (``next_fit``, ``rr_next_fit``) - is
one frozen ``Policy`` value:

  * ``Policy.parse("cbd_beta4")`` / ``str(policy)`` round-trip the
    canonical scan-policy string, with the parameter range validated at
    parse time (``core.torchsim.policy_spec`` raises ValueError for
    "cbd_beta-1", "cbdt_rho0", "adaptive_8_2", ...).
  * Structured parameters (``beta``, ``rho``, adaptive ``low``/``high``,
    best-fit ``norm``, lifetime-alignment ``mode``) are fields, not
    substrings.
  * Capability flags say where the policy can run: ``scan`` (batched
    replay lanes, per event or blocked), ``category`` (carries category
    state in the scan), ``device_select`` (the serving scheduler's device
    select), ``needs_predictions`` (reads the predicted-departure clock).
  * ``Policy.from_registry(name, **kwargs)`` maps an algorithm-zoo
    registry entry to its scan lane (or None when only the host oracle
    can run it) - the one mapping from the host zoo's names to the scan's.

``policies()`` enumerates the registry for introspection.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..core.torchsim import (CATEGORY_POLICIES, POLICIES, SCAN_POLICIES,
                             policy_spec)

# Host-only registry policies: no batched scan lane, the oracle engine is
# their only executor.
HOST_ONLY_POLICIES = ("next_fit", "rr_next_fit")

# Scan policies whose serving-scheduler decision can run through the
# device select (kernels.ops.fitscore_select): the whole score family plus
# the class-masked First Fit of CBD/CBDT.
_DEVICE_FAMILIES = ("score", "cbd", "cbdt")


@dataclasses.dataclass(frozen=True)
class Policy:
    """One placement policy: canonical name + structured parameters +
    capability flags.  Construct via ``parse``/``from_registry``."""

    name: str                       # canonical string; round-trips parse()
    family: str                     # score|cbd|cbdt|hybrid|rcp|la|adaptive|host
    norm: Optional[str] = None      # best_fit residual norm
    beta: Optional[float] = None    # cbd duration base
    rho: Optional[float] = None     # cbdt window width (seconds)
    low: Optional[float] = None     # adaptive regime thresholds
    high: Optional[float] = None
    mode: Optional[str] = None      # lifetime-alignment class structure
    scan: bool = True               # replays as batched scan lanes
    category: bool = False          # category-structured (carried state)
    device_select: bool = False     # serving device select
    needs_predictions: bool = False  # reads the predicted-departure clock

    def __str__(self) -> str:
        return self.name

    @classmethod
    def parse(cls, name: "Policy | str") -> "Policy":
        """Parse a policy name (parametric variants included).  Raises
        KeyError for unknown names and ValueError - naming the valid
        range - for out-of-range parameters.  Idempotent on ``Policy``."""
        if isinstance(name, Policy):
            return name
        if name in HOST_ONLY_POLICIES:
            return cls(name, "host", scan=False)
        spec = policy_spec(name)   # validates; raises KeyError/ValueError
        kw: Dict = {}
        if spec.family == "score":
            if name.startswith("best_fit_"):
                kw["norm"] = name.split("_")[-1]
            kw["needs_predictions"] = name in ("greedy", "nrt_standard",
                                               "nrt_prioritized")
        elif spec.family == "cbd":
            kw.update(beta=spec.beta, needs_predictions=True)
        elif spec.family == "cbdt":
            kw.update(rho=spec.rho, needs_predictions=True)
        elif spec.family == "la":
            kw.update(mode=spec.la_mode, needs_predictions=True)
        elif spec.family == "adaptive":
            kw.update(low=spec.low, high=spec.high, needs_predictions=True)
        else:   # hybrid / rcp: parameterless names
            kw["needs_predictions"] = True
        return cls(name, spec.family,
                   category=spec.family != "score",
                   device_select=spec.family in _DEVICE_FAMILIES, **kw)

    # ------------------------------------------------- host-registry bridge
    def registry_args(self) -> Tuple[str, Dict]:
        """(algorithm-zoo registry name, kwargs) for the equivalent host
        oracle algorithm - the parity reference."""
        if self.family == "score" and self.norm is not None:
            return "best_fit", {"norm": self.norm}
        if self.family == "cbd":
            return "cbd", {"beta": self.beta}
        if self.family == "cbdt":
            return "cbdt", {"rho": self.rho}
        if self.family == "la":
            return "lifetime_alignment", {"mode": self.mode}
        if self.family == "adaptive":
            return "adaptive", {"low": self.low, "high": self.high}
        return self.name, {}

    def host_algorithm(self):
        """A fresh host oracle algorithm instance for this policy."""
        from ..core.algorithms import get_algorithm
        name, kw = self.registry_args()
        return get_algorithm(name, **kw)

    @classmethod
    def from_registry(cls, name: str, **kwargs) -> Optional["Policy"]:
        """The inverse bridge: scan ``Policy`` for an algorithm-registry
        (name, kwargs) pair, or None when the combination has no batched
        lane (host-only policies and exotic kwargs stay on the oracle)."""
        if name == "best_fit" and set(kwargs) <= {"norm"}:
            return cls.parse(f"best_fit_{kwargs.get('norm', 'linf')}")
        if name == "cbd" and set(kwargs) <= {"beta"}:
            return cls.parse(f"cbd_beta{kwargs.get('beta', 2.0):g}")
        if name == "cbdt" and set(kwargs) <= {"rho"} and "rho" in kwargs:
            return cls.parse(f"cbdt_rho{kwargs['rho']:g}")
        if name == "lifetime_alignment" and set(kwargs) <= {"mode"}:
            return cls.parse(f"la_{kwargs.get('mode', 'binary')}")
        if name == "adaptive" and set(kwargs) <= {"low", "high"}:
            if kwargs:
                return cls.parse(f"adaptive_{kwargs.get('low', 2.0):g}"
                                 f"_{kwargs.get('high', 16.0):g}")
            return cls.parse("adaptive")
        if not kwargs:
            try:
                return cls.parse(name)
            except KeyError:
                return None
        return None


def policies(include_host_only: bool = True) -> Tuple[Policy, ...]:
    """The policy registry: every non-parametric policy the repo ships
    (parametric variants - cbd_beta4, cbdt_rho3600, adaptive_2_8 - parse
    on demand via ``Policy.parse``)."""
    names = SCAN_POLICIES + (HOST_ONLY_POLICIES if include_host_only else ())
    return tuple(Policy.parse(n) for n in names)


def policy_names(include_host_only: bool = False) -> Tuple[str, ...]:
    return tuple(p.name for p in policies(include_host_only))


__all__ = ["Policy", "policies", "policy_names", "HOST_ONLY_POLICIES",
           "POLICIES", "CATEGORY_POLICIES", "SCAN_POLICIES"]
