"""Deterministic fault injection: scripted failures at the dispatch seams;
counterpart of ``repro.resilience.faults``.

Every failure-prone boundary of the port crosses a named host-side *seam*,
``faults.fire(site)``, before it dispatches real work:

  * ``kernel.select`` - ``kernels.ops.fitscore_select``, once a call.  On
    the card the per-event replay replays CUDA graphs of event windows, and
    a graph replay crosses no host seam: the seam is crossed while the
    first window runs eagerly and while the second is captured, not once an
    event as in the CPU loop.  Arm it by count on the CPU only;
  * ``sweep.scan``   - one batched replay dispatch in ``sweep.runner``;
  * ``sweep.group``  - one (suite, policy, consolidation, pred) group in
    ``sweep.grid``;
  * ``ckpt.segment`` / ``ckpt.save`` - the segmented checkpointed replay;
  * ``store.load`` / ``store.save`` - sweep-store I/O (``path=`` context);
  * ``serving.select`` - one device placement decision of the scheduler,
    and one rung of a block dispatch of the serving front end
    (``serving.dispatch.BlockDispatcher``);
  * ``kernel.dispatch_block`` - ``kernels.ops.fitscore_replay_dispatch``,
    once a block of the live replay;
  * ``kernel.select_block`` - ``kernels.ops.fitscore_select_block``, once
    a decision of the scheduler's megakernel select.

A ``FaultPlan`` scripts which calls fail and how: each spec matches sites
by glob, arms at the ``at``-th crossing of a matching site and fires for
``count`` consecutive crossings.  Plans are deterministic: faults are a
pure function of the call sequence (plus a ``seed`` that only jitters the
``slow`` delay), so a chaos test replays identically.

Fault kinds: ``xla`` (an ``InjectedFault`` with an ``INTERNAL:`` message,
a device failure the ladder degrades around), ``oom`` (``RESOURCE_
EXHAUSTED:``, transient: retried before degrading, as a real OOM is
retried before it raises), ``error`` (a plain
injected crash, degradable), ``slow`` (sleeps ``delay`` seconds),
``truncate`` (cuts the file passed as ``fire(..., path=)`` to half its
size: a torn write) and ``kill`` (``os._exit(137)``, as if SIGKILLed).

Activation: ``install(plan)`` / ``clear()`` in-process, the ``injected``
context manager, or env ``REPRO_TORCH_FAULTS`` for subprocesses: a comma
list of ``site:kind[:at[:count[:delay]]]``, e.g.
``REPRO_TORCH_FAULTS="sweep.group:kill:3"``.  (The variable is the
port's own, so a process that runs both packages arms one.)  With no plan
installed ``fire`` is two global reads.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import hashlib
import os
import time
from typing import Dict, List, Optional

from .. import obs

ENV = "REPRO_TORCH_FAULTS"
FAULT_KINDS = ("xla", "oom", "error", "slow", "truncate", "kill")

_MESSAGES = {
    "xla": "INTERNAL: injected XlaRuntimeError at seam {site!r}",
    "oom": "RESOURCE_EXHAUSTED: injected OOM at seam {site!r}",
    "error": "injected fault at seam {site!r}",
}


class InjectedFault(RuntimeError):
    """A scripted failure raised by the harness; ``kind`` is the fault
    kind that raised it ("xla", "oom" or "error").  ``guard`` degrades
    around it, and retries the ``oom`` kind first."""

    def __init__(self, message: str, kind: str = "error"):
        super().__init__(message)
        self.kind = kind


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted fault: glob over seam names, kind, and when."""

    site: str            # fnmatch glob over seam names ("sweep.*")
    kind: str            # one of FAULT_KINDS
    at: int = 1          # 1-based crossing index at which it arms
    count: int = 1       # consecutive crossings that fire (0 = forever)
    delay: float = 0.05  # "slow" sleep seconds (jittered by the plan seed)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; known: "
                             f"{FAULT_KINDS}")
        if self.at < 1 or self.count < 0:
            raise ValueError(f"fault spec at={self.at} count={self.count}")


class FaultPlan:
    """Deterministic per-site call counting over a list of FaultSpecs."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self.calls: Dict[str, int] = {}     # site -> crossings so far
        self.fired: Dict[str, int] = {}     # "site:kind" -> times fired

    def on_call(self, site: str) -> Optional[FaultSpec]:
        n = self.calls.get(site, 0) + 1
        self.calls[site] = n
        for sp in self.specs:
            if fnmatch.fnmatchcase(site, sp.site) and n >= sp.at and \
                    (sp.count == 0 or n < sp.at + sp.count):
                key = f"{site}:{sp.kind}"
                self.fired[key] = self.fired.get(key, 0) + 1
                return sp
        return None

    def jitter(self, site: str, delay: float) -> float:
        """Deterministic [0.5, 1.5) delay jitter from (seed, site, call)."""
        h = hashlib.blake2b(
            f"{self.seed}:{site}:{self.calls.get(site, 0)}".encode(),
            digest_size=4).digest()
        return delay * (0.5 + int.from_bytes(h, "big") / 0x100000000)


def parse_plan(text: str, seed: int = 0) -> FaultPlan:
    """Parse ``site:kind[:at[:count[:delay]]]``, comma-separated."""
    specs = []
    for tok in text.split(","):
        tok = tok.strip()
        if not tok:
            continue
        parts = tok.split(":")
        if len(parts) < 2:
            raise ValueError(f"fault spec {tok!r} needs at least site:kind")
        site, kind = parts[0], parts[1]
        at = int(parts[2]) if len(parts) > 2 else 1
        count = int(parts[3]) if len(parts) > 3 else 1
        delay = float(parts[4]) if len(parts) > 4 else 0.05
        specs.append(FaultSpec(site, kind, at, count, delay))
    return FaultPlan(specs, seed=seed)


# ------------------------------------------------------- active plan state

_PLAN: Optional[FaultPlan] = None
_ENV_CHECKED = False


def install(plan) -> FaultPlan:
    """Activate a FaultPlan (or a plan string)."""
    global _PLAN
    if isinstance(plan, str):
        plan = parse_plan(plan)
    _PLAN = plan
    return plan


def clear() -> None:
    """Deactivate fault injection (the env plan is not re-read)."""
    global _PLAN, _ENV_CHECKED
    _PLAN = None
    _ENV_CHECKED = True


def active() -> Optional[FaultPlan]:
    return _PLAN


class injected:
    """``with faults.injected("sweep.scan:xla"): ...`` - a scoped plan."""

    def __init__(self, plan):
        self.plan = parse_plan(plan) if isinstance(plan, str) else plan

    def __enter__(self) -> FaultPlan:
        self._prev = _PLAN
        install(self.plan)
        return self.plan

    def __exit__(self, *exc):
        global _PLAN
        _PLAN = self._prev
        return False


def fire(site: str, path: Optional[str] = None) -> None:
    """The seam: a no-op (two global reads) unless an armed spec matches.

    ``path`` is the file the seam is about to touch (store / checkpoint
    I/O); the ``truncate`` kind corrupts it in place."""
    global _PLAN, _ENV_CHECKED
    if _PLAN is None:
        if _ENV_CHECKED:
            return
        _ENV_CHECKED = True
        text = os.environ.get(ENV, "")
        if not text:
            return
        _PLAN = parse_plan(text)
    sp = _PLAN.on_call(site)
    if sp is None:
        return
    obs.counter_add(f"resilience.fault_{sp.kind}")
    obs.instant(f"fault.{site}", kind=sp.kind)
    if sp.kind == "slow":
        time.sleep(_PLAN.jitter(site, sp.delay))
        return
    if sp.kind == "truncate":
        if path and os.path.exists(path):
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(size // 2, 1))
        return
    if sp.kind == "kill":
        os._exit(137)   # die like SIGKILL: no atexit, no cleanup
    raise InjectedFault(_MESSAGES[sp.kind].format(site=site), sp.kind)
