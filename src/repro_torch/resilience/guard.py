"""Guarded dispatch: retry with backoff, then the degradation ladder;
counterpart of ``repro.resilience.guard``, with a strict classifier.

Two layers, composed by ``run_ladder``:

  * ``guarded_call`` retries *transient* failures on the same execution
    plan, with deterministic jittered exponential backoff, counted as
    ``resilience.retry``.  Transient is ``torch.cuda.OutOfMemoryError``
    and the injected ``oom`` kind, nothing else.
  * When the failure is an injected one (``faults.InjectedFault``),
    execution moves down the ladder of equivalent plans: ``blocked`` (the
    warp or global megakernel) -> ``perevent`` (the graphed select) ->
    ``cpu`` (the plain-torch replay on the CPU); a replay whose lanes are
    split across several devices (``_sharded``) drops the split before it
    leaves the card.  Every rung replays the same decisions bit for bit,
    so degrading trades time, never results.  Each step is counted as
    ``resilience.degrade_blocked_perevent``,
    ``resilience.degrade_sharded_single`` or
    ``resilience.degrade_cuda_cpu``.

The classifier is stricter than the reference's, on purpose, so that no
fallback hides the device or a kernel, and no real failure moves card
work to the CPU: ``is_degradable`` is true only for an ``InjectedFault``.
The ladder is a rehearsal of the degradation path under a fault plan,
never a route around a real failure.  A real OOM is retried on its plan
and then raises.  A real CUDA launch or runtime error propagates at once -
it is sticky, the context is lost and a lower rung on the card would fail
too - and so do an ``nvcc`` build failure, a shape error and an
assertion.  (The reference also degrades around any error whose text
names a device status.)

Backoff sleeps scale with env ``REPRO_TORCH_RESILIENCE_BACKOFF_SCALE``
(tests set 0 to run the retry logic without the waiting).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Callable, List, Tuple

import torch

from .. import obs
from .faults import InjectedFault


def is_transient(exc: BaseException) -> bool:
    """Worth retrying on the same execution plan: an OOM."""
    if isinstance(exc, InjectedFault):
        return exc.kind == "oom"
    return isinstance(exc, torch.cuda.OutOfMemoryError)


def is_degradable(exc: BaseException) -> bool:
    """A failure a lower ladder rung may route around: an injected fault
    only.  A real OOM whose retries are spent, like any real error,
    propagates."""
    return isinstance(exc, InjectedFault)


def backoff_delay(site: str, attempt: int, base: float = 0.05,
                  factor: float = 2.0, seed: int = 0) -> float:
    """Exponential backoff with deterministic jitter in [0.5, 1.5)."""
    h = hashlib.blake2b(f"{seed}:{site}:{attempt}".encode(),
                        digest_size=4).digest()
    jitter = 0.5 + int.from_bytes(h, "big") / 0x100000000
    scale = float(os.environ.get("REPRO_TORCH_RESILIENCE_BACKOFF_SCALE",
                                 "1"))
    return base * (factor ** (attempt - 1)) * jitter * scale


def guarded_call(fn: Callable, *, site: str, retries: int = 2,
                 base_delay: float = 0.05, seed: int = 0):
    """Call ``fn()``; retry transient failures up to ``retries`` times
    with jittered exponential backoff.  Other failures, and the last
    transient one, propagate to the caller - typically a ladder."""
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:
            if attempt >= retries or not is_transient(e):
                raise
            attempt += 1
            obs.counter_add("resilience.retry")
            obs.instant("resilience.retry", site=site, attempt=attempt,
                        error=str(e)[:200])
            time.sleep(backoff_delay(site, attempt, base_delay, seed=seed))


# ------------------------------------------------------------- the ladder

@dataclasses.dataclass(frozen=True)
class Rung:
    """One execution plan on the replay degradation ladder."""

    label: str
    device: str
    block_events: int
    ndev: int = 1


def rung_label(device: str, block_events: int, ndev: int = 1) -> str:
    if block_events and block_events > 1:
        lab = "blocked"
    else:
        lab = "perevent" if torch.device(device).type == "cuda" else "cpu"
    return lab + ("_sharded" if ndev > 1 else "")


def replay_rungs(device, block_events: int, ndev: int = 1) -> List[Rung]:
    """The ladder for one replay dispatch on ``device`` with its lanes
    split across ``ndev`` devices, degrading one axis a rung: the
    event-blocked megakernel first (keep the device), then the lane split
    (one device), then the device itself (the CPU's plain-torch replay is
    the floor).  Only an injected fault steps down (``is_degradable``), so
    a card's ``cpu`` rung serves under a fault plan and never otherwise."""
    dev = str(torch.device(device))
    T, nd = int(block_events or 0), int(ndev)
    cfgs = [(dev, T, nd)]
    if T > 1:
        T = 0
        cfgs.append((dev, T, nd))
    if nd > 1:
        nd = 1
        cfgs.append((dev, T, nd))
    if torch.device(dev).type != "cpu":
        cfgs.append(("cpu", 0, 1))
    return [Rung(rung_label(*c), *c) for c in cfgs]


def transition_name(a: Rung, b: Rung) -> Tuple[str, str]:
    """(from, to) labels for the one axis a ladder step degrades."""
    if (a.block_events or 0) > 1 and not (b.block_events or 0) > 1:
        return ("blocked", "perevent")
    if a.ndev != b.ndev:
        return ("sharded", "single")
    return (torch.device(a.device).type, torch.device(b.device).type)


def run_ladder(attempt: Callable[[Rung], object], rungs: List[Rung], *,
               site: str, retries: int = 2, base_delay: float = 0.05):
    """Run ``attempt(rung)`` down the ladder: each rung is retried for
    transient failures (``guarded_call``); a degradable failure moves to
    the next rung with a ``resilience.degrade_<from>_<to>`` counter.
    Returns ``(rung, result)`` for the rung that served.  The last rung's
    failure, and any failure that is not degradable, propagates."""
    for i, rung in enumerate(rungs):
        try:
            return rung, guarded_call(lambda: attempt(rung), site=site,
                                      retries=retries,
                                      base_delay=base_delay)
        except Exception as e:
            if i + 1 >= len(rungs) or not is_degradable(e):
                raise
            frm, to = transition_name(rung, rungs[i + 1])
            obs.counter_add(f"resilience.degrade_{frm}_{to}")
            obs.instant("resilience.degrade", site=site, frm=frm, to=to,
                        error=str(e)[:200])
    raise ValueError("run_ladder: an empty ladder")
