"""Spans + counters: the process-wide observability collector; the port's
``repro.obs.collector``, with state of its own (the two packages'
recordings never mix).

Two tiers, tuned so instrumentation can stay in every hot path:

  * **Counters** are always on.  ``counter_add`` is one dict upsert - cheap
    enough to live inside ``pack_instances``, the run_batch escalation
    ladder and the serving select path unconditionally.
  * **Spans** record wall-clock intervals only while recording is enabled
    (``obs.enable()`` / ``obs.recording()`` / env ``REPRO_OBS=1``).  When
    disabled, ``span()`` returns a shared no-op object: the cost of an
    instrumented-but-disabled call site is one flag check and one function
    call.

Spans time the host.  A span around work queued on the card covers the
queueing unless the call site waits for the results (the runner copies
them to the host inside its ``sweep.scan`` span); a span must never be
opened inside the body of a CUDA graph capture, which runs once, at
capture time.  Per-event device data never goes through the collector: it
rides out of the replay as tensors (``obs.trace.ReplayTrace``).

Span events use the Chrome ``trace_event`` complete-event shape
(``ph: "X"``, microsecond ``ts``/``dur``) so export is a passthrough.
The span *stack* is thread-local (``annotate()`` targets the innermost
open span of the calling thread); the finished-event buffer and the
counter registry are process-global behind a lock.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import statistics
import threading
import time
from typing import Callable, Dict, List, Optional

_T0 = time.perf_counter()
_LOCK = threading.Lock()
_EVENTS: List[dict] = []
_COUNTERS: Dict[str, float] = {}
_COUNTER_OPS = 0
_ENABLED = os.environ.get("REPRO_OBS", "") not in ("", "0")


class _Tls(threading.local):
    def __init__(self):
        self.stack: List["Span"] = []


_TLS = _Tls()


# ---------------------------------------------------------------- counters

def counter_add(name: str, n: float = 1) -> None:
    """Increment (or, with ``n < 0``, decrement) a named counter.  Always
    on; names are dotted ``<subsystem>.<what>``, the reference's names."""
    global _COUNTER_OPS
    _COUNTER_OPS += 1
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counter_get(name: str, default: float = 0) -> float:
    return _COUNTERS.get(name, default)


def counters() -> Dict[str, float]:
    """Snapshot of every counter (copy - safe to diff against later)."""
    with _LOCK:
        return dict(_COUNTERS)


def counter_ops() -> int:
    """Total ``counter_add`` calls so far (overhead accounting)."""
    return _COUNTER_OPS


def counter_deltas(before: Dict[str, float]) -> Dict[str, float]:
    """Counters that moved since a ``counters()`` snapshot."""
    now = counters()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


# Default histogram bucket bounds: powers of two, sized for the serving
# dispatch counters (batch sizes / queue depths up to the fixed-T ceiling).
HIST_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def counter_hist(name: str, value: float, bounds=HIST_BOUNDS) -> None:
    """Histogram-style counter: one observation lands in ``<name>.le_<b>``
    for the smallest bound >= value (``<name>.le_inf`` above the last),
    plus ``<name>.count`` / ``<name>.sum``.  Built from plain counters so
    histograms ride everything counters already ride (counter deltas, the
    JSONL run log) with no new export machinery."""
    for b in bounds:
        if value <= b:
            counter_add(f"{name}.le_{b}")
            break
    else:
        counter_add(f"{name}.le_inf")
    counter_add(f"{name}.count")
    counter_add(f"{name}.sum", value)


# ------------------------------------------------------------------- spans

class _NullSpan:
    """Shared no-op span: the entire disabled-mode cost."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        return self


_NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("name", "cat", "args", "_t0")

    def __init__(self, name: str, cat: str, args: dict):
        self.name, self.cat, self.args = name, cat, args

    def __enter__(self):
        _TLS.stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def set(self, **kw):
        """Attach attributes discovered mid-span (e.g. the backend that
        actually served a request)."""
        self.args.update(kw)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        _TLS.stack.pop()
        ev = {"name": self.name, "cat": self.cat, "ph": "X",
              "ts": (self._t0 - _T0) * 1e6, "dur": (t1 - self._t0) * 1e6,
              "tid": threading.get_ident() % 0xFFFF}
        if self.args:
            ev["args"] = self.args
        with _LOCK:
            _EVENTS.append(ev)
        return False


def span(name: str, cat: Optional[str] = None, **args):
    """Context manager timing a host-side region.  ``name`` is dotted
    ``<category>.<what>``; the category defaults to the first component.
    Returns the shared no-op span when recording is disabled."""
    if not _ENABLED:
        return _NULL_SPAN
    return Span(name, cat or name.split(".", 1)[0], args)


def instant(name: str, **args) -> None:
    """Record a zero-duration point event (Chrome ``ph: "i"``) - "a thing
    happened here": an injected fault, a retry, a degradation step, a
    checkpoint resume.  Gated like spans (the matching counter is the
    always-on record; the instant adds the *when* and the context when
    recording is enabled)."""
    if not _ENABLED:
        return
    ev = {"name": name, "cat": name.split(".", 1)[0], "ph": "i",
          "ts": (time.perf_counter() - _T0) * 1e6, "dur": 0.0,
          "tid": threading.get_ident() % 0xFFFF}
    if args:
        ev["args"] = args
    with _LOCK:
        _EVENTS.append(ev)


def annotate(**kw) -> None:
    """Attach attributes to the calling thread's innermost open span
    (no-op when disabled or outside any span)."""
    if _TLS.stack:
        _TLS.stack[-1].set(**kw)


def traced(name: Optional[str] = None, cat: Optional[str] = None):
    """Decorator flavor of ``span`` (span name defaults to the qualname)."""
    def deco(fn: Callable) -> Callable:
        nm = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with span(nm, cat):
                return fn(*a, **kw)
        return wrapper
    return deco


# ----------------------------------------------------------- global state

def enabled() -> bool:
    return _ENABLED


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def disable() -> None:
    enable(False)


def events() -> List[dict]:
    """Snapshot of every finished span event (copy)."""
    with _LOCK:
        return list(_EVENTS)


def reset(counters_too: bool = True) -> None:
    """Drop recorded span events (and, by default, zero the counters)."""
    with _LOCK:
        _EVENTS.clear()
        if counters_too:
            _COUNTERS.clear()


class _Recording:
    def __init__(self, clear: bool):
        self.clear = clear

    def __enter__(self):
        self._prev = _ENABLED
        if self.clear:
            reset(counters_too=False)
        enable()
        return self

    def __exit__(self, *exc):
        enable(self._prev)
        return False


def recording(clear: bool = True) -> _Recording:
    """``with obs.recording(): ...`` - enable spans for the block (and by
    default start from an empty event buffer)."""
    return _Recording(clear)


# ------------------------------------------------------------------ timeit

@dataclasses.dataclass(frozen=True)
class TimingStats:
    """Per-rep wall-clock stats from ``obs.timeit`` (seconds)."""
    reps: tuple

    @property
    def n(self) -> int:
        return len(self.reps)

    @property
    def best(self) -> float:
        return min(self.reps)

    @property
    def median(self) -> float:
        return statistics.median(self.reps)

    @property
    def mean(self) -> float:
        return statistics.fmean(self.reps)

    @property
    def stdev(self) -> float:
        return statistics.stdev(self.reps) if len(self.reps) > 1 else 0.0

    def row(self, name: str, derived, scale: float = 1.0) -> str:
        """A benchmark CSV row (the reference's ``benchmarks`` row format)
        carrying the spread as a structured comment.  ``scale`` converts
        per-call times to the row's unit (e.g. 1/E for a per-event row)."""
        s = scale * 1e6
        return (f"{name},{self.best * s:.1f},{derived}"
                f"  # med={self.median * s:.1f}us"
                f" sd={self.stdev * s:.1f}us n={self.n}")


def _device_sync() -> Callable[[], None]:
    """``torch.cuda.synchronize`` when a card is in use in this process
    (CUDA initialized), else a no-op: the CPU runs synchronously."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.synchronize
    return lambda: None


def timeit(fn: Callable, *args, n: int = 5, warmup: int = 1,
           **kw) -> TimingStats:
    """Time ``fn(*args, **kw)`` with ``perf_counter``.  When a card is in
    use, the device is synchronized before each clock read, so a rep covers
    the work ``fn`` queued on it, not just its launch.  ``warmup`` reps
    first (kernel builds, caches), then ``n`` measured reps; returns min /
    median / stdev instead of a single best-of-N wall-clock sample."""
    sync = _device_sync()
    for _ in range(max(0, warmup)):
        fn(*args, **kw)
    reps = []
    for _ in range(max(1, n)):
        sync()
        t0 = time.perf_counter()
        fn(*args, **kw)
        sync()
        reps.append(time.perf_counter() - t0)
    return TimingStats(tuple(reps))
