"""Exporters for the obs collector: JSONL run logs, Chrome/Perfetto
``trace_event`` JSON, a text summary, and the ``torch.profiler`` hook; the
port's ``repro.obs.export``.

A *run log* is line-delimited JSON: one ``{"type": "meta", ...}`` header,
one line per span event, and a final ``{"type": "counters", ...}``
snapshot - append-friendly, grep-friendly, and the per-SHA CI artifact
format.  The Perfetto export is the same span events in the Chrome
``trace_event`` envelope ({"traceEvents": [...]}), which
https://ui.perfetto.dev and chrome://tracing open directly.
"""
from __future__ import annotations

import json
import os
import time
import warnings
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from . import collector


def _pick(events, counters_):
    if events is None:
        events = collector.events()
    if counters_ is None:
        counters_ = collector.counters()
    return events, counters_


def export_jsonl(path: str, events: Optional[List[dict]] = None,
                 counters: Optional[Dict[str, float]] = None,
                 meta: Optional[dict] = None) -> str:
    """Write a JSONL run log (spans + final counter snapshot)."""
    events, counters = _pick(events, counters)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps({"type": "meta", "schema": 1,
                            "unix_time": time.time(),
                            **(meta or {})}) + "\n")
        for ev in events:
            f.write(json.dumps({"type": "span", **ev}) + "\n")
        f.write(json.dumps({"type": "counters", "counters": counters})
                + "\n")
    return path


def read_jsonl(path: str) -> Tuple[List[dict], Dict[str, float], dict]:
    """Load a run log back into (span events, counters, meta)."""
    events, counters, meta = [], {}, {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            t = rec.pop("type", "span")
            if t == "span":
                events.append(rec)
            elif t == "counters":
                counters.update(rec.get("counters", {}))
            elif t == "meta":
                meta.update(rec)
    return events, counters, meta


def chrome_trace_events(events: Optional[List[dict]] = None,
                        counters: Optional[Dict[str, float]] = None) -> dict:
    """The Chrome ``trace_event`` JSON object for recorded spans (counters
    ride along as ``otherData`` so they survive the round trip)."""
    events, counters = _pick(events, counters)
    pid = os.getpid()
    out = [{"pid": pid, "tid": ev.get("tid", 0), "ph": ev.get("ph", "X"),
            "name": ev["name"], "cat": ev.get("cat", ""),
            "ts": ev["ts"], "dur": ev["dur"],
            "args": ev.get("args", {})} for ev in events]
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"counters": counters}}


def export_perfetto(path: str, events: Optional[List[dict]] = None,
                    counters: Optional[Dict[str, float]] = None) -> str:
    """Write spans as Chrome/Perfetto ``trace_event`` JSON."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(chrome_trace_events(events, counters), f, indent=1)
    return path


def summarize(events: Optional[List[dict]] = None,
              counters: Optional[Dict[str, float]] = None) -> str:
    """Text summary: per-span-name call counts and total/mean/max wall
    time, then every counter - what ``python -m repro obs`` prints."""
    events, counters = _pick(events, counters)
    agg: Dict[str, list] = {}
    for ev in events:
        agg.setdefault(ev["name"], []).append(ev["dur"])
    lines = [f"{'span':<28}{'calls':>7}{'total_ms':>10}{'mean_us':>10}"
             f"{'max_us':>10}"]
    for name in sorted(agg, key=lambda n: -sum(agg[n])):
        durs = agg[name]
        lines.append(f"{name:<28}{len(durs):>7}"
                     f"{sum(durs) / 1e3:>10.2f}"
                     f"{sum(durs) / len(durs):>10.0f}"
                     f"{max(durs):>10.0f}")
    if not agg:
        lines.append("(no spans recorded)")
    lines.append("")
    lines.append(f"{'counter':<40}{'value':>14}")
    for name in sorted(counters):
        v = counters[name]
        lines.append(f"{name:<40}{v:>14g}")
    if not counters:
        lines.append("(no counters)")
    return "\n".join(lines)


# Spin kernels (``torch.cuda._sleep``, "spin_kernel" in a trace) that open
# every device-profiling session of ``torch_profile``.  In a process whose
# earlier profiler sessions were read through ``key_averages``, a new
# session's first kernel records are missing from its trace (31 kernels
# gave 26 after two read sessions of 90 000 kernels; none were missing
# after unread ones; behind the lead-in all 31 were there:
# scripts/profile_sessions.py on the card); a short profiled block can lose
# all of its kernels.  The lead-in takes those first records, and
# ``lead_in_survivors`` checks that it was long enough: a session whose
# trace holds none of its spin kernels may have lost the block's first
# kernels too, and says so (``profiler.lead_in_lost``, a warning).
LEAD_IN_KERNELS = 2048
LEAD_IN_NAME = "obs.torch_profile.lead_in"

# the torch_profile session open in this process, if any (sessions do not
# nest: an inner one is a no-op inside an outer one)
_ACTIVE: List[str] = []


def lead_in_survivors(path: str) -> int:
    """The lead-in's spin kernels in the Chrome trace at ``path``; none
    means the lead-in was lost whole, and with it perhaps the block's
    first kernels: counted ``profiler.lead_in_lost`` and warned."""
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    n = sum(e.get("cat") == "kernel" and "spin_kernel" in e.get("name", "")
            for e in trace)
    if not n:
        collector.counter_add("profiler.lead_in_lost")
        warnings.warn(f"torch_profile: none of the {LEAD_IN_KERNELS} "
                      f"lead-in kernels is in {path}; the block's first "
                      "kernels may be missing too", RuntimeWarning,
                      stacklevel=3)
    return n


def _lead_in(torch) -> None:
    with torch.profiler.record_function(LEAD_IN_NAME):
        for _ in range(LEAD_IN_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()


@contextmanager
def torch_profile(logdir: Optional[str] = None):
    """``torch.profiler`` start/stop around a block, recorded as a
    ``profiler.torch_trace`` span, writing a Chrome trace of the host ops
    and (when a card is in use) its kernels into ``logdir``.  Active only
    when a log dir is given (or env ``REPRO_OBS_PROFILE`` names one) and
    no other ``torch_profile`` session is open; otherwise a no-op, so it
    can wrap the replay dispatch unconditionally.  A session that profiles
    the card starts with ``LEAD_IN_KERNELS`` spin kernels under a
    ``LEAD_IN_NAME`` range, so that the block's own kernels are in the
    trace, and its trace is checked for them (``lead_in_survivors``).
    Yields the trace file's path, which exists once the block has
    exited."""
    logdir = logdir or os.environ.get("REPRO_OBS_PROFILE", "")
    if not logdir or _ACTIVE:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"torch_trace_{os.getpid()}_"
                                f"{time.time_ns()}.json")
    with collector.span("profiler.torch_trace", cat="profiler",
                        logdir=logdir):
        prof = profile(activities=acts)
        prof.start()
        _ACTIVE.append(path)
        try:
            if cuda:
                _lead_in(torch)
            yield path
        finally:
            _ACTIVE.pop()
            prof.stop()
            prof.export_chrome_trace(path)
            if cuda:
                lead_in_survivors(path)
