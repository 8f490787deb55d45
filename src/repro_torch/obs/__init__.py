"""repro_torch.obs - spans, counters and replay decision traces; the
port's ``repro.obs``, with state of its own.

One observability layer for every execution path: host-side **spans**
(wall-clock intervals, Chrome ``trace_event`` shaped) and always-on
**counters** from the collector; per-event **replay traces** written by
the replay itself (``trace_level`` on ``sweep.run_batch`` and
``core.torchsim._replay_batch``); JSONL / Perfetto **exporters** plus the
``torch.profiler`` hook; and ``python -m repro_torch obs`` to summarize a
run log.

Span and counter names are the reference's (``sweep.run_batch``,
``sweep.scan``, ``pack.instances``, ``suite.build``, ``store.save``,
``consolidate.replay``, ``serving.select`` ...).  The rules: counters are
always on (single dict upsert); spans are recorded only under
``obs.enable()`` / ``obs.recording()`` / env ``REPRO_OBS=1`` and stay
outside CUDA graph captures (a captured body runs once, at capture time).
Per-event device data never goes through the collector - it rides out of
the replay as tensors (``ReplayTrace``).
"""
from .collector import (HIST_BOUNDS, Span, TimingStats, annotate,
                        counter_add, counter_deltas, counter_get,
                        counter_hist, counter_ops, counters, disable, enable,
                        enabled, events, instant, recording, reset, span,
                        timeit, traced)
from .export import (chrome_trace_events, export_jsonl, export_perfetto,
                     torch_profile, read_jsonl, summarize)
from .trace import (ReplayTrace, TraceDivergence, diff_traces, from_scan)

__all__ = [
    "HIST_BOUNDS", "Span", "TimingStats", "annotate", "counter_add",
    "counter_deltas", "counter_get", "counter_hist", "counter_ops",
    "counters", "disable", "enable", "enabled", "events", "instant",
    "recording", "reset", "span", "timeit", "traced",
    "chrome_trace_events", "export_jsonl", "export_perfetto", "torch_profile",
    "read_jsonl", "summarize",
    "ReplayTrace", "TraceDivergence", "diff_traces", "from_scan",
]
