"""``python -m repro_torch obs`` - summarize or convert an obs run log.

    python -m repro_torch obs run.obs.jsonl                # text summary
    python -m repro_torch obs run.obs.jsonl --perfetto t.json
"""
from __future__ import annotations

import argparse

from .export import export_perfetto, read_jsonl, summarize


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch obs",
        description="Summarize a JSONL obs run log (spans + counters), "
                    "optionally converting it to Chrome/Perfetto "
                    "trace_event JSON.")
    ap.add_argument("log", help="JSONL run log (obs.export_jsonl)")
    ap.add_argument("--perfetto", metavar="OUT.json", default=None,
                    help="also write the spans as Chrome trace_event JSON")
    args = ap.parse_args(argv)
    events, counters, meta = read_jsonl(args.log)
    if meta:
        keys = ", ".join(f"{k}={v}" for k, v in sorted(meta.items())
                         if k not in ("schema", "type"))
        if keys:
            print(f"# {keys}")
    print(summarize(events, counters))
    if args.perfetto:
        path = export_perfetto(args.perfetto, events, counters)
        print(f"\nwrote {path} (open in https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
