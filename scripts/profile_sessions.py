"""Which earlier torch.profiler sessions make a later session's Chrome
trace lose device kernels, and whether ``obs.torch_profile``'s lead-in
keeps them, on the card.

    python3 scripts/profile_sessions.py

Runs each sequence of profiler sessions below in a fresh Python process,
every session around the same 31 device kernels (a 256 x 256 matmul
chain), and prints one JSON line a sequence: what each session saw.  The
sessions:

* ``cuda_only``: ``profile(activities=[CUDA])`` read by ``key_averages``
  (as ``chip_smoke.kernels_per_call`` runs it);
* ``cpu_cuda``: ``profile(activities=[CPU, CUDA])`` read by
  ``key_averages`` (as ``chip_smoke.profile_run``);
* ``big``: ``cpu_cuda`` around ``BIG_OPS`` small device ops (a profiled
  decode step of the 48-layer model launches thousands); ``big_nokey``
  the same, not read (-1 reported); ``big_export`` the same, read
  through ``export_chrome_trace`` (its kernels in the trace);
* ``graph``: a CUDA graph of the ops captured and replayed, unprofiled
  (0 reported);
* ``raw``: a CPU + CUDA session exported as a Chrome trace, as
  ``obs.torch_profile`` ran it before it had a lead-in: [kernels in the
  trace, the names of its first two];
* ``trace``: ``repro_torch.obs.torch_profile(logdir)``: [the block's
  kernels in the trace, the lead-in's spin kernels in it].

Needs the card; builds nothing.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEQUENCES = (("raw",), ("cuda_only", "raw"), ("graph", "raw"),
             ("big_nokey", "raw"), ("big", "big", "raw", "trace"),
             ("big", "big", "cpu_cuda", "trace"),
             ("big_export", "big_export", "raw"))
BIG_OPS = 60_000


def _work(torch, n: int = 10):
    x = torch.randn(256, 256, device="cuda")
    for _ in range(n):
        x = (x @ x).clamp_(-1.0, 1.0)
    torch.cuda.synchronize()


def _kernels(path):
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    return [n for _, n in sorted((e["ts"], e["name"]) for e in evs
                                 if e.get("cat") == "kernel")]


def _session(kind: str, logdir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    if kind == "graph":
        x = torch.randn(256, 256, device="cuda")
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            g.capture_begin()
            (x @ x).clamp_(-1.0, 1.0)
            g.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        for _ in range(100):
            g.replay()
        torch.cuda.synchronize()
        return 0
    if kind == "trace":
        with obs.torch_profile(logdir) as path:
            _work(torch)
        ks = _kernels(path)
        lead = sum("spin_kernel" in k for k in ks)
        return [len(ks) - lead, lead]
    acts = [ProfilerActivity.CUDA] if kind == "cuda_only" else \
        [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    prof = profile(activities=acts)
    prof.start()
    _work(torch, BIG_OPS // 2 if kind.startswith("big") else 10)
    prof.stop()
    if kind == "raw":
        path = os.path.join(logdir, "raw.json")
        prof.export_chrome_trace(path)
        ks = _kernels(path)
        return [len(ks), [k[:24] for k in ks[:2]]]
    if kind == "big_nokey":
        return -1
    if kind == "big_export":
        path = os.path.join(logdir, "big.json")
        prof.export_chrome_trace(path)
        return len(_kernels(path))
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def child(kinds) -> None:
    import torch
    _work(torch)                       # the context exists, as on the path
    logdir = tempfile.mkdtemp(prefix="profile_sessions_")
    print(json.dumps({"sequence": list(kinds),
                      "saw": [_session(k, logdir) for k in kinds]}))


def main() -> None:
    if len(sys.argv) > 1:
        child(sys.argv[1].split(","))
        return
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for seq in SEQUENCES:
        p = subprocess.run([sys.executable, __file__, ",".join(seq)],
                           env=env, capture_output=True, text=True,
                           timeout=600)
        print(p.stdout.strip() or json.dumps(
            {"sequence": list(seq), "rc": p.returncode,
             "stderr": p.stderr[-800:]}), flush=True)


if __name__ == "__main__":
    main()
