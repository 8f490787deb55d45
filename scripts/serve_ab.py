"""The serving path's end-to-end times and the attention wrappers' host cost
of one source tree, so that two trees (a commit and its parent) can be
compared on one card.

    python3 scripts/serve_ab.py [--root TREE] [--label NAME]

``TREE`` (default: the tree this script lies in) is a checkout of this
repo; its own ``chip_smoke.py`` builds its kernels (``phase_build``) and
runs its serving phase's timed run (``timed_serve_real``: serve_real at
qwen2.5-14b's full width, 12 requests, every engine prefill and decode step
timed on the host clock between synchronizations).  Before that, the host
time of one ``ops.flash_attention`` call (bf16, Sq = Skv = 221, H 40, KV 8,
hd 128, causal: the teacher-forced prompt's prefill) and one
``ops.decode_attention`` call (bf16, B 4, S 1024: the engine's decode) is
the wall time of queueing 200 calls, divided by 200, while a spin kernel
holds the stream (so the device never waits for the host and the host
never waits for the device).  Prints, as its last line, one JSON object
with the label, the card and these numbers.  Needs one card.

To compare two trees, run them in turns on one machine (A, B, B, A) and
compare within that sequence: the host's speed drifts from one machine
and hour to the next.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_CALLS = 200


def host_ms(fn, calls: int = HOST_CALLS) -> float:
    """Host time of queueing one call of ``fn`` (see the module
    docstring)."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)     # ~0.5 s of spinning
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("serve_ab: needs a card")
    cs = importlib.import_module("chip_smoke")
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params
    dev = torch.device("cuda")
    card = cs.phase_build()

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    q, k, v = randn(1, 221, 40, 128), randn(1, 221, 8, 128), \
        randn(1, 221, 8, 128)
    flash_host = host_ms(lambda: ops.flash_attention(q, k, v))
    dq, dk, dv = randn(4, 40, 128), randn(4, 1024, 8, 128), \
        randn(4, 1024, 8, 128)
    kv_len = torch.tensor([1024, 700, 300, 129], dtype=torch.int32,
                          device=dev)
    decode_host = host_ms(lambda: ops.decode_attention(dq, dk, dv, kv_len))
    del q, k, v, dq, dk, dv

    cfg = get_config("qwen2.5-14b")
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    reqs = cs.serving_requests()
    stats, wall, times, counts = cs.timed_serve_real(cfg, params, reqs)
    pre, dec = np.array(times["prefill"]), np.array(times["decode"])
    print(card)
    print(json.dumps({
        "label": args.label or root, "card": card,
        "flash_host_ms": flash_host, "decode_host_ms": decode_host,
        "prefill_median_ms": float(np.median(pre)),
        "decode_median_ms": float(np.median(dec)),
        "decode_mean_ms": float(dec.mean()),
        "prefills": len(pre), "decode_steps": len(dec), "wall_s": wall,
        "stats": [stats.replica_seconds, stats.replicas_opened,
                  stats.peak_replicas],
        "launches": dict(counts)}), flush=True)


if __name__ == "__main__":
    main()
