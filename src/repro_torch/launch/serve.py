"""Serving entry point: a replica fleet with DVBP placement (the paper's
technique as the serving control plane); the port's ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 40 \\
        --policy nrt_prioritized --sigma 0.5 [--real] [--device cpu] \\
        [--arch ARCH]

Prints the replica-occupancy seconds of a simulated fleet for a few
policies beside a round-robin baseline; with ``--real`` it also serves the
first 12 requests (prompts cut to 16 tokens, decodes to 32) with real
``ReplicaEngine``s of the reduced configuration of ``--arch`` (one of
``configs.ARCHS``: the dense GQA decoders, the MoE decoders (granite-moe,
deepseek-v2-lite with MLA), whisper-medium and pixtral-12b on text prompts
alone, RWKV6, hymba's attention and SSD heads), placed by the
``DVBPScheduler``.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import ARCHS, get_reduced_config
from ..kernels.ops import resolve_device
from ..models import params as P_
from ..serving.engine import ReplicaEngine
from ..serving.fleet import attach_predictions, simulate_fleet, synth_requests
from ..serving.scheduler import DVBPScheduler, ReplicaCapacity, Request


def serve_real(cfg, params, reqs, policy: str, slots: int = 4,
               max_len: int = 96):
    """Clock-stepped fleet of real engines; one decode tick per time unit.
    The engines run where ``params`` live.  Returns the scheduler's
    ``PlacementStats``."""
    caps = ReplicaCapacity(slots=slots, kv_tokens=slots * max_len,
                           prefill_budget=1e9)
    sched = DVBPScheduler(policy, caps, tokens_per_second=1.0)
    engines = {}
    pending = sorted(reqs, key=lambda r: r.arrival)
    t = 0.0
    done = 0
    while done < len(reqs):
        while pending and pending[0].arrival <= t:
            r = pending.pop(0)
            rep = sched.place(r, t)
            if rep not in engines:
                engines[rep] = ReplicaEngine(cfg, params, slots=slots,
                                             max_len=max_len, eos_id=-1)
            prompt = list(np.random.default_rng(r.rid).integers(
                2, cfg.vocab, r.prompt_len))
            engines[rep].admit(r.rid, prompt, r.decode_len)
        for rep, eng in list(engines.items()):
            for rid in eng.step():
                sched.finish(rid, t)
                done += 1
        t += 1.0
    return sched.stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen2.5-14b")
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--policy", default="greedy")
    ap.add_argument("--sigma", type=float, default=0.0,
                    help="log-normal prediction error for learned policies")
    ap.add_argument("--real", action="store_true",
                    help="run real reduced-model engines (slower)")
    ap.add_argument("--device", default="cuda",
                    help="where the real engines run (cuda or cpu)")
    args = ap.parse_args(argv)

    reqs = synth_requests(args.requests)
    if args.sigma >= 0:
        reqs = attach_predictions(reqs, args.sigma)

    print("fleet simulation (replica-occupancy seconds; lower is better):")
    for pol in ["round_robin", "first_fit", "best_fit_linf", "greedy",
                "nrt_prioritized", args.policy]:
        kw = {"norm": "linf"} if pol == "best_fit_linf" else None
        name = "best_fit" if pol == "best_fit_linf" else pol
        r = simulate_fleet(reqs, name if pol != "round_robin" else pol,
                           policy_kwargs=kw)
        print(f"  {pol:18s} replica_s={r['replica_seconds']:10.1f} "
              f"opened={r['replicas_opened']:3d} peak={r['peak_replicas']}")

    if args.real:
        dev = resolve_device(args.device)
        cfg = get_reduced_config(args.arch)
        params = P_.init_params(cfg, seed=0, device=dev, dtype=torch.float32)
        small = [Request(r.rid, r.arrival, min(r.prompt_len, 16),
                         min(r.decode_len, 32), r.predicted_decode_len)
                 for r in reqs[: min(args.requests, 12)]]
        stats = serve_real(cfg, params, small, args.policy)
        print(f"real engines ({args.policy}, {dev.type}): replica_s="
              f"{stats.replica_seconds:.0f} opened={stats.replicas_opened} "
              f"peak={stats.peak_replicas}")


if __name__ == "__main__":
    main()
