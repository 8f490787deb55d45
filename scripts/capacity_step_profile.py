"""Where a training step's time goes on the MoE capacity path: phase 23
(b)'s single-process step (granite-moe-3b-a800m at full width and
``chip_smoke.TP_LAYERS`` layers, fp32, the token stream's batch 0 of
``TP_TRAIN``), once to warm up, then timed on the host clock, then under
torch.profiler.

    python3 scripts/capacity_step_profile.py [--impl capacity|dense]

``--impl dense`` runs the dropless dispatch instead, for comparison.
Prints the wall of each step and the profiler's top operators by self
CUDA time and by self CPU time.  Needs one card.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", default="capacity")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.train import to_device
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import Runtime
    from repro_torch.train.train_step import make_grad_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cs.phase_build()
    name, cfg, _, _ = cs.tp_train_cases()[0]
    dev = torch.device("cuda")
    params = init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    B, S = cs.TP_TRAIN
    batch = to_device(TokenStream(cfg.vocab, S, B).batch(0), dev)
    step = make_grad_step(cfg, Runtime(moe_impl=args.impl))
    for i in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        grads, loss, _ = step(params, batch)
        torch.cuda.synchronize()
        print(f"{name} {args.impl}: step {i} {time.perf_counter() - t:.3f} s"
              f" loss {float(loss):.6f}", flush=True)
        del grads
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        grads, loss, _ = step(params, batch)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    print(ka.table(sort_by="self_cuda_time_total", row_limit=15))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=15))


if __name__ == "__main__":
    main()
