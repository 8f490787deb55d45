"""The training entry point: the port's ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \\
        --reduced --steps 100 --batch 8 --seq 128 [--device cpu]

Trains ``--arch`` (its reduced configuration with ``--reduced``) from
random fp32 master weights (``init_params``, seed 0) on the deterministic
``TokenStream``, with AdamW, optional microbatches and checkpoints under
``--ckpt`` (every 50 steps and at the end; a run resumes from the latest
one).  Runs on the card unless ``--device cpu``.  The reference builds a
host device mesh for its step; the port's ``Runtime`` is mesh-free, its
MoE layers in the dense (dropless) mode.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCHS, get_config, get_reduced_config
from ..data.tokens import TokenStream
from ..kernels.ops import resolve_device
from ..models import params as P_
from ..models.transformer import Runtime
from ..train.checkpoint import CheckpointManager
from ..train.optimizer import OptConfig, init_opt_state
from ..train.train_step import make_train_step


def build(arch: str, reduced: bool, batch: int, seq: int, microbatches: int,
          lr: float, steps: int, device="cuda"):
    """(cfg, device, step_fn, params, opt_state, stream): the reference's
    ``build`` with the device in place of its mesh."""
    dev = resolve_device(device)
    cfg = get_reduced_config(arch) if reduced else get_config(arch)
    opt = OptConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                    total_steps=steps)
    step_fn = make_train_step(cfg, Runtime(), opt, microbatches=microbatches)
    params = P_.init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    opt_state = init_opt_state(params, opt)
    stream = TokenStream(cfg.vocab, seq, batch)
    return cfg, dev, step_fn, params, opt_state, stream


def to_device(batch, dev):
    """A ``TokenStream`` batch (numpy) as tensors on ``dev``."""
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def main(argv=None):
    """Runs the loop and prints the reference's log lines; returns the
    logged steps' metrics, a list of (step, {name: float}), each with the
    seconds since the loop began."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen2.5-14b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda or cpu)")
    args = ap.parse_args(argv)

    cfg, dev, step_fn, params, opt_state, stream = build(
        args.arch, args.reduced, args.batch, args.seq, args.microbatches,
        args.lr, args.steps, args.device)
    ckpt = CheckpointManager(args.ckpt) if args.ckpt else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start, (params, opt_state) = ckpt.restore((params, opt_state))
        print(f"resumed from step {start}")
    logged = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = to_device(stream.batch(step), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["seconds"] = time.time() - t0
            logged.append((step, m))
            print(f"step {step:5d} loss={m['loss']:.4f} "
                  f"ce={m['ce']:.4f} gnorm={m['grad_norm']:.3f} "
                  f"({m['seconds']:.1f}s)", flush=True)
        if ckpt and step and step % 50 == 0:
            ckpt.save(step, (params, opt_state))
    if ckpt:
        ckpt.save(args.steps, (params, opt_state))
        ckpt.wait()
    print("done")
    return logged


if __name__ == "__main__":
    main()
