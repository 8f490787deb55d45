"""The training entry point: the port's ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \\
        --reduced --steps 100 --batch 8 --seq 128 [--device cpu] \\
        [--mesh DxM] [--fsdp] [--backend nccl|gloo]

Trains ``--arch`` (its reduced configuration with ``--reduced``) from
random fp32 master weights (``init_params``, seed 0) on the deterministic
``TokenStream``, with AdamW, optional microbatches and checkpoints under
``--ckpt`` (every 50 steps and at the end; a run resumes from the latest
one).  Runs on the card unless ``--device cpu``.

It trains on a mesh, as the reference's does on its host mesh: ``--mesh
DxM`` (D data x M model ranks; default the reference's host mesh, every
rank of the group as (N, 1), with ``ShardingRules(fsdp=False)``; ``--fsdp``
shards the weights over "data" too).  With more than one rank it joins the
group ``torchrun`` made (``RANK`` / ``WORLD_SIZE`` set), else it spawns one
process a rank over a file store; rank ``r`` takes card ``r %
device_count``; NCCL on the card by default (``--backend gloo`` to put two
ranks on one card), gloo on the CPU.  Each rank initialises the whole
model and keeps its shards.  Rank 0 logs.  Under a mesh, even of (1, 1),
MoE layers take the capacity path, as the reference's launcher does.
"""
from __future__ import annotations

import argparse
import os
import queue
import tempfile
import time

import torch
import torch.distributed as dist

from ..configs import ARCHS, get_config, get_reduced_config
from ..data.tokens import TokenStream
from ..kernels.ops import resolve_device
from ..models import params as P_
from ..models.sharding import ShardingRules, shard_tree, tree_placements
from ..models.transformer import Runtime
from ..train.checkpoint import CheckpointManager
from ..train.optimizer import OptConfig, init_opt_state, opt_state_placements
from ..train.train_step import make_train_step
from .mesh import join, make_mesh, one_rank_group


def _opt(lr: float, steps: int) -> OptConfig:
    return OptConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                     total_steps=steps)


def _rules(fsdp: bool) -> ShardingRules:
    return ShardingRules(fsdp=fsdp, data_axes=("data",))


def build(arch: str, reduced: bool, batch: int, seq: int, microbatches: int,
          lr: float, steps: int, device="cuda", mesh=None, fsdp=False):
    """(cfg, device, step_fn, params, opt_state, stream): the reference's
    ``build``, on ``mesh`` (None: one rank, no mesh) with
    ``ShardingRules(fsdp=fsdp)``; under a mesh ``params`` and
    ``opt_state`` are this rank's shards (``state_placements`` lays them
    out)."""
    dev = resolve_device(device)
    cfg = get_reduced_config(arch) if reduced else get_config(arch)
    rt = Runtime(mesh=mesh, rules=_rules(fsdp))
    step_fn = make_train_step(cfg, rt, _opt(lr, steps),
                              microbatches=microbatches)
    params = P_.init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    if mesh is not None:
        params = shard_tree(params, tree_placements(cfg, mesh, rt.rules),
                            mesh)
    opt_state = init_opt_state(params, _opt(lr, steps))
    stream = TokenStream(cfg.vocab, seq, batch)
    return cfg, dev, step_fn, params, opt_state, stream


def state_placements(cfg, mesh, fsdp: bool, lr: float, steps: int):
    """The placements of ``build``'s (params, opt_state) on ``mesh``."""
    pl = tree_placements(cfg, mesh, _rules(fsdp))
    return pl, opt_state_placements(pl, _opt(lr, steps))


def to_device(batch, dev):
    """A ``TokenStream`` batch (numpy) as tensors on ``dev``."""
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _parse(argv):
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
    ap.add_argument("--mesh", default="",
                    help="DxM data x model ranks (default: every rank of "
                         "the group, or the local cards, as (N, 1))")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard the weights' embed axis over data too")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the ranks' backend on the card (default nccl)")
    return ap.parse_args(argv)


def _mesh_shape(args):
    if args.mesh:
        d, m = (int(v) for v in args.mesh.lower().split("x"))
        return d, m
    if dist.is_initialized():
        return dist.get_world_size(), 1
    if "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"]), 1
    resolve_device(args.device)
    return (1 if args.device == "cpu" else torch.cuda.device_count()), 1


def _train(args, mesh):
    """The loop on this rank; rank 0 prints the reference's log lines.
    Returns the logged steps' metrics (rank 0's; [] elsewhere)."""
    cfg, dev, step_fn, params, opt_state, stream = build(
        args.arch, args.reduced, args.batch, args.seq, args.microbatches,
        args.lr, args.steps, args.device, mesh, args.fsdp)
    placements = state_placements(cfg, mesh, args.fsdp, args.lr, args.steps)
    lead = dist.get_rank() == 0
    ckpt = CheckpointManager(args.ckpt, mesh=mesh) if args.ckpt else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start, (params, opt_state) = ckpt.restore((params, opt_state),
                                                  placements=placements)
        if lead:
            print(f"resumed from step {start}")
    logged = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = to_device(stream.batch(step), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            m["seconds"] = time.time() - t0
            logged.append((step, m))
            print(f"step {step:5d} loss={m['loss']:.4f} "
                  f"ce={m['ce']:.4f} gnorm={m['grad_norm']:.3f} "
                  f"({m['seconds']:.1f}s)", flush=True)
        if ckpt and step and step % 50 == 0:
            ckpt.save(step, (params, opt_state), placements)
    if ckpt:
        ckpt.save(args.steps, (params, opt_state), placements)
        ckpt.wait()
    if lead:
        print("done")
    return logged


def _rank(rank: int, world: int, init: str, argv, out) -> None:
    """One spawned rank: join the group, train, and hand rank 0's log to
    the parent."""
    args = _parse(argv)
    join(rank, world, init, backend=args.backend, device=args.device)
    try:
        logged = _train(args, make_mesh(_mesh_shape(args), ("data", "model"),
                                        _device_type(args)))
        if rank == 0:
            out.put(logged)
    finally:
        dist.destroy_process_group()


def _device_type(args) -> str:
    return "cpu" if args.device == "cpu" else "cuda"


def main(argv=None):
    """Runs the loop and prints the reference's log lines (rank 0); returns
    the logged steps' metrics, a list of (step, {name: float}), each with
    the seconds since the loop began."""
    args = _parse(argv)
    shape = _mesh_shape(args)
    world = shape[0] * shape[1]
    if world > 1 and not dist.is_initialized() and \
            "WORLD_SIZE" not in os.environ:
        return _spawn(world, argv)
    made = not dist.is_initialized()
    if made:
        if "WORLD_SIZE" in os.environ:       # a rank torchrun started
            join(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                 "env://", backend=args.backend, device=args.device)
        else:
            resolve_device(args.device)
            one_rank_group()
    try:
        return _train(args, make_mesh(shape, ("data", "model"),
                                      _device_type(args)))
    finally:
        if made:
            dist.destroy_process_group()


def _spawn(world: int, argv):
    """Start ``world`` rank processes over a file store, wait for them and
    return rank 0's log; a rank that fails raises here."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = tempfile.mkdtemp(prefix="repro_torch_pg_")
    procs = [ctx.Process(target=_rank, args=(r, world, f"file://{store}/pg",
                                             argv, out))
             for r in range(world)]
    for p in procs:
        p.start()
    logged = None
    while logged is None:
        try:
            logged = out.get(timeout=1.0)
        except queue.Empty:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if not any(p.is_alive() for p in procs):   # a last read
                try:
                    logged = out.get(timeout=1.0)
                except queue.Empty:
                    break
    for p in procs:
        p.join(timeout=None if logged is not None else 30)
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if logged is None or any(codes):
        raise RuntimeError(f"training ranks exited with {codes}")
    return logged


if __name__ == "__main__":
    main()
