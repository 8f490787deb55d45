"""The port's side of ``test_torch_tp.py``: one gloo rank of a world of 2
or 4 processes on the CPU, running every case of ``tp_cases`` whose mesh
has that many ranks; rank 0 writes the results (whole tensors, gathered
from the shards) to one ``.npz``.

    python tests/tp_ranks.py RANK WORLD file://STORE OUT.npz
"""
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

import tp_cases as C
from repro_torch.configs import get_reduced_config
from repro_torch.launch.mesh import join, make_mesh
from repro_torch.models import moe
from repro_torch.models import params as P_
from repro_torch.models.sharding import (ShardingRules, gather_tree,
                                         local_slice, shard_tree,
                                         tree_placements)
from repro_torch.models.transformer import Runtime, forward, init_cache
from repro_torch.train import optimizer as opt_
from repro_torch.train import train_step as ts
from repro_torch.train.grad_compress import _quant, compress_allreduce

_MESHES = {}


def mesh_of(shape, axes=("data", "model")):
    if (shape, axes) not in _MESHES:
        _MESHES[shape, axes] = make_mesh(shape, axes, "cpu")
    return _MESHES[shape, axes]


def config(arch, **over):
    return dataclasses.replace(get_reduced_config(arch), dtype="float32",
                               **over)


def full_params(cfg):
    metas = P_._finalize(cfg, lambda m, n: (((n,) + m.shape) if n else
                                            m.shape, m.init, m.scale))
    return P_.params_from_reference(C.numpy_params(metas), cfg,
                                    device="cpu")


def keystr(tree, prefix=""):
    """(name, leaf) pairs named as ``jax.tree_util.keystr`` names them."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in keystr(tree[k],
                                                        f"{prefix}['{k}']")]
    return [(prefix, tree)]


def run_forward(name, out):
    arch, shape, rules, absorb, over = C.FORWARD[name]
    cfg = config(arch, **over)
    mesh = mesh_of(shape)
    rules = ShardingRules(**rules)
    rt = Runtime(mesh=mesh, rules=rules, mla_absorb=absorb)
    params = shard_tree(full_params(cfg), tree_placements(cfg, mesh, rules),
                        mesh)
    x = C.forward_inputs(cfg)
    extras = {k: torch.from_numpy(x[k]) for k in ("frontend_embeds",
                                                  "enc_embeds") if k in x}
    toks = torch.from_numpy(x["tokens"])
    with torch.no_grad():
        out[f"{name}/train"] = forward(params, cfg, rt, toks, mode="train",
                                       **extras)[0].numpy()
        n_front = cfg.n_frontend_tokens if "frontend_embeds" in x else 0
        cache = init_cache(cfg, C.B, C.S + n_front + C.STEPS,
                           dtype=torch.float32, device="cpu", mesh=mesh,
                           rules=rules)
        logits, cache, _ = forward(params, cfg, rt, toks, mode="prefill",
                                   cache=cache, cache_pos=0, **extras)
        out[f"{name}/prefill"] = logits.numpy()
        for i in range(C.STEPS):
            logits, cache, _ = forward(
                params, cfg, rt, torch.from_numpy(x["steps"][i]),
                mode="decode", cache=cache, cache_pos=C.S + n_front + i)
            out[f"{name}/decode{i}"] = logits.numpy()


def run_moe(name, out):
    shape, over = C.MOE[name]
    cfg = config("granite-moe-3b-a800m", **over)
    mesh = mesh_of(shape)
    rules = ShardingRules()
    pl = tree_placements(cfg, mesh, rules)["layers"]
    full = {k: v[0] for k, v in full_params(cfg)["layers"].items()}
    blk = {k: local_slice(v, pl[k][1:], mesh).contiguous()
           for k, v in full.items()}
    x = torch.from_numpy(C.moe_input(cfg))
    rows = C.MOE_B // shape[0]
    d = mesh.get_local_rank("data") if shape[0] > 1 else 0
    for impl, key in (("auto", ""), ("dense", "dense_")):
        with torch.no_grad():
            y, aux = moe.moe_block(blk, x[d * rows:(d + 1) * rows], cfg,
                                   mesh=mesh, data_axes=("data",),
                                   norm_topk=True, impl=impl)
            parts = [torch.empty_like(y)
                     for _ in range(dist.get_world_size())]
            dist.all_gather(parts, y.contiguous())
        # the data shards' outputs, from the ranks of model coordinate 0
        out[f"{name}/{key}out"] = torch.cat(parts[::shape[1]]).numpy()
        out[f"{name}/{key}aux"] = aux.numpy()
    for j in range(shape[0]):
        xf = x[j * rows:(j + 1) * rows].reshape(-1, cfg.d_model)
        gates, _ = moe.router_probs(xf, full["router"])
        cap = moe._capacity(xf.shape[0], cfg.top_k, cfg.n_experts,
                            cfg.capacity_factor)
        _, table, wtable = moe._dispatch_local(xf, gates, cfg.top_k, cap,
                                               True)
        out[f"{name}/table{j}"] = table.numpy()
        out[f"{name}/wtable{j}"] = wtable.numpy()


def run_train(name, out):
    arch, shape, rules, state_dtype = C.TRAIN[name]
    cfg = config(arch)
    mesh = mesh_of(shape)
    rules = ShardingRules(**rules)
    rt = Runtime(mesh=mesh, rules=rules)
    opt = opt_.OptConfig(state_dtype=state_dtype, **C.OPT)
    pl = tree_placements(cfg, mesh, rules)
    full = full_params(cfg)
    params = shard_tree(full, pl, mesh)
    batch = {k: torch.from_numpy(v) for k, v in C.train_batch(cfg).items()}
    grads, _, _ = ts.make_grad_step(cfg, rt, C.MICRO)(params, batch)
    for k, v in keystr(gather_tree(grads, pl, mesh)):
        out[f"{name}/grad/{k}"] = v.float().numpy()
    if dist.get_rank() == 0:     # the same step on one rank, no mesh
        one, _, _ = ts.make_grad_step(cfg, Runtime(), C.MICRO)(full, batch)
        for k, v in keystr(one):
            out[f"{name}/one_rank/{k}"] = v.float().numpy()
    del full
    state = opt_.init_opt_state(params, opt)
    step = ts.make_train_step(cfg, rt, opt, microbatches=C.MICRO)
    params, state, metrics = step(params, state, batch)
    for k, v in metrics.items():
        out[f"{name}/metric/{k}"] = v.numpy()
    for k, v in keystr(gather_tree(params, pl, mesh)):
        out[f"{name}/param/{k}"] = v.detach().numpy()
    opl = opt_.opt_state_placements(pl, opt)
    for key in ("m", "v"):
        for k, v in keystr(gather_tree(state[key], opl[key], mesh)):
            out[f"{name}/{key}/{k}"] = v.numpy()


def run_compress(rank, out):
    """``compress_allreduce`` over the "pod" axis of a (2, 2, 1) mesh: each
    rank's gradients and errors from its own seed; its reduced values and
    new errors."""
    mesh = mesh_of((2, 2, 1), ("pod", "data", "model"))
    rng = np.random.default_rng([C.SEED, 10 + rank])
    g = {"w": rng.standard_normal((6, 33)).astype(np.float32)}
    e = {"w": (1e-3 * rng.standard_normal((6, 33))).astype(np.float32)}
    red, err = compress_allreduce({k: torch.from_numpy(v) for k, v in
                                   g.items()},
                                  {k: torch.from_numpy(v) for k, v in
                                   e.items()}, mesh=mesh)
    q, s = _quant(torch.from_numpy(g["w"] + e["w"]))
    mine = (q.float() * s).numpy()
    parts = [torch.empty(6, 33) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, torch.from_numpy(mine))
    outs = [torch.empty(6, 33) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, red["w"])
    out["compress/deq"] = torch.stack(parts).numpy()
    out["compress/out"] = torch.stack(outs).numpy()


def main(rank, world, init, path):
    torch.set_num_threads(1)
    join(rank, world, init, device="cpu")
    out = {}
    try:
        for name, (_, shape, _, _, _) in C.FORWARD.items():
            if C.world(shape) == world:
                run_forward(name, out)
        for name, (shape, _) in C.MOE.items():
            if C.world(shape) == world:
                run_moe(name, out)
        for name, (_, shape, _, _) in C.TRAIN.items():
            if C.world(shape) == world:
                run_train(name, out)
        if world == 4:
            run_compress(rank, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(path, **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
