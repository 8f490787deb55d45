"""The JAX package's side of ``test_torch_tp.py``: every case of
``tp_cases`` on a mesh of automatic axes over 4 host devices (the
reference's sharded ``forward`` and ``make_train_step`` refuse the
explicit axes ``jax.make_mesh`` makes by default), written to one
``.npz``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/tp_reference.py OUT.npz forward|rest
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType

import tp_cases as C
from repro.configs import get_reduced_config
from repro.models import moe as ref_moe
from repro.models import params as P_
from repro.models.sharding import ShardingRules
from repro.models.transformer import Runtime, forward, init_cache
from repro.train import optimizer as opt_
from repro.train import train_step as ts


def mesh_of(shape):
    n = C.world(shape)
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])


def params_of(cfg):
    metas = P_._finalize(cfg, lambda m, n: (((n,) + m.shape) if n else
                                            m.shape, m.init, m.scale))
    return C.numpy_params(metas)


def config(arch, **over):
    return dataclasses.replace(get_reduced_config(arch), dtype="float32",
                               **over)


def run_forward(name, out):
    arch, shape, rules, absorb, over = C.FORWARD[name]
    cfg = config(arch, **over)
    mesh = mesh_of(shape)
    rt = Runtime(mesh=mesh, rules=ShardingRules(**rules), mla_absorb=absorb)
    params = jax.tree.map(jnp.asarray, params_of(cfg))
    x = C.forward_inputs(cfg)
    extras = {k: jnp.asarray(x[k]) for k in ("frontend_embeds", "enc_embeds")
              if k in x}
    toks = jnp.asarray(x["tokens"])
    with mesh:
        train = jax.jit(lambda p, t, e: forward(p, cfg, rt, t, mode="train",
                                                **e)[0])
        out[f"{name}/train"] = np.asarray(train(params, toks, extras))
        n_front = cfg.n_frontend_tokens if "frontend_embeds" in x else 0
        cache = init_cache(cfg, C.B, C.S + n_front + C.STEPS,
                           dtype=jnp.float32)
        prefill = jax.jit(lambda p, t, c, e: forward(
            p, cfg, rt, t, mode="prefill", cache=c, cache_pos=0, **e)[:2])
        decode = jax.jit(lambda p, t, c, pos: forward(
            p, cfg, rt, t, mode="decode", cache=c, cache_pos=pos)[:2])
        logits, cache = prefill(params, toks, cache, extras)
        out[f"{name}/prefill"] = np.asarray(logits)
        for i in range(C.STEPS):
            logits, cache = decode(params, jnp.asarray(x["steps"][i]), cache,
                                   jnp.int32(C.S + n_front + i))
            out[f"{name}/decode{i}"] = np.asarray(logits)


def run_moe(name, out):
    shape, over = C.MOE[name]
    cfg = config("granite-moe-3b-a800m", **over)
    mesh = mesh_of(shape)
    tree = params_of(cfg)
    blk = {k: jnp.asarray(v[0]) for k, v in tree["layers"].items()}
    x = C.moe_input(cfg)
    with mesh:
        fn = jax.jit(lambda b, x: ref_moe.moe_block(
            b, x, cfg, mesh=mesh, data_axes=("data",), norm_topk=True))
        y, aux = fn(blk, jnp.asarray(x))
    out[f"{name}/out"] = np.asarray(y)
    out[f"{name}/aux"] = np.asarray(aux)
    # the dense mode, which under a mesh is the mesh-free function
    y, aux = jax.jit(lambda b, x: ref_moe.moe_block(
        b, x, cfg, mesh=None, norm_topk=True, impl="dense"))(
            blk, jnp.asarray(x))
    out[f"{name}/dense_out"] = np.asarray(y)
    out[f"{name}/dense_aux"] = np.asarray(aux)
    D = shape[0]
    rows = C.MOE_B // D
    for j in range(D):     # each data shard's dispatch on its own tokens
        xf = jnp.asarray(x[j * rows:(j + 1) * rows].reshape(-1, cfg.d_model))
        gates, _ = ref_moe.router_probs(xf, blk["router"])
        cap = ref_moe._capacity(xf.shape[0], cfg.top_k, cfg.n_experts,
                                cfg.capacity_factor)
        _, table, wtable = ref_moe._dispatch_local(xf, gates, cfg.top_k, cap,
                                                   True)
        out[f"{name}/table{j}"] = np.asarray(table)
        out[f"{name}/wtable{j}"] = np.asarray(wtable)
        w_top, ids = jax.lax.top_k(gates, cfg.top_k)
        out[f"{name}/aux{j}"] = np.asarray(ref_moe.aux_losses(
            gates, ids, cfg.n_experts))


def run_train(name, out):
    arch, shape, rules, state_dtype = C.TRAIN[name]
    cfg = config(arch)
    mesh = mesh_of(shape)
    rt = Runtime(mesh=mesh, rules=ShardingRules(**rules))
    opt = opt_.OptConfig(state_dtype=state_dtype, **C.OPT)
    params = jax.tree.map(jnp.asarray, params_of(cfg))
    batch = {k: jnp.asarray(v) for k, v in C.train_batch(cfg).items()}
    with mesh:
        grad = jax.jit(jax.grad(lambda p, b: ts.loss_fn(p, cfg, rt, b)[0]))
        m = C.MICRO
        micro = [{k: v.reshape((m, v.shape[0] // m) + v.shape[1:])[j]
                  for k, v in batch.items()} for j in range(m)]
        grads = jax.tree.map(lambda *g: sum(x / m for x in g),
                             *[grad(params, mb) for mb in micro])
        step = jax.jit(ts.make_train_step(cfg, rt, opt, microbatches=m))
        new_p, new_o, metrics = step(params, opt_.init_opt_state(params, opt),
                                     batch)
    for k, v in metrics.items():
        out[f"{name}/metric/{k}"] = np.asarray(v)
    for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[f"{name}/grad/{jax.tree_util.keystr(path)}"] = np.asarray(v)
    for path, v in jax.tree_util.tree_flatten_with_path(new_p)[0]:
        out[f"{name}/param/{jax.tree_util.keystr(path)}"] = np.asarray(v)
    for key in ("m", "v"):
        for path, v in jax.tree_util.tree_flatten_with_path(new_o[key])[0]:
            out[f"{name}/{key}/{jax.tree_util.keystr(path)}"] = np.asarray(v)


def main(path, part):
    """``part`` "forward": the forward cases; "rest": the MoE blocks and
    the train steps (the two halves run as two processes)."""
    out = {}
    if part == "forward":
        for name in C.FORWARD:
            run_forward(name, out)
    else:
        for name in C.MOE:
            run_moe(name, out)
        for name in C.TRAIN:
            run_train(name, out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
