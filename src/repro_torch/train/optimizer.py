"""AdamW with optionally int8-quantized moments (per-row absmax scales): the
port's ``repro.train.optimizer`` (``OptConfig``, ``schedule``, ``_quant``,
``_dequant``, ``init_opt_state``, ``global_norm``, ``adamw_update``), and
``opt_state_from_reference``, which carries the reference's state across.

The 8-bit option cuts the optimizer state from 8 to 2 bytes a parameter;
``_quant`` is the KV cache's ``kernels.attention.quant_kv``, the
reference's two quantizers being one function.  A division by a constant
is a product with its fp32 reciprocal (``_inv``, ``inv_f32``), as the
reference's jitted step computes it.
The reference's arithmetic is kept in fp32 tensors: the warm-up and cosine
terms, ``b1 ** step`` and the bias corrections are never Python floats, so
the learning rate and the update round as the reference's do.  The
gradient norm sums over the leaves in the reference's order (sorted dict
keys, ``train.tree.leaves``).

The update runs in place on the parameters and the state (the reference
donates their buffers to its jitted step), a layer-stacked leaf one layer
at a time, so its fp32 transients are one layer's, as the reference's
``lax.map`` over the stack axis bounds them.

Under a mesh the leaves are this rank's shards (``placements``, from
``models.sharding.tree_placements``): AdamW is elementwise; the gradient
norm sums every shard once (each leaf's squares all-reduced over the axes
that shard it, a replicated leaf counted once); an int8 moment's per-row
absmax spans the shards of its last dim (an all-reduce max over the axis
that shards it), as the reference's scale, placed ``(*spec[:-1], None)``,
does.  ``opt_state_placements`` is the reference's ``opt_state_pspecs``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

from ..kernels.attention import inv_f32 as _inv
from ..kernels.attention import quant_kv as _quant
from ..models.sharding import all_reduce_max, all_reduce_sum, axes_of, \
    axis_sizes, paired
from .tree import leaves


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"      # float32 | int8
    warmup_steps: int = 100
    total_steps: int = 10000


def schedule(opt: OptConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay at ``step`` (an int32 tensor or an
    int), an fp32 scalar tensor."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp_max(step * _inv(max(opt.warmup_steps, 1)), 1.0)
    frac = torch.clamp((step - opt.warmup_steps)
                       * _inv(max(opt.total_steps - opt.warmup_steps, 1)),
                       0.0, 1.0)
    return opt.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))


# ---------------------------------------------------------- int8 quantization

def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _zeros_state(p: torch.Tensor, opt: OptConfig):
    if opt.state_dtype == "int8":
        return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                "s": torch.zeros(p.shape[:-1] + (1,), dtype=torch.float32,
                                 device=p.device)}
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _state_tree(params, opt: OptConfig):
    if isinstance(params, dict):
        return {k: _state_tree(v, opt) for k, v in params.items()}
    return _zeros_state(params, opt)


def init_opt_state(params, opt: OptConfig) -> Dict[str, Any]:
    """Zero moments shaped like ``params`` (fp32, or int8 ``q`` with fp32
    per-row scales ``s``) on the parameters' device, and the step, an int32
    scalar."""
    dev = leaves(params)[0].device
    return {"m": _state_tree(params, opt), "v": _state_tree(params, opt),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_from_reference(tree, params) -> Dict[str, Any]:
    """The JAX package's AdamW state (``init_opt_state`` / ``adamw_update``
    output, leaves as numpy arrays: fp32 moments or int8 ``q`` with fp32
    ``s``, an int32 ``step``) as the port's, on the device of ``params``
    (the port's tree it belongs to, e.g. from ``params_from_reference``).
    Keys, shapes or dtypes that do not fit ``params`` raise."""
    dev = leaves(params)[0].device

    def leaf(a, shape, dtype):
        t = torch.from_numpy(np.array(a))
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"reference state leaf {t.dtype} "
                             f"{tuple(t.shape)}, want {dtype} {tuple(shape)}")
        return t.to(dev)

    def moment(m, p):
        if isinstance(p, dict):
            if set(m) != set(p):
                raise ValueError(f"reference state keys {sorted(m)}, the "
                                 f"parameters' {sorted(p)}")
            return {k: moment(m[k], p[k]) for k in p}
        if isinstance(m, dict):
            if set(m) != {"q", "s"}:
                raise ValueError(f"an int8 moment has keys {sorted(m)}")
            return {"q": leaf(m["q"], p.shape, torch.int8),
                    "s": leaf(m["s"], p.shape[:-1] + (1,), torch.float32)}
        return leaf(m, p.shape, torch.float32)

    return {"m": moment(tree["m"], params), "v": moment(tree["v"], params),
            "step": leaf(tree["step"], (), torch.int32)}


def global_norm(tree, placements=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, each leaf summed whole and
    the leaves added in the reference's leaf order, as the reference
    does.  With ``placements`` (the leaves this rank's shards over
    ``mesh``) the leaves sharded over the same axes are summed together
    and all-reduced over those axes once."""
    pairs = paired(tree, placements) if placements is not None else \
        [(x, ()) for x in leaves(tree)]
    sizes = axis_sizes(mesh) if mesh is not None else {}
    groups = {}
    for x, pl in pairs:
        sq = torch.sum(torch.square(x.to(torch.float32)))
        axes = tuple(sorted({a for ax in pl for a in axes_of(ax)
                             if sizes.get(a, 1) > 1}))
        groups[axes] = sq if axes not in groups else groups[axes] + sq
    total = None
    for axes, sq in groups.items():
        if axes:
            sq = all_reduce_sum(sq, mesh, axes)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _read(s, opt: OptConfig) -> torch.Tensor:
    return _dequant(s["q"], s["s"]) if opt.state_dtype == "int8" else s


def _write(dst, x: torch.Tensor, opt: OptConfig, mesh=None, ax=None) -> None:
    """``x`` into the moment ``dst``; int8 rows take their absmax over the
    shards of the last dim along ``ax`` (the axis that shards it)."""
    if opt.state_dtype == "int8":
        q, s = _quant(x, None if ax is None else
                      lambda a: all_reduce_max(a, mesh, ax))
        dst["q"].copy_(q)
        dst["s"].copy_(s)
    else:
        dst.copy_(x)


def _index(s, i: int):
    return {k: v[i] for k, v in s.items()} if isinstance(s, dict) else s[i]


def _update(p, g, m, v, opt: OptConfig, clip, lr, bc1, bc2,
            decay: float, mesh=None, ax=None) -> None:
    g = g.to(torch.float32) * clip
    m32, v32 = _read(m, opt), _read(v, opt)
    m32 = opt.b1 * m32 + (1 - opt.b1) * g
    v32 = opt.b2 * v32 + (1 - opt.b2) * g * g
    upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + opt.eps)
    p32 = p.to(torch.float32)
    new_p = p32 - lr * (upd + decay * p32)
    p.copy_(new_p.to(p.dtype))
    _write(m, m32, opt, mesh, ax)
    _write(v, v32, opt, mesh, ax)


def _walk(p, g, m, v, pl, fn) -> None:
    if isinstance(p, dict):
        for k in sorted(p):
            _walk(p[k], g[k], m[k], v[k], None if pl is None else pl[k], fn)
    else:
        fn(p, g, m, v, pl)


@torch.no_grad()
def adamw_update(params, grads, state, opt: OptConfig, placements=None,
                 mesh=None):
    """One AdamW step, in place on ``params`` and ``state``.  Returns
    (params, state, metrics), the same objects updated, as the reference
    returns its new ones; ``metrics`` holds the fp32 ``grad_norm`` and
    ``lr``.  With ``placements`` and ``mesh``, the leaves are this rank's
    shards (see the module's docstring)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, placements, mesh)
    clip = torch.clamp_max(opt.grad_clip / (gnorm + 1e-9), 1.0)
    lr = schedule(opt, step).to(gnorm.device)
    step_f = step.to(torch.float32)
    bc1 = 1.0 - opt.b1 ** step_f
    bc2 = 1.0 - opt.b2 ** step_f

    def leaf(p, g, m, v, pl):
        decay = opt.weight_decay if p.dim() >= 2 else 0.0
        ax = pl[-1] if pl and mesh is not None else None   # the last dim's
        if p.dim() >= 3:
            # layer-stacked weights: one layer's fp32 transients at a time
            for i in range(p.shape[0]):
                _update(p[i], g[i], _index(m, i), _index(v, i), opt, clip,
                        lr, bc1, bc2, decay, mesh, ax)
        else:
            _update(p, g, m, v, opt, clip, lr, bc1, bc2, decay, mesh, ax)

    _walk(params, grads, state["m"], state["v"], placements, leaf)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def opt_state_placements(param_placements, opt: OptConfig):
    """Optimizer-state placements mirroring the parameters': the
    reference's ``opt_state_pspecs`` (an int8 moment's per-row scale whole
    along the last dim)."""
    def leaf(pl):
        if opt.state_dtype == "int8":
            return {"q": pl, "s": tuple(pl[:-1]) + (None,) if pl else pl}
        return pl

    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) \
            else leaf(t)
    return {"m": walk(param_placements), "v": walk(param_placements),
            "step": ()}
