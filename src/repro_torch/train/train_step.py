"""The training step: CE loss with a z-loss and the MoE aux loss,
microbatched gradient accumulation, clipping and AdamW, mixed precision
(``cfg.dtype`` compute on fp32 master weights): the port's
``repro.train.train_step``.

The global batch splits into ``microbatches`` equal parts along its
leading axis; gradients accumulate in ``accum_dtype`` across a Python loop
over them (the reference's ``lax.scan``), so activation memory is one
microbatch's.  Gradients come from ``torch.autograd.grad`` through the
forward, the kernels' own ``autograd.Function``s on the card.

Under ``rt.mesh`` each rank holds its shards of the parameters and state
and takes the whole global batch; each microbatch then splits over the
data axes, as the reference's sharded microbatch does.  The loss is the
global batch's mean (its sums all-reduced over the data axes) and the
cross entropy is vocab-parallel where the head is: the max and the sum of
exponentials taken across the shards.  A gradient leaf that the data axes
replicate is all-reduced over them after each microbatch; an FSDP leaf's
gradient was reduce-scattered into its shard by the backward of its
gather.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models.config import ModelConfig
from ..models.sharding import all_reduce_sum, axes_of, paired, tree_placements
from ..models.transformer import Runtime, forward_local, tensor_parallel
from .optimizer import OptConfig, adamw_update
from .tree import leaves, unflatten

Z_LOSS = 1e-4
AUX_LOSS = 1e-2


def batch_keys(cfg: ModelConfig):
    keys = ["tokens", "labels"]
    if cfg.frontend == "audio_stub":
        keys.append("enc_embeds")
    if cfg.frontend == "vision_stub":
        keys.append("frontend_embeds")
    return keys


def _cross_entropy(logits, labels, cfg: ModelConfig, tp):
    """(lse, gold) a position: the log-sum-exp of its logits and the
    label's logit, across the vocab shards where ``logits`` holds this
    rank's."""
    V = logits.shape[-1]
    if V == cfg.vocab:
        lse = torch.logsumexp(logits, dim=-1)
        # a negative label indexes from the end, as take_along_axis does;
        # its term is masked out
        idx = torch.where(labels < 0, labels + V, labels)
        return lse, torch.gather(logits, -1, idx[..., None])[..., 0]
    m = tp.max_model(logits.detach().amax(-1))
    lse = torch.log(tp.reduce(torch.exp(logits - m[..., None]).sum(-1))) + m
    idx = labels - tp.r * V
    own = ((idx >= 0) & (idx < V)).to(logits.dtype)
    gold = torch.gather(logits, -1, idx.clamp(0, V - 1)[..., None])[..., 0]
    return lse, tp.reduce(gold * own)


def loss_fn(params, cfg: ModelConfig, rt: Runtime, batch: Dict):
    """(loss, {"ce", "aux"}) of a batch: the mean CE over labels >= 0 (a
    negative label is masked), the z-loss ``Z_LOSS * mean(lse^2)`` and
    ``AUX_LOSS`` times the MoE layers' aux loss; with ``frontend_embeds``
    (pixtral's patches) only the text suffix's logits count.  Under a mesh
    ``batch`` is the global batch and the means are over all of it."""
    n_front = batch["frontend_embeds"].shape[1] \
        if "frontend_embeds" in batch else 0
    tp = tensor_parallel(cfg, rt, batch["tokens"].shape[1] + n_front)
    b = {k: tp.split_batch(v) for k, v in batch.items()}
    extras = {}
    if "enc_embeds" in b:
        extras["enc_embeds"] = b["enc_embeds"]
    if "frontend_embeds" in b:
        extras["frontend_embeds"] = b["frontend_embeds"]
    logits, _, aux = forward_local(params, cfg, rt, b["tokens"],
                                   mode="train", tp=tp, **extras)
    if n_front:   # loss only on the text suffix
        logits = logits[:, n_front:]
    logits = logits.to(torch.float32)
    labels = b["labels"].long()
    lse, gold = _cross_entropy(logits, labels, cfg, tp)
    mask = (labels >= 0).to(torch.float32)
    count = mask.sum()
    if tp.n_data > 1:
        count = all_reduce_sum(count, tp.mesh, tp.data)
    denom = torch.clamp_min(count, 1.0)
    ce = tp.reduce_data(torch.sum((lse - gold) * mask)) / denom
    zl = tp.reduce_data(torch.sum(torch.square(lse) * mask)) / denom
    loss = ce + Z_LOSS * zl + AUX_LOSS * aux
    return loss, {"ce": ce, "aux": aux}


def _grads(loss, flat):
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(flat, gs)]


def _data_sync(cfg: ModelConfig, rt: Runtime, params):
    """A function that all-reduces, over the data axes, the gradients (a
    list in ``leaves(params)`` order) of the leaves the data axes
    replicate; the identity without a mesh or a data axis."""
    if rt.mesh is None:
        return lambda gs: gs
    tp = tensor_parallel(cfg, rt)
    if tp.n_data == 1:
        return lambda gs: gs
    data = set(axes_of(rt.data_axes))
    pl = tree_placements(cfg, rt.mesh, rt.rules)
    replicated = [not any(a in data for ax in p for a in axes_of(ax))
                  for _, p in paired(params, pl)]

    def sync(gs):
        return [all_reduce_sum(g, rt.mesh, rt.data_axes) if rep else g
                for g, rep in zip(gs, replicated, strict=True)]
    return sync


def make_grad_step(cfg: ModelConfig, rt: Runtime, microbatches: int = 1,
                   accum_dtype=torch.float32):
    """Returns grad_step(params, batch) -> (grads, loss, parts): the
    gradients (a tree like ``params``: fp32, or ``accum_dtype`` when
    ``microbatches > 1``; under a mesh each leaf's gradient of this rank's
    shard, summed over the data axes), the fp32 loss and ``parts`` (``ce``,
    ``aux``), each a mean over the microbatches."""

    def grad_step(params, batch):
        flat = leaves(params)
        sync = _data_sync(cfg, rt, params)
        for p in flat:
            p.requires_grad_(True)
        if microbatches == 1:
            loss, parts = loss_fn(params, cfg, rt, batch)
            grads = [g.to(torch.float32) for g in sync(_grads(loss, flat))]
            loss = loss.detach()
            parts = {k: v.detach() for k, v in parts.items()}
            return unflatten(params, grads), loss, parts

        def split(x, j):
            m = microbatches
            return x.reshape((m, x.shape[0] // m) + x.shape[1:])[j]

        grads = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                 for p in flat]
        loss = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        sums = None
        for j in range(microbatches):
            mb = {k: split(v, j) for k, v in batch.items()}
            lj, pj = loss_fn(params, cfg, rt, mb)
            for a, g in zip(grads, sync(_grads(lj, flat))):
                a += (g / microbatches).to(a.dtype)
            loss = loss + lj.detach()
            pj = {k: v.detach() for k, v in pj.items()}
            sums = pj if sums is None else {k: sums[k] + pj[k] for k in sums}
        return (unflatten(params, grads), loss / microbatches,
                {k: v / microbatches for k, v in sums.items()})

    return grad_step


def make_train_step(cfg: ModelConfig, rt: Runtime, opt: OptConfig,
                    microbatches: int = 1, accum_dtype=torch.float32):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``params`` and ``opt_state`` updated in place; batch leaves
    are tensors with leading dim == the global batch, on the parameters'
    device.  ``metrics``: fp32 scalar tensors ``loss``, ``ce``, ``aux``,
    ``grad_norm`` and ``lr``.  Under ``rt.mesh`` ``params`` and
    ``opt_state`` are this rank's shards.

    accum_dtype: the gradient accumulator's type when ``microbatches >
    1`` (bf16 halves the dominant persistent buffer)."""
    grad_step = make_grad_step(cfg, rt, microbatches, accum_dtype)
    placements = None if rt.mesh is None else \
        tree_placements(cfg, rt.mesh, rt.rules)

    def train_step(params, opt_state, batch):
        grads, loss, parts = grad_step(params, batch)
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, opt, placements=placements,
            mesh=rt.mesh)
        return params, opt_state, {"loss": loss, **parts, **opt_metrics}

    return train_step
