"""The training step: CE loss with a z-loss and the MoE aux loss,
microbatched gradient accumulation, clipping and AdamW, mixed precision
(``cfg.dtype`` compute on fp32 master weights): the port's
``repro.train.train_step``.

The global batch splits into ``microbatches`` equal parts along its
leading axis; gradients accumulate in ``accum_dtype`` across a Python loop
over them (the reference's ``lax.scan``), so activation memory is one
microbatch's.  Gradients come from ``torch.autograd.grad`` through the
forward, the kernels' own ``autograd.Function``s on the card.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models.config import ModelConfig
from ..models.transformer import Runtime, forward
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


def loss_fn(params, cfg: ModelConfig, rt: Runtime, batch: Dict):
    """(loss, {"ce", "aux"}) of a batch: the mean CE over labels >= 0 (a
    negative label is masked), the z-loss ``Z_LOSS * mean(lse^2)`` and
    ``AUX_LOSS`` times the MoE layers' aux loss; with ``frontend_embeds``
    (pixtral's patches) only the text suffix's logits count."""
    extras = {}
    if "enc_embeds" in batch:
        extras["enc_embeds"] = batch["enc_embeds"]
    if "frontend_embeds" in batch:
        extras["frontend_embeds"] = batch["frontend_embeds"]
    logits, _, aux = forward(params, cfg, rt, batch["tokens"], mode="train",
                             **extras)
    if "frontend_embeds" in batch:   # loss only on the text suffix
        logits = logits[:, batch["frontend_embeds"].shape[1]:]
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    labels = batch["labels"].long()
    # a negative label indexes from the end, as take_along_axis does; its
    # term is masked out
    idx = torch.where(labels < 0, labels + logits.shape[-1], labels)
    gold = torch.gather(logits, -1, idx[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    denom = torch.clamp_min(mask.sum(), 1.0)
    ce = torch.sum((lse - gold) * mask) / denom
    zl = torch.sum(torch.square(lse) * mask) / denom
    loss = ce + Z_LOSS * zl + AUX_LOSS * aux
    return loss, {"ce": ce, "aux": aux}


def _grads(loss, flat):
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(flat, gs)]


def make_train_step(cfg: ModelConfig, rt: Runtime, opt: OptConfig,
                    microbatches: int = 1, accum_dtype=torch.float32):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``params`` and ``opt_state`` updated in place; batch leaves
    are tensors with leading dim == the global batch, on the parameters'
    device.  ``metrics``: fp32 scalar tensors ``loss``, ``ce``, ``aux``,
    ``grad_norm`` and ``lr``.

    accum_dtype: the gradient accumulator's type when ``microbatches >
    1`` (bf16 halves the dominant persistent buffer)."""

    def train_step(params, opt_state, batch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        if microbatches == 1:
            loss, parts = loss_fn(params, cfg, rt, batch)
            grads = [g.to(torch.float32) for g in _grads(loss, flat)]
            loss = loss.detach()
            parts = {k: v.detach() for k, v in parts.items()}
        else:
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
                for a, g in zip(grads, _grads(lj, flat)):
                    a += (g / microbatches).to(a.dtype)
                loss = loss + lj.detach()
                pj = {k: v.detach() for k, v in pj.items()}
                sums = pj if sums is None else \
                    {k: sums[k] + pj[k] for k in sums}
            loss = loss / microbatches
            parts = {k: v / microbatches for k, v in sums.items()}
        params, opt_state, opt_metrics = adamw_update(
            params, unflatten(params, grads), opt_state, opt)
        return params, opt_state, {"loss": loss, **parts, **opt_metrics}

    return train_step
