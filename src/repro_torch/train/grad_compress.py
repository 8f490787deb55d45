"""int8 error-feedback gradient compression for the data-parallel ("pod")
ranks: the port's ``repro.train.grad_compress``.

Each leaf of the rank-local gradient, plus the error carried from the last
step, is quantized with per-row absmax scales; the dequantized values are
all-reduced over the ranks of a ``torch.distributed`` process group and
averaged, and the quantization error is fed back into the next step's
gradient (error feedback keeps convergence).

What crosses the wire is what the reference's ``psum`` reduces: the
dequantized float32 values, not the int8 payload with its scales.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels.attention import inv_f32
# per-row absmax int8 quantization, rounded as the reference's traced
# ``_quant`` (``absmax / 127.0`` taken as ``absmax * inv_f32(127)``, XLA's
# rewrite of a division by a constant): the optimizer's, as in the reference
from .optimizer import _quant
from .tree import leaves, unflatten


def compress_allreduce(grads, errors, group=None, mesh=None):
    """All-reduce ``grads`` over ``group`` (the default group when None),
    or over the "pod" axis of ``mesh`` (a ("pod", "data", "model")
    ``DeviceMesh``, as the reference's ``compress_psum_pod`` reduces over
    "pod" only), with int8 error feedback.

    ``grads`` / ``errors``: trees (``train.tree``) of tensors of the same
    structure, the errors float32, carried in the train state and zeros at
    the start.  Returns (the reduced grads, each in its gradient's dtype;
    the new errors)."""
    if mesh is not None:
        group = mesh.get_group("pod")
    world = dist.get_world_size(group)
    inv = inv_f32(world)    # the reference's jitted ``psum / npod``

    red, new_err = [], []
    for g, e in zip(leaves(grads), leaves(errors), strict=True):
        x = g.to(torch.float32) + e
        q, s = _quant(x)
        deq = q.to(torch.float32) * s
        # the reference's traced ``x - deq`` rounds once: XLA contracts the
        # product into the subtraction (an FMA).  In float64 the product is
        # exact (7 x 24 bits) and so is the difference (deq is within a
        # scale of x), so one rounding to float32 gives the FMA's result.
        new_err.append((x.double() - q.double() * s.double()).float())
        dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
        red.append((deq * inv).to(g.dtype))
    return unflatten(grads, red), unflatten(errors, new_err)
