"""Logical-axis -> mesh-axis rules, placement trees, and the collectives
the sharded model runs: the port's ``repro.models.sharding``.

Mesh axes: ("data", "model") on one pod, ("pod", "data", "model") across
pods.  The batch shards over the data axes (``rules.data_axes``).  Tensor
parallelism maps the logical axes heads / kv_heads / mlp / vocab / expert
onto "model".  FSDP also shards the "embed" axis of the weights over
"data" (ZeRO-3: parameters, gradients and optimizer state all inherit
it).  Sequence parallelism shards the residual stream's sequence over
"model" between blocks.

A *placement* is one entry per dim of a leaf: None (whole on every rank),
a mesh axis name, or a tuple of names, the reference's PartitionSpec
entries.  ``tree_placements`` is the counterpart of ``tree_pspecs``, leaf
for leaf, and reads only the axis sizes of its mesh (a
``torch.distributed.device_mesh.DeviceMesh``, a plain mapping of sizes, or
anything whose ``.shape`` is one).  A rank's *local shard* of a leaf is the
contiguous slice of each placed dim at the rank's coordinate on that axis
(row-major over a tuple of axes); ``shard_tree`` cuts full trees into local
shards and ``gather_tree`` puts them back together.

The model computes on local shards Megatron-style, with explicit
collectives over the process groups of a ``DeviceMesh``
(``mesh.get_group(axis)``), not DTensor: the hand-written kernels take
plain tensors.  ``TensorParallel`` holds one call's mesh and plan and the
conjugate operators, each an autograd Function:

- ``enter`` (identity forward, all-reduce over "model" backward) on a
  replicated tensor that the ranks go on to use in different ways (a
  column-parallel product, a slice of the experts or of a norm's scale);
- ``reduce`` (all-reduce forward, identity backward) on partial sums (a
  row-parallel product, the experts' combine, a vocab-parallel lookup);
  ``enter(reduce(.))`` on a partial sum that each rank then uses on its
  own columns (the SSD norm's sum of squares over the heads);
- ``gather`` of a sharded weight before use: over the data axes (FSDP),
  with a reduce-scatter of its gradient; over "model" where the ranks then
  compute alike (a leaf of ``heads`` whose shard does not hold whole
  heads), with the gradient's local slice;
- ``seq_gather`` / ``seq_split`` of the residual stream under sequence
  parallelism (a split after a ``reduce``: each block's output is
  all-reduced, then the rank keeps its slice of the sequence);
- ``shard0``: the MoE aux loss of data shard 0 on every rank (see
  ``models.moe``).

Collectives used: ``all_reduce`` (SUM and MAX), ``all_gather`` into a list
of tensors, ``reduce_scatter_tensor`` and ``broadcast``.  gloo provides
them on CPU tensors and, as checked on the H100 with torch 2.11, on CUDA
tensors, fp32 and bf16; NCCL provides them.  A collective over an axis of
size 1 is skipped, so a (1, 1) mesh issues none.
"""
from __future__ import annotations

import dataclasses
import functools
from collections.abc import Mapping
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from . import params as P_
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    fsdp: bool = False            # shard "embed" weight axis over data
    expert_parallel: bool = True  # shard "expert" over model when divisible
    seq_parallel: bool = False    # shard activation seq dim over model
    data_axes: Tuple[str, ...] = ("data",)   # ("pod","data") multi-pod
    # FSDP of the embedding and head tables: for training; in serving the
    # token gather cannot shard batch and d over the same axis
    fsdp_vocab_tables: bool = True

    def table(self, cfg: ModelConfig, mesh) -> Dict[Optional[str], object]:
        model_n = axis_sizes(mesh)["model"]
        ep_ok = (self.expert_parallel and cfg.n_experts > 0
                 and cfg.n_experts % model_n == 0)
        return {
            "vocab": "model",
            "heads": "model",
            # a ragged kv-head shard would take partial sums across
            # ranks: replicate unless the kv heads divide the model axis
            "kv_heads": "model" if cfg.n_kv_heads % model_n == 0 else None,
            "mlp": None if ep_ok else "model",
            "expert": "model" if ep_ok else None,
            "embed": ("data",) if self.fsdp else None,  # never across pods
            "kv_lora": None,
            "layers": None,
            None: None,
        }


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, of a plain mapping, or of an
    object whose ``.shape`` is a mapping (the reference's ``Mesh``)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def axes_of(ax) -> Tuple[str, ...]:
    """The mesh axes of a placement entry: () for None, a tuple of one
    for a name, the tuple itself."""
    if ax is None:
        return ()
    return tuple(ax) if isinstance(ax, tuple) else (ax,)


def _size(sizes: Dict[str, int], ax) -> int:
    n = 1
    for a in axes_of(ax):
        n *= sizes[a]
    return n


def tree_placements(cfg: ModelConfig, mesh, rules: ShardingRules) -> Dict:
    """A placement (a tuple, one entry a dim) for every leaf of the
    parameter tree.  A dim is placed on its rule's mesh axis only if that
    axis's size divides it (an odd vocab such as 49155 stays whole) and no
    earlier dim of the leaf took the axis."""
    return _placements(cfg, tuple(sorted(axis_sizes(mesh).items())), rules)


@functools.lru_cache(maxsize=None)
def _placements(cfg, sizes, rules) -> Dict:
    sizes = dict(sizes)
    table = rules.table(cfg, sizes)

    def leaf(meta: P_.ParamMeta, n):
        shape = ((n,) + meta.shape) if n else meta.shape
        axes = (("layers",) + meta.axes) if n else meta.axes
        out, seen = [], set()
        vocab_table = "vocab" in axes
        for dim, ax in zip(shape, axes):
            mesh_ax = table.get(ax)
            if ax == "embed" and vocab_table and not rules.fsdp_vocab_tables:
                mesh_ax = None
            flat = axes_of(mesh_ax)
            if (mesh_ax is None or any(a in seen for a in flat)
                    or dim % _size(sizes, mesh_ax) != 0):
                out.append(None)
            else:   # a tuple of one axis is that axis, as in a PartitionSpec
                out.append(flat[0] if len(flat) == 1 else mesh_ax)
                seen.update(flat)
        return tuple(out)

    return P_._finalize(cfg, leaf)


def local_shape(shape, placement, mesh) -> Tuple[int, ...]:
    """The shape of a rank's shard of a leaf of ``shape``."""
    sizes = axis_sizes(mesh)
    return tuple(n // _size(sizes, ax) for n, ax in zip(shape, placement))


def paired(tree, placements):
    """(leaf, placement) pairs in ``train.tree.leaves`` order: the walk
    follows ``tree``'s dicts, tuples and lists, so a placement (itself a
    tuple) is taken whole."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paired(tree[k],
                                                       placements[k])]
    if isinstance(tree, (tuple, list)):
        return [p for t, pl in zip(tree, placements, strict=True)
                for p in paired(t, pl)]
    return [(tree, placements)]


# ------------------------------------------------------------ rank geometry

def _axis_size(mesh, a: str) -> int:
    return axis_sizes(mesh)[a]


def coord(mesh, ax) -> Tuple[int, int]:
    """(this rank's index, the number of shards) along ``ax``, a mesh axis
    or a tuple of axes (row-major)."""
    idx, n = 0, 1
    for a in axes_of(ax):
        k = _axis_size(mesh, a)
        idx = idx * k + (mesh.get_local_rank(a) if k > 1 else 0)
        n *= k
    return idx, n


def _narrow(x: torch.Tensor, dim: int, mesh, ax) -> torch.Tensor:
    i, n = coord(mesh, ax)
    if n == 1:
        return x
    step = x.shape[dim] // n
    return x.narrow(dim, i * step, step)


def local_slice(x: torch.Tensor, placement, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``x`` (a view)."""
    for dim, ax in enumerate(placement):
        x = _narrow(x, dim, mesh, ax)
    return x


def _all_reduce(x: torch.Tensor, mesh, ax, op=dist.ReduceOp.SUM):
    """``x`` all-reduced in place over each axis of ``ax`` in turn."""
    for a in axes_of(ax):
        if _axis_size(mesh, a) > 1:
            dist.all_reduce(x, op=op, group=mesh.get_group(a))
    return x


def _all_gather(x: torch.Tensor, dim: int, mesh, ax) -> torch.Tensor:
    """The shards of ``x`` along ``ax`` concatenated on ``dim``, the
    innermost axis first (row-major over a tuple of axes)."""
    x = x.contiguous()
    for a in reversed(axes_of(ax)):
        n = _axis_size(mesh, a)
        if n > 1:
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=mesh.get_group(a))
            x = torch.cat(parts, dim)
    return x


def _reduce_scatter(x: torch.Tensor, dim: int, mesh, ax) -> torch.Tensor:
    """``x`` summed over the ranks of ``ax``, this rank's slice of it along
    ``dim`` (the outermost axis first: row-major over a tuple of axes)."""
    for a in axes_of(ax):
        n = _axis_size(mesh, a)
        if n > 1:
            xt = x.movedim(dim, 0).contiguous()
            out = xt.new_empty((xt.shape[0] // n,) + xt.shape[1:])
            dist.reduce_scatter_tensor(out, xt, group=mesh.get_group(a))
            x = out.movedim(0, dim)
    return x.contiguous()


def shard_tree(tree, placements, mesh):
    """Local shards (contiguous copies) of a tree of full tensors."""
    def walk(t, pl):
        if isinstance(t, dict):
            return {k: walk(t[k], pl[k]) for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(a, b) for a, b in zip(t, pl, strict=True))
        return local_slice(t, pl, mesh).contiguous().clone()
    return walk(tree, placements)


@torch.no_grad()
def gather_tree(tree, placements, mesh):
    """Full tensors from every rank's local shards (a collective: every
    rank calls it and gets the whole tree)."""
    def walk(t, pl):
        if isinstance(t, dict):
            return {k: walk(t[k], pl[k]) for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(a, b) for a, b in zip(t, pl, strict=True))
        for dim, ax in enumerate(pl):
            if ax is not None:
                t = _all_gather(t, dim, mesh, ax)
        return t
    return walk(tree, placements)


def all_reduce_sum(x: torch.Tensor, mesh, ax) -> torch.Tensor:
    """``x`` summed over the ranks of ``ax`` (a new tensor; no autograd)."""
    return _all_reduce(x.detach().clone(), mesh, ax)


def all_reduce_max(x: torch.Tensor, mesh, ax) -> torch.Tensor:
    """The elementwise max over the ranks of ``ax`` (a new tensor)."""
    return _all_reduce(x.detach().clone(), mesh, ax, dist.ReduceOp.MAX)


# ------------------------------------------------- autograd collectives

class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, ax):
        ctx.mesh, ctx.ax = mesh, ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.mesh, ctx.ax), \
            None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, ax):
        return _all_reduce(x.contiguous().clone(), mesh, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the gradient's local slice, summed over
    the ranks first where ``sum_grad`` (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, mesh, ax, sum_grad):
        ctx.args = (dim, mesh, ax, sum_grad)
        return _all_gather(x, dim, mesh, ax)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, ax, sum_grad = ctx.args
        g = _reduce_scatter(g, dim, mesh, ax) if sum_grad else \
            _narrow(g, dim, mesh, ax).contiguous()
        return g, None, None, None, None


class _Split(torch.autograd.Function):
    """This rank's slice along ``dim``; the gradient all-gathered."""

    @staticmethod
    def forward(ctx, x, dim, mesh, ax):
        ctx.args = (dim, mesh, ax)
        return _narrow(x, dim, mesh, ax).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, mesh, ax = ctx.args
        return _all_gather(g, dim, mesh, ax), None, None, None


class _Shard0(torch.autograd.Function):
    """Data shard 0's value on every rank; each rank's gradient divided
    by the shard count (the mean of the shards' gradients once summed)."""

    @staticmethod
    def forward(ctx, x, mesh, ax):
        _, n = coord(mesh, ax)
        ctx.n = n
        x = x.contiguous().clone()
        for a in axes_of(ax):
            if _axis_size(mesh, a) > 1:
                group = mesh.get_group(a)
                dist.broadcast(x, src=dist.get_global_rank(group, 0),
                               group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _model_local(cfg: ModelConfig, model_n: int) -> frozenset:
    """The logical axes whose model shards a block computes on: all but
    ``heads`` where a shard would hold part of a head."""
    axes = {"vocab", "mlp", "expert", "kv_heads"}
    if cfg.n_heads % model_n == 0:
        axes.add("heads")
    return frozenset(axes)


_logical_axes = functools.lru_cache(maxsize=None)(P_.logical_axes)


class TensorParallel:
    """One forward call's mesh, plan and conjugate operators.  With no mesh
    (``LOCAL``) every operator is the identity."""

    def __init__(self, cfg: Optional[ModelConfig] = None, mesh=None,
                 rules: Optional[ShardingRules] = None, seq: int = 0):
        self.mesh = mesh
        self.rules = rules or ShardingRules()
        sizes = axis_sizes(mesh) if mesh is not None else {}
        self.m = sizes.get("model", 1)
        self.r = coord(mesh, "model")[0] if self.m > 1 else 0
        self.data = self.rules.data_axes
        self.n_data = _size(sizes, self.data) if mesh is not None else 1
        # sequence parallelism where the call's sequence splits evenly
        self.sp = (self.rules.seq_parallel and self.m > 1 and seq > 1
                   and seq % self.m == 0)
        self.pl = tree_placements(cfg, mesh, self.rules) \
            if mesh is not None else None
        self.axes = _logical_axes(cfg) if mesh is not None else None
        self.local_axes = _model_local(cfg, self.m) if self.m > 1 \
            else frozenset()
        # the layer leaves the blocks take as model shards (a name means
        # the same leaf in every stack: whisper's encoder and decoder
        # attention and MLP leaves share their names and placements)
        self.kept_names = frozenset(
            name for stack in ("layers", "dense_layers", "enc_layers")
            if self.m > 1 and stack in self.pl
            for name, pl in self.pl[stack].items()
            if any(ax == "model" and lg in self.local_axes
                   for ax, lg in zip(pl, self.axes[stack][name])))

    def kept(self, name: str) -> bool:
        """Whether the layers' leaf ``name`` reaches its block as a model
        shard."""
        return name in self.kept_names

    @property
    def on(self) -> bool:
        return self.mesh is not None

    # -- weights
    def weight(self, w: torch.Tensor, stack: str, name: Optional[str] = None,
               drop: int = 0) -> torch.Tensor:
        """The leaf ``stack[name]`` (or the top-level leaf ``stack``) as its
        block computes on it: its data-placed dims gathered (FSDP), and
        its model-placed dims gathered unless the block computes on their
        shards.  ``drop``: leading dims of the stored leaf ``w`` no longer
        has (1 for a layer slice of a stack)."""
        if self.pl is None:
            return w
        pl = self.pl[stack] if name is None else self.pl[stack][name]
        axes = self.axes[stack] if name is None else self.axes[stack][name]
        for dim, (ax, logical) in enumerate(zip(pl[drop:], axes[drop:])):
            if ax is None:
                continue
            if ax == "model":
                if logical not in self.local_axes:
                    w = _Gather.apply(w, dim, self.mesh, ax, False)
            else:
                w = _Gather.apply(w, dim, self.mesh, ax, True)
        return w

    # -- activations
    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.mesh, "model") if self.m > 1 else x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.mesh, "model") if self.m > 1 else x

    def seq_gather(self, x: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(x, 1, self.mesh, "model", False) if self.sp \
            else x

    def seq_split(self, x: torch.Tensor) -> torch.Tensor:
        return _Split.apply(x, 1, self.mesh, "model") if self.sp else x

    def gather(self, x: torch.Tensor, dim: int, ax) -> torch.Tensor:
        """``x``'s shards along ``ax`` put together on ``dim`` for every
        rank, the gradient's local slice."""
        if self.mesh is None or coord(self.mesh, ax)[1] == 1:
            return x
        return _Gather.apply(x, dim, self.mesh, ax, False)

    def split_batch(self, x):
        """This rank's rows of a global batch (None stays None)."""
        if x is None or self.n_data == 1:
            return x
        return _narrow(x, 0, self.mesh, self.data)

    def reduce_data(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.mesh, self.data) if self.n_data > 1 \
            else x

    def shard0(self, x: torch.Tensor) -> torch.Tensor:
        return _Shard0.apply(x, self.mesh, self.data) if self.n_data > 1 \
            else x

    def max_model(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_max(x, self.mesh, "model") if self.m > 1 else x


LOCAL = TensorParallel()
