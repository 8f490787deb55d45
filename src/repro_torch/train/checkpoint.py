"""Atomic, async checkpointing with retention GC: the port's
``repro.train.checkpoint``.

Layout:  <root>/step_<N:010d>/arrays.npz + meta.json, the reference's.  The
leaves go into ``arrays.npz`` as ``leaf_<i>`` in the reference's flatten
order (``train.tree.leaves``: sorted dict keys, so for ``(params,
opt_state)`` the parameters, then the ``m`` leaves, ``step``, the ``v``
leaves, an int8 moment as its ``q`` then ``s``), so a checkpoint written by
either package restores in the other.  ``meta.json`` holds the step, the
leaf count and, as ``"tree"``, the port's own: the name of each leaf
(``train.tree.leaf_names``).  Neither package's ``restore`` reads it: both
check only the count.

Writes go to a temp dir + atomic rename, so a crash mid-save never corrupts
the latest checkpoint; ``restore`` loads the newest complete step.  Async
mode copies the state to the host, then hands it to a writer thread, so
the train loop never waits on the disk and may go on updating its tensors
in place.

Over a mesh (``CheckpointManager(mesh=)``, the leaves each rank's shards
laid out by ``placements``) every rank calls ``save``: the shards are
gathered and rank 0 writes the files above, unchanged, so a checkpoint of
a sharded run restores whole, in either package.  ``restore`` reads the
whole leaves on every rank and keeps each rank's shard.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..models.sharding import gather_tree, local_slice, paired
from .tree import leaf_names, leaves, unflatten


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, async_save: bool = True,
                 mesh=None):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self.mesh = mesh
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    def _writes(self) -> bool:
        import torch.distributed as dist
        return self.mesh is None or dist.get_rank() == 0

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, placements=None) -> None:
        """Write ``state`` as step ``step``; over the mesh, ``placements``
        (a tree like ``state``) lays out its shards, and every rank
        calls."""
        if placements is not None:
            state = gather_tree(state, placements, self.mesh)
        if not self._writes():
            return
        # device -> host copies happen here, so the caller can keep training
        host = [x.detach().to("cpu", copy=True).numpy() for x in
                leaves(state)]
        names = leaf_names(state)
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, names))
            self._thread.start()
        else:
            self._write(step, host, names)

    def _write(self, step: int, host, names) -> None:
        final = os.path.join(self.root, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(host)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "n_leaves": len(host),
                       "tree": names}, f)
        if os.path.exists(final):    # re-save of the same step
            shutil.rmtree(final)
        os.replace(tmp, final)       # atomic: readers never see partial state
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:010d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.root)):
            if name.startswith("step_") and not name.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.root, name, "meta.json")):
                out.append(int(name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, step: Optional[int] = None,
                placements=None) -> Tuple[int, Any]:
        """Restore into the structure of ``like`` (a tree of tensors): each
        leaf a new tensor of ``like``'s leaf's shape and dtype on its
        device.  With ``placements`` the leaves of ``like`` are this rank's
        shards over the mesh, and each gets its slice of the whole leaf."""
        step = self.latest_step() if step is None else step
        assert step is not None, "no checkpoint found"
        path = os.path.join(self.root, f"step_{step:010d}")
        data = np.load(os.path.join(path, "arrays.npz"))
        flat = leaves(like)
        pls = [p for _, p in paired(like, placements)] \
            if placements is not None else [()] * len(flat)
        assert len(data.files) == len(flat), "checkpoint/tree mismatch"
        out = []
        for i, (x, pl) in enumerate(zip(flat, pls)):
            a = torch.from_numpy(np.array(data[f"leaf_{i}"]))
            if pl:
                a = local_slice(a, pl, self.mesh).contiguous()
            if tuple(a.shape) != tuple(x.shape) or a.dtype != x.dtype:
                raise ValueError(f"leaf {i}: checkpoint {a.dtype} "
                                 f"{tuple(a.shape)}, the tree wants "
                                 f"{x.dtype} {tuple(x.shape)}")
            out.append(a.to(x.device))
        return step, unflatten(like, out)
