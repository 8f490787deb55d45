"""Meshes of ranks: the port's ``repro.launch.mesh``.

Single pod: (16, 16) = 256 ranks, axes ("data", "model").  Multi-pod:
(2, 16, 16) = 512 ranks, axes ("pod", "data", "model"); the "pod" axis is
pure data parallelism, so only the gradient all-reduce crosses pods.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, one process a rank.  ``join`` brings a process into the
group: on the card the backend is NCCL unless the caller asks for gloo, on
the CPU it is gloo, and rank ``r`` takes card ``r % torch.cuda.device_count()``.
NCCL refuses two ranks on one card, so ``join`` refuses that request
itself, with a message; it never swaps in gloo.  Nothing here runs when
the module is imported.
"""
from __future__ import annotations

import datetime
import os
import tempfile
from typing import Optional, Tuple

import torch
import torch.distributed as dist

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


def data_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def ranks_per_host(world: int) -> int:
    """Ranks that share this host's cards: ``LOCAL_WORLD_SIZE`` where a
    launcher such as ``torchrun`` sets it, else the whole world."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def join(rank: int, world: int, init_method: str, *,
         backend: Optional[str] = None, device: str = "cuda",
         timeout: Optional[float] = None) -> str:
    """Bring this process into the default process group as ``rank`` of
    ``world`` (``init_method`` a ``file://`` or ``tcp://localhost:<port>``
    address).  ``backend`` None: NCCL on the card, gloo on the CPU.
    ``timeout``: seconds a collective may wait for the other ranks (None:
    torch's default).  Returns the backend."""
    if device == "cpu":
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} on the CPU: the CPU "
                             "ranks run over gloo")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "ranks on the CPU")
        backend = backend or "nccl"
        n = torch.cuda.device_count()
        if backend == "nccl" and ranks_per_host(world) > n:
            raise ValueError(
                f"NCCL refuses two ranks on one card: {ranks_per_host(world)}"
                f" ranks on this host's {n} card(s); pass backend='gloo' to "
                "share a card")
        torch.cuda.set_device(rank % n)
    kw = {} if timeout is None else {"timeout": datetime.timedelta(
        seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kw)
    return backend


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    group, whose world must be the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        world = dist.get_world_size() if dist.is_initialized() else 0
        raise ValueError(f"a mesh of {tuple(shape)} needs a group of {n} "
                         f"ranks; the default group has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def one_rank_group() -> None:
    """A default group of this process alone: gloo over a file store in a
    new temporary directory (no collective crosses it)."""
    store = tempfile.mkdtemp(prefix="repro_torch_pg_")
    dist.init_process_group("gloo", init_method=f"file://{store}/pg",
                            rank=0, world_size=1)


def make_host_mesh(device: str = "cuda"):
    """Every rank of the default group as a (data=N, model=1) mesh.  With
    no group yet, ``one_rank_group`` brings one up (the caller may destroy
    it)."""
    if not dist.is_initialized():
        if device != "cpu" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu'")
        one_rank_group()
    return make_mesh((dist.get_world_size(), 1), ("data", "model"),
                     "cpu" if device == "cpu" else "cuda")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise ValueError(f"the production mesh {shape} needs {n} ranks; "
                         f"the default group has {world}")
    return make_mesh(shape, axes, device_type)
