"""Wrappers that launch the port's hand-written kernels.

A wrapper takes its kernel's plain PyTorch version only because the tensors
it was given lie on the CPU.  For CUDA tensors it launches the kernel or
raises; there is no fallback.  Each launch adds one to ``launches`` under
the kernel's name, so a run can show that it went through the kernel.
"""
from __future__ import annotations

import collections

import torch

from .fitscore import DPAD, policy_code, select_ref

# kernel name -> launches since the caller last cleared it
launches: collections.Counter = collections.Counter()


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def resolved_select_impl(device) -> str:
    """The engine that serves ``fitscore_select`` for tensors on
    ``device``: "cuda" (the hand-written kernel) or "torch" (``select_ref``
    on the CPU)."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"fitscore_select: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def fitscore_select(loads, counts, alive, open_seq, access_seq, closes, size,
                    pdep, now, dmask, cmask=None, *, policy: str):
    """The fused placement decision for ``L`` lanes (see ``select_ref``).

    loads (L, Np, 8) f32; counts/open_seq/access_seq (L, Np) int32; alive
    (L, Np) bool; closes (L, Np) f32; size/dmask (L, 8) f32; pdep/now (L,)
    f32; cmask (L, Np) bool or None.  Returns (slot int32, found bool,
    no_free bool), each (L,)."""
    if loads.device.type == "cpu":
        return select_ref(loads, counts, alive, open_seq, access_seq, closes,
                          size, pdep, now, dmask, cmask, policy=policy)
    if loads.device.type != "cuda":
        raise ValueError(f"fitscore_select: no kernel for {loads.device}")
    code = policy_code(policy)
    dev = loads.device
    if loads.dim() != 3:
        raise ValueError(f"fitscore_select: loads must be (L, Np, {DPAD})")
    L, Np, _ = loads.shape
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    _check("loads", loads, (L, Np, DPAD), f32, dev)
    if loads.data_ptr() % 16:
        raise ValueError("fitscore_select: loads must be 16-byte aligned")
    for name, t, dt in (("counts", counts, i32), ("alive", alive, b8),
                        ("open_seq", open_seq, i32),
                        ("access_seq", access_seq, i32),
                        ("closes", closes, f32)):
        _check(name, t, (L, Np), dt, dev)
    _check("size", size, (L, DPAD), f32, dev)
    _check("dmask", dmask, (L, DPAD), f32, dev)
    _check("pdep", pdep, (L,), f32, dev)
    _check("now", now, (L,), f32, dev)
    if cmask is not None:
        _check("cmask", cmask, (L, Np), b8, dev)
    from ._build import library
    lib = library()
    out = torch.empty((L, 3), dtype=i32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fitscore_select_launch(
        loads.data_ptr(), counts.data_ptr(), alive.data_ptr(),
        open_seq.data_ptr(), access_seq.data_ptr(), closes.data_ptr(),
        size.data_ptr(), dmask.data_ptr(),
        None if cmask is None else cmask.data_ptr(), pdep.data_ptr(),
        now.data_ptr(), out.data_ptr(), L, Np, code, dev.index or 0, stream)
    if err:
        raise RuntimeError("fitscore_select launch failed: "
                           f"{lib.fitscore_error_string(err).decode()}")
    launches["fitscore_select"] += 1
    return out[:, 0], out[:, 1] > 0, out[:, 2] > 0
