"""Wrappers that launch the port's hand-written kernels: the select
(``fitscore_select``, ``csrc/select.cu``) and the event-blocked replay
megakernel (``fitscore_replay_block``, ``csrc/replay_block.cu``, with
``replay_chunk``, the host loop over a chunk's blocks).

A wrapper takes its kernel's plain PyTorch version only because the tensors
it was given lie on the CPU.  For CUDA tensors it checks them, launches the
kernel on the current stream or raises; there is no fallback.  Each launch
adds one to ``launches`` under the kernel's name, so a run can show that it
went through the kernel.
"""
from __future__ import annotations

import collections
import functools

import torch

from . import fitscore as fk
from .fitscore import (DPAD, KCAT, REPLAY_EV_F, REPLAY_EV_I, policy_code,
                       replay_block_ref, replay_carry_names, select_ref)

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


def _check(name, t, shape, dtype, device, kernel="fitscore_select"):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {dtype} tensor of "
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


@functools.lru_cache(maxsize=None)
def _rcp_rsqrt_on(device: torch.device) -> torch.Tensor:
    """``fitscore.RCP_RSQRT`` on one card (the kernel reads it there)."""
    return fk.RCP_RSQRT.to(device)


def fitscore_replay_block(carry, ev_i, ev_f, ev_size, dmask, *, family: str,
                          policy: str, n: int, d: int,
                          large_bins: bool = True,
                          adaptive_alpha: bool = False,
                          direct_sum: bool = False, la_mode: str = "binary",
                          la_split: float = 7200.0, low: float = 2.0,
                          high: float = 16.0):
    """One block of ``T`` events for ``L`` lanes, the packed carry updated
    in place: the CUDA megakernel (``csrc/replay_block.cu``) for CUDA
    tensors, ``fitscore.replay_block_ref`` (same arguments) for CPU ones.

    ``ev_i`` (2 + ni, L, T) int32 / ``ev_f`` (2 + nf, L, T) f32 may be
    views of longer streams (block slices): their last axis must be dense
    and their strides equal; ``ev_size`` (L, T, DPAD) likewise, with dense
    rows.  ``policy`` is read by the score family only."""
    kw = dict(family=family, policy=policy, n=n, d=d, large_bins=large_bins,
              adaptive_alpha=adaptive_alpha, direct_sum=direct_sum,
              la_mode=la_mode, la_split=la_split, low=low, high=high)
    dev = carry["loads"].device
    if dev.type == "cpu":
        return replay_block_ref(carry, ev_i, ev_f, ev_size, dmask, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fitscore_replay_block: no kernel for {dev}")
    name = "fitscore_replay_block"
    names = replay_carry_names(family)
    if set(carry) != set(names):
        raise ValueError(f"{name}: carry arrays {sorted(carry)} are not "
                         f"the {family} family's {sorted(names)}")
    if la_mode not in ("binary", "geometric"):
        raise ValueError(f"{name}: la_mode {la_mode!r}")
    code = policy_code(policy) if family == "score" else 0
    L, Np, _ = carry["loads"].shape
    R = carry["itemi"].shape[1]
    if Np != n:
        raise ValueError(f"{name}: the carry has {Np} slots, n={n}")
    f32, i32 = torch.float32, torch.int32
    shapes = {"loads": ((L, Np, DPAD), f32), "slotf": ((L, Np, 8), f32),
              "sloti": ((L, Np, 8), i32), "itemi": ((L, R, 8), i32),
              "sf": ((L, 8), f32), "si": ((L, 8), i32),
              "hagg": ((L, R, DPAD), f32),
              "ragg": ((L, fk.RAGG_ROWS, DPAD), f32),
              "ron": ((L, KCAT, 8), i32)}
    for nm in names:
        _check(nm, carry[nm], *shapes[nm], dev, name)
    T = ev_size.shape[1] if ev_size.dim() == 3 else -1
    for nm, t, shape, dt in (
            ("ev_i", ev_i, (2 + len(REPLAY_EV_I[family]), L, T), i32),
            ("ev_f", ev_f, (2 + len(REPLAY_EV_F[family]), L, T), f32),
            ("ev_size", ev_size, (L, T, DPAD), f32)):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or t.stride(-1) != 1:
            raise ValueError(
                f"{name}: {nm} must be a {dt} tensor of shape {shape} on "
                f"{dev} with a dense last axis; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}, strides {t.stride()}")
    if ev_f.stride() != ev_i.stride() or ev_size.stride(1) != DPAD:
        raise ValueError(f"{name}: ev_i / ev_f strides {ev_i.stride()} / "
                         f"{ev_f.stride()} differ, or ev_size rows are not "
                         f"dense ({ev_size.stride()})")
    _check("dmask", dmask, (L, DPAD), f32, dev, name)
    from ._build import library
    lib = library()
    hagg, ragg, ron = (carry[nm].data_ptr() if nm in carry else None
                       for nm in ("hagg", "ragg", "ron"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fitscore_replay_block_launch(
        carry["loads"].data_ptr(), carry["slotf"].data_ptr(),
        carry["sloti"].data_ptr(), carry["itemi"].data_ptr(),
        carry["sf"].data_ptr(), carry["si"].data_ptr(), hagg, ragg, ron,
        ev_i.data_ptr(), ev_f.data_ptr(), ev_size.data_ptr(),
        dmask.data_ptr(), _rcp_rsqrt_on(dev).data_ptr(),
        ev_i.stride(0), ev_i.stride(1), ev_size.stride(0),
        L, Np, R, T, d, fk.REPLAY_FAMILIES.index(family), code,
        int(large_bins), int(adaptive_alpha), int(direct_sum),
        int(la_mode == "geometric"), la_split, low, high, dev.index or 0,
        stream)
    if err:
        raise RuntimeError("fitscore_replay_block launch failed: "
                           f"{lib.fitscore_error_string(err).decode()}")
    launches[name] += 1
    return carry


def replay_chunk(carry, ev_i, ev_f, ev_size, dmask, *, block_events: int,
                 **block_kwargs):
    """A chunk of ``C = NB * block_events`` events, one
    ``fitscore_replay_block`` per block, the packed carry updated in place:
    the counterpart of the reference's ``fitscore_replay_chunk`` (a host
    loop here, one launch per block).  ``ev_i`` / ``ev_f`` (k, L, C),
    ``ev_size`` (L, C, DPAD); pad the tail block with PAD events."""
    T = int(block_events)
    C = ev_size.shape[1]
    if T < 1 or C % T:
        raise ValueError(f"replay_chunk: {C} events are not a multiple of "
                         f"block_events={T}")
    for b in range(0, C, T):
        fitscore_replay_block(carry, ev_i[:, :, b:b + T],
                              ev_f[:, :, b:b + T], ev_size[:, b:b + T],
                              dmask, **block_kwargs)
    return carry
