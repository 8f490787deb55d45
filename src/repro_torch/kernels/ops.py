"""Wrappers that launch the port's hand-written kernels: the select
(``fitscore_select``, ``csrc/select.cu``: one warp a lane for pools of up
to 256 slots, a CTA a lane above, see ``select_route``), the event-blocked
replay megakernel (``fitscore_replay_block``: ``csrc/replay_block_sm90.cu``,
one warp a lane, for pools of up to 256 slots, ``csrc/replay_block.cu``
otherwise, see ``replay_route``; with ``replay_chunk``, the host loop over
a chunk's blocks; ``fitscore_replay_dispatch``, a block of the serving
front end's live carry; ``fitscore_select_block``, one scheduler decision
at T=1), the legacy
single-pool scorer (``fitscore``, ``csrc/fitscore.cu``), the attention
kernels of the model stack (``flash_attention``:
``csrc/flash_attention_sm90.cu`` on the tensor cores for bf16 at hd 64,
128, 192 or 256, ``csrc/flash_attention.cu`` otherwise, see
``flash_route``; ``decode_attention``, ``csrc/decode_attention.cu``, bf16
on its tensor-core route, see ``decode_route``; both with query
offsets or key bounds, the softcap and an int8 cache as the reference's
XLA path takes them; ``latent_attention``, the absorbed MLA's,
``csrc/latent_attention.cu``) and the chunked linear attention of RWKV6
and of hymba's SSD heads (``rwkv6_chunked``, ``csrc/rwkv6_chunked.cu``).

A wrapper takes its kernel's plain PyTorch version only because the tensors
it was given lie on the CPU.  For CUDA tensors it checks them, launches the
kernel on the current stream or raises; there is no fallback.  Each launch
adds one to ``launches`` under the kernel's name, so a run can show that it
went through the kernel; the select's launches also count under their
route (``fitscore_select_warp`` or ``fitscore_select_cta``), the
megakernel's launches with its MIGRATE branch
count under ``fitscore_replay_block_migrate``, and every megakernel launch
also under its route (``fitscore_replay_block_warp`` or
``fitscore_replay_block_global``) and, launched for the serving front end
or the scheduler, under ``fitscore_replay_dispatch_T{T}`` or
``fitscore_select_block``; flash attention's calls through its
tensor-core kernel also under ``flash_attention_sm90``, decode
attention's under ``decode_attention_mma``, the attention
kernels' calls at an offset, with a softcap or over an int8 cache also
under ``_offset``, ``_softcap`` or ``_int8`` after the kernel's name; the
chunked
kernel's post-update (SSD) launches also under ``rwkv6_chunked_post`` and
its launches from a carried state under ``rwkv6_chunked_s0``.
"""
from __future__ import annotations

import collections
import functools

import torch

from ..resilience import faults
from . import fitscore as fk
from .attention import (decode_attention_ref, flash_attention_ref,
                        latent_attention_ref)
from .fitscore import (DPAD, KCAT, REPLAY_EV_F, REPLAY_EV_I, policy_code,
                       replay_block_ref, replay_carry_names, select_ref)
from .legacy import NORMS, fitscore_ref
from .rwkv6 import rwkv6_chunked_ref

# kernel name -> launches since the caller last cleared it; the per-event
# replay adds its CUDA graph replays and captures (``replay_step_graph``,
# ``replay_step_capture``, see ``core.torchsim.replay_windows``)
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


# the largest slot pool the select's warp route takes (kSelectWarpMaxSlots
# in csrc/select.cu): eight slots a thread
SELECT_WARP_MAX_SLOTS = 256
SELECT_ROUTES = ("warp", "cta")


def select_route(Np: int) -> str:
    """The kernel that serves a ``fitscore_select`` call on the card, from
    the pool size alone: "warp" (one warp a lane, four lanes a CTA,
    ``csrc/select.cu::select_warp_kernel``) for 1 <= Np <=
    ``SELECT_WARP_MAX_SLOTS``, "cta" (a 256-thread CTA a lane,
    ``select_cta_kernel``) above, up to ``MAX_BINS_CAP``."""
    if Np < 1:
        raise ValueError(f"select_route: a pool of {Np} slots")
    return "warp" if Np <= SELECT_WARP_MAX_SLOTS else "cta"


def select_launcher(loads, counts, alive, open_seq, access_seq, closes, size,
                    pdep, now, dmask, cmask=None, *, policy: str,
                    route: str):
    """Checks ``fitscore_select``'s arguments (CUDA tensors) and allocates
    its outputs; returns ``(launch, (slot, found, no_free))``, where
    ``launch`` is a function of no arguments that launches ``route``'s
    kernel ("warp" or "cta") once on them into those outputs, raising if
    the launch fails; it counts nothing.  ``fitscore_select`` calls it with
    ``select_route(Np)``; a measurement may time the other route with it
    (the cta kernel takes any pool, the warp kernel up to
    ``SELECT_WARP_MAX_SLOTS`` slots)."""
    name = "fitscore_select"
    if loads.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {loads.device}")
    if route not in SELECT_ROUTES:
        raise ValueError(f"{name}: route {route!r}")
    code = policy_code(policy)
    dev = loads.device
    if loads.dim() != 3:
        raise ValueError(f"{name}: loads must be (L, Np, {DPAD})")
    L, Np, _ = loads.shape
    if route == "warp" and not 1 <= Np <= SELECT_WARP_MAX_SLOTS:
        raise ValueError(f"{name}: the warp kernel takes 1 to "
                         f"{SELECT_WARP_MAX_SLOTS} slots, not {Np}")
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    _check("loads", loads, (L, Np, DPAD), f32, dev)
    if loads.data_ptr() % 16:
        raise ValueError(f"{name}: loads must be 16-byte aligned")
    for nm, t, dt in (("counts", counts, i32), ("alive", alive, b8),
                      ("open_seq", open_seq, i32),
                      ("access_seq", access_seq, i32),
                      ("closes", closes, f32)):
        _check(nm, t, (L, Np), dt, dev)
    _check("size", size, (L, DPAD), f32, dev)
    _check("dmask", dmask, (L, DPAD), f32, dev)
    _check("pdep", pdep, (L,), f32, dev)
    _check("now", now, (L,), f32, dev)
    if cmask is not None:
        _check("cmask", cmask, (L, Np), b8, dev)
    from ._build import library
    lib = library()
    slot = torch.empty(L, dtype=i32, device=dev)
    flags = torch.empty((2, L), dtype=b8, device=dev)
    args = (loads.data_ptr(), counts.data_ptr(), alive.data_ptr(),
            open_seq.data_ptr(), access_seq.data_ptr(), closes.data_ptr(),
            size.data_ptr(), dmask.data_ptr(),
            None if cmask is None else cmask.data_ptr(), pdep.data_ptr(),
            now.data_ptr(), slot.data_ptr(), flags[0].data_ptr(),
            flags[1].data_ptr(), L, Np, code, SELECT_ROUTES.index(route),
            dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)

    def launch():
        err = lib.fitscore_select_launch(*args)
        if err:
            raise RuntimeError(f"{name} ({route} kernel) launch failed: "
                               f"{lib.fitscore_error_string(err).decode()}")
    return launch, (slot, flags[0], flags[1])


def fitscore_select(loads, counts, alive, open_seq, access_seq, closes, size,
                    pdep, now, dmask, cmask=None, *, policy: str):
    """The fused placement decision for ``L`` lanes (see ``select_ref``).

    loads (L, Np, 8) f32; counts/open_seq/access_seq (L, Np) int32; alive
    (L, Np) bool; closes (L, Np) f32; size/dmask (L, 8) f32; pdep/now (L,)
    f32; cmask (L, Np) bool or None.  Returns (slot int32, found bool,
    no_free bool), each (L,).  For CUDA tensors the kernel
    ``select_route(Np)`` names, counted under ``fitscore_select`` and
    ``fitscore_select_{route}``; ``select_ref`` for CPU ones.

    Crosses the fault seam ``kernel.select`` once a call.  Inside a CUDA
    graph of replay steps the call runs only while the graph is captured:
    its replays cross no seam (see ``resilience.faults``)."""
    faults.fire("kernel.select")
    if loads.device.type == "cpu":
        return select_ref(loads, counts, alive, open_seq, access_seq, closes,
                          size, pdep, now, dmask, cmask, policy=policy)
    route = select_route(loads.shape[1]) if loads.dim() == 3 else "warp"
    launch, out = select_launcher(loads, counts, alive, open_seq,
                                  access_seq, closes, size, pdep, now, dmask,
                                  cmask, policy=policy, route=route)
    launch()
    launches["fitscore_select"] += 1
    launches[f"fitscore_select_{route}"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _rcp_rsqrt_on(device: torch.device) -> torch.Tensor:
    """``fitscore.RCP_RSQRT`` on one card (the kernel reads it there)."""
    return fk.RCP_RSQRT.to(device)


# the largest slot pool the warp kernel takes (kWarpMaxSlots in
# csrc/replay_common.cuh): eight slots a thread
REPLAY_WARP_MAX_SLOTS = 256


def replay_route(Np: int) -> str:
    """The kernel that serves a ``fitscore_replay_block`` launch on the
    card, from the pool size alone: "warp" (``csrc/replay_block_sm90.cu``:
    one warp a lane, the slot state and the event block in shared memory)
    for 1 <= Np <= ``REPLAY_WARP_MAX_SLOTS``, "global" (``csrc/
    replay_block.cu``: a 256-thread CTA a lane, the carry in global memory)
    above, up to ``MAX_BINS_CAP``."""
    if Np < 1:
        raise ValueError(f"replay_route: a pool of {Np} slots")
    return "warp" if Np <= REPLAY_WARP_MAX_SLOTS else "global"


def replay_block_launcher(carry, ev_i, ev_f, ev_size, dmask, *, route: str,
                          family: str, policy: str, n: int, d: int,
                          large_bins: bool = True,
                          adaptive_alpha: bool = False,
                          direct_sum: bool = False, la_mode: str = "binary",
                          la_split: float = 7200.0, low: float = 2.0,
                          high: float = 16.0, migrate: bool = False):
    """Checks ``fitscore_replay_block``'s arguments (CUDA tensors) and
    returns a function of no arguments that launches ``route``'s kernel
    ("warp" or "global") once on them, raising if the launch fails; it
    counts nothing.  ``fitscore_replay_block`` calls it with
    ``replay_route(n)``; a measurement may time the other route with it.
    The warp route raises for carries or sizes that are not 16-byte
    aligned, and for more item rows than its shared memory holds (RCP
    keeps a bit an item row there: about 1.5 million rows at 256 slots)."""
    name = "fitscore_replay_block"
    dev = carry["loads"].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    if route not in ("warp", "global"):
        raise ValueError(f"{name}: route {route!r}")
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
    if route == "warp" and not 1 <= Np <= REPLAY_WARP_MAX_SLOTS:
        raise ValueError(f"{name}: the warp kernel takes 1 to "
                         f"{REPLAY_WARP_MAX_SLOTS} slots, not {Np}")
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
    if route == "warp":
        for nm, t in (*carry.items(), ("ev_size", ev_size)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: {nm} must be 16-byte aligned on "
                                 "the warp route (it reads rows as float4)")
    from ._build import library
    lib = library()
    fam_code = fk.REPLAY_FAMILIES.index(family)
    if route == "warp":
        smem = lib.fitscore_replay_block_warp_smem_bytes(fam_code, Np, T, R)
        if smem > lib.fitscore_replay_block_warp_smem_max():
            raise ValueError(
                f"{name}: {R} item rows need {smem} B of shared memory on "
                f"the warp route, more than the "
                f"{lib.fitscore_replay_block_warp_smem_max()} B a CTA takes")
    fn = lib.fitscore_replay_block_warp_launch if route == "warp" else \
        lib.fitscore_replay_block_launch
    hagg, ragg, ron = (carry[nm].data_ptr() if nm in carry else None
                       for nm in ("hagg", "ragg", "ron"))
    args = (carry["loads"].data_ptr(), carry["slotf"].data_ptr(),
            carry["sloti"].data_ptr(), carry["itemi"].data_ptr(),
            carry["sf"].data_ptr(), carry["si"].data_ptr(), hagg, ragg, ron,
            ev_i.data_ptr(), ev_f.data_ptr(), ev_size.data_ptr(),
            dmask.data_ptr(), _rcp_rsqrt_on(dev).data_ptr(),
            ev_i.stride(0), ev_i.stride(1), ev_size.stride(0),
            L, Np, R, T, d, fam_code, code,
            int(large_bins), int(adaptive_alpha), int(direct_sum),
            int(la_mode == "geometric"), int(migrate), la_split, low, high,
            dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)

    def launch():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{name} ({route} kernel) launch failed: "
                               f"{lib.fitscore_error_string(err).decode()}")
    return launch


def fitscore_replay_block(carry, ev_i, ev_f, ev_size, dmask, *, family: str,
                          policy: str, n: int, d: int,
                          large_bins: bool = True,
                          adaptive_alpha: bool = False,
                          direct_sum: bool = False, la_mode: str = "binary",
                          la_split: float = 7200.0, low: float = 2.0,
                          high: float = 16.0, migrate: bool = False):
    """One block of ``T`` events for ``L`` lanes, the packed carry updated
    in place: for CUDA tensors the CUDA megakernel ``replay_route(n)``
    names (``csrc/replay_block_sm90.cu`` up to ``REPLAY_WARP_MAX_SLOTS``
    slots, ``csrc/replay_block.cu`` above), ``fitscore.replay_block_ref``
    (same arguments) for CPU ones.  ``migrate`` replays MIGRATE events
    (consolidation; the kernel built with its MIGRATE branch); without it
    they are no-ops.

    ``ev_i`` (2 + ni, L, T) int32 / ``ev_f`` (2 + nf, L, T) f32 may be
    views of longer streams (block slices): their last axis must be dense
    and their strides equal; ``ev_size`` (L, T, DPAD) likewise, with dense
    rows.  ``policy`` is read by the score family only.

    Every DEPARTURE and MIGRATE event must name an item its lane has
    placed: an ARRIVAL of it in this block or an earlier one, and no
    DEPARTURE since.  The replays' streams hold to it (``torchsim.
    event_sequence`` sorts each departure after its arrival, since an
    ``Instance`` has departures > arrivals; consolidation migrates live
    items only).  The departure of an item with no slot (placement -1) is
    outside the contract: the plain version, the two kernels and the JAX
    package's megakernel each do something else with it."""
    kw = dict(family=family, policy=policy, n=n, d=d, large_bins=large_bins,
              adaptive_alpha=adaptive_alpha, direct_sum=direct_sum,
              la_mode=la_mode, la_split=la_split, low=low, high=high,
              migrate=migrate)
    dev = carry["loads"].device
    if dev.type == "cpu":
        return replay_block_ref(carry, ev_i, ev_f, ev_size, dmask, **kw)
    route = replay_route(carry["loads"].shape[1])
    replay_block_launcher(carry, ev_i, ev_f, ev_size, dmask, route=route,
                          **kw)()
    name = "fitscore_replay_block"
    launches[name + "_migrate" if migrate else name] += 1
    launches[f"{name}_{route}"] += 1
    return carry


def replay_chunk(carry, ev_i, ev_f, ev_size, dmask, *, block_events: int,
                 **block_kwargs):
    """A chunk of ``C = NB * block_events`` events, one
    ``fitscore_replay_block`` per block, the packed carry updated in place:
    the counterpart of the reference's ``fitscore_replay_chunk`` (a host
    loop here, one launch per block).  ``ev_i`` / ``ev_f`` (k, L, C),
    ``ev_size`` (L, C, DPAD); pad the tail block with PAD events.
    ``block_kwargs`` are ``fitscore_replay_block``'s, ``migrate``
    included."""
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


# the launch geometries fitscore_replay_dispatch has served: (policy, Np,
# dpad, T, migrate, route) - the port's stand-in for the reference's jit
# cache of its block dispatch (``dispatch_trace_count``)
_dispatch_geometries: set = set()


def fitscore_replay_dispatch(carry, ev_i, ev_f, ev_size, dmask, *,
                             policy: str, n: int, d: int,
                             migrate: bool = False):
    """One ``T``-event block of a *live* replay, the serving front end's: a
    batch of pending arrivals (plus the departures that fired since the
    last block, plus PAD filler up to the block geometry) replayed by
    ``fitscore_replay_block`` on a persistent one-lane carry
    (``core.torchsim.make_live_carry``), updated in place and returned.

    ``policy`` is any scan policy whose family has a live form (score, cbd,
    cbdt, rcp, la, adaptive); its ``PolicySpec`` knobs resolve here, so the
    caller passes one name.  Crosses the fault seam
    ``kernel.dispatch_block`` once a call.  Each distinct launch geometry
    is remembered (``dispatch_trace_count``); on the card the launch also
    counts under ``fitscore_replay_dispatch_T{T}``."""
    from ..core.torchsim import replay_block_kwargs
    faults.fire("kernel.dispatch_block")
    dev = carry["loads"].device
    Np, T = carry["loads"].shape[1], ev_size.shape[1]
    route = replay_route(Np) if dev.type == "cuda" else dev.type
    _dispatch_geometries.add((policy, Np, ev_size.shape[2], T, migrate,
                              route))
    fitscore_replay_block(carry, ev_i, ev_f, ev_size, dmask, migrate=migrate,
                          **replay_block_kwargs(policy, n, d))
    if dev.type == "cuda":
        launches[f"fitscore_replay_dispatch_T{T}"] += 1
    return carry


def dispatch_trace_count() -> int:
    """How many distinct launch geometries ``fitscore_replay_dispatch`` has
    served in this process: the serving front end's invariant (after the
    fixed block geometries are warm, mixed batch sizes add none), in place
    of the reference's jit-cache size."""
    return len(_dispatch_geometries)


def fitscore_select_block(loads, alive, open_seq, access_seq, closes, size,
                          pdep, now, cat=None, tags=None, *, policy: str,
                          n: int, d: int):
    """One placement decision through the replay megakernel at T=1: a
    one-lane carry holding the pool's state replays one ARRIVAL and the
    chosen slot is read back from its placement.

    ``loads`` (n, d) f32, ``alive`` (n,) bool, ``open_seq`` /
    ``access_seq`` (n,) int32, ``closes`` (n,) f32, ``size`` (d,) f32 -
    tensors on one device; ``pdep`` / ``now`` floats.  ``cat`` and ``tags``
    (the request's CBD / CBDT class and the replicas' class tags, (n,)
    int32) select the class-restricted First Fit of the cbd family.  The
    first ``n`` slots hold count 1, so the free-slot stage never fires:
    the serving pool opens replicas itself, with absolute indices.  Returns
    ``(slot, found)`` as 0-dim tensors on that device; found False means
    "open a new replica", the host algorithms' contract.  Crosses the fault
    seam ``kernel.select_block``; on the card the launch also counts under
    ``fitscore_select_block``."""
    faults.fire("kernel.select_block")
    dev = loads.device
    f32, i32 = torch.float32, torch.int32
    family = "score" if cat is None else "cbd"
    sloti = torch.zeros((1, n, fk.SLOTI_COLS), dtype=i32, device=dev)
    sloti[0, :, fk.SLOTI_COUNTS] = 1
    sloti[0, :, fk.SLOTI_ALIVE] = alive.to(i32)
    sloti[0, :, fk.SLOTI_OSEQ] = open_seq.to(i32)
    sloti[0, :, fk.SLOTI_ASEQ] = access_seq.to(i32)
    if tags is not None:
        sloti[0, :, fk.SLOTI_TAG] = tags.to(i32)
    slotf = torch.zeros((1, n, fk.SLOTF_COLS), dtype=f32, device=dev)
    slotf[0, :, fk.SLOTF_CLOSES] = closes.to(f32)
    carry = {"loads": torch.zeros((1, n, DPAD), dtype=f32, device=dev),
             "slotf": slotf, "sloti": sloti,
             "itemi": torch.full((1, 1, fk.ITEMI_COLS), -1, dtype=i32,
                                 device=dev),
             "sf": torch.zeros((1, fk.SF_COLS), dtype=f32, device=dev),
             "si": torch.zeros((1, fk.SI_COLS), dtype=i32, device=dev)}
    carry["loads"][0, :, :d] = loads.to(f32)
    ints = {"kind": [[fk.ARRIVAL_KIND]], "item": [[0]]}
    if cat is not None:
        ints["cat"] = [[int(cat)]]
    ev_i, ev_f = fk.stack_event_streams(
        family, ints, {"t": [[float(now)]], "pdep": [[float(pdep)]]})
    ev_size = torch.zeros((1, 1, DPAD), dtype=f32, device=dev)
    ev_size[0, 0, :d] = size.to(f32)
    dmask = torch.zeros((1, DPAD), dtype=f32, device=dev)
    dmask[0, :d] = 1.0
    fitscore_replay_block(
        carry, ev_i.to(dev), ev_f.to(dev), ev_size, dmask, family=family,
        policy=policy if family == "score" else "first_fit", n=n, d=d)
    if dev.type == "cuda":
        launches["fitscore_select_block"] += 1
    return (carry["itemi"][0, 0, fk.ITEMI_PLACE],
            carry["si"][0, fk.SI_OPENED] == 0)


def fitscore(remaining, alive, item, open_seq=None, *, norm: str = "linf"):
    """The legacy single-pool scorer (see ``legacy.fitscore_ref``):
    remaining (N, d) f32, alive (N,) bool, item (d,) f32, open_seq (N,)
    int32 or None (the slot index) -> (scores (N,) f32, +inf where
    infeasible; the chosen row, an int32 0-dim tensor, -1 when no bin is
    feasible).  The CUDA kernel ``csrc/fitscore.cu`` for CUDA tensors (one
    launch a call: up to 4096 bins one cluster of CTAs, above that the last
    CTA, counted on the stream's counter, reduces the per-CTA partials),
    ``fitscore_ref`` for CPU ones."""
    if remaining.device.type == "cpu":
        return fitscore_ref(remaining, alive, item, open_seq, norm=norm)
    name = "fitscore"
    dev = remaining.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    if norm not in NORMS:
        raise ValueError(f"{name}: norm {norm!r} not in {NORMS}")
    if remaining.dim() != 2 or not 1 <= remaining.shape[0] < 2 ** 30:
        raise ValueError(f"{name}: remaining must be (N, d) with 1 <= N < "
                         f"2^30; got {tuple(remaining.shape)}")
    N, d = remaining.shape
    _check("remaining", remaining, (N, d), torch.float32, dev, name)
    _check("alive", alive, (N,), torch.bool, dev, name)
    _check("item", item, (d,), torch.float32, dev, name)
    if open_seq is not None:
        _check("open_seq", open_seq, (N,), torch.int32, dev, name)
    from ._build import library
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    scores = torch.empty(N, dtype=torch.float32, device=dev)
    best = torch.empty((), dtype=torch.int32, device=dev)
    # the per-CTA partials: (score, open_seq, row), 12 bytes each
    partial = torch.empty(3 * lib.fitscore_legacy_blocks(N),
                          dtype=torch.int32, device=dev)
    err = lib.fitscore_legacy_launch(
        remaining.data_ptr(), alive.data_ptr(), item.data_ptr(),
        None if open_seq is None else open_seq.data_ptr(), scores.data_ptr(),
        partial.data_ptr(), _stream_counter(name, dev, stream, 1).data_ptr(),
        best.data_ptr(), N, d, NORMS.index(norm), dev.index or 0, stream)
    if err:
        raise RuntimeError("fitscore launch failed: "
                           f"{lib.fitscore_error_string(err).decode()}")
    launches[name] += 1
    return scores, best


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check_attention(kernel, q, k, v, q_dims, k_scale=None, v_scale=None):
    """The shared checks of the two attention wrappers: one card, one
    dtype (fp32 or bf16), contiguous, GQA head counts, hd <= 256.  With
    ``k_scale`` / ``v_scale``, k and v are an int8 cache with fp32 scales
    of shape (B, S, KV, 1)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for {dev}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{kernel}: q must be float32 or bfloat16, got "
                         f"{q.dtype}")
    if q.dim() != q_dims or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{kernel}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    int8 = k_scale is not None
    if int8 != (v_scale is not None):
        raise ValueError(f"{kernel}: an int8 cache takes k_scale and "
                         "v_scale")
    kv_dtype = torch.int8 if int8 else q.dtype
    for name, t, dt in (("q", q, q.dtype), ("k", k, kv_dtype),
                        ("v", v, kv_dtype)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"{kernel}: {name} must be a contiguous {dt} tensor on "
                f"{dev}; got {t.dtype} on {t.device} (contiguous="
                f"{t.is_contiguous()})")
    if int8:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(name, t, (*k.shape[:3], 1), torch.float32, dev, kernel)
    H, hd = q.shape[-2], q.shape[-1]
    KV = k.shape[2]
    if k.shape[0] != q.shape[0] or k.shape[3] != hd or not 1 <= hd <= 256 \
            or KV < 1 or H % KV:
        raise ValueError(f"{kernel}: q {tuple(q.shape)} against k "
                         f"{tuple(k.shape)}: needs the same batch and head "
                         "dim, hd <= 256 and H a multiple of KV")


def _rows_i32(name, kernel, x, B: int, dev):
    """A per-row int argument (an offset or a key bound) as the kernel reads
    it: None stays None (a null pointer: the kernel's default), an int or a
    0-d / (B,) tensor becomes a (B,) int32 tensor on ``dev``, filled or
    converted on the card (no sync)."""
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        return torch.full((B,), int(x), dtype=torch.int32, device=dev)
    if x.dim() > 1 or (x.dim() == 1 and x.shape[0] != B):
        raise ValueError(f"{kernel}: {name} must be an int or a ({B},) "
                         f"tensor, got shape {tuple(x.shape)}")
    return x.to(device=dev, dtype=torch.int32).expand(B).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


# head dims the tensor-core flash kernel takes (bf16 only)
FLASH_SM90_HEAD_DIMS = (64, 128, 192, 256)


def flash_route(dtype, hd: int, int8: bool = False) -> str:
    """The kernel that serves a ``flash_attention`` call on the card,
    decided before the launch from the call's dtype, head dim and cache
    type alone: "sm90", the tensor-core kernel
    (``csrc/flash_attention_sm90.cu``), for bf16 at hd 64, 128, 192 or 256
    over a bf16 k / v; "simt", the CUDA-core kernel
    (``csrc/flash_attention.cu``), for every other call (fp32, which TF32
    products would hold to no better than ~1e-3, the other head dims, and
    an int8 cache, which the tensor-core kernel's TMA loads of bf16 tiles
    do not read: its calls also count under ``flash_attention_int8``).  Offsets, key bounds and
    the softcap take either route.  The tensor-core kernel reads q, k, v
    through TMA, which needs 16-byte aligned tensors: the wrapper raises
    for a call on that route whose tensors are not."""
    return "sm90" if dtype == torch.bfloat16 and not int8 and \
        hd in FLASH_SM90_HEAD_DIMS else "simt"


def _needs_grad(*ts) -> bool:
    """Grad mode is on and an input requires grad: a kernel call must then
    go through its ``torch.autograd.Function`` (``kernels.autograd``),
    since autograd cannot see the output a launch fills."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _forward_only(kernel, **cache_args):
    """Offsets, key bounds and int8 caches come from a cache, which
    training never has: they take no gradient."""
    given = [k for k, x in cache_args.items() if x is not None]
    if given:
        raise ValueError(f"{kernel}: {', '.join(given)} take no gradient "
                         "(a cache's calls are forward only)")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset=None, kv_len=None, softcap: float = 0.0,
                    k_scale=None, v_scale=None):
    """Blockwise GQA attention forward: q (B, Sq, H, hd), k/v (B, Skv, KV,
    hd) -> (B, Sq, H, hd) in q's type (see ``flash_attention_ref``): query
    ``i`` of row ``b`` at ``q_offset[b] + i`` (an int or (B,); None: 0),
    keys below ``kv_len[b]`` (None: all ``Skv``), ``softcap`` (0: none),
    and with ``k_scale`` / ``v_scale`` k and v an int8 cache.  On CUDA
    tensors (fp32 or bf16, contiguous, hd <= 256) one of two CUDA kernels,
    as ``flash_route`` picks (bf16 at hd 64 / 128 / 192 / 256 the
    tensor-core one); every call counts under
    ``launches["flash_attention"]``, the tensor-core kernel's also under
    ``launches["flash_attention_sm90"]``, a call with an offset or a key
    bound also under ``flash_attention_offset``, with a softcap under
    ``flash_attention_softcap``, over an int8 cache under
    ``flash_attention_int8``.  With grad mode on and an input that requires
    grad, the launch runs inside ``autograd.FlashAttention``, whose
    backward is torch ops (no offsets, key bounds or int8 there).  The
    plain version for CPU tensors."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len,
              softcap=softcap, k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, **kw)
    if _needs_grad(q, k, v):
        _forward_only("flash_attention", q_offset=q_offset, kv_len=kv_len,
                      k_scale=k_scale)
        from .autograd import FlashAttention
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    return flash_launch(q, k, v, **kw)


def flash_launch(q, k, v, *, causal: bool = True, window: int = 0,
                 q_offset=None, kv_len=None, softcap: float = 0.0,
                 k_scale=None, v_scale=None):
    """The launch of ``flash_attention``'s kernel (checks, route, count),
    invisible to autograd."""
    name = "flash_attention"
    _check_attention(name, q, k, v, 4, k_scale, v_scale)
    if softcap < 0 or window < 0:
        raise ValueError(f"{name}: softcap {softcap}, window {window}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if Sq == 0 or B == 0:
        return out
    from ._build import library
    lib = library()
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    int8 = k_scale is not None
    off = _rows_i32("q_offset", name, q_offset, B, dev)
    bound = _rows_i32("kv_len", name, kv_len, B, dev)
    common = (_ptr(off), _ptr(bound), B, Sq, Skv, H, KV, hd, hd ** -0.5,
              float(softcap), int(causal), int(window))
    if flash_route(q.dtype, hd, int8) == "sm90":
        kernel = "flash_attention_sm90"
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError(f"{name}: bf16 q, k, v at hd {hd} must be "
                             "16-byte aligned (the tensor-core kernel reads "
                             "them through TMA)")
        err = lib.flash_attention_sm90_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *common, dev.index or 0, stream)
    else:
        kernel = name
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), *common,
            int(q.dtype == torch.bfloat16), dev.index or 0, stream)
    if err:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{lib.fitscore_error_string(err).decode()}")
    launches[name] += 1
    if kernel != name:
        launches[kernel] += 1
    if off is not None or bound is not None:
        launches[name + "_offset"] += 1
    if softcap:
        launches[name + "_softcap"] += 1
    if int8:
        launches[name + "_int8"] += 1
    return out


# positions a decode split takes at least; split lengths are multiples of it
DECODE_SPLIT_MIN = 64


def decode_splits(B: int, KV: int, S: int, n_sm: int = 132) -> tuple:
    """How ``decode_attention``'s kernel splits a cache of capacity ``S``:
    (n_split, split_len), a grid of (n_split, KV, B) CTAs.  Enough splits to
    put about two CTAs on each of ``n_sm`` SMs, none shorter than
    ``DECODE_SPLIT_MIN`` positions, split_len a multiple of it and no split
    starting at or past ``S``.  From the shapes alone, so the wrapper needs
    no sync to read ``kv_len``; splits past a row's ``kv_len`` are empty.
    ``latent_attention``'s CUDA-core route splits its keys the same way,
    with one query position of one row in the place of a (row, kv head)."""
    if S <= DECODE_SPLIT_MIN:
        return 1, DECODE_SPLIT_MIN
    want = -(-2 * n_sm // max(1, B * KV))
    n = max(1, min(want, S // DECODE_SPLIT_MIN))
    split_len = -(-S // n)
    split_len = -(-split_len // DECODE_SPLIT_MIN) * DECODE_SPLIT_MIN
    return -(-S // split_len), split_len


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# (n_split, split_len) of the last decode_attention launch
last_decode_grid: tuple = (0, 0)
# (route, n_split, CTAs) of the last latent_attention launch
last_latent_grid: tuple = ("", 0, 0)

# (kernel, device index, stream) -> int32 counters of a last-CTA merge
# (decode attention's, the latent kernel's, the legacy scorer's), zero
# between launches (the merging CTA resets its own); one set a kernel and
# stream, so launches that share a set run in order
_counters: dict = {}


def _stream_counter(kernel: str, dev: torch.device, stream: int,
                    n: int) -> torch.Tensor:
    key = (kernel, dev.index or 0, stream)
    c = _counters.get(key)
    if c is None or c.numel() < n:
        c = _counters[key] = torch.zeros(max(n, 256), dtype=torch.int32,
                                         device=dev)
    return c


# query heads a kv head the decode kernel takes (kGMax in
# csrc/decode_attention.cu)
DECODE_G_MAX = 16


def decode_route(dtype, hd: int) -> str:
    """The route of ``csrc/decode_attention.cu`` that serves a
    ``decode_attention`` call on the card, decided here and passed to the
    launch (the C side follows it): "mma", ``decode_mma_kernel``, both
    products on the tensor cores by ``mma.sync``, for a bf16 q at any hd
    the kernel takes (1-256; above 128 in 32-position chunks, so that two
    CTAs still fit an SM), over a bf16 or an int8 cache (staged as bf16);
    "simt", ``decode_kernel`` on the CUDA cores, for fp32, which TF32
    products would hold to no better than ~1e-3."""
    return "mma" if dtype == torch.bfloat16 and 1 <= hd <= 256 else "simt"


def decode_attention(q, k, v, kv_len, *, window: int = 0,
                     softcap: float = 0.0, k_scale=None, v_scale=None):
    """Single-token GQA decode over a KV cache: q (B, H, hd), k/v (B, S,
    KV, hd), kv_len (B,) int32, ``window`` 0 (none) or the number of
    positions before ``kv_len`` a row reads, ``softcap`` (0: none), and
    with ``k_scale`` / ``v_scale`` (B, S, KV, 1) fp32 k and v an int8 cache
    -> (B, H, hd) in q's type (see ``decode_attention_ref``).  The CUDA
    kernel ``csrc/decode_attention.cu`` for CUDA tensors (fp32 or bf16,
    contiguous, hd <= 256, at most ``DECODE_G_MAX`` query heads per kv
    head): one launch a call on the route ``decode_route`` names, the
    cache split as ``decode_splits`` says (the grid launched is kept in
    ``last_decode_grid``; a split wholly before a row's window reads
    nothing), the splits' partials in fp32 scratch merged by the last CTA
    of each (row, kv head); an int8 cache is read as int8 and dequantized
    in the kernel.  Every launch counts under
    ``launches["decode_attention"]``, one on the tensor-core route also
    under ``decode_attention_mma``, a windowed one also under
    ``launches["decode_attention_window"]``, one with a softcap under
    ``decode_attention_softcap``, one over an int8 cache under
    ``decode_attention_int8``.  The plain version for CPU ones."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len, window=window,
                                    softcap=softcap, k_scale=k_scale,
                                    v_scale=v_scale)
    name = "decode_attention"
    _check_attention(name, q, k, v, 3, k_scale, v_scale)
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    if G > DECODE_G_MAX:
        raise ValueError(f"{name}: {G} query heads per kv head; the "
                         f"kernel takes at most {DECODE_G_MAX}")
    if window < 0 or softcap < 0:
        raise ValueError(f"{name}: window {window}, softcap {softcap}")
    _check("kv_len", kv_len, (B,), torch.int32, q.device, name)
    out = torch.empty_like(q)
    if B == 0:
        return out
    from ._build import library
    lib = library()
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_split, split_len = decode_splits(B, KV, S, _sm_count(dev))
    part_acc = part_ml = counter = None
    if n_split > 1:
        scratch = torch.empty(B * KV * n_split * G * (hd + 2),
                              dtype=torch.float32, device=dev)
        part_acc = scratch.data_ptr()
        part_ml = scratch[B * KV * n_split * G * hd:].data_ptr()
        counter = _stream_counter(name, dev, stream, B * KV).data_ptr()
    mma = decode_route(q.dtype, hd) == "mma"
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), kv_len.data_ptr(), out.data_ptr(), part_acc, part_ml,
        counter, B, S, H, KV, hd, hd ** -0.5, float(softcap), int(window),
        n_split, split_len, int(mma), dev.index or 0, stream)
    if err:
        raise RuntimeError("decode_attention launch failed: "
                           f"{lib.fitscore_error_string(err).decode()}")
    global last_decode_grid
    last_decode_grid = (n_split, split_len)
    launches[name] += 1
    if mma:
        launches[name + "_mma"] += 1
    if window:
        launches[name + "_window"] += 1
    if softcap:
        launches[name + "_softcap"] += 1
    if k_scale is not None:
        launches[name + "_int8"] += 1
    return out


# the latent kernels' bounds (kHMax, kDMax, kDvMax in
# csrc/latent_attention.cu and csrc/latent_attention_sm90.cu): query heads,
# latent columns, value columns
LATENT_H_MAX = 16
LATENT_D_MAX = 576
LATENT_DV_MAX = 512
# rows of the tensor-core kernel's tile (kBM): 64 // H query positions x
# all H heads; and keys a tile of its ring (kBN)
LATENT_TILE_ROWS = 64
LATENT_KEY_TILE = 64
# a tile whose visible keys span fewer 64-key tiles than this is not split:
# a merge costs more than the key tile it saves (measured: PERF.md)
LATENT_SPLIT_FROM_TILES = 3
# splits a tile the tensor-core latent kernel takes at most: one thread
# block cluster holds a tile's splits (kMaxSplit, a cluster's portable
# size)
LATENT_SPLIT_MAX = 8


def latent_route(dtype, H: int, D: int, hd_v: int) -> str:
    """The kernel that serves a ``latent_attention`` call on the card,
    decided here and passed to the launch: "tc", ``latent_sm90_kernel`` of
    ``csrc/latent_attention_sm90.cu``, both products on the tensor cores by
    ``wgmma``, for bf16 with D and ``hd_v`` multiples of 8 (TMA row pitches
    are multiples of 16 bytes); "simt", ``latent_kernel`` of
    ``csrc/latent_attention.cu`` on the CUDA cores, for fp32 (TF32 products
    would hold it to no better than ~1e-3) and every other shape."""
    return ("tc" if dtype == torch.bfloat16 and D % 8 == 0 and hd_v % 8 == 0
            else "simt")


def latent_tiles(Sq: int, H: int) -> int:
    """Tiles of the tensor-core latent kernel a batch row: each holds
    ``LATENT_TILE_ROWS // H`` consecutive query positions x all H heads."""
    return -(-Sq // (LATENT_TILE_ROWS // H))


def latent_splits(B: int, n_tiles: int, Sk: int, n_sm: int = 132,
                  clusters=None) -> int:
    """How many parts the tensor-core latent kernel splits each tile's
    visible keys into: a grid of (n_split, n_tiles, B) CTAs in clusters of
    (n_split, 1, 1), one CTA an SM (each takes 222 KB of shared memory).
    ``clusters`` maps a cluster size to how many such clusters the card
    holds at once (a cluster's CTAs share a GPC; default ``n_sm //
    size``).  The largest power of two up to ``LATENT_SPLIT_MAX`` and the
    key tiles of the cache capacity ``Sk`` whose clusters all fit one wave,
    none below ``LATENT_SPLIT_FROM_TILES`` key tiles; then as few as take
    the same longest split, so that at full capacity no split is empty.
    From the shapes alone: the visible keys (``kv_len``, ``q_offset``) live
    on the card, which splits them (``latent_split_range``)."""
    kt = -(-Sk // LATENT_KEY_TILE)
    if kt < LATENT_SPLIT_FROM_TILES:
        return 1
    slots = clusters or {}
    n = 1
    while 2 * n <= min(LATENT_SPLIT_MAX, kt) and \
            B * n_tiles <= slots.get(2 * n, n_sm // (2 * n)):
        n *= 2
    return -(-kt // -(-kt // n))


@functools.lru_cache(maxsize=None)
def _latent_clusters(device: torch.device) -> dict:
    """{cluster size: clusters of that many tensor-core latent CTAs the
    card holds at once (0: none fits)}, asked of the runtime once a
    card."""
    from ._build import library
    lib = library()
    out = {}
    for n in (2, 4, 8):
        got = lib.latent_attention_tc_max_clusters(n, device.index or 0)
        if got < 0:
            raise RuntimeError(f"latent_attention: clusters of {n} CTAs: "
                               f"{lib.fitscore_error_string(-got).decode()}")
        out[n] = got
    return out


def latent_split_range(visible: int, n_split: int, split: int) -> tuple:
    """The keys [start, end) that split ``split`` of the tensor-core latent
    kernel reads of a tile that sees the keys [0, visible): the visible key
    tiles (of ``LATENT_KEY_TILE``) in ``n_split`` parts of ceil(tiles /
    n_split) tiles each, so only splits past the visible keys are empty
    (start == end == visible).  The kernel computes the same on the card."""
    n_kt = -(-visible // LATENT_KEY_TILE)
    per = -(-n_kt // n_split)
    kt0 = min(split * per, n_kt)
    kt1 = min(kt0 + per, n_kt)
    return (min(kt0 * LATENT_KEY_TILE, visible),
            min(kt1 * LATENT_KEY_TILE, visible))


def latent_attention(q, lat, kv_len=None, *, q_offset=None, hd_v: int,
                     scale: float):
    """The absorbed MLA's attention: q (B, Sq, H, D), lat (B, Sk, D) (K the
    whole latent row, V its first ``hd_v`` columns), causal at
    ``q_offset`` (an int or (B,); None: 0), keys below ``kv_len`` (an int
    or (B,); None: all ``Sk``), ``scale`` the caller's -> (B, Sq, H, hd_v)
    in q's type (see ``latent_attention_ref``).  For CUDA tensors (fp32 or
    bf16, contiguous, H <= ``LATENT_H_MAX``, D <= ``LATENT_D_MAX``, hd_v <=
    ``LATENT_DV_MAX``) one launch a call on the route ``latent_route``
    names: "tc" (``csrc/latent_attention_sm90.cu``) a CTA per (key split,
    tile of ``64 // H`` query positions x H heads, row), the tiles' visible
    keys split on the card into ``latent_splits`` parts, one thread block
    cluster a tile merging its splits in shared memory; "simt"
    (``csrc/latent_attention.cu``) a CTA per (key split, query position,
    row), the keys split as ``decode_splits`` says for ``B * Sq`` rows and
    merged by the last CTA from fp32 scratch.  (route, n_split, CTAs) of
    the launch is kept in ``last_latent_grid``.  Every launch counts under
    ``launches["latent_attention"]``, one on the tensor-core route also
    under ``latent_attention_tc``.  With grad mode on and an input that
    requires grad, the launch runs inside ``autograd.LatentAttention`` (no
    offsets or key bounds there).  The plain version for CPU tensors."""
    if q.device.type == "cpu":
        return latent_attention_ref(q, lat, kv_len, q_offset=q_offset,
                                    hd_v=hd_v, scale=scale)
    if _needs_grad(q, lat):
        _forward_only("latent_attention", q_offset=q_offset, kv_len=kv_len)
        from .autograd import LatentAttention
        return LatentAttention.apply(q, lat, hd_v, scale)
    return latent_launch(q, lat, kv_len, q_offset=q_offset, hd_v=hd_v,
                         scale=scale)


def latent_launch(q, lat, kv_len=None, *, q_offset=None, hd_v: int,
                  scale: float):
    """The launch of ``latent_attention``'s kernel (checks, route, splits,
    counts), invisible to autograd."""
    name = "latent_attention"
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: q must be float32 or bfloat16, got "
                         f"{q.dtype}")
    if q.dim() != 4 or lat.dim() != 3:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, lat "
                         f"{tuple(lat.shape)}")
    B, Sq, H, D = q.shape
    Sk = lat.shape[1]
    if not (1 <= H <= LATENT_H_MAX and 1 <= D <= LATENT_D_MAX and
            1 <= hd_v <= min(D, LATENT_DV_MAX)):
        raise ValueError(f"{name}: H={H}, D={D}, hd_v={hd_v}; the kernel "
                         f"takes H <= {LATENT_H_MAX}, "
                         f"D <= {LATENT_D_MAX}, hd_v <= min(D, "
                         f"{LATENT_DV_MAX})")
    _check("q", q, (B, Sq, H, D), q.dtype, dev, name)
    _check("lat", lat, (B, Sk, D), q.dtype, dev, name)
    out = torch.empty((B, Sq, H, hd_v), dtype=q.dtype, device=dev)
    if B * Sq == 0:
        return out
    from ._build import library
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    off = _rows_i32("q_offset", name, q_offset, B, dev)
    bound = _rows_i32("kv_len", name, kv_len, B, dev)
    route = latent_route(q.dtype, H, D, hd_v)
    if route == "tc":
        if Sk == 0 or q.data_ptr() % 16 or lat.data_ptr() % 16:
            raise ValueError(f"{name}: bf16 q and lat must be 16-byte "
                             "aligned and Sk >= 1 (the tensor-core kernel "
                             "reads them through TMA)")
        n_tiles = latent_tiles(Sq, H)
        n_split = latent_splits(B, n_tiles, Sk, _sm_count(dev),
                                _latent_clusters(dev))
        err = lib.latent_attention_tc_launch(
            q.data_ptr(), lat.data_ptr(), _ptr(off), _ptr(bound),
            out.data_ptr(), B, Sq, Sk, H, D, hd_v, float(scale), n_split,
            dev.index or 0, stream)
        ctas = n_split * n_tiles * B
    else:
        part_acc = part_ml = counter = None
        n_split, split_len = decode_splits(B * Sq, 1, max(Sk, 1),
                                           _sm_count(dev))
        if n_split > 1:
            rows = B * Sq * n_split * H
            scratch = torch.empty(rows * (hd_v + 2), dtype=torch.float32,
                                  device=dev)
            part_acc = scratch.data_ptr()
            part_ml = scratch[rows * hd_v:].data_ptr()
            counter = _stream_counter(name, dev, stream, B * Sq).data_ptr()
        err = lib.latent_attention_launch(
            q.data_ptr(), lat.data_ptr(), _ptr(off), _ptr(bound),
            out.data_ptr(), part_acc, part_ml, counter, B, Sq, Sk, H, D,
            hd_v, float(scale), n_split, split_len,
            int(q.dtype == torch.bfloat16), dev.index or 0, stream)
        ctas = n_split * Sq * B
    if err:
        raise RuntimeError(f"{name} ({route}) launch failed: "
                           f"{lib.fitscore_error_string(err).decode()}")
    global last_latent_grid
    last_latent_grid = (route, n_split, ctas)
    launches[name] += 1
    if route == "tc":
        launches[name + "_tc"] += 1
    return out


# (CTAs along B * H, CTAs along V, chunks a window) of the last
# rwkv6_chunked launch
last_rwkv_grid: tuple = (0, 0, 0)


def rwkv6_chunked(r, k, v, logw, u=None, *, chunk: int = 16,
                  post_update: bool = False, initial_state=None):
    """Chunked linear attention: r, k, logw (B, S, H, K); v (B, S, H, V);
    u (H, K) or None (no bonus); ``post_update`` False (RWKV6: y_t reads
    S_{t-1}, plus the bonus) or True (the SSD: y_t reads S_t);
    ``initial_state`` (B, H, K, V) fp32 or None (zeros) -> (y (B, S, H, V)
    fp32, final state (B, H, K, V) fp32), see ``rwkv6_chunked_ref``.  The
    CUDA kernel ``csrc/rwkv6_chunked.cu`` for CUDA tensors (r, k, v of one
    type, fp32 or bf16; logw, u and the initial state fp32; contiguous; K,
    V <= 64; chunk <= 16): one CTA per (row, head, 16 state columns),
    walking the sequence in windows of 8 chunks (the grid launched is kept
    in ``last_rwkv_grid``); the plain version for CPU ones.  Any S: the
    kernel reads the rows past S as identity rows, the padding of
    ``rwkv6_chunked_ref``.  With grad mode on and an input that requires
    grad, the launch runs inside ``autograd.ChunkedScan``, whose backward
    is autograd over the plain version recomputed."""
    if r.device.type == "cpu":
        return rwkv6_chunked_ref(r, k, v, logw, u, chunk=chunk,
                                 post_update=post_update,
                                 initial_state=initial_state)
    if _needs_grad(r, k, v, logw, u, initial_state):
        from .autograd import ChunkedScan
        return ChunkedScan.apply(r, k, v, logw, u, initial_state, chunk,
                                 post_update)
    return rwkv6_launch(r, k, v, logw, u, chunk=chunk,
                        post_update=post_update, initial_state=initial_state)


def rwkv6_launch(r, k, v, logw, u=None, *, chunk: int = 16,
                 post_update: bool = False, initial_state=None):
    """The launch of ``rwkv6_chunked``'s kernel (checks, grid, counts),
    invisible to autograd."""
    name = "rwkv6_chunked"
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    if r.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: r must be float32 or bfloat16, got "
                         f"{r.dtype}")
    if r.dim() != 4 or v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"{name}: shapes r {tuple(r.shape)}, v "
                         f"{tuple(v.shape)}")
    B, S, H, K = r.shape
    V = v.shape[-1]
    if not (1 <= K <= 64 and 1 <= V <= 64 and 1 <= chunk <= 16):
        raise ValueError(f"{name}: K={K}, V={V}, chunk={chunk}; the kernel "
                         "takes K, V <= 64 and chunk <= 16")
    f32 = torch.float32
    _check("r", r, (B, S, H, K), r.dtype, dev, name)
    _check("k", k, (B, S, H, K), r.dtype, dev, name)
    _check("v", v, (B, S, H, V), r.dtype, dev, name)
    _check("logw", logw, (B, S, H, K), f32, dev, name)
    if u is not None:
        _check("u", u, (H, K), f32, dev, name)
    if initial_state is not None:
        _check("initial_state", initial_state, (B, H, K, V), f32, dev, name)
    y = torch.empty((B, S, H, V), dtype=f32, device=dev)
    state = torch.empty((B, H, K, V), dtype=f32, device=dev)
    if B * H == 0:
        return y, state
    from ._build import library
    lib = library()
    err = lib.rwkv6_chunked_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        None if u is None else u.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), state.data_ptr(), B, S, H, K, V,
        max(1, min(chunk, S)), int(r.dtype == torch.bfloat16),
        int(post_update), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("rwkv6_chunked launch failed: "
                           f"{lib.fitscore_error_string(err).decode()}")
    global last_rwkv_grid
    last_rwkv_grid = (B * H, -(-V // lib.rwkv6_chunked_col_block()),
                      lib.rwkv6_chunked_window())
    launches[name] += 1
    if post_update:
        launches[name + "_post"] += 1
    if initial_state is not None:
        launches[name + "_s0"] += 1
    return y, state
