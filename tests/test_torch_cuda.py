"""The port on the card: the CUDA select and the CUDA replay megakernel
(its MIGRATE branch included) against their plain versions, the replays on
the card (per event, blocked, consolidating; the serving front end's live
carry and the scheduler's block select) against the replays on the CPU,
and the legacy scorer against its plain version, bit for bit; the two
attention kernels (at MLA's shapes too, V zero-padded) and the RWKV6
chunked kernel against their plain versions within the JAX kernel tests'
tolerances, the model and engine through them against the plain versions,
the dropless MoE dispatch against the all-experts formula, elastic
training resumed on the card and across the card and the CPU, and the
gradient compression on the card against the CPU.

Every test here needs an NVIDIA card (marker ``cuda``) and skips with a
reason where ``torch.cuda.is_available()`` is false: the CUDA kernel has
no CPU mode.  The file imports neither JAX nor the JAX package, so it runs
on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import collections
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import torchsim
from repro_torch.core.types import Instance
from repro_torch.kernels import ops
from repro_torch.kernels import fitscore as fk
from repro_torch.kernels.fitscore import SELECT_POLICIES, select_ref
from repro_torch.sweep import pack_instances, pad_predictions, run_batch
from repro_torch.sweep.runner import _flatten_lanes

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import (HAZARDS, RWKV_CROSS_SHAPES,  # noqa: E402
                        check_routes, hazard_block, legacy_back_to_back,
                        legacy_inputs, migrate_streams, padded_streams,
                        random_state, synthetic_lanes, windowed_lens)
# (the card check's input makers)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, with float32 matrix products in full float32: the plain
    versions the kernels are held to would otherwise run their products in
    TF32 (three decimal digits) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    return torch.device("cuda")


@pytest.mark.parametrize("policy", SELECT_POLICIES)
def test_kernel_equals_select_ref(policy, cuda):
    rng = np.random.default_rng(SELECT_POLICIES.index(policy))
    for mode in ("random", "ties", "full"):
        for Np in (64, 300):
            for d in (2, 5):
                st = random_state(rng, 28, Np, d, mode, cuda)
                for cmask in (None, st[10]):
                    n0 = ops.launches["fitscore_select"]
                    got = ops.fitscore_select(*st[:10], cmask, policy=policy)
                    assert ops.launches["fitscore_select"] == n0 + 1
                    ref = select_ref(*st[:10], cmask, policy=policy)
                    for a, b in zip(got, ref):
                        assert torch.equal(a.long(), b.long()), \
                            (mode, Np, d, cmask is not None)
                if mode == "full":
                    assert bool(got[2].all()) and not bool(got[1].any())


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    st = random_state(np.random.default_rng(0), 4, 16, 2, "random", cuda)
    bad_dtype = [st[0].double()] + st[1:10]
    with pytest.raises(ValueError, match="loads"):
        ops.fitscore_select(*bad_dtype, policy="first_fit")
    strided = st[:1] + [st[1].t().contiguous().t()] + st[2:10]
    with pytest.raises(ValueError, match="counts"):
        ops.fitscore_select(*strided, policy="first_fit")
    with pytest.raises(ValueError, match="not a select policy"):
        ops.fitscore_select(*st[:10], policy="cbd")
    mixed = st[:1] + [st[1].cpu()] + st[2:10]
    with pytest.raises(ValueError, match="counts"):
        ops.fitscore_select(*mixed, policy="first_fit")


def _quantized(seed, n, d):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 24, (n, d)) / 64.0
    arr = np.sort(rng.integers(0, 50000, n)).astype(float)
    dur = rng.integers(10, 5000, n).astype(float)
    return Instance(sizes, arr, arr + dur, f"q{seed}").sorted_by_arrival()


@pytest.fixture(scope="module")
def lanes():
    insts = [_quantized(1, 60, 2), _quantized(2, 100, 4),
             _quantized(3, 40, 3)]
    batch = pack_instances(insts)
    preds = []
    for i in insts:
        noisy = i.durations * np.random.default_rng(7).choice(
            [0.5, 1.0, 2.0], i.n_items)
        preds.append(np.stack([i.durations, noisy]))
    pdeps = pad_predictions(batch, preds)
    return batch, pdeps, _flatten_lanes(
        batch.sizes, batch.times, batch.kinds, batch.items, pdeps,
        batch.dmask, batch.arrivals, batch.pdeps, batch.n_items)


@pytest.mark.parametrize("policy", SELECT_POLICIES)
def test_replay_on_card_equals_cpu(policy, lanes, cuda):
    *_, flat = lanes
    ops.launches.clear()
    torchsim.counters.clear()
    got = torchsim._replay_batch(*flat, policy=policy, max_bins=16,
                                 device=cuda)
    assert ops.launches["fitscore_select"] == \
        torchsim.counters["scan_steps"] == flat[1].shape[1]
    ref = torchsim._replay_batch(*flat, policy=policy, max_bins=16,
                                 device="cpu")
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


def test_overflow_ladder_on_card_equals_cpu(lanes, cuda):
    batch, pdeps, _ = lanes
    a = run_batch(batch, "best_fit_l2", pdeps, max_bins=1, device=cuda)
    b = run_batch(batch, "best_fit_l2", pdeps, max_bins=1, device="cpu")
    for f in ("usage_time", "n_bins_opened", "overflowed", "max_bins"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("policy", SELECT_POLICIES)
def test_warp_select_equals_select_ref(policy, cuda):
    """The warp route (one warp a lane) at every slot count it takes a
    thread 1, 2 or 8 slots of, pools that are not a multiple of 32, one
    lane and more lanes than a CTA holds; the cta kernel on the same
    inputs too, through ``ops.select_launcher``."""
    rng = np.random.default_rng(40 + SELECT_POLICIES.index(policy))
    for mode in ("random", "ties"):
        for Np in (1, 31, 32, 64, 100, 256):
            for L in (1, 28, 56):
                st = random_state(rng, L, Np, 5, mode, cuda)
                for cmask in (None, st[10]):
                    n0 = ops.launches["fitscore_select_warp"]
                    got = ops.fitscore_select(*st[:10], cmask, policy=policy)
                    assert ops.launches["fitscore_select_warp"] == n0 + 1
                    ref = select_ref(*st[:10], cmask, policy=policy)
                    launch, cta = ops.select_launcher(
                        *st[:10], cmask, policy=policy, route="cta")
                    launch()
                    for a, b, c in zip(got, ref, cta):
                        assert torch.equal(a.long(), b.long()), \
                            (mode, Np, L, cmask is not None)
                        assert torch.equal(c.long(), b.long()), \
                            (mode, Np, L, cmask is not None, "cta")


@pytest.mark.parametrize("Np", [257, 1024])
def test_cta_select_equals_select_ref_above_256_slots(Np, cuda):
    rng = np.random.default_rng(Np)
    for policy in SELECT_POLICIES:
        for mode in ("random", "ties", "full"):
            st = random_state(rng, 28, Np, 5, mode, cuda)
            for cmask in (None, st[10]):
                n0 = dict(ops.launches)
                got = ops.fitscore_select(*st[:10], cmask, policy=policy)
                assert ops.launches["fitscore_select_cta"] == \
                    n0.get("fitscore_select_cta", 0) + 1
                assert ops.launches["fitscore_select_warp"] == \
                    n0.get("fitscore_select_warp", 0)
                ref = select_ref(*st[:10], cmask, policy=policy)
                for a, b in zip(got, ref):
                    assert torch.equal(a.long(), b.long()), \
                        (policy, mode, cmask is not None)


def test_warp_route_refuses_a_pool_above_256_slots(cuda):
    st = random_state(np.random.default_rng(0), 4, 257, 2, "random", cuda)
    with pytest.raises(ValueError, match="warp kernel takes 1 to 256"):
        ops.select_launcher(*st[:10], policy="first_fit", route="warp")


def _replay_counted(flat, policy, cuda, migrate, window):
    """``_replay_batch`` on the card with ``STEP_WINDOW = window``: its
    outputs and final carry, and the launches it counted."""
    old = torchsim.STEP_WINDOW
    torchsim.STEP_WINDOW = window
    try:
        ops.launches.clear()
        torchsim.counters.clear()
        out = torchsim._replay_batch(*flat, policy=policy, max_bins=16,
                                     device=cuda, return_carry=True,
                                     migrate=migrate)
        torch.cuda.synchronize()
    finally:
        torchsim.STEP_WINDOW = old
    return out, dict(ops.launches), torchsim.counters["scan_steps"]


@pytest.mark.parametrize("migrate", [False, True])
@pytest.mark.parametrize("policy", ["best_fit_l2", "cbdt", "hybrid", "ppe",
                                    "la_geometric", "adaptive"])
def test_graphed_replay_equals_eager_on_card(policy, migrate, lanes, cuda):
    """The per-event replay in windows of 16 steps replayed as CUDA graphs
    (``torchsim.replay_windows``) == the eager loop on the card, outputs
    and final carry bit for bit; the launches counted once a replay equal
    the eager loop's, one capture, a graph replay a full window past the
    first."""
    from chip_smoke import with_migrations
    *_, flat = lanes
    if migrate:
        flat = with_migrations(tuple(np.asarray(a) for a in flat), 5)
    E = flat[1].shape[1]
    eager, want, steps = _replay_counted(flat, policy, cuda, migrate, E)
    assert "replay_step_graph" not in want and steps == E
    got, have, steps = _replay_counted(flat, policy, cuda, migrate, 16)
    sched = torchsim.step_windows(E, 16)
    assert have == dict(
        want, replay_step_capture=1,
        replay_step_graph=sum(h in ("capture", "replay") for *_, h in sched))
    assert steps == E and have["fitscore_select"] >= E
    assert set(want) - {"fitscore_select"} == {"fitscore_select_warp"}
    for a, b in zip(got[:4], eager[:4]):
        assert torch.equal(a, b)
    carry = [(a, b) for a, b in zip(got[4][:12], eager[4][:12])]
    if len(eager[4]) > 12:
        carry += [(got[4][12][k], v) for k, v in eager[4][12].items()]
    for a, b in carry:
        assert torch.equal(a, b)


def test_graphed_replay_through_the_overflow_ladder(lanes, cuda):
    """``run_batch`` from a 1-slot pool: each rung's replay captures a
    graph of its own and releases it; the results equal the CPU's."""
    batch, pdeps, _ = lanes
    old = torchsim.STEP_WINDOW
    torchsim.STEP_WINDOW = 16
    try:
        ops.launches.clear()
        a = run_batch(batch, "nrt_prioritized", pdeps, max_bins=1,
                      device=cuda)
    finally:
        torchsim.STEP_WINDOW = old
    assert ops.launches["replay_step_capture"] > 1
    b = run_batch(batch, "nrt_prioritized", pdeps, max_bins=1, device="cpu")
    for f in ("usage_time", "n_bins_opened", "overflowed", "max_bins"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("policy", ["best_fit_l2", "cbd", "hybrid", "ppe",
                                    "la_binary", "adaptive"])
def test_traced_graphed_replay_equals_eager_traced(policy, lanes, cuda):
    """``trace_level=2`` on the card: the windows of 16 traced steps
    replayed as CUDA graphs write the same trace as the eager traced loop
    (their step counter lives on the device), and the same outputs as the
    untraced replay; the traced run still replays graphs."""
    *_, flat = lanes
    E = flat[1].shape[1]
    old = torchsim.STEP_WINDOW
    try:
        outs = {}
        for window in (E, 16):
            torchsim.STEP_WINDOW = window
            ops.launches.clear()
            outs[window] = torchsim._replay_batch(
                *flat, policy=policy, max_bins=16, device=cuda,
                trace_level=2)
            torch.cuda.synchronize()
        assert ops.launches["replay_step_graph"] > 1
    finally:
        torchsim.STEP_WINDOW = old
    plain = torchsim._replay_batch(*flat, policy=policy, max_bins=16,
                                   device=cuda)
    eager, graphed = outs[E], outs[16]
    for a, b, c in zip(graphed[:4], eager[:4], plain):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert graphed[4].keys() == eager[4].keys()
    for k, v in eager[4].items():
        assert torch.equal(graphed[4][k], v), k
    assert torch.equal(graphed[4]["open_bins"],
                       graphed[4]["alive"].sum(dim=2, dtype=torch.int32))


def _block_case(policy, flat, max_bins, device, prefix=48):
    """Streams, kernel arguments and a mid-replay packed carry (the first
    ``prefix`` events replayed) of one policy on ``device``."""
    ev_i, ev_f, ev_size, dmask, fam, d = torchsim._event_streams(
        policy, *flat, None)
    kw = torchsim.replay_block_kwargs(policy, max_bins, d)
    ev = [a.to(device) for a in (ev_i, ev_f, ev_size, dmask)]
    carry = torchsim.packed_init_carry(fam, flat[0].shape[0],
                                       flat[0].shape[1], max_bins, device)
    ops.replay_chunk(carry, ev[0][:, :, :prefix], ev[1][:, :, :prefix],
                     ev[2][:, :prefix], ev[3], block_events=prefix, **kw)
    return carry, ev, kw


@pytest.mark.parametrize("policy", torchsim.SCAN_POLICIES)
def test_megakernel_equals_replay_block_ref(policy, lanes, cuda):
    """One launch (and one plain block) from the same mid-replay carry,
    the 136 events before the block replayed, T = 1 and T = 64 past the
    end of two of the three lanes (PAD): every carry array equal."""
    *_, flat = lanes
    for T in (1, 64):
        carry, (ev_i, ev_f, ev_size, dmask), kw = _block_case(
            policy, flat, 16, cuda, prefix=136)
        plain = {k: v.clone() for k, v in carry.items()}
        blk = slice(136, 136 + T)
        n0 = ops.launches["fitscore_replay_block"]
        ops.fitscore_replay_block(carry, ev_i[:, :, blk], ev_f[:, :, blk],
                                  ev_size[:, blk], dmask, **kw)
        assert ops.launches["fitscore_replay_block"] == n0 + 1
        fk.replay_block_ref(plain, ev_i[:, :, blk], ev_f[:, :, blk],
                            ev_size[:, blk], dmask, **kw)
        for k in carry:
            assert torch.equal(carry[k], plain[k]), (T, k)


@pytest.mark.parametrize("policy", ["best_fit_l2", "cbdt", "hybrid",
                                    "ppe_modified", "la_binary",
                                    "adaptive"])
def test_blocked_replay_on_card_equals_cpu(policy, lanes, cuda):
    *_, flat = lanes
    ops.launches.clear()
    torchsim.counters.clear()
    got = torchsim._replay_batch(*flat, policy=policy, max_bins=16,
                                 device=cuda, block_events=32)
    E = flat[1].shape[1]
    assert ops.launches["fitscore_replay_block"] == \
        torchsim.counters["replay_blocks"] == -(-E // 32)
    assert ops.launches["fitscore_select"] == 0
    ref = torchsim._replay_batch(*flat, policy=policy, max_bins=16,
                                 device="cpu")
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


def test_megakernel_wrapper_rejects_what_the_kernel_does_not_take(lanes,
                                                                  cuda):
    *_, flat = lanes
    carry, (ev_i, ev_f, ev_size, dmask), kw = _block_case(
        "rcp", flat, 16, cuda)
    ev = (ev_i[:, :, :8], ev_f[:, :, :8], ev_size[:, :8], dmask)
    bad = dict(carry, sloti=carry["sloti"].float())
    with pytest.raises(ValueError, match="sloti"):
        ops.fitscore_replay_block(bad, *ev, **kw)
    with pytest.raises(ValueError, match="carry arrays"):
        ops.fitscore_replay_block({k: v for k, v in carry.items()
                                   if k != "ron"}, *ev, **kw)
    with pytest.raises(ValueError, match="ev_i"):
        ops.fitscore_replay_block(carry, ev[0].cpu(), *ev[1:], **kw)
    with pytest.raises(ValueError, match="slots"):
        ops.fitscore_replay_block(carry, *ev, **dict(kw, n=17))


@pytest.mark.parametrize("policy", ["nrt_prioritized", "cbd", "hybrid",
                                    "ppe", "rcp_modified", "la_geometric",
                                    "adaptive"])
def test_migrate_megakernel_equals_plain(policy, lanes, cuda):
    """The megakernel with its MIGRATE branch against
    ``replay_block_ref(migrate=True)`` on blocks that open with MIGRATE
    events (T = 1, 8 and 64 past the end of two lanes): every carry array
    equal; the launch counts under ``fitscore_replay_block_migrate``."""
    *_, flat = lanes
    rng = np.random.default_rng(5)
    for T in (1, 8, 64):
        carry, (ev_i, ev_f, ev_size, dmask), kw = _block_case(
            policy, flat, 16, cuda)
        # the carry after the first 48 events, as migrate_streams needs it
        (mi, mf, ms, _), n_close, _ = migrate_streams(policy, flat, 48, T,
                                                      carry, rng, cuda)
        assert n_close > 0
        plain = {k: v.clone() for k, v in carry.items()}
        blk = slice(48, 48 + T)
        n0 = ops.launches["fitscore_replay_block_migrate"]
        ops.fitscore_replay_block(carry, mi[:, :, blk], mf[:, :, blk],
                                  ms[:, blk], dmask, migrate=True, **kw)
        assert ops.launches["fitscore_replay_block_migrate"] == n0 + 1
        fk.replay_block_ref(plain, mi[:, :, blk], mf[:, :, blk], ms[:, blk],
                            dmask, migrate=True, **kw)
        for k in carry:
            assert torch.equal(carry[k], plain[k]), (T, k)


def test_consolidated_replay_on_card_equals_cpu(lanes, cuda):
    """The consolidating driver on the card, per event and blocked, == on
    the CPU: usage, opened bins, placements and the MIGRATE events."""
    from repro_torch.consolidate import ConsolidationSpec, \
        consolidated_replay
    *_, flat = lanes
    spec = ConsolidationSpec.parse("underload:t0.5:e16")
    for policy in ("best_fit_l2", "ppe", "adaptive"):
        want = consolidated_replay(*flat, policy=policy, max_bins=16,
                                   device="cpu", spec=spec)
        assert want[4]["migrations"].sum() > 0
        for T in (0, 8):
            got = consolidated_replay(*flat, policy=policy, max_bins=16,
                                      device=cuda, block_events=T, spec=spec)
            for a, b in zip(got[:4], want[:4]):
                assert torch.equal(a.cpu(), b), (policy, T)
            assert got[4]["events"] == want[4]["events"]


# (L, Np) of the route tests: both routes (warp up to 256 slots, global
# above), pools that are not a multiple of 32, one lane, and more lanes
# than the card has SMs
ROUTE_SHAPES = [(1, 31), (56, 64), (140, 128), (56, 256), (1, 257),
                (140, 300), (56, 100)]
_route_lanes = {}


def _lanes_of(L, d):
    if (L, d) not in _route_lanes:
        _route_lanes[(L, d)] = synthetic_lanes(
            np.random.default_rng(100 + L + d), L, d, n_max=200)
    return _route_lanes[(L, d)]


def _fail(msg):
    raise AssertionError(msg)


def _routes_equal_plain(carry, blk, dmask, kw, migrate, what):
    """``chip_smoke.check_routes``, failing the test where it finds a
    difference or a launch the wrapper did not count.  Returns the routes
    run."""
    return check_routes(carry, blk, dmask, kw, what, migrate=migrate,
                        on_fail=_fail)[0]


@pytest.mark.parametrize("migrate", [False, True])
@pytest.mark.parametrize("policy", torchsim.SCAN_POLICIES)
def test_megakernel_routes_equal_replay_block_ref(policy, migrate, cuda):
    """Every policy, with and without the MIGRATE branch (then on blocks
    that open with MIGRATE events), T in {1, 8, 256}, (L, Np) cycling
    through ``ROUTE_SHAPES`` and d through {2, 4, 5}: both routes' kernels
    == ``replay_block_ref`` from the same mid-replay carry."""
    pi = torchsim.SCAN_POLICIES.index(policy)
    rng = np.random.default_rng(pi)
    routes = set()
    for ti, T in enumerate((1, 8, 256)):
        L, Np = ROUTE_SHAPES[(3 * pi + ti + int(migrate)) % len(ROUTE_SHAPES)]
        d = (2, 4, 5)[(pi + ti) % 3]
        flat = _lanes_of(L, d)
        E = flat[1].shape[1]
        (ev_i, ev_f, ev_size, dmask), fam, _ = padded_streams(
            policy, flat, T, cuda)
        kw = torchsim.replay_block_kwargs(policy, Np, d)
        start = E // 2 if T < 256 else E - T // 2
        carry = torchsim.packed_init_carry(fam, L, flat[0].shape[1], Np,
                                           cuda)
        ops.fitscore_replay_block(carry, ev_i[:, :, :start],
                                  ev_f[:, :, :start], ev_size[:, :start],
                                  dmask, **kw)
        if migrate:
            (ev_i, ev_f, ev_size, _), _, _ = migrate_streams(
                policy, flat, start, T, carry, rng, cuda)
        blk = slice(start, start + T)
        routes.update(_routes_equal_plain(
            carry, (ev_i[:, :, blk], ev_f[:, :, blk], ev_size[:, blk]),
            dmask, kw, migrate, (L, Np, d, T)))
    assert routes == {"warp", "global"}


HAZARD_POLICIES = ("first_fit", "nrt_prioritized", "cbd",
                   "hybrid_direct_sum", "ppe", "rcp", "la_geometric",
                   "adaptive")


@pytest.mark.parametrize("name,policy", [
    (n, p) for n in HAZARDS for p in HAZARD_POLICIES
    if n != "convert_then_depart" or p in ("ppe", "rcp")])
def test_megakernel_hazards_equal_replay_block_ref(name, policy, cuda):
    """The warp kernel's hazards (``chip_smoke.HAZARDS``, the blocks the
    CPU tests hold the plain version to the reference's interpret-mode
    megakernel on) through both routes: every carry array equal."""
    carry, blk, dmask, kw, mig = hazard_block(name, policy)
    carry = {k: v.to(cuda) for k, v in carry.items()}
    assert _routes_equal_plain(carry, [a.to(cuda) for a in blk],
                               dmask.to(cuda), kw, mig, name) == \
        ["warp", "global"]


@pytest.mark.parametrize("policy", ["greedy", "cbdt", "reduced_hybrid",
                                    "rcp_modified", "la_binary",
                                    "adaptive"])
def test_warp_kernel_block_of_several_tiles(policy, cuda):
    """A block of 600 events is three tiles of the warp kernel's shared
    memory (256, 256, 88): the rows the first tiles' commits write reach
    the later tiles' departures through itemi; a whole replay in such
    blocks == the plain version's."""
    flat = _lanes_of(56, 4)
    E = flat[1].shape[1]
    T = 600
    (ev_i, ev_f, ev_size, dmask), fam, _ = padded_streams(
        policy, flat, -(-E // T) * T - E, cuda)
    kw = torchsim.replay_block_kwargs(policy, 64, 4)
    carry = torchsim.packed_init_carry(fam, 56, flat[0].shape[1], 64, cuda)
    for b in range(0, ev_size.shape[1], T):
        _routes_equal_plain(carry, (ev_i[:, :, b:b + T], ev_f[:, :, b:b + T],
                                    ev_size[:, b:b + T]), dmask, kw, False,
                            b)


def test_warp_route_refuses_what_it_does_not_take(lanes, cuda):
    """The warp kernel takes pools of up to 256 slots and 16-byte aligned
    carries and sizes (it reads rows as float4); the wrapper raises, and
    never gives way to the other kernel."""
    *_, flat = lanes
    carry, (ev_i, ev_f, ev_size, dmask), kw = _block_case(
        "cbd", flat, 16, cuda)
    ev = (ev_i[:, :, :8], ev_f[:, :, :8], ev_size[:, :8], dmask)
    big = torchsim.packed_init_carry("cbd", 3, flat[0].shape[1], 300, cuda)
    with pytest.raises(ValueError, match="1 to 256 slots"):
        ops.replay_block_launcher(big, *ev, route="warp",
                                  **dict(kw, n=300))
    shifted = torch.empty(carry["loads"].numel() + 1, device=cuda)[1:]
    shifted = shifted.view(carry["loads"].shape)
    shifted.copy_(carry["loads"])
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.fitscore_replay_block(dict(carry, loads=shifted), *ev, **kw)


def _with_item_rows(carry, R):
    """``carry`` with ``R`` item rows, the rows past its own as a fresh
    carry holds them (no slot, aux LOC_G)."""
    big = dict(carry)
    big["itemi"] = torch.zeros(carry["itemi"].shape[:1] + (R, fk.ITEMI_COLS),
                               dtype=torch.int32, device=carry["itemi"].device)
    big["itemi"][:, :, fk.ITEMI_PLACE] = -1
    big["itemi"][:, :carry["itemi"].shape[1]] = carry["itemi"]
    return big


@pytest.mark.parametrize("policy", ["rcp", "ppe_modified"])
def test_warp_kernel_bitmap_past_48kb(policy, cuda):
    """RCP's LOC_B bitmap takes a bit an item row: at 400 000 item rows the
    warp kernel's shared memory passes 48 KB (it opts in to more).  The
    conversion block, with far rows marked LOC_B that only a conversion
    reaches, through both routes == the plain version; a lane that
    converts turns them all to LOC_C."""
    carry, blk, dmask, kw, mig = hazard_block("convert_then_depart", policy)
    carry = _with_item_rows({k: v.to(cuda) for k, v in carry.items()},
                            400_000)
    carry["itemi"][:, [40_000, 350_001, 399_999], fk.ITEMI_AUX] = fk.LOC_B
    from repro_torch.kernels._build import library
    T = blk[0].shape[2]
    smem = library().fitscore_replay_block_warp_smem_bytes(
        fk.REPLAY_FAMILIES.index("rcp"), kw["n"], T, 400_000)
    assert 48 * 1024 < smem <= library().fitscore_replay_block_warp_smem_max()
    assert _routes_equal_plain(carry, [a.to(cuda) for a in blk],
                               dmask.to(cuda), kw, mig, policy) == \
        ["warp", "global"]
    far = carry["itemi"][:, [40_000, 350_001, 399_999], fk.ITEMI_AUX]
    converted = (far == fk.LOC_C).all(1)
    assert converted.any()
    assert (converted | (far == fk.LOC_B).all(1)).all()


def test_warp_route_refuses_more_item_rows_than_its_bitmap_holds(cuda):
    """Two million item rows need more shared memory than a CTA may take:
    the warp route raises, and never gives way to the global kernel."""
    carry, blk, dmask, kw, _ = hazard_block("convert_then_depart", "rcp")
    carry = _with_item_rows({k: v[:1].to(cuda) for k, v in carry.items()},
                            2_000_000)
    ev_i, ev_f, ev_size = blk
    n0 = dict(ops.launches)
    with pytest.raises(ValueError, match="item rows"):
        ops.fitscore_replay_block(carry, ev_i[:, :1].to(cuda),
                                  ev_f[:, :1].to(cuda), ev_size[:1].to(cuda),
                                  dmask[:1].to(cuda), **kw)
    assert dict(ops.launches) == n0


@pytest.mark.parametrize("norm", ["l1", "l2", "linf", "first_fit"])
def test_fitscore_kernel_equals_plain(norm, cuda):
    """The legacy scorer against ``fitscore_ref``, bit for bit: random
    pools, 1/64-grid pools tied across CTAs (repeated open_seq, so the row
    decides), pools where nothing fits (-1)."""
    from repro_torch.kernels.legacy import fitscore_ref
    rng = np.random.default_rng(len(norm))
    # CTA-count edges (256 bins a CTA, at most 1024 CTAs, so 262144 bins
    # before a CTA takes a second tile), ties across CTAs, rows wider than
    # the staged 8 floats, and an array that is not 16-byte aligned
    for N, d, mode in ((8, 4, "random"), (37, 2, "random"),
                       (1000, 5, "grid"), (70000, 2, "grid"),
                       (300, 3, "none"), (300000, 5, "random"),
                       (255, 1, "random"), (256, 5, "grid"),
                       (257, 5, "grid"), (262144, 5, "grid"),
                       (262145, 3, "grid"), (1000, 8, "grid"),
                       (1000, 9, "random"), (1000, 5, "unaligned")):
        rem, alive, item, oseq = legacy_inputs(
            rng, N, d, "grid" if mode == "unaligned" else mode, cuda)
        if mode == "unaligned":   # the rows one row into a larger array
            rem = torch.cat([rem[:1], rem])[1:]
            assert rem.is_contiguous() and rem.data_ptr() % 16
        for os_ in (oseq, None):
            n0 = ops.launches["fitscore"]
            s, b = ops.fitscore(rem, alive, item, os_, norm=norm)
            assert ops.launches["fitscore"] == n0 + 1
            s_p, b_p = fitscore_ref(rem, alive, item, os_, norm=norm)
            assert torch.equal(s, s_p), (N, d, mode)
            assert int(b) == int(b_p), (N, d, mode)
            if mode == "none":
                assert int(b) == -1


@pytest.mark.parametrize("n_streams", [1, 2])
def test_fitscore_counter_resets_between_calls(n_streams, cuda):
    """50 consecutive legacy scorer calls, on one stream or alternating
    between two, each equal to ``fitscore_ref``: the last CTA of a launch
    resets its stream's counter, so the next launch's last CTA is found."""
    assert legacy_back_to_back(cuda, n_streams) == []


def test_fitscore_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    rem, alive, item, _ = legacy_inputs(np.random.default_rng(0), 64, 3,
                                        "random", cuda)
    with pytest.raises(ValueError, match="alive"):
        ops.fitscore(rem, alive.int(), item)
    with pytest.raises(ValueError, match="remaining"):
        ops.fitscore(rem.double(), alive, item)
    with pytest.raises(ValueError, match="item"):
        ops.fitscore(rem, alive, item.cpu())
    with pytest.raises(ValueError, match="open_seq"):
        ops.fitscore(rem, alive, item, torch.arange(64, device=cuda))
    with pytest.raises(ValueError, match="norm"):
        ops.fitscore(rem, alive, item, norm="l3")


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _attn_inputs(seed, dev, dtype, *shapes):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in shapes]


def _assert_attn_close(got, want, dtype):
    """Within ``ATTN_TOL`` (atol and rtol) and, for bf16, within 2^-6 of
    max |plain|."""
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATTN_TOL[dtype], rtol=ATTN_TOL[dtype])
    if dtype == torch.bfloat16:
        assert float((got.float() - want.float()).abs().max()) <= \
            2.0 ** -6 * float(want.float().abs().max())


# both dtypes on both routes' head dims, then the tensor-core route's
# cases: lengths around its 64-key and 128-row tiles, keys beyond the
# queries, two batch rows; G = 5 as on the serving path; at hd 192 and 256
# G = 12 (nemotron-4-340b's) and G = 2 (gemma3-12b's), Sq = 1 too
FLASH_CASES = [
    (dtype, *shape) for dtype in (torch.float32, torch.bfloat16)
    for shape in ((2, 128, 128, 4, 2, 64), (2, 100, 100, 2, 1, 32),
                  (1, 64, 192, 4, 2, 128), (1, 96, 96, 8, 8, 16),
                  (2, 77, 77, 40, 8, 128), (1, 40, 50, 6, 2, 256),
                  (1, 33, 33, 3, 1, 200))] + [
    (torch.bfloat16, *shape, hd) for hd in (64, 128)
    for shape in [(1, s, s, 10, 2) for s in (1, 63, 64, 65, 127, 129, 511)]
    + [(1, 64, 192, 4, 2), (2, 129, 129, 10, 2)]] + [
    (torch.bfloat16, *shape, hd) for hd in (192, 256)
    for shape in [(1, 1, 1, 24, 2), (2, 1, 70, 24, 2), (1, 65, 65, 24, 2),
                  (1, 130, 130, 24, 2), (2, 77, 300, 24, 2),
                  (1, 300, 300, 16, 8)]]


@pytest.mark.parametrize("dtype,B,Sq,Skv,H,KV,hd", FLASH_CASES)
def test_flash_kernel_equals_plain(B, Sq, Skv, H, KV, hd, dtype, cuda):
    """Each call takes the kernel ``flash_route`` names (bf16 at hd 64 /
    128 / 192 / 256 the tensor-core one, every other call the CUDA-core
    one) and equals the plain version; bf16 also within 2^-6 of max
    |plain|."""
    from repro_torch.kernels.attention import flash_attention_ref
    q, k, v = _attn_inputs(Sq + H, cuda, dtype, (B, Sq, H, hd),
                           (B, Skv, KV, hd), (B, Skv, KV, hd))
    sm90 = int(ops.flash_route(dtype, hd) == "sm90")
    for causal, window in ((True, 0), (True, 32), (False, 0), (False, 16)):
        n0, n90 = ops.launches["flash_attention"], \
            ops.launches["flash_attention_sm90"]
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        assert ops.launches["flash_attention"] == n0 + 1
        assert ops.launches["flash_attention_sm90"] == n90 + sm90
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        assert got.dtype == dtype
        _assert_attn_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,hd,S", [
    (2, 8, 2, 64, 512), (3, 5, 1, 32, 64), (4, 40, 8, 128, 1024),
    (3, 16, 2, 256, 100), (2, 6, 2, 100, 77)])
def test_decode_kernel_equals_plain(B, H, KV, hd, S, dtype, cuda):
    from repro_torch.kernels.attention import decode_attention_ref
    q, k, v = _attn_inputs(S + H, cuda, dtype, (B, H, hd), (B, S, KV, hd),
                           (B, S, KV, hd))
    kv_len = torch.tensor([S, 0, 1, 13][:B], dtype=torch.int32,
                          device=cuda)
    k[1:, S // 2:] = float("nan")      # past kv_len of rows 1..: unread
    v[1:, S // 2:] = float("nan")
    n0 = _counts()
    got = ops.decode_attention(q, k, v, kv_len)
    d = _since(n0)
    assert d["decode_attention"] == 1
    assert d["decode_attention_mma"] == int(dtype == torch.bfloat16)
    want = decode_attention_ref(q, k, v, kv_len)
    assert float(got[1].abs().max()) == 0.0
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATTN_TOL[dtype], rtol=ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,hd,S", [
    (6, 40, 8, 128, 1024), (6, 40, 8, 128, 1000), (6, 10, 2, 64, 700),
    (6, 16, 2, 256, 333)])
def test_decode_kernel_at_split_edges(B, H, KV, hd, S, dtype, cuda):
    """kv_len one before, at and one past a split's edge, 0, S, and the
    last split's first position, with S not always a multiple of the
    split; NaN past kv_len is never read."""
    from repro_torch.kernels.attention import decode_attention_ref
    n_split, split_len = ops.decode_splits(
        B, KV, S, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert n_split > 1
    q, k, v = _attn_inputs(S + hd, cuda, dtype, (B, H, hd), (B, S, KV, hd),
                           (B, S, KV, hd))
    lens = [split_len - 1, split_len, split_len + 1, 0, S,
            (n_split - 1) * split_len + 1]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    for b, n in enumerate(lens):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    n0 = ops.launches["decode_attention"]
    got = ops.decode_attention(q, k, v, kv_len)
    assert ops.launches["decode_attention"] == n0 + 1
    assert ops.last_decode_grid == (n_split, split_len)
    want = decode_attention_ref(q, k, v, kv_len)
    assert float(got[3].abs().max()) == 0.0
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATTN_TOL[dtype], rtol=ATTN_TOL[dtype])
    # the merge's counters are left at zero: the same call again agrees
    assert torch.equal(ops.decode_attention(q, k, v, kv_len), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,hd,S", [
    (6, 32, 8, 128, 2048), (6, 16, 8, 256, 2048), (6, 96, 8, 192, 1024),
    (6, 32, 2, 64, 1500), (6, 24, 2, 128, 700)])
@pytest.mark.parametrize("window", [1, 64, 1024])
def test_decode_kernel_window_equals_plain(B, H, KV, hd, S, window, dtype,
                                           cuda):
    """A sliding window on decode (gemma3's local layers take 1024): each
    row reads [kv_len - window, kv_len); the rows outside hold NaN and
    reach nothing; a split wholly before the window is empty.  G = 4, 2,
    12, 16 and 12 on both routes' head dims."""
    from repro_torch.kernels.attention import decode_attention_ref
    n_split, split_len = ops.decode_splits(
        B, KV, S, torch.cuda.get_device_properties(cuda).multi_processor_count)
    q, k, v = _attn_inputs(S + hd + window, cuda, dtype, (B, H, hd),
                           (B, S, KV, hd), (B, S, KV, hd))
    lens = windowed_lens(S, window, split_len, B)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    for b, n in enumerate(lens):
        k[b, n:], v[b, n:] = float("nan"), float("nan")
        k[b, :max(0, n - window)] = float("nan")
        v[b, :max(0, n - window)] = float("nan")
    n0 = _counts()
    got = ops.decode_attention(q, k, v, kv_len, window=window)
    d = _since(n0)
    assert d["decode_attention"] == d["decode_attention_window"] == 1
    assert d["decode_attention_mma"] == int(dtype == torch.bfloat16)
    want = decode_attention_ref(q, k, v, kv_len, window=window)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATTN_TOL[dtype], rtol=ATTN_TOL[dtype])
    assert torch.equal(ops.decode_attention(q, k, v, kv_len, window=window),
                       got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [9, 12, 16])
@pytest.mark.parametrize("hd", [64, 128, 192, 256])
def test_decode_kernel_up_to_16_query_heads(G, hd, dtype, cuda):
    """More than 8 query heads a kv head: the tensor-core route (bf16)
    carries the tile's rows 8-15, the CUDA-core route (fp32) two row sets
    of 8; kv_len at 0, 1, a split's edge and S."""
    from repro_torch.kernels.attention import decode_attention_ref
    B, KV, S = 4, 2, 777
    q, k, v = _attn_inputs(G * hd, cuda, dtype, (B, G * KV, hd),
                           (B, S, KV, hd), (B, S, KV, hd))
    lens = [0, 1, 128, S]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    for b, n in enumerate(lens):
        k[b, n:], v[b, n:] = float("nan"), float("nan")
    n0 = _counts()
    got = ops.decode_attention(q, k, v, kv_len)
    assert _since(n0)["decode_attention_mma"] == int(dtype == torch.bfloat16)
    want = decode_attention_ref(q, k, v, kv_len)
    assert float(got[0].abs().max()) == 0.0
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATTN_TOL[dtype], rtol=ATTN_TOL[dtype])


# (B, H, KV, hd, S, window, int8, softcap): the tensor-core decode route
# above hd 128 (warps split hd in halves, 32-position chunks): nemotron's
# hd 192 at G 12 and 16, hd 200 (halves of 8 and 5 tiles of 16), gemma3's
# windowed hd 256 at G 2, over bf16 and int8 caches, with a softcap
DECODE_WIDE_CASES = [(4, 96, 8, 192, 1024, 0, False, 0.0),
                     (4, 32, 2, 192, 777, 0, False, 0.0),
                     (3, 6, 2, 200, 333, 0, False, 0.0),
                     (4, 16, 8, 256, 2048, 1024, False, 0.0),
                     (4, 16, 8, 256, 700, 0, True, 0.0),
                     (4, 16, 8, 256, 2048, 1024, True, 50.0),
                     (4, 24, 2, 256, 500, 0, False, 50.0)]


@pytest.mark.parametrize("case", range(len(DECODE_WIDE_CASES)))
def test_decode_tensor_core_route_at_hd_192_and_256(case, cuda):
    """bf16 decode above hd 128 on the tensor-core route, counted under
    ``decode_attention_mma``: kv_len at 1, a split's edge, one past it and
    S (NaN past it, and before the window), == the plain version within
    ``ATTN_TOL`` and 2^-6 of max |plain|; the merge's counters are left at
    zero, so the same call again gives the same bits."""
    from repro_torch.kernels.attention import decode_attention_ref
    B, H, KV, hd, S, window, int8, softcap = DECODE_WIDE_CASES[case]
    dtype = torch.bfloat16
    assert ops.decode_route(dtype, hd) == "mma"
    split_len = ops.decode_splits(
        B, KV, S,
        torch.cuda.get_device_properties(cuda).multi_processor_count)[1]
    q, k, v = _attn_inputs(S + hd + case, cuda, dtype, (B, H, hd),
                           (B, S, KV, hd), (B, S, KV, hd))
    lens = [1, split_len, split_len + 1, S][:B]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kw = dict(window=window, softcap=softcap)
    if int8:
        k, v, sc = _int8_cache(k, v)
        for b, n in enumerate(lens):
            sc["k_scale"][b, n:] = float("nan")
            sc["v_scale"][b, n:] = float("nan")
        kw.update(sc)
    else:
        for b, n in enumerate(lens):
            k[b, n:], v[b, n:] = float("nan"), float("nan")
            if window:
                k[b, :max(0, n - window)] = float("nan")
                v[b, :max(0, n - window)] = float("nan")
    n0 = _counts()
    got = ops.decode_attention(q, k, v, kv_len, **kw)
    d = _since(n0)
    assert d["decode_attention"] == d["decode_attention_mma"] == 1
    assert d.get("decode_attention_int8", 0) == int(int8)
    want = decode_attention_ref(q, k, v, kv_len, **kw)
    assert bool(torch.isfinite(got).all())
    _assert_attn_close(got, want, dtype)
    assert torch.equal(ops.decode_attention(q, k, v, kv_len, **kw), got)


def test_attention_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v = _attn_inputs(0, cuda, torch.float32, (1, 8, 4, 16),
                           (1, 8, 2, 16), (1, 8, 2, 16))
    kv_len = torch.full((1,), 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                            v)
    with pytest.raises(ValueError, match="k must be"):
        ops.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="k must be"):
        ops.flash_attention(q, k.to(torch.bfloat16), v.to(torch.bfloat16))
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="hd <= 256"):
        big = torch.zeros((1, 4, 2, 300), device=cuda)
        ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="kv_len"):
        ops.decode_attention(q[:, 0], k, v, kv_len.long())
    with pytest.raises(ValueError, match="at most 16"):
        qq = torch.zeros((1, 34, 16), device=cuda)
        ops.decode_attention(qq, k, v, kv_len)
    with pytest.raises(ValueError, match="window"):
        ops.decode_attention(q[:, 0], k, v, kv_len, window=-1)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_sm90_route_rejects_tensors_tma_cannot_read(which, cuda):
    """bf16 at hd 128 stays on the tensor-core route whatever the pointers;
    a contiguous tensor that is not 16-byte aligned raises before any
    launch."""
    t = dict(zip("qkv", _attn_inputs(1, cuda, torch.bfloat16, (1, 8, 4, 128),
                                     (1, 8, 2, 128), (1, 8, 2, 128))))
    buf = torch.empty(t[which].numel() + 1, dtype=torch.bfloat16,
                      device=cuda)
    t[which] = buf[1:].view(t[which].shape).copy_(t[which])
    assert t[which].is_contiguous() and t[which].data_ptr() % 16
    n0 = ops.launches["flash_attention"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention(t["q"], t["k"], t["v"])
    assert ops.launches["flash_attention"] == n0


def test_engine_on_card_equals_plain_attention(cuda):
    """The reduced model in fp32 on the card: an engine's tokens and
    logits through the kernels equal those through the plain attention
    bound in their place, within 1e-4 of max |logit|."""
    import dataclasses
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.attention import (decode_attention_ref,
                                               flash_attention_ref)
    from repro_torch.models import attention
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import ReplicaEngine
    cfg = dataclasses.replace(get_reduced_config("qwen2.5-14b"),
                              dtype="float32")
    params = init_params(cfg, seed=0, device=cuda)

    def run():
        eng = ReplicaEngine(cfg, params, slots=4, max_len=64, eos_id=-1)
        out = []
        eng._decode = (lambda f: lambda *a: (out.append(f(*a)), out[-1])[1])(
            eng._decode)
        eng.admit(1, [5, 6, 7, 8, 9], 6)
        eng.step()
        eng.admit(2, list(range(10, 40)), 5)
        while eng.n_active:
            eng.step()
        return torch.stack(out)

    ops.launches.clear()
    kern = run()
    assert ops.launches["flash_attention"] == 2 * cfg.n_layers
    assert ops.launches["decode_attention"] == kern.shape[0] * cfg.n_layers
    attention.flash_attention = flash_attention_ref
    attention.decode_attention = decode_attention_ref
    try:
        plain = run()
    finally:
        attention.flash_attention = ops.flash_attention
        attention.decode_attention = ops.decode_attention
    rel = float((kern - plain).abs().max() / plain.abs().max())
    assert rel < 1e-4


@pytest.mark.parametrize("arch", ["gemma3-12b", "minitron-8b",
                                  "nemotron-4-340b", "pixtral-12b",
                                  "whisper-medium", "granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_dense_archs_on_card_equal_plain_attention(arch, cuda):
    """The reduced configurations in fp32 on the card (gemma3's window of
    8 binding on decode, pixtral's patch prefix, whisper's encoder and
    cross calls, granite's and deepseek's MoE layers, deepseek's latent
    attention with V padded): a prefill and four decode steps through the
    kernels equal the same through the plain attention bound in their
    place, within 1e-4 of max |logit|."""
    import dataclasses
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.attention import (decode_attention_ref,
                                               flash_attention_ref)
    from repro_torch.models import attention
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import Runtime, forward, init_cache
    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    params = init_params(cfg, seed=0, device=cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 20), generator=g, device=cuda)
    kw = {}
    if cfg.frontend == "vision_stub":
        kw["frontend_embeds"] = 0.1 * torch.randn(
            (2, cfg.n_frontend_tokens, cfg.d_model), generator=g,
            device=cuda)
    if cfg.arch_kind == "encdec":
        kw["enc_embeds"] = 0.1 * torch.randn((2, 48, cfg.d_model),
                                             generator=g, device=cuda)
    S = 20 + (cfg.n_frontend_tokens if "frontend_embeds" in kw else 0)

    def run():
        cache = init_cache(cfg, 2, S + 4, device=cuda)
        out, _, _ = forward(params, cfg, Runtime(), toks, mode="prefill",
                            cache=cache, cache_pos=0, **kw)
        outs = [out[:, -1]]
        for i in range(4):
            pos = torch.tensor([S + i, S + i - 2], dtype=torch.int32,
                               device=cuda)
            out, _, _ = forward(params, cfg, Runtime(), toks[:, i:i + 1],
                                mode="decode", cache=cache, cache_pos=pos)
            outs.append(out[:, 0])
        return torch.stack(outs)

    ops.launches.clear()
    kern = run()
    enc = cfg.n_enc_layers if cfg.arch_kind == "encdec" else 0
    cross = 2 if cfg.arch_kind == "encdec" else 1
    assert ops.launches["flash_attention"] == enc + cross * cfg.n_layers
    assert ops.launches["decode_attention"] == 4 * cross * cfg.n_layers
    n_local = sum(not cfg.layer_is_global(i) for i in range(cfg.n_layers))
    assert ops.launches["decode_attention_window"] == 4 * n_local
    attention.flash_attention = flash_attention_ref
    attention.decode_attention = decode_attention_ref
    try:
        plain = run()
    finally:
        attention.flash_attention = ops.flash_attention
        attention.decode_attention = ops.decode_attention
    rel = float((kern - plain).abs().max() / plain.abs().max())
    assert rel < 1e-4


def _mla_inputs(seed, dev, dtype, q_shape, kv_shape, hd):
    """q, k and v of MLA's width (hd + r), V's columns past ``hd`` zero as
    ``mla_attention_block`` pads them."""
    q, k, v = _attn_inputs(seed, dev, dtype, q_shape, kv_shape, kv_shape)
    v[..., hd:] = 0
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_the_mla_shapes(dtype, cuda):
    """deepseek-v2-lite-16b's prefill: q / k 192 wide (hd 128 + rope 64),
    V zero-padded to 192, H = KV = 16, Sq = Skv = 256, causal, bf16 on the
    tensor-core route and fp32 on the CUDA-core one: == plain, and the
    padded columns of the output are exactly zero."""
    from repro_torch.kernels.attention import flash_attention_ref
    q, k, v = _mla_inputs(3, cuda, dtype, (1, 256, 16, 192),
                          (1, 256, 16, 192), 128)
    n90 = ops.launches["flash_attention_sm90"]
    got = ops.flash_attention(q, k, v, causal=True)
    assert ops.launches["flash_attention_sm90"] == \
        n90 + int(dtype == torch.bfloat16)
    want = flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATTN_TOL[dtype], rtol=ATTN_TOL[dtype])
    assert float(got[..., 128:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,hd,hd_v", [(16, 16, 192, 128),
                                          (24, 8, 64, 64)])
def test_decode_kernel_at_the_moe_shapes(H, KV, hd, hd_v, dtype, cuda):
    """Decode at B 4 over a cache of 1024: deepseek's MLA (q / k 192, V
    zero-padded past 128, G 1) and granite's GQA (hd 64, G 3), bf16 on the
    tensor-core route; kv_len at 1, a split's edge, 700 and S, NaN past
    it."""
    from repro_torch.kernels.attention import decode_attention_ref
    B, S = 4, 1024
    q, k, v = _mla_inputs(H + hd, cuda, dtype, (B, H, hd), (B, S, KV, hd),
                          hd_v)
    split_len = ops.decode_splits(
        B, KV, S,
        torch.cuda.get_device_properties(cuda).multi_processor_count)[1]
    lens = [1, split_len, 700, S]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    for b, n in enumerate(lens):
        k[b, n:], v[b, n:] = float("nan"), float("nan")
    n0 = _counts()
    got = ops.decode_attention(q, k, v, kv_len)
    assert _since(n0)["decode_attention_mma"] == int(dtype == torch.bfloat16)
    want = decode_attention_ref(q, k, v, kv_len)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATTN_TOL[dtype], rtol=ATTN_TOL[dtype])
    if hd_v < hd:
        assert float(got[..., hd_v:].abs().max()) == 0.0


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_moe_block_on_card_equals_the_dense_formula(arch, cuda):
    """The dropless dispatch on the card (reduced, fp32, deepseek renamed
    so its top-k weights stay unnormalised) against the all-experts
    formula, on 40 tokens and on a 4-token decode batch, within 1e-5 of
    max |formula|; one host sync a call."""
    import dataclasses
    from chip_smoke import host_syncs, moe_dense_formula
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32",
                              name=arch)
    params = init_params(cfg, seed=0, device=cuda)
    blk = {k: w[0] for k, w in params["layers"].items()
           if k.startswith(("router", "we_", "shared_"))}
    norm_topk = arch != "deepseek-v2-lite-16b"
    g = torch.Generator(device=cuda)
    g.manual_seed(2)
    for B, S in ((2, 20), (4, 1)):
        x = torch.randn((B, S, cfg.d_model), generator=g, device=cuda)
        syncs, (got, aux) = host_syncs(
            lambda: moe.moe_block(blk, x, cfg, norm_topk=norm_topk))
        want, want_aux = moe_dense_formula(cfg, blk, x, norm_topk)
        assert syncs == moe.HOST_SYNCS_PER_CALL
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
        assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)


def _rwkv_inputs(seed, dev, dtype, B, S, H, K, V):
    """The JAX kernel test's distributions; r, k, v in ``dtype``, logw and
    u fp32."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    r = torch.randn((B, S, H, K), generator=g, device=dev)
    k = 0.5 * torch.randn((B, S, H, K), generator=g, device=dev)
    v = torch.randn((B, S, H, V), generator=g, device=dev)
    lw = -torch.exp(torch.randn((B, S, H, K), generator=g, device=dev))
    u = 0.1 * torch.randn((H, K), generator=g, device=dev)
    return r.to(dtype), k.to(dtype), v.to(dtype), lw, u


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,V,chunk", [
    (2, 64, 2, 16, 16, 16), (1, 48, 4, 32, 64, 16), (2, 16, 1, 8, 8, 16),
    (1, 128, 2, 64, 64, 16), (2, 50, 2, 64, 64, 16), (1, 17, 3, 64, 32, 16),
    (2, 40, 4, 16, 16, 8), (1, 511, 32, 64, 64, 16), (1, 5, 2, 64, 64, 16),
    *RWKV_CROSS_SHAPES])
def test_rwkv6_kernel_equals_plain(B, S, H, K, V, chunk, dtype, cuda):
    """Within 1e-4 atol and rtol (the JAX kernel test's tolerance), on the
    JAX kernel test's shapes, ragged lengths and the windows' and column
    blocks' edges (``RWKV_CROSS_SHAPES``)."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked_ref
    args = _rwkv_inputs(S + H, cuda, dtype, B, S, H, K, V)
    n0 = ops.launches["rwkv6_chunked"]
    y, st = ops.rwkv6_chunked(*args, chunk=chunk)
    assert ops.launches["rwkv6_chunked"] == n0 + 1
    assert ops.last_rwkv_grid[:2] == (B * H, -(-V // 16))
    want_y, want_st = rwkv6_chunked_ref(*args, chunk=chunk)
    assert y.dtype == st.dtype == torch.float32
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, want_st, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [16, 8])
def test_rwkv6_kernel_on_a_model_rank_heads_equals_plain(H, dtype, cuda):
    """rwkv6-1.6b's prefill scan on one model rank's heads: 16 of its 32
    under a model axis of 2 (``chip_smoke`` phase 23's), 8 under 4; B 1,
    S 221, K = V = 64, chunk 16, within 1e-4 atol and rtol, one CTA a (b,
    h, 16 state columns)."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked_ref
    args = _rwkv_inputs(H, cuda, dtype, 1, 221, H, 64, 64)
    n0 = ops.launches["rwkv6_chunked"]
    y, st = ops.rwkv6_chunked(*args)
    assert ops.launches["rwkv6_chunked"] == n0 + 1
    assert ops.last_rwkv_grid[:2] == (H, 4)
    want_y, want_st = rwkv6_chunked_ref(*args)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, want_st, atol=1e-4, rtol=1e-4)


def test_rwkv6_kernel_on_two_streams_equals_plain(cuda):
    """Two calls in flight on two streams, each equal to the plain version
    on its own inputs."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked_ref
    shapes = [(1, 300, 4, 64, 64, 16), (2, 77, 3, 64, 40, 8)]
    args = [_rwkv_inputs(i, cuda, torch.bfloat16, *shp[:5])
            for i, shp in enumerate(shapes)]
    main = torch.cuda.current_stream()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for st, a, shp in zip(streams, args, shapes):
        st.wait_stream(main)
        with torch.cuda.stream(st):
            outs.append(ops.rwkv6_chunked(*a, chunk=shp[5]))
    for st in streams:
        main.wait_stream(st)
    for (y, st), a, shp in zip(outs, args, shapes):
        want_y, want_st = rwkv6_chunked_ref(*a, chunk=shp[5])
        torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(st, want_st, atol=1e-4, rtol=1e-4)


def test_rwkv6_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    r, k, v, lw, u = _rwkv_inputs(0, cuda, torch.float32, 1, 16, 2, 8, 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.rwkv6_chunked(r.half(), k.half(), v.half(), lw, u)
    with pytest.raises(ValueError, match="k must be"):
        ops.rwkv6_chunked(r, k.to(torch.bfloat16), v, lw, u)
    with pytest.raises(ValueError, match="logw must be"):
        ops.rwkv6_chunked(r, k, v, lw.to(torch.bfloat16), u)
    with pytest.raises(ValueError, match="u must be"):
        ops.rwkv6_chunked(r, k, v, lw, u.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        ops.rwkv6_chunked(r.transpose(1, 2).contiguous().transpose(1, 2), k,
                          v, lw, u)
    with pytest.raises(ValueError, match="K, V <= 64"):
        big = torch.zeros((1, 16, 2, 65), device=cuda)
        ops.rwkv6_chunked(big, big, big, big, torch.zeros((2, 65),
                                                          device=cuda))
    with pytest.raises(ValueError, match="chunk <= 16"):
        ops.rwkv6_chunked(r, k, v, lw, u, chunk=32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("post,bonus,carried", [
    (True, False, False), (True, False, True), (False, True, True),
    (True, True, True), (False, False, False)])
@pytest.mark.parametrize("B,S,H,K,V,chunk", [
    (1, 221, 25, 16, 64, 16), (2, 37, 3, 16, 64, 16), (2, 40, 4, 4, 16, 8),
    (1, 300, 2, 64, 64, 16), (2, 133, 3, 20, 12, 16), (1, 70, 2, 7, 5, 8)])
def test_rwkv6_kernel_ssd_and_initial_state_equal_plain(
        B, S, H, K, V, chunk, post, bonus, carried, dtype, cuda):
    """The post-update (SSD) variant and a carried initial state, with and
    without the bonus, within 1e-4 atol and rtol: hymba's heads (H 25, K
    16, V 64) and its reduced configuration's (chunk 8), ragged S, K 64,
    a half column block and plain loads (K 7, V 5).  The post-update cases
    take one decay a head, broadcast over K, as hymba's do.  Each launch
    counts under its variant."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked_ref
    r, k, v, lw, u = _rwkv_inputs(S + K, cuda, dtype, B, S, H, K, V)
    if post:
        lw = lw[..., :1].expand(B, S, H, K).contiguous()
    g = torch.Generator(device=cuda)
    g.manual_seed(S)
    kw = dict(chunk=chunk, post_update=post, initial_state=torch.randn(
        (B, H, K, V), generator=g, device=cuda) if carried else None)
    n0 = dict(ops.launches)
    y, st = ops.rwkv6_chunked(r, k, v, lw, u if bonus else None, **kw)
    for name, want in (("rwkv6_chunked", 1), ("rwkv6_chunked_post", post),
                       ("rwkv6_chunked_s0", carried)):
        assert ops.launches[name] == n0.get(name, 0) + int(want), name
    want_y, want_st = rwkv6_chunked_ref(r, k, v, lw, u if bonus else None,
                                        **kw)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, want_st, atol=1e-4, rtol=1e-4)


def test_rwkv6_kernel_refuses_a_bad_initial_state(cuda):
    r, k, v, lw, u = _rwkv_inputs(0, cuda, torch.float32, 1, 16, 2, 8, 8)
    with pytest.raises(ValueError, match="initial_state must be"):
        ops.rwkv6_chunked(r, k, v, lw, u,
                          initial_state=torch.zeros((1, 2, 8, 7),
                                                    device=cuda))
    with pytest.raises(ValueError, match="initial_state must be"):
        ops.rwkv6_chunked(r, k, v, lw, u, initial_state=torch.zeros(
            (1, 2, 8, 8), device=cuda, dtype=torch.bfloat16))


def test_hymba_engine_on_card_equals_plain_kernels(cuda):
    """The reduced hymba in fp32 on the card, ``A_log`` and ``dt_bias``
    drawn nonzero: an engine's logits through the kernels (flash, decode
    and the chunked kernel's post-update variant) equal those through the
    plain versions bound in their place, within 1e-4 of max |logit|; a
    request prefilled into a reused slot gives a fresh engine's logits."""
    import dataclasses
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.attention import (decode_attention_ref,
                                               flash_attention_ref)
    from repro_torch.kernels.rwkv6 import rwkv6_chunked_ref
    from repro_torch.models import attention, linear_scan
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import ReplicaEngine
    cfg = dataclasses.replace(get_reduced_config("hymba-1.5b"),
                              dtype="float32")
    params = init_params(cfg, seed=0, device=cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    for name in ("A_log", "dt_bias"):
        params["layers"][name].normal_(0, 0.5, generator=g)

    def run():
        eng = ReplicaEngine(cfg, params, slots=4, max_len=64, eos_id=-1)
        out = []
        for name in ("_prefill", "_decode"):
            setattr(eng, name, (lambda f: lambda *a: (
                out.append(f(*a)), out[-1])[1])(getattr(eng, name)))
        eng.admit(1, [5, 6, 7, 8, 9], 6)
        eng.step()
        eng.admit(2, list(range(10, 40)), 5)
        while eng.n_active:
            eng.step()
        eng.admit(3, list(range(40, 60)), 1)   # slot 0 again
        fresh = ReplicaEngine(cfg, params, slots=4, max_len=64, eos_id=-1)
        fresh_out = []
        fresh._prefill = (lambda f: lambda *a: (
            fresh_out.append(f(*a)), fresh_out[-1])[1])(fresh._prefill)
        fresh.admit(3, list(range(40, 60)), 1)
        assert torch.equal(out[-1], fresh_out[-1])
        return torch.cat([o.reshape(-1) for o in out])

    ops.launches.clear()
    kern = run()
    assert ops.launches["rwkv6_chunked_post"] == 4 * cfg.n_layers
    assert ops.launches["flash_attention"] == 4 * cfg.n_layers
    linear_scan.rwkv6_chunked = rwkv6_chunked_ref
    attention.flash_attention = flash_attention_ref
    attention.decode_attention = decode_attention_ref
    try:
        plain = run()
    finally:
        linear_scan.rwkv6_chunked = ops.rwkv6_chunked
        attention.flash_attention = ops.flash_attention
        attention.decode_attention = ops.decode_attention
    rel = float((kern - plain).abs().max() / plain.abs().max())
    assert rel < 1e-4


def test_rwkv_engine_on_card_equals_plain_kernel(cuda):
    """The reduced rwkv6 model in fp32 on the card, its mixes, decay base
    and bonus drawn nonzero: an engine's logits through the kernel equal
    those through the plain version bound in its place, within 1e-4 of max
    |logit|; a request prefilled into a reused slot gives the logits of a
    fresh engine."""
    import dataclasses
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.rwkv6 import rwkv6_chunked_ref
    from repro_torch.models import linear_scan
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import ReplicaEngine
    cfg = dataclasses.replace(get_reduced_config("rwkv6-1.6b"),
                              dtype="float32")
    params = init_params(cfg, seed=0, device=cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    lay = params["layers"]
    for name in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "mix_f"):
        lay[name].uniform_(0, 1, generator=g)
    for name in ("decay_base", "bonus_u"):
        lay[name].normal_(0, 0.5, generator=g)

    def run():
        eng = ReplicaEngine(cfg, params, slots=4, max_len=64, eos_id=-1)
        out = []
        for name in ("_prefill", "_decode"):
            setattr(eng, name, (lambda f: lambda *a: (
                out.append(f(*a)), out[-1])[1])(getattr(eng, name)))
        eng.admit(1, [5, 6, 7, 8, 9], 6)
        eng.step()
        eng.admit(2, list(range(10, 40)), 5)
        while eng.n_active:
            eng.step()
        eng.admit(3, list(range(40, 60)), 1)   # slot 0 again
        fresh = ReplicaEngine(cfg, params, slots=4, max_len=64, eos_id=-1)
        fresh_out = []
        fresh._prefill = (lambda f: lambda *a: (
            fresh_out.append(f(*a)), fresh_out[-1])[1])(fresh._prefill)
        fresh.admit(3, list(range(40, 60)), 1)
        assert torch.equal(out[-1], fresh_out[-1])
        return torch.cat([o.reshape(-1) for o in out])

    ops.launches.clear()
    kern = run()
    assert ops.launches["rwkv6_chunked"] == 4 * cfg.n_layers
    assert ops.launches["flash_attention"] == 0
    linear_scan.rwkv6_chunked = rwkv6_chunked_ref
    try:
        plain = run()
    finally:
        linear_scan.rwkv6_chunked = ops.rwkv6_chunked
    rel = float((kern - plain).abs().max() / plain.abs().max())
    assert rel < 1e-4


# -------------------------------------------------------- online serving

@pytest.mark.parametrize("policy", ["best_fit_linf", "cbd", "rcp",
                                    "la_binary", "adaptive"])
@pytest.mark.parametrize("T", [1, 32, 256])
def test_serve_traffic_on_card_equals_cpu(policy, T, cuda):
    """The live carry's blocks on the card (the megakernel, double-buffered)
    place every request as the plain version on the CPU does, with the same
    fleet numbers."""
    from repro_torch.serving.dispatch import serve_traffic
    from repro_torch.serving.scheduler import ReplicaCapacity
    from repro_torch.serving.traffic import poisson_requests
    reqs = poisson_requests(300, rate=5e4, seed=3, sigma_pred=0.3)
    card, cpu = ((r.placements, r.replica_seconds, r.replicas_opened,
                  r.peak_replicas)
                 for r in (serve_traffic(reqs, policy, ReplicaCapacity(),
                                         tps=1.2e5, batch_max=T, device=dev)
                           for dev in (cuda, "cpu")))
    assert card == cpu


def test_serve_traffic_regrow_across_routes_on_card(cuda):
    """One slot a replica from an 8-slot pool: the carry regrows past 256
    slots while blocks are in flight and the launches move from the warp
    kernel to the global one; the placements equal the CPU's."""
    from repro_torch.serving.dispatch import serve_traffic
    from repro_torch.serving.scheduler import ReplicaCapacity
    from repro_torch.serving.traffic import poisson_requests
    reqs = poisson_requests(400, rate=5e4, seed=4, sigma_pred=0.3)
    g0 = ops.launches["fitscore_replay_block_global"]
    card, cpu = (serve_traffic(reqs, "best_fit_linf",
                               ReplicaCapacity(slots=1), tps=8e3,
                               batch_max=8, max_bins=8, device=dev)
                 for dev in (cuda, "cpu"))
    assert card.peak_replicas > ops.REPLAY_WARP_MAX_SLOTS
    assert ops.launches["fitscore_replay_block_global"] > g0
    assert card.placements == cpu.placements
    assert card.replica_seconds == cpu.replica_seconds


@pytest.mark.parametrize("policy,kwargs", [
    ("best_fit", {"norm": "l2"}), ("nrt_prioritized", None),
    ("cbd", {"beta": 2.0})])
def test_select_block_on_card_equals_host(policy, kwargs, cuda):
    from chip_smoke import drive_scheduler, zoo_requests
    from repro_torch.serving.scheduler import DVBPScheduler
    reqs = zoo_requests(300)
    want = drive_scheduler(DVBPScheduler(policy, policy_kwargs=kwargs,
                                         tokens_per_second=64.0), reqs)
    n0 = ops.launches["fitscore_select_block"]
    sched = DVBPScheduler(policy, policy_kwargs=kwargs,
                          tokens_per_second=64.0, select_backend="device",
                          device=cuda, select_block=True)
    assert drive_scheduler(sched, reqs) == want
    assert ops.launches["fitscore_select_block"] - n0 == len(reqs)
    assert sched.last_select_backend == "cuda_block"


# ------------------------------------------------------------ training path

TRAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _grad_rel(got, want):
    return float((got.float() - want.float()).abs().max()) / \
        float(want.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,H,KV,hd,causal,window", [
    (37, 4, 2, 64, True, 0), (70, 6, 2, 64, True, 16),
    (33, 8, 2, 128, False, 0), (65, 5, 1, 16, True, 8)])
def test_flash_gradients_through_the_kernel_equal_plain(
        Sq, H, KV, hd, causal, window, dtype, cuda):
    """On inputs that require grad the wrapper takes ``FlashAttention``:
    the kernel forward (counted), an output with a grad_fn, and gradients
    within 1e-4 (fp32) / 2e-2 (bf16) of max |plain grad| of autograd
    through ``flash_attention_ref``."""
    from repro_torch.kernels.attention import flash_attention_ref
    g = torch.Generator(device=cuda)
    g.manual_seed(Sq)
    base = [torch.randn((2, Sq, n, hd), generator=g, device=cuda).to(dtype)
            for n in (H, KV, KV)]
    do = torch.randn((2, Sq, H, hd), generator=g, device=cuda).to(dtype)
    ins = [t.clone().requires_grad_() for t in base]
    n0 = ops.launches["flash_attention"]
    out = ops.flash_attention(*ins, causal=causal, window=window)
    assert ops.launches["flash_attention"] == n0 + 1
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ins, do)
    ref = [t.clone().requires_grad_() for t in base]
    want = torch.autograd.grad(flash_attention_ref(
        *ref, causal=causal, window=window), ref, do)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert _grad_rel(a, b) <= TRAIN_TOL[dtype]
    with torch.no_grad():
        assert ops.flash_attention(*ins, causal=causal,
                                   window=window).grad_fn is None


@pytest.mark.parametrize("post,bonus,carried,dtype", [
    (False, True, False, torch.bfloat16), (False, True, True, torch.float32),
    (True, False, False, torch.float32), (True, False, True, torch.float32)])
def test_scan_gradients_through_the_kernel_equal_plain(post, bonus, carried,
                                                       dtype, cuda):
    """``ChunkedScan``: the kernel forward (counted under its variant),
    gradients of y and of the final state equal to autograd through
    ``rwkv6_chunked_ref`` within 1e-4 of max |plain grad|."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked_ref
    B, S, H, K, V = 2, 77, 3, 16, 64
    g = torch.Generator(device=cuda)
    g.manual_seed(S)
    r, k, v = (torch.randn((B, S, H, n), generator=g, device=cuda).to(dtype)
               for n in (K, K, V))
    lw = -torch.exp(torch.randn((B, S, H, K), generator=g, device=cuda))
    u = 0.1 * torch.randn((H, K), generator=g, device=cuda) if bonus \
        else None
    s0 = torch.randn((B, H, K, V), generator=g, device=cuda) if carried \
        else None
    gy = torch.randn((B, S, H, V), generator=g, device=cuda)
    gs = torch.randn((B, H, K, V), generator=g, device=cuda)
    base = [r, k, v, lw, u, s0]

    def leaves_of(ts):
        return [t for t in ts if t is not None]

    ins = [None if t is None else t.clone().requires_grad_() for t in base]
    n0 = ops.launches["rwkv6_chunked_post" if post else "rwkv6_chunked"]
    y, st = ops.rwkv6_chunked(*ins[:5], chunk=16, post_update=post,
                              initial_state=ins[5])
    assert ops.launches["rwkv6_chunked_post" if post else
                        "rwkv6_chunked"] == n0 + 1
    got = torch.autograd.grad((y, st), leaves_of(ins), (gy, gs))
    ref = [None if t is None else t.clone().requires_grad_() for t in base]
    want = torch.autograd.grad(rwkv6_chunked_ref(
        *ref[:5], chunk=16, post_update=post, initial_state=ref[5]),
        leaves_of(ref), (gy, gs))
    for a, b in zip(got, want):
        assert _grad_rel(a, b) <= 1e-4


def test_train_step_on_the_card_equals_the_cpu(cuda):
    """One ``make_train_step`` step of a tiny dense model (the JAX
    package's own training test's configuration, fp32) on the card and on
    the CPU from the same weights: the flash kernel launched twice a layer
    (the forward and remat's recompute), loss and gradient norm within
    1e-5, every parameter within 2e-5."""
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import Runtime
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.tree import leaves, unflatten
    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                      vocab=512, dtype="float32", attn_q_chunk=64)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = TokenStream(cfg.vocab, 32, 8).batch(0)
    cpu_params = init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    outs = {}
    for dev in ("cpu", cuda):
        params = unflatten(cpu_params, [p.to(dev, copy=True)
                                        for p in leaves(cpu_params)])
        step = make_train_step(cfg, Runtime(), opt)
        n0 = ops.launches["flash_attention"]
        params, _, m = step(params, init_opt_state(params, opt),
                            {k: torch.from_numpy(v).to(dev)
                             for k, v in batch.items()})
        if dev == cuda:
            assert ops.launches["flash_attention"] - n0 == 2 * cfg.n_layers
        outs[str(dev)] = (params, {k: float(v) for k, v in m.items()})
    (pc, mc), (pg, mg) = outs["cpu"], outs[str(cuda)]
    for key in ("loss", "grad_norm"):
        assert mg[key] == pytest.approx(mc[key], rel=1e-5)
    for a, b in zip(leaves(pg), leaves(pc)):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= 2e-5


def _elastic_run(parts, root, device, resume_device=None):
    """An ``ElasticTrainer`` on ``device`` failing at step 13 (checkpoints
    every 5), then one re-attached to its checkpoints on
    ``resume_device``: (the resumed first step, its last loss)."""
    from repro_torch.train.elastic import ElasticConfig, ElasticTrainer
    b = ElasticTrainer(*parts, root, ElasticConfig(ckpt_every=5))
    b.attach(device)
    with pytest.raises(RuntimeError, match="simulated node failure at 13"):
        b.run(20, fail_at=13)
    b2 = ElasticTrainer(*parts, root, ElasticConfig(ckpt_every=5))
    b2.attach(resume_device or device)
    start = b2.step
    return start, float(b2.run(20 - start)["loss"])


def _elastic_straight(parts, root, device):
    from repro_torch.train.elastic import ElasticConfig, ElasticTrainer
    a = ElasticTrainer(*parts, root, ElasticConfig(ckpt_every=5))
    a.attach(device)
    return float(a.run(20)["loss"])


def test_elastic_resume_on_the_card(cuda, tmp_path):
    """Reduced qwen2.5-14b in fp32 (4 x 32 tokens) on the card: a run that
    fails at step 13 and a trainer re-attached to its step-10 checkpoint end
    within 1e-6 of 20 straight steps (the JAX package's limit), flash
    launched twice a layer a resumed step."""
    from chip_smoke import elastic_parts
    from repro_torch.configs import get_reduced_config
    parts = elastic_parts(batch=4, seq=32)
    want = _elastic_straight(parts, str(tmp_path / "a"), cuda)
    n0 = ops.launches["flash_attention"]
    start, got = _elastic_run(parts, str(tmp_path / "b"), cuda)
    L = get_reduced_config("qwen2.5-14b").n_layers
    assert start == 10
    assert ops.launches["flash_attention"] - n0 == 2 * L * (13 + 10)
    assert got == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("fail_on,resume_on", [("cuda", "cpu"),
                                               ("cpu", "cuda")])
def test_elastic_resume_across_card_and_cpu(cuda, tmp_path, fail_on,
                                            resume_on):
    """A run that fails on one device resumes from its step-10 checkpoint on
    the other: its last loss within 1e-5 relative (the train step's fp32
    limit) of 20 straight steps on the first device."""
    from chip_smoke import elastic_parts
    parts = elastic_parts(batch=4, seq=32)
    want = _elastic_straight(parts, str(tmp_path / "a"), fail_on)
    start, got = _elastic_run(parts, str(tmp_path / "b"), fail_on,
                              resume_on)
    assert start == 10
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compress_allreduce_on_the_card_equals_the_cpu(cuda, tmp_path,
                                                       dtype):
    """``compress_allreduce`` on a one-rank gloo group over hymba-1.5b's
    leaves (one layer of its stacks): the reduced gradients and the new
    errors on the card equal the CPU's bit for bit."""
    import torch.distributed as dist
    from chip_smoke import compress_inputs
    from repro_torch.train.grad_compress import compress_allreduce
    from repro_torch.train.tree import leaves, unflatten
    g, e = compress_inputs(cuda, layers=1)
    g = unflatten(g, [x.to(dtype) for x in leaves(g)])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        got = compress_allreduce(g, e)
        want = compress_allreduce(*(unflatten(t, [x.cpu() for x in
                                                  leaves(t)])
                                    for t in (g, e)))
    finally:
        dist.destroy_process_group()
    for a, b in zip(leaves(got), leaves(want)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)


_TP_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_reduced_config
from repro_torch.launch.mesh import join, make_mesh
from repro_torch.models import params as P_
from repro_torch.models.sharding import (ShardingRules, shard_tree,
                                         tree_placements)
from repro_torch.models.transformer import Runtime, forward, init_cache
rank, store, out, arch = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    sys.argv[4]
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
join(rank, 2, store, backend="gloo", device="cuda", timeout=120)
try:
    mesh = make_mesh((1, 2), ("data", "model"), "cuda")
    cfg = get_reduced_config(arch)
    rt = Runtime(mesh=mesh, rules=ShardingRules())
    params = shard_tree(P_.init_params(cfg, seed=0, device="cuda"),
                        tree_placements(cfg, mesh, rt.rules), mesh)
    toks = torch.from_numpy(np.load(out + ".tokens.npy")).cuda()
    kw = {}
    if cfg.arch_kind == "encdec":
        kw["enc_embeds"] = torch.from_numpy(
            np.load(out + ".frames.npy")).cuda().to(torch.bfloat16)
    cache = init_cache(cfg, toks.shape[0], toks.shape[1], device="cuda",
                       mesh=mesh, rules=rt.rules)
    logits = forward(params, cfg, rt, toks, mode="prefill", cache=cache,
                     cache_pos=0, **kw)[0]
    if rank == 0:
        np.save(out + ".logits.npy", logits.float().cpu().numpy())
finally:
    dist.destroy_process_group()
"""


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "rwkv6-1.6b", "hymba-1.5b",
                                  "whisper-medium"])
def test_tp_prefill_over_gloo_on_one_card_equals_one_rank(cuda, tmp_path,
                                                          arch):
    """Two gloo ranks on one card run a reduced configuration's prefill on
    a (1, 2) mesh (the sharded cache, the kernels on each rank's heads:
    RWKV6's time mix and state, hymba's SSD heads, whisper's encoder and
    cross-attention over 24 stub frames): its logits equal the one-rank
    run's on the card within 2e-2 of max |logit| (bf16, the kernels'
    tolerance)."""
    import subprocess
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import params as P_
    from repro_torch.models.transformer import Runtime, forward, init_cache
    cfg = get_reduced_config(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 37))
    base = str(tmp_path / "run")
    np.save(base + ".tokens.npy", toks)
    kw = {}
    if cfg.arch_kind == "encdec":
        frames = (0.1 * rng.standard_normal((2, 24, cfg.d_model))).astype(
            np.float32)
        np.save(base + ".frames.npy", frames)
        kw["enc_embeds"] = torch.from_numpy(frames).to(cuda).to(
            torch.bfloat16)
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.path.join(root, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _TP_RANK, str(r),
                               f"file://{tmp_path}/pg", base, arch], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    got = torch.from_numpy(np.load(base + ".logits.npy"))
    params = P_.init_params(cfg, seed=0, device=cuda)
    t = torch.from_numpy(toks).to(cuda)
    want = forward(params, cfg, Runtime(), t, mode="prefill",
                   cache=init_cache(cfg, 2, 37, device=cuda),
                   cache_pos=0, **kw)[0].float().cpu()
    assert float((got - want).abs().max() / want.abs().max()) < 2e-2


def test_nccl_refuses_two_ranks_on_one_card(cuda, monkeypatch):
    """``join`` with NCCL where a host's ranks outnumber its cards raises,
    naming the gloo way out, before any group exists; it never swaps in
    gloo itself."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import join
    monkeypatch.setenv("LOCAL_WORLD_SIZE",
                       str(torch.cuda.device_count() + 1))
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one "
                                         "card.*backend='gloo'"):
        join(0, 2, "file:///nonexistent/pg", backend="nccl")
    assert not dist.is_initialized()


# ------------------------------------------------- the attention module's rest

def _cache_with_nan(k, v, lens):
    """NaN in the cache rows past each row's key bound: never read."""
    for b, n in enumerate(lens):
        k[b, n:], v[b, n:] = float("nan"), float("nan")


def _counts():
    return dict(ops.launches)


def _since(before):
    """The launches counted since ``before`` (a ``_counts()``)."""
    return collections.Counter({k: v - before.get(k, 0)
                                for k, v in ops.launches.items()})


def _int8_cache(k, v):
    """An int8 cache of k and v (the model's ``quant_kv``) with its
    scales."""
    from repro_torch.models.attention import quant_kv
    (kq, ks), (vq, vs) = quant_kv(k), quant_kv(v)
    return kq, vq, dict(k_scale=ks, v_scale=vs)


# (B, Sq, Smax, H, KV, hd): the tensor-core route's head dims (gemma3's
# 256 and nemotron's 192 with G 12 among them) and the CUDA-core route's
# (hd 32)
OFFSET_SHAPES = [(3, 70, 300, 10, 2, 64), (2, 129, 400, 8, 2, 128),
                 (2, 37, 100, 6, 2, 32), (2, 40, 200, 4, 2, 256),
                 (2, 70, 333, 24, 2, 192), (1, 130, 500, 16, 8, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Smax,H,KV,hd", OFFSET_SHAPES)
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (48, 0.0), (0, 50.0),
                                            (48, 5.0)])
def test_flash_at_an_offset_equals_plain(B, Sq, Smax, H, KV, hd, window,
                                         softcap, dtype, cuda):
    """A chunked prefill: queries at a scalar offset and at per-row
    offsets over a cache of Smax rows bounded by ``kv_len = offset + Sq``
    (NaN past it), with and without a window and a softcap, on the route
    ``flash_route`` names; == the plain version, counted under
    ``flash_attention_offset`` (and ``_softcap``)."""
    from repro_torch.kernels.attention import flash_attention_ref
    q, k, v = _attn_inputs(Sq + hd, cuda, dtype, (B, Sq, H, hd),
                           (B, Smax, KV, hd), (B, Smax, KV, hd))
    offs = [Smax - Sq - 7 * b for b in range(B)]
    for q_offset in (offs[0], torch.tensor(offs, dtype=torch.int32,
                                           device=cuda)):
        per_row = isinstance(q_offset, torch.Tensor)
        lens = [o + Sq for o in (offs if per_row else [offs[0]] * B)]
        kk, vv = k.clone(), v.clone()
        _cache_with_nan(kk, vv, lens)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
        n0 = _counts()
        got = ops.flash_attention(q, kk, vv, window=window,
                                  q_offset=q_offset, kv_len=kv_len,
                                  softcap=softcap)
        d = _since(n0)
        assert d["flash_attention"] == d["flash_attention_offset"] == 1
        assert d["flash_attention_sm90"] == int(
            ops.flash_route(dtype, hd) == "sm90")
        assert d["flash_attention_softcap"] == int(softcap > 0)
        want = flash_attention_ref(q, kk, vv, window=window,
                                   q_offset=q_offset, kv_len=kv_len,
                                   softcap=softcap)
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=ATTN_TOL[dtype], rtol=ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 192, 256])
@pytest.mark.parametrize("offset,window,softcap", [(0, 0, 0.0),
                                                   (90, 0, 0.0),
                                                   (90, 32, 30.0)])
def test_flash_over_an_int8_cache_equals_plain(hd, offset, window, softcap,
                                               dtype, cuda):
    """An int8 cache (``quant_kv``'s rows, NaN scales past the bound): the
    CUDA-core route whatever the dtype and head dim, counted under
    ``flash_attention_int8``; == the plain version over the dequantized
    rows."""
    from repro_torch.kernels.attention import flash_attention_ref
    B, Sq, Smax, H, KV = 2, 60, 256, 8, 2
    q, k, v = _attn_inputs(hd + offset, cuda, dtype, (B, Sq, H, hd),
                           (B, Smax, KV, hd), (B, Smax, KV, hd))
    kq, vq, sc = _int8_cache(k, v)
    sc["k_scale"][:, offset + Sq:] = float("nan")
    sc["v_scale"][:, offset + Sq:] = float("nan")
    assert ops.flash_route(dtype, hd, int8=True) == "simt"
    n0 = _counts()
    kw = dict(window=window, q_offset=offset, kv_len=offset + Sq,
              softcap=softcap, **sc)
    got = ops.flash_attention(q, kq, vq, **kw)
    d = _since(n0)
    assert d["flash_attention"] == d["flash_attention_int8"] == 1
    assert d.get("flash_attention_sm90", 0) == 0
    want = flash_attention_ref(q, kq, vq, **kw)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATTN_TOL[dtype], rtol=ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,hd,S", [(4, 40, 8, 128, 1024),
                                         (3, 10, 2, 64, 300),
                                         (4, 16, 8, 256, 700),
                                         (2, 6, 2, 100, 77)])
@pytest.mark.parametrize("int8,softcap,window", [
    (False, 50.0, 0), (True, 0.0, 0), (True, 50.0, 0), (True, 0.0, 64)])
def test_decode_softcap_and_int8_equal_plain(B, H, KV, hd, S, int8, softcap,
                                             window, dtype, cuda):
    """Decode with a softcap and over an int8 cache (the tensor-core route
    for bf16, the CUDA-core one for fp32; hd 100 takes the int8 loader's
    one-byte path): == the plain version, NaN past kv_len never read, one
    launch counted under ``decode_attention_int8`` / ``_softcap`` (and
    ``_mma`` for bf16)."""
    from repro_torch.kernels.attention import decode_attention_ref
    q, k, v = _attn_inputs(S + hd, cuda, dtype, (B, H, hd), (B, S, KV, hd),
                           (B, S, KV, hd))
    lens = [S, 1, S // 2, 13][:B]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kw = dict(window=window, softcap=softcap)
    if int8:
        k, v, sc = _int8_cache(k, v)
        for b, n in enumerate(lens):
            sc["k_scale"][b, n:] = float("nan")
            sc["v_scale"][b, n:] = float("nan")
        kw.update(sc)
    else:
        _cache_with_nan(k, v, lens)
    n0 = _counts()
    got = ops.decode_attention(q, k, v, kv_len, **kw)
    d = _since(n0)
    assert d["decode_attention"] == 1
    assert d.get("decode_attention_mma", 0) == int(dtype == torch.bfloat16)
    assert d.get("decode_attention_int8", 0) == int(int8)
    assert d.get("decode_attention_softcap", 0) == int(softcap > 0)
    want = decode_attention_ref(q, k, v, kv_len, **kw)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATTN_TOL[dtype], rtol=ATTN_TOL[dtype])


# (B, Sq, Sk, H, D, Dv, offsets, kv_len): deepseek's decode at per-slot
# depths (one slot's keys in one split of eight, a key tile straddling
# kv_len), its prefill from 0 and a chunk at an offset (93 queries: not a
# multiple of the tensor-core tile's 4 positions); reduced widths at H 4
# and H 5 (a tile not filled by whole positions); H 5 at three per-row
# offsets (a row that sees one key, a tile straddling kv_len and Sk);
# kv_len below a key tile; a decode step whose splits but one hold no
# visible key; a row with no key at all
LATENT_CASES = [
    (4, 1, 1024, 16, 576, 512, [63, 64, 700, 1023], [64, 65, 701, 1024]),
    (1, 128, 221, 16, 576, 512, [0], None),
    (1, 93, 1024, 16, 576, 512, [128], [221]),
    (2, 37, 64, 4, 48, 32, [0, 20], [37, 57]),
    (3, 1, 50, 5, 40, 40, [9, 0, 49], [10, 1, 50]),
    (3, 13, 150, 5, 40, 40, [9, 0, 120], [22, 1, 133]),
    (2, 8, 200, 16, 64, 64, [10, 30], [12, 20]),
    (2, 1, 2048, 16, 576, 512, [0, 2047], [1, 2048]),
    (2, 4, 64, 8, 32, 16, [0, 5], [0, 9]),
    # deepseek's 16 heads split over 2 and 4 model ranks: 8 and 16
    # positions a tile
    (4, 1, 1024, 8, 576, 512, [63, 64, 700, 1023], [64, 65, 701, 1024]),
    (1, 93, 1024, 4, 576, 512, [128], [221])]


def _latent_case(case, dev, dtype):
    B, Sq, Sk, H, D, Dv, offs, lens = LATENT_CASES[case]
    q, lat = _attn_inputs(case + 1, dev, dtype, (B, Sq, H, D), (B, Sk, D))
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    kv_len = None
    if lens is not None:
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        for b, n in enumerate(lens):
            lat[b, n:] = float("nan")
    return q, lat, kv_len, dict(q_offset=off, hd_v=Dv, scale=192 ** -0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(LATENT_CASES)))
def test_latent_kernel_equals_plain(case, dtype, cuda):
    """The absorbed MLA's kernel: one launch on the route
    ``ops.latent_route`` names (bf16: the tensor-core kernel, counted as
    ``latent_attention_tc``; fp32: the CUDA cores), == ``latent_attention_ref``
    (NaN latent rows past the bound never read), the scale the caller's."""
    from repro_torch.kernels.attention import latent_attention_ref
    q, lat, kv_len, kw = _latent_case(case, cuda, dtype)
    B, Sq, H, _ = q.shape
    n0 = ops.launches["latent_attention"]
    tc0 = ops.launches["latent_attention_tc"]
    got = ops.latent_attention(q, lat, kv_len, **kw)
    assert ops.launches["latent_attention"] == n0 + 1
    tc = dtype == torch.bfloat16
    assert ops.launches["latent_attention_tc"] == tc0 + tc
    assert ops.last_latent_grid[0] == ("tc" if tc else "simt")
    want = latent_attention_ref(q, lat, kv_len, **kw)
    assert tuple(got.shape) == (B, Sq, H, kw["hd_v"])
    assert bool(torch.isfinite(got).all())
    _assert_attn_close(got, want, dtype)


@pytest.mark.parametrize("n_split", [1, 2, 5, 8])
@pytest.mark.parametrize("case", [0, 2, 5, 7])
def test_latent_tc_kernel_at_forced_splits_equals_plain(case, n_split, cuda,
                                                        monkeypatch):
    """The tensor-core kernel with ``ops.latent_splits`` replaced: one
    split (no merge), and 2, 5 and 8 parts of each tile's visible keys
    (clusters of that many CTAs), many of them empty, merged across the
    cluster; the call runs twice."""
    from repro_torch.kernels.attention import latent_attention_ref
    q, lat, kv_len, kw = _latent_case(case, cuda, torch.bfloat16)
    monkeypatch.setattr(ops, "latent_splits", lambda *a: n_split)
    want = latent_attention_ref(q, lat, kv_len, **kw)
    for _ in range(2):
        got = ops.latent_attention(q, lat, kv_len, **kw)
        assert ops.last_latent_grid[:2] == ("tc", n_split)
        assert bool(torch.isfinite(got).all())
        _assert_attn_close(got, want, torch.bfloat16)


def test_latent_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, lat = _attn_inputs(0, cuda, torch.float32, (1, 4, 17, 64), (1, 8, 64))
    with pytest.raises(ValueError, match="H <= 16"):
        ops.latent_attention(q, lat, hd_v=32, scale=0.1)
    q, lat = _attn_inputs(0, cuda, torch.float32, (1, 4, 4, 600), (1, 8, 600))
    with pytest.raises(ValueError, match="D <= 576"):
        ops.latent_attention(q, lat, hd_v=32, scale=0.1)
    q, lat = _attn_inputs(0, cuda, torch.float32, (1, 4, 4, 64), (1, 8, 64))
    with pytest.raises(ValueError, match="lat must be"):
        ops.latent_attention(q, lat.to(torch.bfloat16), hd_v=32, scale=0.1)
    with pytest.raises(ValueError, match="take no gradient"):
        ops.latent_attention(q.requires_grad_(), lat, 8, q_offset=1,
                             hd_v=32, scale=0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,H,KV,hd,window", [(37, 4, 2, 64, 0),
                                               (70, 6, 2, 128, 16),
                                               (33, 4, 1, 32, 0)])
def test_softcap_gradients_through_the_kernel_equal_plain(
        Sq, H, KV, hd, window, dtype, cuda):
    """``FlashAttention`` with a softcap of 5 (binding on these scores):
    the kernel forward and gradients within 1e-4 (fp32) / 2e-2 (bf16) of
    max |plain grad| of autograd through ``flash_attention_ref``."""
    from repro_torch.kernels.attention import flash_attention_ref
    g = torch.Generator(device=cuda)
    g.manual_seed(Sq)
    base = [(2.0 * torch.randn((2, Sq, n, hd), generator=g,
                               device=cuda)).to(dtype) for n in (H, KV, KV)]
    do = torch.randn((2, Sq, H, hd), generator=g, device=cuda).to(dtype)
    ins = [t.clone().requires_grad_() for t in base]
    n0 = ops.launches["flash_attention_softcap"]
    out = ops.flash_attention(*ins, window=window, softcap=5.0)
    assert ops.launches["flash_attention_softcap"] == n0 + 1
    got = torch.autograd.grad(out, ins, do)
    ref = [t.clone().requires_grad_() for t in base]
    want = torch.autograd.grad(flash_attention_ref(
        *ref, window=window, softcap=5.0), ref, do)
    for a, b in zip(got, want):
        assert _grad_rel(a, b) <= TRAIN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,H,D,Dv", [(37, 4, 48, 32), (64, 16, 576, 512)])
def test_latent_gradients_through_the_kernel_equal_plain(Sq, H, D, Dv, dtype,
                                                         cuda):
    """``LatentAttention``: the kernel forward (counted) and the gradients
    of q and the latent (its K and V parts gathered) within 1e-4 (fp32) /
    2e-2 (bf16) of max |plain grad|."""
    from repro_torch.kernels.attention import latent_attention_ref
    q, lat = _attn_inputs(Sq + D, cuda, dtype, (2, Sq, H, D), (2, Sq, D))
    do = _attn_inputs(1, cuda, dtype, (2, Sq, H, Dv))[0]
    kw = dict(hd_v=Dv, scale=192 ** -0.5)
    ins = [t.clone().requires_grad_() for t in (q, lat)]
    n0 = ops.launches["latent_attention"]
    out = ops.latent_attention(*ins, **kw)
    assert ops.launches["latent_attention"] == n0 + 1
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ins, do)
    ref = [t.clone().requires_grad_() for t in (q, lat)]
    want = torch.autograd.grad(latent_attention_ref(*ref, **kw), ref, do)
    for a, b in zip(got, want):
        assert _grad_rel(a, b) <= TRAIN_TOL[dtype]


@pytest.mark.parametrize("arch,change", [
    ("qwen2.5-14b", "int8"), ("qwen2.5-14b", "softcap"),
    ("gemma3-12b", "int8"), ("hymba-1.5b", "none"),
    ("deepseek-v2-lite-16b", "absorb"), ("deepseek-v2-lite-16b", "none")])
def test_chunked_prefill_on_card_equals_plain_attention(arch, change, cuda):
    """The reduced configurations in fp32 on the card: a prompt prefilled
    in two chunks (the second at a scalar offset), then a chunk at per-slot
    offsets and two decode steps, through the kernels and through the plain
    versions bound in their place: logits within 1e-4 of max |logit|, the
    kernels' launches counted.  The blocks apply no ``logit_softcap``, as
    the reference's pass none: no call takes a cap."""
    import dataclasses
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.attention import (decode_attention_ref,
                                               flash_attention_ref,
                                               latent_attention_ref)
    from repro_torch.models import attention
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import Runtime, forward, init_cache
    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    if change == "int8":
        cfg = dataclasses.replace(cfg, kv_cache_int8=True)
    if change == "softcap":
        cfg = dataclasses.replace(cfg, logit_softcap=2.0)
    rt = Runtime(mla_absorb=change == "absorb")
    params = init_params(cfg, seed=0, device=cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (2, 30), generator=g, device=cuda)

    def run():
        cache = init_cache(cfg, 2, 40, device=cuda)
        outs = [forward(params, cfg, rt, toks[:, :17], mode="prefill",
                        cache=cache, cache_pos=0)[0][:, -1],
                forward(params, cfg, rt, toks[:, 17:25], mode="prefill",
                        cache=cache, cache_pos=17)[0][:, -1]]
        pos = torch.tensor([25, 25], dtype=torch.int32, device=cuda)
        outs.append(forward(params, cfg, rt, toks[:, 25:28], mode="prefill",
                            cache=cache, cache_pos=pos)[0][:, -1])
        for i in range(2):
            pos = torch.tensor([28 + i, 28 + i], dtype=torch.int32,
                               device=cuda)
            outs.append(forward(params, cfg, rt, toks[:, 28 + i:29 + i],
                                mode="decode", cache=cache,
                                cache_pos=pos)[0][:, 0])
        return torch.stack(outs)

    ops.launches.clear()
    kern = run()
    L = cfg.n_layers
    if change == "absorb":
        assert ops.launches["latent_attention"] == 5 * L
    else:
        assert ops.launches["flash_attention"] >= 3 * L
        assert ops.launches["flash_attention_offset"] >= 2 * L
    assert ops.launches["flash_attention_softcap"] == 0
    assert ops.launches["decode_attention_softcap"] == 0
    saved = (attention.flash_attention, attention.decode_attention,
             attention.latent_attention)
    attention.flash_attention = flash_attention_ref
    attention.decode_attention = decode_attention_ref
    attention.latent_attention = latent_attention_ref
    try:
        plain = run()
    finally:
        (attention.flash_attention, attention.decode_attention,
         attention.latent_attention) = saved
    rel = float((kern - plain).abs().max() / plain.abs().max())
    assert rel < 1e-4
