"""The port on the card: the CUDA select and the CUDA replay megakernel
(its MIGRATE branch included) against their plain versions, the replays on
the card (per event, blocked, consolidating; the serving front end's live
carry and the scheduler's block select) against the replays on the CPU,
and the legacy scorer against its plain version, bit for bit; the two
attention kernels and the RWKV6 chunked kernel against their plain
versions within the JAX kernel tests' tolerances, and the model and engine
through them against the plain versions.

Every test here needs an NVIDIA card (marker ``cuda``) and skips with a
reason where ``torch.cuda.is_available()`` is false: the CUDA kernel has
no CPU mode.  The file imports neither JAX nor the JAX package, so it runs
on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
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
                        random_state, synthetic_lanes)
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


# both dtypes on both routes' head dims, then the tensor-core route's
# cases: lengths around its 64-key and 128-row tiles, keys beyond the
# queries, two batch rows; G = 5 as on the serving path
FLASH_CASES = [
    (dtype, *shape) for dtype in (torch.float32, torch.bfloat16)
    for shape in ((2, 128, 128, 4, 2, 64), (2, 100, 100, 2, 1, 32),
                  (1, 64, 192, 4, 2, 128), (1, 96, 96, 8, 8, 16),
                  (2, 77, 77, 40, 8, 128), (1, 40, 50, 6, 2, 256),
                  (1, 33, 33, 3, 1, 200))] + [
    (torch.bfloat16, *shape, hd) for hd in (64, 128)
    for shape in [(1, s, s, 10, 2) for s in (1, 63, 64, 65, 127, 129, 511)]
    + [(1, 64, 192, 4, 2), (2, 129, 129, 10, 2)]]


@pytest.mark.parametrize("dtype,B,Sq,Skv,H,KV,hd", FLASH_CASES)
def test_flash_kernel_equals_plain(B, Sq, Skv, H, KV, hd, dtype, cuda):
    """Each call takes the kernel ``flash_route`` names (bf16 at hd 64 /
    128 the tensor-core one, every other call the CUDA-core one) and
    equals the plain version; bf16 also within 2^-6 of max |plain|."""
    from repro_torch.kernels.attention import flash_attention_ref
    q, k, v = _attn_inputs(Sq + H, cuda, dtype, (B, Sq, H, hd),
                           (B, Skv, KV, hd), (B, Skv, KV, hd))
    tol = ATTN_TOL[dtype]
    sm90 = int(ops.flash_route(dtype, hd) == "sm90")
    for causal, window in ((True, 0), (True, 32), (False, 0), (False, 16)):
        n0, n90 = ops.launches["flash_attention"], \
            ops.launches["flash_attention_sm90"]
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        assert ops.launches["flash_attention"] == n0 + 1
        assert ops.launches["flash_attention_sm90"] == n90 + sm90
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        if dtype == torch.bfloat16:
            assert float((got.float() - want.float()).abs().max()) <= \
                2.0 ** -6 * float(want.float().abs().max())


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
    n0 = ops.launches["decode_attention"]
    got = ops.decode_attention(q, k, v, kv_len)
    assert ops.launches["decode_attention"] == n0 + 1
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
    with pytest.raises(ValueError, match="at most 8"):
        qq = torch.zeros((1, 18, 16), device=cuda)
        ops.decode_attention(qq, k, v, kv_len)


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
