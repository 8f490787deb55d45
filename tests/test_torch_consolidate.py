"""Consolidation in the port (``repro_torch.consolidate``) against the JAX
package: the spec strings, the planner, the chunked driver - per event and
event-blocked - against the reference's driver and its sequential
consolidating oracle for all 21 scan policies, the megakernel's MIGRATE
branch (plain version) against the reference's interpret-mode Pallas
megakernel per family.  ``run_batch``, ``run_sweep``, the CLI and the
frontier constants are in ``test_torch_consolidate_sweep.py``.

Instances are fp32-exact (1/64-grid sizes, integer times), so the replay's
fp32 usage must equal the oracle's float64 bit for bit; the reference's
own gates are ``tests/test_consolidate.py``."""
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.consolidate as ref_cons
import repro.kernels.fitscore as ref_fitscore
import repro.sweep as ref_sweep
from repro.core import Instance
from repro.core.jaxsim import SCAN_POLICIES, host_algorithm
from repro.sweep.runner import _flatten_lanes, instances_pdeps
import repro_torch.consolidate as port_cons
from repro_torch.core import Instance as PortInstance
from repro_torch.consolidate import driver as port_driver
from repro_torch.consolidate import planner as port_planner
from repro_torch.core import torchsim
from repro_torch.kernels import fitscore as fk
from repro_torch.kernels import ops

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the MIGRATE blocks of the card check)

torch.set_num_threads(1)

# the reference test's scenario: an underload drain every 8 events, dense
# enough that the 40-item streams below plan ~9 times and migrate
SPEC = "underload:t0.5:e8"


def qinst(seed, n=40, d=3):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 24, (n, d)) / 64.0
    arr = np.sort(rng.integers(0, 50000, n)).astype(float)
    dur = rng.integers(10, 5000, n).astype(float)
    return Instance(sizes, arr, arr + dur, f"q{seed}").sorted_by_arrival()


def port_inst(inst):
    """The port's ``Instance`` of a reference instance."""
    return PortInstance(inst.sizes, inst.arrivals, inst.departures,
                        inst.name)


@pytest.fixture(scope="module")
def pair():
    insts = [qinst(1), qinst(2)]
    batch = ref_sweep.pack_instances(insts)
    flat = _flatten_lanes(batch.sizes, batch.times, batch.kinds, batch.items,
                          instances_pdeps(batch), batch.dmask,
                          batch.arrivals, batch.pdeps, batch.n_items)
    return insts, batch, flat


@functools.lru_cache(maxsize=None)
def _port_run(policy, block_events, spec=SPEC):
    insts = [qinst(1), qinst(2)]
    batch = ref_sweep.pack_instances(insts)
    flat = _flatten_lanes(batch.sizes, batch.times, batch.kinds, batch.items,
                          instances_pdeps(batch), batch.dmask,
                          batch.arrivals, batch.pdeps, batch.n_items)
    return port_cons.consolidated_replay(
        *flat, policy=policy, max_bins=32, device="cpu",
        block_events=block_events,
        spec=port_cons.ConsolidationSpec.parse(spec))


# ------------------------------------------------------------------- spec

@pytest.mark.parametrize("text", [
    "none", "underload", "underload:0.4", "underload:0.4:16",
    "underload:t0.25:b64:e128:c0.5", "periodic:100", "periodic:dt100:t0.3:b8",
    "periodic:100:0.3:8", "underload:t0.25:e32"])
def test_spec_parse_and_canonical_equal_reference(text):
    port = port_cons.ConsolidationSpec.parse(text)
    ref = ref_cons.ConsolidationSpec.parse(text)
    assert port.canonical() == ref.canonical() == str(port)
    assert dataclass_fields(port) == dataclass_fields(ref)
    assert port_cons.ConsolidationSpec.parse(port.canonical()) == port
    assert port.enabled == ref.enabled


def dataclass_fields(spec):
    import dataclasses
    return dataclasses.asdict(spec)


@pytest.mark.parametrize("kw", [dict(kind="defrag"),
                                dict(kind="underload", threshold=0.0),
                                dict(kind="periodic", dt=0.0),
                                dict(kind="underload", every=0)])
def test_spec_rejects_bad_knobs_as_the_reference(kw):
    for cls in (ref_cons.ConsolidationSpec, port_cons.ConsolidationSpec):
        with pytest.raises(AssertionError):
            cls(**kw)


# ---------------------------------------------------------------- planner

def _random_pool(rng, B=24, d=3, n=80):
    loads = np.zeros((B, d))
    counts = np.zeros(B, np.int64)
    alive = rng.random(B) < 0.8
    oseq = rng.permutation(B)
    sizes = rng.integers(1, 20, (n, d)) / 64.0
    bin_items = {}
    for item in range(n):
        b = int(rng.integers(B))
        if alive[b] and np.all(loads[b] + sizes[item] <= 1.0):
            loads[b] += sizes[item]
            counts[b] += 1
            bin_items.setdefault(b, []).append(item)
    return loads, counts, alive, oseq, bin_items, sizes


@pytest.mark.parametrize("seed", range(6))
def test_plan_migrations_equals_reference(seed):
    rng = np.random.default_rng(seed)
    pool = _random_pool(rng)
    for threshold in (0.15, 0.25, 0.5, 1.0):
        for budget in (-1, 0, 3, 10):
            a = port_cons.plan_migrations(*pool, threshold=threshold,
                                          budget=budget)
            b = ref_cons.plan_migrations(*pool, threshold=threshold,
                                         budget=budget)
            assert (a.items, a.bins_closed, a.budget_exhausted) == \
                (b.items, b.bins_closed, b.budget_exhausted)
    assert port_planner.PLAN_EPS == ref_cons.planner.PLAN_EPS


def test_should_plan_equals_reference():
    for text in ("none", "underload", "periodic:100"):
        p, r = (m.ConsolidationSpec.parse(text) for m in (port_cons,
                                                         ref_cons))
        for t, t_next in ((0.0, 0.0), (50.0, 100.0), (150.0, 100.0),
                          (1e5, 0.0)):
            assert port_cons.should_plan(p, t, t_next) == \
                ref_cons.should_plan(r, t, t_next)


# ------------------------------------------ driver vs reference and oracle

# The periodic cadence (should_plan's dt re-arm) and binding per-lane
# budgets, for one policy of each family and ppe (its learning updates
# skipped on a migrant's departure), per event and at T 8.  Their e4
# cadence compiles the reference's driver anew for each policy, so the
# cases take this subset and not all 21.
NEW_SPECS = ("periodic:dt500:t0.5:e4", "periodic:dt3000:t0.6:b3:e8:c1.5",
             "underload:t0.5:b2:e4")
NEW_SPEC_POLICIES = ("first_fit", "best_fit_l2", "cbd", "hybrid", "ppe",
                     "la_binary", "adaptive")
DRIVER_CASES = [pytest.param(SPEC, 0, p, id=p) for p in SCAN_POLICIES] + [
    pytest.param(s, T, p, id=f"{s}-T{T}-{p}") for s in NEW_SPECS
    for T in (0, 8) for p in NEW_SPEC_POLICIES]


@pytest.mark.parametrize("spec,block_events,policy", DRIVER_CASES)
def test_driver_equals_reference_and_oracle(spec, block_events, policy,
                                            pair):
    """On the CPU, per event (and for the added specs also at T 8):
    usage, opened bins, placements, the emitted MIGRATE events and the
    churn (migrations, bins closed, budget exhausted, migration cost)
    equal the reference's jnp driver and its sequential consolidating
    oracle exactly, for every scan policy at the reference test's spec;
    and equal the port's own oracle (``port_cons.run_consolidating`` with
    ``torchsim.host_algorithm``) as well."""
    insts, _, flat = pair
    usage, opened, placements, over, stats = _port_run(policy, block_events,
                                                       spec)
    assert not bool(over.any())
    ru, ro, rp, rov, rs = ref_cons.consolidated_replay(
        *(jnp.asarray(a) for a in flat), policy=policy, max_bins=32,
        backend="jnp", spec=ref_cons.ConsolidationSpec.parse(spec))
    assert np.array_equal(usage.numpy(), np.asarray(ru))
    assert np.array_equal(opened.numpy(), np.asarray(ro))
    assert np.array_equal(placements.numpy(), np.asarray(rp))
    assert stats["events"] == rs["events"]
    for k in ("migrations", "bins_closed", "budget_exhausted",
              "migration_cost"):
        assert np.array_equal(stats[k], np.asarray(rs[k])), k
    for lane, inst in enumerate(insts):
        res, ost = ref_cons.run_consolidating(
            inst, host_algorithm(policy),
            ref_cons.ConsolidationSpec.parse(spec))
        assert float(usage[lane]) == res.usage_time
        assert int(opened[lane]) == res.n_bins_opened
        assert stats["events"][lane] == ost["events"]
        assert int(stats["migrations"][lane]) == ost["migrations"]
        assert int(stats["bins_closed"][lane]) == ost["bins_closed"]
        own, own_st = port_cons.run_consolidating(
            port_inst(inst), torchsim.host_algorithm(policy),
            port_cons.ConsolidationSpec.parse(spec))
        assert float(usage[lane]) == own.usage_time
        assert int(opened[lane]) == own.n_bins_opened
        assert stats["events"][lane] == own_st["events"]
        for k in ("migrations", "bins_closed", "budget_exhausted",
                  "migration_cost"):
            assert stats[k][lane] == own_st[k], k


def test_added_specs_migrate_and_exhaust_budgets():
    """Guard the added cases: across them items move, the periodic cadence
    plans, and a per-lane budget binds."""
    runs = {(s, p): _port_run(p, 0, s)[4] for s in NEW_SPECS
            for p in NEW_SPEC_POLICIES}
    assert sum(r["migrations"].sum() for r in runs.values()) > 0
    assert sum(runs[(NEW_SPECS[0], p)]["migrations"].sum()
               for p in NEW_SPEC_POLICIES) > 0
    assert sum(r["budget_exhausted"].sum() for r in runs.values()) > 0


def test_scenario_actually_migrates():
    """Guard the fixture: the parity above means something only while the
    scenario moves items, the score family's included."""
    stats = _port_run("first_fit", 0)[4]
    assert stats["migrations"].sum() > 0
    assert sum(_port_run(p, 0)[4]["migrations"].sum()
               for p in SCAN_POLICIES) > 2 * len(SCAN_POLICIES)


@pytest.mark.parametrize("policy", SCAN_POLICIES)
def test_blocked_equals_per_event(policy):
    """The event-blocked replay (``replay_block_ref`` on the CPU, MIGRATE
    chunks through its migrate branch) at T = 1 and 8 == per event."""
    want = _port_run(policy, 0)
    for T in (1, 8):
        got = _port_run(policy, T)
        for a, b in zip(got[:4], want[:4]):
            assert torch.equal(a, b), (policy, T)
        assert got[4]["events"] == want[4]["events"]


def test_pool_views_of_both_carries_agree(pair):
    """The planner reads the same pool from the per-event carry and from
    the packed one at the same event."""
    _, _, flat = pair
    E = 24
    cut = (flat[0], flat[1][:, :E], flat[2][:, :E], flat[3][:, :E]) + \
        tuple(flat[4:])
    per_event = torchsim._replay_batch(*cut, policy="cbd", max_bins=32,
                                       device="cpu", return_carry=True)[4]
    blocked = torchsim._replay_batch(*cut, policy="cbd", max_bins=32,
                                     device="cpu", block_events=8,
                                     return_carry=True)[4]
    a, b = (port_driver._pool_view(c, 3) for c in (per_event, blocked))
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert a["loads"].dtype == np.float64 and a["loads"].shape[-1] == 3


# ------------------------------------- the MIGRATE branch vs the reference

def dense(seed, n, d=3):
    """An fp32-exact instance with tens of items alive at once."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 24, (n, d)) / 64.0
    arr = np.sort(rng.integers(0, 5000, n)).astype(float)
    dur = rng.integers(500, 5000, n).astype(float)
    return Instance(sizes, arr, arr + dur, f"w{seed}").sorted_by_arrival()


def _lanes():
    """Three fp32-exact lanes: clairvoyant, pdep == arrival, power-of-two
    noise (40/60/30 items, d = 3)."""
    insts = [dense(1, 40), dense(2, 60), dense(3, 30)]
    batch = ref_sweep.pack_instances(insts)
    preds = []
    for i in insts:
        rng = np.random.default_rng(100)
        noisy = i.durations * rng.choice([0.25, 0.5, 1.0, 2.0, 4.0],
                                         i.n_items)
        preds.append(np.stack([i.durations, np.zeros(i.n_items), noisy]))
    flat = _flatten_lanes(batch.sizes, batch.times, batch.kinds,
                          batch.items, ref_sweep.pad_predictions(batch, preds),
                          batch.dmask, batch.arrivals, batch.pdeps,
                          batch.n_items)
    return tuple(np.asarray(a)[np.array([0, 4, 8])] for a in flat)


@pytest.mark.parametrize("policy,max_bins", [
    ("nrt_prioritized", 20), ("best_fit_l2", 300), ("cbdt", 20),
    ("hybrid_direct_sum", 20), ("ppe", 20), ("rcp_modified", 20),
    ("la_geometric", 20), ("adaptive", 20)])
def test_replay_block_ref_migrate_equals_interpret_megakernel(policy,
                                                              max_bins):
    """A block that opens with MIGRATE events (``chip_smoke.
    migrate_streams``: a migrant whose source bin closes first, RCP/PPE
    migrants off the base bin) from a mid-replay carry: the port's plain
    version with ``migrate=True`` == the reference's megakernel with
    ``migrate=True`` in interpret mode, every carry array bit for bit."""
    flat = _lanes()
    PREFIX, T = 48, 16
    ev_i, ev_f, ev_size, dmask, fam, d = torchsim._event_streams(
        policy, *flat, None)
    L, n_max = flat[0].shape[:2]
    kw = torchsim.replay_block_kwargs(policy, max_bins, d)
    carry = torchsim.packed_init_carry(fam, L, n_max, max_bins, "cpu")
    ops.replay_chunk(carry, ev_i[:, :, :PREFIX], ev_f[:, :, :PREFIX],
                     ev_size[:, :PREFIX], dmask, block_events=PREFIX, **kw)
    (mi, mf, ms, _), n_close, n_base = chip_smoke.migrate_streams(
        policy, flat, PREFIX, T, carry, np.random.default_rng(1), "cpu")
    assert n_close > 0 and (n_base > 0 or fam != "rcp")
    blk = slice(PREFIX, PREFIX + T)
    assert int((mi[0, :, blk] == fk.MIGRATE_KIND).sum()) == 8 * L
    ref_in = torchsim.packed_carry_to_reference(carry, d)
    names_i = ("kind", "item") + fk.REPLAY_EV_I[fam]
    names_f = ("t", "pdep") + fk.REPLAY_EV_F[fam]
    size_ref = np.zeros((L, T, 128), np.float32)
    size_ref[:, :, :fk.DPAD] = ms[:, blk].numpy()
    dmask_ref = np.zeros((L, 128), np.float32)
    dmask_ref[:, :fk.DPAD] = dmask.numpy()
    out = ref_fitscore.fitscore_replay_block(
        {k: jnp.asarray(v) for k, v in ref_in.items()},
        {nm: jnp.asarray(mi[k, :, blk].numpy())
         for k, nm in enumerate(names_i)},
        {nm: jnp.asarray(mf[k, :, blk].numpy())
         for k, nm in enumerate(names_f)},
        jnp.asarray(size_ref), jnp.asarray(dmask_ref), migrate=True,
        interpret=True, **kw)
    got = fk.replay_block_ref(carry, mi[:, :, blk], mf[:, :, blk],
                              ms[:, blk], dmask, migrate=True, **kw)
    want = torchsim.packed_carry_from_reference(out, d, max_bins, "cpu")
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_migrate_events_are_noops_without_migrate():
    """Without ``migrate`` a MIGRATE event leaves the carry as a PAD event
    does, per event and blocked (the reference's megakernel compiles its
    branch only under ``migrate=True``)."""
    flat = _lanes()
    ev_i, ev_f, ev_size, dmask, fam, d = torchsim._event_streams(
        "cbd", *flat, None)
    kw = torchsim.replay_block_kwargs("cbd", 20, d)
    carry = torchsim.packed_init_carry(fam, 3, flat[0].shape[1], 20, "cpu")
    ops.replay_chunk(carry, ev_i[:, :, :40], ev_f[:, :, :40],
                     ev_size[:, :40], dmask, block_events=40, **kw)
    mig = ev_i[:, :, 40:48].clone()
    mig[0] = fk.MIGRATE_KIND
    mig[1] = ev_i[1, :, :8]       # items that arrived early on
    before = {k: v.clone() for k, v in carry.items()}
    fk.replay_block_ref(carry, mig, ev_f[:, :, 40:48], ev_size[:, 40:48],
                        dmask, **kw)
    for k in carry:
        assert torch.equal(carry[k], before[k]), k
    # per event: eight MIGRATE events inserted after event 40 change
    # nothing either
    sizes, times, kinds, items = flat[:4]

    def insert(a, fill):
        return np.concatenate([a[:, :40], fill, a[:, 40:]], axis=1)
    ins = (insert(times, np.repeat(times[:, 39:40], 8, axis=1)),
           insert(kinds, np.full((3, 8), fk.MIGRATE_KIND, kinds.dtype)),
           insert(items, items[:, :8]))
    want = torchsim._replay_batch(*flat, policy="cbd", max_bins=20,
                                  device="cpu")
    got = torchsim._replay_batch(sizes, *ins, *flat[4:], policy="cbd",
                                 max_bins=20, device="cpu")
    for x, y in zip(got, want):
        assert torch.equal(x, y)
