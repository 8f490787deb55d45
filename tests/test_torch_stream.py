"""The port's streamed chunked replay (``repro_torch.stream``) against the
reference's ``repro.stream`` on the same inputs: usage, opened bins,
overflow, the final slot pool, the item-row pool and placements, per
policy family, per event and blocked, across chunk geometries, MIGRATE
events on chunk boundaries, overflow rungs on a boundary, pool growth,
prefetch, the CSV source and a checkpoint resume."""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import repro.stream as ref_stream
from repro.core.jaxsim import _replay_batch as ref_replay_batch
from repro.core.jaxsim import grow_live_items as ref_grow_live_items
from repro.core.jaxsim import replay_init_carry as ref_init_carry
from repro.data import traces as ref_traces
from repro.kernels.fitscore import ARRIVAL_KIND, DEPARTURE_KIND, MIGRATE_KIND
from test_stream import FIXTURE, _one_instance, _stream_instance

import repro_torch.stream as port_stream
from repro_torch import obs
from repro_torch.core import Instance, torchsim
from repro_torch.data import traces as port_traces
from repro_torch.resilience import faults
from repro_torch.resilience.checkpoint import StreamCheckpointer

# one policy a carry family (score / cbd / hybrid / rcp / la / adaptive)
FAMILY_POLICIES = ("best_fit_l2", "cbd", "hybrid", "rcp", "la_binary",
                   "adaptive")

PREFETCH_DEPTHS = (0, 1)

torch.set_num_threads(1)


def _port(inst):
    return Instance(inst.sizes, inst.arrivals, inst.departures, inst.name)


def _port_stream(inst, policy, **kw):
    return port_stream.replay_stream(port_stream.InstanceSource(_port(inst)),
                                     policy, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _ref_stream(key, policy, kw):
    inst = _INSTANCES[key]()
    return ref_stream.replay_stream(ref_stream.InstanceSource(inst), policy,
                                    backend="jnp", **dict(kw))


_INSTANCES = {
    "t3": lambda: _stream_instance(),
    "t9": lambda: _stream_instance(seed=9, n=60),
    "t11": lambda: _stream_instance(seed=11, n=200),
    "t4": lambda: _stream_instance(seed=4, n=80),
    "t13": lambda: _stream_instance(seed=13, n=100),
    "dense": lambda: _one_instance(3, 40, 4, 8, 860000.0, 0.4, "dense"),
}


def _assert_equal(res, ref, what):
    assert res.usage == ref.usage, what
    assert (res.opened, res.overflow, res.max_bins, res.n_items,
            res.n_events, res.n_chunks, res.item_rows) == \
        (ref.opened, ref.overflow, ref.max_bins, ref.n_items, ref.n_events,
         ref.n_chunks, ref.item_rows), what
    if ref.placements is not None:
        assert np.array_equal(res.placements, ref.placements), what


# ---------------------------------------------------------------- equality

@pytest.mark.parametrize("block_events", [0, 16])
@pytest.mark.parametrize("policy", FAMILY_POLICIES)
def test_stream_equals_reference_per_family(policy, block_events):
    """A pool a fraction of the items (recycled rows; hybrid pins the full
    table), per event and blocked, == the reference's streamed replay and
    the port's in-memory one, placements included."""
    kw = (("chunk_events", 32), ("item_rows", 24), ("max_bins", 64),
          ("collect_placements", True))
    ref = _ref_stream("t3", policy, kw)
    res = _port_stream(_INSTANCES["t3"](), policy, block_events=block_events,
                       **dict(kw))
    _assert_equal(res, ref, policy)
    mem = torchsim.simulate(_port(_INSTANCES["t3"]()), policy, max_bins=64,
                            device="cpu", block_events=block_events)
    assert (res.usage, res.opened) == (mem.usage_time, mem.n_bins_opened)
    assert np.array_equal(res.placements, mem.placements)
    if policy != "hybrid":
        assert res.item_rows < res.n_items


@pytest.mark.parametrize("chunk_events", (7, 32, 1024))
def test_chunk_geometry_never_changes_results(chunk_events):
    kw = (("chunk_events", chunk_events), ("item_rows", 16),
          ("max_bins", 64), ("collect_placements", True))
    ref = _ref_stream("t9", "mru", kw)
    _assert_equal(_port_stream(_INSTANCES["t9"](), "mru", **dict(kw)), ref,
                  f"C={chunk_events}")


def test_pool_growth_mid_stream():
    kw = (("chunk_events", 64), ("item_rows", 4), ("max_bins", 64),
          ("collect_placements", True))
    ref = _ref_stream("t11", "first_fit", kw)
    c0 = obs.counter_get("stream.pool_growths")
    res = _port_stream(_INSTANCES["t11"](), "first_fit", **dict(kw))
    _assert_equal(res, ref, "grown")
    assert res.item_rows > 4
    assert obs.counter_get("stream.pool_growths") > c0


@pytest.mark.parametrize("block_events", [0, 8])
def test_prefetch_depth_is_execution_only(block_events):
    kw = (("chunk_events", 32), ("item_rows", 32))
    ref = _ref_stream("t4", "best_fit_linf", kw)
    for prefetch in PREFETCH_DEPTHS:
        res = _port_stream(_INSTANCES["t4"](), "best_fit_linf",
                           prefetch=prefetch, block_events=block_events,
                           **dict(kw))
        _assert_equal(res, ref, f"prefetch={prefetch}")
    # a deeper prefetch would put the snapshot's pool two chunks ahead
    with pytest.raises(ValueError, match="prefetch"):
        _port_stream(_INSTANCES["t4"](), "best_fit_linf", prefetch=2,
                     block_events=block_events, **dict(kw))


# ------------------------------------------------- boundary corner cases

def _migrate_events(n=8, d=3):
    rng = np.random.default_rng(0)
    sizes = (rng.integers(1, 24, (n, d)) / 64.0).astype(np.float32)
    arrivals = np.arange(n, dtype=np.float32)
    rdeps = arrivals + np.float32(100.0) + np.arange(n, dtype=np.float32)
    # 8 arrivals, then 2 MIGRATEs at t=10 (items 0, 1: alive), then deps
    times = np.concatenate([arrivals, [10.0, 10.0], rdeps]).astype(
        np.float32)
    kinds = np.concatenate([np.full(n, ARRIVAL_KIND),
                            [MIGRATE_KIND, MIGRATE_KIND],
                            np.full(n, DEPARTURE_KIND)]).astype(np.int32)
    items = np.concatenate([np.arange(n), [0, 1],
                            np.arange(n)]).astype(np.int32)
    return sizes, arrivals, rdeps, times, kinds, items


@pytest.mark.parametrize("block_events", [0, 4])
@pytest.mark.parametrize("chunk_events", (8, 9, 10))
def test_migrate_event_across_chunk_boundary(chunk_events, block_events):
    """C=9 puts the second MIGRATE as a chunk's last event, C=8 as a
    chunk's first: == the reference's unchunked replay with migrate."""
    sizes, arrivals, rdeps, times, kinds, items = _migrate_events()
    n1 = np.full(1, len(sizes), np.int32)
    ref = [np.asarray(a)[0] for a in ref_replay_batch(
        sizes[None], times[None], kinds[None], items[None], rdeps[None],
        None, arrivals[None], rdeps[None], n1, policy="best_fit_l2",
        max_bins=8, backend="jnp", migrate=True)]
    got = port_stream.replay_chunked_events(
        sizes, times, kinds, items, rdeps, arrivals, rdeps,
        policy="best_fit_l2", chunk_events=chunk_events, max_bins=8,
        device="cpu", block_events=block_events, migrate=True)
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)


def test_overflow_rung_on_chunk_boundary():
    """chunk_events=1: a boundary after every event, the overflowing one
    included; the ladder restarts the stream with a doubled pool."""
    kw = (("chunk_events", 1), ("item_rows", 64), ("max_bins", 4),
          ("collect_placements", True))
    ref = _ref_stream("dense", "first_fit", kw)
    assert ref.max_bins > 4       # the instance does escalate
    c0 = obs.counter_get("stream.overflow_rungs")
    res = _port_stream(_INSTANCES["dense"](), "first_fit", **dict(kw))
    _assert_equal(res, ref, "ladder")
    assert obs.counter_get("stream.overflow_rungs") > c0


def test_capacity_error_at_cap():
    with pytest.raises(torchsim.CapacityError):
        _port_stream(_INSTANCES["dense"](), "first_fit", chunk_events=64,
                     item_rows=64, max_bins=2, max_bins_cap=2)


def test_chunk_builder_equals_reference_and_validates():
    """The port's builder cuts the reference's chunks, field for field,
    and refuses an unsorted stream and an exhausted fixed pool."""
    inst = _stream_instance(seed=2, n=30)
    for policy in ("first_fit", "rcp"):
        a = list(ref_stream.ChunkedWorkload(
            ref_stream.InstanceSource(inst), policy, chunk_events=16,
            item_rows=4).chunks())
        b = list(port_stream.ChunkedWorkload(
            port_stream.InstanceSource(_port(inst)), policy,
            chunk_events=16, item_rows=4).chunks())
        assert len(a) == len(b)
        for x, y in zip(a, b):
            for f in ("times", "kinds", "items", "upd_idx", "upd_size",
                      "upd_arrival", "upd_rdep", "upd_pdep", "freed",
                      "freed_seqs"):
                assert np.array_equal(getattr(x, f), getattr(y, f)), f
            assert all(np.array_equal(p, q)
                       for p, q in zip(x.extras, y.extras))
            assert (x.n_events, x.item_rows, x.final) == \
                (y.n_events, y.item_rows, y.final)
    src = port_stream.InstanceSource(_port(inst))

    class Shuffled:
        def meta(self):
            return src.meta()

        def records(self):
            return iter(list(src.records())[::-1])

    with pytest.raises(ValueError, match="arrival-sorted"):
        list(port_stream.ChunkedWorkload(Shuffled(), "first_fit",
                                         chunk_events=16,
                                         item_rows=8).chunks())
    with pytest.raises(RuntimeError, match="pool exhausted"):
        list(port_stream.ChunkedWorkload(src, "first_fit", chunk_events=16,
                                         item_rows=2, grow=False).chunks())


def test_chunk_instance_events_padding_equals_reference():
    times = np.arange(10, dtype=np.float32)
    kinds = np.ones(10, np.int32)
    items = np.arange(10, dtype=np.int32)
    extra = np.arange(10, dtype=np.int32) * 2
    a = list(ref_stream.chunk_instance_events(times, kinds, items, 4,
                                              (extra,)))
    b = list(port_stream.chunk_instance_events(times, kinds, items, 4,
                                               (extra,)))
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        for p, q in zip(x[:3], y[:3]):
            assert np.array_equal(p, q)
        assert np.array_equal(x[3][0], y[3][0]) and x[4] == y[4]


@pytest.mark.parametrize("policy", ("first_fit", "rcp"))
def test_grown_carries_equal_reference(policy):
    """Both carries grown by rows: placements -1, RCP's memo 0, the rest
    as it was (the packed one against the reference's grow_live_items)."""
    packed = torchsim.replay_init_carry(policy, 16, 3, 8, L=1,
                                        block_events=4, device="cpu")
    packed["itemi"][0, :, 0] = torch.arange(8, dtype=torch.int32)
    grown = torchsim.grow_item_rows(packed, 20)
    ref = ref_init_carry(policy, 16, 3, 8, L=1, backend="pallas_interpret",
                         block_events=4)
    ref = dict(ref, itemi=np.asarray(ref["itemi"]).copy())
    ref["itemi"][0, :, 0] = np.arange(8)
    ref_grown = ref_grow_live_items(ref, 20)
    assert np.array_equal(grown["itemi"].numpy(),
                          np.asarray(ref_grown["itemi"]))
    assert torchsim.grow_item_rows(grown, 20) is grown
    flat = torchsim.replay_init_carry(policy, 16, 3, 8, L=1, device="cpu")
    flat[7][0, 3] = 5
    wide = torchsim.grow_item_rows(flat, 20)
    assert wide[7].shape == (1, 20) and int(wide[7][0, 3]) == 5
    assert bool((wide[7][0, 8:] == -1).all())
    if policy == "rcp":
        assert wide[12]["loc"].shape == (1, 20)
        assert not bool(wide[12]["loc"][0, 8:].any())


def test_hybrid_carry_refuses_to_grow():
    for T in (0, 4):
        carry = torchsim.replay_init_carry("hybrid", 16, 3, 8, L=1,
                                           block_events=T, device="cpu")
        with pytest.raises(ValueError, match="does not grow"):
            torchsim.grow_item_rows(carry, 20)


# -------------------------------------------------------- sources / CSV

def test_csv_source_equals_reference_and_loader():
    """The line-by-line CSV stream == the reference's and the
    materializing loader; its streamed replay == the port's simulate."""
    insts = {i.name: i for i in port_traces.load_azure_csv(FIXTURE)}
    for pm in (0, 1):
        assert port_traces.azure_stream_meta(FIXTURE, pm) == \
            ref_traces.azure_stream_meta(FIXTURE, pm)
        inst = insts[f"azure_pm{pm}"]
        src = port_stream.CsvSource(FIXTURE, machine_id=pm)
        recs = list(src.records())
        ref = list(ref_stream.CsvSource(FIXTURE, machine_id=pm).records())
        assert len(recs) == len(ref) == inst.n_items
        for j, ((size, arr, dep, pdep), (rs, ra, rd, rp)) in \
                enumerate(zip(recs, ref)):
            assert np.array_equal(size, rs)
            assert np.array_equal(size, inst.sizes[j])
            assert (arr, dep, pdep) == (ra, rd, rp) == \
                (inst.arrivals[j], inst.departures[j], inst.departures[j])
        assert dataclasses.astuple(src.meta()) == dataclasses.astuple(
            ref_stream.CsvSource(FIXTURE, pm).meta())
        mem = torchsim.simulate(inst, "best_fit_l2", max_bins=16,
                                device="cpu")
        res = port_stream.replay_stream(src, "best_fit_l2", chunk_events=4,
                                        item_rows=8, max_bins=16,
                                        device="cpu")
        assert (res.usage, res.opened) == (mem.usage_time,
                                           mem.n_bins_opened)


def test_synthetic_source_equals_reference():
    a = ref_stream.synthetic_source(300, seed=21)
    b = port_stream.synthetic_source(300, seed=21)
    assert dataclasses.astuple(a.meta()) == dataclasses.astuple(b.meta())
    for f in ("sizes", "arrivals", "departures"):
        assert np.array_equal(getattr(a.inst, f), getattr(b.inst, f))


# ---------------------------------------------------------- checkpointing

@pytest.mark.parametrize("block_events", [0, 8])
def test_checkpoint_resume_equals_reference(tmp_path, block_events):
    """A streamed replay that left a snapshot resumes from it (the host
    builder fast-forwarded) and ends on the reference's result, at each
    prefetch depth: after a completed run, from its last snapshot, and
    after a run that died at each of its snapshots, from that one."""
    inst = _INSTANCES["t13"]()
    kw = (("chunk_events", 16), ("item_rows", 32), ("max_bins", 64))
    ref = _ref_stream("t13", "rcp", kw)
    for prefetch in PREFETCH_DEPTHS:
        what = f"prefetch={prefetch}"
        root = str(tmp_path / f"p{prefetch}")
        ck = StreamCheckpointer(root, every_chunks=3, keep=True)
        full = _port_stream(inst, "rcp", checkpointer=ck, prefetch=prefetch,
                            block_events=block_events, **dict(kw))
        _assert_equal(full, ref, f"checkpointed, {what}")
        assert [f for f in os.listdir(root) if f.endswith(".npz")]
        c0 = obs.counter_get("resilience.stream_ckpt_resume")
        res = _port_stream(inst, "rcp", block_events=block_events,
                           prefetch=prefetch,
                           checkpointer=StreamCheckpointer(root,
                                                           every_chunks=3),
                           **dict(kw))
        assert obs.counter_get("resilience.stream_ckpt_resume") == c0 + 1
        _assert_equal(res, ref, f"resumed, {what}")
        assert not [f for f in os.listdir(root) if f.endswith(".npz")]
        for k in range(1, full.n_chunks):
            died = str(tmp_path / f"p{prefetch}-died{k}")
            with faults.injected(f"ckpt.save:error:{k}"):
                with pytest.raises(faults.InjectedFault):
                    _port_stream(inst, "rcp", block_events=block_events,
                                 prefetch=prefetch,
                                 checkpointer=StreamCheckpointer(
                                     died, every_chunks=1), **dict(kw))
            res = _port_stream(inst, "rcp", block_events=block_events,
                               prefetch=prefetch,
                               checkpointer=StreamCheckpointer(
                                   died, every_chunks=1), **dict(kw))
            _assert_equal(res, ref, f"died at save {k}, {what}")
    with pytest.raises(ValueError, match="placements"):
        _port_stream(inst, "rcp", checkpointer=ck, collect_placements=True,
                     **dict(kw))


def test_stream_smoke_matches_simulate():
    """A 3k-item (6k-event) synthetic stream in a bounded pool == the
    in-memory replay (the reference's smoke gate, on the port)."""
    src = port_stream.synthetic_source(3000, seed=17)
    mem = torchsim.simulate(src.inst, "first_fit", max_bins=128,
                            device="cpu", block_events=256)
    res = port_stream.replay_stream(src, "first_fit", chunk_events=1024,
                                    item_rows=256, max_bins=128,
                                    device="cpu", block_events=256)
    assert (res.usage, res.opened) == (mem.usage_time, mem.n_bins_opened)
    assert res.item_rows < src.inst.n_items and res.n_events == 6000
