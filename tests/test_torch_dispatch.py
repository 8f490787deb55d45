"""The port's online serving path on the CPU: batched admission and the
double-buffered block dispatch (``repro_torch.serving.dispatch``) on the
live carry, against the JAX package's ``serve_traffic`` and against the
port's own sequential host-zoo oracle, decision for decision; the
scenarios of tests/test_dispatch.py and the two drain tests of
tests/test_consolidate.py.

On the CPU the dispatcher replays each block through the megakernel's
plain version (``kernels.fitscore.replay_block_ref``), which updates the
carry in place as the CUDA kernels do: the regrow with two blocks in
flight replays from the pre-block copies the dispatcher keeps.  The
reference runs as its own tests run it (``impl="pallas_interpret"``,
``"jnp"`` for the drain).  Placements, replica ids, opened and peak
replicas and replica-seconds are held exactly.
"""
import heapq

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.serving.dispatch import BlockDispatcher as RefDispatcher
from repro.serving.dispatch import serve_traffic as ref_serve_traffic
from repro.serving.scheduler import DVBPScheduler as RefScheduler
from repro.serving.scheduler import ReplicaCapacity as RefCaps
from repro.serving.scheduler import Request as RefRequest
from repro.serving.traffic import diurnal_requests as ref_diurnal
from repro.serving.traffic import poisson_requests as ref_poisson
from repro_torch import obs
from repro_torch.core import torchsim
from repro_torch.kernels import fitscore as fk
from repro_torch.kernels import ops
from repro_torch.resilience import faults
from repro_torch.serving.admission import AdmissionQueue
from repro_torch.serving.dispatch import (BatchedFrontEnd, BlockDispatcher,
                                          serve_traffic)
from repro_torch.serving.scheduler import (DVBPScheduler, ReplicaCapacity,
                                           Request, _demand_vector)
from repro_torch.serving.traffic import (diurnal_requests, make_traffic,
                                         poisson_requests)

CAPS = ReplicaCapacity()
TPS = 50.0

# one kernel policy per family, paired with the host-zoo oracle policy
FAMILY_PAIRS = [
    ("best_fit_linf", "best_fit", {"norm": "linf"}),      # score
    ("cbd", "cbd", {"beta": 2.0}),                        # cbd
    ("rcp", "rcp", None),                                 # rcp
    ("la_binary", "lifetime_alignment", {"mode": "binary"}),  # la
    ("adaptive", "adaptive", None),                       # adaptive
]


def _oracle(reqs, policy, kwargs, caps=CAPS):
    """The sequential oracle: one host-zoo ``DVBPScheduler.place`` per
    request at its arrival, departures in finish-time order.  Returns the
    placements and (replica_seconds, opened, peak)."""
    sched = DVBPScheduler(policy, caps, kwargs, tokens_per_second=TPS)
    heap, placements = [], {}
    for r in sorted(reqs, key=lambda x: x.arrival):
        while heap and heap[0][0] <= r.arrival:
            ft, rid = heapq.heappop(heap)
            sched.finish(rid, ft)
        placements[r.rid] = sched.place(r, r.arrival)
        heapq.heappush(heap, (r.arrival + r.decode_len / TPS, r.rid))
    while heap:
        ft, rid = heapq.heappop(heap)
        sched.finish(rid, ft)
    st = sched.stats
    return placements, (st.replica_seconds, st.replicas_opened,
                        st.peak_replicas)


def _fleet(rep):
    return rep.replica_seconds, rep.replicas_opened, rep.peak_replicas


def _degradations():
    return {k: v for k, v in obs.counters().items()
            if k.startswith("resilience.degrade")}


@pytest.fixture
def no_backoff(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_RESILIENCE_BACKOFF_SCALE", "0")


# ------------------------------------------------------------------ parity

@pytest.mark.parametrize("T", [1, 8, 256])
@pytest.mark.parametrize("kpol,hpol,kw", FAMILY_PAIRS,
                         ids=[p[0] for p in FAMILY_PAIRS])
def test_serve_traffic_matches_reference_and_oracle(kpol, hpol, kw, T):
    """Blocks of T events (PAD filler to T) place every request where the
    reference's serve_traffic and the port's sequential oracle place it,
    with the same replica ids, opened and peak replicas and
    replica-seconds."""
    reqs = poisson_requests(40, rate=50.0, seed=2, sigma_pred=0.3)
    ref_reqs = ref_poisson(40, rate=50.0, seed=2, sigma_pred=0.3)
    kw_t = dict(tps=TPS, batch_max=T, geometries=(T,))
    rep = serve_traffic(reqs, kpol, CAPS, device="cpu", **kw_t)
    ref = ref_serve_traffic(ref_reqs, kpol, RefCaps(),
                            impl="pallas_interpret", **kw_t)
    placements, fleet = _oracle(reqs, hpol, kw)
    assert rep.placements == ref.placements == placements
    assert _fleet(rep) == _fleet(ref) == fleet
    assert rep.placed == len(reqs) and rep.shed == 0


def test_traffic_streams_equal_reference():
    """Same seed, same draws: the request streams equal the reference's."""
    def fields(reqs):
        return [(r.rid, r.arrival, r.prompt_len, r.decode_len,
                 r.predicted_decode_len) for r in reqs]
    assert fields(poisson_requests(300, rate=5e4, seed=4, sigma_pred=0.5)) \
        == fields(ref_poisson(300, rate=5e4, seed=4, sigma_pred=0.5))
    assert fields(poisson_requests(50, seed=1, sigma_pred=None)) == \
        fields(ref_poisson(50, seed=1, sigma_pred=None))
    assert fields(diurnal_requests(200, rate=40.0, period=4.0, seed=4,
                                   sigma_pred=0.3)) == \
        fields(ref_diurnal(200, rate=40.0, period=4.0, seed=4,
                           sigma_pred=0.3))
    assert fields(make_traffic("diurnal", 20, seed=3)) == \
        fields(ref_diurnal(20, seed=3))
    with pytest.raises(KeyError):
        make_traffic("bursty", 10)


@pytest.mark.parametrize("kpol,hpol,kw", FAMILY_PAIRS[:2],
                         ids=[p[0] for p in FAMILY_PAIRS[:2]])
def test_batched_matches_sequential_oracle(kpol, hpol, kw):
    """Mixed block sizes over the default geometries place exactly as the
    sequential oracle - batching changes throughput, not decisions."""
    reqs = poisson_requests(90, rate=50.0, seed=3, sigma_pred=0.3)
    oracle = _oracle(reqs, hpol, kw)
    for bm in (8, 32):
        rep = serve_traffic(reqs, kpol, CAPS, tps=TPS, batch_max=bm,
                            device="cpu")
        assert (rep.placements, _fleet(rep)) == oracle, f"batch_max={bm}"


def test_diurnal_traffic_matches_oracle():
    reqs = diurnal_requests(60, rate=40.0, period=4.0, depth=0.8, seed=4,
                            sigma_pred=0.3)
    rep = serve_traffic(reqs, "best_fit_linf", CAPS, tps=TPS, batch_max=16,
                        device="cpu")
    assert (rep.placements, _fleet(rep)) == \
        _oracle(reqs, "best_fit", {"norm": "linf"})


# ------------------------------------------------- ladder, regrow, errors

@pytest.mark.parametrize("plan,counter", [
    ("serving.select:xla:1:1", "resilience.degrade_dispatch_block_events"),
    ("kernel.dispatch_block:error:3:1",
     "resilience.degrade_dispatch_block_events"),
    # an injected OOM is retried on the same rung
    ("kernel.dispatch_block:oom:5:1", "resilience.retry"),
])
def test_degrade_ladder_fires_and_decisions_survive(plan, counter,
                                                    no_backoff):
    """An injected fault steps the ladder down (or, an injected OOM, is
    retried on the same rung); placements still equal the oracle's."""
    reqs = poisson_requests(40, rate=50.0, seed=6, sigma_pred=0.3)
    oracle = _oracle(reqs, "best_fit", {"norm": "linf"})
    before = obs.counters()
    with faults.injected(plan):
        rep = serve_traffic(reqs, "best_fit_linf", CAPS, tps=TPS,
                            batch_max=8, device="cpu")
    delta = obs.counter_deltas(before)
    assert (rep.placements, _fleet(rep)) == oracle
    assert delta.get(counter, 0) == 1


def test_events_rung_restores_the_carry_after_a_partial_block(no_backoff):
    """The 2nd block's block rung fails; its events rung then fails with an
    injected OOM at its 3rd event, after replaying two; the retry starts
    from the pre-block carry, so decisions are unchanged."""
    reqs = poisson_requests(40, rate=50.0, seed=6, sigma_pred=0.3)
    oracle = _oracle(reqs, "best_fit", {"norm": "linf"})
    before = obs.counters()
    with faults.injected("kernel.dispatch_block:error:2:1,"
                         "kernel.dispatch_block:oom:5:1"):
        rep = serve_traffic(reqs, "best_fit_linf", CAPS, tps=TPS,
                            batch_max=8, geometries=(8,), device="cpu")
    delta = obs.counter_deltas(before)
    assert (rep.placements, _fleet(rep)) == oracle
    assert delta.get("resilience.degrade_dispatch_block_events") == 1
    assert delta.get("resilience.retry") == 1


def test_carry_regrow_preserves_decisions():
    """Overflowing the live carry grows the pool (doubling ladder) and
    replays the in-flight blocks; decisions stay oracle-equal."""
    reqs = poisson_requests(90, rate=400.0, seed=7, sigma_pred=0.3)
    before = obs.counters()
    rep = serve_traffic(reqs, "best_fit_linf", CAPS, tps=TPS, batch_max=16,
                        max_bins=2, device="cpu")
    delta = obs.counter_deltas(before)
    assert (rep.placements, _fleet(rep)) == \
        _oracle(reqs, "best_fit", {"norm": "linf"})
    assert delta.get("serving.carry_regrow", 0) >= 1


def test_regrow_with_two_blocks_in_flight(monkeypatch):
    """``max_bins=4``, ``depth=2``, blocks of 8: the pool overflows while
    two newer blocks are in flight, and every one replays from the
    pre-block copies.  The kernels update the carry in place, so a replay
    from the live carry would replay the later blocks twice."""
    seen = []
    orig = BlockDispatcher._replay_grown

    def spy(self):
        seen.append(len(self._inflight))
        return orig(self)

    monkeypatch.setattr(BlockDispatcher, "_replay_grown", spy)
    reqs = poisson_requests(90, rate=400.0, seed=7, sigma_pred=0.3)
    rep = serve_traffic(reqs, "best_fit_linf", CAPS, tps=TPS, batch_max=8,
                        geometries=(8,), max_bins=4, depth=2, device="cpu")
    assert (rep.placements, _fleet(rep)) == \
        _oracle(reqs, "best_fit", {"norm": "linf"})
    assert seen and max(seen) >= 3   # the overflowing block + 2 newer


def _stand_in_oom(*args, **kwargs):
    raise torch.cuda.OutOfMemoryError("stand-in CUDA out of memory")


def _real_error(*args, **kwargs):
    raise RuntimeError("stand-in CUDA error: an illegal memory access")


@pytest.mark.parametrize("raiser", [_stand_in_oom, _real_error],
                         ids=["oom", "runtime_error"])
def test_real_errors_propagate_from_serve_traffic(raiser, monkeypatch,
                                                  no_backoff):
    """A real error on every rung - an OOM after its retries, any other
    error at once - propagates; no rung changes."""
    monkeypatch.setattr(ops, "fitscore_replay_block", raiser)
    before, retries = _degradations(), obs.counter_get("resilience.retry")
    with pytest.raises(Exception) as ei:
        serve_traffic(poisson_requests(20, seed=1, sigma_pred=0.3),
                      "best_fit_linf", CAPS, tps=TPS, batch_max=8,
                      device="cpu")
    assert type(ei.value) is (torch.cuda.OutOfMemoryError
                              if raiser is _stand_in_oom else RuntimeError)
    assert _degradations() == before
    assert obs.counter_get("resilience.retry") - retries == \
        (2 if raiser is _stand_in_oom else 0)


@pytest.mark.parametrize("raiser", [_stand_in_oom, _real_error],
                         ids=["oom", "runtime_error"])
def test_real_errors_propagate_from_select_block(raiser, monkeypatch,
                                                 no_backoff):
    monkeypatch.setattr(ops, "fitscore_replay_block", raiser)
    sched = DVBPScheduler("best_fit", CAPS, {"norm": "linf"},
                          select_backend="device", device="cpu",
                          select_block=True)
    before = _degradations()
    with pytest.raises(Exception) as ei:
        sched.place(Request(0, 0.0, 64, 32), 0.0)
    assert type(ei.value) is (torch.cuda.OutOfMemoryError
                              if raiser is _stand_in_oom else RuntimeError)
    assert _degradations() == before and not sched.placements


def test_retrace_bounded_by_geometries():
    """Padding to a fixed geometry set bounds the launch geometries: mixed
    batch sizes add at most one per geometry, and a second run adds
    none."""
    reqs = poisson_requests(60, rate=50.0, seed=8, sigma_pred=0.3)
    kw = dict(tps=TPS, batch_max=8, geometries=(1, 8, 32), device="cpu")
    n0 = ops.dispatch_trace_count()
    serve_traffic(reqs, "best_fit_linf", CAPS, **kw)
    assert ops.dispatch_trace_count() - n0 <= 3
    before = obs.counters()
    rep = serve_traffic(reqs, "best_fit_linf", CAPS, **kw)
    delta = obs.counter_deltas(before)
    assert delta.get("serving.jit_trace", 0) == 0
    assert delta.get("serving.jit_cache_hit", 0) >= 1
    assert rep.metrics.get("serving.jit_trace", 0) == 0


# ------------------------------------------------------------ block select

@pytest.mark.parametrize("policy,kwargs", [
    ("best_fit", {"norm": "linf"}), ("nrt_prioritized", None),
    ("cbd", {"beta": 2.0}), ("cbdt", {"rho": 8.0}),
])
def test_scheduler_select_block_matches_host(policy, kwargs):
    """``select_block=True`` decides through the megakernel at T=1 (one
    ARRIVAL replayed on a snapshot of the pool) - decision for decision
    the host algorithm zoo's, and the reference's scheduler on the same
    requests, through its host zoo and through its own block select (the
    interpret-mode megakernel)."""
    caps = ReplicaCapacity(slots=4, kv_tokens=65536, prefill_budget=262144)
    ref_caps = RefCaps(slots=4, kv_tokens=65536, prefill_budget=262144)

    def drive(sched_cls=DVBPScheduler, caps=caps, req_cls=Request,
              **sched_kw):
        sched = sched_cls(policy, caps, kwargs, **sched_kw)
        rng = np.random.default_rng(5)
        live, t, picks = [], 0.0, []
        for rid in range(60):
            t += float(rng.integers(1, 8))
            while live and live[0][0] <= t:
                ft, r = live.pop(0)
                sched.finish(r, ft)
            req = req_cls(rid, t, int(rng.integers(16, 512)),
                          int(rng.integers(8, 1024)),
                          predicted_decode_len=int(rng.integers(8, 1024)))
            picks.append(sched.place(req, t))
            live.append((t + req.decode_len / 50.0, rid))
            live.sort()
        return (picks, sched.stats.replicas_opened), sched

    host, _ = drive()
    ref_host, _ = drive(RefScheduler, ref_caps, RefRequest)
    ref_block, ref_sched = drive(RefScheduler, ref_caps, RefRequest,
                                 select_backend="pallas_interpret",
                                 select_block=True)
    plan = faults.install("kernel.select_block:slow:1:0:0")
    try:
        block, sched = drive(select_backend="device", device="cpu",
                             select_block=True)
    finally:
        faults.clear()
    assert block == host == ref_host == ref_block
    assert sched.last_select_backend == "torch_block"
    assert plan.calls["kernel.select_block"] == 60


def test_select_block_injected_fault_steps_down():
    """An injected fault in the block select steps down to the per-request
    select, then the host zoo; decisions are unchanged."""
    reqs = [Request(i, float(i), 64 + 32 * i, 64, 64) for i in range(12)]

    def drive(**kw):
        sched = DVBPScheduler("first_fit", CAPS, **kw)
        return [sched.place(r, r.arrival) for r in reqs], sched

    host, _ = drive()
    before = obs.counters()
    with faults.injected("kernel.select_block:xla:2:3,serving.select:xla:3:1"):
        got, sched = drive(select_backend="device", device="cpu",
                           select_block=True)
    delta = obs.counter_deltas(before)
    assert got == host
    assert delta.get("resilience.degrade_select_torch_block_torch", 0) == 3
    assert delta.get("resilience.degrade_select_torch_host", 0) == 1


def test_select_block_equals_select_on_random_pools():
    """``ops.fitscore_select_block`` == ``ops.fitscore_select`` (counts 1,
    a category mask for cbd) and the reference's ``fitscore_select_block``
    (interpret mode) on random pools, tied loads and full ones."""
    rng = np.random.default_rng(11)
    for trial in range(40):
        n = int(rng.integers(1, 40))
        d = int(rng.integers(1, 6))
        loads = (rng.integers(0, 64, (n, d)) / 64.0).astype(np.float32)
        if trial % 5 == 0:
            loads[:] = 1.0
        alive = rng.random(n) < 0.8
        oseq = rng.permutation(n).astype(np.int32)
        aseq = rng.permutation(n).astype(np.int32)
        closes = rng.integers(0, 100, n).astype(np.float32)
        size = (rng.integers(1, 32, d) / 64.0).astype(np.float32)
        tags = rng.integers(0, 3, n).astype(np.int32)
        cat = int(rng.integers(0, 3)) if trial % 2 else None
        policy = fk.SELECT_POLICIES[trial % len(fk.SELECT_POLICIES)] \
            if cat is None else "first_fit"
        t = torch.from_numpy
        slot, found = ops.fitscore_select_block(
            t(loads), t(alive), t(oseq), t(aseq), t(closes), t(size),
            60.0, 50.0, cat=cat, tags=None if cat is None else t(tags),
            policy=policy, n=n, d=d)
        lp = np.zeros((1, n, fk.DPAD), np.float32)
        lp[0, :, :d] = loads
        sp = np.zeros((1, fk.DPAD), np.float32)
        sp[0, :d] = size
        dm = np.zeros((1, fk.DPAD), np.float32)
        dm[0, :d] = 1.0
        s2, f2, _ = ops.fitscore_select(
            t(lp), torch.ones((1, n), dtype=torch.int32), t(alive[None]),
            t(oseq[None]), t(aseq[None]), t(closes[None]), t(sp),
            torch.tensor([60.0]), torch.tensor([50.0]), t(dm),
            None if cat is None else t((tags == cat)[None]), policy=policy)
        j = jnp.asarray
        s3, f3 = ref_ops.fitscore_select_block(
            j(loads), j(alive), j(oseq), j(aseq), j(closes), j(size),
            60.0, 50.0, cat=cat, tags=None if cat is None else j(tags),
            policy=policy, n=n, d=d, impl="pallas_interpret")
        assert bool(found) == bool(f2[0]) == bool(f3), trial
        if bool(found):
            assert int(slot) == int(s2[0]) == int(s3), trial


# ---------------------------------------------------------- live carry

def test_live_carry_grows_virgin_slots_and_refuses_hybrid():
    carry = torchsim.make_live_carry("rcp", 4, 3, 16, device="cpu")
    assert set(carry) == set(fk.replay_carry_names("rcp"))
    assert carry["loads"].shape == (1, 4, fk.DPAD)
    grown = torchsim.grow_live_carry(carry, 8, 3)
    fresh = torchsim.make_live_carry("rcp", 8, 3, 16, device="cpu")
    for k in carry:
        assert torch.equal(grown[k], fresh[k]), k
    assert torchsim.grow_live_carry(grown, 8, 3) is grown
    with pytest.raises(ValueError, match="clairvoyant-only"):
        torchsim.make_live_carry("hybrid", 4, 3)


# ------------------------------------------------------------- admission

def test_shed_deadline_before_queue_full():
    """A full queue evicts deadline-expired entries before it ever sheds a
    fresh arrival - the two counters are deterministic."""
    q = AdmissionQueue(None, max_pending=2, deadline=1.0, batch_max=4)
    assert q.submit(Request(0, 0.0, 64, 32), now=0.0)
    assert q.submit(Request(1, 0.1, 64, 32), now=0.1)
    assert q.submit(Request(2, 2.0, 64, 32), now=2.0)
    assert q.stats.shed_deadline >= 1
    assert q.stats.shed_queue_full == 0
    assert q.submit(Request(3, 2.0, 64, 32), now=2.0)
    assert not q.submit(Request(4, 2.1, 64, 32), now=2.1)
    assert q.stats.shed_queue_full == 1


def test_take_sheds_expired_and_keeps_survivors():
    q = AdmissionQueue(None, max_pending=8, deadline=1.0, batch_max=8)
    q.submit(Request(0, 0.0, 64, 32), now=0.0)
    q.submit(Request(1, 1.5, 64, 32), now=1.5)
    got = q.take(now=2.0)
    assert [r.rid for r, _ in got] == [1]
    assert q.stats.shed_deadline == 1
    with pytest.raises(ValueError):
        q.drain(now=2.0)


def test_drain_places_in_deadline_order():
    sched = DVBPScheduler("first_fit", CAPS)
    q = AdmissionQueue(sched, max_pending=8, deadline=5.0, batch_max=8)
    q.submit(Request(0, 0.0, 64, 32), now=0.0, deadline=4.0)
    q.submit(Request(1, 0.0, 64, 32), now=0.0, deadline=1.0)
    assert [rid for rid, _ in q.drain(now=0.5)] == [1, 0]
    assert q.stats.placed == 2


def test_demand_vector_memoized():
    before = obs.counters()
    a = _demand_vector(128, 64, CAPS)
    b = _demand_vector(128, 64, CAPS)
    assert a is b and not a.flags.writeable
    assert obs.counter_deltas(before).get("serving.size_memo_hit", 0) >= 1
    np.testing.assert_array_equal(Request(0, 0.0, 128, 64).size(CAPS), a)


# ------------------------------------------------------------ front end

def test_dispatch_histogram_counters_surface_in_metrics():
    reqs = poisson_requests(50, rate=50.0, seed=9, sigma_pred=0.3)
    rep = serve_traffic(reqs, "best_fit_linf", CAPS, tps=TPS, batch_max=8,
                        device="cpu")
    m = rep.metrics
    assert m.get("serving.dispatch_batch_size.count", 0) >= 1
    assert m.get("serving.dispatch_batch_size.sum", 0) == len(reqs) * 2
    assert any(k.startswith("serving.dispatch_batch_size.le_") for k in m)
    assert m.get("serving.queue_depth.count", 0) >= 1


def test_latencies_recorded_per_placed_request():
    reqs = poisson_requests(40, rate=50.0, seed=10, sigma_pred=0.3)
    rep = serve_traffic(reqs, "best_fit_linf", CAPS, tps=TPS, batch_max=8,
                        device="cpu")
    assert rep.placed == len(reqs) == len(rep.latencies)
    assert all(x >= 0 for x in rep.latencies)
    p50, p99 = rep.latency_quantiles()
    assert 0 <= p50 <= p99


def test_front_end_rejects_adaptive_alpha_policies():
    """PPE needs real durations at departure - unsupported live."""
    with pytest.raises(ValueError, match="PPE"):
        BlockDispatcher("ppe", CAPS, TPS, device="cpu")


def test_front_end_force_drains_before_finish():
    fe = BatchedFrontEnd("best_fit_linf", CAPS, tps=TPS, batch_max=64,
                         device="cpu")
    fe.submit(Request(0, 0.0, 64, 32, 32), now=0.0)
    fe.submit(Request(1, 0.1, 64, 32, 32), now=0.1)
    fe.finish(0, now=0.5)       # rid 0 not yet dispatched: must drain first
    fe.sync()
    assert set(fe.placements) == {0, 1}


def test_item_rows_grow_past_max_items():
    reqs = poisson_requests(60, rate=2000.0, seed=12, sigma_pred=0.3)
    rep = serve_traffic(reqs, "best_fit_linf", CAPS, tps=TPS, batch_max=8,
                        max_items=4, device="cpu")
    assert (rep.placements, _fleet(rep)) == \
        _oracle(reqs, "best_fit", {"norm": "linf"})


# ------------------------------------------------------------ drain pass

def _drain_caps(cls):
    return cls(slots=4, kv_tokens=1 << 20, prefill_budget=1 << 20)


def test_serving_drain_pass_moves_migrant():
    """``BlockDispatcher.consolidate``: the lone occupant of an underloaded
    replica moves to the lowest-open_seq replica with headroom (source
    excluded), the source closes, and the churn stats say so - as in the
    reference's dispatcher."""
    def run(disp, req_cls):
        for rid in range(4):           # fill replica 0 (4 x 0.25 slots)
            disp.enqueue_arrival(req_cls(rid, float(rid), 64, 64),
                                 float(rid))
        disp.enqueue_arrival(req_cls(4, 4.0, 64, 64), 4.0)   # replica 1
        disp.sync()
        assert disp.placements[4] == 1
        for rid in (0, 1):
            disp.enqueue_departure(rid, 5.0 + rid)
        disp.sync()
        stats = disp.consolidate(8.0, "underload:t0.3")
        again = disp.consolidate(9.0, "underload:t0.3")["migrations"]
        return (stats, again, dict(disp.placements), disp._open_now,
                disp.replica_seconds)

    disp = BlockDispatcher("first_fit", _drain_caps(ReplicaCapacity),
                           tps=50.0, max_bins=8, max_items=16, device="cpu")
    c0 = obs.counter_get("consolidate.migrations")
    got = run(disp, Request)
    assert got[0] == {"migrations": 1, "bins_closed": 1,
                      "budget_exhausted": 0}
    assert obs.counter_get("consolidate.migrations") == c0 + 1
    assert got[2][4] == 0 and disp._rid_slot[4] == disp._rid_slot[2]
    assert got[3] == 1 and got[1] == 0
    ref = run(RefDispatcher("first_fit", _drain_caps(RefCaps), tps=50.0,
                            max_bins=8, max_items=16, impl="jnp"),
              RefRequest)
    assert got == ref


def test_serving_drain_respects_budget():
    def run(disp, req_cls):
        for rid in range(4):
            disp.enqueue_arrival(req_cls(rid, float(rid), 64, 64),
                                 float(rid))
        for rid in (4, 5):
            disp.enqueue_arrival(req_cls(rid, 4.0, 64, 64), 4.0)
        disp.sync()
        for rid in range(3):           # replica 0 down to one occupant
            disp.enqueue_departure(rid, 5.0 + rid)
        disp.sync()
        return disp.consolidate(8.0, "underload:t0.3:b0")

    stats = run(BlockDispatcher("first_fit", _drain_caps(ReplicaCapacity),
                                tps=50.0, max_bins=8, max_items=16,
                                device="cpu"), Request)
    assert stats["migrations"] == 0 and stats["budget_exhausted"] >= 1
    assert stats == run(RefDispatcher("first_fit", _drain_caps(RefCaps),
                                      tps=50.0, max_bins=8, max_items=16,
                                      impl="jnp"), RefRequest)
