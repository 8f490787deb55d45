"""The port's observability layer (``repro_torch.obs``) on the scenarios of
``tests/test_obs.py``, held against the JAX package where both compute
the same thing.

* Counters are always on, spans only while recording; the disabled span
  is one shared no-op; spans nest and ``annotate`` reaches the innermost;
  ``timeit`` keeps every rep.  The port's state is its own: its counters
  and spans never show in the reference's collector.
* Replay traces: every lane's traced open-bin series equals the port's
  oracle event for event, for one policy of each family; the traces equal
  the reference's traced jnp scan (``diff_traces`` is None); tracing leaves
  the results bit for bit as untraced (``trace_level=0``) and takes the
  per-event path when blocks are asked for; the windowed loop the card
  runs as CUDA graphs traces as the eager loop does; ``diff_traces``
  pinpoints an injected divergence at its (lane, event, field).
* Spans and counters of the ported modules, under the reference's names,
  exported to Perfetto JSON and to a JSONL run log that ``python -m
  repro_torch obs`` summarizes; ``torch_profile`` writes a trace when
  given a log directory and does nothing without one."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro.obs as ref_obs
from repro.sweep import pack_instances as ref_pack
from repro.sweep import pad_predictions as ref_pad
from repro.sweep import run_batch as ref_run_batch
from repro_torch import obs
from repro_torch.core import Instance, run as oracle_run
from repro_torch.core import torchsim
from repro_torch.kernels import fitscore as fk
from repro_torch.obs.trace import (ARRIVAL_KIND, DEPARTURE_KIND, PAD_KIND,
                                   TraceDivergence)
from repro_torch.sweep import pack_instances, pad_predictions, run_batch

# one policy of each kernel family
FAMILY_POLICIES = ("best_fit_linf", "cbd", "reduced_hybrid", "rcp",
                   "la_binary", "adaptive")


def quantized_instance(seed, n, d):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 24, (n, d)) / 64.0
    arr = np.sort(rng.integers(0, 50000, n)).astype(float)
    dur = rng.integers(10, 5000, n).astype(float)
    return Instance(sizes, arr, arr + dur, f"q{seed}").sorted_by_arrival()


@pytest.fixture(scope="module")
def traced_batch():
    """tests/test_obs.py's lanes: mixed sizes and dims, clairvoyant and
    power-of-two noise rows - every lane has PAD events."""
    insts = [quantized_instance(1, 40, 2), quantized_instance(2, 60, 4),
             quantized_instance(3, 30, 3)]
    batch = pack_instances(insts)
    preds = []
    for i in insts:
        rng = np.random.default_rng(100)
        noisy = i.durations * rng.choice([0.25, 0.5, 1.0, 2.0, 4.0],
                                         i.n_items)
        preds.append(np.stack([i.durations, noisy]))
    return insts, preds, batch, pad_predictions(batch, preds)


def _traced(traced_batch, policy, **kw):
    _, _, batch, pdeps = traced_batch
    return run_batch(batch, policy, pdeps, max_bins=32, device="cpu",
                     trace_level=1, **kw)


# --------------------------------------------------------- spans + counters

def test_counters_always_on_and_separate_from_the_reference():
    c0 = obs.counter_get("test.obs.x")
    r0 = ref_obs.counter_get("test.obs.x")
    obs.counter_add("test.obs.x")
    obs.counter_add("test.obs.x", 2.5)
    assert obs.counter_get("test.obs.x") == c0 + 3.5
    assert ref_obs.counter_get("test.obs.x") == r0
    before = obs.counters()
    obs.counter_add("test.obs.y", 7)
    assert obs.counter_deltas(before) == {"test.obs.y": 7}
    obs.counter_hist("test.obs.h", 3)
    assert obs.counter_get("test.obs.h.le_4") >= 1


def test_disabled_span_is_shared_noop():
    prev = obs.enabled()
    obs.enable(False)
    try:
        n0 = len(obs.events())
        s1 = obs.span("test.noop", foo=1)
        assert s1 is obs.span("test.other")
        with s1:
            obs.annotate(bar=2)
        obs.instant("test.instant")
        assert len(obs.events()) == n0
    finally:
        obs.enable(prev)


def test_recording_spans_nesting_and_annotate():
    with obs.recording():
        with obs.span("test.outer", a=1):
            with obs.span("test.inner"):
                obs.annotate(hit=True)
        evs = [e for e in obs.events() if e["name"].startswith("test.")]
        assert not [e for e in ref_obs.events()
                    if e["name"].startswith("test.")]
    assert [e["name"] for e in evs] == ["test.inner", "test.outer"]
    inner, outer = evs
    assert inner["cat"] == "test" and inner["args"] == {"hit": True}
    assert outer["args"] == {"a": 1}
    assert outer["dur"] >= inner["dur"] >= 0 and outer["ts"] <= inner["ts"]

    @obs.traced("test.deco")
    def f(x):
        return x + 1

    with obs.recording():
        assert f(1) == 2
        assert any(e["name"] == "test.deco" for e in obs.events())


def test_timeit_stats_and_row():
    calls = []
    st = obs.timeit(lambda: calls.append(sum(range(100))), n=4, warmup=1)
    assert len(calls) == 5 and st.n == 4
    assert st.best <= st.median <= max(st.reps)
    assert st.stdev >= 0 and st.mean > 0
    row = st.row("perf/x", "1.23", scale=0.5)
    assert row.startswith(f"perf/x,{st.best * 0.5e6:.1f},1.23  # med=")
    assert row.endswith(" n=4")


def test_kind_constants_match_the_kernel_and_the_reference():
    from repro.obs import trace as ref_trace
    for k in ("ARRIVAL_KIND", "DEPARTURE_KIND", "PAD_KIND"):
        assert getattr(obs.trace, k) == getattr(fk, k) == \
            getattr(ref_trace, k)
    assert obs.trace.TRACE_FIELDS == ref_trace.TRACE_FIELDS


# ----------------------------------------------------------- replay traces

def _oracle_open_bins(inst, policy, pred):
    """The oracle's open-bin count after each event (its bins are absolute,
    the replay's slots reused, so the count is what compares)."""
    r = oracle_run(inst, torchsim.host_algorithm(policy),
                   predicted_durations=pred)
    _, kinds, items = torchsim.event_sequence(inst)
    counts, series = {}, []
    for kind, item in zip(kinds, items):
        b = r.placements[item]
        if kind == ARRIVAL_KIND:
            counts[b] = counts.get(b, 0) + 1
        else:
            counts[b] -= 1
            if counts[b] == 0:
                del counts[b]
        series.append(len(counts))
    return r, np.array(series)


@pytest.mark.parametrize("policy", FAMILY_POLICIES)
def test_trace_series_matches_the_port_oracle(policy, traced_batch):
    insts, preds, *_ = traced_batch
    res = _traced(traced_batch, policy)
    tr = res.trace
    assert tr is not None and tr.policy == policy and tr.L == 6
    for bi, inst in enumerate(insts):
        for si in range(2):
            r, want = _oracle_open_bins(inst, policy, preds[bi][si])
            s = tr.series(bi * 2 + si)
            assert len(s["open_bins"]) == 2 * inst.n_items
            assert (s["open_bins"] == want).all(), (policy, inst.name, si)
            assert s["usage"][-1] == res.usage_time[bi, si] == r.usage_time
            assert (s["slot"][s["kind"] == ARRIVAL_KIND] >= 0).all()
            assert (s["kind"] != PAD_KIND).all()
        pad = tr.kinds[bi * 2] == PAD_KIND
        assert (tr.slot[bi * 2][pad] == -1).all()
        assert (tr.tag[bi * 2][pad] == -1).all()


@pytest.mark.parametrize("policy", ["cbd", "rcp"])
def test_trace_equals_the_reference_trace(policy, traced_batch):
    """The port's trace and the reference's traced jnp scan agree on every
    series of every event (the instances are fp32-exact, so the load sums
    are exact in any order)."""
    insts, preds, *_ = traced_batch
    rb = ref_pack(insts)
    want = ref_run_batch(rb, policy, ref_pad(rb, preds), max_bins=32,
                         backend="jnp", trace_level=1).trace
    got = _traced(traced_batch, policy).trace
    assert obs.diff_traces(got, want) is None
    assert got.load.shape == want.load.shape


def test_trace_level0_bit_identical_and_blocked_requests(traced_batch):
    _, _, batch, pdeps = traced_batch
    a = run_batch(batch, "best_fit_linf", pdeps, max_bins=32, device="cpu")
    b = _traced(traced_batch, "best_fit_linf")
    c = _traced(traced_batch, "best_fit_linf", block_events=16)
    assert a.trace is None and b.trace is not None
    for f in ("usage_time", "n_bins_opened", "max_bins"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert obs.diff_traces(b.trace, c.trace) is None
    two = run_batch(batch, "ppe", pdeps, max_bins=1, device="cpu",
                    trace_level=2)
    assert two.trace.alive.shape[:2] == two.trace.slot.shape
    assert (two.trace.alive.sum(axis=2) == two.trace.open_bins).all()
    assert (two.max_bins > 1).any()          # through the overflow ladder


@pytest.mark.parametrize("policy", ["best_fit_l2", "hybrid", "ppe"])
def test_windowed_traced_replay_equals_eager(policy, traced_batch,
                                             monkeypatch):
    """The trace's step counter lives in a tensor: a window body replayed
    as the card replays its CUDA graph (the stand-in graph of
    ``tests/test_torch_step_windows.py``) writes the next window's
    columns."""
    eager = _traced(traced_batch, policy).trace
    from test_torch_step_windows import RecordedGraph
    monkeypatch.setattr(torchsim, "_Graph", RecordedGraph)
    monkeypatch.setattr(
        torchsim, "_run_events",
        lambda step, S, ev, ex, dev: torchsim.replay_windows(
            step, S, ev, ex, 16))
    windowed = _traced(traced_batch, policy).trace
    assert windowed.E > 3 * 16
    assert obs.diff_traces(windowed, eager) is None


def test_diff_traces_pinpoints_injected_divergence(traced_batch):
    tr = _traced(traced_batch, "best_fit_linf").trace
    assert obs.diff_traces(tr, tr) is None
    lane = 3
    ev = int(np.where(tr.kinds[lane] == ARRIVAL_KIND)[0][5])
    slot = tr.slot.copy()
    slot[lane, ev] += 1
    mutated = dataclasses.replace(tr, slot=slot)
    d = obs.diff_traces(tr, mutated)
    assert isinstance(d, TraceDivergence)
    assert (d.lane, d.event, d.field) == (lane, ev, "slot")
    assert d.b_value == d.a_value + 1 and d.kind == ARRIVAL_KIND
    assert "slot" in str(d) and f"lane {lane}" in str(d)
    assert "arrival" in str(d)
    kinds = tr.kinds.copy()
    kinds[0, 0] = PAD_KIND if kinds[0, 0] != PAD_KIND else DEPARTURE_KIND
    d2 = obs.diff_traces(tr, dataclasses.replace(mutated, kinds=kinds))
    assert (d2.lane, d2.event, d2.field) == (0, 0, "kind")
    with pytest.raises(ValueError, match="shapes differ"):
        obs.diff_traces(tr, tr.lane(0))


def test_trace_lane_view(traced_batch):
    tr = _traced(traced_batch, "rcp").trace
    one = tr.lane(2)
    assert one.L == 1 and one.E == tr.E and one.S == 1
    assert (one.slot[0] == tr.slot[2]).all()
    assert (one.usage[0] == tr.usage[2]).all()


# ---------------------------------------- spans of the ported modules, export

def test_sweep_spans_counters_and_perfetto(tmp_path):
    from repro_torch.sweep import PredModel, SuiteSpec, SweepSpec, SweepStore
    from repro_torch.sweep import run_sweep
    spec = SweepSpec(suites=(SuiteSpec("azure", 2, 60, 81),),
                     policies=("first_fit", "greedy"),
                     predictions=(PredModel("clairvoyant"),), seeds=(0,))
    store = SweepStore(str(tmp_path / "sweeps"))
    before = obs.counters()
    with obs.recording():
        run_sweep(spec, store, device="cpu")
        events = obs.events()
    moved = obs.counter_deltas(before)
    assert moved["experiment.cache_miss"] == 2
    assert moved["sweep.scan_calls"] == 2
    assert moved["sweep.device_transfer_bytes"] > 0
    assert moved["store.save"] == 2 and moved["store.load"] == 1
    names = {e["name"] for e in events}
    assert {"sweep.run_batch", "sweep.scan", "sweep.flatten", "sweep.pad",
            "pack.instances", "store.save", "store.load"} <= names
    cats = {e["cat"] for e in events}
    assert {"sweep", "store", "pack"} <= cats
    scan = next(e for e in events if e["name"] == "sweep.scan")
    assert scan["args"]["policy"] in ("first_fit", "greedy")
    before = obs.counters()
    run_sweep(spec, store, device="cpu")
    assert obs.counter_deltas(before)["experiment.cache_hit"] == 2
    out = tmp_path / "trace.json"
    obs.export_perfetto(str(out), events)
    doc = json.loads(out.read_text())
    assert len({e["cat"] for e in doc["traceEvents"]}) >= 3
    assert all({"name", "ph", "ts", "dur", "pid", "tid"} <= e.keys()
               for e in doc["traceEvents"])


def test_consolidate_and_serving_spans():
    from repro_torch.consolidate import ConsolidationSpec
    from repro_torch.serving.scheduler import DVBPScheduler, Request
    insts = [quantized_instance(1, 40, 3), quantized_instance(2, 40, 3)]
    batch = pack_instances(insts)
    before = obs.counters()
    with obs.recording():
        run_batch(batch, "first_fit", device="cpu",
                  consolidate=ConsolidationSpec.parse("underload:t0.5:e8"))
        host = DVBPScheduler("first_fit")
        host.place(Request(0, 0.0, 256, 800, 800), 0.0)
        dev = DVBPScheduler("cbd", select_backend="device", device="cpu")
        dev.place(Request(1, 0.0, 256, 800, 800), 0.0)
        events = obs.events()
    moved = obs.counter_deltas(before)
    assert moved["consolidate.migrations"] > 0
    assert "consolidate.bins_closed" in moved
    names = [e["name"] for e in events]
    assert "consolidate.replay" in names and "consolidate.plan" in names
    sel = [e for e in events if e["name"] == "serving.select"]
    assert [e["args"]["backend"] for e in sel] == ["host", "torch"]
    assert [e["args"]["policy"] for e in sel] == ["first_fit", "cbd"]
    assert (host.last_select_backend, dev.last_select_backend) == \
        ("host", "torch")
    assert moved["serving.select_host"] == moved["serving.select_torch"] == 1


def test_jsonl_roundtrip_and_cli(tmp_path, capsys):
    from repro_torch.obs.cli import main as obs_cli
    with obs.recording():
        with obs.span("test.io", k="v"):
            pass
        events = [e for e in obs.events() if e["name"] == "test.io"]
    log = str(tmp_path / "run.obs.jsonl")
    obs.export_jsonl(log, events, {"test.io.counter": 3},
                     meta={"suite": "unit"})
    evs, counters, meta = obs.read_jsonl(log)
    assert [e["name"] for e in evs] == ["test.io"]
    assert evs[0]["args"] == {"k": "v"}
    assert counters == {"test.io.counter": 3}
    assert meta["suite"] == "unit" and meta["schema"] == 1
    perfetto = str(tmp_path / "t.json")
    assert obs_cli([log, "--perfetto", perfetto]) == 0
    out = capsys.readouterr().out
    assert "test.io" in out and "test.io.counter" in out
    assert "suite=unit" in out
    assert json.loads(open(perfetto).read())["traceEvents"]
    from repro_torch.__main__ import main as port_main
    with pytest.raises(SystemExit) as done:     # python -m repro_torch obs
        port_main(["obs", log])
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert "test.io" in out and "suite=unit" in out


def test_torch_profile_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_OBS_PROFILE", raising=False)
    with obs.torch_profile() as path:
        assert path is None
    with obs.recording():
        with obs.torch_profile(str(tmp_path / "prof")) as path:
            torch.ones(8).add_(1)
        events = obs.events()
    assert os.path.exists(path)
    assert json.loads(open(path).read())["traceEvents"]
    assert [e["name"] for e in events] == ["profiler.torch_trace"]


def test_torch_profile_sessions_do_not_nest_and_skip_the_lead_in(
        tmp_path, monkeypatch):
    """A torch_profile inside another (run_batch opens one around each
    replay dispatch) is a no-op, so the outer trace holds the inner block;
    without a card no lead-in kernels are launched."""
    monkeypatch.setenv("REPRO_OBS_PROFILE", str(tmp_path / "env"))
    from repro_torch.obs import export
    monkeypatch.setattr(export, "_lead_in", lambda torch: pytest.fail(
        "a lead-in on the CPU"))
    with obs.recording():
        with obs.torch_profile(str(tmp_path / "outer")) as outer:
            with obs.torch_profile(str(tmp_path / "inner")) as inner:
                torch.ones(8).mul_(3)
            batch = pack_instances([quantized_instance(1, 12, 3)])
            run_batch(batch, "first_fit", max_bins=8, device="cpu")
        events = obs.events()
    assert inner is None and not os.path.exists(tmp_path / "inner")
    assert not os.path.exists(tmp_path / "env")
    names = {e["name"] for e in json.load(open(outer))["traceEvents"]}
    assert "aten::mul_" in names
    assert [e["name"] for e in events].count("profiler.torch_trace") == 1
    with obs.torch_profile() as path:       # the env's directory
        pass
    assert os.path.dirname(path) == str(tmp_path / "env")


@pytest.mark.parametrize("spins,lost", [(3, 0), (0, 1)])
def test_lead_in_survivors_counts_and_warns_on_a_lost_lead_in(
        tmp_path, spins, lost):
    """A card trace is checked for the lead-in's spin kernels: a trace
    with none of them is counted as ``profiler.lead_in_lost`` and warned
    about, so a loss past the lead-in is seen, not silent."""
    from repro_torch.obs import export
    evs = [{"cat": "kernel", "name": "spin_kernel(long)", "ts": i}
           for i in range(spins)]
    evs.append({"cat": "kernel", "name": "replay_warp_kernel", "ts": 9})
    evs.append({"cat": "cpu_op", "name": "spin_kernel", "ts": 10})
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": evs}, f)
    with obs.recording():
        if lost:
            with pytest.warns(RuntimeWarning, match="lead-in"):
                n = export.lead_in_survivors(path)
        else:
            n = export.lead_in_survivors(path)
        assert obs.counter_get("profiler.lead_in_lost") == lost
    assert n == spins
