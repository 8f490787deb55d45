"""The port's resilience layer (``repro_torch.resilience``) against the
reference's: fault plans, the guard and its strict classifier, the
degradation ladder, checkpoint/resume, store recovery, the scheduler's
guarded select and ``validate`` - and the chaos runs of the sweep CLI,
killed and resumed in subprocesses.

The contract: an injected failure changes how a result is computed (a
retry, a lower rung, a resumed scan, a journal rebuild), never what is
computed - usage and decisions stay equal bit for bit to the fault-free
run and to the JAX package's."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.sweep as ref_sweep
from repro.core.jaxsim import _replay_batch as ref_replay_batch
from repro.resilience import faults as ref_faults
from repro.resilience import validate as ref_validate
from repro.serving.scheduler import DVBPScheduler as RefScheduler
from repro.serving.scheduler import ReplicaCapacity as RefCaps
from repro.serving.scheduler import Request as RefRequest
from test_resilience import _migrate_stream, quantized_instance

import repro_torch.sweep as port_sweep
from repro_torch import obs
from repro_torch.core import Instance
from repro_torch.core import torchsim
from repro_torch.resilience import checkpoint, faults, guard, validate
from repro_torch.resilience.checkpoint import ReplayCheckpointer
from repro_torch.serving.scheduler import (DVBPScheduler, ReplicaCapacity,
                                           Request)
from repro_torch.sweep.runner import _flatten_lanes

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")

# one scan policy a family: score / cbd / rcp / la / adaptive
FAMILY_POLICIES = ("greedy", "cbd", "rcp", "la_binary", "adaptive")

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    """No ambient fault plan in either package, no backoff sleeps."""
    monkeypatch.setenv("REPRO_TORCH_RESILIENCE_BACKOFF_SCALE", "0")
    monkeypatch.setenv("REPRO_RESILIENCE_BACKOFF_SCALE", "0")
    monkeypatch.delenv("REPRO_TORCH_FAULTS", raising=False)
    monkeypatch.delenv("REPRO_FAULTS", raising=False)
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


def _port_instance(inst):
    return Instance(inst.sizes, inst.arrivals, inst.departures, inst.name)


@pytest.fixture(scope="module")
def batches():
    ref = [quantized_instance(s) for s in (1, 2, 3)]
    return (ref_sweep.pack_instances(ref),
            port_sweep.pack_instances([_port_instance(i) for i in ref]))


def _ref_usage(batch, policy):
    return ref_sweep.run_batch(batch, policy, max_bins=64, backend="jnp",
                               shard="never")


# ------------------------------------------------------------ fault plans

def test_fault_spec_arming_and_glob():
    plan = faults.parse_plan("a.b:error:2:2")
    assert plan.on_call("a.b") is None           # call 1: not armed yet
    assert plan.on_call("a.b").kind == "error"   # calls 2 and 3 fire
    assert plan.on_call("a.b").kind == "error"
    assert plan.on_call("a.b") is None           # count spent
    assert plan.calls["a.b"] == 4
    forever = faults.parse_plan("sweep.*:xla:1:0")
    assert all(forever.on_call("sweep.scan").kind == "xla"
               for _ in range(5))
    assert forever.on_call("store.load") is None


@pytest.mark.parametrize("kind,match", [("oom", "RESOURCE_EXHAUSTED"),
                                        ("xla", "INTERNAL"),
                                        ("error", "injected fault")])
def test_fire_raises_counts_and_keeps_the_messages(kind, match):
    c0 = obs.counter_get(f"resilience.fault_{kind}")
    with faults.injected(f"x.y:{kind}"):
        with pytest.raises(faults.InjectedFault, match=match) as e:
            faults.fire("x.y")
    assert e.value.kind == kind
    assert obs.counter_get(f"resilience.fault_{kind}") == c0 + 1
    with ref_faults.injected(f"x.y:{kind}"):
        with pytest.raises(ref_faults.InjectedFault) as r:
            ref_faults.fire("x.y")
    assert str(e.value) == str(r.value)
    faults.fire("x.y")    # plan gone: a no-op


def test_parse_plan_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.parse_plan("a.b:meteor")


def test_each_package_reads_its_own_variable(monkeypatch):
    """REPRO_TORCH_FAULTS arms the port only, REPRO_FAULTS the reference
    only: the parity tests run both packages in one process."""
    monkeypatch.setenv("REPRO_TORCH_FAULTS", "x.y:error")
    for mod in (faults, ref_faults):
        monkeypatch.setattr(mod, "_PLAN", None)
        monkeypatch.setattr(mod, "_ENV_CHECKED", False)
    ref_faults.fire("x.y")
    with pytest.raises(faults.InjectedFault):
        faults.fire("x.y")
    monkeypatch.setenv("REPRO_FAULTS", "x.y:error")
    monkeypatch.delenv("REPRO_TORCH_FAULTS")
    for mod in (faults, ref_faults):
        monkeypatch.setattr(mod, "_PLAN", None)
        monkeypatch.setattr(mod, "_ENV_CHECKED", False)
    faults.fire("x.y")
    with pytest.raises(ref_faults.InjectedFault):
        ref_faults.fire("x.y")


# ------------------------------------------------------- guarded dispatch

@pytest.mark.parametrize("error", [
    faults.InjectedFault("RESOURCE_EXHAUSTED: injected", "oom"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
])
def test_guarded_call_retries_an_oom(error):
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise error
        return 7

    c0 = obs.counter_get("resilience.retry")
    assert guard.guarded_call(flaky, site="t", retries=2) == 7
    assert len(attempts) == 3
    assert obs.counter_get("resilience.retry") == c0 + 2


# stand-ins for what must never degrade: a sticky CUDA error (the context
# is lost), a build failure, a shape error, a bug
NOT_DEGRADABLE = [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("INTERNAL: fitscore_select (warp kernel) launch failed: "
                 "unspecified launch failure"),
    RuntimeError("nvcc failed building select.cu"),
    ValueError("fitscore_select: loads must be (L, Np, 8)"),
    AssertionError("a bug"),
]


@pytest.mark.parametrize("error", NOT_DEGRADABLE)
def test_ladder_propagates_real_errors(error):
    rungs = guard.replay_rungs("cuda", 256)
    seen = []

    def attempt(rung):
        seen.append(rung.label)
        raise error

    before = obs.counters()
    with pytest.raises(type(error)):
        guard.run_ladder(attempt, rungs, site="t")
    assert seen == ["blocked"]     # no retry, no lower rung
    assert not {k for k in obs.counter_deltas(before)
                if k.startswith("resilience.")}
    assert not guard.is_degradable(error) and not guard.is_transient(error)


@pytest.mark.parametrize("device,T,labels", [
    ("cuda", 256, ["blocked", "perevent", "cpu"]),
    ("cuda", 0, ["perevent", "cpu"]),
    ("cpu", 4, ["blocked", "cpu"]),
    ("cpu", 0, ["cpu"]),
])
def test_replay_rungs_ladder_shape(device, T, labels):
    assert [r.label for r in guard.replay_rungs(device, T)] == labels


def test_run_ladder_degrades_counts_and_last_rung_propagates():
    rungs = guard.replay_rungs("cuda", 4)

    def attempt(rung):
        if rung.device != "cpu":
            raise faults.InjectedFault("INTERNAL: kernel died", "xla")
        return rung.label

    c0 = (obs.counter_get("resilience.degrade_blocked_perevent"),
          obs.counter_get("resilience.degrade_cuda_cpu"))
    rung, out = guard.run_ladder(attempt, rungs, site="t")
    assert (rung.label, out) == ("cpu", "cpu")
    assert (obs.counter_get("resilience.degrade_blocked_perevent"),
            obs.counter_get("resilience.degrade_cuda_cpu")) == \
        (c0[0] + 1, c0[1] + 1)

    def dead(rung):
        raise faults.InjectedFault("INTERNAL: dead", "xla")
    with pytest.raises(faults.InjectedFault):
        guard.run_ladder(dead, guard.replay_rungs("cpu", 0), site="t")


@pytest.mark.parametrize("plan,device,counters", [
    # the megakernel dies once -> the per-event path serves
    ("sweep.scan:xla:1:1", "cpu", {"resilience.degrade_blocked_perevent": 1}),
    # blocked and per event on the card die -> the CPU serves (no card
    # here: the card is stood in for, and the injected faults fire before
    # either card rung touches the device)
    ("sweep.scan:xla:1:2", "cuda", {"resilience.degrade_blocked_perevent": 1,
                                    "resilience.degrade_cuda_cpu": 1}),
    # an OOM retries the same rung
    ("sweep.scan:oom:1:1", "cpu", {"resilience.retry": 1}),
])
def test_sweep_ladder_results_equal_fault_free(batches, plan, device,
                                               counters, monkeypatch):
    ref_b, port_b = batches
    ref = _ref_usage(ref_b, "greedy")
    base = port_sweep.run_batch(port_b, "greedy", max_bins=64, device="cpu",
                                block_events=4)
    if device == "cuda":
        monkeypatch.setattr(port_sweep.runner, "resolve_device",
                            torch.device)
    before = obs.counters()
    with faults.injected(plan):
        res = port_sweep.run_batch(port_b, "greedy", max_bins=64,
                                   device=device, block_events=4)
    moved = {k: v for k, v in obs.counter_deltas(before).items()
             if k.startswith("resilience.") and
             not k.startswith("resilience.fault_")}
    assert moved == counters
    for r in (base, ref):
        assert np.array_equal(res.usage_time, r.usage_time)
        assert np.array_equal(res.n_bins_opened, r.n_bins_opened)


def test_sweep_real_error_propagates_from_the_ladder(batches, monkeypatch):
    """A stand-in CUDA error on the blocked rung is raised, not routed
    around: no lower rung runs, no counter moves."""
    _, port_b = batches
    real = torchsim._replay_batch
    calls = []

    def broken(*a, block_events=0, **k):
        calls.append(block_events)
        if block_events > 1:
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        return real(*a, block_events=block_events, **k)

    monkeypatch.setattr(port_sweep.runner, "_replay_batch", broken)
    before = obs.counters()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        port_sweep.run_batch(port_b, "greedy", max_bins=64, device="cpu",
                             block_events=4)
    assert calls == [4]
    assert not {k for k in obs.counter_deltas(before)
                if k.startswith("resilience.")}


def _oom(*a, **k):
    raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")


@pytest.mark.parametrize("where", ["sweep", "scheduler"])
def test_real_oom_propagates_from_the_sweep_and_the_scheduler(
        batches, monkeypatch, where):
    """A real OOM on every attempt is retried on its own plan and then
    raised: it never steps down a rung, so card work never moves to the
    CPU or to the host zoo for a real failure."""
    before = obs.counters()
    if where == "sweep":
        _, port_b = batches
        plans = []

        def oom(*a, device=None, block_events=0, **k):
            plans.append((str(device), block_events))
            _oom()
        monkeypatch.setattr(port_sweep.runner, "_replay_batch", oom)
        # the card stood in for: the ladder has a cpu rung below it
        monkeypatch.setattr(port_sweep.runner, "resolve_device",
                            torch.device)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            port_sweep.run_batch(port_b, "greedy", max_bins=64,
                                 device="cuda", block_events=4)
        assert plans == [("cuda", 4)] * 3      # one try and two retries
    else:
        monkeypatch.setattr(DVBPScheduler, "_select_device", _oom)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            _drive_scheduler(DVBPScheduler, ReplicaCapacity, Request,
                             backend="device", device="cpu", n=3)
    moved = {k: v for k, v in obs.counter_deltas(before).items()
             if k.startswith("resilience.")}
    assert moved == {"resilience.retry": 2}


def test_sweep_refuses_a_missing_card_before_the_ladder(batches,
                                                        monkeypatch):
    """``device="cuda"`` with no card raises up front, even under a fault
    plan that would degrade to the CPU rung."""
    _, port_b = batches
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with faults.injected("sweep.scan:xla:1:2"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_sweep.run_batch(port_b, "greedy", max_bins=64,
                                 device="cuda", block_events=4)


# --------------------------------------------------------- checkpointing

def test_checkpoint_roundtrip(tmp_path):
    carry = {"a": np.arange(5), "b": (np.ones((2, 3), np.float32), None),
             "c": [torch.tensor([2.5]), torch.zeros(2, dtype=torch.bool)]}
    path = str(tmp_path / "c.npz")
    checkpoint.save_checkpoint(path, carry, {"digest": "x", "next_seg": 3})
    loaded, meta = checkpoint.load_checkpoint(path)
    assert meta == {"digest": "x", "next_seg": 3}
    assert np.array_equal(loaded["a"], carry["a"])
    assert isinstance(loaded["b"], tuple) and loaded["b"][1] is None
    assert np.array_equal(loaded["b"][0], carry["b"][0])
    assert isinstance(loaded["c"], list)
    back = checkpoint.to_device(loaded, "cpu")
    assert torch.equal(back["c"][0], carry["c"][0])
    assert back["c"][1].dtype == torch.bool


def test_checkpoint_tamper_quarantined(tmp_path):
    path = str(tmp_path / "c.npz")
    checkpoint.save_checkpoint(path, {"a": np.arange(8)}, {"digest": "x"})
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF                  # flip a payload byte
    open(path, "wb").write(bytes(blob))
    c0 = obs.counter_get("resilience.ckpt_corrupt")
    assert checkpoint.load_checkpoint(path) is None
    assert obs.counter_get("resilience.ckpt_corrupt") == c0 + 1
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)


def test_checkpoint_stale_meta_ignored(tmp_path):
    path = str(tmp_path / "c.npz")
    checkpoint.save_checkpoint(path, {"a": np.arange(3)}, {"digest": "x"})
    c0 = obs.counter_get("resilience.ckpt_stale")
    assert checkpoint.load_checkpoint(path, {"digest": "y"}) is None
    assert obs.counter_get("resilience.ckpt_stale") == c0 + 1
    assert os.path.exists(path)                   # stale stays in place


@pytest.mark.parametrize("block_events", [0, 4])
@pytest.mark.parametrize("policy", FAMILY_POLICIES)
def test_checkpointed_replay_equals_reference(batches, tmp_path, policy,
                                              block_events):
    """Segments of 16 events, per event and blocked, == the reference's
    unsegmented jnp replay (rcp: the full-stream category count)."""
    ref_b, port_b = batches
    ref = _ref_usage(ref_b, policy)
    ckpt = ReplayCheckpointer(str(tmp_path), every_events=16)
    res = port_sweep.run_batch(port_b, policy, max_bins=64, device="cpu",
                               block_events=block_events, checkpoint=ckpt,
                               checkpoint_key=policy)
    assert np.array_equal(res.usage_time, ref.usage_time)
    assert np.array_equal(res.n_bins_opened, ref.n_bins_opened)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".npz")]


@pytest.mark.parametrize("block_events", [0, 4])
@pytest.mark.parametrize("policy", ("first_fit", "rcp"))
def test_checkpointed_migrate_stream_and_resume(tmp_path, policy,
                                                block_events):
    """A MIGRATE-bearing stream (the reference suite's own) in segments of
    8 == the reference's unsegmented replay with ``migrate=True``; killed
    at its third segment and rerun, it resumes from the snapshot."""
    arrays = _migrate_stream()
    ref = [np.asarray(a) for a in ref_replay_batch(
        *arrays, policy=policy, max_bins=32, backend="jnp", migrate=True)]
    kw = dict(policy=policy, max_bins=32, device="cpu",
              block_events=block_events, migrate=True)
    out = checkpoint.checkpointed_replay(
        arrays, ckpt=ReplayCheckpointer(str(tmp_path), every_events=8),
        key="full", **kw)
    for got, want in zip(out, ref):
        assert np.array_equal(got.numpy(), want)
    ck = ReplayCheckpointer(str(tmp_path / "killed"), every_events=8)
    with faults.injected("ckpt.segment:error:3"):
        with pytest.raises(faults.InjectedFault):
            checkpoint.checkpointed_replay(arrays, ckpt=ck, key="k", **kw)
    c0 = obs.counter_get("resilience.ckpt_resume")
    out2 = checkpoint.checkpointed_replay(arrays, ckpt=ck, key="k", **kw)
    assert obs.counter_get("resilience.ckpt_resume") == c0 + 1
    for got, want in zip(out2, ref):
        assert np.array_equal(got.numpy(), want)


def test_segment_digest_covers_migrate_and_device(batches, tmp_path):
    """A snapshot taken without ``migrate`` is stale for a run with it."""
    _, port_b = batches
    flat = _flatten_lanes(port_b.sizes, port_b.times, port_b.kinds,
                          port_b.items, port_b.pdeps[:, None],
                          port_b.dmask, port_b.arrivals, port_b.pdeps,
                          port_b.n_items)
    ck = ReplayCheckpointer(str(tmp_path), every_events=16)
    with faults.injected("ckpt.segment:error:3"):
        with pytest.raises(faults.InjectedFault):
            checkpoint.checkpointed_replay(flat, policy="greedy",
                                           max_bins=64, device="cpu",
                                           ckpt=ck, key="k")
    c0 = (obs.counter_get("resilience.ckpt_stale"),
          obs.counter_get("resilience.ckpt_resume"))
    checkpoint.checkpointed_replay(flat, policy="greedy", max_bins=64,
                                   device="cpu", ckpt=ck, key="k",
                                   migrate=True)
    assert (obs.counter_get("resilience.ckpt_stale"),
            obs.counter_get("resilience.ckpt_resume")) == (c0[0] + 1, c0[1])


# ------------------------------------------------------- store resilience

def _small_spec(mod):
    return mod.SweepSpec(suites=(mod.SuiteSpec("azure", 2, 60, 5),),
                         policies=("first_fit", "greedy"),
                         predictions=(mod.PredModel("clairvoyant"),),
                         max_bins=32)


def test_store_truncate_fault_rebuilt_from_journal(tmp_path):
    """The injected torn write (store.save:truncate) on the last group's
    rewrite: the next load quarantines the main file and rebuilds every
    record from the journal; the records equal the reference's."""
    spec = _small_spec(port_sweep)
    store = port_sweep.SweepStore(str(tmp_path))
    with faults.injected("store.save:truncate:2:1"):    # 2 groups, 2 saves
        rec = port_sweep.run_sweep(spec, store=store, device="cpu")
    c0 = obs.counter_get("store.corrupt")
    with pytest.warns(RuntimeWarning, match="corrupt"):
        rec2 = port_sweep.run_sweep(spec, store=store, device="cpu")
    assert rec2 == rec
    assert obs.counter_get("store.corrupt") == c0 + 1
    assert os.path.exists(store.path(spec) + ".corrupt")
    assert rec == ref_sweep.run_sweep(_small_spec(ref_sweep), backend="jnp")


def test_store_journal_torn_tail_and_load_seam(tmp_path):
    spec = _small_spec(port_sweep)
    store = port_sweep.SweepStore(str(tmp_path))
    rec = port_sweep.run_sweep(spec, store=store, device="cpu")
    with open(store.journal_path(spec), "a") as f:
        f.write('{"suites_hash": "dead, torn mid-')     # crash mid-append
    c0 = obs.counter_get("store.journal_skipped")
    assert port_sweep.run_sweep(spec, store=store, device="cpu") == rec
    assert obs.counter_get("store.journal_skipped") == c0 + 1
    with faults.injected("store.load:error"):
        with pytest.raises(faults.InjectedFault):
            port_sweep.run_sweep(spec, store=store, device="cpu")


# ------------------------------------------------------ serving hardening

def _drive_scheduler(sched_cls, caps_cls, req_cls, backend="host", n=80,
                     **kw):
    caps = caps_cls(slots=4, kv_tokens=65536, prefill_budget=262144)
    sched = sched_cls("nrt_prioritized", caps, select_backend=backend, **kw)
    rng = np.random.default_rng(5)
    live, t, picks = [], 0.0, []
    for rid in range(n):
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
    return picks, sched


@pytest.mark.parametrize("plan,degrades", [("serving.select:xla:5:1", 1),
                                           ("serving.select:xla:1:0", 80)])
def test_serving_select_degrades_to_the_host_zoo(plan, degrades):
    """A failing device select (once, then every time) hands the decision
    to the host zoo: the decisions equal the reference's host zoo."""
    ref, _ = _drive_scheduler(RefScheduler, RefCaps, RefRequest)
    c0 = obs.counter_get("resilience.degrade_select_torch_host")
    with faults.injected(plan):
        picks, sched = _drive_scheduler(DVBPScheduler, ReplicaCapacity,
                                        Request, backend="device",
                                        device="cpu")
    assert picks == ref
    assert obs.counter_get("resilience.degrade_select_torch_host") == \
        c0 + degrades
    assert sched.last_select_backend == ("host" if degrades > 1
                                         else "torch")
    assert sched.stats.replica_seconds > 0


def test_serving_select_real_error_propagates(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("CUDA error: unspecified launch failure")
    monkeypatch.setattr(DVBPScheduler, "_select_device", broken)
    with pytest.raises(RuntimeError, match="unspecified launch failure"):
        _drive_scheduler(DVBPScheduler, ReplicaCapacity, Request,
                         backend="device", device="cpu", n=3)


# ------------------------------------------------- validation / quarantine

def test_validate_rows_and_sanitize_equal_reference():
    sizes = np.array([[0.5], [np.nan], [-0.1], [1.5], [0.5], [0.5]])
    arr = np.array([0.0, 1.0, 2.0, 3.0, 4.0, 5.0])
    dep = np.array([10.0, 11.0, 12.0, 13.0, 4.0, 15.0])
    ids = np.array([0, 1, 2, 3, 4, 0])
    rep = validate.validate_rows(sizes, arr, dep, ids)
    ref = ref_validate.validate_rows(sizes, arr, dep, ids)
    assert rep.counts() == ref.counts() == {
        "nan": 1, "nonpos_size": 1, "oversize": 1, "nonpos_duration": 1,
        "dup_id": 1}
    assert rep.keep.tolist() == ref.keep.tolist()
    assert rep.summary() == ref.summary()
    c0 = obs.counter_get("resilience.quarantine_rows")
    inst, rep = validate.sanitize_rows(sizes[[0, 1, 5]], arr[[5, 1, 0]],
                                       dep[[5, 1, 0]] + 20, name="t")
    assert rep.n_bad == 1
    assert obs.counter_get("resilience.quarantine_rows") == c0 + 1
    assert inst.arrivals.tolist() == [0.0, 5.0]        # sorted by arrival
    assert validate.validate_instance(inst).ok


def test_validate_cli_equals_reference(capsys):
    args = ["--suites", "azure", "huawei", "--n-instances", "2",
            "--n-items", "50"]
    ref_validate.main(args)
    want = capsys.readouterr().out
    p = subprocess.run([sys.executable, "-m", "repro_torch", "validate"]
                       + args, env={**os.environ, "PYTHONPATH": SRC},
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout == want and "[ok]" in want


# -------------------------------------------- chaos: kill + resume (CLI)

def _sweep_args(store):
    return ["--suites", "azure", "--n-instances", "2", "--n-items", "50",
            "--policies", ",".join(FAMILY_POLICIES), "--preds",
            "clairvoyant", "--store", store, "--resume",
            "--checkpoint-every", "16"]


def _port_sweep(store, fault=""):
    env = {**os.environ, "PYTHONPATH": SRC,
           "REPRO_TORCH_RESILIENCE_BACKOFF_SCALE": "0",
           "OMP_NUM_THREADS": "1"}
    env.pop("REPRO_TORCH_FAULTS", None)
    if fault:
        env["REPRO_TORCH_FAULTS"] = fault
    return subprocess.run([sys.executable, "-m", "repro_torch", "sweep",
                           "--device", "cpu"] + _sweep_args(store),
                          env=env, capture_output=True, text=True,
                          timeout=600)


def _store_results(store):
    files = [f for f in os.listdir(store)
             if f.startswith("sweep_") and f.endswith(".json")]
    assert len(files) == 1, files
    return json.load(open(os.path.join(store, files[0])))["results"]


@pytest.fixture(scope="module")
def clean_stores(tmp_path_factory):
    """The fault-free port store (CLI) and the reference's store of the
    same spec (in-process, jnp)."""
    port = str(tmp_path_factory.mktemp("clean_port"))
    p = _port_sweep(port)
    assert p.returncode == 0, p.stderr
    ref = str(tmp_path_factory.mktemp("clean_ref"))
    spec = ref_sweep.SweepSpec(
        suites=(ref_sweep.SuiteSpec("azure", 2, 50, 2026),),
        policies=FAMILY_POLICIES,
        predictions=(ref_sweep.PredModel("clairvoyant"),))
    ref_sweep.run_sweep(spec, store=ref_sweep.SweepStore(ref),
                        backend="jnp")
    return _store_results(port), _store_results(ref)


@pytest.mark.parametrize("fault", [
    "sweep.group:kill:2",     # die between (suite, policy, pred) groups
    "ckpt.segment:kill:7",    # die mid-scan, between carry snapshots
])
def test_killed_sweep_resumes_bit_identical(clean_stores, tmp_path, fault):
    store = str(tmp_path / "store")
    p = _port_sweep(store, fault)
    assert p.returncode == 137, (p.returncode, p.stdout, p.stderr)
    if fault.startswith("ckpt"):    # a carry snapshot was left behind
        assert os.listdir(os.path.join(store, "checkpoints"))
    p = _port_sweep(store)
    assert p.returncode == 0, p.stderr
    port, ref = clean_stores
    assert _store_results(store) == port == ref
