"""The replay's lane split across local devices (``run_batch(shard=)``,
``runner.lane_devices``, the ladder's ``sharded -> single`` rung,
``Experiment.run(shard=)`` and the CLI's ``--shard``) against the
reference's.

Several "devices" are the CPU repeated: ``lane_devices`` is monkeypatched,
the counterpart of the reference tests' forced host device count
(``--xla_force_host_platform_device_count``).  Every split run must equal
the unsplit one bit for bit (usage, bins opened, overflow, the slot pool
each lane ended with)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.resilience import guard as ref_guard
from repro_torch import api, obs
from repro_torch.core import Instance
from repro_torch.resilience import faults, guard
from repro_torch.sweep import pack_instances, pad_predictions, run_batch
from repro_torch.sweep import runner

ROOT = os.path.join(os.path.dirname(__file__), "..")
torch.set_num_threads(1)
FIELDS = ("usage_time", "n_bins_opened", "overflowed", "max_bins")


def _insts(n_lanes, base, step, seed, prefix):
    """tests/test_stream.py's and tests/test_fitscore_select.py's lanes."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_lanes):
        n = base + step * s
        sizes = rng.integers(1, 24, (n, 3)) / 64.0
        arr = np.sort(rng.integers(0, 5000, n)).astype(float)
        dur = rng.integers(10, 500, n).astype(float)
        out.append(Instance(sizes, arr, arr + dur,
                            f"{prefix}{s}").sorted_by_arrival())
    return out


@pytest.fixture
def devices(monkeypatch):
    """``lane_devices`` as ``n`` CPU devices; counts the split replays."""
    calls = []
    split = runner._sharded_replay

    def counted(sub, devs, **kw):
        calls.append(len(devs))
        return split(sub, devs, **kw)

    def use(n):
        monkeypatch.setattr(runner, "lane_devices",
                            lambda dev: [torch.device("cpu")] * n)
        monkeypatch.setattr(runner, "_sharded_replay", counted)
        return calls
    return use


def _equal(a, b):
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("T", [0, 8])
def test_lanes_wrap_when_devices_dwarf_them(devices, T):
    """The reference's ``_PAD_SCRIPT``: 2 lanes over 5 devices (pad 3 > L)
    and 1 lane over 5 (pad 4: ceil(total / L) = 5 copies), per event and
    blocked."""
    calls = devices(5)
    insts = _insts(2, 30, 10, 1, "p")
    batch = pack_instances(insts)
    kw = dict(max_bins=16, device="cpu", block_events=T)
    _equal(run_batch(batch, "best_fit_l1", shard="never", **kw),
           run_batch(batch, "best_fit_l1", shard="always", **kw))
    solo = pack_instances(insts[:1])
    _equal(run_batch(solo, "first_fit", shard="never", **kw),
           run_batch(solo, "first_fit", shard="always", **kw))
    assert calls == [5, 5]


@pytest.mark.parametrize("T", [0, 8])
def test_always_equals_never_with_growth_seed_rows_and_few_lanes(devices, T):
    """``tests/test_fitscore_select.py``'s ``shard="always"`` cases: 6 lanes
    over 4 devices (padded to 8) through the overflow ladder from 2 slots
    (each rung re-split), 2 prediction rows a lane, and 1 lane over 4."""
    calls = devices(4)
    insts = _insts(6, 40, 10, 0, "s")
    batch = pack_instances(insts)
    kw = dict(device="cpu", block_events=T)
    a = run_batch(batch, "best_fit_linf", max_bins=2, shard="never", **kw)
    b = run_batch(batch, "best_fit_linf", max_bins=2, shard="always", **kw)
    _equal(a, b)
    assert not b.overflowed.any() and (b.max_bins > 2).any()
    rungs = len(calls)
    assert rungs > 1 and set(calls) == {4}
    pdeps = pad_predictions(batch, [np.stack([i.durations, 2.0 * i.durations])
                                    for i in insts])
    a = run_batch(batch, "greedy", pdeps, max_bins=32, shard="never", **kw)
    b = run_batch(batch, "greedy", pdeps, max_bins=32, shard="always", **kw)
    assert a.S == 2
    _equal(a, b)
    solo = pack_instances(insts[:1])
    _equal(run_batch(solo, "first_fit", max_bins=32, shard="never", **kw),
           run_batch(solo, "first_fit", max_bins=32, shard="always", **kw))
    assert len(calls) == rungs + 2


@pytest.mark.parametrize("policy", ["cbd", "rcp", "la_binary", "adaptive"])
def test_category_families_split_equal(devices, policy):
    """One policy of each category family, 6 lanes over 4 devices with
    lognormal predictions, blocked: split == unsplit."""
    from repro_torch.core import lognormal_predictions_batch
    devices(4)
    insts = _insts(6, 40, 10, 3, "c")
    batch = pack_instances(insts)
    pdeps = pad_predictions(batch, [lognormal_predictions_batch(i, 1.0, (0,))
                                    for i in insts])
    kw = dict(max_bins=32, device="cpu", block_events=8)
    _equal(run_batch(batch, policy, pdeps, shard="never", **kw),
           run_batch(batch, policy, pdeps, shard="always", **kw))


def test_always_on_one_device_and_an_unknown_mode_raise():
    batch = pack_instances(_insts(2, 30, 10, 1, "p"))
    assert runner.lane_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="requires multiple local devices"):
        run_batch(batch, "first_fit", device="cpu", shard="always")
    with pytest.raises(ValueError, match="shard="):
        run_batch(batch, "first_fit", device="cpu", shard="sometimes")


def test_auto_splits_only_over_several_devices(devices):
    """``shard="auto"`` splits when several devices are there and keeps one
    otherwise; ``"never"`` keeps one; trace-level replays stay on one
    device, with the unsplit trace."""
    batch = pack_instances(_insts(3, 30, 10, 2, "a"))
    kw = dict(max_bins=16, device="cpu")
    base = run_batch(batch, "first_fit", **kw)
    calls = devices(3)
    _equal(run_batch(batch, "first_fit", **kw), base)
    assert calls == [3]
    _equal(run_batch(batch, "first_fit", shard="never", **kw), base)
    traced = run_batch(batch, "first_fit", shard="always", trace_level=1,
                       **kw)
    _equal(traced, base)
    assert calls == [3] and traced.trace is not None
    plain = run_batch(batch, "first_fit", shard="never", trace_level=1, **kw)
    assert obs.diff_traces(traced.trace, plain.trace) is None


# (port device, reference backend) and the reference's labels with its
# jnp floor read as the port's cpu one
@pytest.mark.parametrize("T", [0, 256])
@pytest.mark.parametrize("ndev", [1, 4])
@pytest.mark.parametrize("device,backend", [("cuda", "pallas"),
                                            ("cpu", "jnp")])
def test_replay_rungs_follow_the_reference(device, backend, T, ndev):
    """``replay_rungs(dev, T, ndev)``: the reference's
    ``replay_rungs(backend, T, ndev)`` rung for rung (blocked, per event,
    single device, then the CPU where the reference has jnp), with the
    same transition names between rungs."""
    port = guard.replay_rungs(device, T, ndev)
    ref = ref_guard.replay_rungs(backend, T, ndev)
    assert [r.label for r in port] == \
        [r.label.replace("jnp", "cpu") for r in ref]
    assert [r.ndev for r in port] == [r.ndev for r in ref]
    assert [guard.transition_name(a, b) for a, b in zip(port, port[1:])] == \
        [tuple(x.replace("pallas", "cuda").replace("jnp", "cpu")
               for x in ref_guard.transition_name(a, b))
         for a, b in zip(ref, ref[1:])]
    if ndev == 1:
        assert port == guard.replay_rungs(device, T)


@pytest.mark.parametrize("plan,T,want", [
    ("sweep.scan:xla:1:1", 0, {"resilience.degrade_sharded_single": 1}),
    ("sweep.scan:xla:1:2", 8, {"resilience.degrade_blocked_perevent": 1,
                               "resilience.degrade_sharded_single": 1}),
])
def test_injected_fault_steps_sharded_to_single(devices, plan, T, want):
    """An injected fault at ``sweep.scan`` past the blocked rung moves
    ``resilience.degrade_sharded_single`` exactly once; the results equal
    the fault-free split run's."""
    devices(3)
    batch = pack_instances(_insts(4, 30, 10, 4, "f"))
    kw = dict(max_bins=16, device="cpu", block_events=T, shard="always")
    base = run_batch(batch, "greedy", **kw)
    before = obs.counters()
    with faults.injected(plan):
        res = run_batch(batch, "greedy", **kw)
    moved = {k: v for k, v in obs.counter_deltas(before).items()
             if k.startswith("resilience.")
             and not k.startswith("resilience.fault_")}
    assert moved == want
    _equal(res, base)


def test_experiment_run_passes_shard_through(devices):
    """``Experiment.run(shard=)`` reaches ``run_batch``: "always" splits
    every replay (with the unsplit records) and refuses a single device."""
    exp = api.Experiment(api.synthetic("azure", 3, 80, seed=5),
                         policies=("first_fit", "greedy"),
                         settings=(api.Setting.clairvoyant(),))
    with pytest.raises(ValueError, match="requires multiple local devices"):
        exp.run(device="cpu", shard="always")
    base = exp.run(device="cpu", shard="never")
    calls = devices(2)
    got = exp.run(device="cpu", shard="always")
    assert calls == [2, 2]
    assert got.records == base.records


@pytest.mark.parametrize("shard,rc", [("never", 0), ("auto", 0),
                                      ("always", 1)])
def test_cli_shard_flag(tmp_path, shard, rc):
    """``--shard`` reaches the replay: on the CPU (one device) "never" and
    "auto" run and "always" is refused with ``run_batch``'s message."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "sweep", "--device", "cpu",
         "--n-instances", "2", "--n-items", "60", "--policies", "first_fit",
         "--no-store", "--shard", shard], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == rc, out.stderr
    if rc:
        assert "requires multiple local devices" in out.stderr
    else:
        assert "first_fit" in out.stdout.splitlines()[-1]
