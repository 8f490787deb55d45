"""The port's experiment API (``repro_torch.api``) against the JAX
package's (``repro.api``), on the CPU: the scenarios of tests/test_api.py,
each run through both packages where it runs a replay.

Held exactly (the instances are fp32-exact, as in tests/test_api.py):
``Policy`` values, parse errors and registry bridges field for field;
``Experiment`` records and ``Results.rows()`` (usage time, bins opened,
ratio) equal the reference's; workload digests equal; the store files an
``Experiment.run(store=...)`` writes byte for byte equal; and an
Experiment over ``serving_requests`` reproduces the port's own
``simulate_fleet``.  The port raises ``ValueError`` where the reference
asserts.  The reference runs as its own tests run it (``backend="jnp"``);
the port on the CPU, per event and blocked.
"""
import dataclasses
import os
import warnings

import numpy as np
import pytest

from repro import api as ref_api
from repro.serving.scheduler import ReplicaCapacity as RefCaps
from repro.serving.scheduler import Request as RefRequest
from repro.sweep import PredModel as RefPredModel
from repro.sweep import SuiteSpec as RefSuiteSpec
from repro.sweep import SweepSpec as RefSweepSpec
from repro.sweep import SweepStore as RefSweepStore
from repro.sweep import run_sweep as ref_run_sweep
from repro_torch import api
from repro_torch.serving.fleet import simulate_fleet
from repro_torch.serving.scheduler import ReplicaCapacity, Request
from repro_torch.sweep import (PredModel, SuiteSpec, SweepSpec, SweepStore,
                               run_sweep)

# fp32-exact serving geometry: power-of-two capacities and token rate,
# integer arrivals and lengths (tests/test_api.py's)
CAPS = ReplicaCapacity(slots=4, kv_tokens=65536, prefill_budget=262144)
REF_CAPS = RefCaps(slots=4, kv_tokens=65536, prefill_budget=262144)
TPS = 64.0


def synth_exact_requests(n=150, seed=3, predicted=True, cls=Request):
    rng = np.random.default_rng(seed)
    reqs, t = [], 0.0
    for rid in range(n):
        t += float(rng.integers(1, 8))
        reqs.append(cls(
            rid, t, int(rng.integers(16, 512)), int(rng.integers(8, 1024)),
            predicted_decode_len=int(rng.integers(8, 1024))
            if predicted else None))
    return reqs


def _store_bytes(root):
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


def _rows(res):
    return [(r["workload"], r["setting"], r["policy"], r["instance"],
             r["seed"], r["usage_time"], r["n_bins_opened"], r["ratio"])
            for r in res.rows()]


# ---------------------------------------------------------------- Policy

def test_policy_parse_str_roundtrip():
    for name in ("first_fit", "best_fit_l2", "cbd_beta4", "cbdt_rho3600",
                 "adaptive_2_8", "la_geometric", "ppe_modified"):
        p = api.Policy.parse(name)
        assert str(p) == name
        assert api.Policy.parse(str(p)) == p
        assert dataclasses.asdict(p) == \
            dataclasses.asdict(ref_api.Policy.parse(name))
    p = api.Policy.parse("cbd_beta4")
    assert p.beta == 4.0 and p.family == "cbd"
    assert p.category and p.scan and p.device_select and p.needs_predictions
    a = api.Policy.parse("adaptive_2_8")
    assert (a.low, a.high) == (2.0, 8.0)
    bf = api.Policy.parse("best_fit_l1")
    assert bf.norm == "l1" and not bf.category and bf.device_select
    assert api.Policy.parse(p) is p          # idempotent on Policy values


def test_policy_registry_introspection():
    ps = api.policies()
    assert [dataclasses.asdict(p) for p in ps] == \
        [dataclasses.asdict(p) for p in ref_api.policies()]
    assert api.policy_names() == ref_api.policy_names()
    names = [p.name for p in ps]
    assert set(api.SCAN_POLICIES) <= set(names)
    nf = {p.name: p for p in ps}["next_fit"]
    assert not nf.scan and nf.family == "host"
    assert all(p.category == (p.name in api.CATEGORY_POLICIES)
               for p in ps if p.scan)


@pytest.mark.parametrize("bad,frag", [
    ("cbd_beta-1", "must be > 1"),
    ("cbd_beta1", "must be > 1"),
    ("cbd_beta0.25", "must be > 1"),
    ("cbdt_rho0", "must be > 0"),
    ("cbdt_rho-3600", "must be > 0"),
    ("adaptive_8_2", "1 <= low <= high"),
    ("adaptive_0.5_4", "1 <= low <= high"),
])
def test_parametric_policy_range_validated_at_parse(bad, frag):
    """Out-of-range parameters fail at parse time with the valid range in
    the message, the reference's message."""
    with pytest.raises(ValueError) as ei:
        api.Policy.parse(bad)
    with pytest.raises(ValueError) as ref_ei:
        ref_api.Policy.parse(bad)
    assert frag in str(ei.value) and "got" in str(ei.value)
    assert str(ei.value) == str(ref_ei.value)
    from repro_torch.core.torchsim import known_policy, policy_spec
    with pytest.raises(ValueError):
        policy_spec(bad)
    with pytest.raises(ValueError):
        known_policy(bad)
    with pytest.raises(ValueError):
        SweepSpec(policies=(bad,))


def test_unknown_and_malformed_policies_are_keyerrors():
    for name in ("no_such_policy", "cbd_betax", "adaptive_1_2_3"):
        with pytest.raises(KeyError):
            api.Policy.parse(name)
        with pytest.raises(KeyError):
            ref_api.Policy.parse(name)


def test_policy_from_registry_matches_scan_lanes():
    for name, kw in (("best_fit", {"norm": "l2"}), ("cbd", {"beta": 4.0}),
                     ("cbdt", {"rho": 3600.0}),
                     ("lifetime_alignment", {"mode": "geometric"}),
                     ("adaptive", {"low": 2.0, "high": 8.0}),
                     ("adaptive", {}), ("next_fit", {}), ("greedy", {}),
                     ("best_fit", {"norm": "l2", "exotic": 1})):
        got = api.Policy.from_registry(name, **kw)
        want = ref_api.Policy.from_registry(name, **kw)
        assert (got is None) == (want is None), (name, kw)
        if got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert api.Policy.from_registry("best_fit", norm="l2").name == \
        "best_fit_l2"
    assert api.Policy.from_registry("cbd", beta=4.0).name == "cbd_beta4"
    assert api.Policy.from_registry("best_fit", norm="l2", exotic=1) is None
    name, kw = api.Policy.parse("cbd_beta4").registry_args()
    assert (name, kw) == ("cbd", {"beta": 4.0})


# ---------------------------------------------------- Experiment == sweep

def test_experiment_matches_legacy_run_sweep_and_store(tmp_path):
    """The facade's records equal the port's run_sweep and the reference's;
    run_sweep's store resolves every cell for the Experiment; and the store
    the port's Experiment writes equals the reference's byte for byte."""
    suite = SuiteSpec("azure", 2, 120, seed=5)
    spec = SweepSpec(suites=(suite,), policies=("first_fit", "greedy"),
                     predictions=(PredModel("clairvoyant"),
                                  PredModel("lognormal", 1.0)),
                     seeds=(0, 1), max_bins=32)
    store = SweepStore(str(tmp_path / "legacy"))
    legacy = run_sweep(spec, store=store, device="cpu")

    def experiment(mod):
        return mod.Experiment(
            mod.synthetic("azure", 2, 120, seed=5),
            policies=("first_fit", mod.Policy.parse("greedy")),
            settings=(mod.Setting.clairvoyant(),
                      mod.Setting.predicted("lognormal", 1.0)),
            seeds=(0, 1), max_bins=32)

    log = []
    res = experiment(api).run(store=str(tmp_path / "legacy"),
                              progress=log.append, device="cpu")
    assert res.records == legacy
    assert log and all(m.startswith("skip") for m in log)   # all cached
    rows = res.rows()
    assert {r["setting"] for r in rows} == \
        {"clairvoyant", "predicted:lognormal1"}
    assert all(r["workload"] == suite.label() for r in rows)
    st = res.summary()[(suite.label(), "greedy", "clairvoyant")]
    assert st.n == 2 and st.mean >= 1.0 - 1e-6
    assert res.ratios(policy="first_fit", setting="clairvoyant")

    experiment(api).run(store=str(tmp_path / "port"), device="cpu",
                        block_events=8)
    ref = experiment(ref_api).run(store=str(tmp_path / "ref"),
                                  backend="jnp")
    assert ref.records == res.records
    assert _rows(ref) == _rows(res)
    ref_spec = RefSweepSpec(
        suites=(RefSuiteSpec("azure", 2, 120, seed=5),),
        policies=("first_fit", "greedy"),
        predictions=(RefPredModel("clairvoyant"),
                     RefPredModel("lognormal", 1.0)),
        seeds=(0, 1), max_bins=32)
    assert ref_run_sweep(ref_spec, backend="jnp") == legacy
    assert _store_bytes(tmp_path / "port") == _store_bytes(tmp_path / "ref")


def test_experiment_rejects_host_only_policies():
    with pytest.raises(ValueError, match="host-only"):
        api.Experiment(api.synthetic("azure", 1, 50),
                       policies=("next_fit",))


def test_nonclairvoyant_suite_rejects_prediction_reading_policies():
    """On suite workloads the engine cannot hide durations from greedy /
    nrt / category policies, so the combination is an error; true
    non-clairvoyant policies run, with the reference's records."""
    wl = api.synthetic("azure", 1, 60)
    with pytest.raises(ValueError, match="predicted-departure"):
        api.Experiment(wl, policies=("first_fit", "greedy"),
                       settings=(api.Setting.nonclairvoyant(),))
    res = api.Experiment(wl, policies=("first_fit", "mru"),
                         settings=(api.Setting.nonclairvoyant(),)).run(
        device="cpu")
    assert {r["policy"] for r in res.rows()} == {"first_fit", "mru"}
    ref = ref_api.Experiment(ref_api.synthetic("azure", 1, 60),
                             policies=("first_fit", "mru"),
                             settings=(ref_api.Setting.nonclairvoyant(),)
                             ).run(backend="jnp")
    assert _rows(res) == _rows(ref)


def test_instances_workload_digest_is_content_addressed():
    from repro_torch.data import make_azure_like_suite
    insts = make_azure_like_suite(n_instances=2, n_items=60, seed=9)
    w1 = api.instances(insts, name="a")
    w2 = api.instances(list(insts), name="b")
    assert w1.digest == w2.digest                 # same content
    other = make_azure_like_suite(n_instances=2, n_items=60, seed=10)
    assert api.instances(other).digest != w1.digest
    renamed = [dataclasses.replace(i, name=i.name + "-v2") for i in insts]
    assert api.instances(renamed).digest != w1.digest
    # the reference keys the same content to the same digest
    from repro.data import make_azure_like_suite as ref_suite
    assert ref_api.instances(ref_suite(2, 60, seed=9)).digest == w1.digest
    assert ref_api.instances(ref_suite(2, 60, seed=10)).digest == \
        api.instances(other).digest


def test_results_scoped_to_the_experiment_cells(tmp_path):
    """A shared store file accumulates records across experiments;
    Results report only the cells the experiment asked for."""
    wl = api.synthetic("azure", 2, 100, seed=4)
    api.Experiment(wl, policies=("first_fit",)).run(store=str(tmp_path),
                                                    device="cpu")
    res = api.Experiment(wl, policies=("greedy",)).run(store=str(tmp_path),
                                                       device="cpu")
    assert {r["policy"] for r in res.rows()} == {"greedy"}
    assert len(res.records) == 2
    assert set(res.summary()) == {(wl.label(), "greedy", "clairvoyant")}


def test_experiment_device_path_identity_on_exact_instances():
    """``Experiment.run`` passes the execution arguments through: per
    event and blocked records are identical on fp32-exact instances, and
    equal the reference's (``device`` takes the place of the reference's
    ``backend``)."""
    from repro.core import Instance as RefInstance
    from repro_torch.core import Instance
    rng = np.random.default_rng(2)
    raw = []
    for k, n in enumerate((40, 80)):
        sizes = rng.integers(1, 24, (n, 3)) / 64.0
        arr = np.sort(rng.integers(0, 5000, n)).astype(float)
        dur = rng.integers(10, 500, n).astype(float)
        raw.append((sizes, arr, arr + dur, f"x{k}"))
    wl = api.instances([Instance(*r) for r in raw], name="exact")
    exp = api.Experiment(wl, policies=("best_fit_linf", "cbd"),
                         settings=(api.Setting.clairvoyant(),))
    a = exp.run(device="cpu")
    b = exp.run(device="cpu", block_events=8)
    assert a.records == b.records
    ref_wl = ref_api.instances([RefInstance(*r) for r in raw], name="exact")
    assert ref_wl.digest == wl.digest
    ref = ref_api.Experiment(ref_wl, policies=("best_fit_linf", "cbd"),
                             settings=(ref_api.Setting.clairvoyant(),)
                             ).run(backend="jnp")
    assert ref.records == a.records


# -------------------------------------------------- serving <-> sweep

@pytest.mark.parametrize("policy,kwargs,block_events", [
    ("first_fit", None, 0),
    ("best_fit", {"norm": "linf"}, 0),
    ("greedy", None, 0),
    ("nrt_prioritized", None, 0),
    ("cbd", {"beta": 2.0}, 0),
    ("greedy", None, 8),
    ("cbd", {"beta": 2.0}, 8),
])
def test_serving_requests_reproduces_simulate_fleet(policy, kwargs,
                                                    block_events):
    """Fleet capacity planning through the batched replay: usage totals
    and opened-replica counts equal the port's host fleet simulation, and
    the rows equal the reference's Experiment over the same requests."""
    reqs = synth_exact_requests()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        fleet = simulate_fleet(reqs, policy, CAPS, TPS,
                               policy_kwargs=kwargs)
    pol = api.Policy.from_registry(policy, **(kwargs or {}))
    wl = api.serving_requests(reqs, caps=CAPS, tps=TPS, name="parity")
    res = api.Experiment(wl, policies=(pol,),
                         settings=(api.Setting.predicted(),)).run(
        device="cpu", block_events=block_events)
    (rec,) = res.rows()
    assert rec["usage_time"] == pytest.approx(fleet["replica_seconds"],
                                              abs=1e-3)
    assert rec["n_bins_opened"] == fleet["replicas_opened"]
    assert rec["setting"] == "predicted:attached"
    ref_wl = ref_api.serving_requests(
        synth_exact_requests(cls=RefRequest), caps=REF_CAPS, tps=TPS,
        name="parity")
    assert ref_wl.digest == wl.digest
    ref = ref_api.Experiment(
        ref_wl, policies=(ref_api.Policy.from_registry(policy,
                                                       **(kwargs or {})),),
        settings=(ref_api.Setting.predicted(),)).run(backend="jnp")
    assert _rows(ref) == _rows(res)


@pytest.mark.parametrize("policy", ["first_fit", "mru", "greedy"])
def test_serving_nonclairvoyant_matches_fleet(policy):
    """No predictions attached: the scheduler feeds `now` into the
    indicated-close clock; the workload replays with pdep == arrival."""
    reqs = synth_exact_requests(n=120, seed=9, predicted=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        fleet = simulate_fleet(reqs, policy, CAPS, TPS)
    wl = api.serving_requests(reqs, caps=CAPS, tps=TPS, name="noncl")
    res = api.Experiment(wl, policies=(policy,),
                         settings=(api.Setting.nonclairvoyant(),)).run(
        device="cpu")
    (rec,) = res.rows()
    assert rec["usage_time"] == pytest.approx(fleet["replica_seconds"],
                                              abs=1e-3)
    assert rec["n_bins_opened"] == fleet["replicas_opened"]
    ref = ref_api.Experiment(
        ref_api.serving_requests(
            synth_exact_requests(n=120, seed=9, predicted=False,
                                 cls=RefRequest),
            caps=REF_CAPS, tps=TPS, name="noncl"),
        policies=(policy,),
        settings=(ref_api.Setting.nonclairvoyant(),)).run(backend="jnp")
    assert _rows(ref) == _rows(res)


def test_serving_records_land_in_the_sweep_store(tmp_path):
    """Serving workloads share the sweep store: a second run is a pure
    cache hit, the result_key strings parse as grid records, and the
    store file equals the reference's byte for byte."""
    reqs = synth_exact_requests(n=80, seed=1)
    wl = api.serving_requests(reqs, caps=CAPS, tps=TPS, name="stored")
    exp = api.Experiment(wl, policies=("first_fit", "greedy"),
                         settings=(api.Setting.predicted(),))
    r1 = exp.run(store=str(tmp_path / "port"), device="cpu")
    log = []
    r2 = exp.run(store=str(tmp_path / "port"), progress=log.append,
                 device="cpu")
    assert r2.records == r1.records
    assert log and all(m.startswith("skip") for m in log)
    for key, rec in r1.records.items():
        suite, instance, policy, pred, seed = key.rsplit("/", 4)
        assert suite == wl.label() and instance == "stored"
        assert rec["policy"] == policy and rec["pred"] == pred == "attached"
        assert rec["lower_bound"] > 0 and rec["ratio"] >= 1.0 - 1e-6
    ref_wl = ref_api.serving_requests(
        synth_exact_requests(n=80, seed=1, cls=RefRequest), caps=REF_CAPS,
        tps=TPS, name="stored")
    ref_api.Experiment(ref_wl, policies=("first_fit", "greedy"),
                       settings=(ref_api.Setting.predicted(),)).run(
        store=RefSweepStore(str(tmp_path / "ref")), backend="jnp")
    assert _store_bytes(tmp_path / "port") == _store_bytes(tmp_path / "ref")


def test_serving_requires_attached_predictions_when_asked():
    reqs = synth_exact_requests(n=20, predicted=False)
    wl = api.serving_requests(reqs, caps=CAPS, tps=TPS, name="nopred")
    with pytest.raises(ValueError, match="attached"):
        api.Experiment(wl, policies=("greedy",),
                       settings=(api.Setting.predicted(),)).run(device="cpu")


# ----------------------------------------------------------- Setting

def test_setting_parse_and_validation():
    assert api.Setting.parse("clairvoyant").kind == "clairvoyant"
    assert api.Setting.parse("nonclairvoyant").label() == "nonclairvoyant"
    s = api.Setting.predicted("uniform", 4.0)
    assert s.model == PredModel("uniform", 4.0)
    assert s.label() == "predicted:uniform4"
    assert api.Setting.predicted().label() == "predicted:attached"
    c = api.Setting.clairvoyant().with_consolidation("underload:t0.25")
    assert c.label() == \
        ref_api.Setting.clairvoyant().with_consolidation(
            "underload:t0.25").label()
    with pytest.raises(ValueError):
        api.Setting("clairvoyant", PredModel("lognormal", 1.0))
    with pytest.raises(ValueError):   # exact models are not "predicted"
        api.Setting.predicted(PredModel("clairvoyant"))
    with pytest.raises(KeyError):
        api.Setting.parse("oracle")
    # synthetic workloads refuse attached predictions (they have none)
    with pytest.raises(ValueError, match="attached"):
        api.synthetic("azure", 1, 50).pred_model(api.Setting.predicted())


# ------------------------------------------------------- migration shims

def test_legacy_entry_points_warn_once_with_migration_tag():
    from repro_torch.api import _migration
    _migration._WARNED.clear()
    reqs = synth_exact_requests(n=5)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        simulate_fleet(reqs, "first_fit", CAPS, TPS)
        simulate_fleet(reqs, "first_fit", CAPS, TPS)
    tagged = [x for x in w if "REPRO_API_MIGRATION" in str(x.message)]
    assert len(tagged) == 1                       # once per process
    assert issubclass(tagged[0].category, DeprecationWarning)
    assert "repro_torch.api" in str(tagged[0].message)
    # the host-only baselines have no api replacement: no migration nag
    _migration._WARNED.clear()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        simulate_fleet(reqs, "round_robin", CAPS, TPS)
        simulate_fleet(reqs, "pack_all", CAPS, TPS)
    assert not [x for x in w if "REPRO_API_MIGRATION" in str(x.message)]


def test_scheduler_accepts_policy_objects():
    from repro_torch.serving.scheduler import DVBPScheduler
    sched = DVBPScheduler(api.Policy.parse("cbd_beta4"), CAPS)
    assert sched.alg.name == "cbd_beta4"
    sched2 = DVBPScheduler(api.Policy.parse("best_fit_l2"), CAPS)
    assert sched2._device_policy == "best_fit_l2"


def test_capacity_error_names_failing_cell():
    """Overflow at the escalation cap surfaces as CapacityError naming the
    exact (workload, instance, policy, setting) cell."""
    from repro_torch.core import Instance
    from repro_torch.core.torchsim import CapacityError
    # two overlapping items of 3/4 need two bins
    inst = Instance(np.full((2, 2), 0.75), np.array([0.0, 1.0]),
                    np.array([4.0, 5.0]), name="q1")
    exp = api.Experiment(api.instances([inst], name="tiny-cap"),
                         policies=("first_fit",),
                         settings=(api.Setting.clairvoyant(),),
                         max_bins=1, max_bins_cap=1)
    with pytest.raises(CapacityError) as ei:
        exp.run(device="cpu")
    msg = str(ei.value)
    for needle in ("tiny-cap", "first_fit", "clairvoyant", "q1"):
        assert needle in msg, (needle, msg)
    assert ei.value.policy == "first_fit" and ei.value.max_bins == 1


def test_stream_source_replays_the_workload_instance():
    """``stream_source`` hands one instance of a workload to the streamed
    replay; its replay equals the in-memory one."""
    from repro_torch.api.workload import stream_source
    from repro_torch.core.torchsim import simulate
    from repro_torch.stream import replay_stream
    wl = api.synthetic("azure", 2, 150, seed=3)
    src = stream_source(wl, 1)
    inst = wl.suite().build()[1]
    got = replay_stream(src, "first_fit", chunk_events=128, item_rows=128,
                        max_bins=64, device="cpu")
    want = simulate(inst, "first_fit", max_bins=64, device="cpu")
    assert got.usage == want.usage_time and got.opened == want.n_bins_opened
