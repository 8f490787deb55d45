"""The port's data, prediction, sweep and store layers against the
reference: identical instances and predictions from the same seeds, equal
sweep records, stores readable by either package, the headline grid total
and the CLI."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.data as ref_data
import repro.sweep as ref_sweep
import repro_torch.core as port_core
import repro_torch.data as port_data
import repro_torch.sweep as port_sweep

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the card check's headline constant)

# the tensors here are tiny: intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)


def _same_instances(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.name == y.name
        for f in ("sizes", "arrivals", "departures"):
            np.testing.assert_array_equal(getattr(y, f), getattr(x, f))


@pytest.mark.parametrize("n,items,seed", [(4, 300, 2026), (28, 60, 11)])
def test_azure_like_suite_identical(n, items, seed):
    _same_instances(ref_data.make_azure_like_suite(n, items, seed),
                    port_data.make_azure_like_suite(n, items, seed))


def test_huawei_like_suite_identical():
    _same_instances(ref_data.make_huawei_like_suite(9, 200, 77),
                    port_data.make_huawei_like_suite(9, 200, 77))


@pytest.mark.parametrize("kind,param", [("lognormal", 0.5),
                                        ("lognormal", 2.0),
                                        ("lognormal", 0.0),
                                        ("uniform", 3.0)])
def test_prediction_samplers_identical(kind, param):
    r = ref_data.make_azure_like_suite(2, 200, 5)
    p = port_data.make_azure_like_suite(2, 200, 5)
    for ri, pi in zip(r, p):
        a = getattr(ref_core, f"{kind}_predictions_batch")(ri, param,
                                                            [0, 1, 7])
        b = getattr(port_core, f"{kind}_predictions_batch")(pi, param,
                                                             [0, 1, 7])
        np.testing.assert_array_equal(b, a)


def test_lower_bound_and_packing_identical():
    r = ref_data.make_azure_like_suite(3, 150, 9) + \
        ref_data.make_huawei_like_suite(2, 100, 3)
    p = port_data.make_azure_like_suite(3, 150, 9) + \
        port_data.make_huawei_like_suite(2, 100, 3)
    assert [ref_core.lower_bound(i) for i in r] == \
        [port_core.lower_bound(i) for i in p]
    rb, pb = ref_sweep.pack_instances(r), port_sweep.pack_instances(p)
    for f in ("sizes", "arrivals", "pdeps", "times", "kinds", "items",
              "dmask", "n_items"):
        np.testing.assert_array_equal(getattr(pb, f), getattr(rb, f))
    preds = [ref_core.lognormal_predictions_batch(i, 1.0, [0, 1]) for i in r]
    np.testing.assert_array_equal(port_sweep.pad_predictions(pb, preds),
                                  ref_sweep.pad_predictions(rb, preds))


def _specs(**kw):
    suites = kw.pop("suites", ((("azure", 4, 300, 2026)),))
    preds = (("clairvoyant", 0.0), ("lognormal", 1.0))
    seeds = (0, 1)
    ref = ref_sweep.SweepSpec(
        suites=tuple(ref_sweep.SuiteSpec(*s) for s in suites),
        predictions=tuple(ref_sweep.PredModel(*p) for p in preds),
        seeds=seeds, **kw)
    port = port_sweep.SweepSpec(
        suites=tuple(port_sweep.SuiteSpec(*s) for s in suites),
        predictions=tuple(port_sweep.PredModel(*p) for p in preds),
        seeds=seeds, **kw)
    return ref, port


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """The default 8-policy sweep over azure-like 4 x 300, clairvoyant +
    lognormal:1.0 with seeds 0 and 1, in both packages, each into its own
    store."""
    ref_spec, port_spec = _specs()
    ref_dir = str(tmp_path_factory.mktemp("ref_store"))
    port_dir = str(tmp_path_factory.mktemp("port_store"))
    ref = ref_sweep.run_sweep(ref_spec, store=ref_sweep.SweepStore(ref_dir),
                              backend="jnp")
    port = port_sweep.run_sweep(port_spec,
                                store=port_sweep.SweepStore(port_dir),
                                device="cpu")
    return ref_spec, port_spec, ref_dir, port_dir, ref, port


def test_spec_hashes_equal_reference(swept):
    ref_spec, port_spec, *_ = swept
    assert port_spec.policies == ref_spec.policies
    assert port_spec.spec_hash() == ref_spec.spec_hash()
    assert port_spec.suites_hash() == ref_spec.suites_hash()
    assert port_spec.canonical() == ref_spec.canonical()


def test_run_sweep_records_equal_reference(swept):
    *_, ref, port = swept
    assert len(port) == 4 * 8 * 3
    assert port == ref


def test_store_files_byte_identical(swept):
    ref_spec, _, ref_dir, port_dir, *_ = swept
    name = f"sweep_{ref_spec.suites_hash()}.json"
    with open(os.path.join(ref_dir, name), "rb") as a, \
            open(os.path.join(port_dir, name), "rb") as b:
        assert b.read() == a.read()


@pytest.mark.parametrize("direction", ["port_store_under_reference",
                                       "reference_store_under_port"])
def test_store_resolves_all_cached_across_packages(swept, direction):
    ref_spec, port_spec, ref_dir, port_dir, ref, port = swept
    msgs = []
    if direction == "port_store_under_reference":
        got = ref_sweep.run_sweep(ref_spec,
                                  store=ref_sweep.SweepStore(port_dir),
                                  progress=msgs.append, backend="jnp")
    else:
        got = port_sweep.run_sweep(port_spec,
                                   store=port_sweep.SweepStore(ref_dir),
                                   progress=msgs.append, device="cpu")
    assert len(msgs) == 16 and all(m.startswith("skip") for m in msgs)
    assert got == ref == port


def test_summaries_equal_reference(swept):
    *_, ref, port = swept
    a, b = ref_sweep.summarize_sweep(ref), port_sweep.summarize_sweep(port)
    assert a.keys() == b.keys()
    assert all(a[k].row() == b[k].row() for k in a)


def test_headline_grid_total_equals_chip_constant():
    """The 28 x 250 seed-11 grid of benchmarks/perf.py::sweep_batched_only
    in both packages: both totals print as chip_smoke.REF_USAGE_28x4, the
    number the card must reproduce."""
    pols = chip_smoke.HEADLINE_POLICIES
    rb = ref_sweep.pack_instances(
        ref_data.make_azure_like_suite(28, 250, seed=11))
    pb = port_sweep.pack_instances(
        port_data.make_azure_like_suite(28, 250, seed=11))
    ref = sum(float(ref_sweep.run_batch(rb, p, max_bins=64, backend="jnp")
                    .usage_time.sum()) for p in pols)
    port = sum(float(port_sweep.run_batch(pb, p, max_bins=64, device="cpu")
                     .usage_time.sum()) for p in pols)
    assert port == ref
    assert f"{ref:.0f}" == str(chip_smoke.REF_USAGE_28x4)


def test_sweep_spec_rejects_category_policies():
    """SweepSpec takes all 21 scan policies (hashing as the reference's
    spec does) and rejects a name that is no policy.  The name dates from
    when the port refused the category policies; it is kept so that this
    test's history stays one test."""
    from repro_torch.core.torchsim import SCAN_POLICIES
    names = SCAN_POLICIES + ("cbd_beta4", "adaptive_2_16")
    spec = port_sweep.SweepSpec(policies=names)
    assert spec.spec_hash() == ref_sweep.SweepSpec(policies=names).spec_hash()
    with pytest.raises(KeyError):
        port_sweep.SweepSpec(policies=("no_such_policy",))


def test_cli_sweep_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch", "sweep", "--device", "cpu",
           "--n-instances", "2", "--n-items", "80",
           "--policies", "first_fit,greedy", "--preds", "clairvoyant",
           "lognormal:1.0", "--seeds", "0,1", "--store", str(tmp_path)]
    first = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=300)
    assert first.returncode == 0, first.stderr
    assert first.stdout.count("# run ") == 4
    assert "greedy" in first.stdout and "lognormal1" in first.stdout
    again = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=300)
    assert again.returncode == 0, again.stderr
    assert again.stdout.count("(cached)") == 4
    assert again.stdout.splitlines()[-4:] == first.stdout.splitlines()[-4:]
