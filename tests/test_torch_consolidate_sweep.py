"""Consolidation in the port's sweep layers against the JAX package:
``run_batch(consolidate=)`` (churn, cost, the overflow ladder),
``run_sweep`` with the consolidation axis (spec hashes, records, store files
byte for byte, a cached rerun), ``--consolidate`` on the CLI, and the
frontier constants ``chip_smoke.REF_CONS`` that the card must reproduce.
The driver and the MIGRATE branch are held to the reference in
``test_torch_consolidate.py``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.consolidate as ref_cons
import repro.sweep as ref_sweep
from repro.core import Instance
from repro.data import make_azure_like_suite
import repro_torch.consolidate as port_cons
import repro_torch.sweep as port_sweep

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the frontier constants)

torch.set_num_threads(1)

SPEC = "underload:t0.5:e8"


def qinst(seed, n=40, d=3):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 24, (n, d)) / 64.0
    arr = np.sort(rng.integers(0, 50000, n)).astype(float)
    dur = rng.integers(10, 5000, n).astype(float)
    return Instance(sizes, arr, arr + dur, f"q{seed}").sorted_by_arrival()


@pytest.fixture(scope="module")
def pair():
    insts = [qinst(1), qinst(2)]
    return insts, ref_sweep.pack_instances(insts), None


# ------------------------------------------------- runner, grid and store

def test_run_batch_consolidate_equals_reference(pair):
    """run_batch(consolidate=) surfaces the driver's churn per cell;
    migration_cost = cost x migrations; usage never rises."""
    _, batch, _ = pair
    text = "underload:t0.5:e8:c2.5"
    port = port_sweep.run_batch(
        batch, "first_fit", max_bins=32, device="cpu",
        consolidate=port_cons.ConsolidationSpec.parse(text))
    ref = ref_sweep.run_batch(batch, "first_fit", max_bins=32,
                              backend="jnp",
                              consolidate=ref_cons.ConsolidationSpec.parse(
                                  text))
    for k in ("usage_time", "n_bins_opened", "overflowed", "max_bins",
              "migrations", "migration_cost"):
        assert np.array_equal(getattr(port, k), getattr(ref, k)), k
    assert (port.migration_cost == 2.5 * port.migrations).all()
    base = port_sweep.run_batch(batch, "first_fit", max_bins=32,
                                device="cpu")
    assert base.migrations is None and base.migration_cost is None
    assert (port.usage_time <= base.usage_time).all()
    assert (port.usage_time < base.usage_time).any()
    with pytest.raises(ValueError, match="consolidate=None"):
        port_sweep.run_batch(batch, "first_fit", max_bins=32, device="cpu",
                             consolidate=port_cons.ConsolidationSpec())


def test_overflow_ladder_with_consolidation_equals_reference(pair):
    """From a 1-slot pool the consolidating replay climbs the ladder as the
    reference's does."""
    _, batch, _ = pair
    text = "underload:t0.5:e8"
    port = port_sweep.run_batch(
        batch, "best_fit_l2", max_bins=1, device="cpu", block_events=8,
        consolidate=port_cons.ConsolidationSpec.parse(text))
    ref = ref_sweep.run_batch(batch, "best_fit_l2", max_bins=1,
                              backend="jnp",
                              consolidate=ref_cons.ConsolidationSpec.parse(
                                  text))
    assert (port.max_bins > 1).all()
    for k in ("usage_time", "n_bins_opened", "max_bins", "migrations"):
        assert np.array_equal(getattr(port, k), getattr(ref, k)), k


def _specs(mod, cons_mod):
    return mod.SweepSpec(
        suites=(mod.SuiteSpec("azure", 2, 60, 3),),
        policies=("first_fit", "ppe"),
        predictions=(mod.PredModel("clairvoyant"),
                     mod.PredModel("lognormal", 1.0)),
        seeds=(0, 1), max_bins=32,
        consolidations=(cons_mod.ConsolidationSpec(),
                        cons_mod.ConsolidationSpec.parse(SPEC)))


def test_run_sweep_store_with_consolidation_byte_identical(tmp_path):
    """The grid crosses policies x consolidations: spec hashes, records and
    the store file equal the reference's byte for byte, and a second run
    over the store is all cached."""
    port_spec, ref_spec = _specs(port_sweep, port_cons), \
        _specs(ref_sweep, ref_cons)
    assert port_spec.spec_hash() == ref_spec.spec_hash()
    assert port_spec.canonical() == ref_spec.canonical()
    off = port_sweep.SweepSpec(policies=("first_fit",))
    assert "consolidations" not in off.canonical()
    assert off.spec_hash() == ref_sweep.SweepSpec(
        policies=("first_fit",)).spec_hash()
    ps, rs = port_sweep.SweepStore(str(tmp_path / "p")), \
        ref_sweep.SweepStore(str(tmp_path / "r"))
    port = port_sweep.run_sweep(port_spec, store=ps, device="cpu")
    ref = ref_sweep.run_sweep(ref_spec, store=rs, backend="jnp")
    assert port == ref
    assert len(port) == 2 * 2 * (1 + 2) * 2
    assert {r.get("consolidate", "none") for r in port.values()} == \
        {"none", "underload:t0.5:b-1:e8"}
    with open(ps.path(port_spec), "rb") as f, \
            open(rs.path(ref_spec), "rb") as g:
        assert f.read() == g.read()
    msgs = []
    again = port_sweep.run_sweep(port_spec, store=ps, device="cpu",
                                 progress=msgs.append)
    assert again == port and len(msgs) == 8
    assert all(m.startswith("skip") and m.endswith("(cached)")
               for m in msgs)
    assert port_sweep.summarize_sweep(port).keys() == \
        ref_sweep.summarize_sweep(ref).keys()


def test_cli_consolidate_flag(tmp_path):
    """``python -m repro_torch sweep --consolidate`` writes the store that
    ``python -m repro sweep`` writes for the same arguments."""
    args = ["sweep", "--suites", "azure", "--n-instances", "1",
            "--n-items", "40", "--policies", "first_fit,cbd", "--preds",
            "clairvoyant", "--consolidate", "none", "underload:t0.5:e8"]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    stores = {}
    for pkg, extra in (("repro_torch", ["--device", "cpu"]),
                       ("repro", ["--backend", "jnp"])):
        stores[pkg] = str(tmp_path / pkg)
        p = subprocess.run([sys.executable, "-m", pkg, *args, *extra,
                            "--store", stores[pkg]], env=env,
                           capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr
        assert p.stdout.count("# run ") == 4, p.stdout
    files = {pkg: sorted(f for f in os.listdir(d)
                         if f.startswith("sweep_") and f.endswith(".json"))
             for pkg, d in stores.items()}
    assert files["repro_torch"] == files["repro"] and \
        len(files["repro"]) == 1
    blobs = [open(os.path.join(stores[pkg], files[pkg][0]), "rb").read()
             for pkg in ("repro_torch", "repro")]
    assert blobs[0] == blobs[1]
    tags = {r.get("consolidate", "none")
            for r in json.loads(blobs[0])["results"].values()}
    assert tags == {"none", "underload:t0.5:b-1:e8"}


# ------------------------------------------------- the card's constants

def test_frontier_equals_chip_constants():
    """benchmarks/perf.py::consolidate_sweep's frontier (28 x 250 seed 11,
    the headline policies, underload:t{0.15,0.25,0.5}:e32) per event in the
    port equals the reference's jnp path, and both are chip_smoke.REF_CONS,
    which the card must reproduce."""
    insts = make_azure_like_suite(28, 250, seed=11)
    batch = ref_sweep.pack_instances(insts)
    for thr, (migs, usage) in chip_smoke.REF_CONS.items():
        text = f"underload:t{thr:g}:e32"
        tot = {"port": [0, 0.0], "ref": [0, 0.0]}
        for p in chip_smoke.HEADLINE_POLICIES:
            for name, res in (
                    ("port", port_sweep.run_batch(
                        batch, p, max_bins=64, device="cpu",
                        consolidate=port_cons.ConsolidationSpec.parse(
                            text))),
                    ("ref", ref_sweep.run_batch(
                        batch, p, max_bins=64, backend="jnp",
                        consolidate=ref_cons.ConsolidationSpec.parse(
                            text)))):
                tot[name][0] += int(res.migrations.sum())
                tot[name][1] += float(res.usage_time.sum())
        assert tot["port"] == tot["ref"], thr
        assert (tot["ref"][0], f"{tot['ref'][1]:.0f}") == (migs, str(usage))
