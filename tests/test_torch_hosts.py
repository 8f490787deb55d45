"""The sweep's grid split across hosts (``run_sweep(host_index=,
host_count=)``, the CLI's ``--hosts`` / ``--host-index`` / ``--host-count``
and ``REPRO_HOST_INDEX`` / ``REPRO_HOST_COUNT``) against the reference's:
the same cells a host, slices that merge into the single-process store
byte for byte, and a store the reference writes for the same spec."""
import json
import os
import subprocess
import sys

import pytest
import torch

import repro.sweep as ref_sweep
import repro_torch.sweep as port_sweep

ROOT = os.path.join(os.path.dirname(__file__), "..")
# the tensors here are tiny: intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

SUITE = ("azure", 2, 60, 5)
POLICIES = ("first_fit", "greedy", "cbd", "rcp")
CLI_ARGS = ["--device", "cpu", "--n-instances", "2", "--n-items", "60",
            "--suite-seed", "5", "--policies", "first_fit,greedy,cbd,rcp",
            "--preds", "clairvoyant", "lognormal:1.0", "--seeds", "0,1"]


def _spec(pkg, preds=(("clairvoyant", 0.0),), policies=POLICIES):
    return pkg.SweepSpec(suites=(pkg.SuiteSpec(*SUITE),), policies=policies,
                         predictions=tuple(pkg.PredModel(*p) for p in preds),
                         seeds=(0, 1))


def _file(store, spec):
    with open(store.path(spec), "rb") as f:
        return f.read()


def test_two_host_sweep_merges_to_single_process(tmp_path):
    """Two host slices against one store == the single-process sweep: the
    same records and the same file, byte for byte (checksum and results
    included)."""
    spec = _spec(port_sweep)
    solo_store = port_sweep.SweepStore(str(tmp_path / "solo"))
    solo = port_sweep.run_sweep(spec, store=solo_store, device="cpu")
    multi_store = port_sweep.SweepStore(str(tmp_path / "multi"))
    for host in (0, 1):
        port_sweep.run_sweep(spec, store=multi_store, device="cpu",
                             host_index=host, host_count=2)
    assert multi_store.load(spec) == solo
    a, b = (json.loads(_file(s, spec)) for s in (solo_store, multi_store))
    assert a["checksum"] == b["checksum"]
    assert a["results"] == b["results"]
    assert _file(multi_store, spec) == _file(solo_store, spec)


def test_merged_store_equals_the_reference_single_process_store(tmp_path):
    """The port's 2-host merged store and the reference's single-process
    ``run_sweep`` (backend jnp) store of the same spec: one file, byte for
    byte."""
    ref_spec, spec = _spec(ref_sweep), _spec(port_sweep)
    ref_store = ref_sweep.SweepStore(str(tmp_path / "ref"))
    ref_sweep.run_sweep(ref_spec, store=ref_store, backend="jnp")
    store = port_sweep.SweepStore(str(tmp_path / "port"))
    for host in (0, 1):
        port_sweep.run_sweep(spec, store=store, device="cpu",
                             host_index=host, host_count=2)
    assert _file(store, spec) == _file(ref_store, ref_spec)


@pytest.mark.parametrize("host_count", [2, 3])
def test_host_slices_are_disjoint_complete_and_the_references(tmp_path,
                                                              host_count):
    """Each host computes a strict subset, the union covers the grid and
    equals the single-process records, and every host runs the cells the
    reference's host of the same index runs (two prediction settings: the
    cell counter runs on across them)."""
    preds = (("clairvoyant", 0.0), ("lognormal", 1.0))
    spec = _spec(port_sweep, preds, ("first_fit", "greedy", "mru"))
    ref_spec = _spec(ref_sweep, preds, ("first_fit", "greedy", "mru"))
    parts = []
    for host in range(host_count):
        store = port_sweep.SweepStore(str(tmp_path / f"h{host}"))
        got = port_sweep.run_sweep(spec, store=store, device="cpu",
                                   host_index=host, host_count=host_count)
        want = ref_sweep.run_sweep(ref_spec, backend="jnp", host_index=host,
                                   host_count=host_count)
        assert got == want
        assert 0 < len(got)
        parts.append(got)
    keys = [set(p) for p in parts]
    assert sum(len(k) for k in keys) == len(set().union(*keys))
    full = port_sweep.run_sweep(spec, device="cpu")
    union = {}
    for p in parts:
        union.update(p)
    assert union == full


@pytest.mark.parametrize("index,count", [(2, 2), (-1, 2)])
def test_a_host_index_outside_the_count_is_refused(index, count):
    with pytest.raises(AssertionError):
        port_sweep.run_sweep(_spec(port_sweep), device="cpu",
                             host_index=index, host_count=count)


def _cli(args, env=None, timeout=300):
    env = dict(os.environ if env is None else env,
               PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch", "sweep"] +
                          args, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _summary(stdout):
    """The summary table: the lines after the header row."""
    lines = stdout.splitlines()
    head = next(i for i, s in enumerate(lines) if s.startswith("policy "))
    return lines[head:]


@pytest.mark.parametrize("hosts_flag", [["--hosts", "2"], ["--hosts=2"]])
def test_cli_launcher_equals_a_single_process_run(tmp_path, hosts_flag):
    """``--hosts 2`` (either spelling) starts two workers on the CPU, then
    re-reads the merged store: the store file equals a single-process CLI
    run's byte for byte, every group of the merge is cached and the
    summary is the same."""
    solo = _cli(CLI_ARGS + ["--store", str(tmp_path / "solo")])
    assert solo.returncode == 0, solo.stderr
    multi = _cli(CLI_ARGS + hosts_flag + ["--store", str(tmp_path / "multi")])
    assert multi.returncode == 0, multi.stderr
    assert multi.stdout.count(" host 0/2 -> ") == 1
    assert multi.stdout.count(" host 1/2 -> ") == 1
    # 4 policies x 2 prediction settings: 8 groups run by the workers, then
    # 8 cached in the merge
    assert multi.stdout.count("# run ") == 8
    assert multi.stdout.count("(cached)") == 8
    spec = _spec(port_sweep, (("clairvoyant", 0.0), ("lognormal", 1.0)))
    assert _file(port_sweep.SweepStore(str(tmp_path / "multi")), spec) == \
        _file(port_sweep.SweepStore(str(tmp_path / "solo")), spec)
    assert _summary(multi.stdout)[-9:] == _summary(solo.stdout)


def test_cli_launcher_refuses_no_store():
    out = _cli(CLI_ARGS + ["--hosts", "2", "--no-store"])
    assert out.returncode != 0
    assert "--hosts needs a store to merge results into" in out.stderr


@pytest.mark.parametrize("how", ["environment", "flags"])
def test_one_slice_from_the_environment_or_the_flags(tmp_path, how):
    """``REPRO_HOST_INDEX=1 REPRO_HOST_COUNT=2`` (or ``--host-index 1
    --host-count 2``) runs host 1's slice alone: its store holds exactly
    the records of ``run_sweep(host_index=1, host_count=2)``."""
    store = str(tmp_path / "store")
    env = dict(os.environ)
    env.pop("REPRO_HOST_INDEX", None)
    env.pop("REPRO_HOST_COUNT", None)
    args = CLI_ARGS + ["--store", store]
    if how == "environment":
        env.update(REPRO_HOST_INDEX="1", REPRO_HOST_COUNT="2")
    else:
        args += ["--host-index", "1", "--host-count", "2"]
    out = _cli(args, env=env)
    assert out.returncode == 0, out.stderr
    assert " host 1/2 -> " in out.stdout
    spec = _spec(port_sweep, (("clairvoyant", 0.0), ("lognormal", 1.0)))
    want = port_sweep.run_sweep(spec, device="cpu", host_index=1,
                                host_count=2)
    assert port_sweep.SweepStore(store).load(spec) == want
    assert 0 < len(want) < len(port_sweep.run_sweep(spec, device="cpu"))
