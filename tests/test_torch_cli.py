"""The port's CLI in subprocesses on the CPU, against the JAX package's:
``python -m repro_torch serve --device cpu`` in both modes (capacity
planning through ``api.serving_requests``, and ``--traffic`` through
``serving.dispatch.serve_traffic``) prints the rows ``python -m repro
serve`` prints for the same flags, and ``python -m repro_torch sweep``
reads an Azure Packing2020 dump through ``--trace-root`` (a small one the
test writes) with the reference's summary.  In ``--traffic`` mode the
throughput and latency columns are wall-clock measurements of each
process; the policy, replica-seconds, opened and shed columns are held.
"""
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _run(module, args, tmp_path, **env_kw):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", **env_kw)
    proc = subprocess.run([sys.executable, "-m", module, *args], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = [ln for ln in proc.stdout.splitlines() if not ln.startswith("#")]
    return (rows, proc.stderr) if env_kw else rows


SERVE = ("serve", "--requests", "150", "--sigma", "0.5", "--baselines",
         "--policies", "best_fit_linf,cbd")


def test_serve_capacity_planning_rows_equal_reference(tmp_path):
    port = _run("repro_torch", SERVE + ("--device", "cpu"), tmp_path)
    ref = _run("repro", SERVE + ("--backend", "jnp"), tmp_path)
    assert len(port) == 5 and port == ref


def test_serve_traffic_rows_equal_reference(tmp_path):
    args = ("serve", "--traffic", "poisson", "--requests", "120", "--rate",
            "5e4", "--tps", "1.2e5", "--sigma", "0.3", "--batch-max", "32",
            "--policies", "first_fit,rcp")
    port = _run("repro_torch", args + ("--device", "cpu"), tmp_path)
    ref = _run("repro", args, tmp_path)

    def held(rows):
        head, *body = rows
        return head, [(r.split()[0],) + tuple(r.split()[4:]) for r in body]

    assert len(port) == 3 and held(port) == held(ref)


def _write_dump(root):
    """A small dump in the Azure Packing2020 layout: two machines, three
    VM types, 60 requests over a week (times in days)."""
    os.makedirs(root)
    with open(os.path.join(root, "vmtype.csv"), "w") as f:
        f.write("vmTypeId,machineId,core,memory,hdd,ssd,nic\n"
                "0,0,0.25,0.125,0,0.1,0.05\n"
                "1,0,0.5,0.25,0,0.2,0.1\n"
                "2,1,0.125,0.5,0.25,0,0.0625\n")
    rng = np.random.default_rng(7)
    starts = np.sort(rng.integers(0, 7 * 64, 60)) / 64   # sorted, as dumped
    with open(os.path.join(root, "vmrequest.csv"), "w") as f:
        f.write("vmTypeId,starttime,endtime\n")
        for t in starts:
            f.write(f"{int(rng.integers(0, 3))},{t},"
                    f"{t + float(rng.integers(1, 96)) / 64}\n")


def test_sweep_reads_a_trace_root(tmp_path):
    """``--suites azure_trace --trace-root DIR`` replays the dump with the
    reference's summary; the legacy ``python -m repro_torch.sweep`` prints
    the same and warns once with the migration tag."""
    _write_dump(str(tmp_path / "dump"))
    args = ("--suites", "azure_trace", "--trace-root", str(tmp_path / "dump"),
            "--policies", "first_fit,cbd", "--no-store")
    port = _run("repro_torch", ("sweep",) + args + ("--device", "cpu"),
                tmp_path)
    ref = _run("repro", ("sweep",) + args + ("--backend", "jnp"), tmp_path)
    assert len(port) == 3 and port == ref
    legacy, err = _run("repro_torch.sweep", args + ("--device", "cpu"),
                       tmp_path, PYTHONWARNINGS="always")
    assert legacy == port
    assert err.count("REPRO_API_MIGRATION") == 1, err


def test_bench_names_its_roadmap_item(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch", "bench"],
                          env=env, cwd=str(tmp_path), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and "Queue 1 item 7" in proc.stderr
