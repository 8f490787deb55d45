"""The PyTorch port (``repro_torch``) stands alone: it imports neither JAX
nor anything of the JAX package, its constants equal the reference's, and
asking for the card where there is none raises instead of running on the
CPU."""
import os
import re
import subprocess
import sys

import pytest
import torch

import repro.core.jaxsim as jaxsim
import repro.kernels.fitscore as ref_fitscore
import repro_torch.core.torchsim as torchsim
import repro_torch.kernels.fitscore as port_fitscore
from repro_torch.kernels import ops

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f),
                                      os.path.join(ROOT, "src"))
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_import_loads_no_jax_and_no_reference():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(len(sys.modules), bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["repro_torch.consolidate",
                                    "repro_torch.kernels.ops",
                                    "repro_torch.kernels.legacy",
                                    "repro_torch.api",
                                    "repro_torch.serving.dispatch",
                                    "repro_torch.serving.admission",
                                    "repro_torch.serving.traffic"])
def test_entry_module_alone_loads_no_jax(module):
    """Each of the consolidation, kernel, experiment-API and online-serving
    entry modules, imported alone in a fresh interpreter, loads neither JAX
    nor the JAX package."""
    code = (f"import {module}, sys\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name", ["KINDS", "_MIG_PAD", "PLAN_EPS"])
def test_consolidation_constants_equal_reference(name):
    import repro.consolidate.driver as ref_driver
    import repro.consolidate.planner as ref_planner
    import repro.consolidate.spec as ref_spec
    import repro_torch.consolidate.driver as port_driver
    import repro_torch.consolidate.planner as port_planner
    import repro_torch.consolidate.spec as port_spec
    mods = {"KINDS": (ref_spec, port_spec), "_MIG_PAD": (ref_driver,
                                                         port_driver),
            "PLAN_EPS": (ref_planner, port_planner)}[name]
    assert getattr(mods[0], name) == getattr(mods[1], name)


_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)",
                        re.MULTILINE)


@pytest.mark.parametrize("path", [
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(PORT) for f in sorted(fs) if f.endswith(".py")
] + ["chip_smoke.py"])
def test_source_imports_neither_jax_nor_reference(path):
    with open(os.path.join(ROOT, path)) as f:
        src = f.read()
    assert not _FORBIDDEN.findall(src), path


@pytest.mark.parametrize("name", [
    "SELECT_POLICIES", "SCORE_BIG", "SCORE_NEG", "F32_EPS", "IBIG",
    "ARRIVAL_KIND", "DEPARTURE_KIND", "PAD_KIND", "MIGRATE_KIND",
    "TAG_VIRGIN", "TAG_GENERAL", "TAG_BASE", "TAG_LARGE", "TAG_NONE",
    "LOC_G", "LOC_B", "LOC_C", "LOC_L", "KCAT"])
def test_kernel_constants_equal_reference(name):
    assert getattr(port_fitscore, name) == getattr(ref_fitscore, name)


@pytest.mark.parametrize("name", [
    "POLICIES", "NEG", "BIG", "CATEGORY_POLICIES", "SCAN_POLICIES",
    "CBDT_DEFAULT_RHO", "MAX_BINS_CAP"])
def test_replay_constants_equal_reference(name):
    assert getattr(torchsim, name) == getattr(jaxsim, name)


@pytest.mark.parametrize("policy", jaxsim.SCAN_POLICIES + (
    "cbd_beta4", "cbdt_rho3600", "adaptive_2_16", "adaptive_1.5_8"))
def test_policy_spec_equals_reference(policy):
    a, b = jaxsim.policy_spec(policy), torchsim.policy_spec(policy)
    assert a.__dict__ == b.__dict__
    assert torchsim.known_policy(policy)


@pytest.mark.parametrize("policy,exc", [
    ("cbd_beta-1", ValueError), ("cbd_beta1", ValueError),
    ("cbdt_rho0", ValueError), ("adaptive_8_2", ValueError),
    ("adaptive_0.5_2", ValueError), ("cbd_betax", KeyError),
    ("adaptive_2", KeyError), ("nope", KeyError)])
def test_policy_spec_errors_equal_reference(policy, exc):
    for mod in (jaxsim, torchsim):
        with pytest.raises(exc) as e:
            mod.policy_spec(policy)
        msg = str(e.value)
        if mod is jaxsim:
            ref_msg = msg
    assert msg == ref_msg


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    from repro_torch.core.types import Instance
    from repro_torch.sweep import (SuiteSpec, SweepSpec, pack_instances,
                                   run_batch, run_sweep)
    import numpy as np
    inst = Instance(np.array([[0.5]]), np.array([0.0]), np.array([1.0]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torchsim.simulate(inst, "first_fit")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_batch(pack_instances([inst]), "first_fit")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep(SweepSpec(suites=(SuiteSpec("azure", 1, 20),)))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "sweep", "--n-instances", "1",
         "--n-items", "20", "--store", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_select_wrapper_dispatch():
    assert ops.resolved_select_impl("cpu") == "torch"
    assert ops.resolved_select_impl("cuda") == "cuda"
    assert ops.resolved_select_impl(torch.device("cuda", 0)) == "cuda"
