"""The legacy single-pool scorer: the port's plain version
(``repro_torch.kernels.legacy.fitscore_ref``, the plain version of
``csrc/fitscore.cu``) against the reference's ``ops.fitscore`` - the Pallas
kernel in interpret mode (how the JAX package's own tests run it on the
CPU) and its ``ref`` path - on the shapes of ``tests/test_kernels.py``,
exactly on 1/64-grid pools with ties, the no-feasible case and the
open_seq tie-break.  The CUDA kernel's own comparison with the plain
version runs only on a card (tests/test_torch_cuda.py, ``chip_smoke.py``).
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.fitscore as ref_fitscore
from repro.kernels import ops as ref_ops
from repro_torch.kernels import legacy
from repro_torch.kernels import ops
from repro_torch.kernels.legacy import NORMS, fitscore_ref

torch.set_num_threads(1)


def _port(rem, alive, item, open_seq=None, norm="linf"):
    s, b = fitscore_ref(torch.from_numpy(np.asarray(rem, np.float32)),
                        torch.from_numpy(np.asarray(alive, bool)),
                        torch.from_numpy(np.asarray(item, np.float32)),
                        None if open_seq is None else
                        torch.from_numpy(np.asarray(open_seq, np.int32)),
                        norm=norm)
    assert s.dtype == torch.float32 and b.dtype == torch.int32
    assert b.dim() == 0
    return s.numpy(), int(b)


def _ref(rem, alive, item, open_seq=None, norm="linf",
         impl="pallas_interpret"):
    s, b = ref_ops.fitscore(
        jnp.asarray(rem, jnp.float32), jnp.asarray(alive),
        jnp.asarray(item, jnp.float32),
        None if open_seq is None else jnp.asarray(open_seq, jnp.int32),
        norm=norm, impl=impl)
    return np.asarray(s), int(b)


@pytest.mark.parametrize("N,d,norm", [
    (100, 4, "linf"), (1000, 5, "l1"), (37, 2, "l2"), (300, 4, "first_fit"),
    (8, 4, "linf"), (256, 1, "linf"),
])
@pytest.mark.parametrize("impl", ["pallas_interpret", "ref"])
def test_fitscore_ref_equals_reference(N, d, norm, impl):
    """tests/test_kernels.py::test_fitscore's inputs and tolerance (1e-5):
    the scores agree, and the chosen bin is the same or ties on score."""
    rng = np.random.default_rng(0)
    rem = rng.random((N, d)).astype(np.float32)
    alive = rng.random(N) > 0.3
    item = (rng.random(d) * 0.5).astype(np.float32)
    s_p, b_p = _port(rem, alive, item, norm=norm)
    s_r, b_r = _ref(rem, alive, item, norm=norm, impl=impl)
    np.testing.assert_allclose(np.nan_to_num(s_p, posinf=1e9),
                               np.nan_to_num(s_r, posinf=1e9),
                               atol=1e-5, rtol=1e-5)
    assert np.array_equal(np.isinf(s_p), np.isinf(s_r))
    assert b_p == b_r or float(s_r[b_p]) == pytest.approx(float(s_r[b_r]))


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("N", [300, 1000])
def test_exact_on_grid_pools_with_ties(norm, N):
    """On 1/64-grid capacities every score is exact in fp32, so the port
    equals the interpret-mode Pallas kernel bit for bit, and so does the
    chosen bin: many bins tie on score and, with repeated open_seq values,
    on open_seq too, across the kernel's 256-bin tiles."""
    rng = np.random.default_rng(N)
    d = 3
    rem = rng.integers(8, 12, (N, d)) / 64.0
    item = rng.integers(1, 8, d) / 64.0
    alive = rng.random(N) > 0.1
    oseq = rng.integers(0, 4, N)
    for open_seq in (oseq, rng.permutation(N), None):
        s_p, b_p = _port(rem, alive, item, open_seq, norm=norm)
        s_r, b_r = _ref(rem, alive, item, open_seq, norm=norm)
        assert np.array_equal(s_p, s_r)
        assert b_p == b_r


def test_no_feasible_gives_minus_one():
    rem = np.zeros((10, 3))
    alive = np.ones(10, bool)
    item = np.full(3, 0.5)
    s_p, b_p = _port(rem, alive, item)
    assert b_p == -1 == _ref(rem, alive, item)[1]
    assert np.isinf(s_p).all()
    # dead bins are infeasible however much room they have
    s_p, b_p = _port(np.ones((4, 2)), np.zeros(4, bool), np.full(2, 0.1))
    assert b_p == -1 and np.isinf(s_p).all()


@pytest.mark.parametrize("norm,want", [("l1", 2), ("l2", 2), ("linf", 2),
                                       ("first_fit", 2)])
def test_ties_break_by_open_seq(norm, want):
    """tests/test_kernels.py::test_fitscore_ties_break_by_open_seq: score
    ties fall to the earliest-opened bin, not the smallest slot index."""
    rem = np.array([[0.5, 0.5], [0.125, 0.75], [0.5, 0.5]])
    alive = np.ones(3, bool)
    item = np.array([0.25, 0.25])
    open_seq = np.array([7, 3, 1])
    assert _port(rem, alive, item, open_seq, norm=norm)[1] == want
    assert _ref(rem, alive, item, open_seq, norm=norm)[1] == want
    if norm == "linf":
        # without open_seq the slot index is the opening order
        assert _port(rem, alive, item, norm=norm)[1] == 0


def test_two_pass_reduction_equals_the_global_minimum():
    """The CUDA kernel reduces per-CTA (score, open_seq, row) minima, then
    the partials; the TPU kernel runs a minimum over its tiles in order.
    Rows are unique, so every split gives the global lexicographic minimum:
    emulate the kernel's split (256-row CTAs, grid-stride) on a tied pool."""
    rng = np.random.default_rng(3)
    N, d = 5000, 2
    rem = rng.integers(8, 10, (N, d)) / 64.0
    alive = rng.random(N) > 0.5
    item = np.full(d, 1 / 64)
    oseq = rng.integers(0, 3, N)
    s, b = _port(rem, alive, item, oseq, norm="l1")
    for blocks in (1, 3, 7, 20):
        parts = []
        for cta in range(blocks):
            rows = [r for tile in range(cta * 256, N, blocks * 256)
                    for r in range(tile, min(tile + 256, N))]
            cand = [(s[r], oseq[r], r) for r in rows if np.isfinite(s[r])]
            if cand:
                parts.append(min(cand))
        assert min(parts)[2] == b


def test_cpu_ops_fitscore_runs_the_plain_version():
    rng = np.random.default_rng(5)
    rem = torch.from_numpy(rng.random((64, 4)).astype(np.float32))
    alive = torch.from_numpy(rng.random(64) > 0.2)
    item = torch.from_numpy((rng.random(4) * 0.4).astype(np.float32))
    n0 = ops.launches["fitscore"]
    for norm in NORMS:
        s, b = ops.fitscore(rem, alive, item, norm=norm)
        s_p, b_p = fitscore_ref(rem, alive, item, norm=norm)
        assert torch.equal(s, s_p) and int(b) == int(b_p)
    assert ops.launches["fitscore"] == n0
    with pytest.raises(ValueError, match="norm"):
        fitscore_ref(rem, alive, item, norm="l3")


@pytest.mark.parametrize("name", ["EPS", "BIG", "NORMS"])
def test_constants_equal_reference(name):
    assert getattr(legacy, name) == getattr(ref_fitscore, name)


def test_cuda_constants_equal_python():
    """``csrc/fitscore.cu`` writes the tolerance, the infeasible score and
    the norm codes out again; they must be ``legacy``'s (in float32, as the
    kernel holds them)."""
    path = os.path.join(os.path.dirname(legacy.__file__), "csrc",
                        "fitscore.cu")
    text = re.sub(r"//[^\n]*", "", open(path).read())
    found = dict(re.findall(r"constexpr float (\w+) = ([\d.e+-]+)f;", text))
    assert np.float32(float(found["LEGACY_EPS"])) == np.float32(legacy.EPS)
    assert np.float32(float(found["LEGACY_BIG"])) == np.float32(legacy.BIG)
    body = re.search(r"enum Norm : int \{([^}]*)\}", text).group(1)
    codes = {k.strip(): int(v) for k, v in
             (decl.split("=") for decl in body.split(",") if decl.strip())}
    assert codes == {f"NORM_{n.upper()}": i for i, n in enumerate(NORMS)}
