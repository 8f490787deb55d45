"""The port's plain select (``repro_torch.kernels.fitscore.select_ref``)
against the reference select, bit for bit.

Both reference forms run on the same random states as in
tests/test_fitscore_select.py: the jitted, vmapped jnp ``_select_slot``
(the replay's jnp step) and the Pallas kernel in interpret mode.  States
cover all 8 policies, with and without a category mask, score ties across
reused slots, full pools (``no_free``) and d in {2, 4, 5}, on fp32-exact
loads (1/64 grid) and on uniform random loads.  The random case is where
rounding shows: the reference's jitted l2 norm is an FMA chain, which the
plain select reproduces.  The CUDA kernel's own comparison runs only on a
card: tests/test_torch_cuda.py and ``chip_smoke.py``."""
from functools import partial

import jax
import numpy as np
import pytest
import torch

from repro.core.jaxsim import POLICIES, _select_slot
from repro.kernels.fitscore import fitscore_select_batch
from repro_torch.kernels.fitscore import DPAD
from repro_torch.kernels.ops import fitscore_select

# the tensors here are tiny: intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)


def make_state(seed, L, N, d, exact):
    """A batch of select inputs.  Lane 0 is a full pool (every slot busy,
    nothing fits); lane 1 holds exact score ties on reused slots (equal
    loads and closes, open_seq out of row order); a third of the lanes mask
    their last dim."""
    rng = np.random.default_rng(seed)
    if exact:
        loads = rng.integers(0, 48, (L, N, d)) / 64.0
        size = rng.integers(1, 24, (L, d)) / 64.0
        closes = rng.integers(0, 100, (L, N)).astype(float)
    else:
        loads = rng.uniform(0, 0.9, (L, N, d))
        size = rng.uniform(0.01, 0.4, (L, d))
        closes = rng.uniform(0, 100, (L, N))
    counts = rng.integers(0, 3, (L, N))
    oseq = np.stack([rng.permutation(N) for _ in range(L)])
    counts[0] = 1
    loads[0] = 0.99
    loads[1] = loads[1, :1]
    closes[1] = closes[1, 0]
    dmask = np.ones((L, d))
    dmask[::3, -1] = 0.0
    f32, i32 = np.float32, np.int32
    return dict(
        loads=loads.astype(f32), counts=counts.astype(i32),
        alive=counts > 0, open_seq=oseq.astype(i32),
        access_seq=rng.integers(0, 50, (L, N)).astype(i32),
        closes=closes.astype(f32), size=size.astype(f32),
        pdep=rng.uniform(0, 100, L).astype(f32),
        now=rng.uniform(0, 60, L).astype(f32), dmask=dmask.astype(f32),
        cmask=rng.random((L, N)) < 0.8)


ORDER = ("loads", "counts", "alive", "open_seq", "access_seq", "closes",
         "size", "pdep", "now", "dmask")


def port_select(st, policy, use_cmask, device="cpu"):
    """The port's select on the state, loads and size padded to DPAD."""
    L, N, d = st["loads"].shape
    t = {k: torch.from_numpy(v).to(device) for k, v in st.items()}
    for k, shape in (("loads", (L, N, DPAD)), ("size", (L, DPAD)),
                     ("dmask", (L, DPAD))):
        pad = torch.zeros(shape, dtype=torch.float32, device=device)
        pad[..., :d] = t[k]
        t[k] = pad
    return fitscore_select(*(t[k] for k in ORDER),
                           t["cmask"] if use_cmask else None, policy=policy)


def as_np(out):
    return [np.asarray(a).astype(np.int64) for a in out]


@pytest.mark.parametrize("exact", [True, False], ids=["fp32exact", "random"])
@pytest.mark.parametrize("d", [2, 4, 5])
@pytest.mark.parametrize("policy", POLICIES)
def test_select_ref_equals_jnp_select(policy, d, exact):
    jsel = jax.jit(jax.vmap(partial(_select_slot, policy)))
    for seed in range(3):
        st = make_state(seed, 12, 40, d, exact)
        for use_cmask in (False, True):
            args = [st[k] for k in ORDER] + \
                ([st["cmask"]] if use_cmask else [])
            ref = as_np(jsel(*args))
            got = as_np(port_select(st, policy, use_cmask))
            for r, g in zip(ref, got):
                np.testing.assert_array_equal(g, r)
        assert got[2][0] == 1 and got[1][0] == 0   # the full lane


@pytest.mark.parametrize("exact", [True, False], ids=["fp32exact", "random"])
@pytest.mark.parametrize("policy", POLICIES)
def test_select_ref_equals_pallas_interpret(policy, exact):
    st = make_state(11, 4, 24, 5, exact)
    for use_cmask in (False, True):
        ref = as_np(fitscore_select_batch(
            *(st[k] for k in ORDER), st["cmask"] if use_cmask else None,
            policy=policy, interpret=True))
        got = as_np(port_select(st, policy, use_cmask))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("policy", ["best_fit_l1", "best_fit_linf"])
def test_tie_falls_to_earliest_opened_slot(policy):
    """Two identical feasible bins: the one opened first wins, even when
    it sits in the higher row (a reused slot has a low row but a late
    opening order)."""
    st = make_state(0, 2, 4, 2, True)
    st["loads"][1] = 0.25
    st["counts"][1] = [1, 1, 0, 0]
    st["alive"][1] = [True, True, False, False]
    st["open_seq"][1] = [7, 3, 0, 0]
    st["dmask"][1] = 1.0
    slot, found, no_free = port_select(st, policy, False)
    assert (int(slot[1]), bool(found[1]), bool(no_free[1])) == (1, True,
                                                                 False)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    st = make_state(0, 2, 8, 2, True)
    with pytest.raises(ValueError, match="not a select policy"):
        port_select(st, "cbd", False)
    meta = {k: torch.from_numpy(v).to("meta") for k, v in st.items()}
    with pytest.raises(ValueError, match="no kernel"):
        fitscore_select(*(meta[k] for k in ORDER), policy="first_fit")


def test_l2_rounding_is_an_fma_chain():
    """Why ``score_ref`` writes the l2 norm as an FMA chain: under jit, XLA
    on the CPU contracts the reference's sum of squares into
    ``q = fma(a_k, a_k, q)``.  On 7168 random 4-vectors plain fp32
    ``q + a*a`` disagrees with the jitted reference in many cases (868 with
    this seed), the emulated FMA chain in none."""
    import jax.numpy as jnp
    a = np.random.default_rng(0).uniform(-1, 1, (7168, 4)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: jnp.sqrt(jnp.sum(x * x, -1)))(a))
    q = np.zeros(7168, np.float32)
    for k in range(4):
        q = q + a[:, k] * a[:, k]
    assert (np.sqrt(q) != ref).sum() > 100
    from repro_torch.kernels.fitscore import _fma_f32
    t = torch.from_numpy(a)
    qf = torch.zeros(7168)
    for k in range(4):
        qf = _fma_f32(t[:, k], t[:, k], qf)
    np.testing.assert_array_equal(torch.sqrt(qf.double()).float().numpy(),
                                  ref)
