"""The port's replay (``repro_torch.core.torchsim``) against the jnp replay
of the reference (``repro.core.jaxsim._replay_batch``, backend "jnp").

Fixture: the mixed-size, mixed-d, noisy-prediction batch of
tests/test_fitscore_select.py (copied, not imported): three fp32-exact
instances of 60/100/40 items in d = 2/4/3, each with a clairvoyant and a
noisy prediction row - pad events, the dmask path and the lane flattening
all in play.  Usage, opened bins, placements and overflow must be
bit-identical for all 8 score policies (and a few category ones), through
the overflow ladder, and across a carry handed from one package to the
other mid-replay."""
import numpy as np
import pytest
import torch

from repro.core import Instance
from repro.core import jaxsim
from repro.core.jaxsim import POLICIES
from repro.sweep import pack_instances, pad_predictions, run_batch
from repro.sweep.runner import _flatten_lanes
from repro_torch.core import torchsim
from repro_torch.core.types import Instance as PortInstance
from repro_torch.sweep import pack_instances as port_pack
from repro_torch.sweep import run_batch as port_run_batch

# the tensors here are tiny: intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)


def quantized_instance(seed, n, d):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 24, (n, d)) / 64.0
    arr = np.sort(rng.integers(0, 50000, n)).astype(float)
    dur = rng.integers(10, 5000, n).astype(float)
    return Instance(sizes, arr, arr + dur, f"q{seed}").sorted_by_arrival()


def port_instance(inst):
    return PortInstance(inst.sizes, inst.arrivals, inst.departures,
                        inst.name)


@pytest.fixture(scope="module")
def mixed():
    insts = [quantized_instance(1, 60, 2), quantized_instance(2, 100, 4),
             quantized_instance(3, 40, 3)]
    batch = pack_instances(insts)
    preds = []
    for i in insts:
        rng = np.random.default_rng(7)
        noisy = i.durations * rng.choice([0.5, 1.0, 2.0], i.n_items)
        preds.append(np.stack([i.durations, noisy]))
    pdeps = pad_predictions(batch, preds)
    lanes = _flatten_lanes(batch.sizes, batch.times, batch.kinds,
                           batch.items, pdeps, batch.dmask, batch.arrivals,
                           batch.pdeps, batch.n_items)
    return insts, batch, pdeps, tuple(np.asarray(a) for a in lanes)


def assert_same(ref_out, port_out):
    for r, p in zip(ref_out, port_out):
        np.testing.assert_array_equal(np.asarray(p), np.asarray(r))


@pytest.mark.parametrize("policy", POLICIES)
def test_replay_batch_bit_identical(policy, mixed):
    *_, lanes = mixed
    ref = jaxsim._replay_batch(*lanes, policy=policy, max_bins=16,
                               backend="jnp")
    got = torchsim._replay_batch(*lanes, policy=policy, max_bins=16,
                                 device="cpu")
    assert not np.asarray(ref[3]).any()
    assert_same(ref, got)


@pytest.mark.parametrize("policy", ["first_fit", "best_fit_l2", "greedy",
                                    "nrt_prioritized"])
def test_simulate_placements_identical(policy, mixed):
    insts, *_ = mixed
    inst = insts[1]
    pdur = inst.durations * np.random.default_rng(3).choice([0.5, 2.0],
                                                            inst.n_items)
    a = jaxsim.simulate(inst, policy, pdur, max_bins=16, backend="jnp")
    b = torchsim.simulate(port_instance(inst), policy, pdur, max_bins=16,
                          device="cpu")
    np.testing.assert_array_equal(b.placements, a.placements)
    assert (b.usage_time, b.n_bins_opened, b.overflowed, b.max_bins) == \
        (a.usage_time, a.n_bins_opened, a.overflowed, a.max_bins)


@pytest.mark.parametrize("policy", POLICIES)
def test_overflow_ladder_identical(policy, mixed):
    """max_bins=1 overflows every lane: the lane-wise ladder must climb
    the same rungs and land on the same results."""
    insts, batch, pdeps, _ = mixed
    a = run_batch(batch, policy, pdeps, max_bins=1, backend="jnp")
    b = port_run_batch(port_pack([port_instance(i) for i in insts]), policy,
                       pdeps, max_bins=1, device="cpu")
    assert (a.max_bins > 1).all()
    for f in ("usage_time", "n_bins_opened", "overflowed", "max_bins"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


def test_capacity_error_identical(mixed):
    insts, *_ = mixed
    inst = insts[1]
    errs = []
    for sim, i in ((jaxsim.simulate, inst),
                   (lambda *a, **k: torchsim.simulate(*a, device="cpu", **k),
                    port_instance(inst))):
        with pytest.raises(RuntimeError) as e:
            sim(i, "first_fit", max_bins=1, max_bins_cap=2)
        errs.append(e.value)
    a, b = errs
    assert isinstance(b, torchsim.CapacityError)
    assert (b.policy, b.max_bins, b.instance, str(b)) == \
        (a.policy, a.max_bins, a.instance, str(a))
    nogrow = torchsim.simulate(port_instance(inst), "first_fit", max_bins=2,
                               auto_grow=False, device="cpu")
    assert nogrow.overflowed and nogrow.max_bins == 2


def _halves(lanes):
    sizes, times, kinds, items, pdeps, dmask, arr, rdeps, n = lanes
    h = times.shape[1] // 2
    first = (sizes, times[:, :h], kinds[:, :h], items[:, :h], pdeps, dmask,
             arr, rdeps, n)
    second = (sizes, times[:, h:], kinds[:, h:], items[:, h:], pdeps, dmask,
              arr, rdeps, n)
    return first, second


@pytest.mark.parametrize("policy", ["first_fit", "best_fit_linf",
                                    "nrt_prioritized"])
def test_carry_from_reference_resumes(policy, mixed):
    """First half in JAX, second half in the port: the full JAX replay."""
    *_, lanes = mixed
    d = lanes[0].shape[2]
    first, second = _halves(lanes)
    full = jaxsim._replay_batch(*lanes, policy=policy, max_bins=16,
                                backend="jnp")
    *_, (core, cat) = jaxsim._replay_batch(
        *first, policy=policy, max_bins=16, backend="jnp",
        return_carry=True)
    assert cat == {}
    carry = torchsim.carry_from_reference(core, device="cpu")
    assert carry[0].shape[2] == 8
    got = torchsim._replay_batch(*second, policy=policy, max_bins=16,
                                 device="cpu", carry0=carry)
    assert_same(full, got)
    # the round trip through the port's layout is lossless
    back = torchsim.carry_to_reference(carry, d)
    for a, b in zip(core, back):
        np.testing.assert_array_equal(b, np.asarray(a))
        assert b.dtype == np.asarray(a).dtype


@pytest.mark.parametrize("policy", ["best_fit_l2", "greedy", "mru"])
def test_carry_to_reference_resumes(policy, mixed):
    """First half in the port, second half in JAX: the full port replay."""
    *_, lanes = mixed
    d = lanes[0].shape[2]
    first, second = _halves(lanes)
    full = torchsim._replay_batch(*lanes, policy=policy, max_bins=16,
                                  device="cpu")
    *_, carry = torchsim._replay_batch(*first, policy=policy, max_bins=16,
                                       device="cpu", return_carry=True)
    core = torchsim.carry_to_reference(carry, d)
    got = jaxsim._replay_batch(*second, policy=policy, max_bins=16,
                               backend="jnp", carry0=(core, {}))
    assert_same(full, got)


@pytest.mark.parametrize("policy", ["cbd", "hybrid", "rcp", "la_binary",
                                    "adaptive", "cbd_beta4"])
def test_category_policy_not_ported_raises(policy, mixed):
    """The category policies replay, bit-identical to the jnp reference on
    this fixture (the full matrix is tests/test_torch_categories.py).  The
    name dates from when the port refused them; it is kept so that this
    test's history stays one test."""
    *_, lanes = mixed
    ref = jaxsim._replay_batch(*lanes, policy=policy, max_bins=16,
                               backend="jnp")
    got = torchsim._replay_batch(*lanes, policy=policy, max_bins=16,
                                 device="cpu")
    assert_same(ref, got)


def test_plain_select_and_kernel_wrapper_agree(mixed, monkeypatch):
    """The replay with ``select_ref`` bound in place of the wrapper (as the
    card check runs its plain yardstick) equals the replay through the
    wrapper; on the CPU the wrapper serves ``select_ref`` itself."""
    from repro_torch.kernels.fitscore import select_ref
    *_, lanes = mixed
    a = torchsim._replay_batch(*lanes, policy="nrt_standard", max_bins=16,
                               device="cpu")
    monkeypatch.setattr(torchsim, "fitscore_select", select_ref)
    b = torchsim._replay_batch(*lanes, policy="nrt_standard", max_bins=16,
                               device="cpu")
    assert_same(a, b)


def test_event_sequence_identical(mixed):
    insts, *_ = mixed
    for inst in insts:
        for a, b in zip(jaxsim.event_sequence(inst),
                        torchsim.event_sequence(port_instance(inst))):
            np.testing.assert_array_equal(b, a)
            assert b.dtype == a.dtype
