"""The port's category-structured policies against the reference, bit for
bit: the classifier twins, the category set-up, and the per-event and
event-blocked replays of all 21 scan policies.

The replays run the mixed fixture of tests/test_replay_block.py (copied,
not imported): three fp32-exact instances (1/64-grid sizes, integer times)
of 40/60/30 items in d = 2/4/3, each with three prediction rows -
clairvoyant, pdep == arrival (the nonclairvoyant-style replay) and
power-of-two noise - so pad events, the dim mask and every information
setting are lanes of one batch.  The reference is
``repro.core.jaxsim._replay_batch`` on the jnp backend.  Tolerance: none;
usage, opened bins, placements, overflow and the final category state must
be equal bit for bit.  The classifiers are held to the reference's jitted
jnp twins on boundary values (powers of 2 and 4 and multiples of rho, one
ulp either side) and random ones, also exactly."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import Instance
from repro.core import jaxsim
from repro.core.algorithms import adaptive as ref_adaptive
from repro.core.algorithms import departure as ref_departure
from repro.core.algorithms import duration as ref_duration
from repro.core.algorithms import learned as ref_learned
from repro.sweep import pack_instances, pad_predictions
from repro.sweep.runner import _flatten_lanes
from repro_torch.core import algorithms as port_alg
from repro_torch.core import torchsim
from repro_torch.core.types import Instance as PortInstance
from repro_torch.kernels import fitscore as fk

# the tensors here are tiny: intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

MAX_BINS = 20      # not a power of two: a ragged slot pool


# ----------------------------------------------------------- classifiers

def _ulps(x):
    x = np.asarray(x, np.float32)
    return np.concatenate([np.nextafter(x, np.float32(-np.inf)), x,
                           np.nextafter(x, np.float32(np.inf))])


def _values():
    rng = np.random.default_rng(5)
    pow2 = 2.0 ** np.arange(-45, 41)
    pow4 = 4.0 ** np.arange(-20, 21)
    rand = rng.lognormal(6.0, 4.0, 4000)
    special = [0.0, 1e-12, 1e-13, 0.5, 1.0, 7200.0, 86400.0, np.inf,
               -1.0, -0.0]
    return np.concatenate([_ulps(pow2), _ulps(pow4), _ulps(rand),
                           np.asarray(special)]).astype(np.float32)


def _same(ref_fn, port_fn, *xs):
    ref = np.asarray(jax.jit(ref_fn)(*(jnp.asarray(x) for x in xs)))
    got = port_fn(*(torch.from_numpy(np.asarray(x)) for x in xs)).numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", [
    "dur_exponent_jnp", "geo_class_jnp", "la_class_binary",
    "la_class_geometric", "duration_class_beta2", "duration_class_beta4",
    "pow2_ceiling_jnp"])
def test_classifier_twins_equal_reference(name):
    x = _values()
    twins = {
        "dur_exponent_jnp": (ref_duration.dur_exponent_jnp,
                             port_alg.dur_exponent_jnp),
        "geo_class_jnp": (ref_learned.geo_class_jnp, port_alg.geo_class_jnp),
        "la_class_binary": (lambda v: ref_learned.la_class_jnp(v, "binary"),
                            lambda v: port_alg.la_class_jnp(v, "binary")),
        "la_class_geometric": (
            lambda v: ref_learned.la_class_jnp(v, "geometric"),
            lambda v: port_alg.la_class_jnp(v, "geometric")),
        "duration_class_beta2": (
            lambda v: ref_duration.duration_class_jnp(v, 2.0),
            lambda v: port_alg.duration_class_jnp(v, 2.0)),
        "duration_class_beta4": (
            lambda v: ref_duration.duration_class_jnp(v, 4.0),
            lambda v: port_alg.duration_class_jnp(v, 4.0)),
        "pow2_ceiling_jnp": (ref_adaptive.pow2_ceiling_jnp,
                             port_alg.pow2_ceiling_jnp),
    }
    ref_fn, port_fn = twins[name]
    if name.startswith("duration_class_beta4"):
        x = x[np.isfinite(x) & (x > 0)]
    _same(ref_fn, port_fn, x)


@pytest.mark.parametrize("shape", [(168,), (7, 24)])
def test_hybrid_threshold_equals_reference(shape):
    """Over every index the replay can form: i = jexp - z + 1 with jexp
    <= 128 (an f32 frexp exponent) and z >= -39 (frexp of the 1e-12
    floor), so 1 <= i <= 168.  (Past that range XLA's CPU code rounds
    1/(2 sqrt(i)) differently from IEEE float32 at some i, from i = 267.)"""
    _same(ref_duration.hybrid_threshold_jnp, port_alg.hybrid_threshold_jnp,
          np.arange(1, 169, dtype=np.int32).reshape(shape))


@pytest.mark.parametrize("rho", [21600.0, 2048.0, 3600.0])
def test_departure_window_equals_reference(rho):
    k = np.arange(0, 2000, dtype=np.float64)
    x = np.concatenate([_ulps((k * rho).astype(np.float32)),
                        np.random.default_rng(1).uniform(0, 2e7, 20000)
                        .astype(np.float32)])
    _same(lambda v: ref_departure.departure_window_jnp(v, rho),
          lambda v: port_alg.departure_window_jnp(v, rho), x)


def test_prediction_error_equals_reference():
    rng = np.random.default_rng(2)
    r = np.concatenate([rng.lognormal(6, 3, 5000), [0.0, 1.0, 5.0, 0.0]])
    p = np.concatenate([r[:5000] * rng.lognormal(0, 1, 5000),
                        [0.0, 0.0, 5.0, 3.0]])
    _same(ref_adaptive.prediction_error_jnp, port_alg.prediction_error_jnp,
          r.astype(np.float32), p.astype(np.float32))


def test_float_to_int32_saturates_as_reference():
    x = np.array([5e17, -5e17, 3e9, np.nan, 2.1e9, -2.2e9, 2147483520.0,
                  -2147483648.0, -0.5, 0.5, 1e30, -np.inf, np.inf],
                 np.float32)
    _same(lambda v: v.astype(jnp.int32), port_alg.to_i32, x)


def test_rcp_rsqrt_table_equals_xla_rsqrt():
    """The table of the RCP/PPE threshold against XLA's rsqrt, and the
    reference's own threshold expression (coef / sqrt(x) under jit) at a
    power-of-two coef, for x = 1..64."""
    x = np.arange(1, 65, dtype=np.float32)
    ref = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(x)))
    np.testing.assert_array_equal(fk.RCP_RSQRT.numpy().view(np.uint32),
                                  ref.view(np.uint32))
    for coef in (1.0, 4.0):
        thr = np.asarray(jax.jit(lambda c, v: c / jnp.sqrt(v))(
            jnp.full(64, coef, jnp.float32), jnp.asarray(x)))
        np.testing.assert_array_equal((coef * fk.RCP_RSQRT).numpy(), thr)


def test_dense_key_ids_equal_reference():
    rng = np.random.default_rng(3)
    L, n = 3, 300
    i = rng.integers(1, 6, (L, n)).astype(np.int32)
    cls = rng.integers(0, 3, (L, n)).astype(np.int32)
    win = rng.integers(0, 4, (L, n)).astype(np.int32)
    win[0, ::7] = 2 ** 31 - 1        # saturated windows group together
    ref = np.asarray(jax.vmap(jaxsim._dense_key_ids)(
        jnp.asarray(i), jnp.asarray(cls), jnp.asarray(win)))
    got = torchsim._dense_key_ids(*(torch.from_numpy(a) for a in
                                    (i, cls, win)))
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------- the fixture

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
    insts = [quantized_instance(1, 40, 2), quantized_instance(2, 60, 4),
             quantized_instance(3, 30, 3)]
    batch = pack_instances(insts)
    preds = []
    for i in insts:
        rng = np.random.default_rng(100)
        noisy = i.durations * rng.choice([0.25, 0.5, 1.0, 2.0, 4.0],
                                         i.n_items)
        preds.append(np.stack([i.durations, np.zeros(i.n_items), noisy]))
    pdeps = pad_predictions(batch, preds)
    lanes = tuple(np.asarray(a) for a in _flatten_lanes(
        batch.sizes, batch.times, batch.kinds, batch.items, pdeps,
        batch.dmask, batch.arrivals, batch.pdeps, batch.n_items))
    return insts, batch, pdeps, lanes


_REF = {}


def reference(policy, lanes):
    """jaxsim's jnp replay of the fixture with its final carry (cached:
    the per-event and the blocked tests compare with the same run)."""
    if policy not in _REF:
        _REF[policy] = jaxsim._replay_batch(
            *lanes, policy=policy, max_bins=MAX_BINS, backend="jnp",
            return_carry=True)
    return _REF[policy]


def assert_outputs(ref, got):
    for r, g in zip(ref[:4], got[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_category_setup_equals_reference(mixed):
    """Per-item constants and RCP's distinct-category count of every
    family (the pdep == arrival rows drive the hybrids' window index past
    int32, where the reference's cast saturates)."""
    *_, lanes = mixed
    sizes, times, kinds, items, pdeps, dmask, arr, rdeps, n = lanes
    port_in = torchsim._cpu_inputs(*lanes)
    for policy in ("cbd", "cbd_beta4", "cbdt", "hybrid", "reduced_hybrid",
                   "hybrid_direct_sum", "rcp", "ppe_modified", "la_binary",
                   "la_geometric", "adaptive"):
        spec = jaxsim.policy_spec(policy)
        ref, _, ref_x = jaxsim._category_setup(
            spec, *(jnp.asarray(a) for a in (sizes, pdeps)), dmask,
            *(jnp.asarray(a) for a in (arr, rdeps, n, times, kinds, items)),
            MAX_BINS)
        p = port_in
        got, got_x = torchsim._category_setup(
            torchsim.policy_spec(policy), p[0], p[4], p[6], p[7], p[8],
            p[2], p[3])
        assert set(got) == set(ref), policy
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(ref[k]), err_msg=k)
        assert len(got_x) == len(ref_x)
        for a, b in zip(got_x, ref_x):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("policy", jaxsim.SCAN_POLICIES)
def test_per_event_replay_equals_reference(policy, mixed):
    """All 21 policies x {clairvoyant, pdep == arrival, pow2 noise}: the
    port's per-event replay on the CPU (the select's plain version, the
    category mask as ``cmask``) against the jnp reference, outputs and
    final category state."""
    *_, lanes = mixed
    ref = reference(policy, lanes)
    got = torchsim._replay_batch(*lanes, policy=policy, max_bins=MAX_BINS,
                                 device="cpu", return_carry=True)
    assert_outputs(ref, got)
    core, cat = ref[4]
    back = torchsim.carry_to_reference(got[4], lanes[0].shape[2])
    got_core, got_cat = back if cat else (back, {})
    for a, b in zip(core, got_core):
        np.testing.assert_array_equal(b, np.asarray(a))
    assert set(got_cat) == set(cat)
    for k in cat:
        np.testing.assert_array_equal(got_cat[k], np.asarray(cat[k]),
                                      err_msg=k)
        assert got_cat[k].dtype == np.asarray(cat[k]).dtype, k


@pytest.mark.parametrize("policy", jaxsim.SCAN_POLICIES)
def test_blocked_replay_equals_reference(policy, mixed):
    """The event-blocked path (``block_events=16``: 120 events per lane,
    so a padded tail block) through the megakernel's plain version: the
    same outputs as the per-event jnp reference, and its packed carry
    holds the same final state as the port's per-event carry."""
    *_, lanes = mixed
    ref = reference(policy, lanes)
    got = torchsim._replay_batch(*lanes, policy=policy, max_bins=MAX_BINS,
                                 device="cpu", block_events=16,
                                 return_carry=True)
    assert_outputs(ref, got)
    fam = torchsim._KERNEL_FAMILY[torchsim.policy_spec(policy).family]
    state = fk.unpack_carry(got[4], fam)
    per_event = torchsim._replay_batch(*lanes, policy=policy,
                                       max_bins=MAX_BINS, device="cpu",
                                       return_carry=True)[4]
    flat = dict(zip(fk.CORE_NAMES, per_event[:12]))
    if len(per_event) > 12:
        flat.update(per_event[12])
    assert set(state) == set(flat)
    # a virgin slot's access_seq is -1 in the per-event carry and 0 in the
    # packed one (as in the reference's two layouts); no policy reads it
    opened = flat["access_seq"] >= 0
    state["access_seq"] = torch.where(opened, state["access_seq"], -1)
    for k in flat:
        assert torch.equal(state[k], flat[k]), k


def test_argmax_ties_take_the_first_dimension():
    """hybrid_direct_sum classes an item by its largest dimension; ties go
    to the first, as jnp.argmax does."""
    sizes = np.array([[[0.25, 0.25, 0.125], [0.125, 0.5, 0.5],
                       [0.375, 0.375, 0.375]]], np.float32)
    pdeps = np.array([[10.0, 20.0, 30.0]], np.float32)
    arr = np.zeros((1, 3), np.float32)
    spec = jaxsim.policy_spec("hybrid_direct_sum")
    ref, _, _ = jaxsim._category_setup(
        spec, jnp.asarray(sizes), jnp.asarray(pdeps), None, jnp.asarray(arr),
        jnp.asarray(pdeps), jnp.asarray([3]), jnp.zeros((1, 6)),
        jnp.zeros((1, 6), jnp.int32), jnp.zeros((1, 6), jnp.int32), 4)
    got, _ = torchsim._category_setup(
        torchsim.policy_spec("hybrid_direct_sum"), torch.from_numpy(sizes),
        torch.from_numpy(pdeps), torch.from_numpy(arr),
        torch.from_numpy(pdeps), torch.tensor([3]),
        torch.zeros((1, 6), dtype=torch.int32),
        torch.zeros((1, 6), dtype=torch.int64))
    np.testing.assert_array_equal(got["cls"].numpy(), np.asarray(ref["cls"]))
    assert got["cls"].tolist() == [[0, 1, 0]]


def _halves(lanes):
    sizes, times, kinds, items, pdeps, dmask, arr, rdeps, n = lanes
    h = times.shape[1] // 2
    return ((sizes, times[:, :h], kinds[:, :h], items[:, :h], pdeps, dmask,
             arr, rdeps, n),
            (sizes, times[:, h:], kinds[:, h:], items[:, h:], pdeps, dmask,
             arr, rdeps, n))


@pytest.mark.parametrize("policy", ["cbd", "hybrid", "ppe", "adaptive"])
def test_category_carry_from_reference_resumes(policy, mixed):
    """First half in JAX, second half in the port (per event and blocked):
    the full JAX replay.  RCP's distinct-category count spans the halves
    through ``replay_event_extras``."""
    *_, lanes = mixed
    first, second = _halves(lanes)
    h = lanes[1].shape[1] // 2
    full = reference(policy, lanes)
    x_full = torchsim.replay_event_extras(policy, lanes[0], lanes[4],
                                          lanes[5], lanes[6], lanes[7],
                                          lanes[8], *lanes[1:4])
    x_ref = jaxsim.replay_event_extras(policy, lanes[0], lanes[4], lanes[5],
                                       lanes[6], lanes[7], lanes[8],
                                       *lanes[1:4])
    assert len(x_full) == len(x_ref)
    *_, (core, cat) = jaxsim._replay_batch(
        *first, policy=policy, max_bins=MAX_BINS, backend="jnp",
        return_carry=True,
        ev_extra=tuple(np.asarray(x)[:, :h] for x in x_ref) or None)
    carry = torchsim.carry_from_reference(core, device="cpu", cat=cat)
    assert len(carry) == 13
    got = torchsim._replay_batch(
        *second, policy=policy, max_bins=MAX_BINS, device="cpu",
        carry0=carry, ev_extra=tuple(x[:, h:] for x in x_full) or None)
    assert_outputs(full, got)
    back_core, back_cat = torchsim.carry_to_reference(carry,
                                                      lanes[0].shape[2])
    for k in cat:
        np.testing.assert_array_equal(back_cat[k], np.asarray(cat[k]))


@pytest.mark.parametrize("policy", ["cbdt", "reduced_hybrid_direct_sum",
                                    "rcp"])
def test_category_carry_to_reference_resumes(policy, mixed):
    """First half in the port, second half in JAX: the full port replay."""
    *_, lanes = mixed
    first, second = _halves(lanes)
    h = lanes[1].shape[1] // 2
    x_full = torchsim.replay_event_extras(policy, lanes[0], lanes[4],
                                          lanes[5], lanes[6], lanes[7],
                                          lanes[8], *lanes[1:4])
    full = torchsim._replay_batch(*lanes, policy=policy, max_bins=MAX_BINS,
                                  device="cpu")
    *_, carry = torchsim._replay_batch(
        *first, policy=policy, max_bins=MAX_BINS, device="cpu",
        return_carry=True,
        ev_extra=tuple(x[:, :h] for x in x_full) or None)
    got = jaxsim._replay_batch(
        *second, policy=policy, max_bins=MAX_BINS, backend="jnp",
        carry0=torchsim.carry_to_reference(carry, lanes[0].shape[2]),
        ev_extra=tuple(x[:, h:].numpy() for x in x_full) or None)
    for r, g in zip(full, got):
        np.testing.assert_array_equal(np.asarray(g), r.numpy())


@pytest.mark.parametrize("policy", ["cbd", "ppe_modified", "la_geometric"])
def test_simulate_category_placements_identical(policy, mixed):
    insts, *_ = mixed
    inst = insts[2]
    pdur = inst.durations * np.random.default_rng(4).choice(
        [0.5, 1.0, 2.0], inst.n_items)
    a = jaxsim.simulate(inst, policy, pdur, max_bins=16, backend="jnp")
    for T in (0, 16):
        b = torchsim.simulate(port_instance(inst), policy, pdur, max_bins=16,
                              device="cpu", block_events=T)
        np.testing.assert_array_equal(b.placements, a.placements)
        assert (b.usage_time, b.n_bins_opened, b.max_bins) == \
            (a.usage_time, a.n_bins_opened, a.max_bins)
