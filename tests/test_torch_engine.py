"""The port's exact oracle engine (``repro_torch.core.run``) and
``torchsim.host_algorithm`` against the JAX package's, and the port's own
replay against the port's own oracle.

* ``core.run`` with ``torchsim.host_algorithm(policy)`` equals
  ``repro.core.run`` with ``jaxsim.host_algorithm(policy)``: float64 usage,
  opened and peak bins, span and every placement, for all 21 scan policies
  plus ``next_fit`` and ``rr_next_fit``, on fp32-exact instances
  (clairvoyant and power-of-two noise) and on an Azure-like instance with
  log-normal predictions.
* The port's replay on the CPU (``sweep.run_batch``) equals the port's
  oracle: the fp32 usage bit for bit (the instances are fp32-exact) and
  the opened bins, for all 21 policies on mixed-size, mixed-dimension
  lanes (``tests/test_sweep_categories.py``'s fixture); ``simulate``
  places every item as the oracle does up to the renaming of bins into
  reused slots."""
import numpy as np
import pytest

import repro.core as ref_core
from repro.core import jaxsim
from repro.data import make_azure_like_suite as ref_azure
import repro_torch.core as port_core
from repro_torch.core import torchsim
from repro_torch.data import make_azure_like_suite
from repro_torch.sweep import pack_instances, pad_predictions, run_batch

POLICIES = torchsim.SCAN_POLICIES + ("next_fit", "rr_next_fit")


def _host(name, pkg):
    """The oracle algorithm of a scan policy, or a registry name."""
    mod = torchsim if pkg == "port" else jaxsim
    if name in ("next_fit", "rr_next_fit"):
        return (port_core if pkg == "port" else ref_core).get_algorithm(name)
    return mod.host_algorithm(name)


def quantized_instance(seed, n, d, core=port_core):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 24, (n, d)) / 64.0
    arr = np.sort(rng.integers(0, 50000, n)).astype(float)
    dur = rng.integers(10, 5000, n).astype(float)
    return core.Instance(sizes, arr, arr + dur,
                         f"q{seed}").sorted_by_arrival()


def pow2_noise(inst, seed):
    rng = np.random.default_rng(seed)
    return inst.durations * rng.choice([0.25, 0.5, 1.0, 2.0, 4.0],
                                       inst.n_items)


@pytest.fixture(scope="module")
def cases():
    """(reference instance, port instance, predictions) triples."""
    out = []
    for seed, n, d in ((11, 150, 3), (12, 120, 5)):
        ri = quantized_instance(seed, n, d, ref_core)
        pi = quantized_instance(seed, n, d)
        out += [(ri, pi, None), (ri, pi, pow2_noise(pi, 100))]
    ri = ref_azure(n_instances=1, n_items=300, seed=9)[0]
    pi = make_azure_like_suite(n_instances=1, n_items=300, seed=9)[0]
    out.append((ri, pi, port_core.lognormal_predictions(pi, 1.0, seed=4)))
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_run_equals_the_reference(policy, cases):
    assert _host(policy, "port").name == _host(policy, "ref").name
    for ri, pi, pred in cases:
        r = ref_core.run(ri, _host(policy, "ref"), predicted_durations=pred)
        p = port_core.run(pi, _host(policy, "port"), predicted_durations=pred)
        assert np.array_equal(p.placements, r.placements), policy
        assert (p.usage_time, p.n_bins_opened, p.peak_open_bins, p.span) == \
            (r.usage_time, r.n_bins_opened, r.peak_open_bins, r.span), policy
        assert p.ratio(port_core.lower_bound(pi)) == \
            r.ratio(ref_core.lower_bound(ri))


def test_span_and_types_equal_the_reference(cases):
    _, pi, _ = cases[0]
    ri = cases[0][0]
    assert port_core.span(pi) == ref_core.span(ri)
    arr = port_core.MigrantArrival(3, pi.sizes[3], 900.0, 1500.0,
                                   orig_now=700.0)
    assert arr.pdur == 800.0 and arr.now == 900.0
    assert port_core.Arrival(3, pi.sizes[3], 900.0, None).pdur is None


@pytest.fixture(scope="module")
def mixed():
    """tests/test_sweep_categories.py's lanes: mixed item counts and
    dimensions, clairvoyant and power-of-two noise rows."""
    insts = [quantized_instance(1, 50, 2), quantized_instance(2, 80, 4),
             quantized_instance(3, 30, 3)]
    batch = pack_instances(insts)
    preds = [np.stack([i.durations, pow2_noise(i, 100)]) for i in insts]
    return insts, batch, pad_predictions(batch, preds), preds


@pytest.mark.parametrize("policy", torchsim.SCAN_POLICIES)
def test_cpu_replay_equals_the_port_oracle(policy, mixed):
    insts, batch, pdeps, preds = mixed
    res = run_batch(batch, policy, pdeps, max_bins=32, device="cpu")
    assert not res.overflowed.any()
    for i, inst in enumerate(insts):
        for si in range(2):
            r = port_core.run(inst, torchsim.host_algorithm(policy),
                              predicted_durations=preds[i][si])
            assert res.usage_time[i, si] == r.usage_time, (policy, i, si)
            assert res.n_bins_opened[i, si] == r.n_bins_opened


@pytest.mark.parametrize("policy", ["best_fit_l1", "cbdt", "hybrid_direct_sum",
                                    "ppe", "la_geometric", "adaptive"])
def test_simulate_places_as_the_oracle(policy, mixed):
    """Slot placements map one to one onto the oracle's absolute bins
    while those are open: two items share a slot exactly when they share a
    bin."""
    inst = mixed[0][1]
    sim = torchsim.simulate(inst, policy, max_bins=8, device="cpu")
    r = port_core.run(inst, torchsim.host_algorithm(policy))
    assert sim.usage_time == r.usage_time
    assert sim.n_bins_opened == r.n_bins_opened
    _, kinds, items = torchsim.event_sequence(inst)
    slot_of, bin_of, count = {}, {}, {}
    for kind, item in zip(kinds, items):
        b, s = int(r.placements[item]), int(sim.placements[item])
        if kind == torchsim.ARRIVAL_KIND:
            assert slot_of.setdefault(b, s) == s, (policy, item)
            assert bin_of.setdefault(s, b) == b, (policy, item)
            count[b] = count.get(b, 0) + 1
        else:
            count[b] -= 1
            if not count[b]:
                del slot_of[b], bin_of[s]
