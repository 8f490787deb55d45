"""The port's sequential consolidating oracle
(``repro_torch.consolidate.run_consolidating``) against the JAX package's
(``tests/test_torch_consolidate.py`` holds ``consolidated_replay`` to it).

For all 21 scan policies plus ``next_fit`` and ``rr_next_fit``, on the
fp32-exact instances of ``tests/test_torch_consolidate.py`` (40 items,
d = 3, 1/64-grid sizes, integer times), clairvoyant and with power-of-two
noise, under an underload drain every 8 events and a periodic sweep with a
per-lane budget and a migration cost: float64 usage, opened and peak bins,
span, every placement, the emitted MIGRATE events in order and the churn
(migrations, bins closed, budget exhausted, migration cost) equal the
reference's.  A migrant keeps its original arrival clock for its class,
and a migration teaches the error estimators nothing."""
import numpy as np
import pytest

import repro.consolidate as ref_cons
import repro.core as ref_core
from repro.core import jaxsim
import repro_torch.consolidate as port_cons
import repro_torch.core as port_core
from repro_torch.core import torchsim
from repro_torch.core.algorithms.adaptive import prediction_error
from repro_torch.core.bins import BinPool

POLICIES = torchsim.SCAN_POLICIES + ("next_fit", "rr_next_fit")
SPECS = ("underload:t0.5:e8", "periodic:dt500:t0.5:b2:e4:c1.5")


def qinst(seed, core, n=40, d=3):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 24, (n, d)) / 64.0
    arr = np.sort(rng.integers(0, 50000, n)).astype(float)
    dur = rng.integers(10, 5000, n).astype(float)
    return core.Instance(sizes, arr, arr + dur,
                         f"q{seed}").sorted_by_arrival()


def _alg(policy, pkg):
    if policy in ("next_fit", "rr_next_fit"):
        return (port_core if pkg == "port" else ref_core).get_algorithm(
            policy)
    return (torchsim if pkg == "port" else jaxsim).host_algorithm(policy)


@pytest.fixture(scope="module")
def cases():
    out = []
    for seed in (1, 2):
        pi, ri = qinst(seed, port_core), qinst(seed, ref_core)
        noisy = pi.durations * np.random.default_rng(seed).choice(
            [0.25, 0.5, 1.0, 2.0, 4.0], pi.n_items)
        out += [(pi, ri, None), (pi, ri, noisy)]
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_run_consolidating_equals_the_reference(policy, cases):
    for spec in SPECS:
        for pi, ri, pred in cases:
            p, ps = port_cons.run_consolidating(
                pi, _alg(policy, "port"), port_cons.ConsolidationSpec.parse(
                    spec), predicted_durations=pred)
            r, rs = ref_cons.run_consolidating(
                ri, _alg(policy, "ref"), ref_cons.ConsolidationSpec.parse(
                    spec), predicted_durations=pred)
            assert np.array_equal(p.placements, r.placements), (policy, spec)
            assert (p.usage_time, p.n_bins_opened, p.peak_open_bins,
                    p.span, p.algorithm) == \
                (r.usage_time, r.n_bins_opened, r.peak_open_bins, r.span,
                 r.algorithm), (policy, spec)
            assert ps == rs, (policy, spec)


@pytest.mark.parametrize("spec", SPECS)
def test_scenarios_migrate(spec, cases):
    """Guard the fixture: under each spec items move for the score, CBD
    and RCP families, and the periodic spec's budget binds."""
    st = [port_cons.run_consolidating(
        pi, torchsim.host_algorithm(p), port_cons.ConsolidationSpec.parse(
            spec), predicted_durations=pred)[1]
        for p in ("first_fit", "cbd", "ppe") for pi, _, pred in cases]
    assert all(sum(s["migrations"] for s in st[k:k + 4]) > 0
               for k in (0, 4, 8))
    if ":b" in spec:
        assert sum(s["budget_exhausted"] for s in st) > 0


def test_disabled_spec_is_the_plain_engine(cases):
    pi, _, pred = cases[1]
    for policy in ("first_fit", "ppe", "hybrid"):
        a, st = port_cons.run_consolidating(
            pi, torchsim.host_algorithm(policy),
            port_cons.ConsolidationSpec(), predicted_durations=pred)
        b = port_core.run(pi, torchsim.host_algorithm(policy),
                          predicted_durations=pred)
        assert np.array_equal(a.placements, b.placements)
        assert a.usage_time == b.usage_time and st["migrations"] == 0


def test_migrants_keep_their_class_and_teach_nothing(cases):
    """CBD classes a migrant from its original arrival (``orig_now``), and
    PPE's and the adaptive switch's error estimators ignore migrations."""
    alg = torchsim.host_algorithm("cbd")
    pi = cases[0][0]
    alg.bind(BinPool(pi.d), pi)
    alg.select_bin(port_core.MigrantArrival(0, pi.sizes[0], 40000.0,
                                            41000.0, orig_now=39000.0))
    assert alg._cat == 11     # pdur 2000 s from orig_now: [1024, 2048)
    alg.select_bin(port_core.Arrival(0, pi.sizes[0], 40000.0, 41000.0))
    assert alg._cat == 10     # 1000 s from now
    for policy in ("ppe", "adaptive"):
        spec = port_cons.ConsolidationSpec.parse(SPECS[0])
        for pi, _, pred in cases:
            alg = torchsim.host_algorithm(policy)
            _, st = port_cons.run_consolidating(pi, alg, spec,
                                                predicted_durations=pred)
            est = alg._estimator if policy == "ppe" else alg.estimator
            if pred is None:
                assert est.err == 1.0
            else:
                want = float(prediction_error(pi.durations, pred).max())
                assert est.err == max(1.0, want)
