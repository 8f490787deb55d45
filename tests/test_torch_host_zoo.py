"""The port's host algorithm zoo (``repro_torch.core.algorithms``) against
the JAX package's classes, decision for decision.

Every registry class runs in the port's oracle engine and the reference's
on the same seeded numpy inputs: the hand-checkable scenarios of
``tests/test_core_engine.py``, the adaptive switch's and PPE's scenarios
of ``tests/test_adaptive.py`` (the error staircase, the estimator shared
with PPE's alpha), and Azure-like instances under the prediction models
of ``tests/test_predictions.py``.  Placements are absolute bin indices in
both engines, so equal placements are equal decisions; usage, opened and
peak bins, span, and the policies' learned state must be equal too.  The
float64 classifiers are held to the reference's on class edges."""
import numpy as np
import pytest

import repro.core as ref_core
import repro.core.algorithms as ref_algs
import repro.core.algorithms.adaptive as ref_adaptive
import repro.core.algorithms.duration as ref_duration
import repro.core.algorithms.learned as ref_learned
import repro.data as ref_data
import repro_torch.core as port_core
import repro_torch.core.algorithms as port_algs
import repro_torch.core.algorithms.adaptive as port_adaptive
import repro_torch.core.algorithms.duration as port_duration
import repro_torch.core.algorithms.learned as port_learned
from repro_torch.data import make_azure_like_suite

# every registry name, with the parameters its variants take
CONFIGS = [
    ("first_fit", {}), ("mru", {}), ("next_fit", {}), ("rr_next_fit", {}),
    ("best_fit", {"norm": "l1"}), ("best_fit", {"norm": "l2"}),
    ("best_fit", {"norm": "linf"}), ("cbdt", {"rho": 21600.0}),
    ("cbdt", {"rho": 3600.0}),
    ("nrt_standard", {}), ("nrt_prioritized", {}), ("greedy", {}),
    ("cbd", {}), ("cbd", {"beta": 4.0}), ("hybrid", {}),
    ("reduced_hybrid", {}), ("hybrid_direct_sum", {}),
    ("reduced_hybrid_direct_sum", {}), ("rcp", {}), ("ppe", {}),
    ("rcp_modified", {}), ("ppe_modified", {}),
    ("lifetime_alignment", {"mode": "binary"}),
    ("lifetime_alignment", {"mode": "geometric"}), ("adaptive", {}),
    ("adaptive", {"low": 1.5, "high": 8.0})]
CONFIG_IDS = [n + "".join(f"-{v}" for v in kw.values()) for n, kw in CONFIGS]


def test_registry_and_groups_equal_the_reference():
    assert sorted(port_algs.REGISTRY) == sorted(ref_algs.REGISTRY)
    for name in ("ALL_ALGORITHMS", "NON_CLAIRVOYANT", "CLAIRVOYANT",
                 "LEARNING_AUGMENTED", "ANY_FIT"):
        assert getattr(port_algs, name) == getattr(ref_algs, name), name
    assert set(n for n, _ in CONFIGS) == set(ref_algs.REGISTRY)
    assert port_learned.LA_BINARY_SPLIT == ref_learned.LA_BINARY_SPLIT
    assert port_algs.LA_BINARY_SPLIT == ref_learned.LA_BINARY_SPLIT


def _pair(cls_inst, name, kw, pred=None, clairvoyant=None):
    """The same run in both engines: (port result, port algorithm,
    reference result, reference algorithm)."""
    ra = ref_algs.get_algorithm(name, **kw)
    pa = port_algs.get_algorithm(name, **kw)
    ref_inst, port_inst = cls_inst
    r = ref_core.run(ref_inst, ra, predicted_durations=pred,
                     clairvoyant=clairvoyant)
    p = port_core.run(port_inst, pa, predicted_durations=pred,
                      clairvoyant=clairvoyant)
    return p, pa, r, ra


def _same(p, r):
    assert np.array_equal(p.placements, r.placements)
    assert (p.usage_time, p.n_bins_opened, p.peak_open_bins, p.span,
            p.algorithm, p.instance) == \
        (r.usage_time, r.n_bins_opened, r.peak_open_bins, r.span,
         r.algorithm, r.instance)


def _both(sizes, arr, dep, name):
    return (ref_core.Instance(sizes, arr, dep, name).sorted_by_arrival(),
            port_core.Instance(sizes, arr, dep, name).sorted_by_arrival())


def _hand(items, name="t"):
    sizes = np.array([i[0] for i in items], float)
    if sizes.ndim == 1:
        sizes = sizes[:, None]
    return _both(sizes, np.array([i[1] for i in items], float),
                 np.array([i[2] for i in items], float), name)


# tests/test_core_engine.py's scenarios, each with the policies it pins
HAND = {
    "single": ([(0.5, 0.0, 10.0)], ("first_fit",)),
    "ff_earliest": ([(0.5, 0.0, 100.0), (0.9, 1.0, 100.0),
                     (0.4, 2.0, 100.0)], ("first_fit", "next_fit",
                                          "rr_next_fit", "mru")),
    "bf_tightest": ([(0.5, 0.0, 100.0), (0.7, 1.0, 100.0),
                     (0.2, 2.0, 100.0)], ("best_fit",)),
    "nf_abandons": ([(0.5, 0.0, 100.0), (0.8, 1.0, 100.0),
                     (0.1, 2.0, 100.0)], ("next_fit", "rr_next_fit")),
    "greedy_close": ([(0.3, 0.0, 50.0), (0.3, 1.0, 200.0),
                      (0.3, 2.0, 60.0)], ("greedy", "nrt_standard")),
    "nrt_case_a": ([(0.3, 0.0, 50.0), (0.3, 1.0, 200.0),
                    (0.3, 2.0, 40.0)], ("nrt_prioritized", "nrt_standard")),
    "nrt_case_b": ([(0.3, 0.0, 50.0), (0.3, 1.0, 45.0),
                    (0.3, 2.0, 100.0)], ("nrt_prioritized", "greedy")),
    "cbdt_windows": ([(0.1, 0.0, 10.0), (0.1, 0.0, 1000.0)],
                     ("cbdt", "cbd", "reduced_hybrid")),
    "multidim": ([([0.5, 0.9], 0.0, 10.0), ([0.5, 0.9], 1.0, 10.0)],
                 ("first_fit", "hybrid_direct_sum")),
    "exact_fit": ([(0.5, 0.0, 10.0), (0.5, 1.0, 10.0)],
                  ("first_fit", "rcp", "lifetime_alignment")),
    "episodes": ([(0.9, 0.0, 10.0), (0.9, 20.0, 30.0)],
                 ("first_fit", "ppe_modified", "adaptive")),
}


@pytest.mark.parametrize("case", sorted(HAND))
def test_hand_scenarios_equal_the_reference(case):
    items, names = HAND[case]
    insts = _hand(items, case)
    for name in names:
        for kw in ([{}] if name != "cbdt" else [{"rho": 100.0},
                                               {"rho": 10000.0}]):
            p, _, r, _ = _pair(insts, name, kw)
            _same(p, r)


@pytest.fixture(scope="module")
def azure():
    """Two Azure-like instances (the reference's generator, the port's
    copy; equal arrays) and their prediction rows: log-normal sigma 1.0 and
    uniform eps 4 (``tests/test_predictions.py``'s models)."""
    ref_suite = ref_data.make_azure_like_suite(n_instances=2, n_items=400,
                                               seed=5)
    port_suite = make_azure_like_suite(n_instances=2, n_items=400, seed=5)
    out = []
    for ri, pi in zip(ref_suite, port_suite):
        assert np.array_equal(ri.sizes, pi.sizes)
        preds = (None, port_core.lognormal_predictions(pi, 1.0, seed=3),
                 port_core.uniform_predictions(pi, 4.0, seed=3))
        assert np.array_equal(
            preds[1], ref_core.lognormal_predictions(ri, 1.0, seed=3))
        out.append(((ri, pi), preds))
    return out


@pytest.mark.parametrize("name,kw", CONFIGS, ids=CONFIG_IDS)
def test_every_class_on_azure_like_instances(name, kw, azure):
    """Clairvoyant, log-normal and uniform predictions: every decision,
    the result and the policy's learned state equal the reference's."""
    for insts, preds in azure:
        for pred in preds:
            p, pa, r, ra = _pair(insts, name, kw, pred)
            _same(p, r)
            if name in ("rcp", "ppe", "rcp_modified", "ppe_modified"):
                assert pa._estimator.err == ra._estimator.err
                assert pa._seen_cats == ra._seen_cats
                assert pa._on == ra._on
                assert pa._threshold() == ra._threshold()
            if name == "adaptive":
                assert (pa.estimator.err, pa.regime_switches, pa._last) == \
                    (ra.estimator.err, ra.regime_switches, ra._last)
            if name in ("hybrid", "reduced_hybrid", "hybrid_direct_sum",
                        "reduced_hybrid_direct_sum"):
                assert pa._tag_ids == ra._tag_ids


def test_non_clairvoyant_run_hides_predictions(azure):
    """``clairvoyant=False`` hides pdep from every policy that does not
    need it, in both engines alike."""
    insts, _ = azure[0]
    for name in ("first_fit", "best_fit", "mru"):
        p, _, r, _ = _pair(insts, name, {}, clairvoyant=False)
        _same(p, r)


def test_adaptive_staircase_pinned():
    """tests/test_adaptive.py's error staircase: two regime switches, the
    same arrivals, in both packages."""
    sizes = np.full((6, 1), 0.375)
    arrivals = np.array([0.0, 10.0, 250.0, 260.0, 500.0, 510.0])
    insts = (ref_core.Instance(sizes, arrivals, arrivals + 100.0, "stair"),
             port_core.Instance(sizes, arrivals, arrivals + 100.0, "stair"))
    pd = np.array([100.0, 50.0, 100.0, 5.0, 100.0, 100.0])
    p, pa, r, ra = _pair(insts, "adaptive", {}, pd)
    _same(p, r)
    assert (pa.regime_switches, pa._last, pa.estimator.err) == (2, 2, 20.0)
    assert p.n_bins_opened == 3


def test_estimator_is_shared_with_ppe_alpha():
    """PPE's alpha is pow2_ceiling of the shared running-max estimator, as
    in the reference (``tests/test_adaptive.py``)."""
    rng = np.random.default_rng(5)
    n = 80
    sizes = rng.integers(1, 24, (n, 2)) / 64.0
    arr = np.sort(rng.integers(0, 20000, n)).astype(float)
    dur = rng.integers(10, 5000, n).astype(float)
    insts = _both(sizes, arr, arr + dur, "ppe")
    pd = dur * rng.choice([0.25, 0.5, 1.0, 2.0, 8.0], n)
    p, pa, r, ra = _pair(insts, "ppe", {}, pd)
    _same(p, r)
    assert isinstance(pa._estimator, port_adaptive.DepartureErrorEstimator)
    expect = max(1.0, float(port_adaptive.prediction_error(dur, pd).max()))
    assert pa._estimator.err == expect == ra._estimator.err
    x = max(len(pa._seen_cats), 1)
    assert pa._threshold() == port_adaptive.pow2_ceiling(expect) / np.sqrt(x)
    est = port_adaptive.DepartureErrorEstimator()
    for rd, pdur in ((100.0, 50.0), (100.0, 100.0), (10.0, 90.0)):
        est.observe(rd, pdur)
    assert (est.err, est.pow2_alpha()) == (9.0, 16.0)


# durations on and around the class edges of every classifier
EDGES = np.array([1e-13, 0.5, 0.999999, 1.0, 1.000001, 2.0, 3.0, 4.0,
                  7199.999, 7200.0, 7200.5, 2.0 ** 20, 2.0 ** 20 + 1,
                  3.0 ** 7, 3.0 ** 7 * (1 + 1e-15), 86400.0 * 3])


@pytest.mark.parametrize("fn", ["dur_exponent", "duration_class",
                                "hybrid_threshold", "geo_class", "la_class",
                                "prediction_error", "pow2_ceiling"])
def test_float64_classifiers_equal_the_reference(fn):
    mods = {"dur_exponent": (port_duration, ref_duration),
            "duration_class": (port_duration, ref_duration),
            "hybrid_threshold": (port_duration, ref_duration),
            "geo_class": (port_learned, ref_learned),
            "la_class": (port_learned, ref_learned),
            "prediction_error": (port_adaptive, ref_adaptive),
            "pow2_ceiling": (port_adaptive, ref_adaptive)}[fn]
    port, ref = (getattr(m, fn) for m in mods)
    if fn == "duration_class":
        for beta in (2.0, 3.0, 10.0):
            assert np.array_equal(port(EDGES, beta), ref(EDGES, beta))
    elif fn == "la_class":
        for mode in ("binary", "geometric"):
            assert np.array_equal(port(EDGES, mode), ref(EDGES, mode))
    elif fn == "hybrid_threshold":
        i = np.arange(1, 40)
        assert np.array_equal(port(i), ref(i))
    elif fn == "prediction_error":
        assert np.array_equal(port(EDGES, EDGES[::-1]),
                              ref(EDGES, EDGES[::-1]))
    elif fn == "pow2_ceiling":
        assert [port(float(x)) for x in EDGES + 1] == \
            [ref(float(x)) for x in EDGES + 1]
    else:
        assert np.array_equal(port(EDGES), ref(EDGES))


def _drive(sched, request_cls, n=150, seed=5):
    """tests/test_serving.py's arrival process: integer clock, fp32-exact
    sizes; returns every decision and the stats."""
    rng = np.random.default_rng(seed)
    live, t, picks = [], 0.0, []
    for rid in range(n):
        t += float(rng.integers(1, 8))
        while live and live[0][0] <= t:
            ft, r = live.pop(0)
            sched.finish(r, ft)
        req = request_cls(rid, t, int(rng.integers(16, 512)),
                          int(rng.integers(8, 1024)),
                          predicted_decode_len=int(rng.integers(8, 1024)))
        picks.append(sched.place(req, t))
        live.append((t + req.decode_len / 50.0, rid))
        live.sort()
    while live:
        ft, r = live.pop(0)
        sched.finish(r, ft)
    s = sched.stats
    return picks, (s.replica_seconds, s.replicas_opened, s.peak_replicas)


@pytest.mark.parametrize(
    "name,kw", [c for c in CONFIGS if not c[0].startswith("ppe")],
    ids=[i for i in CONFIG_IDS if not i.startswith("ppe")])
def test_scheduler_host_zoo_equals_the_reference(name, kw):
    """Every registry policy in the serving scheduler, host side, and the
    device select (its plain version on the CPU) where the policy has one,
    CBD included: each decision equals the reference scheduler's."""
    from repro.serving.scheduler import DVBPScheduler as RefScheduler
    from repro.serving.scheduler import ReplicaCapacity as RefCaps
    from repro.serving.scheduler import Request as RefRequest
    from repro_torch.serving.scheduler import (_DEVICE_CATEGORY_POLICIES,
                                               _DEVICE_POLICIES,
                                               DVBPScheduler, ReplicaCapacity,
                                               Request)
    caps = dict(slots=4, kv_tokens=65536, prefill_budget=262144)
    want = _drive(RefScheduler(name, RefCaps(**caps), kw), RefRequest)
    host = DVBPScheduler(name, ReplicaCapacity(**caps), kw)
    assert _drive(host, Request) == want
    assert host.last_select_backend == "host"
    if name in _DEVICE_POLICIES + _DEVICE_CATEGORY_POLICIES:
        dev = DVBPScheduler(name, ReplicaCapacity(**caps), kw,
                            select_backend="device", device="cpu")
        assert _drive(dev, Request) == want
        assert dev.last_select_backend == "torch"


@pytest.mark.parametrize("name", ["ppe", "ppe_modified"])
def test_scheduler_runs_ppe_on_open_ended_streams(name):
    """The reference's PPE indexes past the scheduler's empty instance at
    the first departure; the port's observes no error on request ids past
    it (as the adaptive switch does), so its alpha stays 1 and it decides
    as RCP does."""
    from repro.serving.scheduler import DVBPScheduler as RefScheduler
    from repro.serving.scheduler import Request as RefRequest
    from repro_torch.serving.scheduler import DVBPScheduler, Request
    with pytest.raises(IndexError):
        _drive(RefScheduler(name), RefRequest)
    got = _drive(DVBPScheduler(name), Request)
    assert got == _drive(RefScheduler(name.replace("ppe", "rcp")),
                         RefRequest)
