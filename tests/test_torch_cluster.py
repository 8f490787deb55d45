"""The port's cluster scheduler (``repro_torch.cluster.placement``)
against the JAX package's, on ``tests/test_cluster.py``'s scenarios: the
seeded job streams with and without host failures (their restarts and
lost work), for policies of every family that the cluster's minimal
instance facade binds, and the gang release."""
import copy

import numpy as np
import pytest

from repro.cluster import placement as ref
from repro_torch.cluster import placement as port

POLICIES = ("first_fit", "mru", "best_fit", "greedy", "nrt_prioritized",
            "nrt_standard", "cbd", "rcp", "rcp_modified",
            "lifetime_alignment")


def _jobs(job_cls, n=40, seed=0):
    """tests/test_cluster.py's job stream, as ``job_cls`` objects."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        demand = np.array([rng.choice([0.25, 0.5, 1.0]),
                           rng.uniform(0.1, 0.8), rng.uniform(0.05, 0.5),
                           rng.uniform(0.05, 0.3)])
        runtime = float(rng.integers(600, 7200))
        out.append(job_cls(j, float(rng.integers(0, 36000)), runtime,
                           np.minimum(demand, 1.0), predicted_runtime=runtime,
                           checkpoint_period=300.0))
    return out


@pytest.mark.parametrize("mtbf,seed", [(None, 0), (4000.0, 1), (1500.0, 7)])
@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_cluster_equals_the_reference(policy, mtbf, seed):
    """Host-seconds, hosts opened and peak, failures recovered and lost
    work equal the reference's (each run gets its own jobs: a failure
    shortens a job's remaining runtime)."""
    want = ref.simulate_cluster(_jobs(ref.Job), policy, mtbf=mtbf, seed=seed)
    got = port.simulate_cluster(_jobs(port.Job), policy, mtbf=mtbf,
                                seed=seed)
    assert got == want
    if mtbf is not None and policy == "first_fit":
        assert got["failures_recovered"] > 0
        assert got["lost_work"] <= got["failures_recovered"] * 300.0 + 1e-6


@pytest.mark.parametrize("policy", ["first_fit", "greedy"])
def test_scheduler_places_as_the_reference(policy):
    """Job by job: the host each job lands on and the stats, with every
    job released at its finish."""
    jobs = _jobs(port.Job, n=30, seed=4)
    ref_jobs = [ref.Job(**{k: copy.copy(v) for k, v in vars(j).items()})
                for j in jobs]
    a, b = port.ClusterScheduler(policy), ref.ClusterScheduler(policy)
    for sched, js in ((a, jobs), (b, ref_jobs)):
        events = sorted([(j.submit, 1, j.jid) for j in js] +
                        [(j.submit + j.runtime, 0, j.jid) for j in js])
        by_id = {j.jid: j for j in js}
        hosts = []
        for t, kind, jid in events:
            if kind:
                hosts.append(sched.place(by_id[jid], t))
            else:
                sched.release(jid, t)
        sched.hosts = hosts
    assert a.hosts == b.hosts
    assert vars(a.stats) == vars(b.stats)
    assert not a.pool._open_list


def test_scheduler_gang_release():
    s = port.ClusterScheduler("first_fit")
    s.place(port.Job(0, 0.0, 100.0, np.array([1.0, 0.5, 0.5, 0.5])), 0.0)
    assert s.stats.hosts_opened == 1 and s.host_of(0) == 0
    s.release(0, 100.0)
    assert s.stats.host_seconds == 100.0
    assert not s.pool._open_list
