"""The port's serving path (``repro_torch.serving``, ``launch.serve``)
against the JAX package's: the replica engine's logits step by step (fp32,
within 1e-4 of max |logit|; qwen2.5-14b's and rwkv6-1.6b's reduced
configurations), and the placement side exactly - BinPool and host-zoo
decisions, the device select's decisions, the fleet simulation's numbers
and ``serve_real``'s stats, which chip_smoke.py holds on the card as
``REF_SERVE_STATS``.  On rwkv6 the reference's engine carries a slot's
recurrent state into the next request prefilled there; the port starts
each prefill afresh, and the tests show both."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as ref_reduced
from repro.launch.serve import serve_real as ref_serve_real
from repro.models import params as ref_params
from repro.serving import fleet as ref_fleet
from repro.serving.engine import ReplicaEngine as RefEngine
from repro.serving.scheduler import DVBPScheduler as RefScheduler
from repro.serving.scheduler import ReplicaCapacity as RefCaps
from repro.serving.scheduler import Request as RefRequest
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve_real
from repro_torch.models import params as P_
from repro_torch.serving import fleet
from repro_torch.serving.engine import ReplicaEngine
from repro_torch.serving.scheduler import (DVBPScheduler, ReplicaCapacity,
                                           Request)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (REF_SERVE_STATS, serving_requests)

ARCH = "qwen2.5-14b"
REL_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    ref_cfg = dataclasses.replace(ref_reduced(ARCH), dtype="float32")
    cfg = dataclasses.replace(get_reduced_config(ARCH), dtype="float32")
    tree = jax.tree.map(np.asarray, ref_params.init_params(
        jax.random.PRNGKey(0), ref_cfg, dtype=jnp.float32))
    rng = np.random.default_rng(1)
    for b in ("bq", "bk", "bv"):
        tree["layers"][b] = (0.3 * rng.standard_normal(
            tree["layers"][b].shape)).astype(np.float32)
    return ref_cfg, cfg, tree, P_.params_from_reference(tree, cfg,
                                                        device="cpu")


def _recorded(eng, rec, names):
    """Wrap an engine's model calls so that each call's logits land in
    ``rec``."""
    for name in names:
        fn = getattr(eng, name)

        def call(*a, _fn=fn):
            out = _fn(*a)
            logits = out[0] if isinstance(out, tuple) else out
            rec.append(np.asarray(logits, np.float32) if not
                       isinstance(logits, torch.Tensor) else
                       logits.float().numpy())
            return out
        setattr(eng, name, call)


def test_engine_logits_equal_the_reference_step_by_step(models):
    """Both engines admit the same prompts into 4 slots (the second after
    two steps, so the slots sit at different depths) and decode: every
    prefill's and every decode step's logits agree, and so do the tokens."""
    ref_cfg, cfg, tree, params = models
    ref = RefEngine(ref_cfg, tree, slots=4, max_len=48, eos_id=-1)
    eng = ReplicaEngine(cfg, params, slots=4, max_len=48, eos_id=-1)
    want, got = [], []
    _recorded(ref, want, ("_prefill", "_decode"))
    _recorded(eng, got, ("_prefill", "_decode"))
    for e in (ref, eng):
        e.admit(1, [5, 6, 7, 8, 9], 7)
        e.step()
        e.step()
        e.admit(2, [11, 3, 12], 6)
        e.admit(3, list(range(20, 33)), 4)
        while e.n_active:
            e.step()
    assert len(want) == len(got) == 3 + 7
    for i, (a, b) in enumerate(zip(want, got)):
        # the reference's decode returns all 4 slots, its prefill one row
        assert a.shape == b.shape, i
        assert np.abs(a - b).max() / np.abs(a).max() < REL_TOL, i


def _generate(cfg, params, rid, prompt, n):
    eng = ReplicaEngine(cfg, params, slots=4, max_len=64, eos_id=-1)
    eng.admit(rid, prompt, n)
    toks = list(eng.seqs[rid].tokens)
    while eng.n_active:
        eng.step()
        if rid in eng.seqs:
            toks = list(eng.seqs[rid].tokens)
    return toks


def test_interleaved_batching_matches_isolated(models):
    _, cfg, _, params = models
    eng = ReplicaEngine(cfg, params, slots=4, max_len=64, eos_id=-1)
    eng.admit(1, [5, 6, 7, 8], 6)
    for _ in range(2):
        eng.step()
    eng.admit(2, [9, 10, 11], 6)
    record = {}
    while eng.n_active:
        for rid, s in eng.seqs.items():
            record[rid] = list(s.tokens)
        eng.step()
        for rid, s in eng.seqs.items():
            record[rid] = list(s.tokens)
    assert record[1] == _generate(cfg, params, 1, [5, 6, 7, 8], 6)
    assert record[2] == _generate(cfg, params, 2, [9, 10, 11], 6)


POLICIES = [("first_fit", None), ("best_fit", {"norm": "linf"}),
            ("best_fit", {"norm": "l1"}), ("best_fit", {"norm": "l2"}),
            ("mru", None), ("greedy", None), ("nrt_standard", None),
            ("nrt_prioritized", None), ("cbdt", {"rho": 10.0})]


def _drive(sched, request_cls, n=150, seed=5):
    """The reference test's arrival process (tests/test_serving.py):
    integer clock, fp32-exact sizes."""
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


@pytest.mark.parametrize("policy,kwargs", POLICIES)
def test_scheduler_decisions_equal_the_reference(policy, kwargs):
    """Host zoo and device select (the plain select on the CPU) of the port
    against the JAX scheduler's host zoo, decision for decision, with the
    final pool state and stats."""
    caps = ReplicaCapacity(slots=4, kv_tokens=65536, prefill_budget=262144)
    ref_caps = RefCaps(slots=4, kv_tokens=65536, prefill_budget=262144)
    ref = RefScheduler(policy, ref_caps, kwargs)
    want = _drive(ref, RefRequest)
    host = DVBPScheduler(policy, caps, kwargs)
    assert _drive(host, Request) == want
    assert np.array_equal(host.pool.used, ref.pool.used)
    assert np.array_equal(host.pool.open_seq, ref.pool.open_seq)
    assert np.array_equal(host.pool.tag, ref.pool.tag)
    n0 = sum(ops.launches.values())
    dev = DVBPScheduler(policy, caps, kwargs, select_backend="device",
                        device="cpu")
    assert _drive(dev, Request) == want
    assert sum(ops.launches.values()) == n0   # CPU tensors: the plain select
    assert want[1][1] > 3                     # several replicas in play


@pytest.mark.parametrize("policy", ["next_fit", "rr_next_fit"])
def test_host_only_policies_equal_the_reference(policy):
    caps = ReplicaCapacity(slots=4, kv_tokens=4096, prefill_budget=4096)
    ref = RefScheduler(policy, RefCaps(slots=4, kv_tokens=4096,
                                       prefill_budget=4096))
    assert _drive(DVBPScheduler(policy, caps), Request, 100, 7) == \
        _drive(ref, RefRequest, 100, 7)
    with pytest.raises(ValueError, match="no on-device select"):
        DVBPScheduler(policy, caps, select_backend="device", device="cpu")


def test_scheduler_refuses_what_it_does_not_take():
    with pytest.raises(KeyError):
        DVBPScheduler("no_such_policy")
    with pytest.raises(ValueError, match="no on-device select"):
        DVBPScheduler("hybrid", select_backend="device", device="cpu")
    with pytest.raises(ValueError, match="select_backend"):
        DVBPScheduler("first_fit", select_backend="pallas")


def _fleet_requests():
    reqs = ref_fleet.attach_predictions(ref_fleet.synth_requests(300, seed=3),
                                        sigma=0.3, seed=3)
    port = fleet.attach_predictions(fleet.synth_requests(300, seed=3),
                                    sigma=0.3, seed=3)
    assert [dataclasses.astuple(r) for r in reqs] == \
        [dataclasses.astuple(r) for r in port]
    return reqs, port


@pytest.mark.parametrize("policy,kwargs", [
    ("round_robin", None), ("pack_all", None), ("first_fit", None),
    ("best_fit", {"norm": "linf"}), ("greedy", None),
    ("nrt_prioritized", None), ("cbdt", {"rho": 3600.0})])
def test_simulate_fleet_equals_the_reference(policy, kwargs):
    reqs, port = _fleet_requests()
    want = ref_fleet.simulate_fleet(reqs, policy, policy_kwargs=kwargs)
    assert fleet.simulate_fleet(port, policy, policy_kwargs=kwargs) == want


def test_serve_real_stats_equal_the_reference_and_the_chip_constant(models):
    """chip_smoke.py's phase-8 requests through serve_real on the reduced
    configuration: the port's stats equal the JAX package's, and both equal
    ``REF_SERVE_STATS``, which the card run holds at full width (the stats
    do not depend on the model: eos_id = -1, no sequence reaches
    max_len)."""
    ref_cfg, cfg, tree, params = models
    reqs = chip_smoke.serving_requests()
    assert len(reqs) == chip_smoke.SERVE_REQUESTS
    assert max(r.decode_len for r in reqs) <= chip_smoke.SERVE_DECODE_CAP
    assert max(r.prompt_len + r.decode_len for r in reqs) < \
        chip_smoke.SERVE_MAX_LEN - 1
    ref_reqs = [RefRequest(*dataclasses.astuple(r)) for r in reqs]
    want = ref_serve_real(ref_cfg, tree, ref_reqs, "greedy",
                          slots=chip_smoke.SERVE_SLOTS,
                          max_len=chip_smoke.SERVE_MAX_LEN)
    got = serve_real(cfg, params, reqs, "greedy",
                     slots=chip_smoke.SERVE_SLOTS,
                     max_len=chip_smoke.SERVE_MAX_LEN)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert (got.replica_seconds, got.replicas_opened, got.peak_replicas) == \
        chip_smoke.REF_SERVE_STATS


def test_serve_cli_on_the_cpu(capsys):
    serve_main(["--requests", "4", "--real", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "round_robin" in out and "real engines (greedy, cpu)" in out


def test_serve_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["--requests", "4", "--real"])


# ---------------------------------------------------------------- RWKV6

RWKV = "rwkv6-1.6b"


@pytest.fixture(scope="module")
def rwkv_models():
    from test_torch_rwkv import rwkv_reference_tree
    ref_cfg = dataclasses.replace(ref_reduced(RWKV), dtype="float32")
    cfg = dataclasses.replace(get_reduced_config(RWKV), dtype="float32")
    tree = rwkv_reference_tree(ref_cfg)
    return ref_cfg, cfg, tree, P_.params_from_reference(tree, cfg,
                                                        device="cpu")


def test_rwkv_engine_logits_equal_the_reference_on_fresh_slots(rwkv_models):
    """Three requests admitted into fresh slots of both engines before any
    step (a slot that idles through a decode step is no longer fresh in the
    reference: its state moves), then decoded to the end: every prefill's
    and every decode step's logits agree, and so do the tokens."""
    ref_cfg, cfg, tree, params = rwkv_models
    ref = RefEngine(ref_cfg, tree, slots=4, max_len=48, eos_id=-1)
    eng = ReplicaEngine(cfg, params, slots=4, max_len=48, eos_id=-1)
    want, got = [], []
    _recorded(ref, want, ("_prefill", "_decode"))
    _recorded(eng, got, ("_prefill", "_decode"))
    for e in (ref, eng):
        e.admit(1, [5, 6, 7, 8, 9], 7)
        e.admit(2, [11, 3, 12], 5)
        e.admit(3, list(range(20, 41)), 4)
        while e.n_active:
            e.step()
    assert len(want) == len(got) == 3 + 6
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.shape == b.shape, i
        assert np.abs(a - b).max() / np.abs(a).max() < REL_TOL, i


def test_rwkv_interleaved_batching_matches_isolated(rwkv_models):
    """A request admitted after two steps (its slot idled through them)
    and one in a fresh engine give the same tokens."""
    _, cfg, _, params = rwkv_models
    eng = ReplicaEngine(cfg, params, slots=4, max_len=64, eos_id=-1)
    eng.admit(1, [5, 6, 7, 8], 6)
    for _ in range(2):
        eng.step()
    eng.admit(2, [9, 10, 11], 6)
    record = {}
    while eng.n_active:
        for rid, s in eng.seqs.items():
            record[rid] = list(s.tokens)
        eng.step()
        for rid, s in eng.seqs.items():
            record[rid] = list(s.tokens)
    assert record[1] == _generate(cfg, params, 1, [5, 6, 7, 8], 6)
    assert record[2] == _generate(cfg, params, 2, [9, 10, 11], 6)


def _reused_and_fresh(engine_cls, cfg, params):
    """Prefill logits of request B in a one-slot engine whose slot request
    A (a 20-token prompt, 5 decodes) held before, and in a fresh one."""
    prompt_a = list(np.random.default_rng(11).integers(2, cfg.vocab, 20))
    prompt_b = list(np.random.default_rng(12).integers(2, cfg.vocab, 9))
    out = []
    for warm in (True, False):
        eng = engine_cls(cfg, params, slots=1, max_len=48, eos_id=-1)
        if warm:
            eng.admit(1, prompt_a, 5)
            while eng.n_active:
                eng.step()
        rec = []
        _recorded(eng, rec, ("_prefill",))
        eng.admit(2, prompt_b, 1)
        out.append(rec[0])
    return out


def test_rwkv_reused_slot_starts_fresh_where_the_reference_leaks(
        rwkv_models):
    """The reference's engine prefills into a slice of the slot's cache
    and its RWKV6 layers start from the state there (engine.py:51-61,
    transformer.py:75,81-83): request B's logits in a reused slot differ
    from a fresh engine's by more than 1e-3 of max |logit|.  The port's
    equal its fresh ones exactly, and the reference's fresh ones within
    1e-4."""
    ref_cfg, cfg, tree, params = rwkv_models
    ref_reused, ref_fresh = _reused_and_fresh(RefEngine, ref_cfg, tree)
    scale = np.abs(ref_fresh).max()
    leak = np.abs(ref_reused - ref_fresh).max()
    reused, fresh = _reused_and_fresh(ReplicaEngine, cfg, params)
    port = np.abs(fresh - ref_fresh).max()
    print(f"reference reused - fresh: {leak:.3e} of max |logit| "
          f"{scale:.3f} ({leak / scale:.3e}); port fresh - reference "
          f"fresh: {port:.3e}")
    assert leak / scale > 1e-3
    assert np.array_equal(reused, fresh)
    assert port / scale < REL_TOL


def test_rwkv_serve_real_stats_equal_the_reference_and_the_chip_constant(
        rwkv_models):
    """chip_smoke.py's requests (phase 9 serves them at rwkv6-1.6b's full
    width) through serve_real on the reduced configuration: the port's
    stats equal the JAX package's and ``REF_SERVE_STATS``."""
    ref_cfg, cfg, tree, params = rwkv_models
    reqs = chip_smoke.serving_requests()
    ref_reqs = [RefRequest(*dataclasses.astuple(r)) for r in reqs]
    want = ref_serve_real(ref_cfg, tree, ref_reqs, "greedy",
                          slots=chip_smoke.SERVE_SLOTS,
                          max_len=chip_smoke.SERVE_MAX_LEN)
    got = serve_real(cfg, params, reqs, "greedy",
                     slots=chip_smoke.SERVE_SLOTS,
                     max_len=chip_smoke.SERVE_MAX_LEN)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert (got.replica_seconds, got.replicas_opened, got.peak_replicas) == \
        chip_smoke.REF_SERVE_STATS


def test_rwkv_serve_cli_on_the_cpu(capsys):
    """The default request mix: the same line as the JAX package's
    ``python -m repro.launch.serve --arch rwkv6-1.6b --real``."""
    serve_main(["--arch", RWKV, "--real", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "real engines (greedy, cpu): replica_s=91 opened=3 peak=3" in out


def test_rwkv_serve_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["--arch", RWKV, "--requests", "4", "--real"])
