"""The per-event replay in windows (``torchsim.replay_windows``), which the
card runs as CUDA graphs of ``STEP_WINDOW`` steps, against the eager loop
and the jnp reference (``repro.core.jaxsim._replay_batch``), and the
select's route (``ops.select_route``).

On the CPU the windows run their body directly: a stand-in for the CUDA
graph (``RecordedGraph``) runs the body when it "captures" it and again
on each later replay, so the static window buffers filled by one copy a
stream, the steps and the copy-back of every carry entry a step replaces
all run, and so does the graphed schedule's bookkeeping: the launches a
capture records are taken back and counted once a replay.  Capture itself
needs a card (``tests/test_torch_cuda.py``).

Fixture: the fp32-exact lanes of ``tests/test_torch_categories.py``
(copied): 40/60/30 items in d = 2/4/3, clairvoyant, pdep == arrival and
power-of-two noise, 120 events a lane; with ``migrate`` a MIGRATE event of
a live item after every 7 events (137 a lane).  Windows of 16 steps, so
seven or eight full windows and a ragged tail."""
import collections
import os
import re
import sys

import numpy as np
import pytest
import torch

from repro.core import Instance
from repro.core import jaxsim
from repro.sweep import pack_instances, pad_predictions
from repro.sweep.runner import _flatten_lanes
from repro_torch.core import torchsim
from repro_torch.kernels import ops
from repro_torch.kernels.fitscore import select_ref

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from chip_smoke import with_migrations  # noqa: E402

torch.set_num_threads(1)

MAX_BINS = 24
K = 16
# one policy of each kernel family
FAMILY_POLICIES = ("best_fit_l2", "cbd", "hybrid", "ppe", "la_binary",
                   "adaptive")


def quantized_instance(seed, n, d):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 24, (n, d)) / 64.0
    arr = np.sort(rng.integers(0, 50000, n)).astype(float)
    dur = rng.integers(10, 5000, n).astype(float)
    return Instance(sizes, arr, arr + dur, f"q{seed}").sorted_by_arrival()


@pytest.fixture(scope="module")
def lanes():
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
    flat = tuple(np.asarray(a) for a in _flatten_lanes(
        batch.sizes, batch.times, batch.kinds, batch.items, pdeps,
        batch.dmask, batch.arrivals, batch.pdeps, batch.n_items))
    return {False: flat, True: with_migrations(flat, 7)}


class RecordedGraph:
    """A CPU stand-in for ``torchsim._Graph``: "capturing" runs the body
    once (the window it is asked to capture), so its first replay has
    nothing left to do; later replays run the body again, and, as a graph
    replay runs no Python, what it counts is dropped."""

    captured = 0

    def __init__(self, body, dev):
        body()
        self.body, self.pending = body, True
        RecordedGraph.captured += 1

    def replay(self):
        if self.pending:
            self.pending = False
        else:
            counted = collections.Counter(ops.launches)
            self.body()
            ops.launches.clear()
            ops.launches.update(counted)

    def reset(self):
        self.body = None


def windowed(monkeypatch):
    """Bind the windowed loop (windows of ``K``, the recorded graph) as
    the per-event loop of ``_replay_batch`` on the CPU."""
    monkeypatch.setattr(torchsim, "_Graph", RecordedGraph)
    monkeypatch.setattr(
        torchsim, "_run_events",
        lambda step, S, ev, ex, dev: torchsim.replay_windows(
            step, S, ev, ex, K))


def flat_carry(carry):
    out = dict(zip(torchsim.fk.CORE_NAMES, carry[:12]))
    if len(carry) > 12:
        out.update(carry[12])
    return out


def test_fixture_has_several_windows_and_migrations(lanes):
    for migrate, flat in lanes.items():
        E = flat[1].shape[1]
        assert E % K and E // K >= 3
        assert ((flat[2] == torchsim.MIGRATE_KIND).sum() > 50) == migrate


@pytest.mark.parametrize("migrate", [False, True])
@pytest.mark.parametrize("policy", FAMILY_POLICIES)
def test_windowed_replay_equals_eager_and_reference(policy, migrate, lanes,
                                                    monkeypatch):
    flat = lanes[migrate]
    kw = dict(policy=policy, max_bins=MAX_BINS, return_carry=True,
              migrate=migrate)
    eager = torchsim._replay_batch(*flat, device="cpu", **kw)
    windowed(monkeypatch)
    got = torchsim._replay_batch(*flat, device="cpu", **kw)
    for a, b in zip(got[:4], eager[:4]):
        assert torch.equal(a, b)
    want, have = flat_carry(eager[4]), flat_carry(got[4])
    assert set(want) == set(have)
    for k in want:
        assert torch.equal(have[k], want[k]), k

    ref = jaxsim._replay_batch(*flat, backend="jnp", **kw)
    for r, g in zip(ref[:4], got[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    back = torchsim.carry_to_reference(got[4], flat[0].shape[2])
    core, cat = ref[4] if isinstance(ref[4][1], dict) else (ref[4], {})
    got_core, got_cat = back if cat else (back, {})
    for a, b in zip(core, got_core):
        np.testing.assert_array_equal(b, np.asarray(a))
    assert set(got_cat) == set(cat)
    for k in cat:
        np.testing.assert_array_equal(got_cat[k], np.asarray(cat[k]),
                                      err_msg=k)


@pytest.mark.parametrize("migrate", [False, True])
@pytest.mark.parametrize("policy", ["greedy", "la_geometric", "adaptive"])
def test_graphed_schedule_counts_what_the_eager_loop_counts(
        policy, migrate, lanes, monkeypatch):
    """With a counting stand-in for the select and the recorded graph,
    the graphed schedule's launches equal the eager loop's: the capture's
    are taken back, and each replay adds them once."""
    flat = lanes[migrate]

    def counting_select(*a, **k):
        ops.launches["fitscore_select"] += 1
        return select_ref(*a, **k)

    monkeypatch.setattr(torchsim, "fitscore_select", counting_select)
    kw = dict(policy=policy, max_bins=MAX_BINS, device="cpu",
              migrate=migrate)
    ops.launches.clear()
    eager = torchsim._replay_batch(*flat, **kw)
    want = dict(ops.launches)
    assert want["fitscore_select"] >= flat[1].shape[1]

    windowed(monkeypatch)
    ops.launches.clear()
    RecordedGraph.captured = 0
    got = torchsim._replay_batch(*flat, **kw)
    sched = torchsim.step_windows(flat[1].shape[1], K)
    n_graph = sum(how in ("capture", "replay") for _, _, how in sched)
    assert dict(ops.launches) == dict(
        want, replay_step_graph=n_graph, replay_step_capture=1)
    assert RecordedGraph.captured == 1
    for a, b in zip(got, eager):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["mru", "ppe_modified", "adaptive",
                                    "reduced_hybrid"])
def test_window_body_keeps_the_carry_tensors(policy, lanes):
    """After a window body ``S`` holds the very tensors it began with (a
    graph replays the addresses it captured), with the state the steps
    left: the same as the eager steps', replaced entries included."""
    flat = lanes[True]
    runs = []

    def keep(step, S, ev, ex, dev):   # the replay's set-up, no steps
        runs.append((step, S, ev, ex))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torchsim, "_run_events", keep)
        for _ in range(2):
            torchsim._replay_batch(*flat, policy=policy, max_bins=MAX_BINS,
                                   device="cpu", migrate=True)
    (step, S, ev, ex), (step2, S2, _, _) = runs
    buf = {nm: v[:K].clone() for nm, v in ev.items()}
    bex = {nm: v[:K].clone() for nm, v in ex.items()}
    before, before2 = dict(S), dict(S2)
    torchsim.window_body(step, S, buf, bex, K)
    torchsim.run_steps(step2, S2, ev, ex, 0, K)
    for nm, v in S.items():
        assert v is before[nm], nm
        assert torch.equal(v, S2[nm]), nm
    # the eager steps did replace entries: the copy-back had work to do
    assert any(S2[nm] is not v for nm, v in before2.items())


@pytest.mark.parametrize("E,K_", [(0, 4), (1, 4), (7, 4), (8, 4), (9, 4),
                                  (120, 16), (137, 16), (255, 128),
                                  (256, 128), (11103, 128), (300, 64)])
def test_step_windows_cover_every_event_once_in_order(E, K_):
    sched = torchsim.step_windows(E, K_)
    covered = [e for lo, hi, _ in sched for e in range(lo, hi)]
    assert covered == list(range(E))
    hows = [how for _, _, how in sched]
    if E < 2 * K_:
        assert hows == (["eager"] if E else [])
        return
    assert hows[:2] == ["warm", "capture"]
    full = [(lo, hi) for lo, hi, how in sched if how != "eager"]
    assert all(hi - lo == K_ for lo, hi in full)
    assert hows[2:] == ["replay"] * (E // K_ - 2) + \
        (["eager"] if E % K_ else [])
    assert sched[-1][1] - sched[-1][0] == (E % K_ or K_)


def test_step_windows_refuse_an_empty_window():
    with pytest.raises(ValueError, match="window"):
        torchsim.step_windows(10, 0)


@pytest.mark.parametrize("Np,route", [(1, "warp"), (31, "warp"),
                                      (256, "warp"), (257, "cta"),
                                      (65536, "cta")])
def test_select_route_by_pool_size(Np, route):
    assert ops.select_route(Np) == route


def test_select_route_refuses_an_empty_pool_and_matches_the_kernel():
    with pytest.raises(ValueError, match="pool"):
        ops.select_route(0)
    src = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                       "select.cu")
    with open(src) as f:
        text = f.read()
    assert int(re.search(r"constexpr int kSelectWarpMaxSlots = (\d+);",
                         text).group(1)) == ops.SELECT_WARP_MAX_SLOTS
    assert ops.SELECT_ROUTES == ("warp", "cta")
