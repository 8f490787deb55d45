"""The megakernel's two routes and the warp kernel's hazards.

``ops.replay_route`` picks the kernel of a ``fitscore_replay_block`` launch
on the card from the pool size alone: the warp kernel
(``csrc/replay_block_sm90.cu``: one warp a lane, the slot state and the
event block in shared memory) up to ``ops.REPLAY_WARP_MAX_SLOTS`` slots,
the global kernel (``csrc/replay_block.cu``) above.  Here it is a pure
function, held to the threshold the CUDA source writes.

The warp kernel prefetches a departure's item row when it stages the
block, forwards the rows its commits write to the block's later events,
keeps RCP's LOC_B rows in a bitmap and ends the loop at the block's last
real event.  The blocks that exercise those paths (``chip_smoke.HAZARDS``:
an arrival and its departure in consecutive events, an RCP base conversion
then a converted item's departure, an all-PAD block, a block whose last
real event is its 5th, with MIGRATE events too) go here through the plain
version and through the reference's Pallas megakernel in interpret mode
(how the JAX package's own tests run it on the CPU): every carry array
equal bit for bit.  The CUDA kernels' own comparison with the plain version
on the same blocks runs on a card (tests/test_torch_cuda.py,
``chip_smoke.py`` phase 3).

The megakernel's contract says every DEPARTURE and MIGRATE event names an
item its lane has placed (``ops.fitscore_replay_block``); the streams the
replays hand it are held to that here."""
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.kernels.fitscore as ref_fitscore
from repro_torch.consolidate import ConsolidationSpec, consolidated_replay
from repro_torch.core import torchsim
from repro_torch.core.types import Instance
from repro_torch.kernels import fitscore as fk
from repro_torch.kernels import ops

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (the hazard blocks)

# the tensors here are tiny: intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

MAX = ops.REPLAY_WARP_MAX_SLOTS


@pytest.mark.parametrize("Np,route", [
    (1, "warp"), (31, "warp"), (32, "warp"), (64, "warp"), (128, "warp"),
    (MAX - 1, "warp"), (MAX, "warp"), (MAX + 1, "global"), (300, "global"),
    (65536, "global")])
def test_replay_route_by_pool_size(Np, route):
    assert ops.replay_route(Np) == route


def test_replay_route_threshold_and_refusals():
    """The threshold is 256 slots, as the warp kernel's source says, and a
    pool of no slots has no route."""
    assert MAX == 256
    path = os.path.join(os.path.dirname(fk.__file__), "csrc",
                        "replay_common.cuh")
    text = open(path).read()
    assert int(re.search(r"constexpr int kWarpMaxSlots = (\d+);",
                         text).group(1)) == MAX
    for Np in (0, -1):
        with pytest.raises(ValueError, match="slots"):
            ops.replay_route(Np)


def test_launcher_needs_the_card():
    """The launcher builds no launch for CPU tensors; the wrapper runs the
    plain version on the CPU and counts no launch on either route."""
    carry, blk, dmask, kw, _ = chip_smoke.hazard_block("last_real_5th",
                                                       "first_fit")
    with pytest.raises(ValueError, match="no kernel"):
        ops.replay_block_launcher(carry, *blk, dmask, route="warp", **kw)
    before = dict(ops.launches)
    ops.fitscore_replay_block(carry, *blk, dmask, **kw)
    assert dict(ops.launches) == before


# (hazard, policy): every family for the hazards of every family, the four
# RCP/PPE policies for the conversion
CASES = (
    [("arrive_depart", p) for p in ("nrt_prioritized", "cbd", "hybrid",
                                    "ppe", "la_binary", "adaptive")] +
    [("convert_then_depart", p) for p in ("rcp", "ppe", "rcp_modified",
                                          "ppe_modified")] +
    [("all_pad", p) for p in ("greedy", "reduced_hybrid", "rcp")] +
    [("last_real_5th", p) for p in ("best_fit_l2", "cbdt",
                                    "hybrid_direct_sum", "ppe_modified",
                                    "la_geometric", "adaptive")] +
    [("last_real_5th_migrate", p) for p in ("mru", "cbd", "hybrid", "rcp",
                                            "la_binary", "adaptive")])


def _hazard_holds(name, ev_i, carry, migrate):
    """The block is the hazard its name says."""
    kinds, items = ev_i[0], ev_i[1]
    real = (kinds == fk.ARRIVAL_KIND) | (kinds == fk.DEPARTURE_KIND) | \
        (kinds == fk.MIGRATE_KIND)
    if name == "arrive_depart":
        assert ((kinds[:, :-1] == fk.ARRIVAL_KIND) &
                (kinds[:, 1:] == fk.DEPARTURE_KIND) &
                (items[:, :-1] == items[:, 1:])).any()
    elif name == "convert_then_depart":
        # (test_conversion_block_converts_and_departs replays it)
        assert (kinds == fk.DEPARTURE_KIND).any()
    elif name == "all_pad":
        assert not real.any()
    else:
        last = [int(real[l].nonzero().max()) for l in range(real.shape[0])]
        assert last == [4] * real.shape[0]
        assert ((kinds == fk.MIGRATE_KIND).any()) == migrate


@pytest.mark.parametrize("name,policy", CASES)
def test_hazard_block_equals_interpret_megakernel(name, policy):
    """One hazard block: the plain version (through the wrapper, as the
    CPU path runs it) == the reference's megakernel in interpret mode,
    every carry array bit for bit."""
    carry, (ev_i, ev_f, ev_size), dmask, kw, migrate = \
        chip_smoke.hazard_block(name, policy)
    _hazard_holds(name, ev_i, carry, migrate)
    fam, d = kw["family"], kw["d"]
    L, T = ev_i.shape[1:]
    ref_in = torchsim.packed_carry_to_reference(carry, d)
    names_i = ("kind", "item") + fk.REPLAY_EV_I[fam]
    names_f = ("t", "pdep") + fk.REPLAY_EV_F[fam]
    size_ref = np.zeros((L, T, 128), np.float32)
    size_ref[:, :, :fk.DPAD] = ev_size.numpy()
    dmask_ref = np.zeros((L, 128), np.float32)
    dmask_ref[:, :fk.DPAD] = dmask.numpy()
    out = ref_fitscore.fitscore_replay_block(
        {k: jnp.asarray(v) for k, v in ref_in.items()},
        {nm: jnp.asarray(ev_i[k].numpy()) for k, nm in enumerate(names_i)},
        {nm: jnp.asarray(ev_f[k].numpy()) for k, nm in enumerate(names_f)},
        jnp.asarray(size_ref), jnp.asarray(dmask_ref), migrate=migrate,
        interpret=True, **kw)
    got = ops.fitscore_replay_block(carry, ev_i, ev_f, ev_size, dmask,
                                    migrate=migrate, **kw)
    want = torchsim.packed_carry_from_reference(out, d, kw["n"], "cpu")
    assert set(got) == set(want) == set(fk.replay_carry_names(fam))
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_conversion_block_converts_and_departs():
    """The conversion fixture's block really holds a base conversion that
    turns LOC_B items into LOC_C and a departure of one of them: replayed
    event by event with the plain version."""
    carry, (ev_i, ev_f, ev_size), dmask, kw, _ = chip_smoke.hazard_block(
        "convert_then_depart", "ppe")
    turned, departed = set(), False
    for e in range(ev_i.shape[2]):
        aux0 = carry["itemi"][..., fk.ITEMI_AUX].clone()
        fk.replay_block_ref(carry, ev_i[:, :, e:e + 1], ev_f[:, :, e:e + 1],
                            ev_size[:, e:e + 1], dmask, **kw)
        aux1 = carry["itemi"][..., fk.ITEMI_AUX]
        turned |= {(int(l), int(j)) for l, j in
                   ((aux0 == fk.LOC_B) & (aux1 == fk.LOC_C)).nonzero()}
        for l in range(ev_i.shape[1]):
            if int(ev_i[0, l, e]) == fk.DEPARTURE_KIND and \
                    (l, int(ev_i[1, l, e])) in turned:
                departed = True
    assert turned and departed


def _unplaced(kinds, items):
    """(lane, event) of every DEPARTURE or MIGRATE event whose item its
    lane has not placed at that point: no ARRIVAL of it since its last
    DEPARTURE (an arrival always places the item)."""
    bad = []
    for lane in range(kinds.shape[0]):
        live = set()
        for e, (k, j) in enumerate(zip(kinds[lane].tolist(),
                                       items[lane].tolist())):
            if k == fk.ARRIVAL_KIND:
                live.add(j)
            elif k in (fk.DEPARTURE_KIND, fk.MIGRATE_KIND):
                if j not in live:
                    bad.append((lane, e))
                if k == fk.DEPARTURE_KIND:
                    live.discard(j)
    return bad


def test_unplaced_finds_a_departure_before_its_arrival():
    """The check below finds what it looks for."""
    D, A, M, P = (fk.DEPARTURE_KIND, fk.ARRIVAL_KIND, fk.MIGRATE_KIND,
                  fk.PAD_KIND)
    kinds = np.array([[A, D, D, P], [D, A, M, D], [A, M, D, M]])
    items = np.array([[3, 3, 3, 0], [5, 5, 5, 5], [1, 1, 1, 1]])
    assert _unplaced(kinds, items) == [(0, 2), (1, 0), (2, 3)]


@pytest.mark.parametrize("consolidate", [False, True])
def test_streams_depart_only_placed_items(consolidate, monkeypatch):
    """Every stream a blocked replay hands the megakernel, recorded at its
    door (``torchsim.replay_chunk``) and joined lane by lane, departs and
    migrates placed items only: on lanes whose departures tie with other
    items' arrivals (``chip_smoke.hazard_lanes``), plain and consolidating
    (then with MIGRATE events).  The ties resolve safely because an
    ``Instance`` refuses an item that departs when it arrives."""
    seen = []
    chunk = torchsim.replay_chunk

    def spy(carry, ev_i, *a, **k):
        seen.append(ev_i[:2].clone())
        return chunk(carry, ev_i, *a, **k)

    monkeypatch.setattr(torchsim, "replay_chunk", spy)
    flat = chip_smoke.hazard_lanes()
    if consolidate:
        consolidated_replay(*flat, policy="best_fit_l2", max_bins=32,
                            device="cpu", block_events=8,
                            spec=ConsolidationSpec.parse("underload:t0.5:e8"))
    else:
        torchsim._replay_batch(*flat, policy="first_fit", max_bins=32,
                               device="cpu", block_events=16)
    kinds, items = torch.cat(seen, dim=2).numpy()
    n = np.asarray(flat[-1])
    assert [(kinds[l] == fk.DEPARTURE_KIND).sum() for l in range(len(n))] \
        == n.tolist()
    assert (kinds == fk.MIGRATE_KIND).any() == consolidate
    assert _unplaced(kinds, items) == []
    times = np.array([0.0, 100.0])
    with pytest.raises(ValueError):
        Instance(np.full((2, 2), 0.25), times, times.copy(), "zero")
