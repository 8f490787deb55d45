"""The port on the card: the CUDA select and the CUDA replay megakernel
against their plain versions, and the replays on the card (per event and
blocked) against the replays on the CPU, bit for bit.

Every test here needs an NVIDIA card (marker ``cuda``) and skips with a
reason where ``torch.cuda.is_available()`` is false: the CUDA kernel has
no CPU mode.  The file imports neither JAX nor the JAX package, so it runs
on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import torchsim
from repro_torch.core.types import Instance
from repro_torch.kernels import ops
from repro_torch.kernels import fitscore as fk
from repro_torch.kernels.fitscore import SELECT_POLICIES, select_ref
from repro_torch.sweep import pack_instances, pad_predictions, run_batch
from repro_torch.sweep.runner import _flatten_lanes

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import random_state  # noqa: E402  (random/tied/full pools)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.parametrize("policy", SELECT_POLICIES)
def test_kernel_equals_select_ref(policy, cuda):
    rng = np.random.default_rng(SELECT_POLICIES.index(policy))
    for mode in ("random", "ties", "full"):
        for Np in (64, 300):
            for d in (2, 5):
                st = random_state(rng, 28, Np, d, mode, cuda)
                for cmask in (None, st[10]):
                    n0 = ops.launches["fitscore_select"]
                    got = ops.fitscore_select(*st[:10], cmask, policy=policy)
                    assert ops.launches["fitscore_select"] == n0 + 1
                    ref = select_ref(*st[:10], cmask, policy=policy)
                    for a, b in zip(got, ref):
                        assert torch.equal(a.long(), b.long()), \
                            (mode, Np, d, cmask is not None)
                if mode == "full":
                    assert bool(got[2].all()) and not bool(got[1].any())


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    st = random_state(np.random.default_rng(0), 4, 16, 2, "random", cuda)
    bad_dtype = [st[0].double()] + st[1:10]
    with pytest.raises(ValueError, match="loads"):
        ops.fitscore_select(*bad_dtype, policy="first_fit")
    strided = st[:1] + [st[1].t().contiguous().t()] + st[2:10]
    with pytest.raises(ValueError, match="counts"):
        ops.fitscore_select(*strided, policy="first_fit")
    with pytest.raises(ValueError, match="not a select policy"):
        ops.fitscore_select(*st[:10], policy="cbd")
    mixed = st[:1] + [st[1].cpu()] + st[2:10]
    with pytest.raises(ValueError, match="counts"):
        ops.fitscore_select(*mixed, policy="first_fit")


def _quantized(seed, n, d):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 24, (n, d)) / 64.0
    arr = np.sort(rng.integers(0, 50000, n)).astype(float)
    dur = rng.integers(10, 5000, n).astype(float)
    return Instance(sizes, arr, arr + dur, f"q{seed}").sorted_by_arrival()


@pytest.fixture(scope="module")
def lanes():
    insts = [_quantized(1, 60, 2), _quantized(2, 100, 4),
             _quantized(3, 40, 3)]
    batch = pack_instances(insts)
    preds = []
    for i in insts:
        noisy = i.durations * np.random.default_rng(7).choice(
            [0.5, 1.0, 2.0], i.n_items)
        preds.append(np.stack([i.durations, noisy]))
    pdeps = pad_predictions(batch, preds)
    return batch, pdeps, _flatten_lanes(
        batch.sizes, batch.times, batch.kinds, batch.items, pdeps,
        batch.dmask, batch.arrivals, batch.pdeps, batch.n_items)


@pytest.mark.parametrize("policy", SELECT_POLICIES)
def test_replay_on_card_equals_cpu(policy, lanes, cuda):
    *_, flat = lanes
    ops.launches.clear()
    torchsim.counters.clear()
    got = torchsim._replay_batch(*flat, policy=policy, max_bins=16,
                                 device=cuda)
    assert ops.launches["fitscore_select"] == \
        torchsim.counters["scan_steps"] == flat[1].shape[1]
    ref = torchsim._replay_batch(*flat, policy=policy, max_bins=16,
                                 device="cpu")
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


def test_overflow_ladder_on_card_equals_cpu(lanes, cuda):
    batch, pdeps, _ = lanes
    a = run_batch(batch, "best_fit_l2", pdeps, max_bins=1, device=cuda)
    b = run_batch(batch, "best_fit_l2", pdeps, max_bins=1, device="cpu")
    for f in ("usage_time", "n_bins_opened", "overflowed", "max_bins"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _block_case(policy, flat, max_bins, device):
    """Streams, kernel arguments and a mid-replay packed carry (the first
    48 events replayed) of one policy on ``device``."""
    ev_i, ev_f, ev_size, dmask, fam, d = torchsim._event_streams(
        policy, *flat, None)
    kw = torchsim.replay_block_kwargs(policy, max_bins, d)
    ev = [a.to(device) for a in (ev_i, ev_f, ev_size, dmask)]
    carry = torchsim.packed_init_carry(fam, flat[0].shape[0],
                                       flat[0].shape[1], max_bins, device)
    ops.replay_chunk(carry, ev[0][:, :, :48], ev[1][:, :, :48],
                     ev[2][:, :48], ev[3], block_events=48, **kw)
    return carry, ev, kw


@pytest.mark.parametrize("policy", torchsim.SCAN_POLICIES)
def test_megakernel_equals_replay_block_ref(policy, lanes, cuda):
    """One launch (and one plain block) from the same mid-replay carry,
    T = 1 and T = 64 past the end of two of the three lanes (PAD): every
    carry array equal."""
    *_, flat = lanes
    for T in (1, 64):
        carry, (ev_i, ev_f, ev_size, dmask), kw = _block_case(
            policy, flat, 16, cuda)
        plain = {k: v.clone() for k, v in carry.items()}
        blk = slice(136, 136 + T)
        n0 = ops.launches["fitscore_replay_block"]
        ops.fitscore_replay_block(carry, ev_i[:, :, blk], ev_f[:, :, blk],
                                  ev_size[:, blk], dmask, **kw)
        assert ops.launches["fitscore_replay_block"] == n0 + 1
        fk.replay_block_ref(plain, ev_i[:, :, blk], ev_f[:, :, blk],
                            ev_size[:, blk], dmask, **kw)
        for k in carry:
            assert torch.equal(carry[k], plain[k]), (T, k)


@pytest.mark.parametrize("policy", ["best_fit_l2", "cbdt", "hybrid",
                                    "ppe_modified", "la_binary",
                                    "adaptive"])
def test_blocked_replay_on_card_equals_cpu(policy, lanes, cuda):
    *_, flat = lanes
    ops.launches.clear()
    torchsim.counters.clear()
    got = torchsim._replay_batch(*flat, policy=policy, max_bins=16,
                                 device=cuda, block_events=32)
    E = flat[1].shape[1]
    assert ops.launches["fitscore_replay_block"] == \
        torchsim.counters["replay_blocks"] == -(-E // 32)
    assert ops.launches["fitscore_select"] == 0
    ref = torchsim._replay_batch(*flat, policy=policy, max_bins=16,
                                 device="cpu")
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


def test_megakernel_wrapper_rejects_what_the_kernel_does_not_take(lanes,
                                                                  cuda):
    *_, flat = lanes
    carry, (ev_i, ev_f, ev_size, dmask), kw = _block_case(
        "rcp", flat, 16, cuda)
    ev = (ev_i[:, :, :8], ev_f[:, :, :8], ev_size[:, :8], dmask)
    bad = dict(carry, sloti=carry["sloti"].float())
    with pytest.raises(ValueError, match="sloti"):
        ops.fitscore_replay_block(bad, *ev, **kw)
    with pytest.raises(ValueError, match="carry arrays"):
        ops.fitscore_replay_block({k: v for k, v in carry.items()
                                   if k != "ron"}, *ev, **kw)
    with pytest.raises(ValueError, match="ev_i"):
        ops.fitscore_replay_block(carry, ev[0].cpu(), *ev[1:], **kw)
    with pytest.raises(ValueError, match="slots"):
        ops.fitscore_replay_block(carry, *ev, **dict(kw, n=17))
