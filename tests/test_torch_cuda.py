"""The port on the card: the CUDA select against its plain version, and the
replay on the card against the replay on the CPU, bit for bit.

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
from repro_torch.kernels.fitscore import SELECT_POLICIES, select_ref
from repro_torch.sweep import pack_instances, pad_predictions, run_batch
from repro_torch.sweep.runner import _flatten_lanes

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import random_state  # noqa: E402  (random/tied/full pools)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA select has no CPU mode")
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
