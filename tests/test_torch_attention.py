"""The port's plain attention versions (``repro_torch.kernels.attention``,
run by the ``ops`` wrappers on CPU tensors) against the JAX package's
Pallas kernels in interpret mode, on the shapes of tests/test_kernels.py
and on G = 5 cases (qwen2.5-14b's 40 query heads over 8 kv heads), fp32
and bf16, at the JAX tests' tolerances: 2e-5 (fp32) and 2e-2 (bf16), atol
and rtol.  Inputs are drawn with numpy from a seed and handed to both;
bf16 inputs are the same fp32 draws rounded to bf16 by each framework
(both round to nearest even, so both see the same values)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import ops
from repro_torch.kernels.attention import (decode_attention_ref,
                                           flash_attention_ref)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

FLASH_SHAPES = [(2, 128, 128, 4, 2, 64), (1, 256, 256, 4, 4, 64),
                (2, 100, 100, 2, 1, 32), (1, 64, 192, 4, 2, 128),
                (1, 96, 96, 8, 8, 16),
                # G = 5, a ragged tail, two batch rows
                (2, 37, 37, 10, 2, 32), (1, 70, 90, 5, 1, 16)]
DECODE_SHAPES = [(2, 8, 2, 64, 512), (1, 4, 4, 128, 300), (3, 5, 1, 32, 64),
                 (2, 16, 8, 64, 1024),
                 # G = 5
                 (3, 10, 2, 32, 100), (2, 40, 8, 16, 40)]


def _both(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _assert_close(port, ref, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32),
                                           (False, 0)])
def test_flash_plain_equals_pallas_kernel(B, Sq, Skv, H, KV, hd, dtype,
                                          causal, window):
    rng = np.random.default_rng(B * 1000 + Sq + H)
    (qj, qt), (kj, kt), (vj, vt) = (
        _both(rng, s, dtype) for s in ((B, Sq, H, hd), (B, Skv, KV, hd),
                                       (B, Skv, KV, hd)))
    want = ref_ops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                   impl="pallas_interpret")
    n0 = sum(ops.launches.values())
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert sum(ops.launches.values()) == n0   # the plain version ran
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("B,H,KV,hd,S", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_equals_pallas_kernel(B, H, KV, hd, S, dtype):
    rng = np.random.default_rng(B * 1000 + S + H)
    (qj, qt), (kj, kt), (vj, vt) = (
        _both(rng, s, dtype) for s in ((B, H, hd), (B, S, KV, hd),
                                       (B, S, KV, hd)))
    kv_len = rng.integers(1, S + 1, B).astype(np.int32)
    kv_len[0] = S
    if B >= 3:
        kv_len[-1] = 0
    want = ref_ops.decode_attention(qj, kj, vj, jnp.asarray(kv_len),
                                    impl="pallas_interpret")
    n0 = sum(ops.launches.values())
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(kv_len))
    assert sum(ops.launches.values()) == n0
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _assert_close(got, want, dtype)


def test_decode_kv_len_zero_gives_the_kernels_zeros():
    """At kv_len = 0 the Pallas kernel returns zeros where the JAX
    package's decode_attention_ref averages V; the port follows the
    kernel, and equals the reference's ref.py wherever kv_len > 0."""
    rng = np.random.default_rng(5)
    B, H, KV, hd, S = 3, 10, 2, 32, 48
    (qj, qt), (kj, kt), (vj, vt) = (
        _both(rng, s, "float32") for s in ((B, H, hd), (B, S, KV, hd),
                                           (B, S, KV, hd)))
    kv_len = np.array([0, 7, S], np.int32)
    kernel = np.asarray(ref_ops.decode_attention(
        qj, kj, vj, jnp.asarray(kv_len), impl="pallas_interpret"))
    oracle = np.asarray(ref_ref.decode_attention_ref(qj, kj, vj,
                                                     jnp.asarray(kv_len)))
    got = decode_attention_ref(qt, kt, vt, torch.from_numpy(kv_len)).numpy()
    assert np.abs(kernel[0]).max() == 0 and np.abs(got[0]).max() == 0
    assert np.abs(oracle[0]).max() > 0.01   # ref.py's mean of V
    np.testing.assert_allclose(got, kernel, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got[1:], oracle[1:], atol=2e-5, rtol=2e-5)


def test_decode_cache_rows_past_kv_len_never_reach_the_output():
    """Cache rows at or past kv_len may hold anything (a slot's earlier
    occupant; here NaN): they contribute p = 0 and their V rows are zeroed,
    as in the Pallas kernel, so nothing leaks into the output."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 10, 16), (2, 30, 2, 16), (2, 30, 2, 16)))
    kv_len = torch.tensor([12, 30], dtype=torch.int32)
    base = decode_attention_ref(q, k, v, kv_len)
    k[0, 12:], v[0, 12:] = float("nan"), float("nan")
    assert torch.equal(decode_attention_ref(q, k, v, kv_len), base)


def test_wrappers_run_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 24, 10, 16), (2, 24, 2, 16), (2, 24, 2, 16)))
    kv_len = torch.tensor([3, 24], dtype=torch.int32)
    n0 = dict(ops.launches)
    assert torch.equal(ops.flash_attention(q, k, v, causal=True, window=5),
                       flash_attention_ref(q, k, v, causal=True, window=5))
    assert torch.equal(ops.decode_attention(q[:, 0], k, v, kv_len),
                       decode_attention_ref(q[:, 0], k, v, kv_len))
    assert dict(ops.launches) == n0


@pytest.mark.parametrize("kernel", ["flash", "decode"])
def test_wrappers_refuse_a_device_without_a_kernel(kernel):
    """Tensors on neither the CPU nor a card (here: the meta device) have
    no kernel and no plain fallback: the wrapper raises."""
    q = torch.empty((1, 4, 4, 16), device="meta")
    k = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        if kernel == "flash":
            ops.flash_attention(q, k, k)
        else:
            ops.decode_attention(q[:, 0], k, k,
                                 torch.empty((1,), dtype=torch.int32,
                                             device="meta"))
