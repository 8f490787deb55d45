"""The port's plain attention versions (``repro_torch.kernels.attention``,
run by the ``ops`` wrappers on CPU tensors) against the JAX package's
Pallas kernels in interpret mode, on the shapes of tests/test_kernels.py
and on G = 5 cases (qwen2.5-14b's 40 query heads over 8 kv heads) and G =
12 and 16 (nemotron-4-340b's 96 over 8, and the decode kernel's most),
fp32 and bf16, at the JAX tests' tolerances: 2e-5 (fp32) and 2e-2 (bf16),
atol and rtol.  The windowed decode (which the Pallas kernel lacks) is
held to the reference models' XLA path, ``gqa_attention``, and the MLP
activations to the reference's ``_act``.  Inputs are drawn with numpy from a seed and handed to both;
bf16 inputs are the same fp32 draws rounded to bf16 by each framework
(both round to nearest even, so both see the same values)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as ref_ops
from repro.configs import get_reduced_config as ref_reduced
from repro.kernels import ref as ref_ref
from repro.models.attention import gqa_attention
from repro.models.moe import _act as ref_act
from repro_torch.kernels import ops
from repro_torch.models.transformer import _act
from repro_torch.kernels.attention import (NEG_INF, decode_attention_ref,
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
                 (3, 10, 2, 32, 100), (2, 40, 8, 16, 40),
                 # G = 12 (nemotron-4-340b's 96 over 8) and 16, the most
                 # the decode kernel takes
                 (3, 24, 2, 32, 100), (2, 32, 2, 16, 130)]


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


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 96, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"), (torch.bfloat16, 16, "simt"),
    (torch.bfloat16, 32, "simt"), (torch.bfloat16, 200, "simt"),
    (torch.bfloat16, 256, "sm90"), (torch.bfloat16, 192, "sm90"),
    (torch.float32, 192, "simt"), (torch.float32, 256, "simt")])
def test_flash_route_is_decided_by_dtype_and_head_dim(dtype, hd, route):
    """bf16 at hd 64, 128, 192 or 256 takes the tensor-core kernel; fp32
    and every other head dim keep the CUDA-core kernel."""
    assert ops.flash_route(dtype, hd) == route


@pytest.mark.parametrize("hd", [64, 128, 192, 256])
def test_flash_route_keeps_an_int8_cache_on_the_cuda_cores(hd):
    """An int8 cache takes the CUDA-core kernel at every head dim, the
    tensor-core ones included: the tensor-core kernel reads bf16 tiles."""
    assert ops.flash_route(torch.bfloat16, hd, int8=True) == "simt"
    assert ops.flash_route(torch.float32, hd, int8=True) == "simt"


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 1, "mma"), (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 100, "mma"), (torch.bfloat16, 128, "mma"),
    (torch.bfloat16, 192, "mma"), (torch.bfloat16, 200, "mma"),
    (torch.bfloat16, 256, "mma"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 192, "simt"),
    (torch.float32, 256, "simt")])
def test_decode_route_is_decided_by_dtype_and_head_dim(dtype, hd, route):
    """bf16 at every head dim the decode kernel takes (1-256) runs on the
    tensor cores (``mma.sync``); fp32 keeps the CUDA-core kernel."""
    assert ops.decode_route(dtype, hd) == route


# (B, KV, S) -> (n_split, split_len) at the serving path's shapes
TIMED_SPLITS = {(4, 8, 1024): (8, 128), (32, 8, 1024): (2, 512),
                (4, 8, 4096): (8, 512), (32, 8, 4096): (2, 2048)}


@pytest.mark.parametrize("B,KV,S", [(1, 1, 1), (1, 1, 64), (1, 8, 65),
                                    (1, 8, 511), (2, 2, 512), (3, 1, 100),
                                    (1, 1, 1 << 16), (64, 8, 4096),
                                    *TIMED_SPLITS])
def test_decode_splits_cover_the_cache_and_fill_the_card(B, KV, S):
    n_split, split_len = ops.decode_splits(B, KV, S)
    assert split_len % ops.DECODE_SPLIT_MIN == 0 and split_len >= 64
    assert n_split * split_len >= S > (n_split - 1) * split_len or S <= 64
    ctas = n_split * B * KV
    if S // ops.DECODE_SPLIT_MIN >= -(-264 // (B * KV)):
        # two CTAs an SM asked, at least one kept after rounding split_len
        assert ctas >= 132
    if (B, KV, S) in TIMED_SPLITS:
        assert (n_split, split_len) == TIMED_SPLITS[(B, KV, S)]
        assert ctas >= 2 * B * KV


def decode_split_merge(q, k, v, kv_len, split_len, window=0):
    """The decode kernel's arithmetic with plain torch ops: each split of
    ``split_len`` positions gives a partial (m, l, acc) over its valid
    positions (with a window, from ``max(its start, kv_len - window)``, where
    the kernel starts its walk), an empty split (m, l, acc) = (NEG_INF, 0,
    0); the partials merge as ``finish`` merges them, out = sum acc_s w_s /
    max(sum l_s w_s, 1e-30), w_s = exp(m_s - max m).  fp32 throughout, the
    result in q's type."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    f32 = torch.float32
    qg = q.to(f32).reshape(B, KV, G, hd)
    kt = k.to(f32).permute(0, 2, 1, 3)                   # (B, KV, S, hd)
    vt = v.to(f32).permute(0, 2, 1, 3)
    n_split = -(-S // split_len)
    ms, ls, accs = [], [], []
    for s in range(n_split):
        m = torch.full((B, KV, G), NEG_INF)
        l = torch.zeros((B, KV, G))
        acc = torch.zeros((B, KV, G, hd))
        for b in range(B):
            n = int(kv_len[b])
            lo = max(s * split_len, max(0, n - window) if window else 0)
            hi = min(s * split_len + split_len, max(0, min(n, S)))
            if hi <= lo:
                continue                                   # empty split
            sc = (qg[b] @ kt[b, :, lo:hi].transpose(-1, -2)) * hd ** -0.5
            m[b] = sc.amax(-1)
            p = torch.exp(sc - m[b][..., None])
            l[b] = p.sum(-1)
            acc[b] = p @ vt[b, :, lo:hi]
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.exp(m - m.amax(0))
    out = (acc * w[..., None]).sum(0) / \
        torch.clamp_min((l * w).sum(0), 1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,hd,S", [(1, 10, 2, 32, 1024),
                                         (2, 40, 8, 16, 1000),
                                         (3, 8, 8, 16, 300)])
def test_decode_split_and_merge_equal_the_plain_version(B, H, KV, hd, S,
                                                        dtype):
    """The split-and-merge arithmetic at the split length ``decode_splits``
    gives, with kv_len at a split's edges (split - 1, split, split + 1), 0,
    S, and S not a multiple of the split, against
    ``decode_attention_ref``; the positions past kv_len hold NaN and reach
    nothing."""
    n_split, split_len = ops.decode_splits(B, KV, S)
    assert n_split > 1
    rng = np.random.default_rng(S + H)
    td = DTYPES[dtype][1]
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        td) for s in ((B, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    edges = [split_len - 1, split_len, split_len + 1, 0, S,
             (n_split - 1) * split_len + 1]
    for n in edges:
        kv_len = torch.full((B,), n, dtype=torch.int32)
        kv_len[-1] = min(S, n + 1)
        kk, vv = k.clone(), v.clone()
        for b in range(B):
            kk[b, int(kv_len[b]):] = float("nan")
            vv[b, int(kv_len[b]):] = float("nan")
        got = decode_split_merge(q, kk, vv, kv_len, split_len)
        want = decode_attention_ref(q, kk, vv, kv_len)
        assert torch.isfinite(got.float()).all()
        for b in range(B):
            if int(kv_len[b]) == 0:
                assert float(got[b].float().abs().max()) == 0.0
        tol = TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,hd,S,window", [(1, 10, 2, 32, 1024, 64),
                                                (2, 24, 2, 16, 1000, 200),
                                                (3, 32, 2, 16, 300, 1)])
def test_decode_window_split_and_merge_equal_the_plain_version(
        B, H, KV, hd, S, window, dtype):
    """The windowed walk: with the window's start on a split's edge, one
    position inside a split, and the window ending past, at and before a
    split's edge, the splits read from ``max(start, kv_len - window)``; the
    positions outside the window hold NaN and reach nothing.  G = 5, 12
    and 16."""
    n_split, split_len = ops.decode_splits(B, KV, S)
    assert n_split > 1
    rng = np.random.default_rng(S + H + window)
    td = DTYPES[dtype][1]
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        td) for s in ((B, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    starts = [split_len, split_len + 1, split_len - 1, 0,
              (n_split - 1) * split_len]
    for lo in starts:
        kv_len = torch.full((B,), min(S, lo + window), dtype=torch.int32)
        kv_len[-1] = min(S, max(1, window // 2))   # the window not full
        kk, vv = k.clone(), v.clone()
        for b in range(B):
            n = int(kv_len[b])
            kk[b, n:], vv[b, n:] = float("nan"), float("nan")
            kk[b, :max(0, n - window)] = float("nan")
            vv[b, :max(0, n - window)] = float("nan")
        got = decode_split_merge(q, kk, vv, kv_len, split_len, window)
        want = decode_attention_ref(q, kk, vv, kv_len, window=window)
        assert torch.isfinite(got.float()).all()
        tol = TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def decode_halves(q, k, v, kv_len, window=0):
    """The tensor-core decode kernel's arithmetic above hd 128 (one split),
    with plain torch ops: 32-position chunks from the window's start; warp
    w = 2 dh + ph keeps a running softmax over positions 16 ph .. + 15 of
    each chunk, rounds its p to q's type for P . V and accumulates only
    the dims of 16-dim tiles [dh ND, dh ND + ND) (ND = half of hd's tiles
    in its bound of 12 or 16); the merge takes the max over all four warps,
    the denominator from warps 0 and 1 (2 and 3 repeat them) and each dim
    from the two warps of its half."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    nd = (12 if hd <= 192 else 16) // 2
    f32 = torch.float32
    out = torch.zeros((B, H, hd))
    for b in range(B):
        n = min(int(kv_len[b]), S)
        lo = max(0, n - window) if window else 0
        for h in range(KV):
            qg = q[b, h * G:(h + 1) * G].to(f32)
            kt, vt = k[b, :, h].to(f32), v[b, :, h].to(f32)
            m = torch.full((4, G), float("-inf"))
            l = torch.zeros((4, G))
            acc = torch.zeros((4, G, hd))
            for c0 in range(lo, n, 32):
                for w in range(4):
                    ph, dh = w & 1, w >> 1
                    p0, p1 = c0 + 16 * ph, min(c0 + 16 * ph + 16, n)
                    if p0 >= p1:
                        continue
                    sc = (qg @ kt[p0:p1].T) * hd ** -0.5
                    mx = torch.maximum(m[w], sc.amax(-1))
                    alpha = torch.exp(m[w] - mx)
                    p = torch.exp(sc - mx[:, None])
                    l[w] = l[w] * alpha + p.sum(-1)
                    d0, d1 = 16 * nd * dh, min(16 * nd * (dh + 1), hd)
                    acc[w] *= alpha[:, None]
                    acc[w, :, d0:d1] += p.to(q.dtype).to(f32) @ vt[p0:p1,
                                                                   d0:d1]
                    m[w] = mx
            mm = m.clamp_min(NEG_INF)
            f = torch.exp(mm - mm.amax(0))
            den = torch.clamp_min((l[:2] * f[:2]).sum(0), 1e-30)
            o = torch.zeros((G, hd))
            for dh in range(2):
                d0, d1 = 16 * nd * dh, min(16 * nd * (dh + 1), hd)
                o[:, d0:d1] = (acc[2 * dh:2 * dh + 2, :, d0:d1] *
                               f[2 * dh:2 * dh + 2, :, None]).sum(0)
            out[b, h * G:(h + 1) * G] = o / den[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("B,H,KV,hd,S,window", [
    (3, 12, 1, 192, 100, 0), (2, 6, 2, 200, 77, 0), (3, 4, 2, 256, 130, 40),
    (2, 16, 1, 144, 65, 0)])
def test_decode_halves_equal_the_plain_version(B, H, KV, hd, S, window):
    """The tensor-core decode route's split of hd between warp pairs
    (above hd 128) against ``decode_attention_ref`` in bf16, kv_len at 1,
    33, a chunk's edge and S, NaN past kv_len and before the window: each
    half of hd merged from its own two warps, the denominator counted
    once."""
    rng = np.random.default_rng(hd + S)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        torch.bfloat16) for s in ((B, H, hd), (B, S, KV, hd),
                                  (B, S, KV, hd)))
    kv_len = torch.tensor([1, 33, 64, S][-B:], dtype=torch.int32)
    for b in range(B):
        n = int(kv_len[b])
        k[b, n:], v[b, n:] = float("nan"), float("nan")
        if window:
            k[b, :max(0, n - window)] = float("nan")
            v[b, :max(0, n - window)] = float("nan")
    got = decode_halves(q, k, v, kv_len, window)
    want = decode_attention_ref(q, k, v, kv_len, window=window)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[
        "bfloat16"], rtol=TOL["bfloat16"])
    assert float((got.float() - want.float()).abs().max()) <= \
        2.0 ** -6 * float(want.float().abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,hd,S,window", [
    (3, 8, 2, 16, 64, 8), (2, 24, 2, 32, 100, 1), (2, 32, 2, 16, 130, 64),
    (3, 10, 2, 32, 300, 100)])
def test_decode_window_plain_equals_gqa_attention(B, H, KV, hd, S, window,
                                                  dtype):
    """``decode_attention_ref(window=)`` against the reference's
    ``models.attention.gqa_attention`` (the XLA path of its models'
    decode: the query at position ``kv_len - 1``, ``window`` and
    ``kv_len`` masks), with kv_len before, at and past the window and at
    S; G = 4, 12, 16 and 5."""
    rng = np.random.default_rng(B * 7 + S + window)
    (qj, qt), (kj, kt), (vj, vt) = (
        _both(rng, s, dtype) for s in ((B, H, hd), (B, S, KV, hd),
                                       (B, S, KV, hd)))
    kv_len = np.array([max(1, window - 1), window + 1, S][:B], np.int32)
    if B == 3:
        kv_len[0] = window
    want = gqa_attention(qj[:, None], kj, vj,
                         q_positions=jnp.asarray(kv_len - 1)[:, None],
                         k_positions=jnp.arange(S)[None, :], causal=True,
                         window=window, kv_len=jnp.asarray(kv_len))[:, 0]
    got = decode_attention_ref(qt, kt, vt, torch.from_numpy(kv_len),
                               window=window)
    _assert_close(got, want, dtype)
    whole = decode_attention_ref(qt, kt, vt, torch.from_numpy(kv_len))
    assert not torch.equal(got, whole)      # the window binds


@pytest.mark.parametrize("act", ["silu_glu", "gelu_glu", "gelu", "relu2"])
def test_mlp_activation_equals_the_reference(act):
    """``_act`` against the reference's ``models.moe._act``: GELU in its
    tanh form (``jax.nn.gelu``'s default), relu^2 ignoring the gate."""
    rng = np.random.default_rng(11)
    gate, up = (rng.standard_normal((3, 40)).astype(np.float32) * 3
                for _ in range(2))
    cfg = dataclasses.replace(ref_reduced("qwen2.5-14b"), mlp_act=act)
    want = np.asarray(ref_act(cfg, jnp.asarray(gate), jnp.asarray(up)))
    got = _act(cfg, torch.from_numpy(gate), torch.from_numpy(up)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    if act == "gelu":
        erf = torch.nn.functional.gelu(torch.from_numpy(up)).numpy()
        assert np.abs(erf - want).max() > 1e-4   # not PyTorch's default
