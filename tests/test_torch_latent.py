"""The tensor-core route of the absorbed MLA's latent attention
(``csrc/latent_attention_sm90.cu``) on the CPU: its route and grid as pure
functions (``ops.latent_route``, ``ops.latent_tiles``, ``ops.latent_splits``,
``ops.latent_split_range``), and its arithmetic emulated in plain torch
(``latent_tc_emulation``) against the port's plain version
(``latent_attention_ref``) and the reference's own call, the JAX package's
``gqa_attention`` with the latent as one kv head (as
``repro.models.attention.mla_attention_block`` calls it when absorbed).

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Inputs are numpy draws from a seed, rounded to bf16 by each framework
(both round to nearest even).  Tolerance: the kernels' bf16 one, 2e-2 atol
and rtol and 2^-6 of max |plain| (the one numeric change from the plain
version is P rounded to bf16 before P . V, about 2^-9 of each p)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import gqa_attention
from repro_torch.kernels import ops
from repro_torch.kernels.attention import latent_attention_ref

TOL = 2e-2
REL = 2.0 ** -6
LOG2E = 1.4426950408889634
SCALE = 192 ** -0.5          # deepseek-v2-lite-16b's (hd + r) ** -0.5


@pytest.mark.parametrize("dtype,H,D,hd_v,route", [
    (torch.bfloat16, 16, 576, 512, "tc"), (torch.bfloat16, 4, 48, 32, "tc"),
    (torch.bfloat16, 5, 40, 40, "tc"), (torch.bfloat16, 16, 576, 500, "simt"),
    (torch.bfloat16, 16, 572, 512, "simt"), (torch.bfloat16, 1, 8, 8, "tc"),
    (torch.float32, 16, 576, 512, "simt"), (torch.float32, 4, 48, 32, "simt"),
    (torch.float16, 16, 576, 512, "simt")])
def test_latent_route_is_decided_by_dtype_and_widths(dtype, H, D, hd_v,
                                                     route):
    assert ops.latent_route(dtype, H, D, hd_v) == route


@pytest.mark.parametrize("Sq,H,tiles", [(1, 16, 1), (4, 16, 1), (5, 16, 2),
                                        (128, 16, 32), (93, 16, 24),
                                        (37, 4, 3), (1, 5, 1), (13, 5, 2),
                                        (64, 1, 1), (65, 1, 2)])
def test_latent_tiles_pack_positions_by_heads(Sq, H, tiles):
    assert ops.latent_tiles(Sq, H) == tiles
    # a tile's rows: 64 // H whole positions of H heads, at most 64
    assert (ops.LATENT_TILE_ROWS // H) * H <= ops.LATENT_TILE_ROWS


# clusters of 2, 4 and 8 CTAs of the kernel an NVIDIA H100 80GB HBM3 held
# at once (cudaOccupancyMaxActiveClusters on the card; PERF.md)
GPC_CLUSTERS = {2: 66, 4: 30, 8: 15}


@pytest.mark.parametrize("clusters", [None, GPC_CLUSTERS])
@pytest.mark.parametrize("B,n_tiles,Sk", [
    (4, 1, 1024), (1, 32, 1024), (1, 24, 1024), (1, 1, 1024), (8, 1, 1024),
    (64, 1, 1024), (1, 1, 64), (1, 1, 1), (3, 1, 50), (2, 3, 64),
    (1, 1, 1 << 16), (200, 4, 4096), (1, 2, 130), (1, 24, 221), (2, 1, 1)])
def test_latent_splits_one_wave_of_clusters_and_none_past_the_cache(
        B, n_tiles, Sk, clusters):
    n_sm = 132
    n = ops.latent_splits(B, n_tiles, Sk, n_sm, clusters)
    assert 1 <= n <= ops.LATENT_SPLIT_MAX
    # one CTA an SM: a wave holds the whole grid whenever it splits
    assert n == 1 or n * B * n_tiles <= n_sm
    kt = -(-Sk // ops.LATENT_KEY_TILE)
    if kt < ops.LATENT_SPLIT_FROM_TILES:
        assert n == 1
    # none past the cache: at full visibility every split reads keys
    ranges = [ops.latent_split_range(Sk, n, s) for s in range(n)]
    assert all(a < b for a, b in ranges) or Sk == 0
    assert ranges[0][0] == 0 and ranges[-1][1] == Sk


@pytest.mark.parametrize("B,n_tiles,Sk,n,n_gpc", [
    (4, 1, 1024, 8, 8), (1, 32, 1024, 4, 2), (1, 24, 1024, 4, 4),
    (1, 24, 221, 4, 4), (1, 32, 128, 1, 1), (1, 1, 1024, 8, 8),
    (1, 1, 64, 1, 1), (64, 1, 1024, 2, 2), (200, 1, 1024, 1, 1),
    (16, 1, 1024, 8, 4)])
def test_latent_splits_at_the_served_shapes(B, n_tiles, Sk, n, n_gpc):
    """deepseek's decode at 4 slots (a cache of 1024), its prefill chunks
    of 128 and 93 queries (32 and 24 tiles) against a cache of 1024, of
    221 and of 128 (a prefill from 0 reads only its own latents), one slot,
    a short cache and wide batches; on an ideal card and on one whose GPCs
    hold fewer clusters of 4 and 8 (``GPC_CLUSTERS``)."""
    assert ops.latent_splits(B, n_tiles, Sk, 132) == n
    assert ops.latent_splits(B, n_tiles, Sk, 132, GPC_CLUSTERS) == n_gpc


@pytest.mark.parametrize("visible", [0, 1, 63, 64, 65, 128, 221, 700, 1024])
@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 8, 33])
def test_latent_split_range_covers_the_visible_keys(visible, n_split):
    """Consecutive, disjoint, whole key tiles (but the last), covering [0,
    visible); the empty splits all come after the last that reads keys,
    and only where the visible key tiles run out."""
    ranges = [ops.latent_split_range(visible, n_split, s)
              for s in range(n_split)]
    pos = 0
    for a, b in ranges:
        assert a == pos and b >= a
        assert a == visible or a % ops.LATENT_KEY_TILE == 0
        assert b == visible or b % ops.LATENT_KEY_TILE == 0
        pos = b
    assert pos == visible
    full = [b > a for a, b in ranges]
    n_kt = -(-visible // ops.LATENT_KEY_TILE)
    assert full == sorted(full, reverse=True)
    assert sum(full) == (-(-n_kt // -(-n_kt // n_split)) if n_kt else 0)


def latent_tc_emulation(q, lat, kv_len, q_offset, hd_v, scale, n_split):
    """The tensor-core latent kernel's arithmetic with plain torch ops: per
    batch row, tiles of ``64 // H`` positions x H heads (row r: position
    i0 + r // H, head r % H); the tile's visible keys [0, min(kv_len, last
    position + 1)) split by ``ops.latent_split_range``; each split walks
    64-key tiles (rows past kv_len zeroed, rows past Sk zero), masks per row
    (key < the split's end and key <= the row's position), keeps a running
    softmax in fp32 with the scale folded into exp2, rounds P to bf16 for
    P . V (V the tile's first hd_v columns); one split writes acc / max(l,
    1e-30), more are merged with weights 2^((m_s - M) scale log2 e), 0 for
    a split whose row saw no key."""
    B, Sq, H, D = q.shape
    Sk = lat.shape[1]
    kb = ops.LATENT_KEY_TILE
    P = ops.LATENT_TILE_ROWS // H
    sl2 = scale * LOG2E
    qf, lf = q.float(), lat.float()
    out = torch.zeros((B, Sq, H, hd_v))
    inf = float("inf")
    for b in range(B):
        off = int(q_offset[b])
        klen = Sk if kv_len is None else max(0, min(int(kv_len[b]), Sk))
        for t in range(ops.latent_tiles(Sq, H)):
            i0 = t * P
            n_pos = min(P, Sq - i0)
            rows = n_pos * H
            qt = qf[b, i0:i0 + n_pos].reshape(rows, D)
            qpos = off + i0 + torch.arange(rows) // H
            vis = max(0, min(klen, off + i0 + n_pos))
            parts = []
            for s in range(n_split):
                ks, ke = ops.latent_split_range(vis, n_split, s)
                m = torch.full((rows,), -inf)
                l = torch.zeros(rows)
                acc = torch.zeros((rows, hd_v))
                for k0 in range(ks, ke, kb):
                    kt = torch.zeros((kb, D))
                    n = max(0, min(kb, klen - k0))
                    kt[:n] = lf[b, k0:k0 + n]
                    sc = qt @ kt.T
                    kpos = k0 + torch.arange(kb)
                    ok = (kpos[None] < ke) & (kpos[None] <= qpos[:, None])
                    sc = torch.where(ok, sc, -inf)
                    mx = torch.maximum(m, sc.amax(1))
                    bm = torch.where(mx == -inf, 0.0, mx * sl2)
                    alpha = torch.exp2(m * sl2 - bm)
                    p = torch.exp2(sc * sl2 - bm[:, None])
                    l = l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + \
                        p.to(torch.bfloat16).float() @ kt[:, :hd_v]
                    m = mx
                parts.append((m, l, acc))
            if n_split == 1:
                o = acc / torch.clamp_min(l, 1e-30)[:, None]
            else:
                ms = torch.stack([p_[0] for p_ in parts])
                top = ms.amax(0)
                w = torch.where(ms == -inf, 0.0,
                                torch.exp2((ms - top) * sl2))
                den = torch.clamp_min(
                    sum(w[s] * parts[s][1] for s in range(n_split)), 1e-30)
                o = sum(w[s][:, None] * parts[s][2]
                        for s in range(n_split)) / den[:, None]
            out[b, i0:i0 + n_pos] = o.reshape(n_pos, H, hd_v)
    return out.to(q.dtype)


# (B, Sq, Sk, H, D, hd_v, offsets, kv_len): deepseek-v2-lite-16b's decode
# at per-slot depths (one slot's keys in one split: the others empty; a key
# tile straddling kv_len), its prefill chunks 0+128 and 128+93 (Sq not a
# multiple of 4 positions), H 4 and H 5 (a tile not filled by whole
# positions), per-row offsets with kv_len below a tile, a row with no key
LATENT_TC_CASES = [
    (4, 1, 1024, 16, 576, 512, [63, 64, 700, 1023], [64, 65, 701, 1024]),
    (1, 128, 1024, 16, 576, 512, [0], [128]),
    (1, 93, 1024, 16, 576, 512, [128], [221]),
    (2, 37, 64, 4, 48, 32, [0, 20], [37, 57]),
    (3, 13, 150, 5, 40, 40, [9, 0, 120], [22, 1, 133]),
    (2, 8, 200, 16, 64, 64, [10, 30], [12, 20]),
    (2, 4, 64, 8, 32, 16, [0, 5], [0, 9])]


def _bf16_draws(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("n_split", [None, 1, 3])
@pytest.mark.parametrize("case", range(len(LATENT_TC_CASES)))
def test_latent_tc_emulation_equals_plain_and_reference(case, n_split):
    """The emulated kernel (at ``latent_splits``' count, at one split and
    at three) against ``latent_attention_ref`` (NaN latent rows past each
    kv_len) and the reference's ``gqa_attention`` over the same latents
    (finite past kv_len: its P . V multiplies them by 0), bf16."""
    B, Sq, Sk, H, D, hd_v, offs, lens = LATENT_TC_CASES[case]
    rng = np.random.default_rng(case + 29)
    qn, ln = _bf16_draws(rng, (B, Sq, H, D), (B, Sk, D))
    q = torch.from_numpy(qn).to(torch.bfloat16)
    lat = torch.from_numpy(ln).to(torch.bfloat16)
    off = torch.tensor(offs, dtype=torch.int32)
    kv_len = torch.tensor(lens, dtype=torch.int32)
    if n_split is None:
        n_split = ops.latent_splits(B, ops.latent_tiles(Sq, H), Sk, 132)
    nan_lat = lat.clone()
    for b, n in enumerate(lens):
        nan_lat[b, n:] = float("nan")
    got = latent_tc_emulation(q, nan_lat, kv_len, off, hd_v, SCALE, n_split)
    want = latent_attention_ref(q, nan_lat, kv_len, q_offset=off, hd_v=hd_v,
                                scale=SCALE)
    assert got.shape == (B, Sq, H, hd_v) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    g, w = got.float(), want.float()
    torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)
    assert float((g - w).abs().max()) <= REL * float(w.abs().max())
    pos = np.asarray(offs, np.int32)[:, None] + np.arange(Sq, dtype=np.int32)
    lat_j = jnp.asarray(ln, jnp.bfloat16)
    ref = gqa_attention(jnp.asarray(qn, jnp.bfloat16), lat_j[:, :, None, :],
                        lat_j[:, :, None, :hd_v], q_positions=jnp.asarray(pos),
                        k_positions=jnp.arange(Sk)[None, :], causal=True,
                        window=0, kv_len=jnp.asarray(lens, jnp.int32),
                        scale=SCALE)
    r = torch.from_numpy(np.asarray(ref, np.float32))
    # a row that sees no key: zeros here and in the plain version; the
    # reference's softmax over its all-masked scores averages V instead
    seen = torch.tensor(lens) > 0
    torch.testing.assert_close(g[seen], r[seen], atol=TOL, rtol=TOL)
    assert float((g - r)[seen].abs().max()) <= REL * float(r.abs().max())
    assert not bool(got[~seen].float().any())


def test_latent_tc_emulation_rounds_p_as_the_kernel_does():
    """The emulation is not the plain version in disguise: P in bf16 moves
    the output off the fp32-P result, by about 2^-9 of each p."""
    rng = np.random.default_rng(5)
    qn, ln = _bf16_draws(rng, (1, 8, 16, 576), (1, 300, 576))
    q = torch.from_numpy(qn).to(torch.bfloat16)
    lat = torch.from_numpy(ln).to(torch.bfloat16)
    off = torch.tensor([200], dtype=torch.int32)
    got = latent_tc_emulation(q, lat, None, off, 512, SCALE, 2).float()
    want = latent_attention_ref(q.float(), lat.float(), q_offset=off,
                                hd_v=512, scale=SCALE)
    err = float((got - want).abs().max())
    assert 0 < err <= REL * float(want.abs().max())
    assert math.isfinite(err)
