"""RWKV6's chunked linear attention in the port (``repro_torch.kernels.
rwkv6``, ``kernels.ops.rwkv6_chunked``, ``models.linear_scan``) against the
JAX package's: the plain version equals the interpret-mode Pallas kernel
``rwkv6_chunked``, the sequential ``ref.rwkv6_ref`` and the model's XLA
path ``chunked_linear_attention`` within 1e-4 (atol and rtol, the JAX
kernel test's tolerance: the sums run in another order), on the JAX kernel
test's shapes, at lengths that are not a multiple of the chunk and at the
reduced configuration's chunk of 8.  Inputs are drawn with numpy and
handed to both packages.

``rwkv_reference_tree`` is the JAX package's reduced rwkv6 parameters with
the token-shift mixes, decay base, bonus and group-norm scale drawn
nonzero (the template has them at zero or one); the model and serving
tests use it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.kernels.rwkv6_scan import LOG_DECAY_MIN as REF_LOG_DECAY_MIN
from repro.models import linear_scan as ref_scan
from repro.models import params as ref_params
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6 import LOG_DECAY_MIN, rwkv6_chunked_ref
from repro_torch.models import linear_scan

TOL = 1e-4
KERNEL_SHAPES = [(2, 64, 2, 16, 16), (1, 48, 4, 32, 64), (2, 16, 1, 8, 8),
                 (1, 128, 2, 64, 64)]   # tests/test_kernels.py::test_rwkv6


def rwkv_reference_tree(ref_cfg, seed: int = 1):
    """The JAX package's fp32 parameters of ``ref_cfg`` (numpy leaves) with
    every mix, ``decay_base``, ``bonus_u`` and ``gn_scale`` drawn from
    ``seed``, so that the token shifts, the decay's base and the bonus are
    live."""
    tree = jax.tree.map(np.asarray, ref_params.init_params(
        jax.random.PRNGKey(0), ref_cfg, dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    lay = tree["layers"]
    for name in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "mix_f"):
        lay[name] = rng.uniform(0, 1, lay[name].shape).astype(np.float32)
    for name, scale, mean in (("decay_base", 0.5, 0.0),
                              ("bonus_u", 0.5, 0.0),
                              ("gn_scale", 0.2, 1.0)):
        lay[name] = (mean + scale * rng.standard_normal(
            lay[name].shape)).astype(np.float32)
    return tree


def _inputs(B, S, H, K, V, seed=0):
    """The JAX kernel test's distributions: r, v normal, k half as wide,
    log-decay -exp(normal) (some steps below the clip), u 0.1 normal."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, S, H, K)).astype(np.float32)
    k = (0.5 * rng.standard_normal((B, S, H, K))).astype(np.float32)
    v = rng.standard_normal((B, S, H, V)).astype(np.float32)
    lw = (-np.exp(rng.standard_normal((B, S, H, K)))).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, K))).astype(np.float32)
    return r, k, v, lw, u


def _port(arrs, chunk):
    return rwkv6_chunked_ref(*(torch.from_numpy(a) for a in arrs),
                             chunk=chunk)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


def test_log_decay_clip_equals_reference():
    assert LOG_DECAY_MIN == REF_LOG_DECAY_MIN == ref_scan.LOG_DECAY_MIN


@pytest.mark.parametrize("B,S,H,K,V", KERNEL_SHAPES)
def test_plain_equals_interpret_mode_kernel(B, S, H, K, V):
    arrs = _inputs(B, S, H, K, V)
    y, st = _port(arrs, 16)
    assert y.dtype == st.dtype == torch.float32
    assert tuple(y.shape) == (B, S, H, V) and tuple(st.shape) == (B, H, K, V)
    j = [jnp.asarray(a) for a in arrs]
    y1, s1 = ref_ops.rwkv6(*j, impl="pallas_interpret")
    y2, s2 = ref_kernels.rwkv6_ref(*j[:3], jnp.clip(j[3], -4.0, 0.0), j[4])
    y3, s3 = ref_scan.chunked_linear_attention(*j[:4], u=j[4], chunk=16)
    for want_y, want_s in ((y1, s1), (y2, s2), (y3, s3)):
        _close(y, want_y)
        _close(st, want_s)


@pytest.mark.parametrize("S", [50, 17, 5, 1])
def test_plain_pads_a_ragged_length_with_identity_rows(S):
    """S not a multiple of the chunk: y and the final state equal the
    sequential recurrence over the S real steps (padding that moved the
    state would show in it) and the XLA path, which pads too."""
    arrs = _inputs(2, S, 2, 16, 16, seed=S)
    y, st = _port(arrs, 16)
    j = [jnp.asarray(a) for a in arrs]
    y2, s2 = ref_kernels.rwkv6_ref(*j[:3], jnp.clip(j[3], -4.0, 0.0), j[4])
    y3, s3 = ref_scan.chunked_linear_attention(*j[:4], u=j[4], chunk=16)
    for want_y, want_s in ((y2, s2), (y3, s3)):
        _close(y, want_y)
        _close(st, want_s)


@pytest.mark.parametrize("S", [64, 20])
def test_plain_at_the_reduced_chunk(S):
    """The reduced configuration's chunk of 8 (``scan_chunk``): against the
    interpret-mode kernel where S is a multiple of it, and the sequential
    recurrence always."""
    arrs = _inputs(2, S, 4, 16, 16, seed=3)
    y, st = _port(arrs, 8)
    j = [jnp.asarray(a) for a in arrs]
    y2, s2 = ref_kernels.rwkv6_ref(*j[:3], jnp.clip(j[3], -4.0, 0.0), j[4])
    _close(y, y2)
    _close(st, s2)
    if S % 8 == 0:
        y1, s1 = ref_ops.rwkv6(*j, chunk=8, impl="pallas_interpret")
        _close(y, y1)
        _close(st, s1)


def test_plain_takes_bf16_inputs_as_fp32():
    """bf16 r, k, v are widened to fp32 first: the same as the fp32 call on
    the rounded values."""
    arrs = _inputs(1, 32, 2, 16, 16)
    t = [torch.from_numpy(a) for a in arrs]
    bf = [x.to(torch.bfloat16) for x in t[:3]]
    y, st = rwkv6_chunked_ref(*bf, t[3], t[4])
    y32, st32 = rwkv6_chunked_ref(*(x.float() for x in bf), t[3], t[4])
    assert y.dtype == torch.float32
    assert torch.equal(y, y32) and torch.equal(st, st32)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: half of the low 13 bits' range is
    added to the float32 pattern, then those bits are cleared."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b with each operand split into TF32 hi + lo parts and the three
    products a_hi b_lo + a_lo b_hi + a_hi b_hi summed in fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def _mm_tf32(a, b):
    """a @ b with both operands rounded to TF32 once."""
    return _tf32(a) @ _tf32(b)


def _kernel_products(r, k, v, logw, u, mm, chunk=16):
    """``rwkv6_chunked_ref``'s chunked form with the CUDA kernel's three
    products done by ``mm``: the pair matrix r_dec k_idec^T (the bonus
    then on its diagonal), y = A v + r_dec S_{n-1}, and U_n = k_dec^T v;
    the rest (decays, the state's recurrence) in fp32."""
    B, S, H, K = k.shape
    V = v.shape[-1]
    f32 = torch.float32
    r, k, v, u = (t.to(f32) for t in (r, k, v, u))
    lw = logw.to(f32).clamp(LOG_DECAY_MIN, 0.0)
    pad = (-S) % chunk   # identity rows at the tail, as the kernel reads
    N = (S + pad) // chunk

    def lay(t):   # (B, S, H, F) -> (B, H, N, L, F)
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
        return t.reshape(B, N, chunk, H, t.shape[-1]).permute(0, 3, 1, 2, 4)

    r, k, v, lw = lay(r), lay(k), lay(v), lay(lw)
    cum = torch.cumsum(lw, dim=3)
    tot = cum[:, :, :, -1:]
    r_dec = r * torch.exp(cum - lw)
    k_idec = k * torch.exp(-cum)
    k_dec = k * torch.exp(tot - cum)
    below = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool),
                       diagonal=-1)
    bonus = (r * u[None, :, None, None, :] * k).sum(-1)
    A = torch.where(below, mm(r_dec, k_idec.transpose(-1, -2)), 0.0) + \
        torch.diag_embed(bonus)
    upd = mm(k_dec.transpose(-1, -2), v)
    decay = torch.exp(tot[:, :, :, 0])[..., None]
    state = torch.zeros((B, H, K, V), dtype=f32)
    ys = []
    for n in range(N):
        # A v + r_dec S in one accumulation, as the kernel's mma chain does
        ys.append(mm(torch.cat([A[:, :, n], r_dec[:, :, n]], dim=-1),
                     torch.cat([v[:, :, n], state], dim=-2)))
        state = decay[:, :, n] * state + upd[:, :, n]
    y = torch.stack(ys, dim=2).permute(0, 2, 3, 1, 4).reshape(B, N * chunk, H,
                                                              V)
    return y[:, :S], state


def test_3xtf32_products_hold_the_tolerance_and_single_tf32_does_not():
    """The CUDA kernel's precision scheme, emulated on the CPU (the card is
    absent here): its three products in TF32 on the tensor cores.  At the
    serving path's K = V = 64, chunk 16 and bf16 r, k, v (B 1, S 511; H cut
    from 32 to 4 for time), with the kernel tests' input distributions,
    y and the final state are held to ``rwkv6_chunked_ref`` within
    ``chip_smoke.RWKV_TOL`` = 1e-4 atol and rtol, the tolerance the CUDA
    kernel is held to on the card (the JAX kernel test's).  The 3xTF32
    split keeps ~21 bits of each operand (a relative error near 1e-6 a
    product, sums of up to 64 channels and 16 rows on top) and holds it;
    one pass of TF32 keeps 11 bits (~5e-4 a product) and misses it, which
    is why the kernel pays for the split."""
    arrs = [torch.from_numpy(a) for a in _inputs(1, 511, 4, 64, 64, seed=19)]
    r, k, v = (t.to(torch.bfloat16) for t in arrs[:3])
    want_y, want_st = rwkv6_chunked_ref(r, k, v, arrs[3], arrs[4])

    def misses(got, want):
        return int((got - want).abs().gt(TOL + TOL * want.abs()).sum())

    y3, st3 = _kernel_products(r, k, v, arrs[3], arrs[4], _mm_3xtf32)
    assert misses(y3, want_y) == 0 and misses(st3, want_st) == 0
    y1, st1 = _kernel_products(r, k, v, arrs[3], arrs[4], _mm_tf32)
    assert misses(y1, want_y) > y1.numel() // 10


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 1.0, 3.0])
    assert torch.equal(_tf32(x), want)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    t = [torch.from_numpy(a) for a in _inputs(2, 40, 2, 16, 16)]
    n0 = sum(ops.launches.values())
    y, st = ops.rwkv6_chunked(*t, chunk=16)
    want_y, want_st = rwkv6_chunked_ref(*t, chunk=16)
    assert torch.equal(y, want_y) and torch.equal(st, want_st)
    assert sum(ops.launches.values()) == n0


def test_wrapper_has_no_kernel_for_another_device():
    t = [torch.zeros(s, device="meta") for s in
         ((1, 16, 2, 8), (1, 16, 2, 8), (1, 16, 2, 8), (1, 16, 2, 8),
          (2, 8))]
    with pytest.raises(ValueError, match="no kernel for meta"):
        ops.rwkv6_chunked(*t)


@pytest.mark.parametrize("post_update", [False, True])
@pytest.mark.parametrize("bonus", [False, True])
def test_linear_attention_step_equals_reference(post_update, bonus):
    rng = np.random.default_rng(7)
    B, H, K, V = 3, 4, 16, 8
    r, k, logw = (rng.standard_normal((B, H, K)).astype(np.float32)
                  for _ in range(3))
    logw = -np.exp(logw).astype(np.float32)
    v = rng.standard_normal((B, H, V)).astype(np.float32)
    state = rng.standard_normal((B, H, K, V)).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32) if bonus else None
    want = ref_scan.linear_attention_step(
        *(jnp.asarray(a) for a in (r, k, v, logw, state)),
        u=None if u is None else jnp.asarray(u), post_update=post_update)
    got = linear_scan.linear_attention_step(
        *(torch.from_numpy(a) for a in (r, k, v, logw, state)),
        u=None if u is None else torch.from_numpy(u),
        post_update=post_update)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("S,chunk", [(64, 16), (37, 16), (24, 8)])
def test_chunked_linear_attention_equals_reference(S, chunk):
    """The port's RWKV6 case (through ``ops.rwkv6_chunked``, the plain
    version on the CPU) against the JAX package's XLA path."""
    arrs = _inputs(2, S, 2, 16, 16, seed=S)
    j = [jnp.asarray(a) for a in arrs]
    want_y, want_s = ref_scan.chunked_linear_attention(*j[:4], u=j[4],
                                                       chunk=chunk)
    t = [torch.from_numpy(a) for a in arrs]
    y, st = linear_scan.chunked_linear_attention(*t[:4], u=t[4],
                                                 chunk=chunk)
    _close(y, want_y)
    _close(st, want_s)


@pytest.mark.parametrize("case", ["ssd", "initial_state", "no_bonus"])
def test_chunked_linear_attention_refuses_what_the_port_does_not_run(case):
    """Named when the port refused them: the three cases, now held to the
    JAX package's XLA path (through ``ops.rwkv6_chunked``, the plain
    version on the CPU): the SSD's post-update output without a bonus,
    RWKV6 from a random carried state, and RWKV6 without its bonus; ragged
    S 37, chunk 16."""
    arrs = _inputs(2, 37, 2, 16, 16, seed=11)
    s0 = np.random.default_rng(12).standard_normal((2, 2, 16, 16)).astype(
        np.float32)
    kw = {"u": arrs[4]}
    if case == "ssd":
        kw = {"post_update": True}
    elif case == "initial_state":
        kw["initial_state"] = s0
    else:
        kw = {}
    j = [jnp.asarray(a) for a in arrs[:4]]
    want_y, want_s = ref_scan.chunked_linear_attention(
        *j, chunk=16, **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                         else v for k, v in kw.items()})
    t = [torch.from_numpy(a) for a in arrs[:4]]
    y, st = linear_scan.chunked_linear_attention(
        *t, chunk=16, **{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                         else v for k, v in kw.items()})
    _close(y, want_y)
    _close(st, want_s)


def test_reference_tree_makes_the_zero_initialised_leaves_live():
    from repro.configs import get_reduced_config as ref_reduced
    cfg = dataclasses.replace(ref_reduced("rwkv6-1.6b"), dtype="float32")
    tree = rwkv_reference_tree(cfg)
    lay = tree["layers"]
    for name in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "mix_f",
                 "decay_base", "bonus_u"):
        assert np.abs(lay[name]).max() > 0.1, name
    assert np.abs(lay["gn_scale"] - 1).max() > 0.1
