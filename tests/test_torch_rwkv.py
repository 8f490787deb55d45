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
    t = [torch.from_numpy(a) for a in _inputs(1, 16, 2, 8, 8)]
    kw = {"u": t[4]}
    if case == "ssd":
        kw["post_update"] = True
    elif case == "initial_state":
        kw["initial_state"] = torch.zeros((1, 2, 8, 8))
    else:
        kw = {}
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
        linear_scan.chunked_linear_attention(*t[:4], **kw)


def test_reference_tree_makes_the_zero_initialised_leaves_live():
    from repro.configs import get_reduced_config as ref_reduced
    cfg = dataclasses.replace(ref_reduced("rwkv6-1.6b"), dtype="float32")
    tree = rwkv_reference_tree(cfg)
    lay = tree["layers"]
    for name in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "mix_f",
                 "decay_base", "bonus_u"):
        assert np.abs(lay[name]).max() > 0.1, name
    assert np.abs(lay["gn_scale"] - 1).max() > 0.1
