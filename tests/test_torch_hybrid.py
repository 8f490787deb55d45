"""Hymba-1.5b in the port (``repro_torch.configs.hymba_1_5b``, the SSD
branch of ``models.transformer``, the post-update variant of
``kernels.rwkv6.rwkv6_chunked_ref`` and a carried initial state) against
the JAX package's.

The configurations equal the reference's field for field, the template its
leaves and shapes.  The plain SSD equals the JAX package's XLA
``chunked_linear_attention(post_update=True)`` within 2e-5 atol and rtol
(fp32; the sums run in another order, and each of the two is ~1e-5 from a
float64 recurrence at outputs of ~20): ragged lengths, chunks of 8 and 16,
hymba's K 16 with V 64, the clip at ``LOG_DECAY_MIN`` binding, a random
initial state.  The reduced hymba in fp32, the JAX package's own
``init_params`` tree with ``A_log``, ``dt_bias``, ``ssm_D`` and the norm
scales drawn live (the template has them at 0 or 1, where a wrong sign
would not show), carried across by ``params_from_reference``: ``_ssm_branch``,
``forward`` in train, prefill and decode modes (window 8 binding on the
local layers) and a replica engine of fresh slots give the same logits
within 1e-4 of max |logit|.  A reused slot starts afresh in the port where
the reference carries the previous request's SSM state.  RWKV6's chunked
prefill (more tokens at a nonzero position, the state carried) equals the
reference's ``forward``."""
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced_config as ref_reduced
from repro.launch.serve import serve_real as ref_serve_real
from repro.models import linear_scan as ref_scan
from repro.models import params as ref_params
from repro.models import transformer as ref_tf
from repro.serving.engine import ReplicaEngine as RefEngine
from repro.serving.scheduler import Request as RefRequest
from repro_torch.configs import ARCHS, get_config, get_reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6 import LOG_DECAY_MIN, rwkv6_chunked_ref
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve_real
from repro_torch.models import linear_scan
from repro_torch.models import params as P_
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import ReplicaEngine

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (REF_SERVE_STATS, serving_requests)

ARCH = "hymba-1.5b"
REL_TOL = 1e-4
SSD_TOL = 2e-5
PROMPT = 20


@functools.lru_cache(maxsize=None)
def _ref_fn(ref_cfg, mode):
    """The reference's ``forward`` in ``mode``, jitted once a configuration
    (its decode steps then share one compile)."""
    return jax.jit(lambda tree, toks, cache, pos: ref_tf.forward(
        tree, ref_cfg, ref_tf.Runtime(), toks, mode=mode, cache=cache,
        cache_pos=pos))


def ref_run(tree, ref_cfg, toks, *, mode, cache=None, cache_pos=None):
    return _ref_fn(ref_cfg, mode)(tree, jnp.asarray(toks), cache, cache_pos)


def _rel(port, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(port.float().numpy() - ref).max()) / \
        float(np.abs(ref).max())


def hymba_reference_tree(ref_cfg, seed: int = 1):
    """The JAX package's fp32 parameters of ``ref_cfg`` (numpy leaves) with
    ``A_log``, ``dt_bias`` and ``ssm_D`` drawn from ``seed`` and every norm
    scale drawn away from 1."""
    tree = jax.tree.map(np.asarray, jax.jit(
        ref_params.init_params, static_argnums=(1, 2))(
            jax.random.PRNGKey(0), ref_cfg, jnp.float32))
    rng = np.random.default_rng(seed)
    lay = tree["layers"]
    for name, scale, mean in (("A_log", 0.5, 0.0), ("dt_bias", 0.5, 0.0),
                              ("ssm_D", 0.5, 1.0)):
        lay[name] = (mean + scale * rng.standard_normal(
            lay[name].shape)).astype(np.float32)
    for name in ("ln1", "ln2", "ssm_norm"):
        lay[name] = (1.0 + 0.2 * rng.standard_normal(
            lay[name].shape)).astype(np.float32)
    tree["final_norm"] = (1.0 + 0.2 * rng.standard_normal(
        tree["final_norm"].shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def model():
    """(reference config, port config, reference tree, port params)."""
    ref_cfg = dataclasses.replace(ref_reduced(ARCH), dtype="float32",
                                  remat=False)
    cfg = dataclasses.replace(get_reduced_config(ARCH), dtype="float32")
    tree = hymba_reference_tree(ref_cfg)
    return ref_cfg, cfg, tree, P_.params_from_reference(tree, cfg,
                                                        device="cpu")


# ------------------------------------------------------------ configuration

def test_configs_equal_the_reference():
    assert ARCHS == REF_ARCHS
    for port, ref in ((get_config(ARCH), ref_get_config(ARCH)),
                      (get_reduced_config(ARCH), ref_reduced(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    cfg = get_config(ARCH)
    assert [i for i in range(cfg.n_layers) if cfg.layer_is_global(i)] == \
        [7, 15, 23, 31]
    assert [i for i in range(cfg.n_layers) if cfg.layer_is_global(i)] == \
        [i for i in range(cfg.n_layers)
         if ref_get_config(ARCH).layer_is_global(i)]
    assert cfg.family == "hybrid" and cfg.ssm and not cfg.rwkv


def test_template_and_param_count_equal_the_reference():
    """The template's leaves and shapes at full width equal the JAX
    template's; ``param_count`` is the reference's 1 299 304 000 (2.60 GB
    in bf16, inside tests/test_models_smoke.py's 1.1-1.8 B)."""
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    assert cfg.param_count() == ref.param_count() == 1_299_304_000
    shapes = P_._finalize(cfg, lambda m, n: ((n,) if n else ()) + m.shape)
    ref_shapes = jax.tree.map(lambda a: tuple(a.shape),
                              ref_params.abstract_params(ref))
    assert shapes == ref_shapes
    assert set(shapes["layers"]) >= {"ws_in", "ws_dt", "dt_bias", "ws_B",
                                     "ws_C", "A_log", "ssm_D", "ssm_norm",
                                     "ws_out"}


def test_init_params_follows_the_reference_template():
    """Zeros for ``A_log`` and ``dt_bias``, ones for ``ssm_D`` and the
    norms, normal weights of std ``1 / sqrt(fan_in)``."""
    cfg = get_reduced_config(ARCH)
    ref = ref_params.init_params(jax.random.PRNGKey(0), ref_reduced(ARCH))
    p = P_.init_params(cfg, seed=3, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), ref) == \
        {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
             if isinstance(v, dict) else tuple(v.shape))
         for k, v in p.items()}
    lay = p["layers"]
    for name in ("A_log", "dt_bias"):
        assert torch.all(lay[name] == 0), name
    for name in ("ssm_D", "ssm_norm", "ln1", "ln2"):
        assert torch.all(lay[name] == 1), name
    assert abs(float(lay["ws_out"].float().std()) *
               np.sqrt(cfg.q_dim) - 1.0) < 0.1


def test_params_from_reference_carries_the_ssm_leaves(model):
    _, cfg, tree, params = model
    assert set(params["layers"]) == set(tree["layers"])
    for k, arr in tree["layers"].items():
        assert params["layers"][k].dtype == torch.float32
        assert np.array_equal(params["layers"][k].numpy(), arr), k
    for name in ("A_log", "dt_bias"):
        assert np.abs(tree["layers"][name]).max() > 0.1, name
    assert np.abs(tree["layers"]["ssm_D"] - 1).max() > 0.1


def test_reference_tree_makes_the_zero_initialised_leaves_live(model):
    ref_cfg, _, tree, _ = model
    plain = ref_params.init_params(jax.random.PRNGKey(0), ref_cfg,
                                   dtype=jnp.float32)
    for name in ("A_log", "dt_bias"):
        assert np.all(np.asarray(plain["layers"][name]) == 0), name
        assert np.all(tree["layers"][name] != 0), name


# --------------------------------------------------------------- the SSD

def _ssd_inputs(B, S, H, K, V, seed, *, clip=False, broadcast=True):
    """C (r), k = B dt, x (v), the decay and an initial state: normal C and
    x, k half as wide; the log-decay one a head broadcast over K (hymba's)
    or per channel, -exp(normal), shifted so that most steps fall below
    the clip at ``LOG_DECAY_MIN`` where ``clip``."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, S, H, K)).astype(np.float32)
    k = (0.5 * rng.standard_normal((B, S, H, K))).astype(np.float32)
    v = rng.standard_normal((B, S, H, V)).astype(np.float32)
    shape = (B, S, H, 1) if broadcast else (B, S, H, K)
    lw = -np.exp(rng.standard_normal(shape) + (2.0 if clip else 0.0))
    lw = np.broadcast_to(lw, (B, S, H, K)).astype(np.float32)
    s0 = rng.standard_normal((B, H, K, V)).astype(np.float32)
    return r, k, v, np.ascontiguousarray(lw), s0


def _close(got, want, tol=SSD_TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,K,V,chunk", [
    (1, 221, 5, 16, 64, 16), (2, 37, 3, 16, 64, 16), (2, 40, 4, 4, 16, 8),
    (1, 19, 4, 4, 16, 8), (2, 64, 2, 16, 16, 16), (1, 5, 2, 16, 64, 16)])
@pytest.mark.parametrize("initial", [False, True])
def test_plain_ssd_equals_the_reference(B, S, H, K, V, chunk, initial):
    """The post-update recurrence without a bonus, from zeros or a random
    state: y and the final state equal the reference's XLA path, and the
    sequential recurrence of ``linear_attention_step`` over the S steps."""
    r, k, v, lw, s0 = _ssd_inputs(B, S, H, K, V, seed=S + K + initial)
    j = [jnp.asarray(a) for a in (r, k, v, lw)]
    want_y, want_s = ref_scan.chunked_linear_attention(
        *j, post_update=True, chunk=chunk,
        initial_state=jnp.asarray(s0) if initial else None)
    t = [torch.from_numpy(a) for a in (r, k, v, lw)]
    s0_t = torch.from_numpy(s0) if initial else None
    y, st = rwkv6_chunked_ref(*t, chunk=chunk, post_update=True,
                              initial_state=s0_t)
    _close(y, want_y)
    _close(st, want_s)
    state = s0_t if initial else torch.zeros((B, H, K, V))
    for i in range(S):
        yi, state = linear_scan.linear_attention_step(
            t[0][:, i], t[1][:, i], t[2][:, i], t[3][:, i], state,
            post_update=True)
        torch.testing.assert_close(y[:, i], yi, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, state, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("broadcast", [True, False])
def test_plain_ssd_with_the_clip_binding(broadcast):
    """Decays mostly below ``LOG_DECAY_MIN``: the clip binds on most steps,
    in both packages alike."""
    r, k, v, lw, s0 = _ssd_inputs(2, 45, 3, 16, 64, seed=5, clip=True,
                                  broadcast=broadcast)
    assert (lw < LOG_DECAY_MIN).mean() > 0.5
    j = [jnp.asarray(a) for a in (r, k, v, lw)]
    want_y, want_s = ref_scan.chunked_linear_attention(
        *j, post_update=True, chunk=16, initial_state=jnp.asarray(s0))
    y, st = rwkv6_chunked_ref(*(torch.from_numpy(a) for a in (r, k, v, lw)),
                              chunk=16, post_update=True,
                              initial_state=torch.from_numpy(s0))
    _close(y, want_y)
    _close(st, want_s)


def test_plain_pre_update_with_an_initial_state_and_a_bonus():
    """RWKV6's case from a carried state (the chunked prefill's) and the
    post-update case with a bonus (the reference's general form)."""
    r, k, v, lw, s0 = _ssd_inputs(2, 50, 2, 16, 16, seed=9, broadcast=False)
    u = (0.1 * np.random.default_rng(2).standard_normal((2, 16))).astype(
        np.float32)
    j = [jnp.asarray(a) for a in (r, k, v, lw)]
    t = [torch.from_numpy(a) for a in (r, k, v, lw)]
    for post in (False, True):
        want_y, want_s = ref_scan.chunked_linear_attention(
            *j, u=jnp.asarray(u), post_update=post, chunk=16,
            initial_state=jnp.asarray(s0))
        y, st = rwkv6_chunked_ref(*t, torch.from_numpy(u), chunk=16,
                                  post_update=post,
                                  initial_state=torch.from_numpy(s0))
        _close(y, want_y)
        _close(st, want_s)


def test_chunked_linear_attention_widens_mixed_types():
    """The SSD's fp32 ``k`` beside bf16 C and x: all three widened, as the
    reference widens them (the kernel takes r, k and v of one type)."""
    r, k, v, lw, _ = _ssd_inputs(1, 24, 2, 16, 64, seed=4)
    rb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (r, v))
    kt, lwt = torch.from_numpy(k), torch.from_numpy(lw)
    y, st = linear_scan.chunked_linear_attention(rb, kt, vb, lwt,
                                                 post_update=True, chunk=16)
    want_y, want_st = rwkv6_chunked_ref(rb.float(), kt, vb.float(), lwt,
                                        chunk=16, post_update=True)
    assert torch.equal(y, want_y) and torch.equal(st, want_st)


# ---------------------------------------------------------- the model

def _layer0(params, tree):
    return ({k: w[0] for k, w in params["layers"].items()},
            {k: jnp.asarray(w[0]) for k, w in tree["layers"].items()})


def test_ssm_branch_equals_the_reference(model):
    """The branch alone on a normed input: without a cache, a prefill into
    a cache (state written) and a decode step from that state."""
    ref_cfg, cfg, tree, params = model
    blk, rblk = _layer0(params, tree)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    want, _ = ref_tf._ssm_branch(rblk, jnp.asarray(x), ref_cfg, cache=None)
    got = tf._ssm_branch(blk, torch.from_numpy(x), cfg, cache=None,
                         cache_pos=0)
    assert _rel(got, want) < REL_TOL
    shape = (2, cfg.n_heads, cfg.ssm_state, cfg.head_dim)
    want, rstate = ref_tf._ssm_branch(
        rblk, jnp.asarray(x), ref_cfg,
        cache={"ssm": jnp.zeros(shape, jnp.float32)})
    cache = {"ssm": torch.full(shape, 7.0)}   # a prefill ignores it
    got = tf._ssm_branch(blk, torch.from_numpy(x), cfg, cache=cache,
                         cache_pos=0)
    assert _rel(got, want) < REL_TOL
    np.testing.assert_allclose(cache["ssm"].numpy(), np.asarray(rstate),
                               atol=1e-5, rtol=1e-5)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    want, rstate = ref_tf._ssm_branch(rblk, jnp.asarray(x1), ref_cfg,
                                      cache={"ssm": rstate})
    got = tf._ssm_branch(blk, torch.from_numpy(x1), cfg, cache=cache,
                         cache_pos=torch.tensor([21, 21]))
    assert _rel(got, want) < REL_TOL
    np.testing.assert_allclose(cache["ssm"].numpy(), np.asarray(rstate),
                               atol=1e-5, rtol=1e-5)


def test_forward_train_equals_reference(model):
    ref_cfg, cfg, tree, params = model
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 21))
    want, _, _ = ref_run(tree, ref_cfg, toks, mode="train")
    got, cache, aux = tf.forward(params, cfg, tf.Runtime(),
                                 torch.from_numpy(toks), mode="train")
    assert cache is None and float(aux) == 0.0
    assert tuple(got.shape) == (2, 21, cfg.vocab)
    assert _rel(got, want) < REL_TOL


@pytest.mark.parametrize("vector_pos", [False, True])
def test_prefill_then_decode_equals_reference(model, vector_pos):
    """Prefill 20 tokens (past the local layers' window of 8; not a
    multiple of the chunk of 8), then four decode steps at one scalar
    position or at per-row depths: logits, the k / v cache and the SSM
    state equal the reference's."""
    ref_cfg, cfg, tree, params = model
    rng = np.random.default_rng(3)
    B, Smax = 2, 32
    toks = rng.integers(0, cfg.vocab, (B, PROMPT))
    rcache = ref_tf.init_cache(ref_cfg, B, Smax, dtype=jnp.float32)
    cache = tf.init_cache(cfg, B, Smax, device="cpu")
    assert set(cache) == set(rcache) == {"k", "v", "ssm"}
    for k in cache:
        assert cache[k].shape == rcache[k].shape, k
    assert cache["ssm"].dtype == torch.float32
    want, rcache, _ = ref_run(tree, ref_cfg, toks, mode="prefill",
                              cache=rcache, cache_pos=0)
    got, cache, _ = tf.forward(params, cfg, tf.Runtime(),
                               torch.from_numpy(toks), mode="prefill",
                               cache=cache, cache_pos=0)
    assert tuple(got.shape) == (B, 1, cfg.vocab)
    assert _rel(got, want) < REL_TOL
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(rcache[k]),
                                   atol=1e-4, rtol=1e-4)
    pos = np.array([PROMPT, PROMPT - 3], np.int32) if vector_pos else PROMPT
    for step in range(4):
        tok = rng.integers(0, cfg.vocab, (B, 1))
        rpos = jnp.asarray(pos) if vector_pos else jnp.int32(pos)
        tpos = torch.from_numpy(pos) if vector_pos else pos
        want, rcache, _ = ref_run(tree, ref_cfg, tok, mode="decode",
                                  cache=rcache, cache_pos=rpos)
        got, cache, _ = tf.forward(params, cfg, tf.Runtime(),
                                   torch.from_numpy(tok), mode="decode",
                                   cache=cache, cache_pos=tpos)
        assert _rel(got, want) < REL_TOL, step
        np.testing.assert_allclose(cache["ssm"].numpy(),
                                   np.asarray(rcache["ssm"]), atol=1e-4,
                                   rtol=1e-4)
        pos = pos + 1


def test_decode_equals_train_forward(model):
    """A prefill of S - 1 tokens and one decode step give the train-mode
    logits of the last position."""
    _, cfg, _, params = model
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab,
                                                              (2, 24)))
    full, _, _ = tf.forward(params, cfg, tf.Runtime(), toks, mode="train")
    cache = tf.init_cache(cfg, 2, 24, device="cpu")
    tf.forward(params, cfg, tf.Runtime(), toks[:, :-1], mode="prefill",
               cache=cache, cache_pos=0)
    last, _, _ = tf.forward(params, cfg, tf.Runtime(), toks[:, -1:],
                            mode="decode", cache=cache, cache_pos=23)
    err = float((last[:, 0] - full[:, -1]).abs().max()) / \
        float(full.abs().max())
    assert err < REL_TOL


def test_calls_go_through_the_kernel_wrappers(model, monkeypatch):
    """No cache and the prefill: one flash call and one chunked call
    (post-update, chunk ``scan_chunk``) a layer; a decode step: one decode
    call a layer and no chunked call (the SSD's step is plain ops).  The
    windowed calls are the local layers'."""
    from repro_torch.models import attention
    _, cfg, _, params = model
    calls = []
    for mod, name in ((attention, "flash_attention"),
                      (attention, "decode_attention"),
                      (linear_scan, "rwkv6_chunked")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append((_n, k.get("window", k.get("post_update")))),
            _f(*a, **k))[1])
    toks = torch.zeros((1, 12), dtype=torch.int64)
    tf.forward(params, cfg, tf.Runtime(), toks, mode="train")
    cache = tf.init_cache(cfg, 1, 16, device="cpu")
    tf.forward(params, cfg, tf.Runtime(), toks, mode="prefill", cache=cache,
               cache_pos=0)
    tf.forward(params, cfg, tf.Runtime(), toks[:, :1], mode="decode",
               cache=cache, cache_pos=torch.tensor([12], dtype=torch.int32))
    wins = [int(w) for w in tf.layer_windows(cfg)]
    assert wins == [8, 8, 8, 0]
    layer = [c for w in wins for c in (("flash_attention", w),
                                       ("rwkv6_chunked", True))]
    assert calls == layer * 2 + [("decode_attention", w) for w in wins]


def test_one_token_prompt_takes_the_step_from_zeros(model):
    """A one-token prompt at position 0 takes the decode step, from a zero
    state whatever the cache holds (the reference takes the step from the
    cache's state, zeros in a fresh cache)."""
    ref_cfg, cfg, tree, params = model
    toks = np.array([[17]])
    rcache = ref_tf.init_cache(ref_cfg, 1, 8, dtype=jnp.float32)
    want, rcache, _ = ref_run(tree, ref_cfg, toks, mode="prefill",
                              cache=rcache, cache_pos=0)
    cache = tf.init_cache(cfg, 1, 8, device="cpu")
    cache["ssm"].fill_(3.0)
    got, cache, _ = tf.forward(params, cfg, tf.Runtime(),
                               torch.from_numpy(toks), mode="prefill",
                               cache=cache, cache_pos=0)
    assert _rel(got, want) < REL_TOL
    np.testing.assert_allclose(cache["ssm"].numpy(),
                               np.asarray(rcache["ssm"]), atol=1e-5,
                               rtol=1e-5)


def test_chunked_prefill_raises(model):
    """More tokens at a nonzero position (a chunked prefill): a prompt of 4
    prefilled from 0, then 3 tokens at position 4 (the attention over the
    cache from that offset, the SSD heads from the cache's state) and 2 at
    per-slot position 7, equal the reference's calls within 1e-4 of max
    |logit|; the SSM state as the reference leaves it."""
    ref_cfg, cfg, tree, params = model
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (1, 9))
    cache = tf.init_cache(cfg, 1, 16, device="cpu")
    rcache = ref_tf.init_cache(ref_cfg, 1, 16, dtype=jnp.float32)
    for a, b, pos in ((0, 4, 0), (4, 7, 4), (7, 9, [7])):
        want, rcache, _ = ref_run(tree, ref_cfg, toks[:, a:b],
                                  mode="prefill", cache=rcache,
                                  cache_pos=jnp.asarray(pos, jnp.int32))
        got, cache, _ = tf.forward(
            params, cfg, tf.Runtime(), torch.from_numpy(toks[:, a:b]),
            mode="prefill", cache=cache,
            cache_pos=pos if isinstance(pos, int) else
            torch.tensor(pos, dtype=torch.int32))
        assert _rel(got, want) < REL_TOL, (a, b)
    np.testing.assert_allclose(cache["ssm"].numpy(),
                               np.asarray(rcache["ssm"]), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------------- serving

def _recorded(eng, rec, names):
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


def test_engine_logits_equal_the_reference_on_fresh_slots(model):
    """Three requests admitted into fresh slots of both engines before any
    step (a slot that idles through a decode step is no longer fresh in the
    reference: its SSM state moves), one of them past the window, then
    decoded to the end: every prefill's and every decode step's logits
    agree."""
    ref_cfg, cfg, tree, params = model
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


def test_reused_slot_starts_fresh_where_the_reference_leaks(model):
    """The reference's engine prefills into a slice of the slot's cache and
    its SSD branch starts from the state there (engine.py:50-61,
    transformer.py:118,124-126): request B's logits in a reused slot differ
    from a fresh engine's by more than 1e-3 of max |logit|.  The port's
    equal its fresh ones exactly, and the reference's fresh ones within
    1e-4."""
    ref_cfg, cfg, tree, params = model
    ref_reused, ref_fresh = _reused_and_fresh(RefEngine, ref_cfg, tree)
    scale = np.abs(ref_fresh).max()
    leak = np.abs(ref_reused - ref_fresh).max()
    reused, fresh = _reused_and_fresh(ReplicaEngine, cfg, params)
    port = np.abs(fresh - ref_fresh).max()
    assert leak / scale > 1e-3
    assert np.array_equal(reused, fresh)
    assert port / scale < REL_TOL


def test_serve_real_stats_equal_the_reference_and_the_chip_constant(model):
    """chip_smoke.py's requests (phase 20 serves them at hymba-1.5b's full
    width) through serve_real on the reduced configuration: the port's
    stats equal the JAX package's and ``REF_SERVE_STATS``."""
    ref_cfg, cfg, tree, params = model
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


def test_serve_cli_on_the_cpu(capsys):
    """The same line as the JAX package's ``python -m repro.launch.serve
    --arch hymba-1.5b --real``."""
    serve_main(["--arch", ARCH, "--real", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "real engines (greedy, cpu): replica_s=91 opened=3 peak=3" in out


def test_serve_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["--arch", ARCH, "--requests", "4", "--real"])


# ------------------------------------------------- RWKV6 chunked prefill

def test_rwkv_chunked_prefill_equals_the_reference():
    """A prefill of 13 tokens, then 19 more at position 13 (three chunks
    of the reduced ``scan_chunk`` 8, the last one ragged, on the state
    carried into the kernel, the token shifts restarting from zeros as the
    reference's do), then a decode step: logits, state and shifts equal the
    reference's ``forward``.  ``test_torch_model.py`` holds a split inside
    one chunk."""
    from test_torch_rwkv import rwkv_reference_tree
    rwkv = "rwkv6-1.6b"
    ref_cfg = dataclasses.replace(ref_reduced(rwkv), dtype="float32",
                                  remat=False)
    cfg = dataclasses.replace(get_reduced_config(rwkv), dtype="float32")
    tree = rwkv_reference_tree(ref_cfg)
    params = P_.params_from_reference(tree, cfg, device="cpu")
    rng = np.random.default_rng(8)
    assert cfg.scan_chunk == 8
    rcache = ref_tf.init_cache(ref_cfg, 2, 40, dtype=jnp.float32)
    cache = tf.init_cache(cfg, 2, 40, device="cpu")
    n0 = sum(ops.launches.values())
    for pos, S in ((0, 13), (13, 19), (32, 1)):
        toks = rng.integers(0, cfg.vocab, (2, S))
        mode = "decode" if S == 1 else "prefill"
        want, rcache, _ = ref_run(tree, ref_cfg, toks, mode=mode,
                                  cache=rcache, cache_pos=jnp.int32(pos))
        got, cache, _ = tf.forward(params, cfg, tf.Runtime(),
                                   torch.from_numpy(toks), mode=mode,
                                   cache=cache, cache_pos=pos)
        assert _rel(got, want) < REL_TOL, pos
        for k in cache:
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(rcache[k]), atol=1e-4,
                                       rtol=1e-4, err_msg=f"{pos} {k}")
    assert sum(ops.launches.values()) == n0   # CPU: the plain version
