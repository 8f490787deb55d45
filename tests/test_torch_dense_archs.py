"""The port's model stack against the JAX package's on the dense
architectures beyond qwen2.5-14b: minitron-8b and nemotron-4-340b (relu^2
MLPs), gemma3-12b (gelu_glu, local layers of window 8 in the reduced
configuration, tied embeddings), pixtral-12b (a stub patch prefix) and
whisper-medium (gelu MLPs, an encoder stack and cross-attention).

The reduced configurations in fp32, the JAX package's own ``init_params``
tree (its norm scales drawn away from 1 so every norm is live) carried
across by ``params_from_reference``; the same tokens, patch embeddings and
encoder frames (numpy, seeded) give the same logits in train, prefill and
decode modes within 1e-4 of max |logit| (the attention sums run in another
order).  Prompts of 20 tokens, so gemma3-reduced's window of 8 binds on
every decode step of its local layers."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced_config as ref_reduced
from repro.models import params as ref_params
from repro.models.transformer import Runtime as RefRuntime
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import init_cache as ref_init_cache
from repro_torch.configs import ARCHS, get_config, get_reduced_config
from repro_torch.models import attention
from repro_torch.models import params as P_
from repro_torch.models.transformer import Runtime, forward, init_cache

DENSE = ["minitron-8b", "nemotron-4-340b", "gemma3-12b", "pixtral-12b",
         "whisper-medium"]
REL_TOL = 1e-4
ENC_FRAMES = 48
PROMPT = 20


@functools.lru_cache(maxsize=None)
def _ref_fn(ref_cfg, mode):
    """The reference's ``forward`` in ``mode``, jitted once a configuration
    (its decode steps then share one compile)."""
    return jax.jit(lambda tree, toks, cache, pos, kw: ref_forward(
        tree, ref_cfg, RefRuntime(), toks, mode=mode, cache=cache,
        cache_pos=pos, **kw))


def ref_run(tree, ref_cfg, toks, *, mode, cache=None, cache_pos=None,
            **kw):
    return _ref_fn(ref_cfg, mode)(tree, jnp.asarray(toks), cache, cache_pos,
                                  kw)


def _rel(port, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(port.float().numpy() - ref).max()) / \
        float(np.abs(ref).max())


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    """(arch, reference config, port config, reference tree, port params,
    extra inputs as numpy)."""
    arch = request.param
    ref_cfg = dataclasses.replace(ref_reduced(arch), dtype="float32",
                                  remat=False)
    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    tree = jax.tree.map(np.asarray, jax.jit(
        ref_params.init_params, static_argnums=(1, 2))(
            jax.random.PRNGKey(0), ref_cfg, jnp.float32))
    rng = np.random.default_rng(1)

    def live_norms(d):
        for k, v in d.items():
            if k.startswith("ln") or k.endswith("_norm"):
                d[k] = (1.0 + 0.2 * rng.standard_normal(v.shape)).astype(
                    np.float32)
    live_norms(tree)
    for stack in ("layers", "enc_layers"):
        if stack in tree:
            live_norms(tree[stack])
    params = P_.params_from_reference(tree, cfg, device="cpu")
    extra = {}
    if cfg.frontend == "vision_stub":
        extra["frontend_embeds"] = (0.1 * rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.arch_kind == "encdec":
        extra["enc_embeds"] = (0.1 * rng.standard_normal(
            (2, ENC_FRAMES, cfg.d_model))).astype(np.float32)
    return arch, ref_cfg, cfg, tree, params, extra


def _kw(extra, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return {k: conv(v) for k, v in extra.items()}


def _n_front(cfg, extra):
    return cfg.n_frontend_tokens if "frontend_embeds" in extra else 0


def test_configs_equal_the_reference():
    assert ARCHS == ["gemma3-12b", "qwen2.5-14b", "minitron-8b",
                     "nemotron-4-340b", "granite-moe-3b-a800m",
                     "deepseek-v2-lite-16b", "whisper-medium", "pixtral-12b",
                     "rwkv6-1.6b", "hymba-1.5b"]
    for arch in DENSE:
        for port, ref in ((get_config(arch), ref_get_config(arch)),
                          (get_reduced_config(arch), ref_reduced(arch))):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_params_from_reference_carries_every_leaf(model):
    _, _, cfg, tree, params, _ = model
    assert set(params) == set(tree)
    for key, sub in tree.items():
        if isinstance(sub, dict):
            assert set(params[key]) == set(sub)
            for k, arr in sub.items():
                assert np.array_equal(params[key][k].numpy(), arr), (key, k)
        else:
            assert np.array_equal(params[key].numpy(), sub), key
    if cfg.arch_kind == "encdec":
        assert params["enc_layers"]["wq"].shape[0] == cfg.n_enc_layers
        assert "x_wq" in params["layers"] and "ln_x" in params["layers"]


def test_init_params_follows_the_reference_template(model, monkeypatch):
    """The port's random tree has the reference's keys and shapes; drawn in
    row blocks (``_DRAW_ELEMS`` cut to 1000 elements here) a normal weight
    keeps its std of ``1 / sqrt(fan_in)``, and the same seed gives the same
    tree."""
    arch, ref_cfg, cfg, tree, _, _ = model
    monkeypatch.setattr(P_, "_DRAW_ELEMS", 1000)
    p = P_.init_params(cfg, seed=3, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), tree)
    assert shapes == {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
                          if isinstance(v, dict) else tuple(v.shape))
                      for k, v in p.items()}
    w = p["layers"]["w_out"].float()
    assert abs(float(w.std()) * np.sqrt(cfg.d_ff) - 1.0) < 0.05
    assert torch.all(p["layers"]["ln1"] == 1)
    again = P_.init_params(cfg, seed=3, device="cpu")
    for key, sub in p.items():
        for k, t in (sub.items() if isinstance(sub, dict) else [("", sub)]):
            other = again[key][k] if k else again[key]
            assert torch.equal(t, other), (key, k)


def test_forward_train_equals_reference(model):
    _, ref_cfg, cfg, tree, params, extra = model
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, PROMPT))
    want, _, _ = ref_run(tree, ref_cfg, toks, mode="train",
                         **_kw(extra, "jax"))
    got, cache, aux = forward(params, cfg, Runtime(), torch.from_numpy(toks),
                              mode="train", **_kw(extra, "torch"))
    assert cache is None and float(aux) == 0.0
    assert tuple(got.shape) == (2, PROMPT + _n_front(cfg, extra), cfg.vocab)
    assert _rel(got, want) < REL_TOL


@pytest.mark.parametrize("vector_pos", [False, True])
def test_prefill_then_decode_equals_reference(model, vector_pos):
    """Prefill a 20-token prompt (behind pixtral's patches; whisper's
    encoder over its 48 frames) from position 0, then three decode steps
    (whisper's from the stashed ``enc_out``): at one scalar position, or
    at per-row depths (row 1 rewinds by three positions, as a reused
    engine slot does)."""
    _, ref_cfg, cfg, tree, params, extra = model
    rng = np.random.default_rng(3)
    B, Smax = 2, 48
    toks = rng.integers(0, cfg.vocab, (B, PROMPT))
    rcache = ref_init_cache(ref_cfg, B, Smax, dtype=jnp.float32)
    cache = init_cache(cfg, B, Smax, device="cpu")
    want, rcache, _ = ref_run(tree, ref_cfg, toks, mode="prefill",
                              cache=rcache, cache_pos=0, **_kw(extra, "jax"))
    got, cache, _ = forward(params, cfg, Runtime(), torch.from_numpy(toks),
                            mode="prefill", cache=cache, cache_pos=0,
                            **_kw(extra, "torch"))
    assert tuple(got.shape) == (B, 1, cfg.vocab)
    assert _rel(got, want) < REL_TOL
    S = PROMPT + _n_front(cfg, extra)
    np.testing.assert_allclose(cache["k"][:, :, :S].numpy(),
                               np.asarray(rcache["k"])[:, :, :S],
                               atol=1e-5, rtol=1e-5)
    if cfg.arch_kind == "encdec":
        np.testing.assert_allclose(cache["enc_out"].numpy(),
                                   np.asarray(rcache["enc_out"]),
                                   atol=1e-5, rtol=1e-5)
    pos = np.array([S, S - 3], np.int32) if vector_pos else S
    for step in range(3):
        tok = rng.integers(0, cfg.vocab, (B, 1))
        rpos = jnp.asarray(pos, jnp.int32)
        tpos = torch.from_numpy(pos) if vector_pos else pos
        want, rcache, _ = ref_run(tree, ref_cfg, tok, mode="decode",
                                  cache=rcache, cache_pos=rpos)
        got, cache, _ = forward(params, cfg, Runtime(),
                                torch.from_numpy(tok), mode="decode",
                                cache=cache, cache_pos=tpos)
        assert _rel(got, want) < REL_TOL, step
        pos = pos + 1


def test_decode_equals_train_forward(model):
    """The port's own check: a prefill of all but the last token and one
    decode step give the train-mode logits of the last position."""
    _, _, cfg, _, params, extra = model
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, PROMPT + 1)))
    kw = _kw(extra, "torch")
    full, _, _ = forward(params, cfg, Runtime(), toks, mode="train", **kw)
    S = PROMPT + _n_front(cfg, extra)
    cache = init_cache(cfg, 2, S + 1, device="cpu")
    forward(params, cfg, Runtime(), toks[:, :-1], mode="prefill",
            cache=cache, cache_pos=0, **kw)
    last, _, _ = forward(params, cfg, Runtime(), toks[:, -1:], mode="decode",
                         cache=cache, cache_pos=S)
    err = float((last[:, 0] - full[:, -1]).abs().max()) / \
        float(full.abs().max())
    assert err < REL_TOL


def test_attention_calls_go_through_the_kernel_wrappers(model, monkeypatch):
    """Every attention call of a prefill and a decode step reaches
    ``flash_attention`` or ``decode_attention``: gemma3's local layers with
    their window (binding: ``kv_len`` past it on decode), whisper's encoder
    and cross calls non-causal over all its frames (a decode step's cross
    call as ``decode_attention`` with ``kv_len`` = the frames)."""
    _, _, cfg, _, params, extra = model
    calls = []
    real_flash, real_decode = attention.flash_attention, \
        attention.decode_attention

    def flash(q, k, v, *, causal=True, window=0):
        calls.append(("flash", causal, window, k.shape[1]))
        return real_flash(q, k, v, causal=causal, window=window)

    def decode(q, k, v, kv_len, *, window=0):
        calls.append(("decode", window, tuple(kv_len.tolist())))
        return real_decode(q, k, v, kv_len, window=window)

    monkeypatch.setattr(attention, "flash_attention", flash)
    monkeypatch.setattr(attention, "decode_attention", decode)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, PROMPT)))
    S = PROMPT + _n_front(cfg, extra)
    cache = init_cache(cfg, 2, S + 1, device="cpu")
    forward(params, cfg, Runtime(), toks, mode="prefill", cache=cache,
            cache_pos=0, **_kw(extra, "torch"))
    n_pre = len(calls)
    forward(params, cfg, Runtime(), toks[:, :1], mode="decode", cache=cache,
            cache_pos=S)
    L, Le = cfg.n_layers, cfg.n_enc_layers
    pre, dec = calls[:n_pre], calls[n_pre:]
    windows = [0 if cfg.layer_is_global(i) else cfg.window for i in range(L)]
    if cfg.arch_kind == "encdec":
        enc = [("flash", False, 0, ENC_FRAMES)] * Le
        self_cross = [c for i in range(L) for c in
                      (("flash", True, 0, S), ("flash", False, 0,
                                               ENC_FRAMES))]
        assert pre == enc + self_cross
        assert dec == [c for i in range(L) for c in
                       (("decode", 0, (S + 1, S + 1)),
                        ("decode", 0, (ENC_FRAMES, ENC_FRAMES)))]
    else:
        assert pre == [("flash", True, w, S) for w in windows]
        assert dec == [("decode", w, (S + 1, S + 1)) for w in windows]
    if cfg.attn_kind == "mixed":
        assert 0 < cfg.window < S + 1 and cfg.window in windows


def test_param_count_of_the_full_config_equals_the_reference(model):
    """The template's elements at full width equal the JAX template's, and
    so does ``ModelConfig.param_count``."""
    arch = model[0]
    cfg = get_config(arch)
    n = sum(int(np.prod(((m[1],) if m[1] else ()) + m[0].shape))
            for sub in P_._finalize(cfg, lambda m, n: (m, n)).values()
            for m in (sub.values() if isinstance(sub, dict) else [sub]))
    ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        ref_params.abstract_params(ref_get_config(arch))))
    assert n == ref
    assert cfg.param_count() == ref_get_config(arch).param_count()


def test_engine_decodes_gemma3_across_its_window():
    """gemma3-reduced (fp32) in a ``ReplicaEngine`` of two slots whose
    depths start below its window of 8 and pass it: every step's logits of
    a slot equal the train-mode logits of that slot's whole sequence at
    its last position (continuous batching with per-slot depths, the
    window per row)."""
    from repro_torch.serving.engine import ReplicaEngine
    cfg = dataclasses.replace(get_reduced_config("gemma3-12b"),
                              dtype="float32")
    params = P_.init_params(cfg, seed=1, device="cpu")
    eng = ReplicaEngine(cfg, params, slots=2, max_len=32, eos_id=-1)
    logits = []
    decode = eng._decode
    eng._decode = lambda *a: (logits.append(decode(*a)), logits[-1])[1]
    eng.admit(1, [5, 6, 7], 10)
    eng.admit(2, list(range(20, 32)), 10)
    for _ in range(8):
        eng.step()
    seqs = {1: eng.seqs[1].tokens, 2: eng.seqs[2].tokens}
    for slot, rid in ((0, 1), (1, 2)):
        toks = torch.tensor([seqs[rid]])
        full, _, _ = forward(params, cfg, Runtime(), toks, mode="train")
        n0 = len(seqs[rid]) - 9          # the prompt and its first token
        for i, step in enumerate(logits):
            want = full[0, n0 + i]
            err = float((step[slot] - want).abs().max()) / \
                float(want.abs().max())
            assert err < REL_TOL, (rid, i)
    assert len(seqs[2]) - 1 > cfg.window > 3
