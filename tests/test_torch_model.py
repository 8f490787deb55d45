"""The port's model stack (``repro_torch.models``) against the JAX
package's, on the reduced qwen2.5-14b and rwkv6-1.6b configurations in
fp32: the same parameters (the JAX package's own init, with qwen's QKV
biases and rwkv6's mixes, decay base, bonus and group-norm scale drawn
nonzero by the test, carried across by ``params_from_reference``) and the
same tokens give the same logits in train, prefill and decode modes, within
1e-4 of max |logit| (fp32; the attention and scan sums run in another
order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced_config as ref_reduced
from repro.models import params as ref_params
from repro.models.transformer import Runtime as RefRuntime
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import init_cache as ref_init_cache
from repro_torch.configs import ARCHS, get_config, get_reduced_config
from repro_torch.models import params as P_
from repro_torch.models.attention import attention_block
from repro_torch.models.transformer import Runtime, forward, init_cache

ARCH = "qwen2.5-14b"
REL_TOL = 1e-4


def _cfgs():
    ref = dataclasses.replace(ref_reduced(ARCH), dtype="float32",
                              remat=False)
    port = dataclasses.replace(get_reduced_config(ARCH), dtype="float32")
    return ref, port


@pytest.fixture(scope="module")
def models():
    """The JAX package's parameters with nonzero QKV biases, and the
    port's copy of them."""
    ref_cfg, cfg = _cfgs()
    tree = ref_params.init_params(jax.random.PRNGKey(0), ref_cfg,
                                  dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, tree)
    rng = np.random.default_rng(1)
    for b in ("bq", "bk", "bv"):
        tree["layers"][b] = (0.5 * rng.standard_normal(
            tree["layers"][b].shape)).astype(np.float32)
    params = P_.params_from_reference(tree, cfg, device="cpu")
    return ref_cfg, cfg, tree, params


def _rel(port, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(port.float().numpy() - ref).max()) / \
        float(np.abs(ref).max())


def test_params_from_reference_carries_every_leaf(models):
    _, cfg, tree, params = models
    assert set(params) == set(tree)
    assert set(params["layers"]) == set(tree["layers"])
    for k in ("embed", "final_norm", "lm_head"):
        assert np.array_equal(params[k].numpy(), tree[k])
    for k, arr in tree["layers"].items():
        assert params["layers"][k].dtype == torch.float32
        assert np.array_equal(params["layers"][k].numpy(), arr)
    assert np.abs(tree["layers"]["bq"]).max() > 0.1   # the bias path is live


def test_params_from_reference_refuses_a_wrong_tree(models):
    _, cfg, tree, _ = models
    bad = dict(tree, layers={k: v for k, v in tree["layers"].items()
                             if k != "bq"})
    with pytest.raises(ValueError, match="reference keys"):
        P_.params_from_reference(bad, cfg, device="cpu")
    bad = dict(tree, embed=tree["embed"][:, :-1])
    with pytest.raises(ValueError, match="shape"):
        P_.params_from_reference(bad, cfg, device="cpu")


def test_init_params_follows_the_reference_template():
    """Same tree, shapes and initialisers as the JAX package's
    ``init_params``: ones for norms, zeros for the QKV biases, normal
    weights of std ``1 / sqrt(fan_in)`` (embeddings: 1), in the requested
    dtype (default ``cfg.dtype``), made on the requested device."""
    cfg = get_reduced_config(ARCH)
    ref = ref_params.init_params(jax.random.PRNGKey(0), ref_reduced(ARCH))
    p = P_.init_params(cfg, seed=3, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), ref) == \
        {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
             if isinstance(v, dict) else tuple(v.shape))
         for k, v in p.items()}
    assert p["embed"].dtype == torch.bfloat16 and p["embed"].device.type == \
        "cpu"
    lay = p["layers"]
    assert torch.all(lay["bq"] == 0) and torch.all(lay["ln1"] == 1)
    assert torch.all(p["final_norm"] == 1)
    w = lay["w_out"].float()
    assert abs(float(w.std()) * np.sqrt(cfg.d_ff) - 1.0) < 0.05
    assert abs(float(p["embed"].float().std()) - 1.0) < 0.05
    again = P_.init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    assert torch.equal(again["layers"]["wq"].to(torch.bfloat16), lay["wq"])
    other = P_.init_params(cfg, seed=4, device="cpu")
    assert not torch.equal(other["layers"]["wq"], lay["wq"])


def test_param_count_of_the_full_config_equals_the_reference():
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    assert cfg.param_count() == ref.param_count()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.vocab) == (48, 5120, 40, 8, 128, 152064)
    # the template's elements: the dense count plus norms and QKV biases
    n = sum(int(np.prod(((m[1],) if m[1] else ()) + m[0].shape))
            for sub in P_._finalize(cfg, lambda m, n: (m, n)).values()
            for m in (sub.values() if isinstance(sub, dict) else [sub]))
    extra = cfg.n_layers * (2 * cfg.d_model + cfg.q_dim + 2 * cfg.kv_dim) + \
        cfg.d_model
    assert n == cfg.param_count() + extra
    assert 14.7e9 < n < 14.8e9
    assert ARCHS == REF_ARCHS == [
        "gemma3-12b", "qwen2.5-14b", "minitron-8b", "nemotron-4-340b",
        "granite-moe-3b-a800m", "deepseek-v2-lite-16b", "whisper-medium",
        "pixtral-12b", "rwkv6-1.6b", "hymba-1.5b"]
    assert get_config("hymba-1.5b").param_count() == \
        ref_get_config("hymba-1.5b").param_count()
    with pytest.raises(KeyError):
        get_config("hymba-3b")


def test_forward_train_equals_reference(models):
    ref_cfg, cfg, tree, params = models
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 24))
    want, _, _ = ref_forward(tree, ref_cfg, RefRuntime(), jnp.asarray(toks),
                             mode="train")
    got, cache, aux = forward(params, cfg, Runtime(), torch.from_numpy(toks),
                              mode="train")
    assert cache is None and float(aux) == 0.0
    assert tuple(got.shape) == (2, 24, cfg.vocab)
    assert _rel(got, want) < REL_TOL


@pytest.mark.parametrize("vector_pos", [False, True])
def test_prefill_then_decode_equals_reference(models, vector_pos):
    """Prefill 20 tokens from position 0, then three decode steps: at one
    scalar position for both rows, or at per-row depths (a (B,) cache_pos:
    row 1 rewinds by three positions, as a reused engine slot does)."""
    ref_cfg, cfg, tree, params = models
    rng = np.random.default_rng(3)
    B, S, Smax = 2, 20, 32
    toks = rng.integers(0, cfg.vocab, (B, S))
    rcache = ref_init_cache(ref_cfg, B, Smax, dtype=jnp.float32)
    cache = init_cache(cfg, B, Smax, device="cpu")
    want, rcache, _ = ref_forward(tree, ref_cfg, RefRuntime(),
                                  jnp.asarray(toks), mode="prefill",
                                  cache=rcache, cache_pos=0)
    got, cache, _ = forward(params, cfg, Runtime(), torch.from_numpy(toks),
                            mode="prefill", cache=cache, cache_pos=0)
    assert tuple(got.shape) == (B, 1, cfg.vocab)
    assert _rel(got, want) < REL_TOL
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(rcache["k"]),
                               atol=1e-5, rtol=1e-5)
    pos = np.array([S, S - 3], np.int32) if vector_pos else S
    for step in range(3):
        tok = rng.integers(0, cfg.vocab, (B, 1))
        rpos = jnp.asarray(pos) if vector_pos else pos
        tpos = torch.from_numpy(pos) if vector_pos else pos
        want, rcache, _ = ref_forward(tree, ref_cfg, RefRuntime(),
                                      jnp.asarray(tok), mode="decode",
                                      cache=rcache, cache_pos=rpos)
        got, cache, _ = forward(params, cfg, Runtime(),
                                torch.from_numpy(tok), mode="decode",
                                cache=cache, cache_pos=tpos)
        assert _rel(got, want) < REL_TOL, step
        pos = pos + 1


def test_decode_equals_train_forward(models):
    """The port's own check: a prefill of S - 1 tokens and one decode step
    give the train-mode logits of the last position."""
    _, cfg, _, params = models
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab,
                                                              (2, 24)))
    full, _, _ = forward(params, cfg, Runtime(), toks, mode="train")
    cache = init_cache(cfg, 2, 24, device="cpu")
    forward(params, cfg, Runtime(), toks[:, :-1], mode="prefill",
            cache=cache, cache_pos=0)
    last, _, _ = forward(params, cfg, Runtime(), toks[:, -1:], mode="decode",
                         cache=cache, cache_pos=23)
    err = float((last[:, 0] - full[:, -1]).abs().max()) / \
        float(full.abs().max())
    assert err < REL_TOL


def test_attention_runs_through_the_kernel_wrappers(models, monkeypatch):
    """No cache and the prefill go to ``flash_attention``, a decode step to
    ``decode_attention``, once per layer each."""
    from repro_torch.models import attention
    _, cfg, _, params = models
    calls = []
    for name in ("flash_attention", "decode_attention"):
        fn = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *a, _n=name, _f=fn, **k:
                            (calls.append(_n), _f(*a, **k))[1])
    toks = torch.zeros((1, 5), dtype=torch.int64)
    forward(params, cfg, Runtime(), toks, mode="train")
    cache = init_cache(cfg, 1, 8, device="cpu")
    forward(params, cfg, Runtime(), toks, mode="prefill", cache=cache,
            cache_pos=0)
    forward(params, cfg, Runtime(), toks[:, :1], mode="decode", cache=cache,
            cache_pos=torch.tensor([5], dtype=torch.int32))
    L = cfg.n_layers
    assert calls == ["flash_attention"] * (2 * L) + ["decode_attention"] * L


def _layer(params, cfg):
    return {k: w[0] for k, w in params["layers"].items()}


@pytest.mark.parametrize("case", ["softcap", "int8", "chunked_prefill"])
def test_out_of_scope_attention_raises(models, case):
    """Three cases of the attention module held to the reference's
    ``attention_block`` within 1e-4 of max |out|: ``logit_softcap`` 30 in
    both configurations (neither block applies the field), three tokens prefilled from position 0 into an int8 cache
    (read back dequantized) and three tokens at position 2 of a filled
    cache (a chunked prefill); the caches as written."""
    from repro.models import attention as ref_attention
    ref_cfg, cfg, tree, params = models
    blk = _layer(params, cfg)
    rblk = {k: jnp.asarray(w[0]) for k, w in tree["layers"].items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 3, cfg.d_model)).astype(np.float32)
    shape = (1, 8, cfg.n_kv_heads, cfg.head_dim)
    cache, pos0 = None, 0
    if case == "softcap":
        cfg = dataclasses.replace(cfg, logit_softcap=30.0)
        ref_cfg = dataclasses.replace(ref_cfg, logit_softcap=30.0)
    elif case == "int8":
        cache = {"k_q": np.zeros(shape, np.int8),
                 "v_q": np.zeros(shape, np.int8),
                 "k_s": np.ones(shape[:-1] + (1,), np.float32),
                 "v_s": np.ones(shape[:-1] + (1,), np.float32)}
    else:
        cache = {n: rng.standard_normal(shape).astype(np.float32)
                 for n in ("k", "v")}
        pos0 = 2
    pos = (pos0 + np.arange(3, dtype=np.int32))[None]
    kw = dict(window=0, cache_pos=pos0) if cache is not None else \
        dict(window=0)
    want, rcache = ref_attention.attention_block(
        rblk, jnp.asarray(x), ref_cfg, positions=jnp.asarray(pos),
        cache=None if cache is None else
        {k: jnp.asarray(v) for k, v in cache.items()}, **kw)
    got, new = attention_block(
        blk, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos),
        cache=None if cache is None else
        {k: torch.from_numpy(v.copy()) for k, v in cache.items()}, **kw)
    assert _rel(got, want) < REL_TOL
    if cache is not None:
        for k, v in rcache.items():
            np.testing.assert_allclose(new[k].numpy().astype(np.float32),
                                       np.asarray(v).astype(np.float32),
                                       atol=1.0 if k.endswith("_q") else 1e-6,
                                       rtol=1e-6)


@pytest.mark.parametrize("case", ["cross", "window_decode", "mla"])
def test_former_out_of_scope_attention_equals_reference(models, case):
    """Three cases that used to raise, now held to the reference's
    ``attention_block`` or ``mla_attention_block``: cross-attention onto 5
    states (3 queries through the non-causal flash path, then 1 query
    through the decode path with kv_len = 5; the query bias applies, the
    keys and values take none), a decode step at position 5 against a
    filled cache with a window of 4 (the cache rows before position 2 must
    not count), and deepseek's latent attention (reduced): one token at
    per-slot depths (5, 2) against a cache of random latents, the new
    latents written at those depths."""
    from repro.models.attention import attention_block as ref_block
    ref_cfg, cfg, tree, params = models
    blk = _layer(params, cfg)
    rblk = {k: jnp.asarray(w[0]) for k, w in tree["layers"].items()}
    rng = np.random.default_rng(8)
    if case == "mla":
        from repro.models.attention import mla_attention_block as ref_mla
        from repro_torch.models.attention import mla_attention_block
        ref_cfg = dataclasses.replace(ref_reduced("deepseek-v2-lite-16b"),
                                      dtype="float32")
        cfg = dataclasses.replace(get_reduced_config("deepseek-v2-lite-16b"),
                                  dtype="float32")
        tree = jax.tree.map(np.asarray, ref_params.init_params(
            jax.random.PRNGKey(1), ref_cfg, dtype=jnp.float32))
        rblk = {k: jnp.asarray(w[0]) for k, w in tree["layers"].items()}
        blk = {k: torch.from_numpy(np.array(w[0]))
               for k, w in tree["layers"].items()}
        lat = rng.standard_normal(
            (2, 8, cfg.kv_lora_rank + cfg.rope_head_dim)).astype(np.float32)
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        cpos = np.array([5, 2], np.int32)
        want, rcache = ref_mla(rblk, jnp.asarray(x), ref_cfg,
                               positions=jnp.asarray(cpos[:, None]),
                               cache={"lat": jnp.asarray(lat)},
                               cache_pos=jnp.asarray(cpos))
        cache = {"lat": torch.from_numpy(lat.copy())}
        got, cache = mla_attention_block(
            blk, torch.from_numpy(x), cfg,
            positions=torch.from_numpy(cpos[:, None]), cache=cache,
            cache_pos=torch.from_numpy(cpos))
        assert _rel(got, want) < REL_TOL
        np.testing.assert_allclose(cache["lat"].numpy(),
                                   np.asarray(rcache["lat"]), atol=1e-6,
                                   rtol=1e-6)
        return
    if case == "cross":
        e = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
        for S in (3, 1):
            x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
            pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
            want, _ = ref_block(rblk, jnp.asarray(x), ref_cfg,
                                positions=jnp.asarray(pos), window=0,
                                cross_states=jnp.asarray(e))
            got, cache = attention_block(blk, torch.from_numpy(x), cfg,
                                         positions=torch.from_numpy(pos),
                                         window=0,
                                         cross_states=torch.from_numpy(e))
            assert cache is None
            assert _rel(got, want) < REL_TOL, S
        return
    shape = (2, 8, cfg.n_kv_heads, cfg.head_dim)
    ck, cv = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    pos = np.full((2, 1), 5, np.int32)
    want, rcache = ref_block(rblk, jnp.asarray(x), ref_cfg,
                             positions=jnp.asarray(pos), window=4,
                             cache={"k": jnp.asarray(ck),
                                    "v": jnp.asarray(cv)}, cache_pos=5)
    cache = {"k": torch.from_numpy(ck.copy()),
             "v": torch.from_numpy(cv.copy())}
    got, cache = attention_block(blk, torch.from_numpy(x), cfg,
                                 positions=torch.from_numpy(pos), window=4,
                                 cache=cache, cache_pos=5)
    assert _rel(got, want) < REL_TOL
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(rcache["k"]),
                               atol=1e-6, rtol=1e-6)
    whole, _ = attention_block(blk, torch.from_numpy(x), cfg,
                               positions=torch.from_numpy(pos), window=0,
                               cache={"k": torch.from_numpy(ck.copy()),
                                      "v": torch.from_numpy(cv.copy())},
                               cache_pos=5)
    assert _rel(whole, want) > 1e-3          # the window binds


def test_other_architectures_raise():
    """SSM heads beside the attention (hymba's, here on qwen's reduced
    configuration) build: the reference's template and cache.  The int8
    KV cache is the reference's: int8 ``k_q`` / ``v_q`` and fp32 ``k_s`` / ``v_s`` filled
    with ones."""
    from repro.models.transformer import init_cache as ref_cache
    cfg = dataclasses.replace(get_reduced_config(ARCH), ssm=True,
                              ssm_state=8)
    ref_cfg = dataclasses.replace(ref_reduced(ARCH), ssm=True, ssm_state=8)
    p = P_.init_params(cfg, device="cpu")
    ref = ref_params.init_params(jax.random.PRNGKey(0), ref_cfg)
    assert {k: tuple(v.shape) for k, v in p["layers"].items()} == \
        {k: tuple(v.shape) for k, v in ref["layers"].items()}
    cache = init_cache(cfg, 1, 4, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in ref_cache(ref_cfg, 1, 4).items()}
    int8 = init_cache(dataclasses.replace(get_reduced_config(ARCH),
                                          kv_cache_int8=True), 1, 4,
                      device="cpu")
    want = ref_cache(dataclasses.replace(ref_reduced(ARCH),
                                         kv_cache_int8=True), 1, 4)
    assert set(int8) == set(want) == {"k_q", "v_q", "k_s", "v_s"}
    for k, w in want.items():
        assert int8[k].numpy().dtype == np.asarray(w).dtype
        assert np.array_equal(int8[k].numpy(), np.asarray(w))


# ---------------------------------------------------------------- RWKV6

RWKV = "rwkv6-1.6b"


@pytest.fixture(scope="module")
def rwkv_models():
    from test_torch_rwkv import rwkv_reference_tree
    ref_cfg = dataclasses.replace(ref_reduced(RWKV), dtype="float32",
                                  remat=False)
    cfg = dataclasses.replace(get_reduced_config(RWKV), dtype="float32")
    tree = rwkv_reference_tree(ref_cfg)
    return ref_cfg, cfg, tree, P_.params_from_reference(tree, cfg,
                                                        device="cpu")


def test_rwkv_config_equals_the_reference():
    for full, ref in ((get_config(RWKV), ref_get_config(RWKV)),
                      (get_reduced_config(RWKV), ref_reduced(RWKV))):
        assert dataclasses.asdict(full) == dataclasses.asdict(ref)


def test_rwkv_params_from_reference_carries_every_leaf(rwkv_models):
    _, cfg, tree, params = rwkv_models
    assert set(params["layers"]) == set(tree["layers"])
    for k, arr in tree["layers"].items():
        assert np.array_equal(params["layers"][k].numpy(), arr), k
    assert np.array_equal(params["embed"].numpy(), tree["embed"])


def test_rwkv_init_params_follows_the_reference_template():
    """Same tree, shapes and initialisers as the JAX package's: zeros for
    the mixes, decay base and bonus, ones for the norms and the group-norm
    scale, normal weights of std ``1 / sqrt(fan_in)``."""
    cfg = get_reduced_config(RWKV)
    ref = ref_params.init_params(jax.random.PRNGKey(0), ref_reduced(RWKV))
    p = P_.init_params(cfg, seed=3, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), ref) == \
        {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
             if isinstance(v, dict) else tuple(v.shape))
         for k, v in p.items()}
    lay = p["layers"]
    for name in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "mix_f",
                 "decay_base", "bonus_u"):
        assert torch.all(lay[name] == 0), name
    for name in ("ln1", "ln2", "gn_scale"):
        assert torch.all(lay[name] == 1), name
    assert abs(float(lay["decay_b"].float().std()) * 8 - 1.0) < 0.05
    assert abs(float(lay["w_out"].float().std()) *
               np.sqrt(cfg.d_ff) - 1.0) < 0.05


def test_rwkv_param_count_of_the_full_config_equals_the_reference():
    """The template's elements at full width equal the JAX template's:
    1 483 229 184 (2.97 GB in bf16)."""
    cfg = get_config(RWKV)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab, cfg.scan_chunk) == (24, 2048, 32, 64, 7168, 65536, 16)
    n = sum(int(np.prod(((m[1],) if m[1] else ()) + m[0].shape))
            for sub in P_._finalize(cfg, lambda m, n: (m, n)).values()
            for m in (sub.values() if isinstance(sub, dict) else [sub]))
    ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        ref_params.abstract_params(ref_get_config(RWKV))))
    assert n == ref == 1_483_229_184
    assert cfg.param_count() == ref_get_config(RWKV).param_count()


def test_rwkv_forward_train_equals_reference(rwkv_models):
    ref_cfg, cfg, tree, params = rwkv_models
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 21))
    want, _, _ = ref_forward(tree, ref_cfg, RefRuntime(), jnp.asarray(toks),
                             mode="train")
    got, cache, aux = forward(params, cfg, Runtime(), torch.from_numpy(toks),
                              mode="train")
    assert cache is None and float(aux) == 0.0
    assert tuple(got.shape) == (2, 21, cfg.vocab)
    assert _rel(got, want) < REL_TOL


@pytest.mark.parametrize("vector_pos", [False, True])
def test_rwkv_prefill_then_decode_equals_reference(rwkv_models, vector_pos):
    """Prefill 21 tokens (not a multiple of the chunk of 8) into a zero
    cache, then three decode steps at one scalar position or at per-row
    positions: logits, state and shifts equal the reference's."""
    ref_cfg, cfg, tree, params = rwkv_models
    rng = np.random.default_rng(3)
    B, S = 2, 21
    toks = rng.integers(0, cfg.vocab, (B, S))
    rcache = ref_init_cache(ref_cfg, B, 32, dtype=jnp.float32)
    cache = init_cache(cfg, B, 32, device="cpu")
    assert set(cache) == set(rcache)
    for k in cache:
        assert cache[k].shape == rcache[k].shape
        assert cache[k].dtype == torch.float32
    want, rcache, _ = ref_forward(tree, ref_cfg, RefRuntime(),
                                  jnp.asarray(toks), mode="prefill",
                                  cache=rcache, cache_pos=0)
    got, cache, _ = forward(params, cfg, Runtime(), torch.from_numpy(toks),
                            mode="prefill", cache=cache, cache_pos=0)
    assert tuple(got.shape) == (B, 1, cfg.vocab)
    assert _rel(got, want) < REL_TOL
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(rcache[k]),
                                   atol=1e-4, rtol=1e-4)
    pos = np.array([S, S - 3], np.int32) if vector_pos else S
    for step in range(3):
        tok = rng.integers(0, cfg.vocab, (B, 1))
        rpos = jnp.asarray(pos) if vector_pos else pos
        tpos = torch.from_numpy(pos) if vector_pos else pos
        want, rcache, _ = ref_forward(tree, ref_cfg, RefRuntime(),
                                      jnp.asarray(tok), mode="decode",
                                      cache=rcache, cache_pos=rpos)
        got, cache, _ = forward(params, cfg, Runtime(),
                                torch.from_numpy(tok), mode="decode",
                                cache=cache, cache_pos=tpos)
        assert _rel(got, want) < REL_TOL, step
        pos = pos + 1


def test_rwkv_decode_equals_train_forward(rwkv_models):
    """A prefill of S - 1 tokens and one decode step give the train-mode
    logits of the last position."""
    _, cfg, _, params = rwkv_models
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab,
                                                              (2, 24)))
    full, _, _ = forward(params, cfg, Runtime(), toks, mode="train")
    cache = init_cache(cfg, 2, 24, device="cpu")
    forward(params, cfg, Runtime(), toks[:, :-1], mode="prefill",
            cache=cache, cache_pos=0)
    last, _, _ = forward(params, cfg, Runtime(), toks[:, -1:], mode="decode",
                         cache=cache, cache_pos=23)
    err = float((last[:, 0] - full[:, -1]).abs().max()) / \
        float(full.abs().max())
    assert err < REL_TOL


def test_rwkv_prefill_starts_from_zero_whatever_the_cache_holds(
        rwkv_models):
    """A prefill at position 0 overwrites the state and shifts from a zero
    start, for a 1-token prompt too: a cache full of another request's
    state gives the same logits and cache as a zero one."""
    _, cfg, _, params = rwkv_models
    rng = np.random.default_rng(5)
    for S in (13, 1):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S)))
        fresh = init_cache(cfg, 1, 32, device="cpu")
        dirty = {k: torch.from_numpy(rng.standard_normal(c.shape).astype(
            np.float32)) for k, c in fresh.items()}
        want, _, _ = forward(params, cfg, Runtime(), toks, mode="prefill",
                             cache=fresh, cache_pos=0)
        got, _, _ = forward(params, cfg, Runtime(), toks, mode="prefill",
                            cache=dirty, cache_pos=0)
        assert torch.equal(got, want), S
        for k in fresh:
            assert torch.equal(dirty[k], fresh[k]), (S, k)


def test_rwkv_time_mix_runs_through_the_kernel_wrapper(rwkv_models,
                                                       monkeypatch):
    """No cache and the prefill go to ``rwkv6_chunked`` once per layer
    each; a decode step goes to the step, not the kernel."""
    from repro_torch.models import linear_scan
    _, cfg, _, params = rwkv_models
    calls = []
    fn = linear_scan.rwkv6_chunked
    monkeypatch.setattr(linear_scan, "rwkv6_chunked",
                        lambda *a, **k: (calls.append(k["chunk"]),
                                         fn(*a, **k))[1])
    toks = torch.zeros((1, 5), dtype=torch.int64)
    forward(params, cfg, Runtime(), toks, mode="train")
    cache = init_cache(cfg, 1, 8, device="cpu")
    forward(params, cfg, Runtime(), toks, mode="prefill", cache=cache,
            cache_pos=0)
    forward(params, cfg, Runtime(), toks[:, :1], mode="decode", cache=cache,
            cache_pos=torch.tensor([5], dtype=torch.int32))
    assert calls == [cfg.scan_chunk] * (2 * cfg.n_layers)


def test_rwkv_chunked_prefill_raises(rwkv_models):
    """Named when the port refused it: a chunked prefill now equals the
    reference's.  4 tokens from position 0, then 3 more at position 4
    (both inside one chunk of the reduced ``scan_chunk`` 8), the state
    carried into the kernel and the token shifts restarting from zeros, as
    the reference's do; logits, state and shifts."""
    ref_cfg, cfg, tree, params = rwkv_models
    rng = np.random.default_rng(6)
    rcache = ref_init_cache(ref_cfg, 1, 8, dtype=jnp.float32)
    cache = init_cache(cfg, 1, 8, device="cpu")
    for pos, S in ((0, 4), (4, 3)):
        toks = rng.integers(0, cfg.vocab, (1, S))
        want, rcache, _ = ref_forward(tree, ref_cfg, RefRuntime(),
                                      jnp.asarray(toks), mode="prefill",
                                      cache=rcache, cache_pos=pos)
        got, cache, _ = forward(params, cfg, Runtime(),
                                torch.from_numpy(toks), mode="prefill",
                                cache=cache, cache_pos=pos)
        assert _rel(got, want) < REL_TOL, pos
        for k in cache:
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(rcache[k]), atol=1e-4,
                                       rtol=1e-4)
