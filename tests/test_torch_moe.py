"""The port's MoE stack and DeepSeek-V2's latent attention against the JAX
package's: granite-moe-3b-a800m (40 experts top-8 at full width) and
deepseek-v2-lite-16b (MLA, shared experts, a leading dense layer).

The reduced configurations in fp32, the JAX package's own ``init_params``
tree (its norm scales drawn away from 1 so every norm is live) carried
across by ``params_from_reference``; inputs from numpy seeds.  The
reference keys the unnormalised top-k weights on the full model's name,
so deepseek's reduced configuration also runs renamed to
"deepseek-v2-lite-16b" (``norm_topk=False``) on both sides.

Tolerances: logits within 1e-4 of max |logit| (the attention sums and the
expert sums run in another order: the reference's dense MoE sums all E
experts, most weighted by zero, the port's dropless dispatch only the k);
the aux loss within 1e-5 relative; a single MoE block within 1e-5 of its
largest output."""
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
from repro.models import moe as ref_moe
from repro.models import params as ref_params
from repro.models.attention import mla_attention_block as ref_mla
from repro.models.transformer import Runtime as RefRuntime
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import init_cache as ref_init_cache
from repro_torch.configs import ARCHS, get_config, get_reduced_config
from repro_torch.models import attention, moe
from repro_torch.models import params as P_
from repro_torch.models.transformer import Runtime, forward, init_cache

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (moe_dense_formula, the card's yardstick)

GRANITE, DEEPSEEK = "granite-moe-3b-a800m", "deepseek-v2-lite-16b"
# (arch, renamed to the full model's name: deepseek's norm_topk=False)
CASES = [(GRANITE, False), (DEEPSEEK, False), (DEEPSEEK, True)]
REL_TOL = 1e-4
AUX_TOL = 1e-5
PROMPT = 20


def _ids(case):
    return f"{case[0]}{'-as-full' if case[1] else ''}"


@functools.lru_cache(maxsize=None)
def _ref_fn(ref_cfg, mode):
    """The reference's ``forward`` in ``mode``, jitted once a configuration
    (its decode steps then share one compile)."""
    return jax.jit(lambda tree, toks, cache, pos: ref_forward(
        tree, ref_cfg, RefRuntime(), toks, mode=mode, cache=cache,
        cache_pos=pos))


def ref_run(tree, ref_cfg, toks, *, mode, cache=None, cache_pos=None):
    return _ref_fn(ref_cfg, mode)(tree, jnp.asarray(toks), cache, cache_pos)


def _rel(port, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(port.float().numpy() - ref).max()) / \
        float(np.abs(ref).max())


def _configs(arch, rename):
    ref_cfg = dataclasses.replace(ref_reduced(arch), dtype="float32",
                                  remat=False)
    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    if rename:
        ref_cfg = dataclasses.replace(ref_cfg, name=arch)
        cfg = dataclasses.replace(cfg, name=arch)
    return ref_cfg, cfg


def _pair(arch, rename):
    """(reference config, port config, reference tree, port params)."""
    ref_cfg, cfg = _configs(arch, rename)
    tree = jax.tree.map(np.asarray, jax.jit(
        ref_params.init_params, static_argnums=(1, 2))(
            jax.random.PRNGKey(0), ref_cfg, jnp.float32))
    rng = np.random.default_rng(1)
    for key in ("layers", "dense_layers"):
        for k, v in tree.get(key, {}).items():
            if k.startswith("ln") or k.endswith("_norm"):
                tree[key][k] = (1.0 + 0.2 * rng.standard_normal(
                    v.shape)).astype(np.float32)
    return ref_cfg, cfg, tree, P_.params_from_reference(tree, cfg,
                                                        device="cpu")


@pytest.fixture(scope="module", params=CASES, ids=_ids)
def model(request):
    return _pair(*request.param)


def _moe_params(tree, layer=0):
    """One MoE layer's router, experts and shared experts (numpy)."""
    return {k: np.array(v[layer]) for k, v in tree["layers"].items()
            if k.startswith(("router", "we_", "shared_"))}


def _norm_topk(cfg):
    return cfg.name != DEEPSEEK


def test_configs_equal_the_reference():
    """``ARCHS`` is the reference's list, in its order; the MoE
    configurations (full and reduced) are the reference's field for
    field."""
    assert ARCHS == REF_ARCHS
    for arch in (GRANITE, DEEPSEEK):
        for port, ref in ((get_config(arch), ref_get_config(arch)),
                          (get_reduced_config(arch), ref_reduced(arch))):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    with pytest.raises(KeyError):
        get_config("granite-moe-1b")


def test_params_from_reference_carries_every_leaf(model):
    _, cfg, tree, params = model
    assert set(params) == set(tree)
    for key, sub in tree.items():
        if isinstance(sub, dict):
            assert set(params[key]) == set(sub)
            for k, arr in sub.items():
                assert np.array_equal(params[key][k].numpy(), arr), (key, k)
        else:
            assert np.array_equal(params[key].numpy(), sub), key
    lay = params["layers"]
    n_moe = cfg.n_layers - cfg.first_k_dense
    assert tuple(lay["we_in"].shape) == (n_moe, cfg.n_experts, cfg.d_model,
                                         cfg.d_expert)
    if cfg.first_k_dense:
        dense = params["dense_layers"]
        assert tuple(dense["w_in"].shape) == (cfg.first_k_dense, cfg.d_model,
                                              cfg.dense_d_ff)
        assert "router" not in dense
    if cfg.mla:
        assert tuple(lay["wq"].shape[1:]) == (
            cfg.d_model, cfg.n_heads * (cfg.head_dim + cfg.rope_head_dim))
        assert "kv_norm" in lay and "wk" not in lay


def test_init_params_follows_the_reference_template(model, monkeypatch):
    """The port's random tree has the reference's keys and shapes; an
    expert's weights keep their std of 1 / sqrt(fan in) drawn in row
    blocks; the same seed gives the same tree."""
    _, cfg, tree, _ = model
    monkeypatch.setattr(P_, "_DRAW_ELEMS", 1000)
    p = P_.init_params(cfg, seed=3, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), tree)
    assert shapes == {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
                          if isinstance(v, dict) else tuple(v.shape))
                      for k, v in p.items()}
    for name, fan_in in (("we_in", cfg.d_model), ("we_out", cfg.d_expert),
                         ("router", cfg.d_model)):
        w = p["layers"][name].float()
        assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05, name
    again = P_.init_params(cfg, seed=3, device="cpu")
    for key, sub in p.items():
        for k, t in (sub.items() if isinstance(sub, dict) else [("", sub)]):
            other = again[key][k] if k else again[key]
            assert torch.equal(t, other), (key, k)


@pytest.mark.parametrize("arch", [GRANITE, DEEPSEEK])
def test_param_count_of_the_full_config_equals_the_reference(arch):
    """The template's elements at full width equal the JAX template's and
    ``ModelConfig.param_count()`` plus the norms (two a layer, the final
    norm and MLA's ``kv_norm``)."""
    cfg = get_config(arch)
    n = sum(int(np.prod(((m[1],) if m[1] else ()) + m[0].shape))
            for sub in P_._finalize(cfg, lambda m, n: (m, n)).values()
            for m in (sub.values() if isinstance(sub, dict) else [sub]))
    ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        ref_params.abstract_params(ref_get_config(arch))))
    assert n == ref
    norms = cfg.n_layers * (2 * cfg.d_model + cfg.kv_lora_rank) + cfg.d_model
    assert n == cfg.param_count() + norms
    assert cfg.param_count() == ref_get_config(arch).param_count()


def _moe_input(cfg, B, S, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)


def test_router_probs_and_aux_losses_equal_the_reference(model):
    ref_cfg, cfg, tree, params = model
    blk = _moe_params(tree)
    x = _moe_input(cfg, 2, 16, 5).reshape(-1, cfg.d_model)
    want_g, want_l = ref_moe.router_probs(jnp.asarray(x), blk["router"])
    got_g, got_l = moe.router_probs(torch.from_numpy(x),
                                    torch.from_numpy(np.array(blk["router"])))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-5,
                               rtol=1e-5)
    _, ids = jax.lax.top_k(want_g, cfg.top_k)
    want = ref_moe.aux_losses(want_g, ids, cfg.n_experts)
    got = moe.aux_losses(got_g, torch.from_numpy(np.asarray(ids)).long(),
                         cfg.n_experts)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= AUX_TOL * abs(float(want))


@pytest.mark.parametrize("shape", [(2, 16), (4, 1)])
def test_moe_block_dense_equals_the_reference(model, shape):
    """The dropless dispatch against the reference's dense mode (every
    expert for every token, weighted by the top-k-sparse gate), on a
    prefill's tokens and on a 4-token decode batch; and against the
    all-experts formula the card check holds it to."""
    ref_cfg, cfg, tree, params = model
    blk = _moe_params(tree)
    x = _moe_input(cfg, *shape, 6)
    want, want_aux = ref_moe.moe_block(
        {k: jnp.asarray(v) for k, v in blk.items()}, jnp.asarray(x), ref_cfg,
        mesh=None, norm_topk=_norm_topk(cfg), impl="dense")
    tblk = {k: torch.from_numpy(v) for k, v in blk.items()}
    got, aux = moe.moe_block(tblk, torch.from_numpy(x), cfg,
                             norm_topk=_norm_topk(cfg), impl="dense")
    assert _rel(got, want) < 1e-5
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL * abs(float(want_aux))
    auto, _ = moe.moe_block(tblk, torch.from_numpy(x), cfg,
                            norm_topk=_norm_topk(cfg))
    assert torch.equal(auto, got)
    formula, faux = chip_smoke.moe_dense_formula(cfg, tblk,
                                                 torch.from_numpy(x),
                                                 _norm_topk(cfg))
    assert _rel(formula, want) < 1e-5
    assert abs(float(faux) - float(want_aux)) <= AUX_TOL * abs(float(want_aux))


@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_moe_block_capacity_equals_the_reference_mesh_path(model, cf):
    """``impl="capacity"`` against the reference's shard_map path on a
    (1, 1) mesh: at capacity factor 8 nothing drops (and both equal the
    dense mode); at 0.25 pairs past the capacity drop.  The dispatch
    tables (token ids, combine weights, gathered rows) are equal too."""
    ref_cfg, cfg, tree, params = model
    ref_cfg = dataclasses.replace(ref_cfg, capacity_factor=cf)
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    blk = _moe_params(tree)
    x = _moe_input(cfg, 2, 32, 7)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    want, want_aux = ref_moe.moe_block(
        {k: jnp.asarray(v) for k, v in blk.items()}, jnp.asarray(x), ref_cfg,
        mesh=mesh, norm_topk=_norm_topk(cfg))
    tblk = {k: torch.from_numpy(v) for k, v in blk.items()}
    got, aux = moe.moe_block(tblk, torch.from_numpy(x), cfg,
                             norm_topk=_norm_topk(cfg), impl="capacity")
    assert _rel(got, want) < 1e-5
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL * abs(float(want_aux))

    T, k, E = 64, cfg.top_k, cfg.n_experts
    C = moe._capacity(T, k, E, cf)
    assert C == ref_moe._capacity(T, k, E, cf)
    xf = x.reshape(T, -1)
    gates, _ = ref_moe.router_probs(jnp.asarray(xf), blk["router"])
    rxe, rtable, rw = ref_moe._dispatch_local(jnp.asarray(xf), gates, k, C,
                                              _norm_topk(cfg))
    xe, table, wtable = moe._dispatch_local(
        torch.from_numpy(xf), torch.from_numpy(np.asarray(gates)), k, C,
        _norm_topk(cfg))
    assert np.array_equal(table.numpy(), np.asarray(rtable))
    np.testing.assert_allclose(wtable.numpy(), np.asarray(rw), atol=1e-7,
                               rtol=1e-6)
    assert np.array_equal(xe.numpy(), np.asarray(rxe))
    kept = int((table < T).sum())
    if cf == 8.0:
        assert kept == T * k
        dense, _ = moe.moe_block(tblk, torch.from_numpy(x), cfg,
                                 norm_topk=_norm_topk(cfg), impl="dense")
        assert _rel(got, np.asarray(dense)) < 1e-5
    else:
        assert C == 8 and kept < T * k    # pairs dropped


def test_moe_block_refuses_an_unknown_impl(model):
    _, cfg, tree, _ = model
    blk = {k: torch.from_numpy(v) for k, v in _moe_params(tree).items()}
    with pytest.raises(ValueError, match="impl"):
        moe.moe_block(blk, torch.zeros((1, 2, cfg.d_model)), cfg,
                      impl="sparse")


@pytest.mark.parametrize("case", ["train", "prefill", "decode",
                                  "decode_per_slot"])
def test_mla_attention_block_equals_the_reference(case):
    """``mla_attention_block`` against the reference's (no absorption):
    without a cache over 6 positions, a prefill of 6 from position 0 into
    a cache of 12, and one token against a cache of random latents at
    position 7 or at per-slot depths (7, 3); the output and the latent
    cache equal the reference's."""
    ref_cfg, cfg = _configs(DEEPSEEK, False)
    tree = jax.tree.map(np.asarray, ref_params.init_params(
        jax.random.PRNGKey(2), ref_cfg, jnp.float32))
    rblk = {k: jnp.asarray(w[0]) for k, w in tree["layers"].items()}
    blk = {k: torch.from_numpy(np.array(w[0]))
           for k, w in tree["layers"].items()}
    rng = np.random.default_rng(9)
    B, Smax = 2, 12
    lat_w = cfg.kv_lora_rank + cfg.rope_head_dim
    S = 1 if case.startswith("decode") else 6
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if case in ("train", "prefill"):
        pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        cpos = 0
    else:
        cpos = np.array([7, 3], np.int32) if case == "decode_per_slot" else 7
        pos = (np.zeros((B, 1), np.int32) + np.reshape(cpos, (-1, 1)))
    lat0 = None if case == "train" else (
        np.zeros((B, Smax, lat_w), np.float32) if case == "prefill" else
        rng.standard_normal((B, Smax, lat_w)).astype(np.float32))
    rcache = None if lat0 is None else {"lat": jnp.asarray(lat0)}
    cache = None if lat0 is None else {"lat": torch.from_numpy(lat0.copy())}
    want, rnew = ref_mla(rblk, jnp.asarray(x), ref_cfg,
                         positions=jnp.asarray(pos), cache=rcache,
                         cache_pos=jnp.asarray(cpos))
    tpos = torch.from_numpy(cpos) if isinstance(cpos, np.ndarray) else cpos
    got, new = attention.mla_attention_block(
        blk, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos),
        cache=cache, cache_pos=tpos)
    assert tuple(got.shape) == (B, S, cfg.d_model)
    assert _rel(got, want) < REL_TOL
    if cache is None:
        assert new is None
    else:
        assert new is cache
        np.testing.assert_allclose(cache["lat"].numpy(),
                                   np.asarray(rnew["lat"]), atol=1e-6,
                                   rtol=1e-6)
        assert not np.array_equal(cache["lat"].numpy(), lat0)


def _deepseek_port():
    cfg = dataclasses.replace(get_reduced_config(DEEPSEEK), dtype="float32")
    return cfg, P_.init_params(cfg, seed=0, device="cpu")


def test_absorbed_mla_raises_naming_its_roadmap_item():
    """The absorbed MLA: ``mla_attention_block(absorb=True)``
    at a prefill equals the reference's within 1e-4 of max |out|, and
    ``forward`` under ``Runtime(mla_absorb=True)`` the reference's under
    ``Runtime(mesh=None, mla_absorb=True)`` (logits within 1e-4, aux loss
    within 1e-5)."""
    ref_cfg, cfg, tree, params = _pair(DEEPSEEK, False)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 5, cfg.d_model)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None]
    rblk = {k: jnp.asarray(w[0]) for k, w in tree["layers"].items()}
    want, _ = ref_mla(rblk, jnp.asarray(x), ref_cfg,
                      positions=jnp.asarray(pos), absorb=True)
    got, _ = attention.mla_attention_block(
        {k: w[0] for k, w in params["layers"].items()}, torch.from_numpy(x),
        cfg, positions=torch.from_numpy(pos), absorb=True)
    assert _rel(got, want) < REL_TOL
    toks = rng.integers(0, cfg.vocab, (1, 6))
    want, _, want_aux = jax.jit(lambda t, k: ref_forward(
        t, ref_cfg, RefRuntime(mesh=None, mla_absorb=True), k))(
            tree, jnp.asarray(toks))
    got, _, aux = forward(params, cfg, Runtime(mla_absorb=True),
                          torch.from_numpy(toks))
    assert _rel(got, want) < REL_TOL
    assert float(aux) == pytest.approx(float(want_aux), rel=AUX_TOL)


def test_forward_train_equals_reference(model):
    ref_cfg, cfg, tree, params = model
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, PROMPT))
    want, _, want_aux = ref_run(tree, ref_cfg, toks, mode="train")
    got, cache, aux = forward(params, cfg, Runtime(), torch.from_numpy(toks),
                              mode="train")
    assert cache is None
    assert tuple(got.shape) == (2, PROMPT, cfg.vocab)
    assert _rel(got, want) < REL_TOL
    assert float(want_aux) > 0
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL * float(want_aux)


@pytest.mark.parametrize("vector_pos", [False, True])
def test_prefill_then_decode_equals_reference(model, vector_pos):
    """Prefill a 20-token prompt from position 0, then three decode steps
    at one scalar position or at per-row depths (row 1 rewinds by three
    positions, as a reused engine slot does): logits, aux loss and the
    cache (k/v, or MLA's latents) equal the reference's."""
    ref_cfg, cfg, tree, params = model
    rng = np.random.default_rng(3)
    B, Smax = 2, 32
    toks = rng.integers(0, cfg.vocab, (B, PROMPT))
    rcache = ref_init_cache(ref_cfg, B, Smax, dtype=jnp.float32)
    cache = init_cache(cfg, B, Smax, device="cpu")
    assert set(cache) == set(rcache)
    want, rcache, want_aux = ref_run(tree, ref_cfg, toks, mode="prefill",
                                     cache=rcache, cache_pos=0)
    got, cache, aux = forward(params, cfg, Runtime(), torch.from_numpy(toks),
                              mode="prefill", cache=cache, cache_pos=0)
    assert tuple(got.shape) == (B, 1, cfg.vocab)
    assert _rel(got, want) < REL_TOL
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL * float(want_aux)
    pos = np.array([PROMPT, PROMPT - 3], np.int32) if vector_pos else PROMPT
    for step in range(3):
        tok = rng.integers(0, cfg.vocab, (B, 1))
        rpos = jnp.asarray(pos, jnp.int32)
        tpos = torch.from_numpy(pos) if vector_pos else pos
        want, rcache, want_aux = ref_run(tree, ref_cfg, tok, mode="decode",
                                         cache=rcache, cache_pos=rpos)
        got, cache, aux = forward(params, cfg, Runtime(),
                                  torch.from_numpy(tok), mode="decode",
                                  cache=cache, cache_pos=tpos)
        assert _rel(got, want) < REL_TOL, step
        assert abs(float(aux) - float(want_aux)) <= \
            AUX_TOL * float(want_aux), step
        pos = pos + 1
    for key in cache:
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(rcache[key]), atol=1e-5,
                                   rtol=1e-5)


def test_decode_equals_train_forward(model):
    """The port's own check: a prefill of all but the last token and one
    decode step give the train-mode logits of the last position."""
    _, cfg, _, params = model
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, PROMPT + 1)))
    full, _, _ = forward(params, cfg, Runtime(), toks, mode="train")
    cache = init_cache(cfg, 2, PROMPT + 1, device="cpu")
    forward(params, cfg, Runtime(), toks[:, :-1], mode="prefill",
            cache=cache, cache_pos=0)
    last, _, _ = forward(params, cfg, Runtime(), toks[:, -1:], mode="decode",
                         cache=cache, cache_pos=PROMPT)
    err = float((last[:, 0] - full[:, -1]).abs().max()) / \
        float(full.abs().max())
    assert err < REL_TOL


def test_attention_calls_go_through_the_kernel_wrappers(model, monkeypatch):
    """Every attention call of a prefill and a decode step reaches
    ``flash_attention`` or ``decode_attention``: granite's GQA at its head
    dim; deepseek's MLA with q, k and v all ``hd + r`` wide (V zero-padded
    past ``hd``), H = KV, the decode over the whole cache with kv_len at
    the new token."""
    _, cfg, _, params = model
    calls = []
    real_flash, real_decode = attention.flash_attention, \
        attention.decode_attention

    def flash(q, k, v, *, causal=True, window=0):
        calls.append(("flash", causal, window, q.shape[-1], k.shape[1:],
                      tuple(v.shape) == tuple(k.shape)))
        if cfg.mla:
            assert float(v[..., cfg.head_dim:].abs().max()) == 0.0
        return real_flash(q, k, v, causal=causal, window=window)

    def decode(q, k, v, kv_len, *, window=0):
        calls.append(("decode", window, q.shape[-1], k.shape[1:],
                      tuple(kv_len.tolist())))
        return real_decode(q, k, v, kv_len, window=window)

    monkeypatch.setattr(attention, "flash_attention", flash)
    monkeypatch.setattr(attention, "decode_attention", decode)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, PROMPT)))
    Smax = PROMPT + 4
    cache = init_cache(cfg, 2, Smax, device="cpu")
    forward(params, cfg, Runtime(), toks, mode="prefill", cache=cache,
            cache_pos=0)
    n_pre = len(calls)
    forward(params, cfg, Runtime(), toks[:, :1], mode="decode", cache=cache,
            cache_pos=torch.tensor([PROMPT, PROMPT - 2], dtype=torch.int32))
    L = cfg.n_layers
    hd = cfg.head_dim + cfg.rope_head_dim
    KV = cfg.n_heads if cfg.mla else cfg.n_kv_heads
    assert calls[:n_pre] == [("flash", True, 0, hd, (PROMPT, KV, hd),
                              True)] * L
    assert calls[n_pre:] == [("decode", 0, hd, (Smax, KV, hd),
                              (PROMPT + 1, PROMPT - 1))] * L


def test_gqa_block_refuses_an_mla_configuration():
    """``attention_block`` is the GQA block: an MLA configuration's
    self-attention is ``mla_attention_block`` and the GQA block says so."""
    cfg, params = _deepseek_port()
    blk = {k: w[0] for k, w in params["layers"].items()}
    with pytest.raises(ValueError, match="mla_attention_block"):
        attention.attention_block(blk, torch.zeros((1, 2, cfg.d_model)), cfg,
                                  positions=torch.arange(2)[None], window=0)


def test_engine_decodes_with_per_slot_depths():
    """deepseek-reduced (fp32) in a ``ReplicaEngine`` of three slots at
    different depths: every step's logits of a slot equal the train-mode
    logits of that slot's whole sequence at its last position (the latent
    cache written per slot in place through the engine's slot views)."""
    from repro_torch.serving.engine import ReplicaEngine
    cfg = dataclasses.replace(get_reduced_config(DEEPSEEK), dtype="float32")
    params = P_.init_params(cfg, seed=1, device="cpu")
    eng = ReplicaEngine(cfg, params, slots=3, max_len=32, eos_id=-1)
    logits = []
    decode = eng._decode
    eng._decode = lambda *a: (logits.append(decode(*a)), logits[-1])[1]
    prompts = {1: [5, 6, 7], 2: list(range(20, 32)), 3: list(range(40, 47))}
    for rid, p in prompts.items():
        eng.admit(rid, p, 10)
    for _ in range(5):
        eng.step()
    assert sorted(int(p) for p in eng.pos) == [8, 12, 17]
    for slot, rid in ((0, 1), (1, 2), (2, 3)):
        seq = eng.seqs[rid].tokens
        full, _, _ = forward(params, cfg, Runtime(), torch.tensor([seq]),
                             mode="train")
        n0 = len(seq) - 6          # the prompt and its first token
        for i, step in enumerate(logits):
            want = full[0, n0 + i]
            err = float((step[slot] - want).abs().max()) / \
                float(want.abs().max())
            assert err < REL_TOL, (rid, i)


def test_serve_real_stats_equal_the_reference_on_reduced_granite():
    """chip_smoke.py's phase-8 requests through serve_real on the reduced
    granite: the port's stats equal the JAX package's and
    ``REF_SERVE_STATS``, which the card run holds at full width."""
    from repro.launch.serve import serve_real as ref_serve_real
    from repro.serving.scheduler import Request as RefRequest
    from repro_torch.launch.serve import serve_real
    ref_cfg, cfg = _configs(GRANITE, False)
    tree = jax.tree.map(np.asarray, ref_params.init_params(
        jax.random.PRNGKey(0), ref_cfg, jnp.float32))
    params = P_.params_from_reference(tree, cfg, device="cpu")
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


@pytest.mark.parametrize("arch", [GRANITE, DEEPSEEK])
def test_serve_cli_on_the_cpu(arch, capsys):
    from repro_torch.launch.serve import main as serve_main
    serve_main(["--requests", "4", "--real", "--device", "cpu", "--arch",
                arch])
    assert "real engines (greedy, cpu)" in capsys.readouterr().out
