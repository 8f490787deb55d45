"""The rest of the attention module in the port against the JAX package's:
chunked prefill (more tokens than one at a nonzero cache position, a scalar
or a per-slot offset), the int8 KV cache (``quant_kv`` on write, the
dequantized cache read on every call), the logit softcap, and the absorbed
MLA path (``Runtime(mla_absorb=True)``), on the reduced configurations in
fp32 with the plain versions of the kernels on the CPU.

The reference's functions run jitted.  Its parameters are its own
``init_params`` trees with every constant leaf drawn live
(``test_torch_train.live_tree``), carried across by
``params_from_reference``.  Tolerances, those of ``test_torch_model.py``:
an attention block's output within 2e-5 of its max |out| (one attention
call; the sums run in another order), logits within 1e-4 of max |logit|,
gradient leaves within 1e-4 of each leaf's max |g|.  ``quant_kv`` is held
bit for bit, the int8 cache's rows to one step of 127 where fp32 ulps of
the projections land on a rounding edge.

The softcap: the reference's ``gqa_attention`` caps its scores, but its
blocks never pass ``cfg.logit_softcap`` to it, so its models ignore the
field, and the port's blocks do as well.  The tests hold the port's blocks
and models with the field set to the reference's, and the port's
attention calls with a cap (forward and backward) to ``gqa_attention``
given the same cap.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as ref_reduced
from repro.models import attention as ref_attn
from repro.models import transformer as ref_tf
from repro.train import train_step as ref_step
from repro_torch.configs import get_reduced_config
from repro_torch.models import attention as attn
from repro_torch.models import params as P_
from repro_torch.models import transformer as tf
from repro_torch.train import train_step as step_
from repro_torch.train.tree import leaves
from test_torch_train import live_tree

BLOCK_TOL = 2e-5
REL_TOL = 1e-4
GRAD_TOL = 1e-4
SMAX = 12


def _cfgs(arch, **kw):
    ref = dataclasses.replace(ref_reduced(arch), dtype="float32",
                              remat=False, **kw)
    port = dataclasses.replace(get_reduced_config(arch), dtype="float32",
                               **kw)
    return ref, port


def _rel(port, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(port.detach().float().numpy() - ref).max()) / \
        float(np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def _tree(ref_cfg):
    return live_tree(ref_cfg)


def _blocks(ref_cfg, cfg):
    """Layer 0's weights: the reference's (jnp) and the port's (torch)."""
    tree = _tree(ref_cfg)
    return ({k: jnp.asarray(w[0]) for k, w in tree["layers"].items()},
            {k: torch.from_numpy(np.array(w[0]))
             for k, w in tree["layers"].items()})


def _cache(rng, cfg, int8, B=2):
    """A cache of ``SMAX`` positions holding random rows (earlier tokens'
    keys and values, finite past them too), as numpy arrays."""
    shape = (B, SMAX, cfg.n_kv_heads, cfg.head_dim)
    if not int8:
        return {n: rng.standard_normal(shape).astype(np.float32)
                for n in ("k", "v")}
    return {"k_q": rng.integers(-127, 128, shape).astype(np.int8),
            "v_q": rng.integers(-127, 128, shape).astype(np.int8),
            "k_s": rng.uniform(0.001, 0.02, shape[:-1] + (1,)).astype(
                np.float32),
            "v_s": rng.uniform(0.001, 0.02, shape[:-1] + (1,)).astype(
                np.float32)}


def _caches_equal(port, ref):
    assert set(port) == set(ref)
    for name, want in ref.items():
        got, want = port[name].numpy(), np.asarray(want)
        assert got.dtype == want.dtype, name
        if name in ("k_q", "v_q"):
            d = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert d.max() <= 1 and (d == 0).mean() >= 0.999, name
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=name)


def _run_block(*, int8, S, pos, window, softcap, mode, arch="qwen2.5-14b"):
    """attention_block of the port and of the reference (jitted) on the
    same inputs: ``mode`` "train" (no cache) or "cache" (``S`` tokens at
    ``pos``, an int or a per-slot list).  Returns (port out, reference
    out, port cache, reference cache)."""
    ref_cfg, cfg = _cfgs(arch, kv_cache_int8=int8, logit_softcap=softcap)
    rblk, blk = _blocks(ref_cfg, cfg)
    rng = np.random.default_rng(S * 7 + window + int(int8))
    B = 2
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    p0 = np.broadcast_to(np.asarray(pos, np.int32), (B,))
    positions = (p0[:, None] + np.arange(S, dtype=np.int32)).astype(np.int32)
    cpos = np.asarray(pos, np.int32)
    cache = None if mode == "train" else _cache(rng, cfg, int8)

    def ref(blk_, x_, pos_, cache_, cpos_):
        return ref_attn.attention_block(blk_, x_, ref_cfg, positions=pos_,
                                        window=window, cache=cache_,
                                        cache_pos=cpos_)
    want, rcache = jax.jit(ref)(rblk, jnp.asarray(x), jnp.asarray(positions),
                                None if cache is None else
                                {k: jnp.asarray(v) for k, v in cache.items()},
                                jnp.asarray(cpos))
    tcache = None if cache is None else \
        {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tpos = pos if isinstance(pos, int) else torch.from_numpy(cpos)
    got, new = attn.attention_block(blk, torch.from_numpy(x), cfg,
                                    positions=torch.from_numpy(positions),
                                    window=window, cache=tcache,
                                    cache_pos=tpos)
    return got, want, new, rcache


def test_quant_kv_is_the_jitted_reference_bit_for_bit():
    """``quant_kv`` on fp32 and bf16 rows (a zero row, rows scaled over
    six decades, values on the rounding edges of their own scale) equals
    ``jax.jit(quant_kv)`` bit for bit: the int8 values and the scales."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 40, 4, 16)).astype(np.float32)
    x *= 10.0 ** rng.uniform(-3, 3, (3, 40, 4, 1)).astype(np.float32)
    x[0, 0, 0] = 0.0
    top = np.abs(x[1, :, :, :1]) + 1.0      # each row's absmax, then edges
    x[1, :, :, 1:] = top * (np.arange(15, dtype=np.float32) + 0.5) / 127
    x[1, :, :, :1] = top
    ref = jax.jit(ref_attn.quant_kv)
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        t = torch.from_numpy(x).to(dtype)
        q, s = attn.quant_kv(t)
        rq, rs = ref(jnp.asarray(t.float().numpy()).astype(jdt))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert np.array_equal(q.numpy(), np.asarray(rq))
        assert np.array_equal(s.numpy().view(np.int32),
                              np.asarray(rs).view(np.int32))


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "hymba-1.5b",
                                  "deepseek-v2-lite-16b"])
def test_init_cache_int8_equals_the_reference(arch):
    """``init_cache`` with ``kv_cache_int8``: a dense configuration's
    int8 ``k_q`` / ``v_q`` (zeros) and fp32 ``k_s`` / ``v_s`` (ones);
    hymba's also its fp32 ``ssm``; MLA's latent in the compute type, as
    the reference's MLA branch comes first."""
    ref_cfg, cfg = _cfgs(arch, kv_cache_int8=True)
    want = ref_tf.init_cache(ref_cfg, 2, SMAX, dtype=jnp.float32)
    got = tf.init_cache(cfg, 2, SMAX, device="cpu")
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        assert tuple(got[name].shape) == w.shape, name
        assert got[name].numpy().dtype == w.dtype, name
        assert np.array_equal(got[name].numpy(), w), name


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("pos", [5, [5, 2]], ids=["scalar", "per_slot"])
def test_chunked_prefill_block_equals_the_reference(pos, window):
    """Three tokens at a nonzero position of a cache of random earlier
    rows, a scalar and a per-slot offset, with and without a window of 4
    (binding: the chunk's queries see 4 keys each): the block's output and
    the cache as written."""
    got, want, cache, rcache = _run_block(int8=False, S=3, pos=pos,
                                          window=window, softcap=0.0,
                                          mode="cache")
    assert _rel(got, want) < BLOCK_TOL
    _caches_equal(cache, rcache)


@pytest.mark.parametrize("S,pos", [(6, 0), (3, 5), (3, [5, 2]), (1, 7),
                                   (1, [7, 3])],
                         ids=["prefill", "chunk", "chunk_per_slot",
                              "decode", "decode_per_slot"])
@pytest.mark.parametrize("window", [0, 4])
def test_int8_cache_block_equals_the_reference(S, pos, window):
    """An int8 cache: a prefill from 0 (which reads the dequantized cache
    rows it just wrote, not the fresh k and v), chunks and decode steps at
    scalar and per-slot positions: the output and the int8 cache."""
    got, want, cache, rcache = _run_block(int8=True, S=S, pos=pos,
                                          window=window, softcap=0.0,
                                          mode="cache")
    assert _rel(got, want) < BLOCK_TOL
    _caches_equal(cache, rcache)


@pytest.mark.parametrize("S,pos,mode,int8", [
    (6, 0, "train", False), (6, 0, "cache", False), (3, 5, "cache", False),
    (1, [7, 3], "cache", False), (6, 0, "cache", True),
    (3, 5, "cache", True), (1, [7, 3], "cache", True)],
    ids=["train", "prefill", "chunk", "decode", "int8_prefill",
         "int8_chunk", "int8_decode"])
def test_softcap_block_equals_the_capped_reference(S, pos, mode, int8):
    """Train, prefill, chunked prefill and decode, over a bf16 / fp32 and
    an int8 cache: the block with ``logit_softcap`` 0.5 in its
    configuration equals the reference's block with the same
    configuration (neither applies the field), and the attention call the
    block makes there, given a cap of 0.5 (binding on these scores), equals
    the reference's ``gqa_attention`` given the same cap, and differs from
    it without the cap."""
    got, want, _, _ = _run_block(int8=int8, S=S, pos=pos, window=0,
                                 softcap=0.5, mode=mode)
    assert _rel(got, want) < BLOCK_TOL
    got, want = _capped_call(S, pos, mode, int8, 0.5)
    assert _rel(got, want) < BLOCK_TOL
    uncapped, _ = _capped_call(S, pos, mode, int8, 0.0)
    assert _rel(uncapped, want) > 1e-3


def _capped_call(S, pos, mode, int8, softcap, H=4, KV=2, hd=16):
    """The call ``attention_block`` makes for ``S`` tokens at ``pos`` (no
    cache in "train"), made directly through the port's wrappers with
    ``softcap``, and the reference's ``gqa_attention`` given a cap of 0.5
    on the same inputs: (port out, reference out)."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(S * 11 + int(int8))
    B = 2
    q = (2.0 * rng.standard_normal((B, S, H, hd))).astype(np.float32)
    p0 = np.broadcast_to(np.asarray(pos, np.int32), (B,))
    qpos = (p0[:, None] + np.arange(S, dtype=np.int32)).astype(np.int32)
    if mode == "train":
        k, v = (rng.standard_normal((B, S, KV, hd)).astype(np.float32)
                for _ in range(2))
        kpos, kv_len, kv = qpos, None, {}
    else:
        c = _cache(rng, dataclasses.replace(
            _cfgs("qwen2.5-14b")[1], n_kv_heads=KV, head_dim=hd), int8, B)
        k, v = (c["k"], c["v"]) if not int8 else (c["k_q"], c["v_q"])
        kv = {} if not int8 else {"k_scale": c["k_s"], "v_scale": c["v_s"]}
        kpos = np.arange(SMAX, dtype=np.int32)[None]
        kv_len = (p0 + S).astype(np.int32)
    t = {n: torch.from_numpy(np.ascontiguousarray(a))
         for n, a in dict(q=q, k=k, v=v, **kv).items()}
    extra = {n: t[n] for n in kv}
    if mode == "train" or (isinstance(pos, int) and pos == 0 and not int8):
        got = ops.flash_attention(t["q"], t["k"], t["v"], causal=True,
                                  softcap=softcap)
    elif S == 1:
        got = ops.decode_attention(t["q"][:, 0], t["k"], t["v"],
                                   torch.from_numpy(kv_len), softcap=softcap,
                                   **extra)[:, None]
    else:
        got = ops.flash_attention(t["q"], t["k"], t["v"], causal=True,
                                  q_offset=torch.from_numpy(p0.copy()),
                                  kv_len=torch.from_numpy(kv_len),
                                  softcap=softcap, **extra)
    if int8:
        k = ref_attn.dequant_kv(jnp.asarray(k), jnp.asarray(kv["k_scale"]),
                                jnp.float32)
        v = ref_attn.dequant_kv(jnp.asarray(v), jnp.asarray(kv["v_scale"]),
                                jnp.float32)
    want = jax.jit(functools.partial(
        ref_attn.gqa_attention, causal=True, window=0, softcap=0.5))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos), k_positions=jnp.asarray(kpos),
        kv_len=None if kv_len is None else jnp.asarray(kv_len))
    return got, want


def test_the_reference_blocks_ignore_the_softcap_field():
    """The reference's ``attention_block`` with ``logit_softcap`` 0.5 in
    its configuration returns what it returns at 0, bit for bit (it never
    passes the field on), and so does the port's."""
    ref_cfg, cfg = _cfgs("qwen2.5-14b")
    rblk, blk = _blocks(ref_cfg, cfg)
    x = np.random.default_rng(0).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    outs = [ref_attn.attention_block(
        rblk, jnp.asarray(x), dataclasses.replace(ref_cfg, logit_softcap=c),
        positions=jnp.asarray(pos), window=0)[0] for c in (0.0, 0.5)]
    assert np.array_equal(np.asarray(outs[0]), np.asarray(outs[1]))
    outs = [attn.attention_block(
        blk, torch.from_numpy(x), dataclasses.replace(cfg, logit_softcap=c),
        positions=torch.from_numpy(pos), window=0)[0] for c in (0.0, 0.5)]
    assert torch.equal(outs[0], outs[1])


def _run_mla(S, pos, *, absorb, mode="cache"):
    """mla_attention_block of the port and of the reference (jitted) on
    the same inputs, a cache of random latents; returns (port out,
    reference out, port cache, reference cache)."""
    ref_cfg, cfg = _cfgs("deepseek-v2-lite-16b")
    rblk, blk = _blocks(ref_cfg, cfg)
    rng = np.random.default_rng(S * 5 + int(absorb))
    B = 2
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    p0 = np.broadcast_to(np.asarray(pos, np.int32), (B,))
    positions = (p0[:, None] + np.arange(S, dtype=np.int32)).astype(np.int32)
    cpos = np.asarray(pos, np.int32)
    lat = rng.standard_normal(
        (B, SMAX, cfg.kv_lora_rank + cfg.rope_head_dim)).astype(np.float32)
    cache = None if mode == "train" else {"lat": lat}

    def ref(blk_, x_, pos_, cache_, cpos_):
        return ref_attn.mla_attention_block(blk_, x_, ref_cfg,
                                            positions=pos_, cache=cache_,
                                            cache_pos=cpos_, absorb=absorb)
    want, rcache = jax.jit(ref)(rblk, jnp.asarray(x), jnp.asarray(positions),
                                None if cache is None else
                                {"lat": jnp.asarray(lat)}, jnp.asarray(cpos))
    tcache = None if cache is None else {"lat": torch.from_numpy(lat.copy())}
    tpos = pos if isinstance(pos, int) else torch.from_numpy(cpos)
    got, new = attn.mla_attention_block(
        blk, torch.from_numpy(x), cfg, positions=torch.from_numpy(positions),
        cache=tcache, cache_pos=tpos, absorb=absorb)
    return got, want, new, rcache


@pytest.mark.parametrize("S,pos,mode", [
    (6, 0, "train"), (6, 0, "cache"), (3, 5, "cache"), (3, [5, 2], "cache"),
    (1, 7, "cache"), (1, [7, 3], "cache")],
    ids=["train", "prefill", "chunk", "chunk_per_slot", "decode",
         "decode_per_slot"])
@pytest.mark.parametrize("absorb", [True, False], ids=["absorbed", "naive"])
def test_mla_block_equals_the_reference(S, pos, mode, absorb):
    """``mla_attention_block`` absorbed (``latent_attention`` over the
    latent rows, scale ``(hd + r) ** -0.5``) and not (the chunked prefill
    on the up-projected keys) in train, prefill, chunked prefill and
    decode: the output and the latent cache as written."""
    got, want, cache, rcache = _run_mla(S, pos, absorb=absorb, mode=mode)
    assert _rel(got, want) < BLOCK_TOL
    if mode == "cache":
        np.testing.assert_allclose(cache["lat"].numpy(),
                                   np.asarray(rcache["lat"]), rtol=1e-6,
                                   atol=1e-6)


@functools.lru_cache(maxsize=None)
def _ref_forward(ref_cfg, mode, absorb):
    rt = ref_tf.Runtime(mesh=None, mla_absorb=absorb)
    return jax.jit(lambda tree, toks, cache, pos: ref_tf.forward(
        tree, ref_cfg, rt, toks, mode=mode, cache=cache, cache_pos=pos))


def _model(arch, **kw):
    ref_cfg, cfg = _cfgs(arch, **kw)
    tree = _tree(dataclasses.replace(ref_cfg, kv_cache_int8=False,
                                     logit_softcap=0.0))
    return ref_cfg, cfg, tree, P_.params_from_reference(tree, cfg,
                                                        device="cpu")


def _chunked_requests(arch, absorb=False, **kw):
    """A prompt of 13 tokens prefilled in two chunks (8 from 0, then 5 at
    a scalar 8), a chunk of 3 at per-slot positions (13, 13), then two
    decode steps at per-slot positions: the port's logits of each call
    and the reference's."""
    ref_cfg, cfg, tree, params = _model(arch, **kw)
    rt = tf.Runtime(mla_absorb=absorb)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 18))
    cache = tf.init_cache(cfg, 2, 24, device="cpu")
    rcache = ref_tf.init_cache(ref_cfg, 2, 24, dtype=jnp.float32)
    got, want = [], []
    calls = [("prefill", 0, 8, 0), ("prefill", 8, 13, 8),
             ("prefill", 13, 16, [13, 13]), ("decode", 16, 17, [16, 16]),
             ("decode", 17, 18, [17, 17])]
    for mode, a, b, pos in calls:
        tpos = pos if isinstance(pos, int) else \
            torch.tensor(pos, dtype=torch.int32)
        out, cache, _ = tf.forward(params, cfg, rt, torch.from_numpy(
            toks[:, a:b]), mode=mode, cache=cache, cache_pos=tpos)
        rout, rcache, _ = _ref_forward(ref_cfg, mode, absorb)(
            tree, jnp.asarray(toks[:, a:b]), rcache,
            jnp.asarray(np.asarray(pos, np.int32)))
        got.append(out[:, -1])
        want.append(np.asarray(rout)[:, -1])
    return torch.stack(got), np.stack(want)


@pytest.mark.parametrize("arch,int8", [
    ("qwen2.5-14b", False), ("qwen2.5-14b", True), ("gemma3-12b", False),
    ("gemma3-12b", True), ("hymba-1.5b", False), ("hymba-1.5b", True)])
def test_chunked_prefill_then_decode_equals_the_reference(arch, int8):
    """Reduced qwen2.5-14b, gemma3-12b (its window of 8 binding on the
    local layers) and hymba-1.5b (the SSD state carried into each chunk),
    with a bf16 / fp32 cache and an int8 one: every call's logits."""
    got, want = _chunked_requests(arch, kv_cache_int8=int8)
    assert _rel(got, want) < REL_TOL


@pytest.mark.parametrize("chunked", [False, True])
def test_absorbed_deepseek_forward_equals_the_reference(chunked):
    """Reduced deepseek-v2-lite-16b under ``Runtime(mla_absorb=True)``
    against the reference's ``Runtime(mesh=None, mla_absorb=True)``: the
    train logits, or two prefill chunks, a per-slot chunk and decode
    steps."""
    if chunked:
        got, want = _chunked_requests("deepseek-v2-lite-16b", absorb=True)
        assert _rel(got, want) < REL_TOL
        return
    ref_cfg, cfg, tree, params = _model("deepseek-v2-lite-16b")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 16))
    want, _, want_aux = _ref_forward(ref_cfg, "train", True)(
        tree, jnp.asarray(toks), None, None)
    got, _, aux = tf.forward(params, cfg, tf.Runtime(mla_absorb=True),
                             torch.from_numpy(toks), mode="train")
    assert _rel(got, want) < REL_TOL
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


def _grads(arch, absorb, softcap):
    """The loss and every gradient leaf of the port's ``loss_fn`` and of
    the reference's ``value_and_grad``, ``logit_softcap`` set in both
    configurations."""
    from test_torch_train import _batch, _leaf_rel, _torch_batch
    ref_cfg, cfg, tree, params = _model(arch, logit_softcap=softcap)
    b = _batch(cfg)
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: ref_step.loss_fn(
            p, ref_cfg, ref_tf.Runtime(mesh=None, mla_absorb=absorb), bb),
        has_aux=True))(tree, {k: jnp.asarray(v) for k, v in b.items()})
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = step_.loss_fn(params, cfg, tf.Runtime(mla_absorb=absorb),
                            _torch_batch(b))
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    want = jax.tree.leaves(rgrads)
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        assert g is not None
        assert _leaf_rel(g, w) <= GRAD_TOL


def test_softcap_gradients_equal_the_reference():
    """The attention backward the card's ``FlashAttention`` runs,
    ``flash_attention_bwd`` with a cap of 0.5 (its factor ``1 - tanh^2``),
    causal and windowed, against ``jax.vjp`` of the reference's
    ``gqa_attention`` given the cap, each gradient within 1e-4 of its max
    |g|; and reduced qwen2.5-14b with ``logit_softcap`` 0.5 in both
    configurations: the loss and every gradient leaf."""
    from repro_torch.kernels.attention import flash_attention_ref
    from repro_torch.kernels.autograd import flash_attention_bwd
    from test_torch_train import _leaf_rel
    rng = np.random.default_rng(9)
    B, S, H, KV, hd = 2, 11, 4, 2, 16
    q = (2.0 * rng.standard_normal((B, S, H, hd))).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, hd)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = jnp.asarray(np.tile(np.arange(S, dtype=np.int32), (B, 1)))
    for window in (0, 4):
        def ref(q_, k_, v_):
            return ref_attn.gqa_attention(q_, k_, v_, q_positions=pos,
                                          k_positions=pos, causal=True,
                                          window=window, softcap=0.5)
        _, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
        t = [torch.from_numpy(a) for a in (q, k, v)]
        o = flash_attention_ref(*t, window=window, softcap=0.5)
        got = flash_attention_bwd(*t, o, torch.from_numpy(do), causal=True,
                                  window=window, softcap=0.5)
        for g, w in zip(got, want):
            assert _leaf_rel(g, w) <= GRAD_TOL
    _grads("qwen2.5-14b", False, 0.5)


def test_absorbed_mla_gradients_equal_the_reference():
    """Reduced deepseek-v2-lite-16b under ``Runtime(mla_absorb=True)``:
    the loss and every gradient leaf (W_UK and W_UV through the absorbed
    queries and the attended latent)."""
    _grads("deepseek-v2-lite-16b", True, 0.0)


@pytest.mark.parametrize("arch,absorb,int8", [
    ("deepseek-v2-lite-16b", True, False), ("qwen2.5-14b", False, True)],
    ids=["deepseek-absorbed", "qwen-int8"])
def test_engine_equals_the_reference_engine(arch, absorb, int8):
    """``ReplicaEngine(cfg, params, rt=Runtime(mla_absorb=True))`` (the
    reference's own entry point for the absorbed path) and an engine over
    an int8 cache: three requests in 4 slots at different depths, every
    prefill's and decode step's logits within 1e-4 of max |logit| of the
    reference engine's."""
    from repro.serving.engine import ReplicaEngine as RefEngine
    from repro_torch.serving.engine import ReplicaEngine
    from test_torch_serving import _recorded
    ref_cfg, cfg, tree, params = _model(arch, kv_cache_int8=int8)
    ref = RefEngine(ref_cfg, tree, slots=4, max_len=48, eos_id=-1,
                    rt=ref_tf.Runtime(mesh=None, mla_absorb=absorb))
    eng = ReplicaEngine(cfg, params, slots=4, max_len=48, eos_id=-1,
                        rt=tf.Runtime(mla_absorb=absorb))
    want, got = [], []
    _recorded(ref, want, ("_prefill", "_decode"))
    _recorded(eng, got, ("_prefill", "_decode"))
    for e in (ref, eng):
        e.admit(1, [5, 6, 7, 8, 9], 6)
        e.step()
        e.step()
        e.admit(2, [11, 3, 12], 5)
        e.admit(3, list(range(20, 33)), 4)
        while e.n_active:
            e.step()
    assert len(want) == len(got) > 3
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.shape == b.shape, i
        assert np.abs(a - b).max() / np.abs(a).max() < REL_TOL, i
