"""The training path's data and state in the port against the JAX
package's: the token stream and the hedged prefetch (``data.tokens``),
document packing (``data.packing``), AdamW's schedule, int8 moments and
update (``train.optimizer``), and checkpoints (``train.checkpoint``)
written by either package and restored in the other.

Tolerances: the token batches, the packings, ``_quant`` / ``_dequant`` and
the checkpoints' leaves are equal bit for bit; the schedule is equal bit
for bit through the warm-up (where 5-step runs of ``launch.train`` stay)
and within 2 ulp of ``lr`` after it (its cosine is XLA's on one side and
torch's on the other); one ``adamw_update`` matches within 1e-6 of each
leaf's max.  The reference's AdamW runs jitted, as its training step runs
it: XLA computes a division by a constant as a product with the
reciprocal, and the port follows that (``optimizer._inv``)."""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import packing as ref_packing
from repro.data import tokens as ref_tokens
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro_torch.data import packing, tokens
from repro_torch.launch import train as launch_train
from repro_torch.train import optimizer as opt_
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.tree import leaf_names, leaves, unflatten

ADAMW_TOL = 1e-6


# ------------------------------------------------------------------ tokens

@pytest.mark.parametrize("vocab,seq,batch,seed,doc_len", [
    (512, 128, 8, 0, 64), (50, 7, 3, 5, 64), (32001, 1100, 2, 0, 64),
    (1000, 33, 4, 2, 5)])
def test_token_stream_equals_the_reference(vocab, seq, batch, seed, doc_len):
    """``TokenStream.batch(step)`` bit for bit, dtypes included, at steps
    out of order (the stream is a pure function of the step)."""
    port = tokens.TokenStream(vocab, seq, batch, seed=seed, doc_len=doc_len)
    ref = ref_tokens.TokenStream(vocab, seq, batch, seed=seed,
                                 doc_len=doc_len)
    for step in (0, 7, 1, 123456):
        got, want = port.batch(step), ref.batch(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])


def test_prefetch_loader_hedges_a_straggler_and_raises_failures():
    """A primary fetch past its deadline fires a backup (counted), both
    give the stream's batch; a failing worker's exception reaches the
    caller."""
    stream = tokens.TokenStream(256, 16, 2)
    release = threading.Event()

    def delay(step, tag):
        if tag == "primary" and step == 1:
            release.wait(5.0)
        return 0.0
    loader = tokens.PrefetchLoader(stream, deadline_s=0.05, delay_fn=delay)
    for step in (0, 1, 2):
        got = loader(step)
        assert np.array_equal(got["tokens"], stream.batch(step)["tokens"])
    release.set()
    assert loader.hedged == 1

    def boom(step, tag):
        raise ValueError("worker failed")
    with pytest.raises(ValueError, match="worker failed"):
        tokens.PrefetchLoader(stream, delay_fn=boom)(0)


# ----------------------------------------------------------------- packing

@pytest.mark.parametrize("policy", ["first_fit", "first_fit_decreasing",
                                    "best_fit", "best_fit_decreasing"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_documents_equals_the_reference(policy, seed):
    """The same bins, in the same order, and the same efficiency, with
    over-length documents skipped and ties in length."""
    rng = np.random.default_rng(seed)
    lengths = [int(x) for x in rng.integers(1, 300, 60)] + [256, 256, 513]
    for seq_len in (256, 512):
        got = packing.pack_documents(lengths, seq_len, policy)
        want = ref_packing.pack_documents(lengths, seq_len, policy)
        assert got == want
    assert packing.pack_documents([], 64, policy) == \
        ref_packing.pack_documents([], 64, policy)


# --------------------------------------------------------------- optimizer

def _quant_input(seed):
    """Rows of widely spread magnitudes, a zero row, and exact halves that
    round to even."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((64, 257)) *
         10.0 ** rng.uniform(-8, 2, (64, 1))).astype(np.float32)
    x[3] = 0.0
    x[5] = 0.0
    x[5, :4] = [127.0, -0.5, 1.5, 2.5]
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quant_and_dequant_equal_the_reference(seed):
    """Per-row absmax int8 quantization and its inverse, bit for bit with
    the reference's as its jitted step runs them (scales ``absmax * (1 /
    127)``, rounding half to even)."""
    x = _quant_input(seed)
    q, s = opt_._quant(torch.from_numpy(x))
    rq, rs = jax.jit(ref_opt._quant)(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert np.array_equal(s.numpy(), np.asarray(rs))
    assert np.array_equal(q[5, :4].numpy(), [127, -0, 2, 2])
    d = opt_._dequant(q, s)
    assert np.array_equal(d.numpy(),
                          np.asarray(jax.jit(ref_opt._dequant)(rq, rs)))
    err = float((d - torch.from_numpy(x)).abs().max())
    assert err <= float(np.abs(x).max()) / 127.0 + 1e-7


@pytest.mark.parametrize("warmup,total", [(5, 5), (5, 20), (7, 100),
                                          (100, 10000)])
def test_schedule_equals_the_reference(warmup, total):
    """The warm-up bit for bit; the cosine within 2 ulp of ``lr``."""
    kw = dict(lr=3e-3, warmup_steps=warmup, total_steps=total)
    ropt, popt = ref_opt.OptConfig(**kw), opt_.OptConfig(**kw)
    f = jax.jit(lambda s: ref_opt.schedule(ropt, s))
    for step in list(range(0, warmup + 1)) + \
            list(range(warmup + 1, total + 3, max(1, total // 50))):
        got = opt_.schedule(popt, torch.tensor(step, dtype=torch.int32))
        want = np.asarray(f(jnp.int32(step)))
        assert got.dtype == torch.float32
        if step <= warmup:
            assert got.item() == float(want), step
        else:
            assert abs(got.item() - float(want)) <= 2 * 2.0 ** -23 * 3e-3


def _tree(rng):
    """A nested parameter tree: a layer-stacked dict (3-D and stacked 1-D
    leaves), 2-D and 1-D top-level leaves."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"embed": a(40, 12), "final_norm": a(12),
            "layers": {"w_in": a(3, 12, 20), "ln1": a(3, 12),
                       "we": a(3, 2, 12, 5)}}


def _state(rng, tree, state_dtype):
    """A nonzero reference AdamW state at step 6 (int8: quantized by the
    reference)."""
    def moment(p, positive):
        x = rng.standard_normal(p.shape).astype(np.float32) * 1e-2
        x = np.abs(x) if positive else x
        if state_dtype == "int8":
            q, s = jax.jit(ref_opt._quant)(jnp.asarray(x))
            return {"q": np.asarray(q), "s": np.asarray(s)}
        return x
    return {"m": jax.tree.map(lambda p: moment(p, False), tree),
            "v": jax.tree.map(lambda p: moment(p, True), tree),
            "step": np.int32(6)}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_adamw_update_equals_the_reference(state_dtype):
    """One AdamW step (gradient clipping binding, weight decay on >= 2-D
    leaves, stacked leaves a layer at a time) from the same nonzero state:
    parameters, moments (int8 dequantized) and metrics within 1e-6 of each
    leaf's max, the step advanced; the update is in place."""
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    grads = jax.tree.map(lambda p: (3.0 * rng.standard_normal(p.shape))
                         .astype(np.float32), tree)
    state = _state(rng, tree, state_dtype)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20,
              state_dtype=state_dtype)
    rp, rs, rm = jax.jit(lambda p, g, s: ref_opt.adamw_update(
        p, g, s, ref_opt.OptConfig(**kw)))(tree, grads, state)
    params = _to_torch(tree)
    pstate = opt_.opt_state_from_reference(state, params)
    p_obj = params["layers"]["w_in"]
    pp, ps, pm = opt_.adamw_update(params, _to_torch(grads), pstate,
                                   opt_.OptConfig(**kw))
    assert pp["layers"]["w_in"] is p_obj
    assert int(ps["step"]) == 7 and ps["step"].dtype == torch.int32
    for k in ("grad_norm", "lr"):
        assert float(pm[k]) == pytest.approx(float(rm[k]), rel=1e-6)

    def read(s):
        if state_dtype == "int8":
            return [np.asarray(q, np.float32) * np.asarray(sc) for q, sc in
                    zip(s[0::2], s[1::2])]
        return s
    pairs = list(zip(leaves(pp), jax.tree.leaves(rp)))
    for key in ("m", "v"):
        pairs += list(zip(read([x.numpy() for x in leaves(ps[key])]),
                          read([np.asarray(x)
                                for x in jax.tree.leaves(rs[key])])))
    for a, b in pairs:
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        b = np.asarray(b)
        assert np.abs(a - b).max() <= ADAMW_TOL * np.abs(b).max()


def test_opt_state_from_reference_refuses_a_wrong_tree():
    rng = np.random.default_rng(5)
    tree = _tree(rng)
    state = _state(rng, tree, "int8")
    params = _to_torch(tree)
    got = opt_.opt_state_from_reference(state, params)
    assert got["m"]["layers"]["we"]["q"].dtype == torch.int8
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 6
    bad = dict(state, m=dict(state["m"], extra=state["m"]["embed"]))
    with pytest.raises(ValueError, match="keys"):
        opt_.opt_state_from_reference(bad, params)
    with pytest.raises(ValueError, match="want"):
        opt_.opt_state_from_reference(_state(rng, tree, "float32"),
                                      dict(params, embed=params["embed"].T))


def test_adamw_minimizes_a_quadratic():
    """The reference's own optimizer test on the port: 150 steps on
    ||w||^2 bring every entry below 0.3, fp32 and int8 moments."""
    for state_dtype in ("float32", "int8"):
        opt = opt_.OptConfig(lr=0.1, weight_decay=0.0,
                             state_dtype=state_dtype, warmup_steps=1,
                             total_steps=200)
        params = {"w": torch.tensor([[4.0, -3.0], [2.0, 5.0]])}
        state = opt_.init_opt_state(params, opt)
        for _ in range(150):
            params, state, _ = opt_.adamw_update(
                params, {"w": 2 * params["w"]}, state, opt)
        assert float(params["w"].abs().max()) < 0.3, state_dtype


def test_global_norm_follows_the_reference():
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    want = float(jax.jit(ref_opt.global_norm)(tree))
    assert float(opt_.global_norm(_to_torch(tree))) == \
        pytest.approx(want, rel=1e-6)


def test_tree_order_is_the_reference_flatten_order():
    rng = np.random.default_rng(4)
    tree = _tree(rng)
    state = _state(rng, tree, "int8")
    both = (tree, state)
    got = [x.numpy() for x in leaves(_to_torch(both))]
    want = jax.tree.leaves(both)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a, np.asarray(b))
    t = _to_torch(both)
    assert leaves(unflatten(t, leaves(t))) == leaves(t)
    with pytest.raises(ValueError):
        unflatten(t, leaves(t) + [torch.zeros(())])
    assert leaf_names({"b": 1, "a": (2, {"d": 3, "c": 4})}) == \
        ["a.0", "a.1.c", "a.1.d", "b"]
    assert len(leaf_names(t)) == len(leaves(t))


# ------------------------------------------------------------- checkpoints

def _train_state(state_dtype, seed=0):
    rng = np.random.default_rng(seed)
    tree = _tree(rng)
    return tree, _state(rng, tree, state_dtype)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_a_reference_checkpoint_restores_in_the_port(tmp_path, state_dtype):
    """(params, opt_state) saved by the reference's manager, restored by
    the port's into its own tree: every leaf equal bit for bit, dtypes
    kept (int8 ``q``, fp32 ``s``, int32 step)."""
    tree, state = _train_state(state_dtype)
    ref_ckpt.CheckpointManager(str(tmp_path), async_save=False).save(
        6, jax.tree.map(jnp.asarray, (tree, state)))
    like = _to_torch(jax.tree.map(np.zeros_like, (tree, state)))
    step, restored = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 6
    want = jax.tree.leaves((tree, state))
    got = leaves(restored)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.numpy().dtype == np.asarray(b).dtype
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_a_port_checkpoint_restores_in_the_reference(tmp_path, state_dtype):
    tree, state = _train_state(state_dtype, seed=1)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(9, _to_torch((tree, state)))
    mgr.wait()
    step, restored = ref_ckpt.CheckpointManager(str(tmp_path)).restore(
        jax.eval_shape(lambda: jax.tree.map(jnp.asarray, (tree, state))))
    assert step == 9
    for a, b in zip(jax.tree.leaves(restored),
                    jax.tree.leaves((tree, state))):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_roundtrip_gc_and_tree_mismatch(tmp_path):
    """The reference's checkpoint test on the port: keep=2 leaves the last
    two steps; the latest restores bit for bit; a tree of another leaf
    count, shape or dtype is refused."""
    ck = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    state = {"a": torch.arange(12.0).reshape(3, 4),
             "b": {"c": torch.ones(5, dtype=torch.int32)}}
    for step in (10, 20, 30):
        ck.save(step, state)
    assert ck.all_steps() == [20, 30]
    assert sorted(os.listdir(tmp_path)) == ["step_0000000020",
                                            "step_0000000030"]
    step, restored = ck.restore({"a": torch.zeros((3, 4)),
                                 "b": {"c": torch.zeros(5, dtype=torch.int32)}})
    assert step == 30
    for a, b in zip(leaves(state), leaves(restored)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    with pytest.raises(AssertionError):
        ck.restore({"a": state["a"]})
    with pytest.raises(ValueError):
        ck.restore({"a": torch.zeros(4, 3), "b": state["b"]})
    with pytest.raises(ValueError):
        ck.restore({"a": state["a"].double(), "b": state["b"]})


def test_async_save_copies_before_the_writer_runs(tmp_path):
    """The host copy is taken at ``save``: a tensor updated in place right
    after (as the training loop's AdamW does) leaves the checkpoint as it
    was."""
    ck = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    w = torch.ones((128, 128))
    ck.save(5, {"w": w})
    w.mul_(3.0)
    ck.wait()
    assert ck.latest_step() == 5
    _, got = ck.restore({"w": torch.zeros((128, 128))})
    assert torch.equal(got["w"], torch.ones((128, 128)))


def test_launch_train_resumes_exactly(tmp_path, capsys):
    """``launch.train.main`` with ``--ckpt``: 6 steps straight, against 3
    steps (saved at the end) and a second run that resumes from that
    checkpoint for the other 3; the final checkpoints' leaves (parameters,
    moments, step) equal bit for bit, the resumed run's log says where it
    began, and its logged losses are the straight run's."""
    args = ["--arch", "qwen2.5-14b", "--reduced", "--batch", "4", "--seq",
            "32", "--log-every", "1", "--device", "cpu"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    straight = launch_train.main(args + ["--steps", "6", "--ckpt", a])
    launch_train.main(args + ["--steps", "3", "--ckpt", b])
    resumed = launch_train.main(args + ["--steps", "6", "--ckpt", b])
    assert "resumed from step 3" in capsys.readouterr().out
    assert [s for s, _ in resumed] == [3, 4, 5]
    assert [m["loss"] for _, m in resumed] == \
        [m["loss"] for _, m in straight[3:]]
    ra, rb = (np.load(os.path.join(d, "step_0000000006", "arrays.npz"))
              for d in (a, b))
    assert ra.files == rb.files and len(ra.files) > 3
    for f in ra.files:
        assert np.array_equal(ra[f], rb[f])
