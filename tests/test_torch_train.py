"""The training path of the port (``repro_torch.train``, ``launch.train``,
the kernels' autograd Functions, remat in ``models.transformer``) against
the JAX package's.

Inputs come from numpy with a seed; parameters are the JAX package's own
``init_params`` trees (every constant leaf - norm scales, mixes, biases,
``A_log``, ``dt_bias``, ``ssm_D`` - drawn live), carried across by
``params_from_reference``.  Tolerances, each stated where it is used:

- ``loss_fn``: the loss within 1e-5 relative and every gradient leaf within
  1e-4 of that leaf's max |g|, fp32 copies of the reduced configurations
  (dense, RWKV6, hybrid, MoE, MLA, encoder-decoder, patch prefix);
- ``make_train_step``: parameters within 2e-5 (the JAX package's own
  tolerance for microbatches 1 against 4, ``tests/test_train.py``), on that
  test's configuration;
- ``launch.train.main``: the losses of 5 reduced steps within 1e-2
  relative at the configuration's own bf16 compute;
- the Functions: with the kernel's launch replaced by a stand-in that
  autograd cannot see (the plain version under ``torch.no_grad``), the
  gradients through each Function equal autograd of the plain version
  (1e-5 of max |g| for attention, whose backward is written out; the
  scan's recomputes the plain version itself: bit for bit), and without
  the Function there are none.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_reduced_config as ref_reduced
from repro.data.tokens import TokenStream as RefStream
from repro.models import params as ref_params
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.sharding import ShardingRules
from repro.models.transformer import Runtime as RefRuntime
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_step
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import autograd as kag
from repro_torch.kernels import ops
from repro_torch.kernels.attention import flash_attention_ref
from repro_torch.kernels.rwkv6 import rwkv6_chunked_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as model_attention
from repro_torch.models import linear_scan
from repro_torch.models import params as P_
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Runtime
from repro_torch.train import optimizer as opt_
from repro_torch.train import train_step as step_
from repro_torch.train.tree import leaves

GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
PARAM_TOL = 2e-5
MAIN_LOSS_REL = 1e-2
ARCHS = ["qwen2.5-14b", "rwkv6-1.6b", "hymba-1.5b", "granite-moe-3b-a800m",
         "deepseek-v2-lite-16b", "whisper-medium", "pixtral-12b"]
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, dtype="float32",
            attn_q_chunk=64)     # tests/test_train.py's CFG


def live_tree(ref_cfg, seed: int = 1):
    """The JAX package's fp32 parameters of ``ref_cfg`` (numpy leaves),
    every leaf the initialiser fills with one value (zeros, ones) drawn
    around it instead, so no gradient path sits at a constant."""
    tree = jax.tree.map(np.asarray, jax.jit(
        ref_params.init_params, static_argnums=(1, 2))(
            jax.random.PRNGKey(0), ref_cfg, jnp.float32))
    rng = np.random.default_rng(seed)

    def live(a):
        if a.size > 1 and np.all(a == a.flat[0]):
            return (a + 0.2 * rng.standard_normal(a.shape)).astype(
                np.float32)
        return a
    return jax.tree.map(live, tree)


def _configs(arch):
    return (dataclasses.replace(ref_reduced(arch), dtype="float32"),
            dataclasses.replace(get_reduced_config(arch), dtype="float32"))


def _batch(cfg, B=2, S=16, seed=3):
    """Tokens and labels from the token stream (a few labels masked to
    -1), with the stub frontends' embeddings where the configuration has
    them."""
    b = RefStream(cfg.vocab, S, B, seed=seed).batch(0)
    b["labels"][0, :3] = -1
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        b["enc_embeds"] = (0.1 * rng.standard_normal(
            (B, 12, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "vision_stub":
        b["frontend_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    return b


def _torch_batch(b, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in b.items()}


def _leaf_rel(got, want):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got.detach().float().numpy() - want).max())
    return err / scale if scale else err


@functools.lru_cache(maxsize=None)
def _ref_grad_fn(ref_cfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: ref_step.loss_fn(p, ref_cfg, RefRuntime(), b),
        has_aux=True))


def _port_loss_and_grads(params, cfg, batch):
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, parts = step_.loss_fn(params, cfg, Runtime(), batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_equal_the_reference(arch):
    """``loss_fn`` (CE with masked labels, z-loss, the MoE aux loss,
    pixtral's suffix-only loss, whisper's encoder) and autograd through the
    port's forward (remat on, as the configurations set it): the loss
    within 1e-5 relative, ce and aux too, every gradient leaf within 1e-4
    of its max |g|."""
    ref_cfg, cfg = _configs(arch)
    assert cfg.remat
    tree = live_tree(ref_cfg)
    b = _batch(cfg)
    (want_loss, want_parts), want_g = _ref_grad_fn(ref_cfg)(
        tree, {k: jnp.asarray(v) for k, v in b.items()})
    params = P_.params_from_reference(tree, cfg, device="cpu")
    loss, parts, grads = _port_loss_and_grads(params, cfg, _torch_batch(b))
    assert float(loss) == pytest.approx(float(want_loss), rel=LOSS_TOL)
    for k in ("ce", "aux"):
        assert float(parts[k]) == pytest.approx(float(want_parts[k]),
                                                rel=LOSS_TOL, abs=1e-7)
    want_leaves = jax.tree.leaves(want_g)
    assert len(grads) == len(want_leaves)
    for g, w in zip(grads, want_leaves):
        assert g is not None and tuple(g.shape) == np.shape(w)
        assert _leaf_rel(g, w) <= GRAD_TOL


def test_remat_gives_the_gradients_without_it():
    """``cfg.remat`` changes what is kept for the backward, not the
    gradients: hymba's reduced configuration with and without it, equal
    bit for bit on the CPU."""
    ref_cfg, cfg = _configs("hymba-1.5b")
    params = P_.params_from_reference(live_tree(ref_cfg), cfg, device="cpu")
    b = _torch_batch(_batch(cfg))
    _, _, g_on = _port_loss_and_grads(params, cfg, b)
    _, _, g_off = _port_loss_and_grads(
        params, dataclasses.replace(cfg, remat=False), b)
    for a, c in zip(g_on, g_off):
        assert torch.equal(a, c)


# ------------------------------------------------------------- train step

def _tiny_step_pair(mb, state_dtype, steps):
    """Params and losses of ``steps`` steps of the port and of the
    reference (jitted) from the same weights and batches."""
    ref_cfg, cfg = RefModelConfig(**TINY), ModelConfig(**TINY)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10,
              state_dtype=state_dtype)
    ropt, popt = ref_opt.OptConfig(**kw), opt_.OptConfig(**kw)
    tree = jax.jit(ref_params.init_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), ref_cfg, jnp.float32)
    params = P_.params_from_reference(jax.tree.map(np.asarray, tree), cfg,
                                      device="cpu")
    rstep = jax.jit(ref_step.make_train_step(ref_cfg, RefRuntime(), ropt,
                                             microbatches=mb))
    pstep = step_.make_train_step(cfg, Runtime(), popt, microbatches=mb)
    rp, ro = tree, ref_opt.init_opt_state(tree, ropt)
    pp, po = params, opt_.init_opt_state(params, popt)
    stream = RefStream(cfg.vocab, 32, 8)
    out = []
    for s in range(steps):
        b = stream.batch(s)
        rp, ro, rm = rstep(rp, ro, {k: jnp.asarray(v) for k, v in b.items()})
        pp, po, pm = pstep(pp, po, _torch_batch(b))
        out.append((rm, pm))
    return rp, pp, out


@pytest.mark.parametrize("mb,state_dtype,steps", [
    (1, "float32", 2), (4, "float32", 2), (1, "int8", 1), (4, "int8", 1)])
def test_train_step_equals_the_reference(mb, state_dtype, steps):
    """``make_train_step`` with 1 and 4 microbatches, fp32 and int8
    moments: every parameter within 2e-5 of the reference's after each
    run, the metrics' keys the reference's and their values within 1e-5
    relative.  (int8 runs one step: from a nonzero state the int8
    moments' rounding buckets amplify ulp differences in either package.)"""
    rp, pp, out = _tiny_step_pair(mb, state_dtype, steps)
    for rm, pm in out:
        assert set(pm) == set(rm)
        for k in rm:
            assert float(pm[k]) == pytest.approx(float(rm[k]), rel=1e-5,
                                                 abs=1e-7)
    for a, b in zip(leaves(pp), jax.tree.leaves(rp)):
        assert float(np.abs(a.detach().numpy() - np.asarray(b)).max()) <= \
            PARAM_TOL


def test_a_step_from_the_reference_state_equals_the_reference():
    """Both packages start a step from the same state: the reference's
    parameters and fp32 AdamW state after one of its steps, carried across
    by ``params_from_reference`` and ``opt_state_from_reference``; one more
    step in each gives parameters within 2e-5 and moments within 1e-5 of
    each leaf's max (the gradients themselves part at ~1e-6).  Not int8:
    there a gradient an ulp apart can move a moment across a rounding
    bucket of its row's scale, and a v rounded to 0 makes the update m /
    eps (either package; the carried int8 state itself is checked in
    ``test_torch_train_data.py``)."""
    state_dtype = "float32"
    ref_cfg, cfg = RefModelConfig(**TINY), ModelConfig(**TINY)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10,
              state_dtype=state_dtype)
    ropt, popt = ref_opt.OptConfig(**kw), opt_.OptConfig(**kw)
    tree = jax.jit(ref_params.init_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), ref_cfg, jnp.float32)
    rstep = jax.jit(ref_step.make_train_step(ref_cfg, RefRuntime(), ropt))
    stream = RefStream(cfg.vocab, 32, 8)
    b0, b1 = ({k: jnp.asarray(v) for k, v in stream.batch(s).items()}
              for s in (0, 1))
    rp, ro, _ = rstep(tree, ref_opt.init_opt_state(tree, ropt), b0)
    pp = P_.params_from_reference(jax.tree.map(np.asarray, rp), cfg,
                                  device="cpu")
    po = opt_.opt_state_from_reference(jax.tree.map(np.asarray, ro), pp)
    rp, ro, rm = rstep(rp, ro, b1)
    pp, po, pm = step_.make_train_step(cfg, Runtime(), popt)(
        pp, po, _torch_batch(jax.tree.map(np.asarray, b1)))
    assert int(po["step"]) == int(ro["step"]) == 2
    assert float(pm["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    for a, b in zip(leaves(pp), jax.tree.leaves(rp)):
        assert float(np.abs(a.detach().numpy() - np.asarray(b)).max()) <= \
            PARAM_TOL

    for key in ("m", "v"):
        for a, b in zip(leaves(po[key]), jax.tree.leaves(ro[key])):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_microbatches_equal_one_batch_and_bf16_accumulation_runs():
    """The reference's own check on the port: 4 microbatches against 1,
    parameters within 2e-5 and the loss within 1e-5; a bf16 accumulator
    gives finite metrics."""
    cfg = ModelConfig(**TINY)
    opt = opt_.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    p0 = P_.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    batch = _torch_batch(RefStream(cfg.vocab, 32, 8).batch(0))
    outs = []
    for mb, acc in ((1, torch.float32), (4, torch.float32),
                    (4, torch.bfloat16)):
        p = {k: ({kk: vv.clone() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.clone())
             for k, v in p0.items()}
        step = step_.make_train_step(cfg, Runtime(), opt, microbatches=mb,
                                     accum_dtype=acc)
        p, _, m = step(p, opt_.init_opt_state(p, opt), batch)
        outs.append((p, m))
    (p1, m1), (p4, m4), (_, mbf) = outs
    assert float(m4["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    for a, b in zip(leaves(p1), leaves(p4)):
        assert float((a - b).abs().max()) <= PARAM_TOL
    assert all(np.isfinite(float(v)) for v in mbf.values())


def test_launch_train_main_equals_the_reference_loop(capsys, monkeypatch):
    """``launch.train.main(["--arch", "qwen2.5-14b", "--reduced", "--steps",
    "5", "--device", "cpu"])`` from the reference's weights (its
    ``init_params`` bound in place of the port's) logs the losses of the
    reference's loop - its ``build`` with the mesh left out, since under
    jax 0.9.0 its host mesh's explicit axes refuse the step's sharding
    constraints - within 1e-2 relative, both at the configuration's bf16
    compute; the log lines are the reference's."""
    arch, steps = "qwen2.5-14b", 5
    ref_cfg = ref_reduced(arch)
    tree = jax.jit(ref_params.init_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), ref_cfg, jnp.float32)
    ropt = ref_opt.OptConfig(lr=3e-3, warmup_steps=max(steps // 20, 5),
                             total_steps=steps)
    rstep = jax.jit(ref_step.make_train_step(ref_cfg, RefRuntime(), ropt))
    stream = RefStream(ref_cfg.vocab, 128, 8)
    rp, ro, want = tree, ref_opt.init_opt_state(tree, ropt), []
    for s in range(steps):
        rp, ro, m = rstep(rp, ro, {k: jnp.asarray(v) for k, v in
                                   stream.batch(s).items()})
        want.append(float(m["loss"]))

    def init_params(cfg, *, seed, device, dtype):
        assert (seed, dtype) == (0, torch.float32)
        return P_.params_from_reference(jax.tree.map(np.asarray, tree), cfg,
                                        device=device, dtype=dtype)
    monkeypatch.setattr(launch_train.P_, "init_params", init_params)
    logged = launch_train.main(["--arch", arch, "--reduced", "--steps",
                                str(steps), "--log-every", "1", "--device",
                                "cpu"])
    got = [m["loss"] for _, m in logged]
    assert [s for s, _ in logged] == list(range(steps))
    np.testing.assert_allclose(got, want, rtol=MAIN_LOSS_REL)
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "done"
    assert all(line.startswith(f"step {s:5d} loss=") and " ce=" in line and
               " gnorm=" in line for s, line in enumerate(lines[:-1]))


def test_launch_train_refuses_a_missing_card():
    """Without ``--device cpu`` the entry point asks for the card and raises
    where there is none: nothing trains on the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen2.5-14b", "--reduced", "--steps",
                           "1"])


def test_granite_first_step_follows_the_dense_mode():
    """Without a mesh (``Runtime()``) the port trains MoE layers in the
    reference's mesh-free (dense) mode.  Reduced granite-moe-3b-a800m's
    first-step loss (bf16, the token stream's batch 0 at 8 x 128) equals
    the reference's mesh-free loss within 1e-3 relative; the reference's
    host-mesh path (its ``launch/train.py``; here on a mesh of automatic
    axes) takes the capacity dispatch, which drops pairs, and lands more
    than 5e-3 away.  The port's ``launch/train.py`` trains on a mesh too
    (``test_launch_train_follows_the_reference_host_mesh``)."""
    arch = "granite-moe-3b-a800m"
    ref_cfg, cfg = ref_reduced(arch), get_reduced_config(arch)
    tree = jax.jit(ref_params.init_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), ref_cfg, jnp.float32)
    b = RefStream(ref_cfg.vocab, 128, 8).batch(0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    dense = float(jax.jit(lambda p, x: ref_step.loss_fn(
        p, ref_cfg, RefRuntime(), x)[0])(tree, jb))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    rt = RefRuntime(mesh=mesh, rules=ShardingRules(fsdp=False,
                                                   data_axes=("data",)))
    with mesh:
        capacity = float(jax.jit(lambda p, x: ref_step.loss_fn(
            p, ref_cfg, rt, x)[0])(tree, jb))
    params = P_.params_from_reference(jax.tree.map(np.asarray, tree), cfg,
                                      device="cpu", dtype=torch.float32)
    with torch.no_grad():
        port = float(step_.loss_fn(params, cfg, Runtime(),
                                   _torch_batch(b))[0])
    assert port == pytest.approx(dense, rel=1e-3)
    assert abs(capacity - dense) > 5e-3 * abs(dense)


def test_launch_train_follows_the_reference_host_mesh(monkeypatch, capsys):
    """``launch.train.main`` on reduced granite-moe-3b-a800m (the CPU: a
    (1, 1) mesh, as the reference's launcher builds its host mesh) takes
    the capacity path: its first-step loss, from the reference's weights,
    equals the reference's ``make_train_step`` under a (1, 1) mesh of
    automatic axes within 1e-2 relative (the file's bf16 limit), and lies
    nearer it than the mesh-free (dense) loss."""
    arch = "granite-moe-3b-a800m"
    ref_cfg = ref_reduced(arch)
    tree = jax.jit(ref_params.init_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), ref_cfg, jnp.float32)
    ropt = ref_opt.OptConfig(lr=3e-3, warmup_steps=5, total_steps=1)
    b = {k: jnp.asarray(v) for k, v in
         RefStream(ref_cfg.vocab, 128, 8).batch(0).items()}
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    rt = RefRuntime(mesh=mesh, rules=ShardingRules(fsdp=False,
                                                   data_axes=("data",)))
    with mesh:
        _, _, m = jax.jit(ref_step.make_train_step(ref_cfg, rt, ropt))(
            tree, ref_opt.init_opt_state(tree, ropt), b)
    capacity = float(m["loss"])
    dense = float(jax.jit(lambda p, x: ref_step.loss_fn(
        p, ref_cfg, RefRuntime(), x)[0])(tree, b))

    def init_params(cfg, *, seed, device, dtype):
        return P_.params_from_reference(jax.tree.map(np.asarray, tree), cfg,
                                        device=device, dtype=dtype)
    monkeypatch.setattr(launch_train.P_, "init_params", init_params)
    logged = launch_train.main(["--arch", arch, "--reduced", "--steps", "1",
                                "--device", "cpu"])
    port = logged[0][1]["loss"]
    assert port == pytest.approx(capacity, rel=MAIN_LOSS_REL)
    assert abs(port - capacity) < abs(port - dense)
    assert capsys.readouterr().out.splitlines()[-1] == "done"


# -------------------------------------------- the kernels' autograd Functions

def _no_grad(fn):
    """``fn`` under ``torch.no_grad``: a launch's output, which autograd
    cannot see."""
    def call(*args, **kwargs):
        with torch.no_grad():
            return fn(*args, **kwargs)
    return call


@pytest.fixture
def stand_ins(monkeypatch):
    """The kernels' launches replaced by the plain versions under
    ``torch.no_grad``, counted."""
    calls = {"flash": 0, "scan": 0}

    def flash(*args, **kwargs):
        calls["flash"] += 1
        return _no_grad(flash_attention_ref)(*args, **kwargs)

    def scan(*args, **kwargs):
        calls["scan"] += 1
        return _no_grad(rwkv6_chunked_ref)(*args, **kwargs)
    monkeypatch.setattr(ops, "flash_launch", flash)
    monkeypatch.setattr(ops, "rwkv6_launch", scan)
    return calls


FLASH_CASES = [(37, 37, 6, 2, 16, True, 0), (37, 37, 6, 2, 16, True, 8),
               (20, 33, 4, 4, 8, False, 0), (16, 40, 4, 1, 16, True, 5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,H,KV,hd,causal,window", FLASH_CASES)
def test_flash_function_gradients_equal_plain(stand_ins, Sq, Skv, H, KV, hd,
                                              causal, window, dtype):
    """``FlashAttention`` over a stand-in launch: its written-out backward
    (causal mask, window, GQA sums over each kv head's query heads, the
    1 / sqrt(hd) scale) equals autograd of ``flash_attention_ref`` within
    1e-5 (fp32) / 2e-2 (bf16, the JAX kernel tests' tolerance) of each
    input's max |g|, in the inputs' type; the stand-in alone leaves no
    gradient."""
    rng = np.random.default_rng(Sq + Skv + window)
    base = [torch.from_numpy(rng.standard_normal((2, s, n, hd)).astype(
        np.float32)).to(dtype) for s, n in ((Sq, H), (Skv, KV), (Skv, KV))]
    do = torch.from_numpy(rng.standard_normal((2, Sq, H, hd)).astype(
        np.float32)).to(dtype)
    ins = [t.clone().requires_grad_() for t in base]
    out = kag.FlashAttention.apply(*ins, causal, window)
    assert stand_ins["flash"] == 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, ins, do)
    ref = [t.clone().requires_grad_() for t in base]
    want = torch.autograd.grad(flash_attention_ref(
        *ref, causal=causal, window=window), ref, do)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert _leaf_rel(a, b.float().numpy()) <= tol
    bare = ops.flash_launch(*ins, causal=causal, window=window)
    assert bare.grad_fn is None
    with pytest.raises(RuntimeError):
        torch.autograd.grad(bare, ins, do)


SCAN_CASES = [(False, True, False), (False, True, True), (False, False, False),
              (True, False, False), (True, False, True)]


@pytest.mark.parametrize("post,bonus,carried", SCAN_CASES)
def test_scan_function_gradients_equal_plain(stand_ins, post, bonus,
                                             carried):
    """``ChunkedScan`` over a stand-in launch, pre- and post-update, with
    and without ``u`` and an initial state, gradients of y alone (the final
    state's None) and of both: equal to autograd of ``rwkv6_chunked_ref``
    bit for bit; the clamp at ``LOG_DECAY_MIN`` passes no gradient below
    it; the stand-in alone leaves no gradient."""
    B, S, H, K, V = 2, 37, 3, 8, 12
    rng = np.random.default_rng(int(post) * 4 + int(bonus) * 2 + carried)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32))
    lw = -torch.from_numpy(rng.uniform(0, 6, (B, S, H, K)).astype(
        np.float32))      # a third of the steps below the clamp at -4
    base = [t(B, S, H, K), t(B, S, H, K), t(B, S, H, V), lw,
            t(H, K, scale=0.1) if bonus else None,
            t(B, H, K, V) if carried else None]
    gy, gs = t(B, S, H, V), t(B, H, K, V)

    def live(ts):
        return [x for x in ts if x is not None]

    for with_state in (False, True):
        ins = [None if x is None else x.clone().requires_grad_()
               for x in base]
        y, st = kag.ChunkedScan.apply(*ins, 8, post)
        outs, gout = ((y, st), (gy, gs)) if with_state else ((y,), (gy,))
        got = torch.autograd.grad(outs, live(ins), gout)
        ref = [None if x is None else x.clone().requires_grad_()
               for x in base]
        yr, sr = rwkv6_chunked_ref(*ref[:5], chunk=8, post_update=post,
                                   initial_state=ref[5])
        want = torch.autograd.grad((yr, sr) if with_state else (yr,),
                                   live(ref), gout)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        below = lw < -4.0
        assert bool(below.any()) and bool((got[3][below] == 0).all())
    assert stand_ins["scan"] == 2
    y, _ = ops.rwkv6_launch(*live(ins)[:4], ins[4], chunk=8,
                            post_update=post, initial_state=ins[5])
    assert y.grad_fn is None
    with pytest.raises(RuntimeError):
        torch.autograd.grad(y, live(ins), gy)


def test_the_model_trains_through_the_functions(stand_ins, monkeypatch):
    """Hymba's reduced configuration, fp32, with the model's attention and
    scan bound to the wrappers' card path (the Functions over the stand-in
    launches): the loss and every gradient leaf equal the plain run's
    within 1e-5 of the leaf's max |g|, each Function launched twice a layer
    (the forward and remat's recompute); with the stand-ins bound directly
    (no Function) the attention and SSD weights get no gradient."""
    def flash(q, k, v, *, causal=True, window=0):
        return kag.FlashAttention.apply(q, k, v, causal, window) \
            if ops._needs_grad(q, k, v) else \
            ops.flash_launch(q, k, v, causal=causal, window=window)

    def scan(r, k, v, logw, u=None, *, chunk=16, post_update=False,
             initial_state=None):
        return kag.ChunkedScan.apply(r, k, v, logw, u, initial_state, chunk,
                                     post_update)
    ref_cfg, cfg = _configs("hymba-1.5b")
    params = P_.params_from_reference(live_tree(ref_cfg), cfg, device="cpu")
    b = _torch_batch(_batch(cfg))
    loss0, _, want = _port_loss_and_grads(params, cfg, b)
    monkeypatch.setattr(model_attention, "flash_attention", flash)
    monkeypatch.setattr(linear_scan, "rwkv6_chunked", scan)
    loss, _, got = _port_loss_and_grads(params, cfg, b)
    assert stand_ins == {"flash": 2 * cfg.n_layers, "scan": 2 * cfg.n_layers}
    assert float(loss) == pytest.approx(float(loss0), rel=1e-6)
    for a, w in zip(got, want):
        assert _leaf_rel(a, w.numpy()) <= 1e-5
    monkeypatch.setattr(model_attention, "flash_attention", ops.flash_launch)
    monkeypatch.setattr(linear_scan, "rwkv6_chunked", ops.rwkv6_launch)
    flat = leaves(params)
    loss, _ = step_.loss_fn(params, cfg, Runtime(), b)
    grads = dict(zip([n for n in sorted(params["layers"])],
                     torch.autograd.grad(loss, [params["layers"][n] for n in
                                                sorted(params["layers"])],
                                         allow_unused=True)))
    for name in ("wq", "wk", "wv", "ws_B", "ws_C", "A_log", "dt_bias"):
        assert grads[name] is None, name
    assert grads["wo"] is not None and len(flat) > 0
