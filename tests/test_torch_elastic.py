"""Elastic training and int8 error-feedback gradient compression in the
port (``repro_torch.train.elastic``, ``repro_torch.train.grad_compress``)
against the JAX package's.

Tolerances, each stated where it is used:

- an elastic run that fails at step 13 and resumes from its step-10
  checkpoint ends within 1e-6 of the run that never failed (the JAX
  package's own limit, ``tests/test_train.py``);
- the port's trainer against the reference's on the same weights and
  stream: the last loss within 1e-5 relative, the train step's fp32 limit
  (``tests/test_torch_train.py``);
- ``_quant`` and ``compress_allreduce`` against the reference's jitted
  ``_quant`` and ``compress_psum_pod``: bit for bit.
"""
import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from repro.data.tokens import TokenStream as RefStream
from repro.launch.mesh import make_host_mesh
from repro.models import params as ref_params
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.transformer import Runtime as RefRuntime
from repro.train import elastic as ref_elastic
from repro.train import grad_compress as ref_gc
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_step
from repro_torch.data.tokens import TokenStream
from repro_torch.models import params as P_
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Runtime
from repro_torch.train import optimizer as opt_
from repro_torch.train import train_step as step_
from repro_torch.train.elastic import ElasticConfig, ElasticTrainer
from repro_torch.train.grad_compress import _quant, compress_allreduce
from repro_torch.train.tree import leaves

RESUME_TOL = 1e-6
LOSS_TOL = 1e-5
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, dtype="float32",
            attn_q_chunk=64)     # tests/test_train.py's CFG
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=30)
SEQ, BATCH = 32, 4              # tests/test_train.py's stream


def _ref_tree():
    return jax.jit(ref_params.init_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), RefModelConfig(**TINY), jnp.float32)


def port_parts(from_reference: bool = False):
    """(make_state, make_step, batch_fn) of the port's trainer on the tiny
    configuration: fresh weights from the port's ``init_params`` (seed 0),
    or the reference's ``init_params`` tree carried across."""
    cfg, opt = ModelConfig(**TINY), opt_.OptConfig(**OPT)
    tree = jax.tree.map(np.asarray, _ref_tree()) if from_reference else None
    stream = TokenStream(cfg.vocab, SEQ, BATCH)

    def make_state(device):
        p = P_.params_from_reference(tree, cfg, device=device) \
            if from_reference else \
            P_.init_params(cfg, seed=0, device=device, dtype=torch.float32)
        return (p, opt_.init_opt_state(p, opt))

    def make_step(device):
        fn = step_.make_train_step(cfg, Runtime(), opt)

        def step(state, batch):
            p, o, m = fn(*state, batch)
            return (p, o), m
        return step, None

    return make_state, make_step, stream.batch


def ref_parts():
    """The reference test's (make_state, make_step, batch_fn)."""
    cfg, opt = RefModelConfig(**TINY), ref_opt.OptConfig(**OPT)
    stream = RefStream(cfg.vocab, SEQ, BATCH)

    def make_state():
        p = _ref_tree()
        return (p, ref_opt.init_opt_state(p, opt))

    def make_step(mesh):
        fn = ref_step.make_train_step(cfg, RefRuntime(mesh=None), opt,
                                      microbatches=1)

        @jax.jit
        def step(state, batch):
            p, o = state
            p, o, m = fn(p, o, batch)
            return (p, o), m
        return step, None

    def batch_fn(step):
        return jax.tree.map(jnp.asarray, stream.batch(step))

    return make_state, make_step, batch_fn


def _fail_and_resume(parts, root, device="cpu", resume_device=None):
    """A run that fails at step 13 (checkpoints every 5 steps), then a new
    trainer over its checkpoints on ``resume_device``: (the resumed
    trainer's first step, its last loss)."""
    b = ElasticTrainer(*parts, root, ElasticConfig(ckpt_every=5))
    b.attach(device)
    with pytest.raises(RuntimeError, match="simulated node failure at 13"):
        b.run(20, fail_at=13)
    b2 = ElasticTrainer(*parts, root, ElasticConfig(ckpt_every=5))
    b2.attach(resume_device or device)
    start = b2.step
    return start, float(b2.run(20 - start)["loss"])


def test_elastic_resume_exact(tmp_path):
    """The reference's test on the port: 20 straight steps against a run
    failing at 13 and a trainer re-attached to its step-10 checkpoint."""
    parts = port_parts()
    a = ElasticTrainer(*parts, str(tmp_path / "a"),
                       ElasticConfig(ckpt_every=5))
    a.attach("cpu")
    assert a.step == 0
    ref = float(a.run(20)["loss"])
    assert a.ckpt.all_steps() == [15, 20]       # keep=2
    start, got = _fail_and_resume(parts, str(tmp_path / "b"))
    assert start == 10
    assert got == pytest.approx(ref, abs=RESUME_TOL)


def test_elastic_equals_the_reference_trainer(tmp_path):
    """The port's and the reference's trainers from the reference's weights
    on the same stream: the straight runs' last losses, and the resumed
    runs', within the train step's fp32 limit; checkpoints at the same
    steps."""
    pa = ElasticTrainer(*port_parts(from_reference=True),
                        str(tmp_path / "pa"), ElasticConfig(ckpt_every=5))
    pa.attach("cpu")
    ra = ref_elastic.ElasticTrainer(*ref_parts(), str(tmp_path / "ra"),
                                    ref_elastic.ElasticConfig(ckpt_every=5))
    ra.attach(make_host_mesh())
    got, want = float(pa.run(20)["loss"]), float(ra.run(20)["loss"])
    assert got == pytest.approx(want, rel=LOSS_TOL)
    assert pa.ckpt.all_steps() == ra.ckpt.all_steps()
    start, resumed = _fail_and_resume(port_parts(from_reference=True),
                                      str(tmp_path / "pb"))
    assert start == 10
    assert resumed == pytest.approx(want, rel=LOSS_TOL)


def test_a_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's trainer fails at step 13; the port's trainer attached
    to its checkpoints resumes at step 10 and ends within the train step's
    fp32 limit of the reference's straight run."""
    ra = ref_elastic.ElasticTrainer(*ref_parts(), str(tmp_path / "a"),
                                    ref_elastic.ElasticConfig(ckpt_every=5))
    ra.attach(make_host_mesh())
    want = float(ra.run(20)["loss"])
    root = str(tmp_path / "b")
    rb = ref_elastic.ElasticTrainer(*ref_parts(), root,
                                    ref_elastic.ElasticConfig(ckpt_every=5))
    rb.attach(make_host_mesh())
    with pytest.raises(RuntimeError):
        rb.run(20, fail_at=13)
    pb = ElasticTrainer(*port_parts(), root, ElasticConfig(ckpt_every=5))
    pb.attach("cpu")
    assert pb.step == 10
    assert float(pb.run(10)["loss"]) == pytest.approx(want, rel=LOSS_TOL)


# ----------------------------------------------------- gradient compression

def _rows_the_rewrite_moves(x):
    """How many rows' scales differ between ``absmax / 127`` and ``absmax *
    fp32(1 / 127)``: the rows where the traced rounding shows."""
    absmax = np.abs(x).max(axis=-1)
    div = absmax / np.float32(127.0)
    mul = absmax * (np.float32(1.0) / np.float32(127.0))
    return int(np.sum((absmax > 0) & (div != mul)))


@pytest.mark.parametrize("shape", [(64, 1), (256, 7), (512, 127),
                                   (96, 1024), (8, 3, 4099)])
def test_quant_equals_the_traced_reference(shape):
    """``_quant`` bit for bit against ``jax.jit(_quant)`` of the reference's
    ``grad_compress``, on rows of widely spread magnitudes (a zero row,
    exact halves) among which the division's and the reciprocal's scales
    differ."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) *
         10.0 ** rng.uniform(-8, 2, shape[:-1] + (1,))).astype(np.float32)
    x[0] = 0.0
    x[1, ..., :1] = 0.5
    assert _rows_the_rewrite_moves(x) > 0
    q, s = _quant(torch.from_numpy(x))
    rq, rs = jax.jit(ref_gc._quant)(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert np.array_equal(s.numpy(), np.asarray(rs))


def test_error_feedback_bounds_the_drift():
    """The reference's own check on the port: over 50 steps the summed
    dequantized updates track the summed true gradients within 2 % of the
    largest (+1e-5)."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(8, 1024)).astype(np.float32) * 1e-3
    err = np.zeros_like(g)
    total_true = np.zeros_like(g)
    total_sent = np.zeros_like(g)
    for _ in range(50):
        gt = rng.normal(size=g.shape).astype(np.float32) * 1e-3
        total_true += gt
        x = gt + err
        q, s = _quant(torch.from_numpy(x))
        deq = q.numpy().astype(np.float32) * s.numpy()
        err = x - deq
        total_sent += deq
    drift = np.abs(total_sent - total_true).max()
    assert drift <= np.abs(total_true).max() * 0.02 + 1e-5


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo process group over a file store (no network)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _grad_tree(seed, dtype=np.float32):
    """Gradients and carried errors of a small parameter tree (nested
    dicts, a stacked leaf, a vector), from ``seed``."""
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1e-3):
        return (rng.standard_normal(shape) * scale *
                10.0 ** rng.uniform(-3, 1, shape[:-1] + (1,))
                ).astype(np.float32)
    g = {"embed": arr(40, 24), "layers": {"wq": arr(2, 24, 16),
                                          "norm": arr(2, 24)},
         "out": arr(24)}
    e = jax.tree.map(lambda a: (0.01 * a).astype(np.float32), g)
    return jax.tree.map(lambda a: a.astype(dtype), g), e


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree, np.float32)).to(
        torch.bfloat16 if np.asarray(tree).dtype == jnp.bfloat16
        else torch.float32)


def _jit_psum_pod():
    """The reference's ``compress_psum_pod`` on a one-device ("pod",) mesh,
    jitted, as a train step runs it: XLA's rewrites apply (the scale's
    division by 127 a product with the reciprocal, the error's ``x - q *
    s`` contracted to an FMA).  Called outside a jit under jax 0.9.0, it
    rounds otherwise (an IEEE division, an unfused error)."""
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("pod",))
    return jax.jit(functools.partial(ref_gc.compress_psum_pod, mesh=mesh))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_world_of_one_equals_compress_psum_pod(world1, dtype):
    """``compress_allreduce`` of a tree on a one-rank group against the
    reference's jitted ``compress_psum_pod`` on a one-device ("pod",) mesh,
    leaf by leaf: reduced gradients (in the gradients' dtype) and new
    errors bit for bit.  (The reference's function takes one array at a
    time: over a tree of several leaves its ``tree.map`` returns a tree of
    pairs, which its ``out_specs`` pair refuses.)"""
    g, e = _grad_tree(1, dtype)
    ref = _jit_psum_pod()
    got_g, got_e = compress_allreduce(_to_torch(g), _to_torch(e))
    pairs = zip(leaves(got_g), leaves(got_e), jax.tree.leaves(g),
                jax.tree.leaves(e))
    n = 0
    for pg, pe, rg, re in pairs:
        want_g, want_e = ref(jnp.asarray(rg), jnp.asarray(re))
        assert pg.dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                            else torch.float32)
        assert pe.dtype == torch.float32
        assert np.array_equal(pg.float().numpy(),
                              np.asarray(want_g, np.float32))
        assert np.array_equal(pe.numpy(), np.asarray(want_e))
        n += 1
    assert n == len(jax.tree.leaves(g)) == 4


_RANK_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.train.grad_compress import compress_allreduce
    rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2)
    data = np.load(out + f".in{rank}.npz")
    g = {k[2:]: torch.from_numpy(data[k]) for k in data.files
         if k.startswith("g.")}
    e = {k[2:]: torch.from_numpy(data[k]) for k in data.files
         if k.startswith("e.")}
    red, err = compress_allreduce(g, e)
    np.savez(out + f".out{rank}.npz",
             **{"g." + k: v.numpy() for k, v in red.items()},
             **{"e." + k: v.numpy() for k, v in err.items()})
    dist.destroy_process_group()
""")


def test_two_ranks_average_their_dequantized_gradients(tmp_path):
    """Two gloo ranks (processes) with different gradients and errors: each
    returns the mean of the two ranks' dequantized values, computed from
    the reference's traced ``_quant``, and its own new error, the
    reference's jitted ``compress_psum_pod``'s on its own gradients."""
    base = str(tmp_path / "run")
    trees = []
    for rank in (0, 1):
        rng = np.random.default_rng(10 + rank)
        g = {f"w{i}": (rng.standard_normal((16, 33 * (i + 1))) *
                       10.0 ** rng.uniform(-4, 0, (16, 1))).astype(np.float32)
             for i in range(3)}
        e = {k: (1e-3 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in g.items()}
        trees.append((g, e))
        np.savez(base + f".in{rank}.npz", **{"g." + k: v for k, v in
                                             g.items()},
                 **{"e." + k: v for k, v in e.items()})
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    init = f"file://{tmp_path}/pg"
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT, str(r),
                               init, base], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
    deq, new_e = [], []
    quant, ref = jax.jit(ref_gc._quant), _jit_psum_pod()
    for g, e in trees:
        d, ne = {}, {}
        for k in g:
            q, s = quant(jnp.asarray(g[k] + e[k]))
            d[k] = np.asarray(q, np.float32) * np.asarray(s)
            ne[k] = np.asarray(ref(jnp.asarray(g[k]), jnp.asarray(e[k]))[1])
        deq.append(d)
        new_e.append(ne)
    for rank in (0, 1):
        out = np.load(base + f".out{rank}.npz")
        for k in trees[0][0]:
            mean = (deq[0][k] + deq[1][k]) * np.float32(0.5)
            assert np.array_equal(out["g." + k], mean)
            assert np.array_equal(out["e." + k], new_e[rank][k])
