"""The port's sharded models (``repro_torch.models.sharding``, the sharded
``forward``, ``moe_block`` and train step) against the JAX package's on
meshes of automatic axes, and ``launch.train`` across ranks.

The reference runs as two JAX processes of 4 host devices
(``tp_reference.py``: this process's JAX has already started with one),
the port as gloo rank processes at world 2 and 4 (``tp_ranks.py``) over a
file store under ``tmp_path``, all at once, once for the module; the tests
compare what they wrote (``tp_cases`` lists the cases).  Reduced
configurations in fp32.  Limits:

- logits (training-mode forward, prefill, decode steps) within 1e-5 of
  their max |logit|; rwkv6-1.6b's within 1e-4, its chunked scan's
  tolerance (``tests/test_torch_rwkv.py``: the sums run in another
  order), which its unsharded logits need too (1.5e-5 on these weights);
- ``moe_block``'s output within 1e-5 of its max; its aux loss data shard
  0's (1e-6 relative); the dispatch tables' token ids equal and their
  combine weights within 1e-6;
- the train step: the loss within 1e-6 relative, the other metrics within
  1e-5, every gradient leaf within 1e-4 of its max |g| of the same step's
  on one rank with no mesh (the port's own: only the sharding differs)
  and of the reference's, the updated parameters within 2e-5 (the JAX
  package's own limit, ``tests/test_train.py``) where the gradient is
  above that 1e-4 (below it, Adam's first step ``g / (|g| + eps)``
  divides the gradients' difference by their size); fp32 moments within
  1e-5 of their max, int8 moments' values within 1 and their scales 1e-5
  relative (a row of the embedding's m, scale 1.4e-6, sums its few
  gradient terms in another order and reads 1.1e-6); rwkv6-1.6b's fp32
  moments within 1e-4, its logits' limit: the first step's m is 0.1 g,
  and its one-rank gradient is itself ~2e-5 of max |g| from the
  reference's (the scan's sums in another order; ``tp_cases.SPREAD``
  draws its bonus wide enough that no head's first position amplifies
  that further);
- ``compress_allreduce`` over "pod": bit for bit;
- ``launch.train`` on a (1, 2) mesh: the losses of a one-rank run within
  1e-2 relative (the configuration's bf16 compute,
  ``tests/test_torch_train.py``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import tp_cases as C
from repro_torch.configs import get_reduced_config
from repro_torch.launch import train as launch_train

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
LOGIT_TOL = 1e-5
RWKV_TOL = 1e-4
LOSS_REL = 1e-6
METRIC_REL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 2e-5
MAIN_LOSS_REL = 1e-2
TIMEOUT = 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, port): the two sides' results, each a dict of arrays."""
    tmp = tmp_path_factory.mktemp("tp")
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [SRC, HERE, os.environ.get("PYTHONPATH", "")]))
    jax_env = dict(env, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count"
                                   "=4").strip())
    jobs = [([os.path.join(HERE, "tp_reference.py"),
              str(tmp / f"ref_{part}.npz"), part], jax_env)
            for part in ("forward", "rest")]
    for world in (2, 4):
        jobs += [([os.path.join(HERE, "tp_ranks.py"), str(r), str(world),
                   f"file://{tmp}/pg{world}", str(tmp / f"port{world}.npz")],
                  env) for r in range(world)]
    procs = []
    for i, (args, e) in enumerate(jobs):
        log = open(tmp / f"log{i}.txt", "w")
        procs.append((subprocess.Popen([sys.executable] + args, env=e,
                                       stdout=log, stderr=subprocess.STDOUT),
                      log, args))
    failed = []
    try:
        for p, log, args in procs:
            try:
                p.wait(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            if p.returncode:
                failed.append((args, p.returncode))
    finally:
        for p, log, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        logs = "\n".join(open(tmp / f"log{i}.txt").read()[-3000:]
                         for i in range(len(procs)))
        pytest.fail(f"{failed}\n{logs}")

    def load(*names):
        out = {}
        for n in names:
            with np.load(tmp / n) as f:
                out.update({k: f[k] for k in f.files})
        return out
    return (load("ref_forward.npz", "ref_rest.npz"),
            load("port2.npz", "port4.npz"))


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() /
                 max(np.abs(want).max(), 1e-30))


FORWARD_KEYS = [(name, what) for name in C.FORWARD
                for what in ("train", "prefill") +
                tuple(f"decode{i}" for i in range(C.STEPS))]


@pytest.mark.parametrize("name,what", FORWARD_KEYS)
def test_sharded_logits_equal_the_reference(runs, name, what):
    """The sharded ``forward``'s logits, gathered whole on every rank, in
    training mode and through the sharded cache (a prefill, then decode
    steps), against the reference's on the same mesh: qwen2.5-14b at (1,
    2) and (2, 2); nemotron-4-340b at (1, 4) (its 6 heads do not split in
    4: the head-split weights gathered, kv heads whole) and at (1, 2) with
    sequence parallelism; gemma3-12b's windows, minitron-8b,
    granite-moe-3b-a800m's experts, pixtral-12b's patch prefix and
    deepseek-v2-lite-16b's MLA, absorbed and not, at (1, 2);
    whisper-medium's encoder and cross-attention at (1, 2); rwkv6-1.6b's
    time mix and recurrent state at (1, 2), at (1, 4) (a head a rank) and
    at (1, 2) with sequence parallelism (each token shift across the ranks'
    slices); hymba-1.5b at (1, 2), its SSD heads split, and with 5 heads,
    which do not split in 2 (attention and SSD whole on each rank)."""
    ref, port = runs
    key = f"{name}/{what}"
    assert port[key].shape == ref[key].shape
    tol = RWKV_TOL if name.startswith("rwkv6") else LOGIT_TOL
    assert _rel(port[key], ref[key]) <= tol


@pytest.mark.parametrize("name", list(C.MOE))
def test_sharded_moe_block_equals_the_reference(runs, name):
    """granite-moe-3b-a800m's MoE block: expert parallel at (1, 2); at (2,
    2), where the capacity counts each data shard's tokens and, at a
    capacity factor of 0.5, pairs drop; and with 6 experts at (1, 4), the
    experts' hidden dim split.
    The output, each data shard's dispatch tables, and the aux loss,
    which is data shard 0's on every rank, as the reference returns it."""
    ref, port = runs
    assert _rel(port[f"{name}/out"], ref[f"{name}/out"]) <= LOGIT_TOL
    aux = float(port[f"{name}/aux"])
    assert aux == pytest.approx(float(ref[f"{name}/aux"]), rel=LOSS_REL)
    assert aux == pytest.approx(float(ref[f"{name}/aux0"]), rel=LOSS_REL)
    shape, _ = C.MOE[name]
    kept = 0
    for j in range(shape[0]):
        table = port[f"{name}/table{j}"]
        assert np.array_equal(table, ref[f"{name}/table{j}"])
        np.testing.assert_allclose(port[f"{name}/wtable{j}"],
                                   ref[f"{name}/wtable{j}"], atol=1e-6)
        kept += int((table < C.MOE_B * C.MOE_S // shape[0]).sum())
    if shape[0] > 1:
        cfg = get_reduced_config("granite-moe-3b-a800m")
        assert kept < C.MOE_B * C.MOE_S * cfg.top_k       # pairs dropped
        assert float(ref[f"{name}/aux0"]) != float(ref[f"{name}/aux1"])


@pytest.mark.parametrize("name", list(C.MOE))
def test_sharded_dense_mode_equals_the_mesh_free_reference(runs, name):
    """``moe_block(impl="dense")`` under the mesh (``Runtime(moe_impl=
    "dense")``): the experts gathered, each data shard's tokens dropless,
    the aux loss over the whole batch, as the reference's dense mode
    computes under a mesh: its mesh-free function."""
    ref, port = runs
    assert _rel(port[f"{name}/dense_out"], ref[f"{name}/dense_out"]) <= \
        LOGIT_TOL
    assert float(port[f"{name}/dense_aux"]) == pytest.approx(
        float(ref[f"{name}/dense_aux"]), rel=METRIC_REL)


@pytest.mark.parametrize("name", list(C.TRAIN))
def test_sharded_train_step_equals_the_reference(runs, name):
    """The train step with 2 microbatches: qwen2.5-14b's at (2, 2) with
    FSDP, fp32 and int8 moments; rwkv6-1.6b's at (1, 2), hymba-1.5b's at
    (2, 2) and whisper-medium's (its encoder frames split over data) at (1,
    2), fp32 moments.  The metrics, every gradient leaf (gathered from the
    shards), the updated parameters and moments."""
    ref, port = runs
    p = f"{name}/metric/"
    metrics = [k[len(p):] for k in ref if k.startswith(p)]
    assert sorted(metrics) == sorted(k[len(p):] for k in port
                                     if k.startswith(p))
    assert float(port[p + "loss"]) == pytest.approx(float(ref[p + "loss"]),
                                                    rel=LOSS_REL)
    for k in metrics:
        assert float(port[p + k]) == pytest.approx(float(ref[p + k]),
                                                   rel=METRIC_REL, abs=1e-7)
    keys = [k for k in ref if k.startswith(f"{name}/grad/")]
    assert keys and set(keys) == {k for k in port
                                  if k.startswith(f"{name}/grad/")}
    for k in keys:
        assert _rel(port[k], ref[k]) <= GRAD_TOL, k
        assert _rel(port[k], port[k.replace("/grad/", "/one_rank/")]) <= \
            GRAD_TOL, k
    for k in (k for k in ref if k.startswith(f"{name}/param/")):
        g = np.abs(ref[k.replace("/param/", "/grad/")])
        sure = g > GRAD_TOL * g.max()
        assert np.abs(port[k] - ref[k])[sure].max() <= PARAM_TOL, k
    for key in ("m", "v"):
        keys = [k for k in ref if k.startswith(f"{name}/{key}/")]
        assert keys
        for k in keys:
            if k.endswith("['q']"):
                assert np.abs(port[k].astype(int) -
                              ref[k].astype(int)).max() <= 1, k
            elif k.endswith("['s']"):
                np.testing.assert_allclose(port[k], ref[k], rtol=1e-5,
                                           err_msg=k)
            else:
                assert _rel(port[k], ref[k]) <= (
                    RWKV_TOL if name.startswith("rwkv6") else 1e-5), k


def test_compress_allreduce_reduces_over_pods_only(runs):
    """``compress_allreduce(mesh=)`` on a ("pod", "data", "model") mesh of
    (2, 2, 1): each rank gets the mean of its own and the other pod's
    (same data coordinate) dequantized gradients, not the whole world's."""
    _, port = runs
    deq, out = port["compress/deq"], port["compress/out"]
    for r in range(4):
        want = (deq[r] + deq[r ^ 2]) * np.float32(0.5)
        assert np.array_equal(out[r], want)
    assert not np.array_equal(out[0], out[1])


def test_meshes_of_one_rank(tmp_path):
    """``make_host_mesh`` brings up a one-rank group where there is none:
    a (1, 1) mesh; a mesh of another size and the production meshes are
    refused by that group."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    assert not dist.is_initialized()
    mesh = M.make_host_mesh("cpu")
    try:
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == \
            {"data": 1, "model": 1}
        with pytest.raises(ValueError, match="needs a group of 2"):
            M.make_mesh((1, 2), ("data", "model"), "cpu")
        for multi in (False, True):
            with pytest.raises(ValueError, match="production mesh"):
                M.make_production_mesh(multi_pod=multi, device_type="cpu")
    finally:
        dist.destroy_process_group()
    assert M.data_axes(True) == ("pod", "data")
    assert (M.SINGLE_POD, M.MULTI_POD) == ((16, 16), (2, 16, 16))


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "rwkv6-1.6b"])
def test_launch_train_on_a_model_axis_follows_one_rank(monkeypatch,
                                                      tmp_path, arch):
    """``launch.train.main(["--mesh", "1x2", "--device", "cpu", ...])``
    spawns two gloo ranks and logs the losses of a one-rank run (``--mesh
    1x1``, in this process) within 1e-2 relative: 2 steps that end in a
    checkpoint (gathered, written by rank 0), then a run of 3 that resumes
    from it (each rank reads its shards) and logs step 2.  qwen2.5-14b and
    rwkv6-1.6b (its time mix on each rank's heads)."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    args = ["--arch", arch, "--reduced", "--batch", "4", "--seq",
            "32", "--log-every", "1", "--device", "cpu"]
    one = launch_train.main(args + ["--steps", "3", "--mesh", "1x1"])
    ck = ["--mesh", "1x2", "--ckpt", str(tmp_path / "ck")]
    two = launch_train.main(args + ["--steps", "2"] + ck)
    two += launch_train.main(args + ["--steps", "3"] + ck)
    assert [s for s, _ in two] == [0, 1, 2]
    np.testing.assert_allclose([m["loss"] for _, m in two],
                               [m["loss"] for _, m in one],
                               rtol=MAIN_LOSS_REL)
