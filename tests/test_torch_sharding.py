"""The port's sharding plan (``repro_torch.models.sharding``,
``launch.specs``, ``train.optimizer.opt_state_placements``) against the
JAX package's, in one process with no ranks: meshes are duck-typed, only
their axis sizes read (``.shape`` a mapping, as the reference's
``tree_pspecs`` reads it; a plain mapping on the port's side).

- ``tree_placements`` equals ``tree_pspecs`` leaf for leaf for all ten
  architectures at full size: on the production meshes (16, 16) and (2,
  16, 16) under ``make_rules`` for every shape ``shapes_for`` lists, and on
  (1, 2), (2, 2), (1, 4), (4, 1) and (1, 16) with ``fsdp`` and
  ``fsdp_vocab_tables`` each on and off;
- so do the per-rank parameter bytes the two plans give;
- ``opt_state_placements`` equals ``opt_state_pspecs``, fp32 and int8
  states;
- ``make_rules``, ``opt_config``, ``MICROBATCHES`` and the three sets of
  ``launch/specs.py`` equal the reference's.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import get_config as ref_get_config
from repro.launch import specs as ref_specs
from repro.models import params as ref_params
from repro.models import sharding as ref_sharding
from repro.models.config import SHAPES as REF_SHAPES
from repro.train import optimizer as ref_opt
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import specs
from repro_torch.models import sharding
from repro_torch.models.attention import kv_heads_for
from repro_torch.models.config import SHAPES, shapes_for
from repro_torch.train import optimizer as opt_

PRODUCTION = {"single": {"data": 16, "model": 16},
              "multi": {"pod": 2, "data": 16, "model": 16}}
SMALL = [(1, 2), (2, 2), (1, 4), (4, 1), (1, 16)]
FLAGS = [(f, v) for f in (False, True) for v in (False, True)]


def _ref_mesh(sizes):
    return types.SimpleNamespace(shape=dict(sizes))


def _ref_rules(rules):
    return ref_sharding.ShardingRules(**dataclasses.asdict(rules))


def _tuples(tree):
    """The reference's PartitionSpec tree as a tree of tuples."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    assert isinstance(tree, PartitionSpec)
    return tuple(tree)


def _plans(arch, sizes, rules):
    got = sharding.tree_placements(get_config(arch), sizes, rules)
    want = ref_sharding.tree_pspecs(ref_get_config(arch), _ref_mesh(sizes),
                                    _ref_rules(rules))
    return got, want


def _rank_bytes(shapes, plan, sizes, nbytes=4):
    """Bytes of one rank's shards under ``plan`` (a tree of placements)."""
    total = 0
    for key, sub in shapes.items():
        pl = plan[key]
        items = sub.items() if isinstance(sub, dict) else [(None, sub)]
        for name, shape in items:
            p = pl if name is None else pl[name]
            total += int(np.prod(sharding.local_shape(shape, tuple(p),
                                                      sizes))) * nbytes
    return total


def _shapes(arch):
    return ref_params._finalize(ref_get_config(arch), lambda m, n: (
        ((n,) + m.shape) if n else m.shape))


PROD_CASES = [(a, mesh, s) for a in ARCHS for mesh in PRODUCTION
              for s in shapes_for(a)]


@pytest.mark.parametrize("arch,mesh,shape", PROD_CASES)
def test_production_placements_equal_tree_pspecs(arch, mesh, shape):
    """Under ``make_rules`` on the production mesh: every leaf's placement
    is the reference's PartitionSpec, and the per-rank bytes are equal."""
    multi = mesh == "multi"
    rules = specs.make_rules(get_config(arch), SHAPES[shape], multi)
    got, want = _plans(arch, PRODUCTION[mesh], rules)
    assert got == _tuples(want)
    sizes = PRODUCTION[mesh]
    assert _rank_bytes(_shapes(arch), got, sizes) == \
        _rank_bytes(_shapes(arch), _tuples(want), sizes)


SMALL_CASES = [(a, m, f, v) for a in ARCHS for m in SMALL for f, v in FLAGS]


@pytest.mark.parametrize("arch,mesh,fsdp,vocab_tables", SMALL_CASES)
def test_small_mesh_placements_equal_tree_pspecs(arch, mesh, fsdp,
                                                  vocab_tables):
    """On the meshes the multi-rank tests run, with ``fsdp`` and
    ``fsdp_vocab_tables`` on and off: the placements and per-rank bytes
    are the reference's."""
    sizes = {"data": mesh[0], "model": mesh[1]}
    rules = sharding.ShardingRules(fsdp=fsdp, fsdp_vocab_tables=vocab_tables)
    got, want = _plans(arch, sizes, rules)
    assert got == _tuples(want)
    assert _rank_bytes(_shapes(arch), got, sizes) == \
        _rank_bytes(_shapes(arch), _tuples(want), sizes)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_placements_equal_opt_state_pspecs(arch, state_dtype):
    """The optimizer state's placements (an int8 moment's scale whole
    along its last dim) on the production mesh with FSDP."""
    sizes = PRODUCTION["single"]
    rules = sharding.ShardingRules(fsdp=True)
    got, want = _plans(arch, sizes, rules)
    port = opt_.opt_state_placements(got, opt_.OptConfig(
        state_dtype=state_dtype))
    ref = ref_opt.opt_state_pspecs(want, ref_opt.OptConfig(
        state_dtype=state_dtype))
    assert port == _tuples(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_tables_equal_the_reference(arch):
    """``make_rules`` for every shape and both meshes, with and without
    the overrides, and ``opt_config``, as the reference's."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for shape in shapes_for(arch):
        for multi in (False, True):
            for kw in ({}, {"fsdp": False}, {"seq_parallel": True}):
                got = specs.make_rules(cfg, SHAPES[shape], multi, **kw)
                want = ref_specs.make_rules(ref_cfg, REF_SHAPES[shape], multi,
                                            **kw)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(specs.opt_config(cfg)) == \
        dataclasses.asdict(ref_specs.opt_config(ref_cfg))


def test_specs_constants_equal_the_reference():
    assert specs.MICROBATCHES == ref_specs.MICROBATCHES
    assert specs.SEQ_PARALLEL == ref_specs.SEQ_PARALLEL
    assert specs.INT8_OPT == ref_specs.INT8_OPT
    assert specs.BF16_ACCUM == ref_specs.BF16_ACCUM
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == \
            dataclasses.asdict(REF_SHAPES[name])


@pytest.mark.parametrize("H,KV,m", [(8, 2, 2), (6, 2, 2), (40, 8, 16),
                                    (16, 8, 16), (12, 4, 4), (16, 2, 4),
                                    (24, 8, 4)])
def test_kv_heads_for_covers_each_rank_query_heads(H, KV, m):
    """Each rank's kv heads serve its query heads under the GQA map of a
    call over them (local query head j reads local kv head j // (H_loc /
    KV_loc)), and every rank holds as many."""
    G, H_loc = H // KV, H // m
    lens = set()
    for r in range(m):
        kv = kv_heads_for(H, KV, H_loc, r)
        assert H_loc % len(kv) == 0
        g = H_loc // len(kv)
        for j in range(H_loc):
            assert kv[j // g] == (r * H_loc + j) // G
        lens.add(len(kv))
    assert len(lens) == 1


@pytest.mark.parametrize("H", [16, 8, 4])
def test_latent_tiles_at_the_local_heads(H):
    """The latent kernel's tile holds ``64 // H`` positions of all H heads:
    at deepseek's 16 heads split over 2 and 4 ranks, 8 and 16 positions."""
    assert ops.LATENT_TILE_ROWS % H == 0
    P = ops.LATENT_TILE_ROWS // H
    for Sq in (1, 4, 5, 17, 221):
        assert ops.latent_tiles(Sq, H) == -(-Sq // P)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "nemotron-4-340b",
                                  "deepseek-v2-lite-16b", "hymba-1.5b"])
def test_cache_placements_split_batch_and_kv_heads(arch):
    """The port's cache layout: batch over data where it divides, kv heads
    over model where they divide it (``"select"`` where the query heads
    split and the kv heads do not), no sequence sharding."""
    cfg = get_config(arch)
    rules = sharding.ShardingRules()
    pl = specs.cache_placements(cfg, 8, {"data": 2, "model": 4}, rules)
    assert pl["k"][1] == ("data",) and pl["k"][2] is None
    if cfg.n_heads % 4:
        assert pl["k"][3] is None
    else:
        assert pl["k"][3] == ("model" if cfg.n_kv_heads % 4 == 0
                              else "select")
    assert specs.cache_placements(cfg, 3, {"data": 2, "model": 1},
                                  rules)["k"][1] is None
    assert pl["lat"] == (None, ("data",), None, None)


STATE_MESHES = [{"data": 2, "model": 4}, {"data": 1, "model": 2},
                {"data": 4, "model": 64}, PRODUCTION["single"],
                PRODUCTION["multi"]]


@pytest.mark.parametrize("mesh", range(len(STATE_MESHES)))
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_recurrent_state_placements_equal_cache_specs(arch, mesh):
    """RWKV6's and the SSD's recurrent states (and RWKV6's token shifts)
    are placed as the reference's ``cache_specs`` places them for every
    serving shape: on the heads where ``n_heads`` divides the model axis
    (rwkv6-1.6b's 32 heads at 2, 4 and 16, not at 64; hymba-1.5b's 25 at
    none), the batch over the data axes where it divides."""
    sizes = STATE_MESHES[mesh]
    multi = "pod" in sizes
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    names = ("state", "shift_a", "shift_f") if cfg.rwkv else ("ssm",)
    for shape in shapes_for(arch):
        if SHAPES[shape].is_train:
            continue
        rules = specs.make_rules(cfg, SHAPES[shape], multi)
        _, want = ref_specs.cache_specs(
            ref_cfg, REF_SHAPES[shape], _ref_mesh(sizes), rules.data_axes,
            jnp.float32)
        got = specs.cache_placements(cfg, SHAPES[shape].global_batch, sizes,
                                     rules)
        for name in names:   # a tuple of one axis is that axis, as in P
            assert tuple(a[0] if isinstance(a, tuple) and len(a) == 1
                         else a for a in got[name]) == tuple(want[name]), \
                (shape, name)
    heads = got[names[0]][2]
    assert heads == ("model" if cfg.n_heads % sizes["model"] == 0
                     else None)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_leaf_name_is_placed_alike_in_every_stack(arch):
    """``TensorParallel.kept`` keys the layer leaves by name alone: a name
    in two stacks (whisper's encoder and decoder attention and MLP,
    deepseek's dense and MoE layers) has one placement and one set of
    logical axes, layer dim aside, on every small and production mesh."""
    cfg = get_config(arch)
    axes = sharding.P_.logical_axes(cfg)
    stacks = [k for k, v in axes.items() if isinstance(v, dict)]
    for sizes in [{"data": d, "model": m} for d, m in SMALL] + \
            list(PRODUCTION.values()):
        for fsdp in (False, True):
            pl = sharding.tree_placements(
                cfg, sizes, sharding.ShardingRules(fsdp=fsdp))
            for i, a in enumerate(stacks):
                for b in stacks[i + 1:]:
                    for name in set(axes[a]) & set(axes[b]):
                        assert axes[a][name] == axes[b][name], name
                        assert pl[a][name][1:] == pl[b][name][1:], name


def test_local_shape_and_slices_of_a_placement():
    """A rank's shard: each placed dim divided by its axes' sizes."""
    sizes = {"pod": 2, "data": 4, "model": 2}
    assert sharding.local_shape((8, 6, 4), (("pod", "data"), None, "model"),
                                sizes) == (1, 6, 2)
    assert sharding.axis_sizes(_ref_mesh(sizes)) == sizes
    t = torch.arange(16).reshape(4, 4)
    mesh = types.SimpleNamespace(
        shape=(2, 2), mesh_dim_names=("data", "model"),
        get_local_rank=lambda a: {"data": 1, "model": 0}[a])
    assert torch.equal(sharding.local_slice(t, ("data", "model"), mesh),
                       t[2:, :2])
