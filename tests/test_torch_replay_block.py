"""The event-blocked replay: the plain version of the megakernel
(``repro_torch.kernels.fitscore.replay_block_ref``) against the
reference's Pallas megakernel ``repro.kernels.fitscore.
fitscore_replay_block`` in interpret mode (how the JAX package's own tests
run it on the CPU), one block per kernel family.

Each case starts from a mid-replay carry: the port replays the first 64
events of three lanes of the mixed fixture (one lane per instance, one per
prediction setting) with its plain version, the carry goes to the
reference's layout (``packed_carry_to_reference``: d padded to 128 lanes,
slots to the reference's tiling), and both replay the next block of 32
events - past the end of the shorter lanes, so PAD events are in it.  The
reference's carry comes back through ``packed_carry_from_reference``, and
every carry array must be equal bit for bit.  The CUDA kernel's own
comparison with the plain version runs only on a card
(tests/test_torch_cuda.py, ``chip_smoke.py``).

Then the blocked path end to end against the reference: the overflow
ladder from an 8-slot pool, ``run_sweep`` store files (byte for byte, per
event and blocked), the category headline grid of ``chip_smoke.py`` and
the CLI's ``--block-events``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.kernels.fitscore as ref_fitscore
from repro.core import Instance
from repro.core import jaxsim
from repro.sweep import pack_instances, pad_predictions, run_batch
from repro.sweep.runner import _flatten_lanes
from repro_torch.core import torchsim
from repro_torch.core.types import Instance as PortInstance
from repro_torch.kernels import fitscore as fk
from repro_torch.kernels import ops
from repro_torch.sweep import pack_instances as port_pack
from repro_torch.sweep import run_batch as port_run_batch

# the tensors here are tiny: intra-op threads only contend with the other
# test workers
torch.set_num_threads(1)

PREFIX, T = 64, 32


def quantized_instance(seed, n, d):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 24, (n, d)) / 64.0
    arr = np.sort(rng.integers(0, 50000, n)).astype(float)
    dur = rng.integers(10, 5000, n).astype(float)
    return Instance(sizes, arr, arr + dur, f"q{seed}").sorted_by_arrival()


@pytest.fixture(scope="module")
def lanes():
    """Three lanes: instance 0 clairvoyant, instance 1 with pdep ==
    arrival, instance 2 with power-of-two noise (40/60/30 items, d =
    2/4/3, 120 events a lane with PAD tails)."""
    insts = [quantized_instance(1, 40, 2), quantized_instance(2, 60, 4),
             quantized_instance(3, 30, 3)]
    batch = pack_instances(insts)
    preds = []
    for i in insts:
        rng = np.random.default_rng(100)
        noisy = i.durations * rng.choice([0.25, 0.5, 1.0, 2.0, 4.0],
                                         i.n_items)
        preds.append(np.stack([i.durations, np.zeros(i.n_items), noisy]))
    pdeps = pad_predictions(batch, preds)
    flat = _flatten_lanes(batch.sizes, batch.times, batch.kinds,
                          batch.items, pdeps, batch.dmask, batch.arrivals,
                          batch.pdeps, batch.n_items)
    pick = np.array([0, 4, 8])
    return tuple(np.asarray(a)[pick] for a in flat)


@pytest.mark.parametrize("policy,max_bins", [
    ("nrt_prioritized", 20), ("best_fit_l2", 300), ("cbdt", 20),
    ("hybrid_direct_sum", 20), ("ppe", 20), ("la_geometric", 20),
    ("adaptive", 20)])
def test_replay_block_ref_equals_interpret_megakernel(policy, max_bins,
                                                      lanes):
    """One block per family (and a 300-slot pool, which the reference
    pads to 512 rows): the plain version == the reference's megakernel."""
    ev_i, ev_f, ev_size, dmask, fam, d = torchsim._event_streams(
        policy, *lanes, None)
    L, n_max = lanes[0].shape[0], lanes[0].shape[1]
    kw = torchsim.replay_block_kwargs(policy, max_bins, d)
    carry = torchsim.packed_init_carry(fam, L, n_max, max_bins, "cpu")
    ops.replay_chunk(carry, ev_i[:, :, :PREFIX], ev_f[:, :, :PREFIX],
                     ev_size[:, :PREFIX], dmask, block_events=PREFIX, **kw)
    ref_in = torchsim.packed_carry_to_reference(carry, d)
    Np_ref = ref_fitscore.select_pad_geometry(max_bins, d)[0]
    assert ref_in["loads"].shape == (L, Np_ref, 128)
    blk = slice(PREFIX, PREFIX + T)
    names_i = ("kind", "item") + fk.REPLAY_EV_I[fam]
    names_f = ("t", "pdep") + fk.REPLAY_EV_F[fam]
    size_ref = np.zeros((L, T, 128), np.float32)
    size_ref[:, :, :fk.DPAD] = ev_size[:, blk].numpy()
    dmask_ref = np.zeros((L, 128), np.float32)
    dmask_ref[:, :fk.DPAD] = dmask.numpy()
    out = ref_fitscore.fitscore_replay_block(
        {k: jnp.asarray(v) for k, v in ref_in.items()},
        {nm: jnp.asarray(ev_i[k, :, blk].numpy())
         for k, nm in enumerate(names_i)},
        {nm: jnp.asarray(ev_f[k, :, blk].numpy())
         for k, nm in enumerate(names_f)},
        jnp.asarray(size_ref), jnp.asarray(dmask_ref), interpret=True, **kw)
    assert (ev_i[0, :, blk] == fk.PAD_KIND).any()      # a PAD tail
    got = fk.replay_block_ref(carry, ev_i[:, :, blk], ev_f[:, :, blk],
                              ev_size[:, blk], dmask, **kw)
    want = torchsim.packed_carry_from_reference(out, d, max_bins, "cpu")
    assert set(got) == set(want) == set(fk.replay_carry_names(fam))
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_pad_events_leave_the_carry_unchanged(lanes):
    """A block of PAD events only is a no-op, in every family."""
    for policy in ("greedy", "cbd", "reduced_hybrid", "rcp", "la_binary",
                   "adaptive"):
        ev_i, ev_f, ev_size, dmask, fam, d = torchsim._event_streams(
            policy, *lanes, None)
        kw = torchsim.replay_block_kwargs(policy, 20, d)
        carry = torchsim.packed_init_carry(fam, 3, lanes[0].shape[1], 20,
                                           "cpu")
        ops.replay_chunk(carry, ev_i[:, :, :PREFIX], ev_f[:, :, :PREFIX],
                         ev_size[:, :PREFIX], dmask, block_events=16, **kw)
        before = {k: v.clone() for k, v in carry.items()}
        pad_i = ev_i[:, :, :8].clone()
        pad_i[0] = fk.PAD_KIND
        fk.replay_block_ref(carry, pad_i, ev_f[:, :, :8], ev_size[:, :8],
                            dmask, **kw)
        for k in carry:
            assert torch.equal(carry[k], before[k]), (policy, k)


@pytest.mark.parametrize("fam", fk.REPLAY_FAMILIES)
def test_packed_init_carry_equals_reference(fam):
    """The fresh packed carry, in the reference's layout after the
    conversion (a 300-slot pool: 512 reference rows), and back."""
    ref = jaxsim.packed_init_carry(fam, 2, 7, 300, 3)
    port = torchsim.packed_init_carry(fam, 2, 7, 300, "cpu")
    conv = torchsim.packed_carry_to_reference(port, 3)
    assert set(conv) == set(ref) == set(fk.replay_carry_names(fam))
    for k in ref:
        np.testing.assert_array_equal(conv[k], np.asarray(ref[k]), err_msg=k)
        assert conv[k].dtype == np.asarray(ref[k]).dtype
    back = torchsim.packed_carry_from_reference(ref, 3, 300, "cpu")
    for k in port:
        assert torch.equal(back[k], port[k]), k


@pytest.mark.parametrize("name", [
    "SLOTF_CLOSES", "SLOTF_OPEN_TIME", "SLOTF_COLS", "SLOTI_COUNTS",
    "SLOTI_ALIVE", "SLOTI_OSEQ", "SLOTI_ASEQ", "SLOTI_TAG", "SLOTI_COLS",
    "ITEMI_PLACE", "ITEMI_AUX", "ITEMI_COLS", "SF_USAGE", "SF_ALPHA",
    "SF_ERR", "SF_COLS", "SI_SEQ", "SI_OPENED", "SI_OVERFLOW", "SI_BASE",
    "SI_COLS", "RAGG_BASE", "RAGG_ROWS", "RON_COLS", "REPLAY_FAMILIES",
    "REPLAY_EV_I", "REPLAY_EV_F"])
def test_packed_layout_constants_equal_reference(name):
    assert getattr(fk, name) == getattr(ref_fitscore, name)


def _cuda_constants():
    """The ``constexpr`` constants and the ``Family`` / ``Policy`` enums of
    the kernels' sources, evaluated: ``{name: value}``."""
    import os
    import re
    csrc = os.path.join(os.path.dirname(fk.__file__), "csrc")
    text = "".join(open(os.path.join(csrc, f)).read()
                   for f in ("fitscore_common.cuh", "replay_common.cuh",
                             "replay_block.cu", "replay_block_sm90.cu"))
    text = re.sub(r"//[^\n]*", "", text)
    found = {}
    for decls in re.findall(r"constexpr\s+(?:int|float)\s+([^;]+);", text):
        for decl in decls.split(","):
            name, expr = (x.strip() for x in decl.split("="))
            expr = re.sub(r"(\d)f\b", r"\1", expr)
            assert re.fullmatch(r"[\w\s.+\-*/<()]+", expr), expr
            found[name] = eval(expr, {"__builtins__": {}}, dict(found))
    for body in re.findall(r"enum\s+\w+\s*:\s*int\s*\{([^}]*)\}", text):
        for decl in body.split(","):
            if decl.strip():
                name, value = (x.strip() for x in decl.split("="))
                found[name] = int(value)
    return found


# (the name in the CUDA sources, the name in kernels/fitscore.py)
_CUDA_NAMES = [(n, n) for n in (
    "SLOTF_CLOSES", "SLOTF_OPEN_TIME", "SLOTI_COUNTS", "SLOTI_ALIVE",
    "SLOTI_OSEQ", "SLOTI_ASEQ", "SLOTI_TAG", "ITEMI_PLACE", "ITEMI_AUX",
    "SF_USAGE", "SF_ALPHA", "SF_ERR", "SI_SEQ", "SI_OPENED", "SI_OVERFLOW",
    "SI_BASE", "KCAT", "RAGG_BASE", "RAGG_ROWS", "TAG_GENERAL", "TAG_BASE",
    "TAG_LARGE", "TAG_NONE", "LOC_G", "LOC_B", "LOC_C", "LOC_L", "DPAD",
    "IBIG", "SCORE_BIG", "SCORE_NEG", "F32_EPS")] + [
    ("COLS", n) for n in ("SLOTF_COLS", "SLOTI_COLS", "ITEMI_COLS", "SF_COLS",
                          "SI_COLS", "RON_COLS")] + [
    ("ARRIVAL", "ARRIVAL_KIND"), ("DEPARTURE", "DEPARTURE_KIND"),
    ("MIGRATION", "MIGRATE_KIND")]


@pytest.mark.parametrize("cuda_name,name", _CUDA_NAMES)
def test_cuda_layout_constants_equal_python(cuda_name, name):
    """The packed layout and the codes are written out twice, in
    kernels/fitscore.py and in the CUDA sources; the card's equality run
    is not the only thing that ties them together (float constants
    compared in float32, as the kernels hold them)."""
    got = _cuda_constants()[cuda_name]
    want = getattr(fk, name)
    if isinstance(want, float):
        assert np.float32(got) == np.float32(want)
    else:
        assert got == want


@pytest.mark.parametrize("enum,names", [("family", fk.REPLAY_FAMILIES),
                                        ("policy", fk.SELECT_POLICIES)])
def test_cuda_enums_follow_python_order(enum, names):
    """The kernels' ``Family`` and ``Policy`` codes are the indices into
    ``REPLAY_FAMILIES`` and ``SELECT_POLICIES``."""
    found = _cuda_constants()
    assert [found[n.upper()] for n in names] == list(range(len(names)))


def test_replay_init_carry_matches_the_path(lanes):
    per_event = torchsim.replay_init_carry("ppe", 16, 3, 40, L=2,
                                           device="cpu")
    assert len(per_event) == 13 and per_event[0].shape == (2, 16, fk.DPAD)
    assert len(torchsim.replay_init_carry("la_binary", 16, 3, 40,
                                          device="cpu")) == 12
    blocked = torchsim.replay_init_carry("ppe", 16, 3, 40, L=2,
                                         block_events=8, device="cpu")
    assert set(blocked) == set(fk.replay_carry_names("rcp"))


def test_wrapper_takes_the_plain_version_on_the_cpu(lanes):
    """On CPU tensors the wrapper runs ``replay_block_ref`` and counts no
    launch; a chunk that is not a whole number of blocks is refused."""
    ev_i, ev_f, ev_size, dmask, fam, d = torchsim._event_streams(
        "cbd", *lanes, None)
    kw = torchsim.replay_block_kwargs("cbd", 20, d)
    a = torchsim.packed_init_carry(fam, 3, lanes[0].shape[1], 20, "cpu")
    b = {k: v.clone() for k, v in a.items()}
    n0 = ops.launches["fitscore_replay_block"]
    ops.fitscore_replay_block(a, ev_i[:, :, :T], ev_f[:, :, :T],
                              ev_size[:, :T], dmask, **kw)
    fk.replay_block_ref(b, ev_i[:, :, :T], ev_f[:, :, :T], ev_size[:, :T],
                        dmask, **kw)
    assert ops.launches["fitscore_replay_block"] == n0
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="multiple"):
        ops.replay_chunk(a, ev_i[:, :, :30], ev_f[:, :, :30],
                         ev_size[:, :30], dmask, block_events=16, **kw)


# ------------------------------------------- the blocked path end to end

def port_instance(inst):
    return PortInstance(inst.sizes, inst.arrivals, inst.departures,
                        inst.name)


def dense_instance(seed, n, d):
    """High concurrency: many items alive at once, so a small pool
    overflows and RCP/PPE reach base-bin conversions."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 24, (n, d)) / 64.0
    arr = np.sort(rng.integers(0, 2000, n)).astype(float)
    dur = rng.integers(500, 4000, n).astype(float)
    return Instance(sizes, arr, arr + dur, f"d{seed}").sorted_by_arrival()


@pytest.mark.parametrize("policy", ["cbd", "hybrid_direct_sum", "rcp",
                                    "ppe", "la_binary", "adaptive"])
def test_overflow_ladder_blocked_equals_reference(policy):
    """Dense lanes from an 8-slot pool: the blocked replay's ladder climbs
    the reference's rungs, rerunning the overflowing lanes from a fresh
    carry, and lands on its results (heavy load and 0.25x / 4x noise push
    RCP/PPE through base conversion and category ON/OFF)."""
    insts = [dense_instance(35, 50, 3), dense_instance(36, 60, 2)]
    batch = pack_instances(insts)
    rng = np.random.default_rng(3)
    pdeps = pad_predictions(
        batch, [np.stack([i.durations,
                          i.durations * rng.choice([0.25, 4.0], i.n_items)])
                for i in insts])
    a = run_batch(batch, policy, pdeps, max_bins=8, backend="jnp")
    b = port_run_batch(port_pack([port_instance(i) for i in insts]), policy,
                       pdeps, max_bins=8, device="cpu", block_events=16)
    assert (a.max_bins > 8).any()
    for f in ("usage_time", "n_bins_opened", "overflowed", "max_bins"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


def test_run_sweep_category_store_byte_identical(tmp_path):
    """A sweep over category policies, per event and blocked, writes the
    reference's store file byte for byte: ``block_events`` is an execution
    argument."""
    import os
    import repro.sweep as ref_sweep
    import repro_torch.sweep as port_sweep
    pols = ("first_fit", "cbd", "reduced_hybrid", "ppe_modified",
            "la_binary", "adaptive")
    preds = (("clairvoyant", 0.0), ("lognormal", 1.0))
    specs = [m.SweepSpec(suites=(m.SuiteSpec("azure", 2, 100, 5),),
                         policies=pols,
                         predictions=tuple(m.PredModel(*p) for p in preds),
                         seeds=(0, 1), max_bins=16)
             for m in (ref_sweep, port_sweep)]
    assert specs[0].spec_hash() == specs[1].spec_hash()
    ref_sweep.run_sweep(specs[0], store=ref_sweep.SweepStore(
        str(tmp_path / "ref")), backend="jnp")
    name = f"sweep_{specs[0].suites_hash()}.json"
    with open(tmp_path / "ref" / name, "rb") as f:
        want = f.read()
    for T in (0, 16):
        d = tmp_path / f"port{T}"
        recs = port_sweep.run_sweep(specs[1],
                                    store=port_sweep.SweepStore(str(d)),
                                    device="cpu", block_events=T)
        assert len(recs) == 2 * len(pols) * 3
        with open(os.path.join(d, name), "rb") as f:
            assert f.read() == want, T


def test_category_headline_equals_chip_constant():
    """The 28 x 250 seed-11 grid of benchmarks/perf.py::sweep_categories
    (cbd, reduced_hybrid, ppe_modified, la_binary x lognormal:1.0 x seeds
    0-5): the jnp reference, the port per event and the port blocked all
    total ``chip_smoke.REF_USAGE_CAT_28x4``, the number the card must
    reproduce.  Sizes and predictions here are not fp32-exact, so this is
    where RCP_RSQRT and the classifiers' rounding show."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    import repro.core as ref_core
    import repro.data as ref_data
    import repro_torch.data as port_data
    seeds = chip_smoke.CAT_HEADLINE_SEEDS
    insts = ref_data.make_azure_like_suite(28, 250, seed=11)
    rb = pack_instances(insts)
    pdeps = pad_predictions(rb, [ref_core.lognormal_predictions_batch(
        i, 1.0, seeds) for i in insts])
    pb = port_pack(port_data.make_azure_like_suite(28, 250, seed=11))
    ref = sum(float(run_batch(rb, p, pdeps, max_bins=64, backend="jnp")
                    .usage_time.sum())
              for p in chip_smoke.CAT_HEADLINE_POLICIES)
    for T in (0, 256):
        port = sum(float(port_run_batch(pb, p, pdeps, max_bins=64,
                                        device="cpu", block_events=T)
                         .usage_time.sum())
                   for p in chip_smoke.CAT_HEADLINE_POLICIES)
        assert port == ref, T
    assert f"{ref:.0f}" == str(chip_smoke.REF_USAGE_CAT_28x4)


def test_cli_block_events_on_cpu(tmp_path):
    import os
    import subprocess
    import sys
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    outs = []
    for T in ("0", "16"):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch", "sweep", "--device", "cpu",
             "--n-instances", "2", "--n-items", "60", "--policies",
             "cbdt,ppe,la_geometric", "--preds", "lognormal:1.0",
             "--seeds", "0,1", "--block-events", T, "--no-store"],
            env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.count("# run ") == 3
        outs.append(proc.stdout.splitlines()[-3:])
    assert outs[0] == outs[1]
