"""Drive the PyTorch + CUDA port on one card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. Device and build: the card's name and power limit, then the select
   kernel built from ``src/repro_torch/kernels/csrc`` (build time printed).
2. Kernel vs plain: the CUDA select against ``select_ref`` on the card, on
   random, tied and full pools for every score policy, with and without a
   category mask - (slot, found, no_free) must be identical.  Then the
   kernel's and the plain version's time at the main path's shapes (L=28
   and 56 lanes at Np=64 slots, L=28 at Np=128; d=5) beside the card's
   bound for the same work.
3. Headline grid: the 28 x 250, seed-11 Azure-like grid of four policies
   (first_fit, best_fit_l2, greedy, nrt_prioritized; max_bins=64) through
   ``run_batch``; total usage must equal ``REF_USAGE_28x4``.
4. Main path at full size: ``run_sweep`` over the 28-instance Azure-like
   suite at the generator's default size (28 x 5000 nominal, 138221 VMs),
   all 8 score policies x {clairvoyant, lognormal:1.0} x seeds {0, 1} into a
   temporary store.  Every replay step must have launched the kernel once;
   best_fit_l2 x clairvoyant is replayed again with the plain select bound
   in place of the kernel's wrapper and must agree; a second run over the
   store must find every group cached.

Then, as a measurement and not a check, 400 replay steps of the main
path's first rung (L=28, Np=64) under torch.profiler: device busy time
against wall time per step.

Prints the card's name and power limit and a JSON line of kernel numbers
before the last line, which is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Total usage of the 28 x 250 seed-11 grid of benchmarks/perf.py::
# sweep_batched_only as the JAX package's jnp path computes it (rounded as
# that benchmark prints it).  tests/test_torch_sweep.py ties it to the
# reference on the CPU.
REF_USAGE_28x4 = 179426678
HEADLINE_POLICIES = ("first_fit", "best_fit_l2", "greedy", "nrt_prioritized")

HBM_BYTES_PER_S = 3.35e12    # H100 SXM memory rate
F32_OPS_PER_S = 67e12        # H100 SXM fp32 rate outside the tensor cores


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def random_state(rng, L, Np, d, mode, dev):
    """One select input set: ``mode`` "random" (uniform loads), "ties"
    (a few load/closes levels, so many slots tie on score, and open_seq a
    permutation, so reused low rows carry late opening order) or "full"
    (every slot busy and nothing fits: no_free)."""
    import numpy as np
    import torch
    loads = np.zeros((L, Np, 8), np.float32)
    size = np.zeros((L, 8), np.float32)
    if mode == "ties":
        loads[:, :, :d] = rng.integers(0, 4, (L, Np, d)) / 8.0
        size[:, :d] = rng.integers(1, 3, (L, d)) / 8.0
        closes = rng.integers(0, 4, (L, Np)).astype(np.float32) * 10
    else:
        loads[:, :, :d] = rng.uniform(0, 0.9, (L, Np, d))
        size[:, :d] = rng.uniform(0.01, 0.4, (L, d))
        closes = rng.uniform(0, 100, (L, Np)).astype(np.float32)
    counts = rng.integers(0, 3, (L, Np)).astype(np.int32)
    if mode == "full":
        counts[:] = 1
        loads[:, :, :d] = 0.97
    dmask = np.zeros((L, 8), np.float32)
    dmask[:, :d] = 1.0
    dmask[::3, d - 1] = 0.0          # a lane with fewer real dims
    oseq = np.stack([rng.permutation(Np) for _ in range(L)]).astype(np.int32)
    aseq = rng.integers(0, 50, (L, Np)).astype(np.int32)
    pdep = rng.uniform(0, 100, L).astype(np.float32)
    now = rng.uniform(0, 60, L).astype(np.float32)
    cmask = rng.random((L, Np)) < 0.7
    arrs = (loads, counts, counts > 0, oseq, aseq, closes, size, pdep, now,
            dmask, cmask)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]


def time_ms(fn, reps: int) -> float:
    """Wall time per call of ``fn`` (host clock, synchronized): what a
    caller pays, launch and Python overhead included."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: a spin kernel holds the stream while
    the host queues ``reps`` calls, so the events bracket their work run
    back to back, without the host's launch gaps.  ``reps`` times the
    kernels per call must stay within the launch queue (~1000)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)      # ~0.2 s of spinning
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def raw_select(st, policy):
    """One select launch with no wrapper work (pointers bound up front),
    for timing the kernel alone; not counted as a main-path launch."""
    import torch
    from repro_torch.kernels._build import library
    from repro_torch.kernels.fitscore import policy_code
    lib = library()
    L, Np, _ = st[0].shape
    out = torch.empty((L, 3), dtype=torch.int32, device=st[0].device)
    args = [t.data_ptr() for t in st[:6]] + \
        [st[6].data_ptr(), st[9].data_ptr(), None, st[7].data_ptr(),
         st[8].data_ptr(), out.data_ptr(), L, Np, policy_code(policy),
         st[0].device.index or 0,
         torch.cuda.current_stream().cuda_stream]

    def launch():
        if lib.fitscore_select_launch(*args):
            fail("select launch failed")
    return launch, out


def phase_build():
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    t0 = time.perf_counter()
    path, secs, report = _build.build()
    _build.library()
    say(f"# build: {os.path.relpath(path, ROOT)} "
        f"(nvcc {secs:.1f} s, ready in {time.perf_counter() - t0:.1f} s)")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            say(f"#   {line.strip()}")
    return card


def phase_kernel_vs_plain(dev):
    import numpy as np
    import torch
    from repro_torch.kernels.fitscore import SELECT_POLICIES, select_ref
    from repro_torch.kernels.ops import fitscore_select
    rng = np.random.default_rng(2026)
    n_cases = max_err = 0
    for mode in ("random", "ties", "full"):
        for L in (28, 56):
            for Np in (64, 128, 256, 300):
                for d in (2, 4, 5):
                    st = random_state(rng, L, Np, d, mode, dev)
                    for policy in SELECT_POLICIES:
                        for cmask in (None, st[10]):
                            k = fitscore_select(*st[:10], cmask,
                                                policy=policy)
                            p = select_ref(*st[:10], cmask, policy=policy)
                            for a, b in zip(k, p):
                                err = int((a.long() - b.long()).abs().max())
                                max_err = max(max_err, err)
                                if err:
                                    fail(f"select kernel != plain: {mode} "
                                         f"L={L} Np={Np} d={d} {policy} "
                                         f"cmask={cmask is not None}")
                            n_cases += 1
    torch.cuda.synchronize()
    say(f"# kernel == plain on {n_cases} random cases "
        "(slot, found, no_free identical)")

    # timing at the main path's shapes: the first rung of the ladder (64
    # slots) for the clairvoyant (28 lanes) and the lognormal groups (56
    # lanes), and the second rung (128 slots); the line of kernel numbers
    # takes the 56-lane shape
    for L, Np in ((28, 64), (28, 128), (56, 64)):
        timed = time_select(dev, L, Np, 5, "best_fit_l2")
    timed["max_abs_err"] = max_err
    return timed


def time_select(dev, L, Np, d, policy):
    """Device and wall time per call of the kernel and of ``select_ref``
    on one random pool, beside the card's bound for the same work."""
    import numpy as np
    import torch
    from repro_torch.kernels.fitscore import select_ref
    from repro_torch.kernels.ops import fitscore_select
    st = random_state(np.random.default_rng(7), L, Np, d, "random", dev)
    launch, out = raw_select(st, policy)
    launch()
    if not torch.equal(out[:, 0], select_ref(*st[:10], policy=policy)[0]):
        fail("raw select launch disagrees with the plain version")
    ms = device_ms(launch, 500)
    plain_ms = device_ms(lambda: select_ref(*st[:10], policy=policy), 4)
    wrap_ms = time_ms(lambda: fitscore_select(*st[:10], policy=policy), 500)
    plain_wall_ms = time_ms(lambda: select_ref(*st[:10], policy=policy), 50)
    # bytes the function must move for best_fit_l2 over the d real dims:
    # loads, counts, alive, open_seq per slot, size and dmask per lane, the
    # (L, 3) output (the kernel's padding of d to 8 is not the function's)
    nbytes = L * Np * (d * 4 + 4 + 1 + 4) + L * 2 * d * 4 + L * 3 * 4
    # fp32 operations per slot: feasibility (sub, add, compare) and the l2
    # residual (sub, sub, mul, fma) on d dims, the sqrt, the argmin compare
    nops = L * Np * (d * 3 + d * 5 + 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    say(f"# select L={L} Np={Np} d={d} {policy}: device time per call: "
        f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms; bound "
        f"{bound_ms:.3e} ms by {bound_by} ({nbytes} B at 3.35 TB/s); wall "
        f"time per call: wrapper {wrap_ms:.6f} ms, plain {plain_wall_ms:.6f}"
        f" ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_headline(dev):
    from repro_torch.data import make_azure_like_suite
    from repro_torch.sweep import pack_instances, run_batch
    t0 = time.perf_counter()
    batch = pack_instances(make_azure_like_suite(28, 250, seed=11))
    total = sum(float(run_batch(batch, p, max_bins=64, device=dev)
                      .usage_time.sum()) for p in HEADLINE_POLICIES)
    say(f"# headline 28x250 seed 11 {','.join(HEADLINE_POLICIES)}: total "
        f"usage {total:.2f} in {time.perf_counter() - t0:.1f} s")
    if f"{total:.0f}" != str(REF_USAGE_28x4):
        fail(f"headline usage {total:.0f} != REF_USAGE_28x4 "
             f"{REF_USAGE_28x4}")


def phase_main_path(dev, n_items: int = 5000):
    import numpy as np
    import torch
    from repro_torch.core import torchsim
    from repro_torch.core.torchsim import POLICIES
    from repro_torch.kernels import ops
    from repro_torch.kernels.fitscore import select_ref
    from repro_torch.sweep import (PredModel, SuiteSpec, SweepSpec,
                                   SweepStore, run_batch, run_sweep,
                                   summarize_sweep)
    from repro_torch.sweep.grid import _built_suite, result_key
    suite = SuiteSpec("azure", 28, n_items)
    preds = (PredModel("clairvoyant"), PredModel("lognormal", 1.0))
    spec = SweepSpec(suites=(suite,), policies=POLICIES, predictions=preds,
                     seeds=(0, 1))
    insts, _, batch = _built_suite(suite)
    n_events = 2 * int(batch.n_items.sum())
    say(f"# main path: {len(insts)} instances, {n_events // 2} VMs, "
        f"n_max {batch.n_max}, d_max {batch.d_max}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_",
                                     dir=ROOT) as tmp:
        store = SweepStore(tmp)
        ops.launches.clear()
        torchsim.counters.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records = run_sweep(spec, store=store, device=dev,
                            progress=lambda m: say(f"#   {m}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launches["fitscore_select"]
        steps = torchsim.counters["scan_steps"]
        replays = sum(len(POLICIES) * (len(spec.seeds) if p.noisy else 1)
                      for p in preds)
        say(f"# main path: {len(records)} records in {wall:.1f} s, "
            f"{replays * n_events / wall:.0f} events/s "
            f"({replays} replays of {n_events} events), "
            f"{launches} select launches over {steps} scan steps")
        if launches != steps or steps == 0:
            fail(f"select launches {launches} != scan steps {steps}")
        for (pol, pred), st in summarize_sweep(records).items():
            say(f"#   ratio {pol:<16} {pred:<12} mean {st.mean:.6f}")
        # usage accumulates in fp32 (as in the reference), the Eq.(1)
        # bound in f64: a ratio may sit a few fp32 ulps under 1
        bad = [k for k, r in records.items()
               if r["overflowed"] or not np.isfinite(r["ratio"])
               or r["ratio"] < 1.0 - 1e-5]
        if len(records) != len(insts) * replays or bad:
            fail(f"{len(records)} records, bad: {bad[:3]}")

        # the plain select on the card must make the same decisions: bind
        # it in place of the kernel's wrapper for one run_batch
        t0 = time.perf_counter()
        torchsim.fitscore_select = select_ref
        try:
            plain = run_batch(batch, "best_fit_l2", None, spec.max_bins,
                              spec.max_bins_cap, device=dev)
        finally:
            torchsim.fitscore_select = ops.fitscore_select
        say(f"# best_fit_l2 x clairvoyant with the plain select: "
            f"{time.perf_counter() - t0:.1f} s")
        for bi, inst in enumerate(insts):
            r = records[result_key(suite, inst.name, "best_fit_l2",
                                   preds[0], 0)]
            if (r["usage_time"], r["n_bins_opened"]) != \
                    (float(plain.usage_time[bi, 0]),
                     int(plain.n_bins_opened[bi, 0])):
                fail(f"plain select differs on {inst.name}")

        msgs = []
        ops.launches.clear()
        again = run_sweep(spec, store=SweepStore(tmp), device=dev,
                          progress=msgs.append)
        if again != records or ops.launches["fitscore_select"] or \
                not all(m.startswith("skip") for m in msgs):
            fail("a second run over the store recomputed groups")
        say(f"# rerun over the store: all {len(msgs)} groups cached")
    return launches


def phase_profile(dev, n_items: int = 5000, steps: int = 400):
    """Where the time goes on the main path: ``steps`` replay steps of one
    group's first rung (best_fit_l2, clairvoyant, max_bins 64) under
    torch.profiler - device kernel time against wall time.  A measurement,
    not a check: if the profiler reports no device activity it says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.torchsim import _replay_batch
    from repro_torch.sweep import SuiteSpec
    from repro_torch.sweep.grid import _built_suite
    _, _, b = _built_suite(SuiteSpec("azure", 28, n_items))
    ev = slice(0, steps)
    args = (b.sizes, b.times[:, ev], b.kinds[:, ev], b.items[:, ev],
            b.pdeps, b.dmask)
    _replay_batch(*args, policy="best_fit_l2", max_bins=64, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _replay_batch(*args, policy="best_fit_l2", max_bins=64, device=dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_k = sum(e.count for e in kernels)
    sel = sum(e.self_device_time_total for e in kernels
              if "select_kernel" in e.key)
    if not n_k:
        say("# profile: the profiler saw no device kernels (not measured)")
        return
    say(f"# profile {steps} steps (L=28, Np=64, best_fit_l2, under the "
        f"profiler): wall {wall_us / steps:.1f} us/step, device busy "
        f"{busy_us / steps:.1f} us/step ({100 * busy_us / wall_us:.1f} %), "
        f"{n_k / steps:.1f} kernels/step, select kernel "
        f"{sel / steps:.2f} us/step")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        say(f"#   {e.self_device_time_total / steps:8.2f} us/step "
            f"x{e.count / steps:.1f}  {e.key[:90]}")


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable from {ROOT}/src: {e}")
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = phase_build()
    say(f"# torch {torch.__version__} cuda {torch.version.cuda} on {card}")
    kern = phase_kernel_vs_plain(dev)
    phase_headline(dev)
    launches = phase_main_path(dev)
    try:
        phase_profile(dev)
    except Exception as e:   # a measurement, not a check: report, go on
        say(f"# profile: not measured ({type(e).__name__}: {e})")
    say(f"# total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [dict(
        name="fitscore_select", route="cuda",
        source="src/repro_torch/kernels/csrc/select.cu",
        replaces="src/repro/kernels/fitscore.py:330",
        launches=launches, library_ms=None, **kern)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
