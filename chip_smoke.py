"""Drive the PyTorch + CUDA port on one card and check it end to end.

    python3 chip_smoke.py [--parent TREE]

``--parent TREE`` (a ``git archive`` of an earlier commit, unpacked) also
builds that tree's ``rwkv6_chunked.cu`` and ``fitscore.cu`` into a library
of their own and times them in turns with the port's kernels on the same
inputs (phases 9a and 10).  Float32 matrix products run in full float32
(``allow_tf32`` off, precision "highest"), so the plain versions the
kernels are held to are not themselves TF32; phases 9a and 10 check it.

Phases (any failure exits non-zero, and no result line is printed):

1. Device and build: the card's name and power limit, then the port's eight
   kernel sources built from ``src/repro_torch/kernels/csrc`` (one nvcc per
   source, started together; build time printed), each kernel's registers,
   spills and static shared memory from ptxas (the attention kernels must
   not spill), the HGMMA count of the tensor-core flash kernel's SASS and
   the HMMA count of the RWKV6 kernel's (``cuobjdump -sass``; 0 fails),
   and the attention, RWKV6 and replay warp kernels' dynamic shared
   memory.
2. Select vs plain: the CUDA select against ``select_ref`` on the card, on
   random, tied and full pools for every score policy, with and without a
   category mask - (slot, found, no_free) must be identical - on the route
   ``ops.select_route`` picks (the warp kernel up to 256 slots, the cta
   kernel above) and, up to 256 slots, on the cta kernel too.  Then both
   kernels' device time per raw launch on the same inputs, the plain
   version's, and the wrapper's wall time per call at the main path's
   shapes (L=28 and 56 lanes at Np=64 slots, L=28 at Np=128; d=5) beside
   the card's bound for the same work.
3. Megakernel vs plain: the CUDA replay megakernel against
   ``replay_block_ref`` on the card for all 21 policy names (every kernel
   family), L in {8, 56}, Np in {64, 128, 300}, d in {2, 4, 5}, T in {1,
   64, 256} with a PAD tail, from a mid-replay carry, and on the warp
   kernel's hazards (``HAZARDS``: an arrival and its departure in
   consecutive events, an RCP base conversion then a converted item's
   departure, an all-PAD block, a block whose last real event is its 5th,
   with MIGRATE events too): every carry array must be equal, on the route
   ``ops.replay_route`` picks (warp up to 256 slots, global above) and on
   the other where its kernel takes the pool; the blocks each route ran
   are printed.  Then its device time per launch over a whole scan of the
   main path (L=56 and 28, Np=64, 128 and 256, T=256), on the warp route
   and on the global kernel, beside its bound (the bytes and operations
   each block's data needs) and the serial chain of events per lane; the
   two routes and the same scan replayed again must end in the same carry,
   and its mid-scan block, replayed by ``replay_block_ref`` from the
   kernel's carry, must give every carry array equal.
4. Headline grids: the 28 x 250, seed-11 Azure-like grid of four score
   policies (first_fit, best_fit_l2, greedy, nrt_prioritized; max_bins=64)
   through ``run_batch``, total usage ``REF_USAGE_28x4``; and the category
   grid of benchmarks/perf.py::sweep_categories (cbd, reduced_hybrid,
   ppe_modified, la_binary x lognormal:1.0 x seeds 0-5), per event (the
   select with its category mask) and blocked, each totalling
   ``REF_USAGE_CAT_28x4``.
5. Main path per event: ``run_sweep`` over the 28-instance Azure-like suite
   at the generator's default size (28 x 5000 nominal, 138221 VMs), two of
   the 8 score policies (``PER_EVENT_POLICIES``: first_fit, best_fit_l2) x
   {clairvoyant, lognormal:1.0} x seeds {0, 1} into a temporary store.
   The per-event loop runs in windows of ``torchsim.STEP_WINDOW`` steps,
   each a replay of one CUDA graph.  Every replay step must have launched
   the select once (counted once a graph replay), all on the warp route;
   best_fit_l2 x clairvoyant is replayed again with the plain select bound
   in place of the kernel's wrapper and must agree; first_fit x
   clairvoyant is replayed again graphed and as the eager loop, each equal
   to the sweep's records, with both walls printed; a second run over the
   store must find every group cached.
6. Main path blocked: the same sweep with all 21 policies and
   ``block_events=BLOCK_EVENTS``: the megakernel must have launched once
   per block of every scan (counted by route) and the select never, the score policies'
   records must equal phase 5's on its keys, and every record is finite,
   overflow-free and at least the Eq.(1) bound; the wall time is split into
   the scans' CPU set-up, their copies to the card, their launches and the
   rest.
   Then ppe_modified x lognormal:1.0 x seed 0 per event at full size must
   equal its blocked records.
7. Attention kernels vs plain: the CUDA flash kernels (tensor cores for
   bf16 at hd 64 / 128, CUDA cores otherwise: ``ops.flash_route``, checked
   per call) and the decode kernel against ``flash_attention_ref`` /
   ``decode_attention_ref`` on the card, fp32 and bf16, on the JAX
   package's kernel-test shapes (causal / window cases (T, 0), (T, 32),
   (F, 0), (F, 16)), the tensor-core kernel's tile edges (Sq = Skv in {1,
   63, 64, 65, 127, 129}, Sq 64 against Skv 192, B 2; hd 64 and 128),
   decode's split edges (kv_len one before, at and past a split's end, 0,
   S, S not a multiple of the split) and the serving path's shapes (H=40,
   KV=8, hd=128; prefill Sq = Skv in {16, 511, 2048}; decode B in {4, 32} x
   S in {1024, 4096} with random kv_len and one row at S), NaN in every
   cache row past kv_len, within the JAX tests' tolerances (2e-5 fp32,
   2e-2 bf16, atol and rtol), and in bf16 also within ``BF16_REL`` of the
   output's largest magnitude.  Then each kernel's device time at the
   path's shapes in bf16 beside its bound, the plain version's time,
   ``scaled_dot_product_attention``'s (a yardstick, never on the path) and,
   for flash, the CUDA-core kernel's on the same bf16 inputs; decode's
   split count and device kernels a call (torch.profiler).
8. Serving at full width: qwen2.5-14b (48 layers, d 5120, bf16, random
   weights from seed 0 made on the card), 12 requests as
   ``repro_torch.launch.serve --real`` draws them (prompts 32-511 tokens,
   decodes capped at 64) through ``serve_real(..., "greedy", slots=4,
   max_len=1024)``: the DVBP scheduler places them on replicas, real
   ``ReplicaEngine``s prefill and decode them.  Flash attention must have
   launched 48 times per prefill, every call through the tensor-core
   kernel, and decode attention 48 times per engine decode step; the
   placement stats must equal ``REF_SERVE_STATS``.  One
   request is teacher-forced (prefill and 8 decode steps) with every
   attention call running both the kernel and the plain version on the
   same q, k, v, cache and kv_len, held to each other at every layer within
   the bf16 tolerance of phase 7; its logits must then equal those of a run
   with the plain versions bound in place of the kernels within
   ``SERVE_LOGIT_TOL`` of max |logit|.  Then
   torch.profiler over engine decode steps and one prefill at full width.
9. RWKV6 serving path.  (a) The CUDA ``rwkv6_chunked`` kernel against
   ``rwkv6_chunked_ref`` on the card, fp32 and bf16 r, k, v, on
   ``RWKV_SHAPES`` (the JAX kernel test's shapes, lengths that are not a
   multiple of the chunk, chunk 8, and the path's B 1 / H 32 / K = V = 64
   at S in {16, 511, 2048}) and ``RWKV_CROSS_SHAPES`` (across the kernel's
   windows and column blocks): y and the final state within ``RWKV_TOL``
   atol and rtol, and the grid launched ((B * H, ceil(V / 16)), at least 4
   CTAs a (b, h) at V 64); then its device time at the path's shapes in
   bf16 with its grid and windows, beside its bound, the plain version's
   and (``--parent``) the parent kernel's (no PyTorch call computes it).
   (b) rwkv6-1.6b at full width (24 layers, d 2048, 32 heads of 64, d_ff
   7168, vocab 65 536, bf16, random weights from seed 0 made on the card)
   serving phase 8's 12 requests through ``serve_real``: the kernel must
   have launched 24 times per prefill (288) and the attention kernels never,
   the stats must equal ``REF_SERVE_STATS``; the same requests served again
   with every one of the 288 kernel calls also running the plain version on
   its own inputs, within ``RWKV_TOL`` of max |plain|; one request
   teacher-forced (prefill and 8 decode steps) with the kernel and with the
   plain version bound in its place, logits within ``SERVE_LOGIT_TOL``;
   a prompt prefilled into a slot another request held gives a fresh
   engine's logits bit for bit.  Then torch.profiler over engine decode
   steps and one prefill, and the prefill's ``rwkv6_chunked`` share.
10. The legacy scorer (``ops.fitscore``, ``csrc/fitscore.cu``): kernel ==
   ``fitscore_ref`` bit for bit (scores and chosen row) on the JAX kernel
   test's shapes and on N in ``LEGACY_NS`` x d in {2, 5} x the four norms
   x random pools, 1/64-grid pools tied across CTAs (repeated open_seq, so
   the row decides) and pools where nothing fits (-1), each with its
   open_seq (a permutation or repeated values) and without one; 50 calls
   back to back on one stream and 50 alternating between two, each ==
   plain (the merge's counter resets).  Its main path: a host Best Fit
   (l_inf) loop placing ``LEGACY_PLACEMENTS`` items into a 4096-bin pool,
   one launch an arrival, == the loop through the plain version.  Then its
   device time at d=5, linf for each N beside its byte bound, an empty
   kernel's launch (the floor below ~1 M bins), the plain version's and
   (``--parent``) the parent's two-launch kernel's (no PyTorch call
   computes it).
11. Consolidation.  (a) The megakernel with its MIGRATE branch ==
   ``replay_block_ref(migrate=True)`` on blocks opening with MIGRATE events
   (a migrant whose source bin closes, RCP/PPE migrants off the base bin),
   all 21 policies x T in {1, 8, 256}, on both routes as in phase 3;
   without MIGRATE events the kernel with the branch == without.  (b) The frontier: the 28 x 250 seed-11
   grid, ``HEADLINE_POLICIES`` x underload:t{0.15,0.25,0.5}:e32 through
   ``run_batch(consolidate=)``, per event and blocked: migrations and usage
   totals == ``REF_CONS``.  (c) Full size: the 28 x 5000 suite,
   clairvoyant, ``CONS_SPEC``, all 21 policies blocked: a mid-scan MIGRATE
   chunk of every scan == ``replay_block_ref`` from the kernel's carry,
   ``PER_EVENT_POLICIES`` per event == blocked; migrations, usage against
   phase 6, the wall time split into replay, planner and copies, the
   CUDA events around the path's MIGRATE chunk calls (the host's launch
   gaps included), and each scan's middle MIGRATE chunk replayed five times
   on each route's kernel (equal to the path's; device time, side by
   side).

12. The replay against the port's own oracle: 8 fp32-exact instances
   (1/64-grid sizes, integer times; ``ORACLE_ITEMS`` items, d
   ``ORACLE_D``), clairvoyant and power-of-two noise, 16 lanes of 3000
   events.  For all 21 policies ``run_batch`` per event with
   ``trace_level=1`` (the CUDA select in CUDA graphs of event windows) and
   blocked (the megakernel) must equal ``core.run(inst,
   torchsim.host_algorithm(policy), ...)``: usage exactly and opened bins,
   lane by lane, and the traced open-bin, load and usage series event for
   event (``obs.diff_traces`` against ``oracle_trace``, which rebuilds
   them from the oracle's placements; the first divergence is printed).
   Then ``run_batch(consolidate=ORACLE_CONS)`` on 4 of the instances,
   blocked for one policy of each family and ppe, per event for first_fit
   and ppe: usage, opened bins and migrations equal
   ``run_consolidating``'s.  The oracle's and the card's wall times are
   printed.
13. The scheduler's zoo: ``DVBPScheduler`` over ``ZOO_REQUESTS`` requests
   built like ``launch/serve.py``'s (arrivals rounded up to whole seconds,
   ``ZOO_TPS`` tokens a second: float32-exact).  Every registry policy on
   the host; ``select_backend="device"`` on the card for the score
   policies, CBD and CBDT (one CUDA select a request, the class from the
   host's float64 ``duration_class`` / ``departure_window``): every
   decision and the stats equal to the host zoo's.
14. ``obs`` on the card: a per-event and a blocked sweep, a consolidating
   replay and the device select under ``obs.recording()`` - the
   reference's span names present (``sweep.run_batch``, ``sweep.scan``,
   ``pack.instances``, ``suite.build``, ``consolidate.replay``,
   ``serving.select``, ``store.save``); a JSONL run log and a Perfetto
   file written, the log summarized by ``python -m repro_torch obs``;
   ``torch_profile`` with a log directory writes a trace of the profiled
   ops that holds every megakernel launch of the profiled blocked replay
   (the lead-in's surviving kernels counted apart); traced card replays ==
   traced CPU replays of the same
   lanes at ``trace_level=2`` (``diff_traces(...) is None``, one policy a
   family) and a slot flipped in one event pinpointed at that (lane,
   event, "slot"); the untraced and traced per-event replays' wall time a
   step at phase 12's shape, in turns.
15. Resilience on the card (``phase_resilience``): first a guard - no
   ``REPRO_TORCH_FAULTS`` and no ``resilience.*`` counter moved in phases
   1-14 (checked before phase 14 resets the counters, and again here).
   The ladder: ``run_batch`` of the 28 x 250 seed-11 suite blocked
   (best_fit_l2) under ``sweep.scan:xla:1:1`` (-> per event),
   ``xla:1:2`` (-> the CPU) and ``oom:1:1`` (a retry), each equal to the
   fault-free blocked run bit for bit and each counter moved by exactly
   one.  ``checkpointed_replay`` of its lanes in segments of
   ``CKPT_EVERY`` events for ``CKPT_POLICIES`` (and rcp with MIGRATE
   events), per event and blocked, equal to the unsegmented card replay,
   with the per-event segments' warm-up and capture time; a segmented
   replay stopped by an injected fault at its 2nd segment and resumed.
   ``python -m repro_torch sweep --device cuda --resume`` killed by
   ``sweep.group:kill:2`` and by ``ckpt.segment:kill:3`` (two stores, in
   parallel subprocesses) and rerun: each store equal to a clean card
   run's.  The scheduler's guarded device select (cbd, nrt_prioritized)
   under ``serving.select:xla:5:1`` and ``xla:1:0`` equal to the host zoo
   decision for decision.
16. The streamed replay on the card (``phase_stream``), the shapes of
   benchmarks/perf.py's perf/stream_replay rows: ``synthetic_source(10
   000, seed=21)`` at max_bins 128 and ``synthetic_source(100 000,
   seed=22)`` at 256, 2048-event chunks over 2048 item rows: first_fit
   per event (10k) and one policy a family blocked at T = 256, each equal
   to the in-memory card replay of the materialized instance, with fewer
   item rows than items (hybrid pins its table); the walls, a chunk's
   split (host streams, staging, replay, the builder), the accounted
   ``peak_device_bytes`` and ``torch.cuda.max_memory_allocated`` beside
   the in-memory replay's; a pool of 16 rows that grows; prefetch 0
   against 1 at 100k (in turns, equal); a stream killed at
   ``ckpt.save:kill:2`` in a subprocess, resumed here from its snapshot.
17. The experiment API and online serving (``phase_api_serving``): (a)
   ``api.Experiment`` over phase 4's 28 x 250 suite == ``run_sweep``'s
   records, total ``REF_USAGE_28x4``; (b) ``serve_traffic`` (the live
   one-lane carry, blocks of the megakernel, double-buffered) over
   benchmarks/perf.py::serve_throughput's trace (2000 Poisson requests at
   5e4 a second, 1.2e5 tokens a second) for one policy of each live family
   (score, cbd, rcp, la, adaptive) at batch sizes 1, 32 and 256: each ==
   the sequential host-zoo oracle decision for decision and in its fleet
   numbers, a second pass adding no launch geometry (us a placed request,
   p50 / p99 placement latency, the wall's split into host stream
   building, launching and resolving); (c) a stream with one slot a
   replica whose peak passes 256, from a 64-slot pool: it regrows to 512
   and its blocks move from the warp kernel to the global one, == the
   oracle; (e) phase 13's requests through the scheduler's ``select_block``
   == the host zoo; (f) ``python -m repro_torch serve`` in both modes on
   the card (its default) == with ``--device cpu``, row for row (the
   wall-clock columns aside); (d) injected faults at ``serving.select``,
   ``kernel.dispatch_block`` and ``kernel.select_block``: each steps one
   rung and moves no other resilience counter, decisions unchanged.  Then
   one early block of each geometry of (b) through both routes ==
   ``replay_block_ref``, and its device time a block at L=1 beside its
   bound.

Then, as a measurement and not a check, on the main path's first rung
(L=28, Np=64): torch.profiler over 2048 graphed per-event steps and 400
eager ones (device busy time against wall time, the select's own time in
the graphed steps), CUDA events around each graph replay (the graphed
windows' device time a step), the whole scan's wall time a step at windows
of 64, 128 and 256 steps, the select's device time a launch inside a CUDA
graph of 256 launches, and torch.profiler over one blocked scan.

Prints the card's name and power limit and a JSON line of kernel numbers
before the last line, which is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import statistics
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
# The category headline: benchmarks/perf.py::sweep_categories (the same 28 x
# 250 seed-11 suite, four category policies x lognormal:1.0 x seeds 0-5) on
# the JAX package's jnp path; tests/test_torch_categories.py ties it to the
# reference on the CPU.
REF_USAGE_CAT_28x4 = 1467354455
CAT_HEADLINE_POLICIES = ("cbd", "reduced_hybrid", "ppe_modified", "la_binary")
CAT_HEADLINE_SEEDS = (0, 1, 2, 3, 4, 5)

# Events per megakernel launch on the blocked main path: the events of a
# lane are a serial chain either way; 256 puts ~55 launches in a 13.9k-event
# scan, so the launch and its host-side wrapper cost ~1/256 of an event
# each, and the tested T in {1, 64, 256} of phase 3 includes it.
BLOCK_EVENTS = 256

# The per-event main path (phase 5) runs two of the 8 score policies: the
# first and the l2 best fit, whose select the plain-select swap checks.
# Phase 6 replays all 21 blocked and is held to phase 5 on these keys.
PER_EVENT_POLICIES = ("first_fit", "best_fit_l2")

# Placement stats of phases 8 and 9's serve_real (replica_seconds,
# replicas_opened, peak_replicas).  They do not depend on the model (eos_id
# = -1, no sequence reaches max_len); tests/test_torch_serving.py ties them
# to the JAX package's serve_real on both reduced configurations.
REF_SERVE_STATS = (187.0, 3, 3)
SERVE_REQUESTS, SERVE_DECODE_CAP, SERVE_SLOTS, SERVE_MAX_LEN = 12, 64, 4, 1024
# Kernel vs plain logits of the teacher-forced request, relative to max
# |logit|.  Each layer's attention output is held to the plain version's on
# the same inputs (phase 8's per-call check); the logits compare two runs
# whose bf16 activations part once any layer's output rounds one ulp apart,
# and that drift passes through the rest of the 48 layers: 2.265e-02 in a
# measured run on the H100.  The per-call check is the tight one.
SERVE_LOGIT_TOL = 5e-2

HBM_BYTES_PER_S = 3.35e12    # H100 SXM memory rate
F32_OPS_PER_S = 67e12        # H100 SXM fp32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12      # H100 SXM dense bf16 rate (tensor cores)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py
# RWKV6's chunked kernel against its plain version (y and the final state,
# both fp32 for fp32 and bf16 inputs alike): tests/test_kernels.py's 1e-4,
# atol and rtol; the serving path's calls are held within RWKV_TOL of max
# |plain| on their own inputs.
RWKV_TOL = 1e-4
# (B, S, H, K, V, chunk): the JAX kernel test's shapes, two lengths that are
# not a multiple of the chunk, the reduced configuration's chunk of 8, and
# the serving path's B 1 / H 32 / K = V = 64 (prompts padded inside).
RWKV_SHAPES = [(2, 64, 2, 16, 16, 16), (1, 48, 4, 32, 64, 16),
               (2, 16, 1, 8, 8, 16), (1, 128, 2, 64, 64, 16),
               (2, 50, 2, 64, 64, 16), (2, 40, 4, 16, 16, 8)] + \
    [(1, s, 32, 64, 64, 16) for s in (16, 511, 2048)]
# Shapes across the kernel's windows (8 chunks) and column blocks (16 state
# columns): S of three windows and a ragged tail at chunk 16 and 8, V 40 (a
# half block), K 48 and 20, B 2 with odd H, and K / V whose rows are not
# 16-byte multiples (plain loads instead of TMA).
RWKV_CROSS_SHAPES = [(2, 389, 3, 48, 40, 16), (2, 197, 3, 64, 40, 8),
                     (1, 389, 2, 64, 64, 16), (2, 133, 3, 20, 12, 16),
                     (1, 70, 2, 7, 5, 8)]
# Both attention versions compute in fp32 and round the result to bf16
# once, so an element may round one bf16 ulp apart (at most 2^-7 of its
# magnitude); a bf16 output may differ from the plain one by two such ulps
# of the output's largest magnitude, on top of the atol / rtol check.
BF16_REL = 2.0 ** -6

# Phase 10, the legacy scorer: tests/test_kernels.py::test_fitscore's
# shapes, the pool sizes timed (benchmarks/perf.py's 4096-bin row,
# MAX_BINS_CAP, 2^20) and the arrivals of its main-path placement loop.
LEGACY_TEST_SHAPES = [(100, 4, "linf"), (1000, 5, "l1"), (37, 2, "l2"),
                      (300, 4, "first_fit"), (8, 4, "linf"),
                      (256, 1, "linf")]
LEGACY_NS = (4096, 65536, 1 << 20)
LEGACY_PLACEMENTS = 256

# Phase 11, consolidation.  The frontier of benchmarks/perf.py::
# consolidate_sweep (the 28 x 250 seed-11 grid, HEADLINE_POLICIES,
# underload:t{thr}:e32) as the JAX package's jnp path computes it: threshold
# -> (total migrations, total usage rounded as that benchmark prints it).
# tests/test_torch_consolidate.py ties both to the reference on the CPU.
REF_CONS = {0.15: (45, 178306710), 0.25: (87, 177407906),
            0.5: (149, 176133829)}
# The full-size scenario: the default cadence (e256) plans once a block.
CONS_SPEC = "underload:t0.25"


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


# kernels whose ptxas report must show no spills (mangled-name parts)
NO_SPILL_KERNELS = ("flash_sm90_kernel", "decode_kernel", "decode_mma_kernel")


def ptxas_by_kernel(report: str) -> dict:
    """{mangled kernel name: {"registers": n, "spill": bytes stored +
    loaded, "smem": static bytes}} from nvcc's ``-Xptxas=-v`` output."""
    import re
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": 0, "spill": 0, "smem": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[name]["smem"] = int(m.group(1))
    return out


def sass_instruction_counts(path: str, opcode: str) -> dict:
    """{mangled kernel name: count of ``opcode`` in its SASS} from
    ``cuobjdump -sass`` of the built library."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                         text=True, timeout=300)
    if res.returncode:
        fail(f"cuobjdump -sass failed: {res.stderr.strip()[:500]}")
    out, name = {}, None
    for line in res.stdout.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            out.setdefault(name, 0)
        elif name and opcode in line:
            out[name] += 1
    return out


def check_fp32_precision():
    """The plain versions' float32 matrix products must run in full float32
    (``main`` sets it): in TF32 the reference would itself be off by more
    than ``RWKV_TOL``."""
    import torch
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        fail("float32 matmul precision is not 'highest' (allow_tf32 "
             f"{torch.backends.cuda.matmul.allow_tf32}, precision "
             f"{torch.get_float32_matmul_precision()!r})")


# the parent tree's kernels (``--parent TREE``), timed beside the port's
PARENT_SOURCES = ("rwkv6_chunked.cu", "fitscore.cu")


def parent_library(tree):
    """``PARENT_SOURCES`` of the tree at ``tree`` (a ``git archive`` of an
    earlier commit) built with the port's flags into a library of their own
    under the build directory (its C symbols are the port's names, so it is
    loaded apart), or None without a tree."""
    import ctypes
    from repro_torch.kernels import _build
    if not tree:
        return None
    csrc = os.path.join(tree, "src", "repro_torch", "kernels", "csrc")
    out = os.path.join(_build.BUILD_DIR, "parent")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    nvcc, objs, procs = _build._nvcc(), [], []
    for src in PARENT_SOURCES:
        objs.append(os.path.join(out, src + ".o"))
        procs.append(subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *_build.SOURCES[src], "-I", csrc,
             "-c", "-o", objs[-1], os.path.join(csrc, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for src, proc in zip(PARENT_SOURCES, procs):
        report = proc.communicate()[0]
        if proc.returncode:
            fail(f"parent {src} did not build:\n{report[-2000:]}")
    path = os.path.join(out, "libparent.so")
    res = subprocess.run([nvcc, "-shared", "-o", path, *objs],
                         capture_output=True, text=True)
    if res.returncode:
        fail(f"parent link failed: {res.stderr[-2000:]}")
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_chunked_launch.argtypes = [p] * 7 + [i] * 8 + [p]
    lib.fitscore_legacy_blocks.argtypes = [i]
    lib.fitscore_legacy_launch.argtypes = [p] * 7 + [i] * 4 + [p]
    say(f"# parent: {', '.join(PARENT_SOURCES)} of {tree} built in "
        f"{time.perf_counter() - t0:.1f} s")
    return lib


def phase_build():
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    t0 = time.perf_counter()
    if os.path.exists(_build.library_path()):   # rebuild: ptxas reports
        os.remove(_build.library_path())
    path, secs, report = _build.build()
    lib = _build.library()
    say(f"# build: {os.path.relpath(path, ROOT)} "
        f"(nvcc {secs:.1f} s, ready in {time.perf_counter() - t0:.1f} s)")
    digests = {}
    for name in (*_build.SOURCES, *_build.HEADERS):
        with open(os.path.join(_build.CSRC, name), "rb") as f:
            digests[name] = hashlib.sha256(f.read()).hexdigest()[:16]
    say(f"# build: sources sha256 {digests}")
    for name, r in ptxas_by_kernel(report).items():
        say(f"#   {name[:72]}: {r['registers']} registers, "
            f"{r['spill']} bytes spilled, {r['smem']} bytes static smem")
        if r["spill"] and any(k in name for k in NO_SPILL_KERNELS):
            fail(f"{name} spills {r['spill']} bytes")
    hgmma = {n: c for n, c in sass_instruction_counts(path, "HGMMA").items()
             if "flash_sm90_kernel" in n}
    say(f"# build: HGMMA instructions in the sm90 flash kernel's SASS: "
        f"{hgmma}; dynamic smem a CTA: flash sm90 "
        f"{lib.flash_attention_sm90_smem_bytes(64)} B (hd 64), "
        f"{lib.flash_attention_sm90_smem_bytes(128)} B (hd 128); decode "
        f"(G 5, hd 128, 8 splits) bf16 "
        f"{lib.decode_attention_smem_bytes(5, 128, 1, 8)} B, fp32 "
        f"{lib.decode_attention_smem_bytes(5, 128, 0, 8)} B; replay warp "
        f"kernel (T 256, 8192 item rows) score at Np 64 "
        f"{lib.fitscore_replay_block_warp_smem_bytes(0, 64, 256, 8192)} B, "
        f"rcp at Np 64 "
        f"{lib.fitscore_replay_block_warp_smem_bytes(3, 64, 256, 8192)} B, "
        f"at Np 256 "
        f"{lib.fitscore_replay_block_warp_smem_bytes(3, 256, 256, 8192)} B")
    if len(hgmma) != 2 or not all(hgmma.values()):
        fail(f"the sm90 flash kernel has no HGMMA instructions: {hgmma}")
    hmma = {n: c for n, c in sass_instruction_counts(path, "HMMA").items()
            if "rwkv6_chunked_kernel" in n}
    say(f"# build: HMMA instructions in the rwkv6 kernel's SASS: {hmma}; "
        f"dynamic smem a CTA: bf16 {lib.rwkv6_chunked_smem_bytes(1)} B, "
        f"fp32 {lib.rwkv6_chunked_smem_bytes(0)} B")
    if len(hmma) != 4 or not all(hmma.values()):
        fail(f"the rwkv6 kernel has no HMMA instructions: {hmma}")
    return card


def phase_kernel_vs_plain(dev):
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.fitscore import SELECT_POLICIES, select_ref
    rng = np.random.default_rng(2026)
    n_cases = max_err = 0
    by_route = collections.Counter()
    for mode in ("random", "ties", "full"):
        for L in (28, 56):
            for Np in (64, 128, 256, 300):
                for d in (2, 4, 5):
                    st = random_state(rng, L, Np, d, mode, dev)
                    for policy in SELECT_POLICIES:
                        for cmask in (None, st[10]):
                            p = select_ref(*st[:10], cmask, policy=policy)
                            # the wrapper's route, then the other route's
                            # kernel where it takes the pool (uncounted)
                            route = ops.select_route(Np)
                            runs = [(route, ops.fitscore_select(
                                *st[:10], cmask, policy=policy))]
                            if route == "warp":
                                launch, out = ops.select_launcher(
                                    *st[:10], cmask, policy=policy,
                                    route="cta")
                                launch()
                                runs.append(("cta", out))
                            for r, k in runs:
                                for a, b in zip(k, p):
                                    err = int((a.long() - b.long()).abs()
                                              .max())
                                    max_err = max(max_err, err)
                                    if err:
                                        fail(f"select kernel ({r} route) "
                                             f"!= plain: {mode} L={L} "
                                             f"Np={Np} d={d} {policy} "
                                             f"cmask={cmask is not None}")
                                by_route[r] += 1
                            n_cases += 1
    torch.cuda.synchronize()
    say(f"# kernel == plain on {n_cases} random cases (slot, found, "
        f"no_free identical): {by_route['warp']} on the warp route, "
        f"{by_route['cta']} on the cta route")

    # timing at the main path's shapes: the first rung of the ladder (64
    # slots) for the clairvoyant (28 lanes) and the lognormal groups (56
    # lanes), and the second rung (128 slots); the line of kernel numbers
    # takes the 56-lane shape
    for L, Np in ((28, 64), (28, 128), (56, 64)):
        timed = time_select(dev, L, Np, 5, "best_fit_l2")
    timed["max_abs_err"] = max_err
    return timed


def time_select(dev, L, Np, d, policy):
    """Device time per raw launch of the select's two kernels (the warp
    route's and the cta route's, on the same inputs) and of
    ``select_ref``, the wrapper's wall time per call, and the card's bound
    for the same work."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.fitscore import select_ref
    st = random_state(np.random.default_rng(7), L, Np, d, "random", dev)
    want = select_ref(*st[:10], policy=policy)
    ms = {}
    for route in ops.SELECT_ROUTES:
        launch, out = ops.select_launcher(*st[:10], policy=policy,
                                          route=route)
        launch()
        if not all(torch.equal(a, b) for a, b in zip(out, want)):
            fail(f"raw select launch ({route}) disagrees with the plain "
                 "version")
        ms[route] = device_ms(launch, 500)
    plain_ms = device_ms(lambda: select_ref(*st[:10], policy=policy), 4)
    wrap_ms = time_ms(lambda: ops.fitscore_select(*st[:10], policy=policy),
                      500)
    plain_wall_ms = time_ms(lambda: select_ref(*st[:10], policy=policy), 50)
    # bytes the function must move for best_fit_l2 over the d real dims:
    # loads, counts, alive, open_seq per slot, size and dmask per lane, the
    # outputs (slot int32, found and no_free bool) (the kernel's padding of
    # d to 8 is not the function's)
    nbytes = L * Np * (d * 4 + 4 + 1 + 4) + L * 2 * d * 4 + L * (4 + 2)
    # fp32 operations per slot: feasibility (sub, add, compare) and the l2
    # residual (sub, sub, mul, fma) on d dims, the sqrt, the argmin compare
    nops = L * Np * (d * 3 + d * 5 + 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    say(f"# select L={L} Np={Np} d={d} {policy}: device time per raw "
        f"launch: warp kernel {ms['warp']:.6f} ms, cta kernel "
        f"{ms['cta']:.6f} ms, plain {plain_ms:.6f} ms; bound "
        f"{bound_ms:.3e} ms by {bound_by} ({nbytes} B at 3.35 TB/s); wall "
        f"time per call: wrapper ({ops.select_route(Np)} route) "
        f"{wrap_ms:.6f} ms, plain {plain_wall_ms:.6f} ms")
    return {"ms": ms[ops.select_route(Np)], "cta_ms": ms["cta"],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "wrapper_ms": wrap_ms}


def synthetic_lanes(rng, L, d, n_max=300):
    """``L`` lanes of random instances in ``d`` dims of n_max/2..n_max items
    each (so the shorter lanes end in PAD events), long-lived enough to keep
    tens of bins open, and the three prediction settings in turn:
    clairvoyant, pdep == arrival, lognormal noise.  Flattened lane arrays
    as ``torchsim._replay_batch`` takes them."""
    import numpy as np
    from repro_torch.core.types import Instance
    from repro_torch.sweep import pack_instances, pad_predictions
    from repro_torch.sweep.runner import _flatten_lanes
    insts, preds = [], []
    for lane in range(L):
        n = int(rng.integers(n_max // 2, n_max + 1))
        arr = np.sort(rng.uniform(0.0, 20000.0, n))
        dur = rng.lognormal(8.5, 1.0, n)
        insts.append(Instance(rng.uniform(0.01, 0.45, (n, d)), arr,
                              arr + dur, f"s{lane}").sorted_by_arrival())
        real = insts[-1].durations
        preds.append([real, np.zeros(n),
                      real * rng.lognormal(0.0, 1.0, n)][lane % 3][None])
    batch = pack_instances(insts)
    return _flatten_lanes(batch.sizes, batch.times, batch.kinds, batch.items,
                          pad_predictions(batch, preds), batch.dmask,
                          batch.arrivals, batch.pdeps, batch.n_items)


def padded_streams(policy, flat, extra, dev):
    """The replay's event streams of ``flat`` for ``policy``, padded with
    ``extra`` PAD events, on ``dev``."""
    import torch
    from repro_torch.core import torchsim
    from repro_torch.kernels.fitscore import PAD_KIND
    ev_i, ev_f, ev_size, dmask, fam, d = torchsim._event_streams(
        policy, *flat, None)
    L = ev_size.shape[0]
    fill_i = torch.zeros((ev_i.shape[0], L, extra), dtype=torch.int32)
    fill_i[0] = PAD_KIND
    ev_i = torch.cat([ev_i, fill_i], dim=2)
    ev_f = torch.cat([ev_f, ev_f.new_zeros(ev_f.shape[:2] + (extra,))], 2)
    ev_size = torch.cat([ev_size, ev_size.new_zeros((L, extra, 8))], 1)
    return [a.to(dev) for a in (ev_i, ev_f, ev_size, dmask)], fam, d


# ------------------------------------------ the warp kernel's hazards

def hazard_lanes(n: int = 48):
    """Three lanes of 1/64-grid instances (fp32-exact; d = 2, 3, 4) whose
    items arrive 100 time units apart and live 100-3000 units, but every
    seventh, which departs one unit after it arrives: its arrival and its
    departure are consecutive events.  Predictions clairvoyant, pdep ==
    arrival and power-of-two noise.  Flattened lane arrays as
    ``torchsim._replay_batch`` takes them."""
    import numpy as np
    from repro_torch.core.types import Instance
    from repro_torch.sweep import pack_instances, pad_predictions
    from repro_torch.sweep.runner import _flatten_lanes
    insts, preds = [], []
    for lane, d in enumerate((2, 3, 4)):
        rng = np.random.default_rng(40 + lane)
        arr = 100.0 * np.arange(n)
        dur = 100.0 * rng.integers(1, 31, n)
        dur[3::7] = 1.0
        insts.append(Instance(rng.integers(1, 24, (n, d)) / 64.0, arr,
                              arr + dur, f"h{lane}").sorted_by_arrival())
        real = insts[-1].durations
        noisy = real * rng.choice([0.25, 0.5, 2.0, 4.0], n)
        preds.append(np.stack([real, np.zeros(n), noisy])[lane][None])
    batch = pack_instances(insts)
    return _flatten_lanes(batch.sizes, batch.times, batch.kinds, batch.items,
                          pad_predictions(batch, preds), batch.dmask,
                          batch.arrivals, batch.pdeps, batch.n_items)


def _conversion_block(policy, flat, streams, kw, T):
    """The first block of ``T`` events in which a lane converts its RCP base
    bin and then sees the departure of an item the conversion turned from
    LOC_B into LOC_C: its start, found by replaying the lanes event by
    event with ``replay_block_ref`` on the CPU."""
    from repro_torch.core import torchsim
    from repro_torch.kernels import fitscore as fk
    ev_i, ev_f, ev_size, dmask = streams
    L, E = ev_i.shape[1:]
    carry = torchsim.packed_init_carry(kw["family"], L, flat[0].shape[1],
                                       kw["n"], "cpu")
    conv = {}          # lane -> (event, the items the conversion turned)
    for e in range(E):
        aux0 = carry["itemi"][..., fk.ITEMI_AUX].clone()
        base0 = carry["si"][:, fk.SI_BASE].clone()
        fk.replay_block_ref(carry, ev_i[:, :, e:e + 1], ev_f[:, :, e:e + 1],
                            ev_size[:, e:e + 1], dmask, **kw)
        aux1 = carry["itemi"][..., fk.ITEMI_AUX]
        for lane in range(L):
            kind, j = int(ev_i[0, lane, e]), int(ev_i[1, lane, e])
            turned = ((aux0[lane] == fk.LOC_B) & (aux1[lane] == fk.LOC_C))
            if kind == fk.ARRIVAL_KIND and base0[lane] >= 0 and \
                    carry["si"][lane, fk.SI_BASE] < 0 and turned.any():
                conv[lane] = (e, set(turned.nonzero()[:, 0].tolist()))
            if kind == fk.DEPARTURE_KIND and lane in conv and \
                    j in conv[lane][1] and e - conv[lane][0] < T - 2:
                return max(0, conv[lane][0] - 2)
    raise AssertionError(f"{policy}: no base conversion followed by a "
                         f"converted item's departure within {T} events")


HAZARDS = ("arrive_depart", "convert_then_depart", "all_pad",
           "last_real_5th", "last_real_5th_migrate")


def hazard_block(name, policy, max_bins: int = 20):
    """One of ``HAZARDS`` for ``policy`` on ``hazard_lanes``, on the CPU:
    (the carry before the block, the block's (ev_i, ev_f, ev_size), dmask,
    the kernel's keyword arguments, migrate).  "arrive_depart": a block of
    16 holding an item's arrival and, next, its departure;
    "convert_then_depart" (RCP/PPE only): a block of 32 holding a base
    conversion and a converted item's departure; "all_pad": 16 PAD events
    from a mid-replay carry; "last_real_5th": a block of 32 whose last real
    event is its 5th; "last_real_5th_migrate": a block of 8 opening with
    three MIGRATE events (``migrate_streams``), PAD from its 6th event."""
    import numpy as np
    from repro_torch.core import torchsim
    from repro_torch.kernels import fitscore as fk
    flat = hazard_lanes()
    streams = list(torchsim._event_streams(policy, *flat, None))
    fam, d = streams[4:]
    streams = streams[:4]
    kw = torchsim.replay_block_kwargs(policy, max_bins, d)
    kinds, items = streams[0][0], streams[0][1]
    migrate = False
    if name == "arrive_depart":
        T = 16
        nxt = (kinds[0, :-1] == fk.ARRIVAL_KIND) & \
            (kinds[0, 1:] == fk.DEPARTURE_KIND) & \
            (items[0, :-1] == items[0, 1:])
        start = [int(p) for p in nxt.nonzero()[:, 0] if p >= 16][0] - 6
    elif name == "convert_then_depart":
        if fam != "rcp":
            raise ValueError(f"{name} needs an RCP-family policy")
        T = 32
        start = _conversion_block(policy, flat, streams, kw, T)
    elif name in ("all_pad", "last_real_5th"):
        T, start = (16, 40) if name == "all_pad" else (32, 40)
        streams[0] = streams[0].clone()
        streams[0][0, :, start + (0 if name == "all_pad" else 5):
                   start + T] = fk.PAD_KIND
    elif name == "last_real_5th_migrate":
        T, start, migrate = 8, 40, True
    else:
        raise ValueError(f"unknown hazard {name!r}")
    L = kinds.shape[0]
    carry = torchsim.packed_init_carry(fam, L, flat[0].shape[1], max_bins,
                                       "cpu")
    ev_i, ev_f, ev_size, dmask = streams
    fk.replay_block_ref(carry, ev_i[:, :, :start], ev_f[:, :, :start],
                        ev_size[:, :start], dmask, **kw)
    if migrate:
        (ev_i, ev_f, ev_size, _), _, _ = migrate_streams(
            policy, flat, start, T, carry, np.random.default_rng(3), "cpu")
        ev_i[0, :, start + 5:] = fk.PAD_KIND
    blk = slice(start, start + T)
    return carry, (ev_i[:, :, blk], ev_f[:, :, blk], ev_size[:, blk]), \
        dmask, kw, migrate


def other_route(Np: int):
    """The megakernel route ``ops.replay_route`` does not pick for a pool of
    ``Np`` slots, where its kernel takes such a pool (the global kernel
    takes any; the warp kernel up to ``ops.REPLAY_WARP_MAX_SLOTS``), else
    None."""
    from repro_torch.kernels import ops
    if ops.replay_route(Np) == "warp":
        return "global"
    return "warp" if Np <= ops.REPLAY_WARP_MAX_SLOTS else None


def check_routes(carry, blk, dmask, kw, what, migrate=False, on_fail=fail):
    """One block from ``carry`` (on the card) through the route
    ``ops.replay_route`` picks (the wrapper, which must count one launch
    under that route) and through the other route's kernel where it takes
    the pool (``ops.replay_block_launcher``, not counted), each against
    ``replay_block_ref`` on a copy of the same carry: every carry array
    equal, else ``on_fail(message)``.  ``carry`` ends at the block's end.
    Returns the routes run and the largest |difference| seen (0)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.fitscore import replay_block_ref
    Np = carry["loads"].shape[1]
    route, alt = ops.replay_route(Np), other_route(Np)
    plain = {k: v.clone() for k, v in carry.items()}
    other = {k: v.clone() for k, v in carry.items()}
    counter = f"fitscore_replay_block_{route}"
    n0 = ops.launches[counter]
    ops.fitscore_replay_block(carry, *blk, dmask, migrate=migrate, **kw)
    if ops.launches[counter] != n0 + 1:
        on_fail(f"megakernel: {what}: the wrapper did not count one launch "
                f"on the {route} route")
    if alt:
        ops.replay_block_launcher(other, *blk, dmask, route=alt,
                                  migrate=migrate, **kw)()
    replay_block_ref(plain, *blk, dmask, migrate=migrate, **kw)
    torch.cuda.synchronize()
    runs = [(route, carry)] + ([(alt, other)] if alt else [])
    max_err = 0.0
    for r, got in runs:
        for k in got:
            err = float((got[k].double() - plain[k].double()).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(got[k], plain[k]):
                on_fail(f"megakernel ({r} route) != plain: {what}: {k} "
                        f"differs (max |diff| {err})")
    return [r for r, _ in runs], max_err


def phase_megakernel_vs_plain(dev):
    """Every policy name, T in {1, 64, 256}, with (L, Np, d) cycling
    through {8, 56} x {64, 128, 300} x {2, 4, 5}: one launch against one
    ``replay_block_ref`` block from the same mid-replay carry (replayed by
    the kernel up to the block), on the route ``ops.replay_route`` picks
    and on the other where its kernel takes the pool (``check_routes``);
    T = 64 and 256 straddle the end of the longest lane, so the block ends
    in PAD events.  Then the warp kernel's hazards (``HAZARDS``) for every
    policy, on both routes."""
    import itertools
    import numpy as np
    from repro_torch.core import torchsim
    from repro_torch.kernels import ops
    rng = np.random.default_rng(12)
    combos = list(itertools.product((8, 56), (64, 128, 300), (2, 4, 5)))
    data = {}
    n_cases = max_err = 0
    routes = collections.Counter()
    for pi, policy in enumerate(torchsim.SCAN_POLICIES):
        for ti, T in enumerate((1, 64, 256)):
            L, Np, d = combos[(3 * pi + ti) % len(combos)]
            if (L, d) not in data:
                data[(L, d)] = synthetic_lanes(rng, L, d)
            flat = data[(L, d)]
            E = flat[1].shape[1]
            (ev_i, ev_f, ev_size, dmask), fam, _ = padded_streams(
                policy, flat, T, dev)
            kw = torchsim.replay_block_kwargs(policy, Np, d)
            start = E // 2 if T == 1 else E - T // 2
            carry = torchsim.packed_init_carry(fam, L, flat[0].shape[1], Np,
                                               dev)
            ops.fitscore_replay_block(carry, ev_i[:, :, :start],
                                      ev_f[:, :, :start],
                                      ev_size[:, :start], dmask, **kw)
            blk = slice(start, start + T)
            ran, err = check_routes(
                carry, (ev_i[:, :, blk], ev_f[:, :, blk], ev_size[:, blk]),
                dmask, kw, f"{policy} L={L} Np={Np} d={d} T={T}")
            routes.update(f"{r} (Np {Np})" for r in ran)
            max_err = max(max_err, err)
            n_cases += 1
    n_haz = 0
    for policy in torchsim.SCAN_POLICIES:
        for name in HAZARDS:
            if name == "convert_then_depart" and \
                    torchsim.replay_block_kwargs(policy, 1, 1)["family"] \
                    != "rcp":
                continue
            carry, blk, dmask, kw, mig = hazard_block(name, policy)
            carry = {k: v.to(dev) for k, v in carry.items()}
            ran, err = check_routes(
                carry, [a.to(dev) for a in blk], dmask.to(dev), kw,
                f"hazard {name} {policy}", migrate=mig)
            routes.update(f"{r} (hazards)" for r in ran)
            max_err = max(max_err, err)
            n_haz += 1
    say(f"# megakernel == plain on {n_cases} blocks (21 policies x T in "
        f"{{1, 64, 256}}) and {n_haz} hazard blocks ({', '.join(HAZARDS)});"
        f" every carry array equal; blocks by route: "
        f"{dict(sorted(routes.items()))}")
    return max_err


def block_bytes(before, after, blk, fam, d):
    """The bytes one megakernel launch must move, counted from this block's
    data: each input read once, each output written once, and only the
    columns the family uses.  Reads: the event streams of the block (the
    kind of a PAD event, every plane and the ``d`` real size columns of a
    real one), the dim mask, every slot row (the select considers each),
    and the item, hybrid-key, RCP-category and RCP-base rows the block's
    events name; writes: the rows whose value the block changed (a changed
    row not among the reads is read once too).  Returned as a device
    scalar, with the select's operations: per arrival, an add and a
    compare per real dim and one argmin compare for every slot alive at
    the block's start (the policy's score not counted)."""
    import torch
    from repro_torch.kernels.fitscore import (ARRIVAL_KIND, DEPARTURE_KIND,
                                              KCAT, RAGG_BASE, SLOTI_ALIVE)
    ev_i, ev_f, _ = blk
    L, T = ev_i.shape[1:]
    arr = ev_i[0] == ARRIVAL_KIND
    real = arr | (ev_i[0] == DEPARTURE_KIND)
    n_real = real.sum()
    nbytes = n_real * ((ev_i.shape[0] + ev_f.shape[0] + d) * 4) + \
        (L * T - n_real) * 4 + L * d * 4
    tagged = fam in ("cbd", "hybrid", "rcp")
    row_bytes = {"loads": 4 * d, "slotf": 8, "sloti": 20 if tagged else 16,
                 "itemi": 8 if fam in ("hybrid", "rcp") else 4,
                 "sf": 8 if fam in ("rcp", "adaptive") else 4,
                 "si": 16 if fam == "rcp" else 12, "hagg": 4 * d,
                 "ragg": 4 * d, "ron": 4}
    lane, ev = real.nonzero(as_tuple=True)

    def named(rows, planes):
        need = torch.zeros((L, rows), dtype=torch.bool, device=real.device)
        for p, off in planes:
            need[lane, ev_i[p][lane, ev].long() + off] = True
        return need

    for k, x in before.items():
        y = after[k]
        if x.dim() == 2:                 # sf, si: one row per lane
            changed = (x != y).any(-1, keepdim=True)
            need = torch.ones_like(changed)
        else:
            changed = (x != y).any(-1)
            if k in ("loads", "slotf", "sloti"):
                need = torch.ones_like(changed)
            elif k == "itemi":
                need = named(x.shape[1], [(1, 0)])
            elif k in ("hagg", "ron"):
                need = named(x.shape[1], [(2, 0)])
            else:                        # ragg: gen and cat rows, the base
                need = named(x.shape[1], [(2, 0), (2, KCAT)])
                need[:, RAGG_BASE] = True
        nbytes = nbytes + ((need | changed).sum() + changed.sum()) * \
            row_bytes[k]
    alive = before["sloti"][:, :, SLOTI_ALIVE].sum(1)
    nops = (arr.sum(1) * alive).sum() * (2 * d + 1)
    return nbytes, nops


def time_launches(launchers, spin_cycles: int = 400_000_000) -> float:
    """Device ms per launch of ``launchers`` (functions of no arguments,
    one launch each), run in order while a spin kernel holds the stream so
    the events bracket their work back to back."""
    import torch
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    t0.record()
    for launch in launchers:
        launch()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / len(launchers)


def time_routes(fresh, blocks, dmask, kw, routes, reps: int = 1,
                spin_cycles: int = 400_000_000):
    """Each route's device ms per launch over ``blocks`` (tuples (ev_i,
    ev_f, ev_size)), replayed ``reps`` times, each time from a new carry
    ``fresh()``, through ``ops.replay_block_launcher`` (uncounted); the
    final carries of every route and rep must be equal.  Returns
    {route: ms} and the last final carry."""
    import torch
    from repro_torch.kernels import ops
    times, final = {}, None
    for route in routes:
        # one launch on a throwaway carry loads the module and the kernel
        ops.replay_block_launcher(fresh(), *blocks[0], dmask, route=route,
                                  **kw)()
        runs = [fresh() for _ in range(reps)]
        launchers = [ops.replay_block_launcher(c, *blk, dmask, route=route,
                                               **kw)
                     for c in runs for blk in blocks]
        times[route] = time_launches(launchers, spin_cycles)
        for c in runs:
            final = final or c
            for n in c:
                if not torch.equal(c[n], final[n]):
                    fail(f"megakernel: the {route} route's replay differs "
                         f"from the {routes[0]} route's ({n})")
    return times, final


def time_megakernel(dev, n_items: int = 5000):
    """Device time per launch of the megakernel over a whole scan of the
    main path, on the warp route and on the global kernel (the route before
    it, same blocks, each from a fresh carry; both end in the same carry),
    a spin kernel holding the stream while the launches queue.  Then the
    same scan again through the wrapper, launch by launch, for the checks
    and the bound: the mid-scan block (NB // 2) is replayed by
    ``replay_block_ref`` from the kernel's carry and every carry array must
    be equal, the final carry must equal the timed runs', and each block's
    bytes and operations are counted from its data (``block_bytes``).  The
    line of kernel numbers takes the medians over the 21 policies at the
    lognormal groups' first rung (L=56, Np=64); L=28 at Np 64, 128 and 256
    are timed for one policy a family."""
    import numpy as np
    import torch
    from repro_torch.core import torchsim
    from repro_torch.kernels import ops
    from repro_torch.kernels.fitscore import PAD_KIND, replay_block_ref
    from repro_torch.sweep import PredModel, SuiteSpec, pad_predictions
    from repro_torch.sweep.batching import instances_pdeps
    from repro_torch.sweep.grid import _built_suite
    from repro_torch.sweep.runner import _flatten_lanes
    T = BLOCK_EVENTS
    insts, _, b = _built_suite(SuiteSpec("azure", 28, n_items))
    lanes = {28: _flatten_lanes(
        b.sizes, b.times, b.kinds, b.items, instances_pdeps(b), b.dmask,
        b.arrivals, b.pdeps, b.n_items)}
    logn = pad_predictions(b, [PredModel("lognormal", 1.0).durations(
        i, (0, 1)) for i in insts])
    lanes[56] = _flatten_lanes(b.sizes, b.times, b.kinds, b.items, logn,
                               b.dmask, b.arrivals, b.pdeps, b.n_items)
    E = b.times.shape[1]
    NB = -(-E // T)
    mid = NB // 2
    say(f"# megakernel timing: one scan of {E} events = {NB} launches of "
        f"T={T}, on the warp route and on the global kernel; block {mid} "
        "checked against the plain version")
    one_per_family = ("first_fit", "cbd", "hybrid", "ppe_modified",
                      "la_binary", "adaptive")
    rows = {}
    for L, Np, policies in ((56, 64, torchsim.SCAN_POLICIES),
                            (28, 64, one_per_family),
                            (28, 128, one_per_family),
                            (28, 256, one_per_family)):
        flat = lanes[L]
        for policy in policies:
            (ev_i, ev_f, ev_size, dmask), fam, d = padded_streams(
                policy, flat, NB * T - E, dev)
            kw = torchsim.replay_block_kwargs(policy, Np, d)
            blocks = [(ev_i[:, :, k:k + T], ev_f[:, :, k:k + T],
                       ev_size[:, k:k + T]) for k in range(0, NB * T, T)]

            def fresh():
                return torchsim.packed_init_carry(fam, L, b.n_max, Np, dev)
            times, timed = time_routes(fresh, blocks, dmask, kw,
                                       ("warp", "global"))

            carry, counts = fresh(), []
            for k, blk in enumerate(blocks):
                before = {n: v.clone() for n, v in carry.items()}
                ops.fitscore_replay_block(carry, *blk, dmask, **kw)
                counts.append(block_bytes(before, carry, blk, fam, d))
                if k != mid:
                    continue
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                replay_block_ref(before, *blk, dmask, **kw)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t2) * 1e3
                for n in carry:
                    if not torch.equal(carry[n], before[n]):
                        fail(f"megakernel != plain on main-path block {k}: "
                             f"{policy} L={L} Np={Np}: {n} differs")
            for n in carry:
                if not torch.equal(carry[n], timed[n]):
                    fail(f"megakernel: two replays of one scan differ "
                         f"({policy} L={L} Np={Np}: {n})")
            nbytes, nops = (torch.stack(c).double().cpu().numpy()
                            for c in zip(*counts))
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / F32_OPS_PER_S * 1e3
            bound_ms = float(np.maximum(t_bytes, t_ops).mean())
            bound_by = "bytes" if t_bytes.sum() >= t_ops.sum() else \
                "operations"
            real = float((ev_i[0] != PAD_KIND).view(L, NB, T).sum(2)
                         .max(0).values.double().mean())
            ms, gms = times["warp"], times["global"]
            rows[(L, Np, policy)] = (ms, gms, bound_ms, bound_by, plain_ms,
                                     ms / real * 1e3, gms / real * 1e3)
            say(f"#   megakernel L={L} Np={Np} T={T} {policy:<26} warp "
                f"{ms:.6f} ms/launch (device), global {gms:.6f} "
                f"({gms / ms:.2f}x); bound {bound_ms:.3e} ms by {bound_by} "
                f"({nbytes.mean():.0f} B, {nops.mean():.0f} fp32 ops a "
                f"launch); serial chain {real:.1f} events a launch, warp "
                f"{ms / real * 1e3:.3f} us each, global "
                f"{gms / real * 1e3:.3f}; plain {plain_ms:.1f} ms on block "
                f"{mid} (wall), equal")
    for L, Np in ((56, 64), (28, 64), (28, 128), (28, 256)):
        sel = [r for (l, n, _), r in rows.items() if (l, n) == (L, Np)]
        say(f"# megakernel medians at L={L} Np={Np} over {len(sel)} "
            f"policies: warp {np.median([r[0] for r in sel]):.6f} ms, "
            f"global {np.median([r[1] for r in sel]):.6f} ms a launch; "
            f"warp {np.median([r[5] for r in sel]):.3f} us, global "
            f"{np.median([r[6] for r in sel]):.3f} us a chained event")
    main = [rows[(56, 64, p)] for p in torchsim.SCAN_POLICIES]
    med = {"ms": float(np.median([r[0] for r in main])),
           "global_ms": float(np.median([r[1] for r in main])),
           "bound_ms": float(np.median([r[2] for r in main])),
           "bound_by": main[0][3],
           "plain_ms": float(np.median([r[4] for r in main])),
           "us_per_event": float(np.median([r[5] for r in main])),
           "global_us_per_event": float(np.median([r[6] for r in main]))}
    say(f"# megakernel == plain on block {mid} of {len(rows)} main-path "
        f"scans; medians over 21 policies at L=56 Np=64 T={T}: warp "
        f"{med['ms']:.6f} ms/launch ({med['us_per_event']:.3f} us an "
        f"event), global {med['global_ms']:.6f} ms/launch "
        f"({med['global_us_per_event']:.3f} us), bound "
        f"{med['bound_ms']:.3e} ms, plain {med['plain_ms']:.1f} ms/block")
    return med


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


def phase_category_headline(dev):
    """The category grid per event (the select with the category mask) and
    blocked (the megakernel): each must total REF_USAGE_CAT_28x4."""
    from repro_torch.core import lognormal_predictions_batch
    from repro_torch.data import make_azure_like_suite
    from repro_torch.kernels import ops
    from repro_torch.sweep import pack_instances, pad_predictions, run_batch
    insts = make_azure_like_suite(28, 250, seed=11)
    batch = pack_instances(insts)
    pdeps = pad_predictions(batch, [lognormal_predictions_batch(
        i, 1.0, CAT_HEADLINE_SEEDS) for i in insts])
    for T, kernel in ((0, "fitscore_select"),
                      (BLOCK_EVENTS, "fitscore_replay_block")):
        ops.launches.clear()
        t0 = time.perf_counter()
        total = sum(float(run_batch(batch, p, pdeps, max_bins=64, device=dev,
                                    block_events=T).usage_time.sum())
                    for p in CAT_HEADLINE_POLICIES)
        say(f"# category headline 28x250 seed 11 "
            f"{','.join(CAT_HEADLINE_POLICIES)} x lognormal:1.0 x 6 seeds, "
            f"block_events={T}: total usage {total:.2f} in "
            f"{time.perf_counter() - t0:.1f} s ({ops.launches[kernel]} "
            f"{kernel} launches)")
        # per event: the select's warp route, from CUDA graphs of
        # STEP_WINDOW steps (the scans are longer than two windows)
        want = {kernel, kernel + "_warp", "replay_step_graph",
                "replay_step_capture"} if T == 0 else \
            {kernel, kernel + "_warp"}
        if not ops.launches[kernel] or set(ops.launches) != want:
            fail(f"category headline (block_events={T}) launches "
                 f"{dict(ops.launches)}")
        if f"{total:.0f}" != str(REF_USAGE_CAT_28x4):
            fail(f"category headline (block_events={T}) usage {total:.0f} "
                 f"!= REF_USAGE_CAT_28x4 {REF_USAGE_CAT_28x4}")


def phase_main_path(dev, n_items: int = 5000):
    import numpy as np
    import torch
    from repro_torch.core import torchsim
    from repro_torch.kernels import ops
    from repro_torch.kernels.fitscore import select_ref
    from repro_torch.sweep import (PredModel, SuiteSpec, SweepSpec,
                                   SweepStore, run_batch, run_sweep,
                                   summarize_sweep)
    from repro_torch.sweep.grid import _built_suite, result_key
    suite = SuiteSpec("azure", 28, n_items)
    preds = (PredModel("clairvoyant"), PredModel("lognormal", 1.0))
    spec = SweepSpec(suites=(suite,), policies=PER_EVENT_POLICIES,
                     predictions=preds, seeds=(0, 1))
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
        graphs = {k: ops.launches[k] for k in ("replay_step_graph",
                                               "replay_step_capture")}
        steps = torchsim.counters["scan_steps"]
        replays = sum(len(spec.policies) * (len(spec.seeds) if p.noisy
                                            else 1) for p in preds)
        say(f"# main path: {len(records)} records in {wall:.1f} s, "
            f"{replays * n_events / wall:.0f} events/s "
            f"({replays} replays of {n_events} events), "
            f"{launches} select launches over {steps} scan steps "
            f"({ops.launches['fitscore_select_warp']} on the warp route; "
            f"{graphs['replay_step_graph']} CUDA graph replays of "
            f"{torchsim.STEP_WINDOW} steps from "
            f"{graphs['replay_step_capture']} captures)")
        if launches != steps or steps == 0 or \
                ops.launches["fitscore_select_warp"] != launches or \
                not graphs["replay_step_graph"]:
            fail(f"select launches {launches} != scan steps {steps}, or "
                 f"not all on the warp route, or no graph replays: "
                 f"{dict(ops.launches)}")
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

        # one scan again, graphed (the path) and eagerly (a window longer
        # than half the scan runs the plain loop): equal records, both walls
        walls = {}
        for how, window in (("graphed", torchsim.STEP_WINDOW),
                            ("eager", 1 << 30)):
            old = torchsim.STEP_WINDOW
            torchsim.STEP_WINDOW = window
            ops.launches.clear()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = run_batch(batch, "first_fit", None, spec.max_bins,
                                spec.max_bins_cap, device=dev)
                torch.cuda.synchronize()
                walls[how] = time.perf_counter() - t0
            finally:
                torchsim.STEP_WINDOW = old
            if bool(ops.launches["replay_step_graph"]) != (how == "graphed"):
                fail(f"first_fit x clairvoyant {how}: {dict(ops.launches)}")
            for bi, inst in enumerate(insts):
                r = records[result_key(suite, inst.name, "first_fit",
                                       preds[0], 0)]
                if (r["usage_time"], r["n_bins_opened"]) != \
                        (float(res.usage_time[bi, 0]),
                         int(res.n_bins_opened[bi, 0])):
                    fail(f"first_fit x clairvoyant {how} differs from the "
                         f"sweep's records on {inst.name}")
        say(f"# first_fit x clairvoyant again: graphed "
            f"{walls['graphed']:.3f} s, eager {walls['eager']:.3f} s "
            f"({walls['eager'] / walls['graphed']:.2f}x); both == the "
            f"sweep's records")

        msgs = []
        ops.launches.clear()
        again = run_sweep(spec, store=SweepStore(tmp), device=dev,
                          progress=msgs.append)
        if again != records or ops.launches["fitscore_select"] or \
                not all(m.startswith("skip") for m in msgs):
            fail("a second run over the store recomputed groups")
        say(f"# rerun over the store: all {len(msgs)} groups cached")
    return launches, records, replays * n_events / wall, graphs, walls


def phase_blocked_main_path(dev, per_event_records, per_event_eps,
                            n_items: int = 5000):
    """The main path through the megakernel: all 21 policies, the same
    suite and prediction settings as phase 5, ``block_events=BLOCK_EVENTS``;
    then one category group per event at full size against it."""
    import numpy as np
    import torch
    from repro_torch.core import torchsim
    from repro_torch.kernels import ops
    from repro_torch.sweep import (PredModel, SuiteSpec, SweepSpec,
                                   pad_predictions, run_batch, run_sweep,
                                   summarize_sweep)
    from repro_torch.sweep.grid import _built_suite, result_key
    T = BLOCK_EVENTS
    suite = SuiteSpec("azure", 28, n_items)
    preds = (PredModel("clairvoyant"), PredModel("lognormal", 1.0))
    spec = SweepSpec(suites=(suite,), policies=torchsim.SCAN_POLICIES,
                     predictions=preds, seeds=(0, 1))
    insts, _, batch = _built_suite(suite)
    n_events = 2 * int(batch.n_items.sum())
    NB = -(-batch.times.shape[1] // T)
    # the wall time split per scan: the category set-up and event streams
    # on the CPU (torchsim._event_streams), then the tail padding, the
    # fresh carry and the host-to-device copies, then the launches up to
    # the device's end of the scan (a synchronize after each scan, where
    # the runner reads the results back anyway); the rest is the runner's
    split, mark = collections.Counter(), [0.0]
    streams, chunk = torchsim._event_streams, torchsim.replay_chunk

    def timed_streams(*a, **k):
        t = time.perf_counter()
        out = streams(*a, **k)
        mark[0] = time.perf_counter()
        split["set-up"] += mark[0] - t
        return out

    def timed_chunk(*a, **k):
        t = time.perf_counter()
        split["copy"] += t - mark[0]
        chunk(*a, **k)
        torch.cuda.synchronize()
        split["blocks"] += time.perf_counter() - t

    ops.launches.clear()
    torchsim.counters.clear()
    torch.cuda.synchronize()
    torchsim._event_streams, torchsim.replay_chunk = timed_streams, \
        timed_chunk
    try:
        t0 = time.perf_counter()
        records = run_sweep(spec, device=dev, block_events=T,
                            progress=lambda m: say(f"#   {m}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        torchsim._event_streams, torchsim.replay_chunk = streams, chunk
    launches = ops.launches["fitscore_replay_block"]
    by_route = {r: ops.launches[f"fitscore_replay_block_{r}"]
                for r in ("warp", "global")}
    blocks = torchsim.counters["replay_blocks"]
    replays = len(spec.policies) * (1 + len(spec.seeds))
    eps = replays * n_events / wall
    say(f"# blocked main path (block_events={T}): {len(records)} records "
        f"in {wall:.1f} s, {eps:.0f} events/s ({replays} replays of "
        f"{n_events} events; per event, phase 5: {per_event_eps:.0f} "
        f"events/s), {launches} megakernel launches = {blocks // NB} scans "
        f"x {NB} blocks ({by_route['warp']} on the warp route, "
        f"{by_route['global']} on the global), "
        f"{ops.launches['fitscore_select']} select launches")
    scans = blocks // NB
    say(f"# blocked main path split over {scans} scans: category set-up "
        f"and streams (CPU) {split['set-up']:.3f} s, padding, carry and "
        f"host-to-device copy {split['copy']:.3f} s, launches to the "
        f"device's end {split['blocks']:.3f} s, the runner's other host "
        f"work {wall - sum(split.values()):.3f} s")
    if launches != blocks or blocks % NB or not launches or \
            sum(by_route.values()) != launches or \
            ops.launches["fitscore_select"]:
        fail(f"megakernel launches {launches}, blocks {blocks} (a scan is "
             f"{NB}), select launches {ops.launches['fitscore_select']}")
    for (pol, pred), st in summarize_sweep(records).items():
        say(f"#   ratio {pol:<26} {pred:<12} mean {st.mean:.6f}")
    bad = [k for k, r in records.items()
           if r["overflowed"] or not np.isfinite(r["ratio"])
           or r["ratio"] < 1.0 - 1e-5]
    if len(records) != len(insts) * replays or bad:
        fail(f"{len(records)} blocked records, bad: {bad[:3]}")
    differ = [k for k, r in per_event_records.items() if records[k] != r]
    if differ:
        fail(f"blocked records differ from the per-event ones: {differ[:3]}")
    say(f"# blocked == per-event records for the {len(per_event_records)} "
        f"records of {', '.join(PER_EVENT_POLICIES)}")

    # one category group per event at full size: RCP on data that is not
    # fp32-exact, where the threshold's rsqrt table decides
    pdeps = pad_predictions(batch, [preds[1].durations(i, (0,))
                                    for i in insts])
    ops.launches.clear()
    torchsim.counters.clear()
    t0 = time.perf_counter()
    res = run_batch(batch, "ppe_modified", pdeps, spec.max_bins,
                    spec.max_bins_cap, device=dev)
    steps = torchsim.counters["scan_steps"]
    say(f"# ppe_modified x lognormal:1.0 x seed 0 per event: "
        f"{time.perf_counter() - t0:.1f} s, {ops.launches['fitscore_select']}"
        f" select launches over {steps} scan steps")
    if ops.launches["fitscore_select"] != steps or not steps:
        fail("per-event category group: select launches != scan steps")
    for bi, inst in enumerate(insts):
        r = records[result_key(suite, inst.name, "ppe_modified", preds[1],
                               0)]
        if (r["usage_time"], r["n_bins_opened"]) != \
                (float(res.usage_time[bi, 0]),
                 int(res.n_bins_opened[bi, 0])):
            fail(f"ppe_modified per event != blocked on {inst.name}")
    say("# ppe_modified per event == blocked on all 28 instances")
    return launches, by_route, records


def _attention_inputs(gen, dev, dtype, q_shape, kv_shape):
    import torch
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in (q_shape, kv_shape, kv_shape)]


def _allclose_err(got, want, tol, what):
    """max |got - want| in fp32; fails unless |got - want| <= tol + tol *
    |want| everywhere and, for bf16, max |got - want| <= BF16_REL *
    max |want|."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if not bool(torch.isfinite(g).all()) or \
            bool((diff > tol + tol * w.abs()).any()):
        fail(f"{what}: kernel != plain (max |diff| {err}, tolerance {tol})")
    if got.dtype == torch.bfloat16 and diff.numel() and \
            err > BF16_REL * float(w.abs().max()):
        fail(f"{what}: kernel != plain (max |diff| {err} > {BF16_REL} x "
             f"max |plain| {float(w.abs().max())})")
    return err


def attention_bound(kind, shapes, nbytes_el, valid_pairs):
    """The least time of one attention call: bytes (q, k, v rows the call
    needs, read once; out written once) over the memory rate, against the
    operations of its two products (2 * hd multiply-adds per valid (query
    head, key) pair) at the card's peak for the operands' type: bf16 on the
    tensor cores, fp32 outside them, whatever units the kernel uses."""
    B, H, KV, hd, q_rows, kv_rows = shapes
    nbytes = nbytes_el * (2 * q_rows * H * hd + 2 * kv_rows * KV * hd)
    if kind == "decode":
        nbytes += 4 * B                          # kv_len
    nops = 4 * valid_pairs * H * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = BF16_OPS_PER_S if nbytes_el == 2 else F32_OPS_PER_S
    t_ops = nops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernels_per_call(fn, calls: int = 10):
    """Device kernels a call of ``fn`` launches, counted by torch.profiler
    over ``calls`` calls; None where the profiler sees no device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n / calls if n else None


def phase_attention_vs_plain(dev):
    """The attention kernels against their plain versions on the card
    (fp32 and bf16, the JAX kernel tests' shapes, the tensor-core flash
    kernel's tile edges, decode's split edges and the serving path's
    shapes), then their times at the path's shapes in bf16."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import library
    from repro_torch.kernels.attention import (decode_attention_ref,
                                               flash_attention_ref)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    flash_shapes = [(2, 128, 128, 4, 2, 64), (1, 256, 256, 4, 4, 64),
                    (2, 100, 100, 2, 1, 32), (1, 64, 192, 4, 2, 128),
                    (1, 96, 96, 8, 8, 16)] + \
        [(1, s, s, 40, 8, 128) for s in (16, 511, 2048)] + \
        [(b, sq, skv, 10, 2, hd) for hd in (64, 128)
         for b, sq, skv in [(1, s, s) for s in (1, 63, 64, 65, 127, 129)] +
         [(1, 64, 192), (2, 129, 129)]]
    decode_shapes = [(2, 8, 2, 64, 512), (1, 4, 4, 128, 300),
                     (3, 5, 1, 32, 64), (2, 16, 8, 64, 1024)] + \
        [(b, 40, 8, 128, s) for b in (4, 32) for s in (1024, 4096)]
    # (B, H, KV, hd, S) at which kv_len sits on the split edges
    edge_shapes = [(6, 40, 8, 128, 1024), (6, 40, 8, 128, 1000),
                   (6, 10, 2, 64, 700), (6, 16, 2, 256, 333)]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    n_cases = n_sm90 = 0
    for dtype_name, tol in ATTN_TOL.items():
        dtype = getattr(torch, dtype_name)
        for B, Sq, Skv, H, KV, hd in flash_shapes:
            q, k, v = _attention_inputs(gen, dev, dtype, (B, Sq, H, hd),
                                        (B, Skv, KV, hd))
            for causal, window in ((True, 0), (True, 32), (False, 0),
                                   (False, 16)):
                n90 = ops.launches["flash_attention_sm90"]
                got = ops.flash_attention(q, k, v, causal=causal,
                                          window=window)
                sm90 = ops.launches["flash_attention_sm90"] - n90
                if sm90 != (ops.flash_route(dtype, hd) == "sm90"):
                    fail(f"flash {dtype} hd={hd} took the wrong kernel")
                n_sm90 += sm90
                want = flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
                err = _allclose_err(got, want, tol, f"flash {dtype} "
                                    f"{(B, Sq, Skv, H, KV, hd)} causal="
                                    f"{causal} window={window}")
                errs["flash_attention"] = max(errs["flash_attention"], err)
                n_cases += 1
        for B, H, KV, hd, S in decode_shapes + edge_shapes:
            q, k, v = _attention_inputs(gen, dev, dtype, (B, H, hd),
                                        (B, S, KV, hd))
            edge = (B, H, KV, hd, S) in edge_shapes
            if edge:
                n_split, split = ops.decode_splits(B, KV, S, n_sm)
                kv_len = torch.tensor(
                    [split - 1, split, split + 1, 0, S,
                     (n_split - 1) * split + 1], dtype=torch.int32,
                    device=dev)
            else:
                kv_len = torch.randint(1, S + 1, (B,), generator=gen,
                                       device=dev, dtype=torch.int32)
                kv_len[0] = S
                if B >= 3:
                    kv_len[-1] = 0      # the Pallas kernel's zeros
            for b in range(B):          # never read: NaN must not leak
                k[b, int(kv_len[b]):] = float("nan")
                v[b, int(kv_len[b]):] = float("nan")
            got = ops.decode_attention(q, k, v, kv_len)
            if edge and ops.last_decode_grid != (n_split, split):
                fail(f"decode {(B, H, KV, hd, S)}: launched "
                     f"{ops.last_decode_grid}, the edges are at "
                     f"{(n_split, split)}")
            want = decode_attention_ref(q, k, v, kv_len)
            err = _allclose_err(got, want, tol, f"decode {dtype} "
                                f"{(B, H, KV, hd, S)} kv_len "
                                f"{kv_len.tolist()}")
            errs["decode_attention"] = max(errs["decode_attention"], err)
            n_cases += 1
    torch.cuda.synchronize()
    say(f"# attention kernels == plain on {n_cases} cases ({n_sm90} flash "
        f"calls on the tensor-core kernel; fp32 within 2e-5, bf16 within "
        f"2e-2 and {BF16_REL} of max |plain|): max |diff| flash "
        f"{errs['flash_attention']:.3e}, decode "
        f"{errs['decode_attention']:.3e}")

    # times at the serving path's shapes, bf16 as the path runs them, with
    # the CUDA-core flash kernel (the fp32 route, launched raw) beside the
    # tensor-core one; the line of kernel numbers takes the largest prompt
    # (Sq = Skv = 511) and the engine's decode (4 slots x 1024 positions)
    F = torch.nn.functional
    bf = torch.bfloat16
    lib = library()
    rows = {}
    for Sq in (16, 511, 2048):
        q, k, v = _attention_inputs(gen, dev, bf, (1, Sq, 40, 128),
                                    (1, Sq, 8, 128))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        simt_out = torch.empty_like(q)
        simt_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     simt_out.data_ptr(), 1, Sq, Sq, 40, 8, 128, 128 ** -0.5,
                     1, 0, 1, dev.index or 0,
                     torch.cuda.current_stream().cuda_stream)
        ms = device_ms(lambda: ops.flash_attention(q, k, v), 50)
        simt_ms = device_ms(lambda: lib.flash_attention_launch(*simt_args),
                            20)
        plain_ms = device_ms(lambda: flash_attention_ref(q, k, v), 5)
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 50)
        bound_ms, bound_by = attention_bound(
            "flash", (1, 40, 8, 128, Sq, Sq), 2, Sq * (Sq + 1) // 2)
        rows[("flash", Sq)] = dict(ms=ms, plain_ms=plain_ms,
                                   library_ms=lib_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, simt_ms=simt_ms)
        say(f"# flash_attention bf16 B=1 Sq=Skv={Sq} H=40 KV=8 hd=128 "
            f"causal: device time {ms:.6f} ms (tensor cores; the CUDA-core "
            f"kernel {simt_ms:.6f} ms), plain {plain_ms:.6f} ms, sdpa "
            f"{lib_ms:.6f} ms; bound {bound_ms:.6f} ms by {bound_by}; "
            f"{4 * Sq * (Sq + 1) // 2 * 40 * 128 / ms / 1e9:.1f} TFLOP/s")
    for B, S in ((4, 1024), (32, 1024), (4, 4096), (32, 4096)):
        q, k, v = _attention_inputs(gen, dev, bf, (B, 40, 128),
                                    (B, S, 8, 128))
        kv_len = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                               dtype=torch.int32)
        kv_len[0] = S
        mask = (torch.arange(S, device=dev)[None, :] <
                kv_len[:, None])[:, None, None, :]
        qt, kt, vt = q[:, :, None], k.transpose(1, 2).contiguous(), \
            v.transpose(1, 2).contiguous()
        ms = device_ms(lambda: ops.decode_attention(q, k, v, kv_len), 200)
        plain_ms = device_ms(lambda: decode_attention_ref(q, k, v, kv_len),
                             10)
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), 200)
        n_valid = int(kv_len.sum())
        bound_ms, bound_by = attention_bound(
            "decode", (B, 40, 8, 128, B, n_valid), 2, n_valid)
        n_split, split = ops.last_decode_grid
        per_call = kernels_per_call(
            lambda: ops.decode_attention(q, k, v, kv_len))
        if n_split < 2:
            fail(f"decode B={B} S={S}: {n_split} split, under 2 B KV CTAs")
        rows[("decode", B, S)] = dict(ms=ms, plain_ms=plain_ms,
                                      library_ms=lib_ms, bound_ms=bound_ms,
                                      bound_by=bound_by, n_split=n_split,
                                      kernels_per_call=per_call)
        say(f"# decode_attention bf16 B={B} S={S} H=40 KV=8 hd=128 "
            f"({n_valid} valid rows): device time {ms:.6f} ms, plain "
            f"{plain_ms:.6f} ms, sdpa {lib_ms:.6f} ms; bound "
            f"{bound_ms:.6f} ms by {bound_by}; {n_split} splits of {split} "
            f"({n_split * B * 8} CTAs), device kernels a call "
            f"{'not measured' if per_call is None else per_call}")
    flash = dict(rows[("flash", 511)], max_abs_err=errs["flash_attention"])
    decode = dict(rows[("decode", 4, 1024)],
                  max_abs_err=errs["decode_attention"])
    return flash, decode


def serving_requests():
    """Phase 8's requests: ``launch.serve --real``'s draw (synth_requests,
    then predictions at sigma 0), the first ``SERVE_REQUESTS``, prompts as
    drawn and decodes capped at ``SERVE_DECODE_CAP``."""
    from repro_torch.serving.fleet import attach_predictions, synth_requests
    from repro_torch.serving.scheduler import Request
    reqs = attach_predictions(synth_requests(SERVE_REQUESTS), 0.0)
    return [Request(r.rid, r.arrival, r.prompt_len,
                    min(r.decode_len, SERVE_DECODE_CAP),
                    r.predicted_decode_len) for r in reqs]


def teacher_forced_logits(cfg, params, prompt, forced, dev):
    """Logits of one request's prefill and of one decode step per forced
    token, through the engine's two forward calls."""
    import torch
    from repro_torch.models.transformer import Runtime, forward, init_cache
    cache = init_cache(cfg, 1, SERVE_MAX_LEN, device=dev)
    toks = torch.tensor([prompt], dtype=torch.int64, device=dev)
    out, _, _ = forward(params, cfg, Runtime(), toks, mode="prefill",
                        cache=cache, cache_pos=0)
    logits = [out[:, -1]]
    for i, tok in enumerate(forced):
        pos = torch.tensor([len(prompt) + i], dtype=torch.int32, device=dev)
        out, _, _ = forward(params, cfg, Runtime(),
                            torch.tensor([[tok]], device=dev), mode="decode",
                            cache=cache, cache_pos=pos)
        logits.append(out[:, 0])
    return torch.cat(logits).float()


def timed_serve_real(cfg, params, reqs):
    """``serve_real(cfg, params, reqs, "greedy")`` on the card, every
    engine prefill and decode step timed on the host clock between
    synchronizations.  The launch counts are set to 0 just before and read
    just after.  Returns (stats, wall seconds, {"prefill": [ms],
    "decode": [ms]}, the launch counts)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_real
    from repro_torch.serving.engine import ReplicaEngine
    times = {"prefill": [], "decode": []}
    prefill, decode = ReplicaEngine._prefill, ReplicaEngine._decode

    def timed(kind, fn):
        def call(self, *a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(self, *a)
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    ReplicaEngine._prefill = timed("prefill", prefill)
    ReplicaEngine._decode = timed("decode", decode)
    try:
        torch.cuda.synchronize()
        ops.launches.clear()
        t0 = time.perf_counter()
        stats = serve_real(cfg, params, reqs, "greedy", slots=SERVE_SLOTS,
                           max_len=SERVE_MAX_LEN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = collections.Counter(ops.launches)
    finally:
        ReplicaEngine._prefill, ReplicaEngine._decode = prefill, decode
    return stats, wall, times, counts


def phase_serving(dev):
    """serve_real at qwen2.5-14b's full width on the card (see the module
    docstring, phase 8).  Returns the two attention kernels' launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.attention import (decode_attention_ref,
                                               flash_attention_ref)
    from repro_torch.models import attention
    from repro_torch.models.params import init_params, param_count
    from repro_torch.models.transformer import Runtime, forward, init_cache
    from repro_torch.serving.engine import ReplicaEngine
    cfg = get_config("qwen2.5-14b")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = param_count(params)
    weight_bytes = n_params * params["embed"].element_size()
    say(f"# serving: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
        f"H={cfg.n_heads} KV={cfg.n_kv_heads} hd={cfg.head_dim} "
        f"vocab={cfg.vocab} {cfg.dtype}: {n_params} parameters ("
        f"{cfg.param_count()} in dense matrices and embeddings; "
        f"{weight_bytes / 1e9:.2f} GB) made on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    reqs = serving_requests()
    stats, wall, times, counts = timed_serve_real(cfg, params, reqs)
    launches = {k: counts[k] for k in ("flash_attention",
                                       "flash_attention_sm90",
                                       "decode_attention")}
    n_pre, n_dec = len(times["prefill"]), len(times["decode"])
    got = (stats.replica_seconds, stats.replicas_opened, stats.peak_replicas)
    new_tokens = sum(r.decode_len for r in reqs)
    prompt_tokens = sum(r.prompt_len for r in reqs)
    pre = np.array(times["prefill"])
    dec = np.array(times["decode"])
    say(f"# serving: {len(reqs)} requests (prompts {prompt_tokens} tokens, "
        f"{new_tokens} new tokens) in {wall:.1f} s, "
        f"{new_tokens / wall:.1f} new tokens/s; {n_pre} prefills, median "
        f"{np.median(pre):.1f} ms ({pre.min():.1f}-{pre.max():.1f}), "
        f"{n_dec} engine decode steps, median {np.median(dec):.2f} ms "
        f"({dec.min():.2f}-{dec.max():.2f}); stats {got}")
    say(f"# serving: decode step bound by weight bytes "
        f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms "
        f"({weight_bytes / 1e9:.2f} GB at 3.35 TB/s); device memory in use "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    say(f"# serving: launches {launches}: flash = {cfg.n_layers} x "
        f"{n_pre} prefills, decode = {cfg.n_layers} x {n_dec} steps")
    if launches["flash_attention"] != cfg.n_layers * n_pre or not n_pre:
        fail(f"flash_attention launches {launches['flash_attention']} != "
             f"{cfg.n_layers} x {n_pre} prefills")
    if launches["flash_attention_sm90"] != launches["flash_attention"]:
        fail(f"{launches['flash_attention_sm90']} of "
             f"{launches['flash_attention']} flash calls went through the "
             "tensor-core kernel")
    if launches["decode_attention"] != cfg.n_layers * n_dec or not n_dec:
        fail(f"decode_attention launches {launches['decode_attention']} != "
             f"{cfg.n_layers} x {n_dec} decode steps")
    if got != REF_SERVE_STATS:
        fail(f"placement stats {got} != REF_SERVE_STATS {REF_SERVE_STATS}")

    # one request teacher-forced twice: every attention call running the
    # kernel and the plain version on the same inputs (the kernel's output
    # goes on), then the plain versions alone bound in the kernels' place
    r = reqs[0]
    prompt = list(np.random.default_rng(r.rid).integers(2, cfg.vocab,
                                                        r.prompt_len))
    forced = list(np.random.default_rng(99).integers(2, cfg.vocab, 8))
    tol = ATTN_TOL["bfloat16"]
    calls = {"flash_attention": [], "decode_attention": []}

    def both(kernel, plain, name):
        def call(*a, **kw):
            got = kernel(*a, **kw)
            calls[name].append(_allclose_err(
                got, plain(*a, **kw), tol, f"{name} call "
                f"{len(calls[name])} of the teacher-forced request"))
            return got
        return call

    runs = {}
    for name, flash, decode_ in (
            ("kernel", both(ops.flash_attention, flash_attention_ref,
                            "flash_attention"),
             both(ops.decode_attention, decode_attention_ref,
                  "decode_attention")),
            ("plain", flash_attention_ref, decode_attention_ref)):
        attention.flash_attention, attention.decode_attention = flash, decode_
        try:
            runs[name] = teacher_forced_logits(cfg, params, prompt, forced,
                                               dev)
        finally:
            attention.flash_attention = ops.flash_attention
            attention.decode_attention = ops.decode_attention
    if len(calls["flash_attention"]) != cfg.n_layers or \
            len(calls["decode_attention"]) != cfg.n_layers * len(forced):
        fail(f"teacher-forced request: {len(calls['flash_attention'])} flash "
             f"and {len(calls['decode_attention'])} decode calls checked")
    say(f"# serving: teacher-forced request {r.rid} (prompt {r.prompt_len}, "
        f"{len(forced)} decode steps): every attention call kernel == plain "
        f"on its own inputs ({len(calls['flash_attention'])} flash, "
        f"{len(calls['decode_attention'])} decode; bf16 within {tol} and "
        f"{BF16_REL} of max |plain|): max |diff| flash "
        f"{max(calls['flash_attention']):.3e}, decode "
        f"{max(calls['decode_attention']):.3e}")
    scale = float(runs["plain"].abs().max())
    rel = float((runs["kernel"] - runs["plain"]).abs().max()) / scale
    say(f"# serving: teacher-forced logits, kernel run vs plain run: max "
        f"|diff| / max |logit| ({scale:.3f}) {rel:.3e} (tolerance "
        f"{SERVE_LOGIT_TOL})")
    if not np.isfinite(rel) or rel > SERVE_LOGIT_TOL:
        fail(f"teacher-forced logits differ: {rel} > {SERVE_LOGIT_TOL}")

    # where an engine step's time goes: a fresh engine, four slots busy
    eng = ReplicaEngine(cfg, params, slots=SERVE_SLOTS,
                        max_len=SERVE_MAX_LEN, eos_id=-1)
    for i in range(SERVE_SLOTS):
        eng.admit(1000 + i, prompt[:128 + 64 * i], SERVE_MAX_LEN)
    profile_run(dev, f"engine decode, {SERVE_SLOTS} slots busy, 8 steps",
                lambda: [eng.step() for _ in range(8)], 8, "step")
    del eng
    sub = init_cache(cfg, 1, SERVE_MAX_LEN, device=dev)
    toks = torch.tensor([prompt], dtype=torch.int64, device=dev)
    profile_run(dev, f"prefill of {len(prompt)} tokens",
                lambda: forward(params, cfg, Runtime(), toks, mode="prefill",
                                cache=sub, cache_pos=0), 1, "prefill")
    del params
    torch.cuda.empty_cache()
    return launches


def _rwkv_inputs(gen, dev, dtype, B, S, H, K, V):
    """The JAX kernel test's distributions: r, v normal, k half as wide,
    log-decay -exp(normal), u 0.1 normal; r, k, v in ``dtype``, logw and u
    fp32 (as the model hands them over)."""
    import torch
    r = torch.randn((B, S, H, K), generator=gen, device=dev)
    k = 0.5 * torch.randn((B, S, H, K), generator=gen, device=dev)
    v = torch.randn((B, S, H, V), generator=gen, device=dev)
    lw = -torch.exp(torch.randn((B, S, H, K), generator=gen, device=dev))
    u = 0.1 * torch.randn((H, K), generator=gen, device=dev)
    return r.to(dtype), k.to(dtype), v.to(dtype), lw, u


def rwkv_bound(B, S, H, K, V, L, nbytes_el):
    """The least time of one ``rwkv6_chunked`` call: bytes (r, k, v in
    their type, logw and u fp32, read once; y and the state written once)
    over the memory rate, against the fp32 operations its S rows need (the
    pair terms of each row with the earlier rows of its chunk, the u-bonus,
    the product with the carried state, the state update) at the fp32 peak:
    the function computes in fp32 whatever its inputs' type."""
    nbytes = nbytes_el * B * S * H * (2 * K + V) + \
        4 * (B * S * H * (K + V) + H * K + B * H * K * V)
    n_chunks = -(-S // L)
    rows = [min(L, S - c * L) for c in range(n_chunks)]
    pairs = sum(m * (m - 1) // 2 for m in rows)
    nops = B * H * (2 * pairs * (K + V) + S * (3 * K + 2 * V) +
                    4 * S * K * V + n_chunks * K * V)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rwkv_err(got, want, what):
    """max |got - want| of y or the state; fails unless |got - want| <=
    RWKV_TOL + RWKV_TOL * |want| everywhere."""
    import torch
    diff = (got - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if not bool(torch.isfinite(got).all()) or \
            bool((diff > RWKV_TOL + RWKV_TOL * want.abs()).any()):
        fail(f"{what}: kernel != plain (max |diff| {err}, tolerance "
             f"{RWKV_TOL})")
    return err


def in_turns(new, old, reps: int):
    """Device times of two versions of one call in turns (old, new, new,
    old, each ``device_ms`` over ``reps`` calls): (new ms, old ms), each
    the mean of its two readings."""
    o1, n1, n2, o2 = (device_ms(f, reps) for f in (old, new, new, old))
    return (n1 + n2) / 2, (o1 + o2) / 2


def parent_rwkv(parent, args, L):
    """A call of the parent tree's ``rwkv6_chunked_launch`` on ``args``
    (uncounted), and its outputs."""
    import torch
    r, k, v, lw, u = args
    B, S, H, K = r.shape
    V = v.shape[-1]
    y = torch.empty((B, S, H, V), dtype=torch.float32, device=r.device)
    st = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream

    def call():
        err = parent.rwkv6_chunked_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), y.data_ptr(), st.data_ptr(), B, S, H, K, V, L,
            int(r.dtype == torch.bfloat16), r.device.index or 0, stream)
        if err:
            fail(f"the parent rwkv6_chunked launch failed ({err})")
    return call, y, st


def phase_rwkv_vs_plain(dev, parent=None):
    """Phase 9a: the RWKV6 chunked kernel against ``rwkv6_chunked_ref`` on
    the card (``RWKV_SHAPES`` and ``RWKV_CROSS_SHAPES``, fp32 and bf16 r,
    k, v, float32 matmuls at "highest"), the grid and window launched (at
    least 4 CTAs a (b, h) at the path's V 64), then its time at the
    serving path's shapes in bf16 beside its bound, the plain version's
    and, given the parent tree's library, the parent kernel's on the same
    inputs in turns.  No PyTorch call computes chunked RWKV6: no library
    time."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.rwkv6 import rwkv6_chunked_ref
    check_fp32_precision()
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    err = 0.0
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, H, K, V, L in RWKV_SHAPES + RWKV_CROSS_SHAPES:
            args = _rwkv_inputs(gen, dev, dtype, B, S, H, K, V)
            y, st = ops.rwkv6_chunked(*args, chunk=L)
            want_y, want_st = rwkv6_chunked_ref(*args, chunk=L)
            what = f"rwkv6_chunked {dtype} {(B, S, H, K, V)} chunk {L}"
            err = max(err, _rwkv_err(y, want_y, what + " y"),
                      _rwkv_err(st, want_st, what + " state"))
            if ops.last_rwkv_grid[:2] != (B * H, -(-V // 16)):
                fail(f"{what}: grid {ops.last_rwkv_grid}")
            n_cases += 1
    torch.cuda.synchronize()
    say(f"# rwkv6_chunked == plain on {n_cases} cases (y and final state "
        f"within {RWKV_TOL} atol and rtol; {len(RWKV_CROSS_SHAPES)} shapes "
        f"a type across windows and column blocks): max |diff| {err:.3e}")
    rows = {}
    for S in (16, 511, 2048):
        args = _rwkv_inputs(gen, dev, torch.bfloat16, 1, S, 32, 64, 64)
        n_chunks = -(-S // 16)
        y, st = ops.rwkv6_chunked(*args)
        grid = ops.last_rwkv_grid
        if grid[1] < 4:
            fail(f"rwkv6_chunked at V 64 launched {grid[1]} CTAs a (b, h)")
        ms = device_ms(lambda: ops.rwkv6_chunked(*args), 100)
        parent_ms = parent_diff = None
        if parent is not None:
            call, py, pst = parent_rwkv(parent, args, 16)
            ms, parent_ms = in_turns(lambda: ops.rwkv6_chunked(*args), call,
                                     100)
            parent_diff = max(float((py - y).abs().max()),
                              float((pst - st).abs().max()))
        plain_ms = device_ms(lambda: rwkv6_chunked_ref(*args),
                             max(1, 400 // (3 * n_chunks + 20)))
        bound_ms, bound_by = rwkv_bound(1, S, 32, 64, 64, 16, 2)
        rows[S] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=None,
                       parent_ms=parent_ms)
        vs_parent = "parent kernel: no tree given" if parent is None else \
            (f"parent kernel {parent_ms:.6f} ms on the same inputs "
             f"({parent_ms / ms:.2f}x; max |new - parent| "
             f"{parent_diff:.3e})")
        say(f"# rwkv6_chunked bf16 B=1 S={S} H=32 K=V=64 chunk 16: grid "
            f"{grid[0]} x {grid[1]} CTAs, {-(-n_chunks // grid[2])} "
            f"window(s) of {grid[2]} chunks; device time {ms:.6f} ms "
            f"({ms * 1e3 / n_chunks:.3f} us a chunk), plain "
            f"{plain_ms:.6f} ms; bound {bound_ms:.6f} ms by {bound_by}; "
            f"{vs_parent}; library call: none")
    return dict(rows[511], max_abs_err=err, grid=list(grid[:2]),
                window=grid[2], ms_by_S={S: r["ms"] for S, r in rows.items()},
                parent_ms_by_S={S: r["parent_ms"] for S, r in rows.items()})


def phase_rwkv_serving(dev):
    """Phase 9b: serve_real at rwkv6-1.6b's full width on the card (see
    the module docstring).  Returns the kernel's launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.rwkv6 import rwkv6_chunked_ref
    from repro_torch.models import linear_scan
    from repro_torch.models.params import init_params, param_count
    from repro_torch.models.transformer import Runtime, forward, init_cache
    from repro_torch.serving.engine import ReplicaEngine
    cfg = get_config("rwkv6-1.6b")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = param_count(params)
    weight_bytes = n_params * params["embed"].element_size()
    say(f"# rwkv serving: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
        f"H={cfg.n_heads} hd={cfg.head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab} chunk {cfg.scan_chunk} {cfg.dtype}: {n_params} "
        f"parameters ({weight_bytes / 1e9:.2f} GB) made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = serving_requests()
    stats, wall, times, counts = timed_serve_real(cfg, params, reqs)
    launches = counts["rwkv6_chunked"]
    attn = counts["flash_attention"] + counts["decode_attention"]
    n_pre, n_dec = len(times["prefill"]), len(times["decode"])
    got = (stats.replica_seconds, stats.replicas_opened, stats.peak_replicas)
    new_tokens = sum(r.decode_len for r in reqs)
    pre, dec = np.array(times["prefill"]), np.array(times["decode"])
    say(f"# rwkv serving: {len(reqs)} requests (prompts "
        f"{sum(r.prompt_len for r in reqs)} tokens, {new_tokens} new "
        f"tokens) in {wall:.1f} s, {new_tokens / wall:.1f} new tokens/s; "
        f"{n_pre} prefills, median {np.median(pre):.2f} ms "
        f"({pre.min():.2f}-{pre.max():.2f}), {n_dec} engine decode steps, "
        f"median {np.median(dec):.2f} ms ({dec.min():.2f}-{dec.max():.2f}); "
        f"stats {got}")
    say(f"# rwkv serving: decode step bound by weight bytes "
        f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms "
        f"({weight_bytes / 1e9:.2f} GB at 3.35 TB/s); device memory in use "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    say(f"# rwkv serving: launches rwkv6_chunked {launches} = "
        f"{cfg.n_layers} x {n_pre} prefills, attention kernels {attn}")
    if launches != cfg.n_layers * len(reqs) or n_pre != len(reqs):
        fail(f"rwkv6_chunked launches {launches} != {cfg.n_layers} x "
             f"{len(reqs)} prefills ({n_pre} prefills timed)")
    if attn:
        fail(f"the attention kernels launched {attn} times on rwkv6")
    if got != REF_SERVE_STATS:
        fail(f"rwkv placement stats {got} != REF_SERVE_STATS "
             f"{REF_SERVE_STATS}")

    # the same requests again, every kernel call also running the plain
    # version on its own inputs (the kernel's output goes on)
    errs = []

    def checked(*a, **kw):
        y, st = ops.rwkv6_chunked(*a, **kw)
        want_y, want_st = rwkv6_chunked_ref(*a, **kw)
        scale = max(float(want_y.abs().max()), float(want_st.abs().max()))
        err = max(float((y - want_y).abs().max()),
                  float((st - want_st).abs().max()))
        if not (err <= RWKV_TOL * scale):
            fail(f"rwkv6_chunked call {len(errs)} of the serving run: max "
                 f"|diff| {err} > {RWKV_TOL} x max |plain| {scale}")
        errs.append(err / scale)
        return y, st

    linear_scan.rwkv6_chunked = checked
    try:
        again = timed_serve_real(cfg, params, reqs)[0]
    finally:
        linear_scan.rwkv6_chunked = ops.rwkv6_chunked
    again = (again.replica_seconds, again.replicas_opened,
             again.peak_replicas)
    if len(errs) != launches or again != got:
        fail(f"checked serving run: {len(errs)} calls checked, stats "
             f"{again}")
    say(f"# rwkv serving: every one of the {len(errs)} rwkv6_chunked calls "
        f"kernel == plain on its own inputs: max |diff| / max |plain| "
        f"{max(errs):.3e} (tolerance {RWKV_TOL}); stats again {again}")

    # one request teacher-forced, with the kernel and with the plain version
    # bound in its place
    r = reqs[0]
    prompt = list(np.random.default_rng(r.rid).integers(2, cfg.vocab,
                                                        r.prompt_len))
    forced = list(np.random.default_rng(99).integers(2, cfg.vocab, 8))
    runs = {}
    for name, fn in (("kernel", ops.rwkv6_chunked),
                     ("plain", rwkv6_chunked_ref)):
        linear_scan.rwkv6_chunked = fn
        try:
            runs[name] = teacher_forced_logits(cfg, params, prompt, forced,
                                               dev)
        finally:
            linear_scan.rwkv6_chunked = ops.rwkv6_chunked
    scale = float(runs["plain"].abs().max())
    gaps = (runs["kernel"] - runs["plain"]).abs().amax(dim=-1) / scale
    rel = float(gaps.max())
    say(f"# rwkv serving: teacher-forced request {r.rid} (prompt "
        f"{r.prompt_len}, {len(forced)} decode steps), kernel run vs plain "
        f"run: max |diff| / max |logit| ({scale:.3f}) {rel:.3e} (tolerance "
        f"{SERVE_LOGIT_TOL}); by position, prefill first: "
        f"{' '.join(f'{g:.2e}' for g in gaps.tolist())}")
    if not np.isfinite(rel) or rel > SERVE_LOGIT_TOL:
        fail(f"rwkv teacher-forced logits differ: {rel} > "
             f"{SERVE_LOGIT_TOL}")

    # a reused slot starts afresh: request B prefilled where request A ran
    # gives the logits of a fresh engine
    prompt_b = list(np.random.default_rng(7).integers(2, cfg.vocab, 300))
    toks = torch.tensor([prompt_b], dtype=torch.int64, device=dev)
    logits = []
    for warm in (True, False):
        eng = ReplicaEngine(cfg, params, slots=SERVE_SLOTS,
                            max_len=SERVE_MAX_LEN, eos_id=-1)
        if warm:
            eng.admit(1, prompt, 8)
            slot = eng.slot_of[1]
            while eng.n_active:
                eng.step()
        logits.append(eng._prefill(toks, slot))
        del eng
    if not torch.equal(logits[0], logits[1]):
        fail(f"rwkv reused slot != fresh slot: max |diff| "
             f"{float((logits[0] - logits[1]).abs().max())}")
    say(f"# rwkv serving: a {len(prompt_b)}-token prompt prefilled into the "
        f"slot request {r.rid} held (prompt {r.prompt_len}, 8 decodes) gives "
        f"the logits of a fresh engine, bit for bit")

    eng = ReplicaEngine(cfg, params, slots=SERVE_SLOTS,
                        max_len=SERVE_MAX_LEN, eos_id=-1)
    for i in range(SERVE_SLOTS):
        eng.admit(1000 + i, prompt[:128 + 64 * i], SERVE_MAX_LEN)
    profile_run(dev, f"rwkv engine decode, {SERVE_SLOTS} slots busy, 8 "
                "steps", lambda: [eng.step() for _ in range(8)], 8, "step")
    del eng
    sub = init_cache(cfg, 1, SERVE_MAX_LEN, device=dev)
    toks = torch.tensor([prompt], dtype=torch.int64, device=dev)
    prof = profile_run(dev, f"rwkv prefill of {len(prompt)} tokens",
                       lambda: forward(params, cfg, Runtime(), toks,
                                       mode="prefill", cache=sub,
                                       cache_pos=0), 1, "prefill")
    if prof:
        rwkv_us = sum(us for name, us in prof["by_name"].items()
                      if "rwkv6_chunked_kernel" in name)
        say(f"# rwkv prefill: rwkv6_chunked {rwkv_us:.2f} us of the "
            f"prefill's {prof['busy_us']:.1f} us of device time "
            f"({100 * rwkv_us / prof['busy_us']:.2f} %; "
            f"{100 * rwkv_us / prof['wall_us']:.2f} % of its wall)")
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 10

def legacy_inputs(rng, N, d, mode, dev):
    """One input set of the legacy scorer: ``mode`` "random" (uniform
    capacities, 70 % alive, a permuted open_seq), "grid" (1/64-grid capacities
    and item from a few levels, so many bins tie on score in every CTA, and
    an open_seq with repeated values, so tied bins also tie on it and the
    row decides, across CTAs) or "none" (nothing fits: -1)."""
    import numpy as np
    import torch
    if mode == "grid":
        rem = rng.integers(8, 12, (N, d)) / 64.0
        item = rng.integers(1, 8, d) / 64.0
        alive = rng.random(N) > 0.1
        oseq = rng.integers(0, max(1, N // 512), N).astype(np.int32)
    elif mode == "none":
        rem = rng.uniform(0.0, 0.4, (N, d))
        item = np.full(d, 0.5)
        alive = np.ones(N, bool)
        oseq = rng.permutation(N).astype(np.int32)
    else:
        rem = rng.random((N, d))
        item = rng.random(d) * 0.5
        alive = rng.random(N) > 0.3
        oseq = rng.permutation(N).astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (rem.astype(np.float32), alive, item.astype(np.float32),
                      oseq)]


def legacy_bound(N, d, with_oseq):
    """Bytes of one legacy scorer call (remaining, alive as bool, item and
    open_seq read once; scores and the chosen row written once) at the
    memory rate, against its fp32 operations (per bin and dim a subtract,
    a compare and the norm's one or two) at the fp32 rate."""
    nbytes = N * (4 * d + 1 + 4 + (4 if with_oseq else 0)) + 4 * d + 4
    nops = N * d * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes", nbytes) if t_bytes >= t_ops else \
        (t_ops, "operations", nbytes)


def legacy_back_to_back(dev, n_streams: int, calls: int = 50) -> list:
    """``calls`` consecutive ``ops.fitscore`` calls (20 CTAs each; random,
    grid-tied and nothing-fits pools, the four norms in turn), on the
    current stream (``n_streams`` 1) or alternating between two new ones,
    then each against ``fitscore_ref``: the calls that differ.  A counter
    left unreset would leave the next launch on its stream without a last
    CTA, and its row unwritten."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.legacy import NORMS, fitscore_ref
    rng = np.random.default_rng(50)
    cases = [legacy_inputs(rng, 5000, 5, mode, dev)
             for mode in ("random", "grid", "none")]
    main = torch.cuda.current_stream(dev)
    streams = [main] if n_streams == 1 else \
        [torch.cuda.Stream(dev) for _ in range(n_streams)]
    for st in streams:
        st.wait_stream(main)
    outs = []
    for i in range(calls):
        with torch.cuda.stream(streams[i % n_streams]):
            outs.append(ops.fitscore(*cases[i % 3], norm=NORMS[i % 4]))
    torch.cuda.synchronize()
    bad = []
    for i, (s, b) in enumerate(outs):
        s_p, b_p = fitscore_ref(*cases[i % 3], norm=NORMS[i % 4])
        if not (torch.equal(s, s_p) and int(b) == int(b_p)):
            bad.append(i)
    return bad


def parent_fitscore(parent, rem, alive, item, oseq):
    """A call of the parent tree's two-launch ``fitscore_legacy_launch``
    (l_inf; uncounted)."""
    import torch
    N, d = rem.shape
    scores = torch.empty(N, dtype=torch.float32, device=rem.device)
    best = torch.empty((), dtype=torch.int32, device=rem.device)
    partial = torch.empty(3 * parent.fitscore_legacy_blocks(N),
                          dtype=torch.int32, device=rem.device)
    stream = torch.cuda.current_stream(rem.device).cuda_stream

    def call():
        err = parent.fitscore_legacy_launch(
            rem.data_ptr(), alive.data_ptr(), item.data_ptr(),
            oseq.data_ptr(), scores.data_ptr(), partial.data_ptr(),
            best.data_ptr(), N, d, 2, rem.device.index or 0, stream)
        if err:
            fail(f"the parent fitscore launch failed ({err})")
    return call


def phase_legacy_fitscore(dev, parent=None):
    """The legacy scorer: kernel == plain bit for bit (scores and chosen
    row) on the JAX kernel test's shapes and on N in LEGACY_NS x d in {2,
    5} x the four norms x random / grid-tied / nothing-feasible pools;
    then 50 calls back to back on one stream and on two (the last CTA's
    counter reset); then its main path, a host Best Fit (l_inf) loop
    placing LEGACY_PLACEMENTS items into a 4096-bin pool through
    ``ops.fitscore``, against the same loop through the plain version; then
    its times beside the bound, an empty kernel's launch and, given the
    parent tree's library, the parent's two-launch kernel in turns."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import library
    from repro_torch.kernels.legacy import NORMS, fitscore_ref
    check_fp32_precision()
    rng = np.random.default_rng(10)
    cases = [(N, d, norm, "random") for N, d, norm in LEGACY_TEST_SHAPES]
    cases += [(N, d, norm, mode) for N in LEGACY_NS for d in (2, 5)
              for norm in NORMS for mode in ("random", "grid", "none")]
    n_cases = 0
    for N, d, norm, mode in cases:
        rem, alive, item, oseq = legacy_inputs(rng, N, d, mode, dev)
        for os_ in (oseq, None):
            s_k, b_k = ops.fitscore(rem, alive, item, os_, norm=norm)
            s_p, b_p = fitscore_ref(rem, alive, item, os_, norm=norm)
            if not (torch.equal(s_k, s_p) and int(b_k) == int(b_p)):
                fail(f"fitscore kernel != plain: N={N} d={d} {norm} {mode} "
                     f"open_seq={os_ is not None}: best {int(b_k)} vs "
                     f"{int(b_p)}")
            if mode == "none" and int(b_k) != -1:
                fail(f"fitscore: a pool where nothing fits gave {int(b_k)}")
            n_cases += 1
    say(f"# fitscore kernel == plain on {n_cases} cases (scores and chosen "
        "row identical, ties across CTAs and -1 included)")
    for n_streams in (1, 2):
        bad = legacy_back_to_back(dev, n_streams)
        if bad:
            fail(f"fitscore back to back on {n_streams} stream(s): calls "
                 f"{bad} != plain")
    say("# fitscore: 50 calls back to back on one stream and 50 alternating "
        "between two streams, each == plain (the counter resets)")

    # the main path: one arrival at a time scored against a 4096-bin pool
    # (benchmarks/perf.py's fitscore row), placed by Best Fit (l_inf)
    N, d = 4096, 5
    rem0 = torch.from_numpy(rng.random((N, d)).astype(np.float32)).to(dev)
    alive = torch.ones(N, dtype=torch.bool, device=dev)
    items = torch.from_numpy(
        (rng.random((LEGACY_PLACEMENTS, d)) * 0.3).astype(np.float32)).to(dev)

    def place(score):
        rem, chosen = rem0.clone(), []
        for k in range(LEGACY_PLACEMENTS):
            _, b = score(rem, alive, items[k], None, norm="linf")
            b = int(b)
            chosen.append(b)
            if b >= 0:
                rem[b] -= items[k]
        return chosen, rem
    ops.launches.clear()
    t0 = time.perf_counter()
    got, rem_k = place(ops.fitscore)
    wall = time.perf_counter() - t0
    launches = ops.launches["fitscore"]
    want, rem_p = place(fitscore_ref)
    if got != want or not torch.equal(rem_k, rem_p):
        fail("fitscore main path: kernel placements != plain placements")
    if launches != LEGACY_PLACEMENTS:
        fail(f"fitscore main path: {launches} launches for "
             f"{LEGACY_PLACEMENTS} arrivals")
    say(f"# fitscore main path: {LEGACY_PLACEMENTS} arrivals into {N} bins "
        f"(Best Fit l_inf) in {wall:.3f} s, {launches} launches, "
        f"{len(set(got)) - (-1 in got)} bins used, == plain")

    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    floor_ms = device_ms(lambda: lib.fitscore_empty_launch(dev.index or 0,
                                                           stream), 200)
    rows = {}
    for N in LEGACY_NS:
        rem, alive_n, item, oseq = legacy_inputs(rng, N, 5, "random", dev)

        def call():
            return ops.fitscore(rem, alive_n, item, oseq, norm="linf")
        ms, parent_ms = device_ms(call, 200), None
        if parent is not None:
            ms, parent_ms = in_turns(call, parent_fitscore(
                parent, rem, alive_n, item, oseq), 200)
        plain_ms = device_ms(lambda: fitscore_ref(rem, alive_n, item, oseq,
                                                  norm="linf"), 20)
        bound_ms, bound_by, nbytes = legacy_bound(N, 5, True)
        rows[N] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, parent_ms=parent_ms)
        vs_parent = "parent kernel: no tree given" if parent is None else \
            f"parent (two launches) {parent_ms:.6f} ms in turns"
        say(f"# fitscore N={N} d=5 linf: device time {ms:.6f} ms, plain "
            f"{plain_ms:.6f} ms; bound {bound_ms:.3e} ms by {bound_by} "
            f"({nbytes} B at 3.35 TB/s), an empty kernel's launch "
            f"{floor_ms:.6f} ms: the floor is "
            f"{'a launch' if floor_ms > bound_ms else 'the bytes'}; "
            f"{vs_parent}; no PyTorch call computes it")
    return launches, dict(rows[4096], max_abs_err=0.0, floor_ms=floor_ms,
                          ms_by_N={N: r["ms"] for N, r in rows.items()},
                          parent_ms_by_N={N: r["parent_ms"]
                                          for N, r in rows.items()})


# ---------------------------------------------------------------- phase 11

def live_items(kinds, items, n_max, upto):
    """(L, n_max) bool: the items of each lane alive after its first
    ``upto`` events."""
    import numpy as np
    from repro_torch.kernels.fitscore import ARRIVAL_KIND, DEPARTURE_KIND
    L, E = kinds.shape
    live = np.zeros((L, n_max), bool)
    lanes = np.arange(L)
    for i in range(min(upto, E)):
        arr, dep = kinds[:, i] == ARRIVAL_KIND, kinds[:, i] == DEPARTURE_KIND
        live[lanes[arr], items[arr, i]] = True
        live[lanes[dep], items[dep, i]] = False
    return live


def with_migrations(flat, every: int = 7, seed: int = 0):
    """``flat`` (``_replay_batch``'s lane arrays, numpy) with one more event
    after every ``every`` events of each lane, at the time of the event
    before it: a MIGRATE of one of the lane's live items, drawn from
    ``seed``, or a PAD event where the lane holds none.  The stream a
    per-event replay with ``migrate=True`` takes, as the consolidating
    driver makes them, but without the planner."""
    import numpy as np
    from repro_torch.kernels import fitscore as fk
    sizes, times, kinds, items = flat[:4]
    rng = np.random.default_rng(seed)
    L, E = kinds.shape
    W = E + E // every
    t2 = np.zeros((L, W), times.dtype)
    k2 = np.full((L, W), fk.PAD_KIND, kinds.dtype)
    i2 = np.zeros((L, W), items.dtype)
    for lane in range(L):
        live, w = [], 0
        for e in range(E):
            k, it = int(kinds[lane, e]), int(items[lane, e])
            t2[lane, w], k2[lane, w], i2[lane, w] = times[lane, e], k, it
            w += 1
            if k == fk.ARRIVAL_KIND:
                live.append(it)
            elif k == fk.DEPARTURE_KIND and it in live:
                live.remove(it)
            if (e + 1) % every == 0:
                t2[lane, w] = times[lane, e]
                if live:
                    k2[lane, w] = fk.MIGRATE_KIND
                    i2[lane, w] = live[int(rng.integers(len(live)))]
                w += 1
    return (sizes, t2, k2, i2) + tuple(flat[4:])


def migrate_streams(policy, flat, start, T, carry, rng, dev):
    """The event streams of ``flat`` under ``policy`` cut at ``start``, with
    a block of ``T`` events that opens with MIGRATE events of live items
    chosen from ``carry`` (the packed carry after the first ``start``
    events): per lane 1 (T = 1), 3 (T = 8) or 8 migrants, first an item
    alone in its bin (the source bin closes), then for RCP/PPE an item of
    the base bin, then others at random; the rest of the block is the
    lane's next events.  Returns the streams over ``start + T`` events on
    ``dev`` and the numbers of closing and base-bin migrants."""
    import numpy as np
    from repro_torch.core import torchsim
    from repro_torch.kernels import fitscore as fk
    sizes, times, kinds, items, pdeps, dmask, arrivals, rdeps, n_items = \
        flat
    L, E = kinds.shape
    live = live_items(kinds, items, sizes.shape[1], start)
    place = carry["itemi"][..., fk.ITEMI_PLACE].cpu().numpy()
    counts = carry["sloti"][..., fk.SLOTI_COUNTS].cpu().numpy()
    base = carry["si"][:, fk.SI_BASE].cpu().numpy()
    m = 1 if T == 1 else (3 if T == 8 else 8)
    W = start + T
    k2 = np.full((L, W), fk.PAD_KIND, np.int32)
    i2 = np.zeros((L, W), np.int64)
    t2 = np.zeros((L, W), np.float64)
    k2[:, :start], i2[:, :start] = kinds[:, :start], items[:, :start]
    t2[:, :start] = times[:, :start]
    n_close = n_base = 0
    for lane in range(L):
        members = np.flatnonzero(live[lane])
        pl = place[lane, members]
        close = [int(j) for j in members[counts[lane, pl] == 1]]
        on_base = [int(j) for j in members[pl == base[lane]]] \
            if base[lane] >= 0 else []
        pick = []
        for pool in ((close, on_base) if lane % 2 == 0 else
                     (on_base, close)):
            if pool and len(pick) < m:
                pick.append(pool[int(rng.integers(len(pool)))])
        rest = [int(j) for j in rng.permutation(members) if j not in pick]
        pick += rest[:m - len(pick)]
        n_close += sum(j in close for j in pick)
        n_base += sum(j in on_base for j in pick)
        real = np.flatnonzero(kinds[lane, :start] != fk.PAD_KIND)
        t_mig = times[lane, real[-1]] if len(real) else 0.0
        n = len(pick)
        k2[lane, start:start + n] = fk.MIGRATE_KIND
        i2[lane, start:start + n] = pick
        t2[lane, start:start + n] = t_mig
        tail = slice(start, min(E, start + T - n))
        w = tail.stop - tail.start
        k2[lane, start + n:start + n + w] = kinds[lane, tail]
        i2[lane, start + n:start + n + w] = items[lane, tail]
        t2[lane, start + n:start + n + w] = times[lane, tail]
    ev_i, ev_f, ev_size, dmask_p, _, _ = torchsim._event_streams(
        policy, sizes, t2, k2, i2, pdeps, dmask, arrivals, rdeps, n_items,
        None)
    return [a.to(dev) for a in (ev_i, ev_f, ev_size, dmask_p)], n_close, \
        n_base


def phase_migrate_vs_plain(dev):
    """(a) The megakernel with its MIGRATE branch against
    ``replay_block_ref(migrate=True)`` on blocks that open with MIGRATE
    events (``migrate_streams``), all 21 policies x T in {1, 8, 256}, from
    a mid-replay carry, on both routes where their kernels take the pool
    (``check_routes``): every carry array equal.  The same block without
    its MIGRATE events through the kernel with and without the branch: equal
    too (the branch costs nothing where nothing migrates)."""
    import itertools
    import numpy as np
    import torch
    from repro_torch.core import torchsim
    from repro_torch.kernels import ops
    from repro_torch.kernels.fitscore import replay_block_ref
    rng = np.random.default_rng(11)
    combos = list(itertools.product((8, 56), (64, 128, 300), (2, 4, 5)))
    data = {}
    n_cases = n_close = n_base = 0
    routes = collections.Counter()
    for pi, policy in enumerate(torchsim.SCAN_POLICIES):
        for ti, T in enumerate((1, 8, 256)):
            L, Np, d = combos[(3 * pi + ti + 1) % len(combos)]
            if (L, d) not in data:
                data[(L, d)] = synthetic_lanes(rng, L, d)
            flat = data[(L, d)]
            E = flat[1].shape[1]
            start = E // 2 if T < 256 else E - T // 2
            (ev_i, ev_f, ev_size, dmask), fam, _ = padded_streams(
                policy, flat, T, dev)
            kw = torchsim.replay_block_kwargs(policy, Np, d)
            carry = torchsim.packed_init_carry(fam, L, flat[0].shape[1], Np,
                                               dev)
            ops.fitscore_replay_block(carry, ev_i[:, :, :start],
                                      ev_f[:, :, :start],
                                      ev_size[:, :start], dmask, **kw)
            blk = slice(start, start + T)
            plain_blk = (ev_i[:, :, blk], ev_f[:, :, blk], ev_size[:, blk])
            a, b = ({k: v.clone() for k, v in carry.items()}
                    for _ in range(2))
            ops.fitscore_replay_block(a, *plain_blk, dmask, **kw)
            ops.fitscore_replay_block(b, *plain_blk, dmask, migrate=True,
                                      **kw)
            for k in a:
                if not torch.equal(a[k], b[k]):
                    fail(f"megakernel with the MIGRATE branch != without on "
                         f"a stream without MIGRATE events: {policy} T={T} "
                         f"{k}")
            (mi, mf, ms, _), nc, nb = migrate_streams(policy, flat, start, T,
                                                      carry, rng, dev)
            n_close += nc
            n_base += nb if fam == "rcp" else 0
            mblk = (mi[:, :, blk], mf[:, :, blk], ms[:, blk])
            ran, _ = check_routes(carry, mblk, dmask, kw,
                                  f"MIGRATE {policy} L={L} Np={Np} d={d} "
                                  f"T={T}", migrate=True)
            routes.update(f"{r} (Np {Np})" for r in ran)
            n_cases += 1
    if not n_close or not n_base:
        fail(f"MIGRATE blocks without a closing ({n_close}) or an RCP "
             f"base-bin ({n_base}) migrant")
    say(f"# MIGRATE megakernel == plain on {n_cases} blocks (21 policies x "
        f"T in {{1, 8, 256}}, {n_close} migrants whose source bin closes, "
        f"{n_base} RCP/PPE migrants off the base bin; blocks by route: "
        f"{dict(sorted(routes.items()))}); without MIGRATE events the "
        "kernel with the branch == without")


def phase_frontier(dev):
    """(b) The consolidation frontier: the 28 x 250 seed-11 grid, the four
    headline policies x underload:t{0.15,0.25,0.5}:e32, per event (the CUDA
    select) and blocked (T = BLOCK_EVENTS): migrations and usage totals
    must equal REF_CONS, and the two paths' records each other."""
    import numpy as np
    from repro_torch.consolidate import ConsolidationSpec
    from repro_torch.data import make_azure_like_suite
    from repro_torch.kernels import ops
    from repro_torch.sweep import pack_instances, run_batch
    batch = pack_instances(make_azure_like_suite(28, 250, seed=11))
    for thr, (ref_migs, ref_usage) in REF_CONS.items():
        spec = ConsolidationSpec.parse(f"underload:t{thr:g}:e32")
        runs = {}
        for T in (0, BLOCK_EVENTS):
            ops.launches.clear()
            t0 = time.perf_counter()
            res = [run_batch(batch, p, max_bins=64, device=dev,
                             block_events=T, consolidate=spec)
                   for p in HEADLINE_POLICIES]
            migs = sum(int(r.migrations.sum()) for r in res)
            usage = sum(float(r.usage_time.sum()) for r in res)
            say(f"# frontier underload:t{thr:g}:e32 block_events={T}: "
                f"{migs} migrations, usage {usage:.2f} in "
                f"{time.perf_counter() - t0:.1f} s ({dict(ops.launches)})")
            if (migs, f"{usage:.0f}") != (ref_migs, str(ref_usage)):
                fail(f"frontier t{thr:g} block_events={T}: ({migs}, "
                     f"{usage:.0f}) != REF_CONS ({ref_migs}, {ref_usage})")
            runs[T] = res
        for p, a, b in zip(HEADLINE_POLICIES, *runs.values()):
            if not (np.array_equal(a.usage_time, b.usage_time) and
                    np.array_equal(a.migrations, b.migrations)):
                fail(f"frontier t{thr:g} {p}: per event != blocked")


def phase_consolidation_main_path(dev, base_records, n_items: int = 5000):
    """(c) Consolidation at full size: the 28 x 5000 suite, clairvoyant,
    ``CONS_SPEC``, all 21 policies blocked (T = BLOCK_EVENTS) through
    ``run_batch(consolidate=)``, its wall time split into replay, planner
    and the carry's copies to the host; the middle MIGRATE chunk of each
    scan replayed again by ``replay_block_ref`` from the kernel's carry must
    give every carry array equal.  Then PER_EVENT_POLICIES per event (the
    CUDA select): records equal the blocked ones.  Usage against phase 6's
    unconsolidated records is reported, not asserted."""
    import numpy as np
    import torch
    from repro_torch.consolidate import ConsolidationSpec, driver
    from repro_torch.core import torchsim
    from repro_torch.kernels import ops
    from repro_torch.kernels.fitscore import replay_block_ref
    from repro_torch.sweep import PredModel, SuiteSpec, run_batch
    from repro_torch.sweep.grid import _built_suite, result_key
    spec = ConsolidationSpec.parse(CONS_SPEC)
    suite = SuiteSpec("azure", 28, n_items)
    insts, _, batch = _built_suite(suite)
    clair = PredModel("clairvoyant")
    policies = torchsim.SCAN_POLICIES
    split, mig_ms, mig_chunks = collections.Counter(), [], []
    mig_route_ms = collections.defaultdict(list)
    replay, plan, view, chunk = (driver._replay_batch, driver.plan_migrations,
                                 driver._pool_view, torchsim.replay_chunk)

    def timed(key, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            if key == "replay":
                torch.cuda.synchronize()
            split[key] += time.perf_counter() - t
            return out
        return run

    def checked_chunk(carry, *a, migrate=False, **k):
        if not migrate:
            return chunk(carry, *a, **k)
        mig_chunks.append(({n: v.clone() for n, v in carry.items()}, a, k))
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        out = chunk(carry, *a, migrate=True, **k)
        t1.record()
        mig_chunks[-1] += ({n: v.clone() for n, v in carry.items()},)
        mig_ms.append((t0, t1, a[2].shape[1] // k["block_events"]))
        return out

    driver._replay_batch, driver.plan_migrations, driver._pool_view = (
        timed("replay", replay), timed("planner", plan),
        timed("copies", view))
    torchsim.replay_chunk = checked_chunk
    results, n_checked = {}, 0
    ops.launches.clear()
    try:
        t_all = time.perf_counter()
        for policy in policies:
            mig_chunks.clear()
            t0 = time.perf_counter()
            res = run_batch(batch, policy, max_bins=64, device=dev,
                            block_events=BLOCK_EVENTS, consolidate=spec)
            results[policy] = res
            # the middle MIGRATE chunk of the scan, again by the plain version
            t_check = time.perf_counter()
            if mig_chunks:
                before, a, k, after = mig_chunks[len(mig_chunks) // 2]
                kw = {n: v for n, v in k.items() if n != "block_events"}
                T = k["block_events"]
                blocks = [(a[0][:, :, o:o + T], a[1][:, :, o:o + T],
                           a[2][:, o:o + T])
                          for o in range(0, a[2].shape[1], T)]
                # the same chunk on each route's kernel, five times each
                Np = before["loads"].shape[1]
                routes = tuple(r for r in ("warp", "global")
                               if r == "global" or
                               Np <= ops.REPLAY_WARP_MAX_SLOTS)
                ms, final = time_routes(
                    lambda: {n: v.clone() for n, v in before.items()},
                    blocks, a[3], dict(kw, migrate=True), routes, reps=5,
                    spin_cycles=50_000_000)
                for r, t in ms.items():
                    mig_route_ms[r].append(t)
                for n in before:
                    if not torch.equal(final[n], after[n]):
                        fail(f"consolidation {policy}: a MIGRATE chunk "
                             f"replayed on the {routes[-1]} route != the "
                             f"path's ({n})")
                for blk in blocks:
                    replay_block_ref(before, *blk, a[3], migrate=True, **kw)
                for n in before:
                    if not torch.equal(before[n], after[n]):
                        fail(f"consolidation {policy}: the kernel's MIGRATE "
                             f"chunk != replay_block_ref ({n})")
                n_checked += 1
            split["check"] += time.perf_counter() - t_check
            base = sum(base_records[result_key(suite, i.name, policy, clair,
                                               0)]["usage_time"]
                       for i in insts)
            say(f"#   consolidation {policy:<26} {CONS_SPEC}: "
                f"{int(res.migrations.sum())} migrations, usage "
                f"{float(res.usage_time.sum()):.2f} = "
                f"{float(res.usage_time.sum()) / base:.6f} of the "
                f"unconsolidated, max_bins {int(res.max_bins.max())}, "
                f"{time.perf_counter() - t0:.1f} s")
        wall = time.perf_counter() - t_all
        blocked_split = dict(split)
        blocked_launches = dict(ops.launches)
        ops.launches.clear()
        t0 = time.perf_counter()
        per_event = {p: run_batch(batch, p, max_bins=64, device=dev,
                                  consolidate=spec)
                     for p in PER_EVENT_POLICIES}
        pe_wall = time.perf_counter() - t0
        pe_launches = dict(ops.launches)
    finally:
        driver._replay_batch, driver.plan_migrations, driver._pool_view = \
            replay, plan, view
        torchsim.replay_chunk = chunk
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) / n for a, b, n in mig_ms]
    n_mig = blocked_launches.get("fitscore_replay_block_migrate", 0)
    n_blk = blocked_launches.get("fitscore_replay_block", 0)
    if not n_mig or not n_blk or "fitscore_select" in blocked_launches:
        fail(f"consolidation blocked launches {blocked_launches}")
    if not pe_launches.get("fitscore_select") or \
            pe_launches.get("fitscore_select_warp") != \
            pe_launches["fitscore_select"] or \
            not set(pe_launches) <= {"fitscore_select", "fitscore_select_warp",
                                     "replay_step_graph",
                                     "replay_step_capture"}:
        fail(f"consolidation per-event launches {pe_launches}")
    if not n_checked:
        fail("no scan had a MIGRATE chunk to check")
    for p, r in per_event.items():
        b = results[p]
        if not (np.array_equal(r.usage_time, b.usage_time) and
                np.array_equal(r.n_bins_opened, b.n_bins_opened) and
                np.array_equal(r.migrations, b.migrations)):
            fail(f"consolidation {p}: per event != blocked")
    rest = wall - sum(blocked_split.values())
    say(f"# consolidation main path ({len(policies)} policies, blocked "
        f"T={BLOCK_EVENTS}, {CONS_SPEC}): {wall:.1f} s = replay "
        f"{blocked_split['replay']:.3f} s (set-up, copies to the card, "
        f"launches to the device's end) + planner "
        f"{blocked_split['planner']:.3f} s + carry copies to the host "
        f"{blocked_split['copies']:.3f} s + the mid-scan checks (plain "
        f"replays, the routes' replays) {blocked_split['check']:.3f} s + "
        f"the rest (host "
        f"aliveness, MIGRATE chunk building, the checks' clones) "
        f"{rest:.3f} s; "
        f"{n_blk} plain and {n_mig} MIGRATE megakernel launches; "
        f"CUDA events around the path's MIGRATE chunk calls "
        f"{float(np.median(times)):.6f} ms a launch (median of "
        f"{len(times)} chunks; the host's launch gaps included); each "
        f"scan's middle MIGRATE chunk again, five times on each route's "
        f"kernel, launches queued behind a spin (device time): "
        + ", ".join(f"{r} median {float(np.median(v)):.6f} ms a launch "
                    f"({len(v)} chunks)" for r, v in mig_route_ms.items())
        + "; per event "
        f"({', '.join(PER_EVENT_POLICIES)}): {pe_launches['fitscore_select']}"
        f" select launches ({pe_launches.get('replay_step_graph', 0)} "
        f"graph replays), {pe_wall:.1f} s, records == blocked; "
        f"{n_checked} mid-scan MIGRATE chunks == replay_block_ref")
    return n_mig, float(np.median(times)), {
        r: float(np.median(v)) for r, v in mig_route_ms.items()}


# ------------------------------------ phases 12-14: oracle, zoo, obs

# Phase 12: 8 fp32-exact instances of ORACLE_ITEMS items in ORACLE_D dims,
# two prediction rows each (16 lanes of 3000 events); the consolidation
# scenario and its policies (one of each kernel family, and ppe).
ORACLE_SEEDS = tuple(range(1, 9))
ORACLE_ITEMS = 1500
ORACLE_D = 5
ORACLE_CONS = "underload:t0.25:e32"
ORACLE_CONS_POLICIES = ("first_fit", "cbd", "hybrid", "rcp", "la_binary",
                        "adaptive", "ppe")
ORACLE_CONS_PER_EVENT = ("first_fit", "ppe")   # 32-event chunks run eagerly
# Phase 13: the request stream, and a clock rate that keeps every
# predicted departure a float32-exact number of 1/64 seconds.
ZOO_REQUESTS = 2000
ZOO_TPS = 64.0


def quantized_instance(seed, n, d):
    """tests/test_replay_block.py's fp32-exact instance: 1/64-grid sizes,
    integer arrivals and durations."""
    import numpy as np
    from repro_torch.core.types import Instance
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 24, (n, d)) / 64.0
    arr = np.sort(rng.integers(0, 50000, n)).astype(float)
    dur = rng.integers(10, 5000, n).astype(float)
    return Instance(sizes, arr, arr + dur, f"q{seed}").sorted_by_arrival()


def oracle_lanes(seeds=ORACLE_SEEDS, n_items=ORACLE_ITEMS, d=ORACLE_D):
    """Phase 12's instances, their predicted durations (clairvoyant and
    power-of-two noise, (2, n) each), the packed batch and its pdeps."""
    import numpy as np
    from repro_torch.sweep import pack_instances, pad_predictions
    insts = [quantized_instance(s, n_items, d) for s in seeds]
    preds = []
    for s, inst in zip(seeds, insts):
        noise = np.random.default_rng(100 + s).choice(
            [0.25, 0.5, 1.0, 2.0, 4.0], inst.n_items)
        preds.append(np.stack([inst.durations, inst.durations * noise]))
    batch = pack_instances(insts)
    return insts, preds, batch, pad_predictions(batch, preds)


def oracle_trace(card, insts, results):
    """The oracle's decision series in ``card``'s layout (a ``ReplayTrace``
    of ``len(insts) * card.S`` lanes): after each event the open-bin count,
    the aggregate load and the running usage, rebuilt from the oracle's
    placements (``results``, lane order); the slot and tag series are
    ``card``'s own, since the oracle numbers bins absolutely and the replay
    reuses slots.  PAD events repeat the lane's last state."""
    import dataclasses
    import numpy as np
    from repro_torch.kernels.fitscore import ARRIVAL_KIND
    L, E = card.slot.shape
    d = card.load.shape[2]
    open_bins = np.zeros((L, E), card.open_bins.dtype)
    load = np.zeros((L, E, d), card.load.dtype)
    usage = np.zeros((L, E), card.usage.dtype)
    for lane in range(L):
        inst, r = insts[lane // card.S], results[lane]
        counts, opened_at = {}, {}
        agg, u = np.zeros(d), 0.0
        for e in range(E):
            kind, item = int(card.kinds[lane, e]), int(card.items[lane, e])
            if kind == ARRIVAL_KIND:
                b = int(r.placements[item])
                if b not in counts:
                    counts[b], opened_at[b] = 0, float(card.times[lane, e])
                counts[b] += 1
                agg[:inst.d] += inst.sizes[item]
            elif e < 2 * inst.n_items:          # a departure
                b = int(r.placements[item])
                counts[b] -= 1
                agg[:inst.d] -= inst.sizes[item]
                if not counts[b]:
                    del counts[b]
                    u += float(card.times[lane, e]) - opened_at.pop(b)
            open_bins[lane, e], load[lane, e], usage[lane, e] = \
                len(counts), agg, u
    return dataclasses.replace(card, open_bins=open_bins, load=load,
                               usage=usage)


def phase_oracle(dev, n_items: int = ORACLE_ITEMS):
    """Phase 12: the card's replay against the port's own float64 oracle.
    All 21 policies through ``run_batch``: per event with ``trace_level=1``
    (the CUDA select, in CUDA graphs of event windows) and blocked
    (``block_events=BLOCK_EVENTS``, the megakernel), usage and opened bins
    equal to ``core.run(inst, torchsim.host_algorithm(policy), ...)`` lane
    by lane, and the traced open-bin, load and usage series equal to the
    oracle's event for event (``diff_traces``; the first divergence is
    printed before the run fails).  Then ``run_batch(consolidate=
    ORACLE_CONS)`` over 4 of the instances, blocked for
    ``ORACLE_CONS_POLICIES`` and per event for ``ORACLE_CONS_PER_EVENT``:
    usage, opened bins and migrations equal to ``run_consolidating``.
    Returns the launches of both parts."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.consolidate import ConsolidationSpec, run_consolidating
    from repro_torch.core import run as oracle_run
    from repro_torch.core import torchsim
    from repro_torch.kernels import ops
    from repro_torch.sweep import pack_instances, pad_predictions, run_batch
    insts, preds, batch, pdeps = oracle_lanes(n_items=n_items)
    S = pdeps.shape[1]
    walls = collections.Counter()
    ops.launches.clear()
    for policy in torchsim.SCAN_POLICIES:
        t0 = time.perf_counter()
        want = [oracle_run(inst, torchsim.host_algorithm(policy),
                           predicted_durations=preds[b][s])
                for b, inst in enumerate(insts) for s in range(S)]
        t1 = time.perf_counter()
        traced = run_batch(batch, policy, pdeps, max_bins=64, device=dev,
                           trace_level=1)
        t2 = time.perf_counter()
        blocked = run_batch(batch, policy, pdeps, max_bins=64, device=dev,
                            block_events=BLOCK_EVENTS)
        t3 = time.perf_counter()
        walls["oracle"] += t1 - t0
        walls["traced"] += t2 - t1
        walls["blocked"] += t3 - t2
        usage = np.array([r.usage_time for r in want]).reshape(-1, S)
        opened = np.array([r.n_bins_opened for r in want]).reshape(-1, S)
        div = obs.diff_traces(traced.trace,
                              oracle_trace(traced.trace, insts, want))
        if div is not None:
            say(f"# oracle {policy}: first divergence of the card's trace "
                f"from the oracle's: {div}")
            fail(f"phase 12 {policy}: the traced replay diverges from the "
                 f"oracle at lane {div.lane}, event {div.event} "
                 f"({div.field})")
        for what, res in (("per event", traced), ("blocked", blocked)):
            bad = np.argwhere((res.usage_time != usage) |
                              (res.n_bins_opened != opened))
            if len(bad):
                b, s = bad[0]
                fail(f"phase 12 {policy} {what}: lane {b * S + s} usage "
                     f"{res.usage_time[b, s]} opened "
                     f"{res.n_bins_opened[b, s]} != the oracle's "
                     f"{usage[b, s]} / {opened[b, s]}")
    launches = dict(ops.launches)
    if not launches.get("fitscore_select") or \
            not launches.get("fitscore_replay_block"):
        fail(f"phase 12 launches {launches}")
    say(f"# phase 12: 21 policies x {batch.B} x {S} lanes of "
        f"{batch.times.shape[1]} events ({n_items} items, d {ORACLE_D}): "
        f"per event (traced) and blocked == core.run in usage and opened "
        f"bins, traced open bins, load and usage == the oracle's at every "
        f"event; wall: oracle {walls['oracle']:.1f} s, card traced "
        f"{walls['traced']:.1f} s, card blocked {walls['blocked']:.1f} s "
        f"({launches})")

    spec = ConsolidationSpec.parse(ORACLE_CONS)
    sub = insts[:4]
    sub_batch = pack_instances(sub)
    sub_pdeps = pad_predictions(sub_batch, preds[:4])
    ops.launches.clear()
    walls = collections.Counter()
    for policy in ORACLE_CONS_POLICIES:
        t0 = time.perf_counter()
        want = [run_consolidating(inst, torchsim.host_algorithm(policy),
                                  spec, predicted_durations=preds[b][s])
                for b, inst in enumerate(sub) for s in range(S)]
        walls["oracle"] += time.perf_counter() - t0
        usage = np.array([r.usage_time for r, _ in want]).reshape(-1, S)
        opened = np.array([r.n_bins_opened for r, _ in want]).reshape(-1, S)
        migs = np.array([st["migrations"] for _, st in want]).reshape(-1, S)
        if not migs.any():
            fail(f"phase 12 consolidation {policy}: the oracle migrates "
                 f"nothing")
        for T in ((0, BLOCK_EVENTS) if policy in ORACLE_CONS_PER_EVENT
                  else (BLOCK_EVENTS,)):
            t0 = time.perf_counter()
            res = run_batch(sub_batch, policy, sub_pdeps, max_bins=64,
                            device=dev, block_events=T, consolidate=spec)
            walls[f"T{T}"] += time.perf_counter() - t0
            if not (np.array_equal(res.usage_time, usage) and
                    np.array_equal(res.n_bins_opened, opened) and
                    np.array_equal(res.migrations, migs)):
                fail(f"phase 12 consolidation {policy} block_events={T}: "
                     f"usage {res.usage_time.tolist()} opened "
                     f"{res.n_bins_opened.tolist()} migrations "
                     f"{res.migrations.tolist()} != run_consolidating's "
                     f"{usage.tolist()} / {opened.tolist()} / "
                     f"{migs.tolist()}")
    cons_launches = dict(ops.launches)
    if not cons_launches.get("fitscore_select") or \
            not cons_launches.get("fitscore_replay_block_migrate"):
        fail(f"phase 12 consolidation launches {cons_launches}")
    say(f"# phase 12 consolidation {ORACLE_CONS}, {len(sub)} x {S} lanes: "
        f"blocked ({', '.join(ORACLE_CONS_POLICIES)}) and per event "
        f"({', '.join(ORACLE_CONS_PER_EVENT)}) == run_consolidating in "
        f"usage, opened bins and migrations; wall: oracle "
        f"{walls['oracle']:.1f} s, card per event {walls['T0']:.1f} s, card "
        f"blocked {walls[f'T{BLOCK_EVENTS}']:.1f} s ({cons_launches})")
    return launches, cons_launches


def zoo_requests(n: int = ZOO_REQUESTS, seed: int = 0):
    """``launch/serve.py``'s workload (``synth_requests``, log-normal
    predictions at sigma 0.5) with arrivals rounded up to whole seconds:
    with ``ZOO_TPS`` tokens a second every size, time and predicted
    departure is exact in float32, so the card's select and the host's
    float64 zoo see the same numbers."""
    import dataclasses
    import math
    from repro_torch.serving.fleet import attach_predictions, synth_requests
    reqs = attach_predictions(synth_requests(n, seed=seed), 0.5, seed=seed)
    return [dataclasses.replace(r, arrival=float(math.ceil(r.arrival)))
            for r in reqs]


def drive_scheduler(sched, reqs, tps: float = ZOO_TPS):
    """Place ``reqs`` in arrival order, finishing each after its decode at
    ``tps`` tokens a second (``serving.fleet.simulate_fleet``'s loop):
    every decision and the final stats."""
    import heapq
    heap, picks = [], []
    for r in reqs:
        while heap and heap[0][0] <= r.arrival:
            ft, rid = heapq.heappop(heap)
            sched.finish(rid, ft)
        picks.append(sched.place(r, r.arrival))
        heapq.heappush(heap, (r.arrival + r.decode_len / tps, r.rid))
    while heap:
        ft, rid = heapq.heappop(heap)
        sched.finish(rid, ft)
    s = sched.stats
    return picks, (s.replica_seconds, s.replicas_opened, s.peak_replicas)


def phase_scheduler_zoo(dev, n: int = ZOO_REQUESTS):
    """Phase 13: ``DVBPScheduler`` over ``zoo_requests``: every registry
    policy on the host (all requests placed, the fleet empty at the end);
    ``select_backend="device"`` on the card for the score policies, CBD and
    CBDT - one CUDA select a request, every decision and the stats equal
    to the host run's.  Returns the device runs' select launches."""
    from repro_torch.core.algorithms import ALL_ALGORITHMS
    from repro_torch.kernels import ops
    from repro_torch.serving.scheduler import (_DEVICE_CATEGORY_POLICIES,
                                               _DEVICE_POLICIES,
                                               DVBPScheduler)
    reqs = zoo_requests(n)
    kwargs = {"cbdt": {"rho": 8.0}}
    host, t0 = {}, time.perf_counter()
    for name in ALL_ALGORITHMS:
        sched = DVBPScheduler(name, policy_kwargs=kwargs.get(name),
                              tokens_per_second=ZOO_TPS)
        host[name] = drive_scheduler(sched, reqs)
        if len(host[name][0]) != n or sched.open_replicas() or \
                not host[name][1][0] > 0:
            fail(f"phase 13 host {name}: {host[name][1]}")
    host_wall = time.perf_counter() - t0
    device = [(p, kw) for p in _DEVICE_POLICIES + _DEVICE_CATEGORY_POLICIES
              for kw in ([{"norm": m} for m in ("l1", "l2", "linf")]
                         if p == "best_fit" else [kwargs.get(p)])]
    ops.launches.clear()
    t0 = time.perf_counter()
    for name, kw in device:
        want = drive_scheduler(DVBPScheduler(
            name, policy_kwargs=kw, tokens_per_second=ZOO_TPS), reqs)
        c0 = ops.launches["fitscore_select"]
        sched = DVBPScheduler(name, policy_kwargs=kw,
                              tokens_per_second=ZOO_TPS,
                              select_backend="device", device=dev)
        got = drive_scheduler(sched, reqs)
        if ops.launches["fitscore_select"] - c0 != n or \
                sched.last_select_backend != "cuda":
            fail(f"phase 13 {name} {kw}: {ops.launches['fitscore_select']}"
                 f" select launches, backend {sched.last_select_backend}")
        if got != want:
            first = next(i for i, (a, b) in enumerate(zip(got[0], want[0]))
                         if a != b) if got[0] != want[0] else None
            fail(f"phase 13 {name} {kw}: the card's select != the host "
                 f"zoo (first different decision: request {first}; stats "
                 f"{got[1]} vs {want[1]})")
    dev_wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    say(f"# phase 13: {n} requests, {len(ALL_ALGORITHMS)} registry "
        f"policies on the host in {host_wall:.1f} s; device select on the "
        f"card for {len(device)} configurations (score policies, cbd, "
        f"cbdt) == the host zoo decision for decision in {dev_wall:.1f} s "
        f"({launches}); replica-seconds " + ", ".join(
            f"{k} {v[1][0]:g}" for k, v in sorted(host.items())))
    return launches


def phase_obs(dev):
    """Phase 14: ``repro_torch.obs`` on the card.  Under
    ``obs.recording()``: a sweep per event and one blocked (``run_sweep``),
    a consolidating ``run_batch`` and a scheduler on the device select; the
    reference's span names must be there.  The recording goes to a JSONL
    run log and a Perfetto file, and ``python -m repro_torch obs``
    summarizes the log; ``torch_profile`` with a log directory writes a
    trace of the profiled ops that must hold every megakernel launch of
    the profiled blocked replay (its lead-in kernels counted apart).  A
    traced card
    replay and a traced
    CPU replay of the same lanes give ``diff_traces(...) is None``; a slot
    flipped in one event is pinpointed at that (lane, event, "slot").
    Then the traced and untraced per-event replays' wall time a step at
    phase 12's shape.  Returns the launches of the recorded run."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.consolidate import ConsolidationSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels.fitscore import ARRIVAL_KIND
    from repro_torch.serving.scheduler import DVBPScheduler
    from repro_torch.sweep import (PredModel, SuiteSpec, SweepSpec,
                                   SweepStore, run_batch, run_sweep)
    out = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    ops.launches.clear()
    obs.reset()
    with obs.recording():
        for T in (0, BLOCK_EVENTS):
            spec = SweepSpec(suites=(SuiteSpec("azure", 4, 400, 31 + T),),
                             policies=("best_fit_l2", "ppe_modified"),
                             predictions=(PredModel("clairvoyant"),),
                             seeds=(0,))
            run_sweep(spec, SweepStore(os.path.join(out, "store")),
                      device=dev, block_events=T)
        _, _, small, small_pdeps = oracle_lanes(seeds=(1, 2), n_items=400)
        run_batch(small, "cbd", small_pdeps, max_bins=64, device=dev,
                  consolidate=ConsolidationSpec.parse(ORACLE_CONS))
        sched = DVBPScheduler("cbd", tokens_per_second=ZOO_TPS,
                              select_backend="device", device=dev)
        drive_scheduler(sched, zoo_requests(50))
        events, counters = obs.events(), obs.counters()
    launches = dict(ops.launches)
    names = {e["name"] for e in events}
    want = {"sweep.run_batch", "sweep.scan", "pack.instances", "suite.build",
            "consolidate.replay", "serving.select", "store.save"}
    if not want <= names:
        fail(f"phase 14: spans {sorted(want - names)} missing; recorded "
             f"{sorted(names)}")
    for c in ("sweep.scan_calls", "consolidate.migrations",
              "serving.select_cuda", "experiment.cache_miss"):
        if not counters.get(c):
            fail(f"phase 14: counter {c} is {counters.get(c)}")
    if not launches.get("fitscore_select") or \
            not launches.get("fitscore_replay_block"):
        fail(f"phase 14 launches {launches}")
    log = obs.export_jsonl(os.path.join(out, "run.obs.jsonl"), events,
                           counters, meta={"check": "chip_smoke phase 14"})
    perfetto = obs.export_perfetto(os.path.join(out, "trace.json"), events,
                                   counters)
    if len(json.load(open(perfetto))["traceEvents"]) != len(events):
        fail("phase 14: the Perfetto file lost spans")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "obs", log],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=300)
    if proc.returncode or not all(n in proc.stdout for n in want):
        fail(f"phase 14: python -m repro_torch obs: {proc.returncode} "
             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")

    from repro_torch.obs.export import LEAD_IN_KERNELS
    mk0 = ops.launches["fitscore_replay_block"]
    with obs.recording(clear=False), \
            obs.torch_profile(os.path.join(out, "profile")) as prof_path:
        run_batch(small, "best_fit_l2", small_pdeps, max_bins=64, device=dev,
                  block_events=BLOCK_EVENTS)
        torch.cuda.synchronize()
    mk_launched = ops.launches["fitscore_replay_block"] - mk0
    trace = json.load(open(prof_path))["traceEvents"]
    cats = collections.Counter(e.get("cat") for e in trace)
    knames = [e["name"] for e in trace if e.get("cat") == "kernel"]
    lead = sum("spin_kernel" in k for k in knames)
    mk_traced = sum("replay_warp_kernel" in k for k in knames)
    if not cats["cpu_op"] or "profiler.torch_trace" not in \
            {e["name"] for e in obs.events()} or not mk_launched or \
            mk_traced != mk_launched:
        fail(f"phase 14: the torch_profile trace {prof_path} holds "
             f"{mk_traced} of the block's {mk_launched} megakernel launches "
             f"({dict(cats)}; {lead} of the {LEAD_IN_KERNELS} lead-in "
             "kernels)")
    kernels = f"{len(knames) - lead} ({mk_traced} of {mk_launched} " \
        f"megakernel launches; {lead} of {LEAD_IN_KERNELS} lead-in kernels)"

    t_card = t_cpu = 0.0
    for policy in ("best_fit_l2", "cbd", "reduced_hybrid", "ppe",
                   "la_binary", "adaptive"):
        t0 = time.perf_counter()
        card = run_batch(small, policy, small_pdeps, max_bins=64,
                         device=dev, trace_level=2).trace
        t1 = time.perf_counter()
        cpu = run_batch(small, policy, small_pdeps, max_bins=64,
                        device="cpu", trace_level=2).trace
        t_card += t1 - t0
        t_cpu += time.perf_counter() - t1
        div = obs.diff_traces(card, cpu)
        if div is not None or not np.array_equal(card.alive, cpu.alive):
            fail(f"phase 14 {policy}: the card's trace != the CPU's: {div}")
    lane = card.L - 1
    ev = int(np.flatnonzero(card.kinds[lane] == ARRIVAL_KIND)[7])
    slot = card.slot.copy()
    slot[lane, ev] += 1
    div = obs.diff_traces(card, dataclasses.replace(card, slot=slot))
    if div is None or (div.lane, div.event, div.field) != (lane, ev, "slot"):
        fail(f"phase 14: a flipped slot at ({lane}, {ev}) gives {div}")

    step_s = collections.defaultdict(list)
    _, _, batch, pdeps = oracle_lanes()
    E = batch.times.shape[1]
    for rep in range(2):
        for level in ((0, 1) if rep == 0 else (1, 0)):
            for policy in ("best_fit_l2", "ppe"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_batch(batch, policy, pdeps, max_bins=64, device=dev,
                          trace_level=level)
                torch.cuda.synchronize()
                step_s[(policy, level)].append(
                    (time.perf_counter() - t0) / E * 1e6)
    say(f"# phase 14: spans {sorted(names)}; run log {len(events)} spans, "
        f"{len(counters)} counters; `python -m repro_torch obs` summarized "
        f"it; torch_profile wrote a trace with {kernels} device kernels; "
        f"traced "
        f"card == traced CPU replays (6 policies, {card.L} lanes x "
        f"{card.E} events: card {t_card:.1f} s, CPU "
        f"{t_cpu:.1f} s); a flipped slot found at (lane {lane}, event "
        f"{ev}, slot); wall a step at {batch.B} x 2 lanes x {E} events, "
        f"untraced / traced (two runs each, in turns): " + "; ".join(
            f"{p} {min(step_s[(p, 0)]):.2f} / {min(step_s[(p, 1)]):.2f} µs"
            for p in ("best_fit_l2", "ppe")))
    return launches, {f"{p}_{'traced' if lv else 'untraced'}_us_a_step":
                      min(v) for (p, lv), v in step_s.items()}


# The ladder's plans on the card (phase 15): each injected at the first
# crossing of ``sweep.scan`` of one blocked run_batch, with the counters
# it must move by exactly this much.
RESILIENCE_PLANS = (
    ("sweep.scan:xla:1:1", {"resilience.degrade_blocked_perevent": 1}),
    ("sweep.scan:xla:1:2", {"resilience.degrade_blocked_perevent": 1,
                            "resilience.degrade_cuda_cpu": 1}),
    ("sweep.scan:oom:1:1", {"resilience.retry": 1}))
# checkpointed_replay on the card: one policy a family plus a hybrid, in
# segments of CKPT_EVERY events (each per-event segment a call of its own:
# a warm-up window, a capture, replays)
CKPT_POLICIES = ("greedy", "cbd", "rcp", "la_binary", "adaptive", "hybrid")
CKPT_EVERY = 256
# the port's sweep CLI killed and resumed on the card (subprocesses)
CHAOS_FAULTS = ("sweep.group:kill:2", "ckpt.segment:kill:3")
CHAOS_ARGS = ("--suites", "azure", "--n-instances", "2", "--n-items", "200",
              "--policies", "greedy,cbd,rcp", "--preds", "clairvoyant",
              "--resume", "--checkpoint-every", "128")
# phase 16: benchmarks/perf.py's perf/stream_replay shapes (items, seed,
# max_bins), at chunk_events STREAM_CHUNK and item_rows STREAM_ROWS
STREAM_CELLS = ((10_000, 21, 128), (100_000, 22, 256))
STREAM_CHUNK, STREAM_ROWS = 2048, 2048
STREAM_BLOCKED = ("first_fit", "cbd", "hybrid", "rcp", "la_binary",
                  "adaptive")
# the per-event stream (first_fit) runs at the 10k cell only: at 100k its
# 98 chunks would each pay a warm-up window and a capture (~20 s)
STREAM_PER_EVENT_ITEMS = 10_000


def resilience_guard(where: str) -> None:
    """No fault plan in this process, and no ``resilience.*`` counter moved:
    no retry or degradation happened unseen on the paths run so far."""
    from repro_torch import obs
    from repro_torch.resilience import faults
    if os.environ.get("REPRO_TORCH_FAULTS") or faults.active() is not None:
        fail(f"{where}: a fault plan is set (REPRO_TORCH_FAULTS="
             f"{os.environ.get('REPRO_TORCH_FAULTS')!r})")
    moved = {k: v for k, v in obs.counters().items()
             if k.startswith("resilience.") and v}
    if moved:
        fail(f"{where}: resilience counters moved on the main paths: "
             f"{moved}")


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _port_env(fault: str = "") -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("REPRO_TORCH_FAULTS", None)
    if fault:
        env["REPRO_TORCH_FAULTS"] = fault
    return env


def _store_results(store: str) -> dict:
    files = [f for f in os.listdir(store)
             if f.startswith("sweep_") and f.endswith(".json")]
    if len(files) != 1:
        fail(f"store {store}: {files}")
    with open(os.path.join(store, files[0])) as f:
        return json.load(f)["results"]


def segment_costs(dev, fn):
    """``fn()`` with the per-event path's warm-up windows and captures
    timed (synchronized around each): (wall s, warm-up s, capture s)."""
    import torch
    from repro_torch.core import torchsim
    spent = collections.Counter()
    body, graph_cls = torchsim.window_body, torchsim._Graph

    def timed_body(*a, **k):
        if dev.type != "cuda" or torch.cuda.is_current_stream_capturing():
            return body(*a, **k)
        _sync(dev)
        t = time.perf_counter()
        body(*a, **k)
        _sync(dev)
        spent["warm"] += time.perf_counter() - t

    class TimedCapture(graph_cls):
        def __init__(self, *a, **k):
            _sync(dev)
            t = time.perf_counter()
            super().__init__(*a, **k)
            _sync(dev)
            spent["capture"] += time.perf_counter() - t

    torchsim.window_body, torchsim._Graph = timed_body, TimedCapture
    try:
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        torchsim.window_body, torchsim._Graph = body, graph_cls
    return out, wall, spent["warm"], spent["capture"]


def phase_resilience(dev, n_items: int = 250, chaos_items: str = "200"):
    """Phase 15: ``repro_torch.resilience`` on the card.  (a) The ladder:
    ``run_batch`` of the 28 x ``n_items`` seed-11 suite blocked
    (best_fit_l2, ``BLOCK_EVENTS``) under each of ``RESILIENCE_PLANS``
    equals the fault-free blocked run bit for bit, each counter moved by
    exactly the plan.  (b) ``checkpointed_replay`` of its lanes in segments
    of ``CKPT_EVERY`` events, per event and blocked, for
    ``CKPT_POLICIES`` (and rcp with MIGRATE events), equals the
    unsegmented card replay (usage, bins, placements, overflow); one
    segmented replay is stopped at its second segment and resumed from its
    snapshot; the per-event segments' share of warm-up windows and
    captures.  (c) ``python -m repro_torch sweep --device cuda --resume``
    killed by each of ``CHAOS_FAULTS`` (in parallel subprocesses) and
    rerun: each store equals a clean card run's.  (d) The scheduler's
    guarded select under injected failure equals the host zoo decision
    for decision.  Returns the launches of the phase and its numbers."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core import torchsim
    from repro_torch.kernels import ops
    from repro_torch.resilience import checkpoint, faults
    from repro_torch.serving.scheduler import DVBPScheduler
    from repro_torch.sweep import (PredModel, SuiteSpec, SweepSpec,
                                   SweepStore, run_batch, run_sweep)
    from repro_torch.sweep.grid import _built_suite
    from repro_torch.sweep.runner import _flatten_lanes
    resilience_guard("phase 15")
    ops.launches.clear()
    out = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    _, _, batch = _built_suite(SuiteSpec("azure", 28, n_items, 11))
    kw = dict(max_bins=64, device=dev, block_events=BLOCK_EVENTS)
    base = run_batch(batch, "best_fit_l2", **kw)
    walls = {}
    for plan, want in RESILIENCE_PLANS:
        before = obs.counters()
        t0 = time.perf_counter()
        with faults.injected(plan):
            res = run_batch(batch, "best_fit_l2", **kw)
        walls[plan] = time.perf_counter() - t0
        moved = {k: v for k, v in obs.counter_deltas(before).items()
                 if k.startswith("resilience.")
                 and not k.startswith("resilience.fault_")}
        if moved != want:
            fail(f"phase 15 {plan}: counters moved {moved}, want {want}")
        for f in ("usage_time", "n_bins_opened", "overflowed"):
            if not np.array_equal(getattr(res, f), getattr(base, f)):
                fail(f"phase 15 {plan}: {f} != the fault-free run's")
    out["ladder_wall_s"] = walls
    say(f"# phase 15 ladder: run_batch 28 x {n_items} blocked "
        f"(T={BLOCK_EVENTS}) under " + "; ".join(
            f"{p} ({', '.join(RESILIENCE_PLANS[i][1])}) {walls[p]:.2f} s"
            for i, (p, _) in enumerate(RESILIENCE_PLANS))
        + " == the fault-free run bit for bit, each counter +1")

    flat = _flatten_lanes(batch.sizes, batch.times, batch.kinds,
                          batch.items, batch.pdeps[:, None], batch.dmask,
                          batch.arrivals, batch.pdeps, batch.n_items)
    cases = [(p, T, False) for p in CKPT_POLICIES
             for T in (0, BLOCK_EVENTS)]
    cases += [("rcp", 0, True), ("rcp", BLOCK_EVENTS, True)]
    mig = with_migrations(flat)
    seg = collections.defaultdict(float)
    for policy, T, migrate in cases:
        arrays = mig if migrate else flat
        whole, t_whole, _, _ = segment_costs(dev, lambda: [
            v.cpu() for v in torchsim._replay_batch(
                *arrays, policy=policy, max_bins=64, device=dev,
                block_events=T, migrate=migrate)])
        ck = checkpoint.ReplayCheckpointer(os.path.join(root, "ckpt"),
                                           every_events=CKPT_EVERY)
        got, t_seg, warm, capt = segment_costs(dev, lambda: [
            v.cpu() for v in checkpoint.checkpointed_replay(
                arrays, policy=policy, max_bins=64, device=dev,
                block_events=T, ckpt=ck, key=f"{policy}-{T}-{migrate}",
                migrate=migrate)])
        for a, b, nm in zip(got, whole, ("usage", "opened", "placements",
                                         "overflow")):
            if not torch.equal(a, b):
                fail(f"phase 15 checkpointed {policy} T={T} "
                     f"migrate={migrate}: {nm} != the unsegmented replay")
        way = "blocked" if T else "per_event"
        seg[f"{way}_whole_s"] += t_whole
        seg[f"{way}_segmented_s"] += t_seg
        seg[f"{way}_warm_s"] += warm
        seg[f"{way}_capture_s"] += capt
    E = flat[1].shape[1]
    nseg = -(-E // CKPT_EVERY)
    ck = checkpoint.ReplayCheckpointer(os.path.join(root, "kill"),
                                       every_events=CKPT_EVERY)
    for T in (0, BLOCK_EVENTS):
        with faults.injected("ckpt.segment:error:2"):
            try:
                checkpoint.checkpointed_replay(flat, policy="rcp",
                                               max_bins=64, device=dev,
                                               block_events=T, ckpt=ck,
                                               key=f"kill{T}")
                fail("phase 15: the injected segment fault did not fire")
            except faults.InjectedFault:
                pass
        c0 = obs.counter_get("resilience.ckpt_resume")
        got = checkpoint.checkpointed_replay(flat, policy="rcp", max_bins=64,
                                             device=dev, block_events=T,
                                             ckpt=ck, key=f"kill{T}")
        want = torchsim._replay_batch(*flat, policy="rcp", max_bins=64,
                                      device=dev, block_events=T)
        if obs.counter_get("resilience.ckpt_resume") != c0 + 1 or \
                not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"phase 15: the resumed segmented replay (T={T}) != the "
                 "unsegmented one")
    share = 100 * (seg["per_event_warm_s"] + seg["per_event_capture_s"]) \
        / seg["per_event_segmented_s"]
    out["segments"] = dict(seg, per_event_warm_capture_share=share,
                           segments_a_replay=nseg)
    say(f"# phase 15 checkpointed_replay: {len(cases)} replays "
        f"({', '.join(CKPT_POLICIES)} per event and blocked, rcp with "
        f"MIGRATE events), {flat[1].shape[0]} lanes x {E} events in "
        f"{nseg} segments of "
        f"{CKPT_EVERY} == the unsegmented card replays (usage, bins, "
        f"placements, overflow); a replay stopped at its 2nd segment "
        f"resumed == (per event and blocked); per event: unsegmented "
        f"{seg['per_event_whole_s']:.2f} s, segmented "
        f"{seg['per_event_segmented_s']:.2f} s, of which warm-up windows "
        f"{seg['per_event_warm_s']:.2f} s and captures "
        f"{seg['per_event_capture_s']:.2f} s ({share:.1f} %); blocked: "
        f"unsegmented {seg['blocked_whole_s']:.2f} s, segmented "
        f"{seg['blocked_segmented_s']:.2f} s")

    # (c) the CLI killed and resumed, two stores in parallel
    spec = SweepSpec(suites=(SuiteSpec("azure", 2, int(chaos_items), 2026),),
                     policies=("greedy", "cbd", "rcp"),
                     predictions=(PredModel("clairvoyant"),))
    clean = os.path.join(root, "clean")
    run_sweep(spec, store=SweepStore(clean), device=dev)
    want = _store_results(clean)
    cmd = [sys.executable, "-m", "repro_torch", "sweep", "--device",
           dev.type] + list(CHAOS_ARGS)
    cmd[cmd.index("--n-items") + 1] = chaos_items
    stores = {f: os.path.join(root, f.replace(":", "_"))
              for f in CHAOS_FAULTS}
    t0 = time.perf_counter()
    for fault, expect in ((True, 137), (False, 0)):
        procs = {f: subprocess.Popen(
            cmd + ["--store", stores[f]], env=_port_env(f if fault else ""),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for f in CHAOS_FAULTS}
        for f, p in procs.items():
            so, se = p.communicate(timeout=600)
            if p.returncode != expect:
                fail(f"phase 15 {f} ({'killed' if fault else 'resumed'} "
                     f"run): rc {p.returncode}, want {expect}: {so[-1500:]}"
                     f" {se[-1500:]}")
    for f, store in stores.items():
        if _store_results(store) != want:
            fail(f"phase 15: the store killed by {f} and resumed != a "
                 "clean card run's")
    out["chaos_wall_s"] = time.perf_counter() - t0
    say(f"# phase 15 chaos: `python -m repro_torch sweep --device "
        f"{dev.type} --resume` killed by {' and by '.join(CHAOS_FAULTS)} "
        f"(rc 137, in parallel) and rerun: both stores == a clean card "
        f"run's ({len(want)} records) in {out['chaos_wall_s']:.1f} s")

    reqs = zoo_requests(300)
    counter = f"resilience.degrade_select_{ops.resolved_select_impl(dev)}" \
        "_host"
    for policy in ("cbd", "nrt_prioritized"):
        want = drive_scheduler(DVBPScheduler(
            policy, tokens_per_second=ZOO_TPS), reqs)
        for plan, n_deg in (("serving.select:xla:5:1", 1),
                            ("serving.select:xla:1:0", len(reqs))):
            c0 = obs.counter_get(counter)
            sched = DVBPScheduler(policy, tokens_per_second=ZOO_TPS,
                                  select_backend="device", device=dev)
            with faults.injected(plan):
                got = drive_scheduler(sched, reqs)
            moved = obs.counter_get(counter) - c0
            if got != want or moved != n_deg:
                fail(f"phase 15 scheduler {policy} {plan}: decisions "
                     f"{'==' if got == want else '!='} the host zoo, "
                     f"{moved} degradations (want {n_deg})")
    say(f"# phase 15 scheduler: cbd and nrt_prioritized on the device "
        f"select under serving.select:xla:5:1 and :1:0 ({len(reqs)} "
        f"requests) == the host zoo decision for decision, {counter} +1 "
        f"/ +{len(reqs)}")
    return dict(ops.launches), out


def _stream_split(dev, fn):
    """``fn()`` (a streamed replay) with its host preparation
    (``torchsim.event_streams``), staging and replays
    (``torchsim.replay_streams``, synchronized) timed; the rest of the
    wall is the chunk builder's (merge, pool scatter) and the driver's."""
    from repro_torch.core import torchsim
    from repro_torch.stream import replay as sr
    spent = collections.Counter()
    streams, replay, stage = torchsim.event_streams, \
        torchsim.replay_streams, sr._Stager.stage

    def timed(name, f, sync=False):
        def g(*a, **k):
            t = time.perf_counter()
            r = f(*a, **k)
            if sync:
                _sync(dev)
            spent[name] += time.perf_counter() - t
            return r
        return g

    torchsim.event_streams = timed("streams", streams)
    torchsim.replay_streams = timed("replay", replay, sync=True)
    sr._Stager.stage = timed("stage", stage)
    try:
        _sync(dev)
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        torchsim.event_streams, torchsim.replay_streams = streams, replay
        sr._Stager.stage = stage
    spent["builder_and_rest"] = wall - sum(spent.values())
    return res, wall, dict(spent)


def phase_stream(dev, cells=STREAM_CELLS, chunk=STREAM_CHUNK,
                 rows=STREAM_ROWS):
    """Phase 16: ``repro_torch.stream`` on the card, the shapes of
    benchmarks/perf.py's perf/stream_replay rows: ``synthetic_source`` of
    each of ``cells`` (items, seed, max_bins) at ``chunk`` events a chunk
    and ``rows`` item rows.  first_fit per event (the 10k cell) and
    ``STREAM_BLOCKED`` blocked at ``BLOCK_EVENTS``, each streamed replay
    equal to the in-memory card replay of the materialized instance
    (usage, bins, slot pool), with fewer item rows than items but for
    hybrid; both runs' walls, the chunk's wall, the accounted
    ``peak_device_bytes`` and ``torch.cuda.max_memory_allocated`` of each;
    a run whose pool starts at 16 rows and grows; prefetch 0 against 1
    (timed in turns, results equal); where a chunk's time goes; and a
    ``StreamCheckpointer`` resume after a subprocess killed at
    ``ckpt.save:kill:2``.  Returns the launches and the numbers."""
    import torch
    from repro_torch import obs
    from repro_torch.core import torchsim
    from repro_torch.kernels import ops
    from repro_torch.resilience.checkpoint import StreamCheckpointer
    from repro_torch.stream import replay_stream, synthetic_source
    cuda = dev.type == "cuda"

    def peak_reset():
        _sync(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
            return torch.cuda.memory_allocated(dev)
        return 0

    def peak_since(base):
        return torch.cuda.max_memory_allocated(dev) - base if cuda else 0

    ops.launches.clear()
    out = {}
    for n, seed, mb in cells:
        src = synthetic_source(n, seed=seed)
        inst = src.inst
        runs = [("first_fit", 0)] if n <= STREAM_PER_EVENT_ITEMS else []
        runs += [(p, BLOCK_EVENTS) for p in STREAM_BLOCKED]
        cell = {}
        for policy, T in runs:
            base = peak_reset()
            t0 = time.perf_counter()
            mem = torchsim.simulate(inst, policy, max_bins=mb, device=dev,
                                    block_events=T)
            _sync(dev)
            t_mem = time.perf_counter() - t0
            mem_peak = peak_since(base)
            base = peak_reset()
            res, t_st, split = _stream_split(dev, lambda: replay_stream(
                src, policy, chunk_events=chunk, item_rows=rows, max_bins=mb,
                device=dev, block_events=T))
            st_peak = peak_since(base)
            if (res.usage, res.opened, res.max_bins, res.overflow) != (
                    mem.usage_time, mem.n_bins_opened, mem.max_bins,
                    mem.overflowed):
                fail(f"phase 16 {n} {policy} T={T}: the stream ({res.usage}"
                     f", {res.opened}, {res.max_bins}) != the in-memory "
                     f"replay ({mem.usage_time}, {mem.n_bins_opened}, "
                     f"{mem.max_bins})")
            if policy != "hybrid" and not res.item_rows < inst.n_items:
                fail(f"phase 16 {n} {policy}: {res.item_rows} item rows "
                     f"for {inst.n_items} items")
            key = f"{policy}_{'blocked' if T else 'per_event'}"
            cell[key] = {"stream_s": t_st, "in_memory_s": t_mem,
                         "chunks": res.n_chunks,
                         "chunk_ms": 1e3 * t_st / res.n_chunks,
                         "item_rows": res.item_rows,
                         "max_bins": res.max_bins,
                         "peak_device_bytes": res.peak_device_bytes,
                         "stream_max_allocated": st_peak,
                         "in_memory_max_allocated": mem_peak,
                         "split_s": split}
            say(f"# phase 16 {n} items (seed {seed}) {policy} "
                f"{'blocked T=%d' % T if T else 'per event'}: stream == "
                f"in memory (usage {res.usage:.2f}, {res.opened} bins, "
                f"max_bins {res.max_bins}); {res.n_chunks} chunks of "
                f"{chunk}, {res.item_rows} item rows for {inst.n_items} "
                f"items; stream {t_st:.2f} s ({1e3 * t_st / res.n_chunks:.1f}"
                f" ms a chunk: " + ", ".join(
                    f"{k} {1e3 * v / res.n_chunks:.1f}"
                    for k, v in split.items()) +
                f" ms), in memory {t_mem:.2f} s; device bytes: accounted "
                f"{res.peak_device_bytes}, max allocated {st_peak} "
                f"(in memory {mem_peak})")
        out[n] = cell

    # a pool that starts small and grows; prefetch 0 against 1, in turns
    n, seed, mb = cells[0]
    src = synthetic_source(n, seed=seed)
    want = out[n]["first_fit_blocked"]
    g0 = obs.counter_get("stream.pool_growths")
    res = replay_stream(src, "first_fit", chunk_events=chunk, item_rows=16,
                        max_bins=mb, device=dev, block_events=BLOCK_EVENTS)
    grew = obs.counter_get("stream.pool_growths") - g0
    if not grew or res.item_rows <= 16 or res.max_bins != want["max_bins"]:
        fail(f"phase 16 pool growth: {grew} growths, {res.item_rows} rows")
    mem = torchsim.simulate(src.inst, "first_fit", max_bins=mb, device=dev,
                            block_events=BLOCK_EVENTS)
    if (res.usage, res.opened) != (mem.usage_time, mem.n_bins_opened):
        fail("phase 16 pool growth: the grown stream != in memory")
    n, seed, mb = cells[-1]
    src = synthetic_source(n, seed=seed)
    walls = collections.defaultdict(list)
    results = {}
    for depth in (0, 1, 1, 0) * 3:
        _sync(dev)
        t0 = time.perf_counter()
        r = replay_stream(src, "first_fit", chunk_events=chunk,
                          item_rows=rows, max_bins=mb, device=dev,
                          block_events=BLOCK_EVENTS, prefetch=depth)
        _sync(dev)
        walls[depth].append(time.perf_counter() - t0)
        results[depth] = (r.usage, r.opened, r.max_bins)
    if results[0] != results[1]:
        fail(f"phase 16 prefetch: {results}")
    out["prefetch_s"] = {d: min(v) for d, v in walls.items()}
    out["prefetch_median_s"] = {d: statistics.median(v)
                                for d, v in walls.items()}
    out["pool_growths"] = grew
    say(f"# phase 16: a pool of 16 rows grew {grew:g} times to "
        f"{res.item_rows}, == in memory; {n} items first_fit blocked, "
        f"prefetch 0 / 1 (six turns each, alternating; best / median): "
        f"{out['prefetch_s'][0]:.3f} / {out['prefetch_s'][1]:.3f} s, "
        f"{out['prefetch_median_s'][0]:.3f} / "
        f"{out['prefetch_median_s'][1]:.3f} s, "
        f"results equal")

    # a StreamCheckpointer resume after a subprocess kill at the 2nd save
    n, seed, mb = cells[0]
    root = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    code = (f"from repro_torch.stream import replay_stream, "
            f"synthetic_source\n"
            f"from repro_torch.resilience.checkpoint import "
            f"StreamCheckpointer\n"
            f"replay_stream(synthetic_source({n}, seed={seed}), 'rcp', "
            f"chunk_events={chunk}, item_rows={rows}, max_bins={mb}, "
            f"device={dev.type!r}, block_events={BLOCK_EVENTS}, "
            f"checkpointer=StreamCheckpointer({root!r}, every_chunks=2))\n")
    p = subprocess.run([sys.executable, "-c", code],
                       env=_port_env("ckpt.save:kill:2"),
                       capture_output=True, text=True, timeout=600)
    if p.returncode != 137 or not os.listdir(root):
        fail(f"phase 16: the killed stream: rc {p.returncode}, "
             f"{os.listdir(root)} {p.stderr[-1500:]}")
    c0 = obs.counter_get("resilience.stream_ckpt_resume")
    res = replay_stream(synthetic_source(n, seed=seed), "rcp",
                        chunk_events=chunk, item_rows=rows, max_bins=mb,
                        device=dev, block_events=BLOCK_EVENTS,
                        checkpointer=StreamCheckpointer(root,
                                                        every_chunks=2))
    want = out[n]["rcp_blocked"]
    if obs.counter_get("resilience.stream_ckpt_resume") != c0 + 1 or \
            res.n_chunks != want["chunks"]:
        fail(f"phase 16: the stream did not resume ({res.n_chunks} chunks)")
    mem = torchsim.simulate(synthetic_source(n, seed=seed).inst, "rcp",
                            max_bins=mb, device=dev,
                            block_events=BLOCK_EVENTS)
    if (res.usage, res.opened) != (mem.usage_time, mem.n_bins_opened):
        fail("phase 16: the resumed stream != in memory")
    say(f"# phase 16: a {n}-item rcp stream killed at its 2nd snapshot "
        f"(rc 137) resumed in this process == in memory "
        f"(usage {res.usage:.2f})")
    return dict(ops.launches), out


# phase 17: benchmarks/perf.py::serve_throughput's shape - one Poisson trace
# at a control-plane rate through the double-buffered block dispatcher at
# batch sizes T, one policy a live kernel family (cbdt shares cbd's)
SERVE_TRAFFIC = dict(n=2000, rate=5e4, seed=0, sigma_pred=0.3)
SERVE_TPS = 1.2e5
SERVE_TS = (1, 32, 256)
SERVE_FAMILIES = (("best_fit_linf", "best_fit", {"norm": "linf"}),
                  ("cbd", "cbd", {"beta": 2.0}), ("rcp", "rcp", None),
                  ("la_binary", "lifetime_alignment", {"mode": "binary"}),
                  ("adaptive", "adaptive", None))
# the regrow stream: one slot a replica, so open replicas = requests in
# flight; at 4e4 tokens a second the peak passes 256, from a 64-slot pool
SERVE_REGROW_TPS = 4e4
# phase 17 (f): ``python -m repro_torch serve`` in both modes, by
# subprocess, on the card by default and again with ``--device cpu``
SERVE_CLI = ("serve", "--requests", "400", "--policies",
             "best_fit_linf,cbd,rcp")
SERVE_CLI_MODES = {
    "planning": ("--sigma", "0.5", "--baselines"),
    "traffic": ("--traffic", "poisson", "--rate", "5e4", "--tps", "1.2e5",
                "--sigma", "0.3")}
# the fault plans of phase 17 (d): (plan, the serve path or the scheduler's
# block select, the resilience counters the plan must move and by how much)
SERVE_FAULTS = (
    ("serving.select:xla:3:1", "dispatch",
     {"resilience.degrade_dispatch_block_events": 1}),
    ("serving.select:xla:5:2", "dispatch",
     {"resilience.degrade_dispatch_block_events": 1,
      "resilience.degrade_dispatch_events_cpu": 1}),
    ("kernel.dispatch_block:xla:7:1", "dispatch",
     {"resilience.degrade_dispatch_block_events": 1}),
    ("kernel.select_block:xla:4:3", "select",
     {"resilience.degrade_select_cuda_block_cuda": 3}),
)


def serve_oracle(reqs, policy, kwargs, caps, tps):
    """The sequential host oracle of ``serve_traffic``: one host-zoo
    ``DVBPScheduler.place`` a request at its arrival, departures in finish
    order.  Returns (placements, (replica_seconds, opened, peak))."""
    import heapq
    from repro_torch.serving.scheduler import DVBPScheduler
    sched = DVBPScheduler(policy, caps, kwargs, tokens_per_second=tps)
    heap, placements = [], {}
    for r in sorted(reqs, key=lambda x: x.arrival):
        while heap and heap[0][0] <= r.arrival:
            ft, rid = heapq.heappop(heap)
            sched.finish(rid, ft)
        placements[r.rid] = sched.place(r, r.arrival)
        heapq.heappush(heap, (r.arrival + r.decode_len / tps, r.rid))
    while heap:
        ft, rid = heapq.heappop(heap)
        sched.finish(rid, ft)
    st = sched.stats
    return placements, (st.replica_seconds, st.replicas_opened,
                        st.peak_replicas)


def served(rep):
    return rep.placements, (rep.replica_seconds, rep.replicas_opened,
                            rep.peak_replicas)


def phase_api_serving(dev, n_zoo: int = ZOO_REQUESTS):
    """Phase 17: the experiment API and online serving on the card.

    (a) ``api.Experiment`` over phase 4's 28 x 250 seed-11 suite and
    ``HEADLINE_POLICIES`` == ``run_sweep``'s records, total usage
    ``REF_USAGE_28x4``.  (b) ``serve_traffic`` over ``poisson_requests(
    **SERVE_TRAFFIC)`` at ``SERVE_TPS`` for ``SERVE_FAMILIES`` at batch
    sizes ``SERVE_TS`` (benchmarks/perf.py::serve_throughput's geometries
    and pool): each == the sequential host oracle, decision for decision
    and in its fleet numbers; a second pass adds no launch geometry and is
    the timed one (us a placed request, the latency quantiles, the wall's
    split into host stream building, launching and resolving).  (c) One
    stream with one slot a replica at ``SERVE_REGROW_TPS``, from a 64-slot
    pool: the pool regrows past 256 slots, the blocks move from the warp
    kernel to the global one, == the oracle.  (d) ``SERVE_FAULTS``: each
    injected fault steps one rung and nothing else moves; decisions == the
    fault-free run.  (e) Phase 13's requests through the scheduler's
    ``select_block`` (the megakernel at T=1 a decision) == the host zoo.
    (f) ``python -m repro_torch serve`` (``SERVE_CLI``) in both modes, on
    the card by default == ``--device cpu``.
    Then one mid-stream block of each geometry, copied from (b)'s first
    pass: both routes == ``replay_block_ref`` on it, and the megakernel's
    device time a block at L=1 beside its bound.  Returns the launches of
    (a)-(e) and the numbers."""
    from repro_torch import api, obs
    from repro_torch.core import torchsim
    from repro_torch.kernels import ops
    from repro_torch.kernels.fitscore import PAD_KIND
    from repro_torch.resilience import faults
    from repro_torch.serving import dispatch
    from repro_torch.serving.dispatch import serve_traffic
    from repro_torch.serving.scheduler import (_DEVICE_CATEGORY_POLICIES,
                                               _DEVICE_POLICIES,
                                               DVBPScheduler,
                                               ReplicaCapacity)
    from repro_torch.serving.traffic import poisson_requests
    from repro_torch.sweep import SuiteSpec, SweepSpec, run_sweep

    def resilience_moved():
        return {k: v for k, v in obs.counters().items()
                if k.startswith("resilience.") and v}

    res0 = resilience_moved()
    geo0 = ops.dispatch_trace_count()
    out = {}
    ops.launches.clear()
    # (a) the experiment API over the headline suite
    t0 = time.perf_counter()
    exp = api.Experiment(api.synthetic("azure", 28, 250, seed=11),
                         policies=HEADLINE_POLICIES, max_bins=64)
    res = exp.run(device=dev)
    records = run_sweep(SweepSpec(suites=(SuiteSpec("azure", 28, 250, 11),),
                                  policies=HEADLINE_POLICIES, max_bins=64),
                        device=dev)
    total = res.usage_total()
    if res.records != records or f"{total:.0f}" != str(REF_USAGE_28x4):
        fail(f"phase 17 (a): Experiment {total:.0f} ({len(res.records)} "
             f"records) != run_sweep's records / REF_USAGE_28x4")
    say(f"# phase 17 (a): api.Experiment 28x250 seed 11 "
        f"{','.join(HEADLINE_POLICIES)} == run_sweep's {len(records)} "
        f"records, total usage {total:.2f} == REF_USAGE_28x4 in "
        f"{time.perf_counter() - t0:.1f} s")

    # (b) serve_traffic, five families x T, against the host oracle
    caps = ReplicaCapacity()
    reqs = poisson_requests(SERVE_TRAFFIC["n"], rate=SERVE_TRAFFIC["rate"],
                            seed=SERVE_TRAFFIC["seed"],
                            sigma_pred=SERVE_TRAFFIC["sigma_pred"])
    split = collections.Counter()

    def timed(name):
        orig = getattr(dispatch.BlockDispatcher, name)

        def wrap(self, *a, **k):
            t = time.perf_counter()
            try:
                return orig(self, *a, **k)
            finally:
                split[name] += time.perf_counter() - t
        return orig, wrap

    captured, seen = {}, collections.Counter()
    orig_dispatch = ops.fitscore_replay_dispatch

    def capture(carry, ev_i, ev_f, ev_size, dmask, **kw):
        T = ev_size.shape[1]
        seen[T] += 1
        if seen[T] == 3:   # an early mid-stream block of this geometry
            captured[T] = ({k: v.clone() for k, v in carry.items()},
                           (ev_i.clone(), ev_f.clone(), ev_size.clone()),
                           dmask.clone(), kw)
        return orig_dispatch(carry, ev_i, ev_f, ev_size, dmask, **kw)

    stats = {}
    t_oracle = t_first = 0.0
    for kpol, hpol, kw in SERVE_FAMILIES:
        t = time.perf_counter()
        want = serve_oracle(reqs, hpol, kw, caps, SERVE_TPS)
        t_oracle += time.perf_counter() - t
        for T in SERVE_TS:
            args = dict(tps=SERVE_TPS, batch_max=T, max_bins=64, device=dev)
            t = time.perf_counter()
            if kpol == SERVE_FAMILIES[0][0]:
                ops.fitscore_replay_dispatch = capture
            try:
                first = serve_traffic(reqs, kpol, caps, **args)
            finally:
                ops.fitscore_replay_dispatch = orig_dispatch
            t_first += time.perf_counter() - t
            g = ops.dispatch_trace_count()
            split.clear()
            saved = [timed(nm) for nm in ("_streams", "_launch", "_resolve")]
            for (o, w), nm in zip(saved, ("_streams", "_launch", "_resolve")):
                setattr(dispatch.BlockDispatcher, nm, w)
            try:
                rep = serve_traffic(reqs, kpol, caps, **args)
            finally:
                for (o, w), nm in zip(saved, ("_streams", "_launch",
                                              "_resolve")):
                    setattr(dispatch.BlockDispatcher, nm, o)
            if served(first) != want or served(rep) != want:
                bad = served(first)[0] != want[0]
                fail(f"phase 17 (b): {kpol} T={T}: serve_traffic != the "
                     f"host oracle ({'placements' if bad else 'fleet'}: "
                     f"{served(rep)[1]} vs {want[1]})")
            if ops.dispatch_trace_count() != g or \
                    rep.metrics.get("serving.jit_trace", 0):
                fail(f"phase 17 (b): {kpol} T={T}: the second pass added "
                     "launch geometries")
            p50, p99 = rep.latency_quantiles()
            wall = rep.wall_seconds
            stats[(kpol, T)] = dict(
                us_per_request=wall / rep.placed * 1e6, p50_us=p50 * 1e6,
                p99_us=p99 * 1e6, wall_s=wall,
                streams_share=split["_streams"] / wall,
                launch_share=split["_launch"] / wall,
                resolve_share=split["_resolve"] / wall,
                peak=rep.peak_replicas)
    for kpol, _, _ in SERVE_FAMILIES:
        say(f"# phase 17 (b): {kpol}: " + "; ".join(
            f"T={T} {s['us_per_request']:.1f} us a request, p50 "
            f"{s['p50_us']:.0f} / p99 {s['p99_us']:.0f} us, host streams "
            f"{s['streams_share']:.3f} / launch {s['launch_share']:.3f} / "
            f"resolve {s['resolve_share']:.3f} of the wall"
            for T in SERVE_TS for s in [stats[(kpol, T)]]))
    say(f"# phase 17 (b): {SERVE_TRAFFIC['n']} requests x "
        f"{len(SERVE_FAMILIES)} families x T {SERVE_TS} == the host oracle "
        f"(placements, replica ids, replica-seconds, opened, peak "
        f"{stats[(SERVE_FAMILIES[0][0], 1)]['peak']}); first passes "
        f"{t_first:.1f} s, the oracle {t_oracle:.1f} s; launch geometries "
        f"{ops.dispatch_trace_count() - geo0}, none added by the second "
        "passes")

    # (c) a stream that regrows 64 -> 512 slots across the route switch
    caps1 = ReplicaCapacity(slots=1)
    want = serve_oracle(reqs, "best_fit", {"norm": "linf"}, caps1,
                        SERVE_REGROW_TPS)
    c0, g0 = obs.counter_get("serving.carry_regrow"), \
        ops.launches["fitscore_replay_block_global"]
    rep = serve_traffic(reqs, "best_fit_linf", caps1, tps=SERVE_REGROW_TPS,
                        batch_max=32, max_bins=64, device=dev)
    regrows = obs.counter_get("serving.carry_regrow") - c0
    glob = ops.launches["fitscore_replay_block_global"] - g0
    if served(rep) != want or rep.peak_replicas <= ops.REPLAY_WARP_MAX_SLOTS \
            or regrows < 3 or not glob:
        fail(f"phase 17 (c): peak {rep.peak_replicas}, {regrows} regrows, "
             f"{glob} global launches, == oracle {served(rep) == want}")
    say(f"# phase 17 (c): one slot a replica, peak {rep.peak_replicas} "
        f"replicas: the pool regrew {regrows} times from 64 slots and "
        f"{glob} blocks took the global kernel; == the host oracle")
    out["regrow"] = dict(peak=rep.peak_replicas, regrows=regrows,
                         global_launches=glob)

    # (e) the scheduler's megakernel select against the host zoo
    zreqs = zoo_requests(n_zoo)
    zkw = {"cbdt": {"rho": 8.0}}
    device = [(p, kw) for p in _DEVICE_POLICIES + _DEVICE_CATEGORY_POLICIES
              for kw in ([{"norm": m} for m in ("l1", "l2", "linf")]
                         if p == "best_fit" else [zkw.get(p)])]
    t0 = time.perf_counter()
    for name, kw in device:
        want = drive_scheduler(DVBPScheduler(
            name, policy_kwargs=kw, tokens_per_second=ZOO_TPS), zreqs)
        c0 = ops.launches["fitscore_select_block"]
        sched = DVBPScheduler(name, policy_kwargs=kw,
                              tokens_per_second=ZOO_TPS,
                              select_backend="device", device=dev,
                              select_block=True)
        got = drive_scheduler(sched, zreqs)
        if got != want or sched.last_select_backend != "cuda_block" or \
                ops.launches["fitscore_select_block"] - c0 != n_zoo:
            fail(f"phase 17 (e): {name} {kw}: the block select != the host "
                 f"zoo ({got[1]} vs {want[1]}, backend "
                 f"{sched.last_select_backend})")
    say(f"# phase 17 (e): {n_zoo} requests x {len(device)} configurations "
        f"through select_block == the host zoo in "
        f"{time.perf_counter() - t0:.1f} s")
    # (f) the serve CLI in both modes: the card (its default) == the CPU
    t0 = time.perf_counter()
    procs = {(mode, dflag): subprocess.Popen(
        [sys.executable, "-m", "repro_torch", *SERVE_CLI, *margs, *dflag],
        cwd=ROOT, env=_port_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for mode, margs in SERVE_CLI_MODES.items()
        for dflag in ((), ("--device", "cpu"))}
    rows = {}
    for key, proc in procs.items():
        stdout, err = proc.communicate(timeout=600)
        if proc.returncode:
            fail(f"phase 17 (f): serve {key}: rc {proc.returncode} "
                 f"{err[-1500:]}")
        body = [ln.split() for ln in stdout.splitlines()
                if ln and not ln.startswith("#")][1:]
        # traffic mode: req/s and the latencies are wall clock
        rows[key] = [r[:1] + r[4:] for r in body] \
            if key[0] == "traffic" else body
    for mode in SERVE_CLI_MODES:
        card, cpu = rows[(mode, ())], rows[(mode, ("--device", "cpu"))]
        if card != cpu or len(card) < 3:
            fail(f"phase 17 (f): serve {mode} on the card {card} != on the "
                 f"CPU {cpu}")
    say(f"# phase 17 (f): python -m repro_torch serve, capacity planning "
        f"and --traffic poisson, on the card by default == --device cpu, "
        f"row for row ({time.perf_counter() - t0:.1f} s, 4 processes)")
    moved = {k: v - res0.get(k, 0) for k, v in resilience_moved().items()
             if v != res0.get(k, 0)}
    if moved:
        fail(f"phase 17: resilience counters moved without a fault plan: "
             f"{moved}")
    launches = dict(ops.launches)

    # (d) injected faults: one rung a fault, the same decisions
    small = reqs[:400]
    for plan, path, moves in SERVE_FAULTS:
        before = obs.counters()
        if path == "dispatch":
            want = served(serve_traffic(small, "best_fit_linf", caps,
                                        tps=SERVE_TPS, batch_max=32,
                                        device=dev))
            with faults.injected(plan) as p:
                got = served(serve_traffic(small, "best_fit_linf", caps,
                                           tps=SERVE_TPS, batch_max=32,
                                           device=dev))
        else:
            want = drive_scheduler(DVBPScheduler(
                "cbd", tokens_per_second=ZOO_TPS), zreqs[:200])
            with faults.injected(plan) as p:
                got = drive_scheduler(DVBPScheduler(
                    "cbd", tokens_per_second=ZOO_TPS,
                    select_backend="device", device=dev, select_block=True),
                    zreqs[:200])
        delta = {k: v for k, v in obs.counter_deltas(before).items()
                 if k.startswith("resilience.")}
        expect = dict(moves, **{"resilience.fault_xla":
                                 sum(p.fired.values())})
        if got != want or delta != expect:
            fail(f"phase 17 (d): {plan}: == fault-free {got == want}, "
                 f"counters {delta} (expected {expect})")
    say(f"# phase 17 (d): {len(SERVE_FAULTS)} fault plans "
        f"({', '.join(p for p, _, _ in SERVE_FAULTS)}): each fault stepped "
        "one rung, no other resilience counter moved, decisions == the "
        "fault-free runs")

    # the path's blocks at L=1: both routes == plain, device time, bound
    blocks = {}
    for T, (carry, blk, dmask, kw) in sorted(captured.items()):
        bkw = torchsim.replay_block_kwargs(kw["policy"], kw["n"], kw["d"])
        after = {k: v.clone() for k, v in carry.items()}
        routes, _ = check_routes(after, blk, dmask, bkw,
                                 f"serving block T={T}")
        nbytes, nops = block_bytes(carry, after, blk, bkw["family"],
                                   kw["d"])
        t_bytes = float(nbytes) / HBM_BYTES_PER_S * 1e3
        t_ops = float(nops) / F32_OPS_PER_S * 1e3
        runs = [{k: v.clone() for k, v in carry.items()} for _ in range(50)]
        ms = time_launches([ops.replay_block_launcher(
            c, *blk, dmask, route=ops.replay_route(kw["n"]), **bkw)
            for c in runs])
        blocks[T] = dict(device_ms=ms, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else
                         "operations", routes=routes,
                         events=int((blk[0][0] != PAD_KIND).sum()))
    say("# phase 17: the dispatcher's megakernel at L=1 (best_fit_linf, "
        "the 3rd block of each geometry, both routes == replay_block_ref):"
        " " + "; ".join(
            f"T={T} ({b['events']} real events) {b['device_ms'] * 1e3:.2f} "
            f"us a block, bound {b['bound_ms'] * 1e3:.4f} us by "
            f"{b['bound_by']}" for T, b in blocks.items()))
    out.update(stats={f"{k}_T{T}": v for (k, T), v in stats.items()},
               blocks=blocks)
    return launches, out


def profile_run(dev, label, fn, units: int, unit: str) -> dict:
    """Device busy time against wall time of ``fn`` under torch.profiler,
    per ``unit``: {"wall_us", "busy_us", "share" (%), "kernels", "by_name"
    ({kernel: device µs})}, empty if the profiler saw no device kernels.
    A measurement, not a check: if the profiler reports no device activity
    it says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_k = sum(e.count for e in kernels)
    if not n_k:
        say(f"# profile {label}: the profiler saw no device kernels (not "
            "measured)")
        return {}
    say(f"# profile {label} (under the profiler): wall "
        f"{wall_us / units:.1f} us/{unit}, device busy "
        f"{busy_us / units:.1f} us/{unit} "
        f"({100 * busy_us / wall_us:.1f} %), {n_k / units:.1f} "
        f"kernels/{unit}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        say(f"#   {e.self_device_time_total / units:10.2f} us/{unit} "
            f"x{e.count / units:.1f}  {e.key[:90]}")
    return {"wall_us": wall_us / units, "busy_us": busy_us / units,
            "share": 100 * busy_us / wall_us, "kernels": n_k / units,
            "by_name": {e.key: e.self_device_time_total / units
                        for e in kernels}}


def select_in_graph_ms(dev, L: int = 56, Np: int = 64, n: int = 256):
    """Device time per select launch inside a CUDA graph of ``n`` launches
    (the warp route, best_fit_l2, d=5; uncounted), replayed behind a spin:
    the select as the graphed per-event path launches it."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    st = random_state(np.random.default_rng(7), L, Np, 5, "random", dev)
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        launch, _ = ops.select_launcher(*st[:10], policy="best_fit_l2",
                                        route=ops.select_route(Np))
        g.capture_begin()
        for _ in range(n):
            launch()
        g.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    ms = device_ms(g.replay, 3) / n
    g.reset()
    return ms


def phase_profile(dev, n_items: int = 5000, steps: int = 2048,
                  eager_steps: int = 400):
    """Where the time goes on the main path's first rung (L=28
    clairvoyant lanes, max_bins 64, best_fit_l2): ``steps`` per-event
    steps graphed (the path; the warm-up window and the capture included)
    and ``eager_steps`` as the plain loop, under the profiler; the whole
    scan's wall time at windows of 64, 128 and 256 steps, and at
    ``STEP_WINDOW`` its graph replays' device time by CUDA events around
    each; the select's own device time inside a graph; and one whole
    blocked scan of best_fit_l2 and of ppe_modified."""
    import torch
    from repro_torch.core import torchsim
    from repro_torch.core.torchsim import _replay_batch
    from repro_torch.sweep import SuiteSpec
    from repro_torch.sweep.grid import _built_suite
    _, _, b = _built_suite(SuiteSpec("azure", 28, n_items))

    def per_event(n, window):
        ev = slice(0, n)
        old = torchsim.STEP_WINDOW
        torchsim.STEP_WINDOW = window
        try:
            _replay_batch(b.sizes, b.times[:, ev], b.kinds[:, ev],
                          b.items[:, ev], b.pdeps, b.dmask,
                          policy="best_fit_l2", max_bins=64, device=dev)
        finally:
            torchsim.STEP_WINDOW = old

    K = torchsim.STEP_WINDOW
    out = {"graphed": profile_run(
        dev, f"per event graphed (windows of {K}), {steps} steps, L=28 "
        f"Np=64 best_fit_l2", lambda: per_event(steps, K), steps, "step")}
    out["eager"] = profile_run(
        dev, f"per event eager, {eager_steps} steps, L=28 Np=64 best_fit_l2",
        lambda: per_event(eager_steps, 1 << 30), eager_steps, "step")
    sel = {k: v for k, v in out["graphed"].get("by_name", {}).items()
           if "select_warp_kernel" in k}
    out["select_in_graph_us"] = sum(sel.values()) or None
    if sel:
        say(f"# profile: the select inside the graphed steps "
            f"{sum(sel.values()):.2f} us/step ({', '.join(sel)})")

    # the whole scan of the first rung at each window (the path's wall),
    # and at STEP_WINDOW its graph replays' device time by CUDA events
    E = b.times.shape[1]
    walls = {}
    for w in (64, 128, 256):
        walls[w] = time_ms(lambda: per_event(E, w), 1) * 1e3 / E
    out["window_walls_us"] = walls
    say(f"# whole first-rung scan ({E} steps), wall a step by window: "
        + ", ".join(f"{w}: {v:.2f} us" for w, v in walls.items())
        + f" (STEP_WINDOW = {K})")
    replays, graph_cls = [], torchsim._Graph

    class TimedGraph(graph_cls):
        """The path's graph with CUDA events around each replay: the device
        time of the graphed windows, without the eager ones."""

        def replay(self):
            a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            super().replay()
            z.record()
            replays.append((a, z))

    torchsim._Graph = TimedGraph
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_event(E, K)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        torchsim._Graph = graph_cls
    n_rep = len(replays)
    graph_us = 1e3 * sum(a.elapsed_time(z) for a, z in replays)
    out["graph_step_us"] = graph_us / (n_rep * K)
    out["graph_busy_share"] = 100 * graph_us / wall_us
    say(f"# the same scan's graph replays alone (CUDA events around each): "
        f"{n_rep} replays of {K} steps, {out['graph_step_us']:.2f} us of "
        f"device time a step; the device busy in them "
        f"{out['graph_busy_share']:.1f} % of the scan's wall "
        f"({wall_us / E:.2f} us a step; the rest the warm-up window, the "
        f"capture and the tail, run eagerly)")
    out["select_graph_ms"] = select_in_graph_ms(dev)
    say(f"# select launched from a CUDA graph (L=56, Np=64, warp route): "
        f"{out['select_graph_ms']:.6f} ms a launch of device time")

    full = (b.sizes, b.times, b.kinds, b.items, b.pdeps, b.dmask,
            b.arrivals, b.pdeps, b.n_items)
    NB = -(-b.times.shape[1] // BLOCK_EVENTS)
    for policy in ("best_fit_l2", "ppe_modified"):
        profile_run(dev, f"blocked, one scan of {NB} blocks, L=28 Np=64 "
                    f"T={BLOCK_EVENTS} {policy}",
                    lambda: _replay_batch(*full, policy=policy, max_bins=64,
                                          device=dev,
                                          block_events=BLOCK_EVENTS),
                    NB, "block")
    return out


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    parent_tree = None
    if len(sys.argv) == 3 and sys.argv[1] == "--parent":
        parent_tree = os.path.abspath(sys.argv[2])
    elif len(sys.argv) != 1:
        fail("usage: python3 chip_smoke.py [--parent TREE]")
    # the plain versions' float32 products in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable from {ROOT}/src: {e}")
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = phase_build()
    say(f"# torch {torch.__version__} cuda {torch.version.cuda} on {card}")
    parent = parent_library(parent_tree)
    sel = phase_kernel_vs_plain(dev)
    mk_err = phase_megakernel_vs_plain(dev)
    mk = time_megakernel(dev)
    phase_headline(dev)
    phase_category_headline(dev)
    sel_launches, records, eps, graphs, graph_walls = phase_main_path(dev)
    mk_launches, mk_routes, blocked_records = phase_blocked_main_path(
        dev, records, eps)
    flash, decode = phase_attention_vs_plain(dev)
    attn_launches = phase_serving(dev)
    rwkv = phase_rwkv_vs_plain(dev, parent)
    rwkv_launches = phase_rwkv_serving(dev)
    legacy_launches, legacy = phase_legacy_fitscore(dev, parent)
    phase_migrate_vs_plain(dev)
    phase_frontier(dev)
    mig_launches, mig_ms, mig_mid = phase_consolidation_main_path(
        dev, blocked_records)
    oracle_launches, oracle_cons_launches = phase_oracle(dev)
    zoo_launches = phase_scheduler_zoo(dev)
    resilience_guard("phases 1-13")    # phase 14 resets the counters
    obs_launches, trace_steps = phase_obs(dev)
    res_launches, res_numbers = phase_resilience(dev)
    stream_launches, stream_numbers = phase_stream(dev)
    api_launches, api_numbers = phase_api_serving(dev)
    prof = phase_profile(dev)
    say(f"# total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [
        dict(name="fitscore_select", route="cuda",
             source="src/repro_torch/kernels/csrc/select.cu (+ "
                    "warp_select.cuh)",
             replaces="src/repro/kernels/fitscore.py:330",
             routes={"warp": "select_warp_kernel, Np <= 256 (ms)",
                     "cta": "select_cta_kernel, Np > 256 (cta_ms)"},
             launches=sel_launches, library_ms=None,
             graph_replays=graphs["replay_step_graph"],
             graph_captures=graphs["replay_step_capture"],
             in_graph_ms=prof["select_graph_ms"],
             graph_step_us=prof["graph_step_us"],
             graph_busy_share=prof["graph_busy_share"],
             select_us_a_graphed_step=prof["select_in_graph_us"],
             scan_wall_graphed_s=graph_walls["graphed"],
             scan_wall_eager_s=graph_walls["eager"],
             oracle_phase_launches=oracle_launches["fitscore_select"],
             oracle_consolidation_launches=oracle_cons_launches[
                 "fitscore_select"],
             scheduler_zoo_launches=zoo_launches["fitscore_select"],
             obs_phase_launches=obs_launches["fitscore_select"],
             resilience_phase_launches=res_launches.get(
                 "fitscore_select", 0),
             stream_phase_launches=stream_launches.get(
                 "fitscore_select", 0),
             segment_warm_capture_share=res_numbers["segments"][
                 "per_event_warm_capture_share"],
             **trace_steps, **sel),
        dict(name="fitscore_replay_block", route="cuda",
             source="src/repro_torch/kernels/csrc/replay_block_sm90.cu + "
                    "src/repro_torch/kernels/csrc/replay_block.cu",
             replaces="src/repro/kernels/fitscore.py:865",
             launches=mk_launches, launches_warp=mk_routes["warp"],
             launches_global=mk_routes["global"], max_abs_err=mk_err,
             library_ms=None, migrate_launches=mig_launches,
             migrate_ms=mig_ms, migrate_device_ms=mig_mid.get("warp"),
             migrate_global_device_ms=mig_mid.get("global"),
             oracle_phase_launches=oracle_launches["fitscore_replay_block"],
             oracle_consolidation_launches=oracle_cons_launches.get(
                 "fitscore_replay_block_migrate", 0),
             obs_phase_launches=obs_launches["fitscore_replay_block"],
             resilience_phase_launches=res_launches.get(
                 "fitscore_replay_block", 0),
             stream_phase_launches=stream_launches.get(
                 "fitscore_replay_block", 0),
             stream_chunk_ms={
                 str(n): stream_numbers[n]["first_fit_blocked"]["chunk_ms"]
                 for n, _, _ in STREAM_CELLS},
             dispatch_phase_launches=api_launches.get(
                 "fitscore_replay_block", 0),
             dispatch_launches_by_T={
                 k[len("fitscore_replay_dispatch_T"):]: v
                 for k, v in sorted(api_launches.items())
                 if k.startswith("fitscore_replay_dispatch_T")},
             select_block_launches=api_launches.get(
                 "fitscore_select_block", 0),
             serve_block_device_ms={
                 str(T): b["device_ms"]
                 for T, b in api_numbers["blocks"].items()},
             serve_block_bound_ms={
                 str(T): b["bound_ms"]
                 for T, b in api_numbers["blocks"].items()},
             serve_us_per_request={
                 k: v["us_per_request"]
                 for k, v in api_numbers["stats"].items()},
             **mk),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_sm90.cu + "
                    "src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:68",
             launches=attn_launches["flash_attention"],
             sm90_launches=attn_launches["flash_attention_sm90"], **flash),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:55",
             launches=attn_launches["decode_attention"], **decode),
        dict(name="rwkv6_chunked", route="cuda",
             source="src/repro_torch/kernels/csrc/rwkv6_chunked.cu",
             replaces="src/repro/kernels/rwkv6_scan.py:69",
             launches=rwkv_launches, **rwkv),
        dict(name="fitscore", route="cuda",
             source="src/repro_torch/kernels/csrc/fitscore.cu",
             replaces="src/repro/kernels/fitscore.py:154",
             launches=legacy_launches, library_ms=None, **legacy)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
