"""deepseek-v2-lite-16b's absorbed MLA (``Runtime(mla_absorb=True)``,
every attention call through the latent kernel) at full width and the
depth of ``chip_smoke.SERVE_LAYERS``, through one source tree's kernels,
timed, so that two trees (a commit and its parent) can be compared on one
card.

    python3 scripts/latent_ab.py [--root TREE] [--label NAME] [--repeats N]

``TREE`` (default: the tree this script lies in) is a checkout of this
repo: its own kernels are built (``_build.library``, reused when built)
and its own ``chip_smoke`` helpers run (weights from seed 0):

- the teacher-forced request of phase 19c: a 221-token prompt prefilled
  as chunks of 128 and 93 (``chip_smoke.CHUNKED_PROMPT``), then its
  decode steps, each forward call on the host clock between
  synchronizations, once to warm up and ``N`` times timed;
- an engine of 4 slots at depths ``chip_smoke.MOE_ENGINE_LENS``, each
  step timed likewise (``N`` rounds of ``MOE_ENGINE_STEPS`` steps).

Prints, as its last line, one JSON object with the label, the card, the
median ms of each prefill chunk, of a decode step and of an engine step,
the spread (min, max) of each, and the attention launches of one request.
Needs one card.  Run the two trees in turns on one machine (A, B, B, A)
and compare within that sequence: the host's speed drifts from one machine
and hour to the next.
"""
from __future__ import annotations

import argparse
import collections
import importlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "deepseek-v2-lite-16b"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("latent_ab: needs a card")
    cs = importlib.import_module("chip_smoke")
    from repro_torch.kernels import _build, ops
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import Runtime
    from repro_torch.serving.engine import ReplicaEngine
    dev = torch.device("cuda")
    _build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cfg = cs.dense_config(ARCH)
    params = init_params(cfg, seed=0, device=dev)
    rt = Runtime(mla_absorb=True)
    n_prompt, chunks = cs.CHUNKED_PROMPT
    prompt = list(np.random.default_rng(7).integers(2, cfg.vocab, n_prompt))
    forced = list(np.random.default_rng(99).integers(2, cfg.vocab,
                                                     cs.CHUNKED_DECODE))
    cs.teacher_forced_logits(cfg, params, prompt, forced, dev, rt=rt,
                             chunks=chunks)
    times = collections.defaultdict(list)
    for _ in range(args.repeats):
        ops.launches.clear()
        cs.teacher_forced_logits(cfg, params, prompt, forced, dev, rt=rt,
                                 chunks=chunks, times=times)
    launches = {k: v for k, v in sorted(ops.launches.items())
                if "attention" in k}
    rng = np.random.default_rng(11)
    prompts = [list(rng.integers(2, cfg.vocab, n))
               for n in cs.MOE_ENGINE_LENS]
    steps = []
    for rep in range(args.repeats + 1):
        eng = ReplicaEngine(cfg, params, slots=len(prompts),
                            max_len=cs.SERVE_MAX_LEN, rt=rt, eos_id=-1)
        for i, p in enumerate(prompts):
            eng.admit(4000 + i, p, 64)
        for _ in range(cs.MOE_ENGINE_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            if rep:                         # the first round warms up
                steps.append((time.perf_counter() - t) * 1e3)
        del eng
    n_chunks = len(chunks)
    pre = np.array(times["prefill"]).reshape(args.repeats, n_chunks)

    def stats(x):
        x = np.asarray(x)
        return dict(median=float(np.median(x)), min=float(x.min()),
                    max=float(x.max()))
    out = dict(layers=cfg.n_layers,
               prefill_chunk_ms={f"{sum(chunks[:i])}+{c}": stats(pre[:, i])
                                 for i, c in enumerate(chunks)},
               decode_ms=stats(times["decode"]),
               engine_step_ms=stats(steps), launches=launches)
    cs.free_model(params)
    print(card)
    print(json.dumps({"label": args.label or root, "card": card,
                      "repeats": args.repeats, ARCH: out}), flush=True)


if __name__ == "__main__":
    main()
