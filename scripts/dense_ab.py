"""Phase 18's and 19's teacher-forced requests of the architectures whose
attention runs at head dims 192 and 256 (gemma3-12b, nemotron-4-340b and
deepseek-v2-lite-16b's MLA, at full width and the depths of
``chip_smoke.SERVE_LAYERS``), through one source tree's kernels, timed, so
that two trees (a commit and its parent) can be compared on one card.

    python3 scripts/dense_ab.py [--root TREE] [--label NAME] [--repeats N]

``TREE`` (default: the tree this script lies in) is a checkout of this
repo: its own kernels are built (``_build.library``, reused when built),
and its own ``chip_smoke.teacher_forced_logits`` runs each model's request
(``DENSE_REQUESTS``: the prompt prefilled at once, then its decode steps,
weights from seed 0) once to warm up and ``N`` times timed, each forward
call on the host clock between synchronizations.  Prints, as its last
line, one JSON object with the label, the card and, for each model, the
median prefill ms, the median decode ms a step and the attention launches
of one request.  Needs one card.

To compare two trees, run them in turns on one machine (A, B, B, A) and
compare within that sequence: the host's speed drifts from one machine and
hour to the next.
"""
from __future__ import annotations

import argparse
import collections
import importlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("gemma3-12b", "nemotron-4-340b", "deepseek-v2-lite-16b")


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
        sys.exit("dense_ab: needs a card")
    cs = importlib.import_module("chip_smoke")
    from repro_torch.kernels import _build, ops
    from repro_torch.models.params import init_params
    dev = torch.device("cuda")
    _build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out = {}
    for arch in ARCHS:
        cfg = cs.dense_config(arch)
        params = init_params(cfg, seed=0, device=dev)
        n_prompt, n_forced = cs.DENSE_REQUESTS[arch]
        prompt = list(np.random.default_rng(7).integers(2, cfg.vocab,
                                                        n_prompt))
        forced = list(np.random.default_rng(99).integers(2, cfg.vocab,
                                                         n_forced))
        max_len = cs.GEMMA_MAX_LEN if arch == "gemma3-12b" else \
            cs.SERVE_MAX_LEN
        cs.teacher_forced_logits(cfg, params, prompt, forced, dev, max_len)
        times = collections.defaultdict(list)
        for _ in range(args.repeats):
            ops.launches.clear()
            cs.teacher_forced_logits(cfg, params, prompt, forced, dev,
                                     max_len, times=times)
        out[arch] = dict(
            layers=cfg.n_layers,
            prefill_ms=float(np.median(times["prefill"])),
            decode_ms=float(np.median(times["decode"])),
            launches={k: v for k, v in sorted(ops.launches.items())
                      if "attention" in k})
        cs.free_model(params)
    print(card)
    print(json.dumps({"label": args.label or root, "card": card,
                      "repeats": args.repeats, "archs": out}), flush=True)


if __name__ == "__main__":
    main()
