"""Per-rank bytes of the training state under the sharding plan, computed
from ``tree_placements`` and the architecture's shapes: nothing is
allocated and nothing runs on a card.

    python3 scripts/plan_bytes.py [--arch ARCH ...]

For each architecture (default nemotron-4-340b and qwen2.5-14b) at its
``train_4k`` cell, on the production meshes (16, 16) and (2, 16, 16) under
``launch.specs.make_rules``, and on one rank: the bytes one rank holds of
the fp32 master weights, of the gradient accumulator (bf16 where
``BF16_ACCUM`` names the architecture, else fp32) and of the AdamW moments
(``opt_config``: int8 values with fp32 per-row scales, or fp32).  Every
rank of a plan holds the same (each placed dim divides its axes).  Prints
one JSON object a line.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import types

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import params as P_  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.models.sharding import (local_shape,  # noqa: E402
                                         paired, tree_placements)
from repro_torch.train.optimizer import opt_state_placements  # noqa: E402

MESHES = {"one rank": {"data": 1, "model": 1},
          "(16, 16)": {"data": 16, "model": 16},
          "(2, 16, 16)": {"pod": 2, "data": 16, "model": 16}}


def rank_bytes(arch: str, mesh: str) -> dict:
    cfg = get_config(arch)
    shape = SHAPES["train_4k"]
    rules = specs.make_rules(cfg, shape, multi_pod=mesh == "(2, 16, 16)")
    sizes = MESHES[mesh]
    pl = tree_placements(cfg, sizes, rules)
    leaves = P_._finalize(cfg, lambda m, n: types.SimpleNamespace(
        shape=((n,) + m.shape) if n else m.shape))
    opt = specs.opt_config(cfg)

    def elems(shape, placement):
        return math.prod(local_shape(shape, placement, sizes))

    pairs = paired(leaves, pl)
    weights = sum(elems(x.shape, p) for x, p in pairs)
    if opt.state_dtype == "int8":
        scales = paired(leaves, opt_state_placements(pl, opt)["m"])
        n_scales = sum(elems(x.shape[:-1] + (1,), p["s"]) for x, p in scales)
        moments = 2 * (weights + 4 * n_scales)
    else:
        moments = 2 * 4 * weights
    accum = 2 if cfg.name in specs.BF16_ACCUM else 4
    out = {"arch": arch, "mesh": mesh, "weights_fp32": 4 * weights,
           "gradients": accum * weights, "moments": moments,
           "state_dtype": opt.state_dtype}
    out["total"] = out["weights_fp32"] + out["gradients"] + moments
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*",
                    default=["nemotron-4-340b", "qwen2.5-14b"])
    args = ap.parse_args(argv)
    for arch in args.arch:
        for mesh in MESHES:
            print(json.dumps(rank_bytes(arch, mesh)), flush=True)


if __name__ == "__main__":
    main()
