"""The tensor-core latent kernel (``csrc/latent_attention_sm90.cu``) at
phase 7c's deepseek-v2-lite-16b cases (a decode step at 4 slots' depths,
a 221-token prompt prefilled as 128 + 93), each launched at several key
split counts in place of ``ops.latent_splits``'s, checked against
``latent_attention_ref`` and timed on the card.

    python3 scripts/latent_splits_sweep.py [--splits 1,2,4,8]

Builds the kernels first (the library is deleted, so that ptxas reports:
the new kernel's registers, spills and any warning are printed).  Prints
one line a (case, n_split) and, as its last line, one JSON object with the
card, the split count ``ops.latent_splits`` picks for each case, and the
device ms of every (case, n_split).  Needs one card.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splits", default="1,2,3,4,5,6,8")
    ap.add_argument("--probe", action="store_true",
                    help="also time one split at uniform depths")
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(HERE, "src"), HERE]
    import torch
    if not torch.cuda.is_available():
        sys.exit("latent_splits_sweep: needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.attention import latent_attention_ref
    if os.path.exists(_build.library_path()):
        os.remove(_build.library_path())
    path, secs, report = _build.build()
    print(f"# build {secs:.1f} s")
    for line in report.splitlines():
        if "latent_sm90" in line or "arning" in line or "erialized" in line:
            print("#   " + line.strip()[:200])
    for name, r in cs.ptxas_by_kernel(report).items():
        if "latent" in name or "flash_sm90" in name:
            print(f"#   {name[:60]}: {r['registers']} registers, "
                  f"{r['spill']} bytes spilled")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"# clusters of 2 / 4 / 8 CTAs the card holds at once: "
          f"{ops._latent_clusters(dev)}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    H, D, Dv = cs.LATENT_H, cs.LATENT_D, cs.LATENT_DV
    B, Smax, lens = cs.LATENT_DECODE
    cases = {"decode": (B, 1, Smax, [n - 1 for n in lens], list(lens))}
    start = 0
    for c in cs.LATENT_PREFILL[1]:
        cases[f"prefill {start}+{c}"] = (1, c, Smax, [start], [start + c])
        start += c
    picked, ms = {}, {}
    real_splits = ops.latent_splits
    try:
        for name, (b_, sq, sk, offs, ls) in cases.items():
            q, lat = cs._attention_inputs(gen, dev, torch.bfloat16,
                                          (b_, sq, H, D), (b_, sk, D))[:2]
            for b, n in enumerate(ls):
                lat[b, n:] = float("nan")
            kw = dict(q_offset=torch.tensor(offs, dtype=torch.int32,
                                            device=dev),
                      hd_v=Dv, scale=cs.LATENT_SCALE)
            kv_len = torch.tensor(ls, dtype=torch.int32, device=dev)
            want = latent_attention_ref(q, lat, kv_len, **kw)
            picked[name] = real_splits(b_, ops.latent_tiles(sq, H), sk, n_sm,
                                       ops._latent_clusters(dev))
            for n in [int(x) for x in args.splits.split(",")]:
                ops.latent_splits = lambda *a, n=n: n
                what = f"{name} n_split {n}"
                got = ops.latent_attention(q, lat, kv_len, **kw)
                err = cs._allclose_err(got, want, cs.ATTN_TOL["bfloat16"],
                                       what)
                t = cs.device_ms(lambda: ops.latent_attention(q, lat, kv_len,
                                                              **kw), 50)
                ms[what] = t
                print(f"# {what} ({ops.last_latent_grid[2]} CTAs) "
                      f"{t:.6f} ms, max |diff| {err:.3e}", flush=True)
    finally:
        ops.latent_splits = real_splits
    # one CTA an SM walking k key tiles alone: B rows of one query at
    # kv_len = 64 k, one split (the time a key tile takes a CTA, and
    # whether it moves when more SMs stream at once)
    probe = {}
    if args.probe:
        ops.latent_splits = lambda *a: 1
        try:
            for b_, n in itertools.product((4, 32, 128), (64, 256, 1024)):
                q, lat = cs._attention_inputs(gen, dev, torch.bfloat16,
                                              (b_, 1, H, D), (b_, n, D))[:2]
                kw = dict(q_offset=torch.full((b_,), n - 1, dtype=torch.int32,
                                              device=dev),
                          hd_v=Dv, scale=cs.LATENT_SCALE)
                t = cs.device_ms(lambda: ops.latent_attention(q, lat, **kw),
                                 50)
                probe[f"B {b_} kv_len {n}"] = t
                print(f"# probe B {b_} kv_len {n} (one split): {t:.6f} ms, "
                      f"{b_ * n * D * 2 / t / 1e6:.1f} GB/s of latent rows",
                      flush=True)
        finally:
            ops.latent_splits = real_splits
    print(card)
    print(json.dumps({"card": card, "picked": picked, "ms": ms,
                      "probe": probe}))


if __name__ == "__main__":
    main()
