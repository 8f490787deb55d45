"""Where a decode step of qwen2.5-14b over an int8 KV cache spends its time,
beside the same step over a bf16 cache, on the card.

    python3 scripts/int8_decode_profile.py [--layers 8] [--steps 12]

Builds the kernels (``chip_smoke.phase_build``) and makes qwen2.5-14b at
full width, its depth cut to ``--layers`` (random weights from seed 0, made
on the card).  For each cache (int8 with its fp32 scales, then bf16) it
prefills chip_smoke's 221-token prompt as chunks of 128 and 93 into one
slot of 1024 positions and runs two decode steps to warm up.  Then it
times ``--steps`` decode steps of each on the host clock between
synchronizations, the two caches' steps in turns (int8, bf16, bf16, int8,
...: the host's speed drifts within a call), and runs ``PROFILED_STEPS``
more of each under torch.profiler (CPU and CUDA).  Per decode step it
reports the wall time, the device's busy time and share, and each
device kernel's and each host op's (``aten::``, self CPU time) time and
count.  Then the int8 step minus the bf16 step, by kernel and by host op.

Beside that, one layer's two parts that differ, alone, both ways: its
cache write (``quant_kv`` of k and v and four row writes for int8, two row
writes for bf16, at a per-slot position as the engine passes it) and its
decode attention call (B 1, the cache of 1024 positions, 221 of them
read), measured in the first ``PART_ROUNDS`` turns, medians kept.  Each
one's host time is the wall time of queueing ``CALLS`` of
them while a spin kernel holds the stream, divided by ``CALLS`` (few
enough that the launch queue never fills, which would block the host); its
device time is CUDA events around the same calls, which run back to back
once the spin ends.  The profiler's first session in a process costs more
on the host than later ones, so an unread session runs first.

Writes everything to ``chiprun_out/int8_decode_profile.json`` and prints
a summary, the card's name and power limit, and as its last line one JSON
object of the main numbers.  Needs one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 20
PART_ROUNDS = 5
PROFILED_STEPS = 4


def _profile(fn, steps):
    """{"wall_us", "busy_us", "share", "kernels", "device", "host"} per
    step of ``fn`` run ``steps`` times under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            fn(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    dev, host = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev[e.key] = [e.self_device_time_total / steps, e.count / steps]
        elif e.key.startswith("aten::"):
            host[e.key] = [e.self_cpu_time_total / steps, e.count / steps]
    busy = sum(t for t, _ in dev.values())
    return dict(wall_us=wall / steps, busy_us=busy,
                share=100 * busy / wall * steps if wall else 0.0,
                kernels=sum(n for _, n in dev.values()), device=dev,
                host=host)


def _diff(a, b):
    """Per key: [a's us, b's us, a - b, a's count, b's count], by |a - b|."""
    rows = {k: [a.get(k, [0, 0])[0], b.get(k, [0, 0])[0],
                a.get(k, [0, 0])[0] - b.get(k, [0, 0])[0],
                a.get(k, [0, 0])[1], b.get(k, [0, 0])[1]]
            for k in set(a) | set(b)}
    return dict(sorted(rows.items(), key=lambda kv: -abs(kv[1][2])))


def _host_device_us(fn):
    """(host us, device us) of one call of ``fn`` (see the module
    docstring)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)     # ~0.1 s of spinning
    a.record()
    t = time.perf_counter()
    for _ in range(CALLS):
        fn()
    host_us = (time.perf_counter() - t) / CALLS * 1e6
    b.record()
    torch.cuda.synchronize()
    return host_us, a.elapsed_time(b) / CALLS * 1e3


def _layer_parts(cfg, dev, int8):
    """{"write": (host us, device us), "decode": (...)} of one layer's
    cache write and decode attention call over an int8 or a bf16 cache."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.attention import quant_kv
    from repro_torch.models.attention import _write_rows
    from repro_torch.models.transformer import init_cache
    c = dataclasses.replace(cfg, n_layers=1, kv_cache_int8=int8)
    cache = {k: v[0] for k, v in init_cache(c, 1, 1024, device=dev).items()}
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    bf = torch.bfloat16
    k, v = (torch.randn((1, 1, cfg.n_kv_heads, cfg.head_dim), generator=g,
                        device=dev).to(bf) for _ in range(2))
    q = torch.randn((1, cfg.n_heads, cfg.head_dim), generator=g,
                    device=dev).to(bf)
    pos = torch.tensor([220], dtype=torch.int32, device=dev)
    kv_len = pos + 1

    def write():
        if int8:
            (kq, ks), (vq, vs) = quant_kv(k), quant_kv(v)
            for name, u in (("k_q", kq), ("k_s", ks), ("v_q", vq),
                            ("v_s", vs)):
                _write_rows(cache[name], u, pos)
        else:
            _write_rows(cache["k"], k, pos)
            _write_rows(cache["v"], v, pos)

    def decode():
        if int8:
            ops.decode_attention(q, cache["k_q"], cache["v_q"], kv_len,
                                 k_scale=cache["k_s"], v_scale=cache["v_s"])
        else:
            ops.decode_attention(q, cache["k"], cache["v"], kv_len)
    write()
    return {"write": _host_device_us(write),
            "decode": _host_device_us(decode)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "int8_decode_profile.json"))
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("int8_decode_profile: needs a card")
    cs = importlib.import_module("chip_smoke")
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import Runtime, forward, init_cache
    dev = torch.device("cuda")
    card = cs.phase_build()
    cfg = dataclasses.replace(get_config("qwen2.5-14b"),
                              n_layers=args.layers)
    params = init_params(cfg, seed=0, device=dev)
    n_prompt, chunks = cs.CHUNKED_PROMPT
    prompt = np.random.default_rng(7).integers(2, cfg.vocab, n_prompt)
    forced = np.random.default_rng(99).integers(
        2, cfg.vocab, 4 + args.steps + PROFILED_STEPS)
    rt = Runtime()
    kinds = ("int8", "bf16")
    steps = {}
    for kind in kinds:
        c = dataclasses.replace(cfg, kv_cache_int8=kind == "int8")
        cache = init_cache(c, 1, cs.SERVE_MAX_LEN, device=dev)
        start = 0
        for n in chunks:
            forward(params, c, rt, torch.tensor(
                [prompt[start:start + n].tolist()], device=dev),
                mode="prefill", cache=cache, cache_pos=start)
            start += n
        step_no = [0]

        def step(_i, c=c, cache=cache, step_no=step_no):
            i = step_no[0]
            step_no[0] += 1
            pos = torch.tensor([n_prompt + i], dtype=torch.int32,
                               device=dev)
            forward(params, c, rt, torch.tensor([[int(forced[i])]],
                                                device=dev),
                    mode="decode", cache=cache, cache_pos=pos)
        step(0)
        step(1)
        steps[kind] = step
    # the host's speed drifts within a call: the two caches' steps and
    # parts alternate (int8, bf16, bf16, int8, ...) and medians are kept
    ms = {k: [] for k in kinds}
    parts = {k: [] for k in kinds}
    for i in range(args.steps):
        for kind in kinds if i % 2 == 0 else kinds[::-1]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            steps[kind](i)
            torch.cuda.synchronize()
            ms[kind].append((time.perf_counter() - t) * 1e3)
            if i < PART_ROUNDS:
                parts[kind].append(_layer_parts(cfg, dev, kind == "int8"))
    _profile(steps["int8"], 1)                # the first session, unread
    res = {}
    for kind in kinds:
        ops.launches.clear()
        prof = _profile(steps[kind], PROFILED_STEPS)
        prof.update(step_ms=float(np.median(ms[kind])),
                    step_ms_all=ms[kind],
                    launches={k: v / PROFILED_STEPS
                              for k, v in ops.launches.items()})
        for p in ("write", "decode"):
            for i, w in enumerate(("host", "device")):
                prof[f"{p}_{w}_us"] = float(np.median(
                    [r[p][i] for r in parts[kind]]))
        res[kind] = prof
    pair = np.array(ms["int8"]) - np.array(ms["bf16"])
    a, b = res["int8"], res["bf16"]
    res["int8_minus_bf16"] = dict(
        step_ms=a["step_ms"] - b["step_ms"],
        step_ms_paired=float(np.median(pair)),
        wall_us=a["wall_us"] - b["wall_us"],
        busy_us=a["busy_us"] - b["busy_us"],
        kernels=a["kernels"] - b["kernels"],
        device=_diff(a["device"], b["device"]),
        host=_diff(a["host"], b["host"]))
    res.update(card=card, layers=args.layers, steps=args.steps)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    d = res["int8_minus_bf16"]
    parts = ("write_host_us", "write_device_us", "decode_host_us",
             "decode_device_us")
    for kind in ("int8", "bf16"):
        r = res[kind]
        print(f"# {kind}: decode step {r['step_ms']:.3f} ms (host clock, "
              f"median of {args.steps}); under the profiler wall "
              f"{r['wall_us']:.1f} us, device busy {r['busy_us']:.1f} us "
              f"({r['share']:.1f} %), {r['kernels']:.1f} kernels a step; a "
              f"layer's cache write {r['write_host_us']:.1f} us host, "
              f"{r['write_device_us']:.2f} us device; its decode call "
              f"{r['decode_host_us']:.1f} us host, "
              f"{r['decode_device_us']:.2f} us device")
    host = args.layers * sum(a[p] - b[p] for p in parts[::2])
    print(f"# int8 - bf16: {d['step_ms']:.3f} ms a step (median of the "
          f"paired differences {d['step_ms_paired']:.3f}), busy "
          f"{d['busy_us']:.1f} us, {d['kernels']:.1f} kernels a step; the "
          f"writes' and decode calls' host time x {args.layers} layers "
          f"{host:+.1f} us")
    for what in ("device", "host"):
        for k, (x, y, z, nx, ny) in list(d[what].items())[:12]:
            print(f"#   {what} {z:+9.1f} us ({x:.1f} vs {y:.1f}; x{nx:.1f} "
                  f"vs x{ny:.1f})  {k[:80]}")
    print(card)
    print(json.dumps(dict(
        card=card, layers=args.layers, layers_host_diff_us=host,
        step_ms_paired_diff=d["step_ms_paired"],
        **{f"{k}_{m}": res[k][m] for k in ("int8", "bf16")
           for m in ("step_ms", "wall_us", "busy_us", "share", "kernels")
           + parts})), flush=True)


if __name__ == "__main__":
    main()
