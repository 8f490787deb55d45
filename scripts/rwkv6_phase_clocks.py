"""Where a window's time goes inside the RWKV6 chunked kernel, on the card.

    python3 scripts/rwkv6_phase_clocks.py [S ...]

Builds a copy of ``src/repro_torch/kernels/csrc/rwkv6_chunked.cu`` with
``clock64()`` stamps between its steps (lane 0 of every warp of the first
CTA, every window) into a library of its own under the build directory,
runs it at B 1, H 32, K = V = 64, chunk 16, bf16 (the serving path's
shapes) for each S (default 511 and 2048), and prints the mean clocks of
each step over the middle windows and the warps.  The stamps cost a few
instructions each; the kernel's device time is ``chip_smoke.py``'s.  Needs
the card and nvcc; the stamps are placed by matching the source's text, so
a rewrite of a marked line fails loudly here.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

# (text in the source, the stamp placed before (-) or after (+) it, index)
STAMPS = [
    ("  if (maps) mbar_wait(smem_u32(slot + SL::bar), (ci / kWin) & 1);", "-",
     1),
    ("  if (maps) mbar_wait(smem_u32(slot + SL::bar), (ci / kWin) & 1);\n"
     "  pair_sync(pair);", "+", 2),
    ("          make_float2(f.x * ep[kL / 2].x, f.y * ep[kL / 2].y);\n  }",
     "+", 3),
    ("    if (lane < 16) bonp[hf * kL + row] = b;\n  }", "+", 4),
    ("  if (ci + kWin < n_chunks)\n"
     "    load_part(slot, maps, s, (ci + kWin) * s.L, hf, lane);", "+", 5),
    ("    if (hf == 1)\n#pragma unroll\n      for (int nt = 0; nt < 2; ++nt)",
     "-", 6),
    ("  pair_sync(pair);\n\n  // 3.", "-", 7),
    ("    const bool mine = ci < n_chunks;", "+", 0),
    ("    __syncthreads();\n    if (mine && hf == 1", "-", 8),
    ("    // 2. the recurrence over the window's chunks, in registers", "-",
     9),
    ("    if (mine) chunk_output<T, KF>(slot, s, ci, pair, hf, lane, yacc, "
     "y);", "-", 10),
    ("    if (mine) chunk_output<T, KF>(slot, s, ci, pair, hf, lane, yacc, "
     "y);", "+", 11),
]
STEPS = ["window start", "chunk entered", "tiles landed", "decays done",
         "bonus summed", "loads issued", "A partials", "A stored",
         "A v, U_n done", "recurrence start", "read-out start", "y stored"]
N_STAMPS, MAX_WINDOWS, WARPS = 12, 64, 16


def stamped_source(src: str) -> str:
    head = ("__device__ long long g_clk[%d];\n"
            "#define STAMP(p) do { if (blockIdx.x == 0 && blockIdx.y == 0 "
            "&& (threadIdx.x & 31) == 0 && w0 / kWin < %d) g_clk[((w0 / "
            "kWin) * %d + (threadIdx.x >> 5)) * %d + (p)] = clock64(); } "
            "while (0)\n" % (MAX_WINDOWS * WARPS * N_STAMPS, MAX_WINDOWS,
                             WARPS, N_STAMPS))
    src = src.replace("namespace rwkv6 {\n", "namespace rwkv6 {\n" + head, 1)
    for text, where, idx in STAMPS:
        if src.count(text) != 1:
            raise SystemExit(f"stamp {idx}: the source no longer has "
                             f"{text!r} once")
        stamp = f"STAMP({idx});"
        src = src.replace(text, (f"{stamp}\n{text}" if where == "-"
                                 else f"{text}\n{stamp}"))
    # the window's first chunk index w0 passed into chunk_products
    src = src.replace("const Src<T>& s, int ci,\n"
                      "                                               int "
                      "n_chunks,",
                      "const Src<T>& s, int ci,\n"
                      "                                               int "
                      "n_chunks, int w0,", 1)
    src = src.replace("chunk_products<T, KF, POST>(slot, us, s, ci, "
                      "n_chunks, ",
                      "chunk_products<T, KF, POST>(slot, us, s, ci, "
                      "n_chunks, w0, ", 1)
    return src + ('\nextern "C" int rwkv6_clocks(long long* out) {\n'
                  "  return (int)cudaMemcpyFromSymbol(out, rwkv6::g_clk, "
                  "sizeof(rwkv6::g_clk));\n}\n")


def main() -> None:
    import numpy as np
    import torch
    import chip_smoke
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("needs a card")
    lens = [int(a) for a in sys.argv[1:]] or [511, 2048]
    with open(os.path.join(_build.CSRC, "rwkv6_chunked.cu")) as f:
        src = stamped_source(f.read())
    out_dir = os.path.join(_build.BUILD_DIR, "clocks")
    os.makedirs(out_dir, exist_ok=True)
    cu, lib_path = (os.path.join(out_dir, n) for n in
                    ("rwkv6_clocks.cu", "librwkv6_clocks.so"))
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                          _build.CSRC, "-shared", "-o", lib_path, cu],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(res.stdout[-3000:] + res.stderr[-3000:])
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_chunked_launch.argtypes = [p] * 8 + [i] * 9 + [p]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for S in lens:
        args = chip_smoke._rwkv_inputs(gen, dev, torch.bfloat16, 1, S, 32,
                                       64, 64)
        call, _, _ = chip_smoke.parent_rwkv(lib, args, 16)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (MAX_WINDOWS * WARPS * N_STAMPS))()
        if lib.rwkv6_clocks(buf):
            raise SystemExit("reading the clocks failed")
        clk = np.array(buf, dtype=np.float64).reshape(MAX_WINDOWS, WARPS,
                                                      N_STAMPS)
        n_win = min(MAX_WINDOWS, -(-(-(-S // 16)) // 8))
        mid = clk[1:n_win - 1] if n_win > 2 else clk[:n_win]
        steps = np.diff(mid, axis=2).mean(axis=(0, 1))
        window = np.diff(clk[:n_win, 0, 0])
        print(f"S={S}: {n_win} windows of 8 chunks; mean clocks a step "
              f"(windows 1 .. {n_win - 2}, 16 warps):")
        for k in range(N_STAMPS - 1):
            print(f"  {STEPS[k]:>20} -> {STEPS[k + 1]:<20} "
                  f"{steps[k]:9.1f}")
        if len(window) > 2:
            print(f"  a window, stamp to stamp (warp 0): "
                  f"{window[1:-1].mean():.1f} clocks")


if __name__ == "__main__":
    main()
