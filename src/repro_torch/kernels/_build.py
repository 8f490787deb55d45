"""Build the port's CUDA kernels from the sources in ``csrc/`` at first use.

``nvcc`` compiles each source of ``csrc/`` (the select, ``select.cu`` (one
warp a lane up to 256 slots, a CTA a lane above), the
event-blocked replay megakernel, ``replay_block_sm90.cu`` (one warp a lane,
pools of up to 256 slots) and ``replay_block.cu`` (larger pools), the
legacy scorer,
``fitscore.cu``, the attention kernels,
``flash_attention_sm90.cu`` (tensor cores, bf16 at hd 64 / 128 / 192 /
256), ``flash_attention.cu`` (CUDA cores, every other call),
``decode_attention.cu`` (bf16 on the tensor cores, fp32 on the CUDA
cores), ``latent_attention_sm90.cu`` (the absorbed MLA's attention over
its latent rows on the tensor cores, bf16) and ``latent_attention.cu`` (the
same on the CUDA cores, every other call), and the
chunked linear attention of RWKV6 and of hymba's SSD heads,
``rwkv6_chunked.cu``) for Hopper
(``sm_90a``), one compiler process per source, all started together, and
links the objects into one shared library with a plain C interface, which
``ctypes`` loads.  The library is named by a hash of its sources and flags
and written to ``_build/`` beside this file (listed in ``.gitignore``), so
an edited source rebuilds and an unchanged one is reused.  Nothing is built
when the module is imported.

Flags: ``-O3``, and ``--fmad=false`` for the four placement sources:
contraction is off there so that the score and capacity arithmetic round
once per operation, as the JAX package's select does (and as the legacy
scorer's plain version does); the select's l2 norm's FMA chain is written
out with ``fmaf`` in the source.  The attention and RWKV6
kernels are held to a tolerance, not bit for bit, and keep contraction on.

``flash_attention_sm90.cu``, ``latent_attention_sm90.cu`` and
``rwkv6_chunked.cu`` encode their TMA tensor maps with the driver's
``cuTensorMapEncodeTiled``, which they reach through the runtime's
``cudaGetDriverEntryPoint`` (``tma_common.cuh``): the library links no
``libcuda``.  The two tensor-core attention kernels share their ``wgmma``
helpers (``wgmma_common.cuh``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
# source -> the flags it takes beside NVCC_FLAGS
SOURCES = {"select.cu": ("--fmad=false",),
           "replay_block_sm90.cu": ("--fmad=false",),
           "replay_block.cu": ("--fmad=false",),
           "fitscore.cu": ("--fmad=false",),
           "flash_attention_sm90.cu": (), "flash_attention.cu": (),
           "decode_attention.cu": (), "latent_attention_sm90.cu": (),
           "latent_attention.cu": (), "rwkv6_chunked.cu": ()}
HEADERS = ("fitscore_common.cuh", "replay_common.cuh", "warp_select.cuh",
           "tma_common.cuh", "wgmma_common.cuh")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(repr((NVCC_FLAGS, SOURCES)).encode())
    for name in (*SOURCES, *HEADERS):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"libfitscore_{h.hexdigest()[:16]}.so")


def build() -> tuple:
    """Compile the library unless it exists; returns (path, build seconds,
    the compiler's report: ptxas registers, spills, shared memory), with 0.0
    seconds and an empty report when it was already built."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        t0 = time.perf_counter()
        objs, procs = [], []
        for src, flags in SOURCES.items():
            obj = os.path.join(tmpdir, src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *flags, "-I", CSRC, "-c", "-o", obj,
                   os.path.join(CSRC, src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        report = []
        for cmd, proc in procs:
            out = proc.communicate()[0]
            report.append(out)
            if proc.returncode != 0:
                for _, other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        tmp = os.path.join(tmpdir, "lib.so")
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, path)   # atomic: a concurrent builder sees all or none
    return path, time.perf_counter() - t0, "".join(report)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    path = build()[0]
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fitscore_select_launch.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.fitscore_select_launch.restype = i
    ll, f = ctypes.c_longlong, ctypes.c_float
    lib.fitscore_replay_block_launch.argtypes = \
        [p] * 14 + [ll] * 3 + [i] * 12 + [f] * 3 + [i, p]
    lib.fitscore_replay_block_launch.restype = i
    lib.fitscore_replay_block_warp_launch.argtypes = \
        lib.fitscore_replay_block_launch.argtypes
    lib.fitscore_replay_block_warp_launch.restype = i
    lib.fitscore_replay_block_warp_smem_bytes.argtypes = [i] * 4
    lib.fitscore_replay_block_warp_smem_bytes.restype = i
    lib.fitscore_replay_block_warp_smem_max.argtypes = []
    lib.fitscore_replay_block_warp_smem_max.restype = i
    lib.fitscore_legacy_blocks.argtypes = [i]
    lib.fitscore_legacy_blocks.restype = i
    lib.fitscore_legacy_launch.argtypes = [p] * 8 + [i] * 4 + [p]
    lib.fitscore_legacy_launch.restype = i
    lib.fitscore_empty_launch.argtypes = [i, p]
    lib.fitscore_empty_launch.restype = i
    lib.flash_attention_launch.argtypes = [p] * 8 + [i] * 6 + [f] * 2 + \
        [i] * 4 + [p]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_sm90_launch.argtypes = [p] * 6 + [i] * 6 + \
        [f] * 2 + [i] * 3 + [p]
    lib.flash_attention_sm90_launch.restype = i
    lib.flash_attention_sm90_smem_bytes.argtypes = [i]
    lib.flash_attention_sm90_smem_bytes.restype = i
    lib.decode_attention_launch.argtypes = [p] * 10 + [i] * 5 + [f] * 2 + \
        [i] * 5 + [p]
    lib.decode_attention_launch.restype = i
    lib.decode_attention_smem_bytes.argtypes = [i] * 4
    lib.decode_attention_smem_bytes.restype = i
    lib.latent_attention_launch.argtypes = [p] * 8 + [i] * 6 + [f] + \
        [i] * 4 + [p]
    lib.latent_attention_launch.restype = i
    lib.latent_attention_smem_bytes.argtypes = [i] * 2
    lib.latent_attention_smem_bytes.restype = i
    lib.latent_attention_tc_launch.argtypes = [p] * 5 + [i] * 6 + [f] + \
        [i] * 2 + [p]
    lib.latent_attention_tc_launch.restype = i
    lib.latent_attention_tc_smem_bytes.argtypes = []
    lib.latent_attention_tc_smem_bytes.restype = i
    lib.latent_attention_tc_max_clusters.argtypes = [i] * 2
    lib.latent_attention_tc_max_clusters.restype = i
    lib.rwkv6_chunked_launch.argtypes = [p] * 8 + [i] * 9 + [p]
    lib.rwkv6_chunked_launch.restype = i
    for fn in (lib.rwkv6_chunked_window, lib.rwkv6_chunked_col_block):
        fn.argtypes, fn.restype = [], i
    lib.rwkv6_chunked_smem_bytes.argtypes = [i]
    lib.rwkv6_chunked_smem_bytes.restype = i
    lib.fitscore_error_string.argtypes = [i]
    lib.fitscore_error_string.restype = ctypes.c_char_p
    return lib
