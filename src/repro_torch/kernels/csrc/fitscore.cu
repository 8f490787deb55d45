// The legacy single-pool scorer of the DVBP placement, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fitscore.py::fitscore
// (fitscore.py:154, kernel body _kernel).  One arriving item against the N
// bins of one pool: feasibility (after = remaining - item >= -EPS on every
// dim, and alive), the residual score of every bin (the l1, l2 or l_inf norm
// of `after`, or for first_fit the bin's opening order; +inf where
// infeasible) and the chosen bin, the lexicographic (score, open_seq, row)
// minimum over the feasible bins, or -1.  Plain version:
// repro_torch/kernels/legacy.py::fitscore_ref, the same op order (sums over
// the dims left to right, the l2 sum as q + a*a rounded twice, a correctly
// rounded sqrt; built with --fmad=false), held equal to this kernel bit for
// bit on the card.
//
// What bounds it: bytes.  Each bin is read once (d floats, alive, open_seq)
// and its score written once, a few fp32 operations per dim in between:
// 29 bytes a bin at d = 5 against ~20 operations, far under the card's
// 20 operations a byte.  At 4096 bins that is 0.12 MB, well below a
// launch's latency; at 2^20 bins, 30 MB, ~9 us at 3.35 TB/s.
//
// Design (simple and right first): pass 1 is a grid-stride loop, one thread
// a bin, 256 threads a CTA and at most kMaxBlocks CTAs; each thread writes
// its bins' scores and keeps its best candidate in registers, and each CTA
// reduces its candidates (warp shuffles, then shared memory) into one
// per-CTA partial.  Pass 2, one CTA, reduces the partials and writes the
// chosen row.  The TPU kernel's running argmin over tiles in order becomes
// this two-pass reduction: rows are unique, so the lexicographic minimum is
// one element whatever order the reduction takes, and the result is
// deterministic.  The rows are read as the (N, d) row-major array they are,
// without the TPU's padding of d to 128 lanes.
//
// Launched through a plain C interface (ctypes), on the caller's stream; it
// allocates nothing (the wrapper passes the partials' scratch) and does not
// synchronise.
#include <cmath>

#include "fitscore_common.cuh"

namespace fitscore {

constexpr float LEGACY_EPS = 1e-9f;
constexpr float LEGACY_BIG = 3.0e38f;
constexpr int kLegacyThreads = 256;
constexpr int kLegacyWarps = kLegacyThreads / 32;
constexpr int kMaxBlocks = 1024;

// Norm codes, in the order of NORMS (repro_torch/kernels/legacy.py).
enum Norm : int {
  NORM_L1 = 0,
  NORM_L2 = 1,
  NORM_LINF = 2,
  NORM_FIRST_FIT = 3,
};

__device__ __forceinline__ Cand no_legacy_cand() {
  return Cand{INFINITY, IBIG, IBIG};
}

// Lexicographic minimum of every thread's candidate of the CTA (valid in
// thread 0).
__device__ __forceinline__ Cand block_lex_min(Cand c, Cand* sh) {
  c = warp_lex_min(c);
  const int tid = threadIdx.x;
  if ((tid & 31) == 0) sh[tid / 32] = c;
  __syncthreads();
  if (tid == 0)
    for (int w = 1; w < kLegacyWarps; ++w)
      if (lex_less(sh[w], c)) c = sh[w];
  return c;
}

__global__ void __launch_bounds__(kLegacyThreads)
legacy_score_kernel(const float* __restrict__ remaining,  // (N, d)
                    const uint8_t* __restrict__ alive,    // (N,) bool
                    const float* __restrict__ item,       // (d,)
                    const int* __restrict__ open_seq,     // (N,) or null
                    float* __restrict__ scores,           // (N,)
                    Cand* __restrict__ partial,           // (gridDim.x,)
                    int N, int d, int norm) {
  Cand best = no_legacy_cand();
  const int stride = gridDim.x * kLegacyThreads;
  for (int r = blockIdx.x * kLegacyThreads + threadIdx.x; r < N;
       r += stride) {
    const float* row = remaining + static_cast<long long>(r) * d;
    const int os = open_seq != nullptr ? open_seq[r] : r;
    bool ok = alive[r] != 0;
    float acc = 0.0f;
    float mx = -INFINITY;
    for (int k = 0; k < d; ++k) {
      const float a = row[k] - item[k];
      ok = ok && a >= -LEGACY_EPS;
      if (norm == NORM_L1) {
        acc = acc + a;
      } else if (norm == NORM_L2) {
        acc = acc + a * a;
      } else if (norm == NORM_LINF) {
        mx = k == 0 ? a : fmaxf(mx, a);
      }
    }
    float s;
    if (norm == NORM_L1) {
      s = acc;
    } else if (norm == NORM_L2) {
      s = __fsqrt_rn(acc);
    } else if (norm == NORM_LINF) {
      s = mx;
    } else {
      s = static_cast<float>(os);
    }
    s = ok ? s : LEGACY_BIG;
    scores[r] = s >= LEGACY_BIG ? INFINITY : s;
    if (s < LEGACY_BIG) {
      const Cand c{s, os, r};
      if (lex_less(c, best)) best = c;
    }
  }
  __shared__ Cand sh[kLegacyWarps];
  best = block_lex_min(best, sh);
  if (threadIdx.x == 0) partial[blockIdx.x] = best;
}

__global__ void __launch_bounds__(kLegacyThreads)
legacy_reduce_kernel(const Cand* __restrict__ partial, int n_partial,
                     int* __restrict__ best_row) {
  Cand best = no_legacy_cand();
  for (int i = threadIdx.x; i < n_partial; i += kLegacyThreads)
    if (lex_less(partial[i], best)) best = partial[i];
  __shared__ Cand sh[kLegacyWarps];
  best = block_lex_min(best, sh);
  if (threadIdx.x == 0) *best_row = best.row < IBIG ? best.row : -1;
}

}  // namespace fitscore

extern "C" {

// The number of pass-1 CTAs for N bins: the size of the partials' scratch
// (12 bytes each) the wrapper allocates.
int fitscore_legacy_blocks(int N) {
  using namespace fitscore;
  const int blocks = (N + kLegacyThreads - 1) / kLegacyThreads;
  return blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

// Scores N bins and chooses one on `stream` of card `device`; returns the
// cudaError_t of the launches (0 on success).
int fitscore_legacy_launch(const void* remaining, const void* alive,
                           const void* item, const void* open_seq,
                           void* scores, void* partial, void* best, int N,
                           int d, int norm, int device, void* stream) {
  using namespace fitscore;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = fitscore_legacy_blocks(N);
  legacy_score_kernel<<<blocks, kLegacyThreads, 0, s>>>(
      static_cast<const float*>(remaining),
      static_cast<const uint8_t*>(alive), static_cast<const float*>(item),
      static_cast<const int*>(open_seq), static_cast<float*>(scores),
      static_cast<Cand*>(partial), N, d, norm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  legacy_reduce_kernel<<<1, kLegacyThreads, 0, s>>>(
      static_cast<const Cand*>(partial), blocks, static_cast<int*>(best));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
