// Device functions shared by the placement kernels of the DVBP replay:
// feasibility, the policy scores and the lexicographic (score, open_seq,
// row) comparison.  The rounding follows the JAX package's jitted select
// (repro/kernels/fitscore.py, core/jaxsim.py::_score) bit for bit:
//
//   * the file is built with --fmad=false, so `1 - loads + F32_EPS`,
//     `1 - loads - size` and the time arithmetic round once per operation;
//   * the l1 norm is a left-to-right fp32 sum over the dims;
//   * the l2 norm is an explicit FMA chain q = fmaf(a_k, a_k, q), which is
//     what XLA contracts the jitted sum of squares into on the CPU, then a
//     correctly rounded square root.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fitscore {

constexpr float SCORE_BIG = 1e30f;
constexpr float SCORE_NEG = -1e30f;
constexpr float F32_EPS = 1e-6f;
constexpr int IBIG = 1 << 30;
constexpr int DPAD = 8;   // padded resource width: two float4 per slot row

// Index in SELECT_POLICIES (repro_torch/kernels/fitscore.py).
enum Policy : int {
  FIRST_FIT = 0,
  BEST_FIT_L1 = 1,
  BEST_FIT_L2 = 2,
  BEST_FIT_LINF = 3,
  MRU = 4,
  GREEDY = 5,
  NRT_STANDARD = 6,
  NRT_PRIORITIZED = 7,
};

// One candidate slot of the argmin.
struct Cand {
  float score;
  int oseq;
  int row;
};

__device__ __forceinline__ Cand no_cand() { return Cand{SCORE_BIG, IBIG, IBIG}; }

// (score, open_seq, row) lexicographic order: score ties fall to the
// earliest-opened bin, then to the lowest row.
__device__ __forceinline__ bool lex_less(const Cand& a, const Cand& b) {
  if (a.score != b.score) return a.score < b.score;
  if (a.oseq != b.oseq) return a.oseq < b.oseq;
  return a.row < b.row;
}

// size <= 1 - loads + F32_EPS on every dim (padded dims hold zero size and
// zero load, so they always fit).
__device__ __forceinline__ bool fits(const float (&l)[DPAD],
                                     const float (&sz)[DPAD]) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < DPAD; ++k) ok = ok && (sz[k] <= (1.0f - l[k]) + F32_EPS);
  return ok;
}

// Residual norms of the best-fit policies over the real dims (dm = 1).
__device__ __forceinline__ float best_fit_score(int policy,
                                                const float (&l)[DPAD],
                                                const float (&sz)[DPAD],
                                                const float (&dm)[DPAD]) {
  if (policy == BEST_FIT_L1) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < DPAD; ++k) acc = acc + ((1.0f - l[k]) - sz[k]) * dm[k];
    return acc;
  }
  if (policy == BEST_FIT_L2) {
    float q = 0.0f;
#pragma unroll
    for (int k = 0; k < DPAD; ++k) {
      const float m = ((1.0f - l[k]) - sz[k]) * dm[k];
      q = fmaf(m, m, q);
    }
    return __fsqrt_rn(q);
  }
  float mx = SCORE_NEG;   // BEST_FIT_LINF: max over the real dims
#pragma unroll
  for (int k = 0; k < DPAD; ++k)
    mx = fmaxf(mx, dm[k] > 0.0f ? (1.0f - l[k]) - sz[k] : SCORE_NEG);
  return mx;
}

// Lexicographic minimum across one warp (result valid in lane 0).
__device__ __forceinline__ Cand warp_lex_min(Cand c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Cand o;
    o.score = __shfl_down_sync(0xffffffffu, c.score, off);
    o.oseq = __shfl_down_sync(0xffffffffu, c.oseq, off);
    o.row = __shfl_down_sync(0xffffffffu, c.row, off);
    if (lex_less(o, c)) c = o;
  }
  return c;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace fitscore
