// Device functions shared by the placement kernels of the DVBP replay (the
// select, select.cu, and the event-blocked megakernel, replay_block.cu):
// feasibility, the policy scores and the block-wide lexicographic (score,
// open_seq, row) argmin.  The rounding follows the JAX package's jitted select
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

// Score of a feasible slot under a score policy (lower is better).  For
// NRT_PRIORITIZED the score is |gap| and `case_b` says the slot is in case
// (b) (gap < 0), which ranks after every case-(a) slot.  `access_seq` and
// `closes` are read only by the policies that need them.
template <typename ASeq, typename Closes>
__device__ __forceinline__ float policy_score(int policy,
                                              const float (&l)[DPAD],
                                              const float (&sz)[DPAD],
                                              const float (&dm)[DPAD], int os,
                                              ASeq access_seq, Closes closes,
                                              float t, float pd,
                                              bool& case_b) {
  case_b = false;
  switch (policy) {
    case FIRST_FIT:
      return static_cast<float>(os);
    case MRU:
      return -static_cast<float>(access_seq());
    case GREEDY:
      return -fmaxf(closes(), t);
    case NRT_STANDARD:
      return fabsf(fmaxf(closes(), t) - pd);
    case NRT_PRIORITIZED: {
      const float gap = fmaxf(closes(), t) - pd;
      case_b = !(gap >= 0.0f);
      return case_b ? -gap : gap;
    }
    default:
      return best_fit_score(policy, l, sz, dm);
  }
}

// Per-warp partials of a block-wide select (shared memory).
template <int kWarps>
struct SelectScratch {
  Cand a[kWarps];
  Cand b[kWarps];
  int free_row[kWarps];
};

// Block-wide select: reduces every thread's case-(a) / case-(b) candidates
// and lowest free row.  Every thread of the block must call it (it holds a
// __syncthreads); the outcome is valid in thread 0 only: (slot, found,
// no_free) with the semantics of the JAX package's select - the best
// case-(a) slot, else the best case-(b) slot, else the first free slot,
// else slot 0 with no_free.
template <int kWarps>
__device__ __forceinline__ void block_select(SelectScratch<kWarps>& sh,
                                             Cand ca, Cand cb, int free_row,
                                             int& slot, bool& found,
                                             bool& no_free) {
  ca = warp_lex_min(ca);
  cb = warp_lex_min(cb);
  free_row = warp_min(free_row);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  if ((tid & 31) == 0) {
    sh.a[warp] = ca;
    sh.b[warp] = cb;
    sh.free_row[warp] = free_row;
  }
  __syncthreads();
  if (tid != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    if (lex_less(sh.a[w], ca)) ca = sh.a[w];
    if (lex_less(sh.b[w], cb)) cb = sh.b[w];
    free_row = min(free_row, sh.free_row[w]);
  }
  const bool found_a = ca.score < SCORE_BIG;
  found = found_a || cb.score < SCORE_BIG;
  no_free = free_row >= IBIG;
  slot = found ? (found_a ? ca.row : cb.row) : (no_free ? 0 : free_row);
}

}  // namespace fitscore
