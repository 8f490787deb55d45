// The warp-wide argmin of the two kernels that give a lane one warp: the
// select's warp route (select.cu, select_warp_kernel) and the replay
// megakernel for pools of up to 256 slots (replay_block_sm90.cu).  Thread i
// of the warp owns slots i + 32 k; each keeps its best candidate in
// registers, and the warp's winner comes out of __reduce_min_sync in every
// thread: no shared memory and no __syncthreads.
#pragma once

#include <climits>

#include "fitscore_common.cuh"

namespace fitscore {

constexpr unsigned kFull = 0xffffffffu;

// An unsigned key that orders like the float (finite or infinite, not
// NaN), with -0 ranked as +0, as the float comparison ranks them.
__device__ __forceinline__ unsigned order_key(float f) {
  unsigned u = __float_as_uint(f);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// One thread's best candidate in (class, score key, open_seq, row) order.
// Class 1 (case (b) of NRT_PRIORITIZED, LA's fallback bins) ranks after
// every class-0 slot; class 2 means no candidate.
struct WarpCand {
  int cls = 2;
  unsigned key = ~0u;
  int oseq = 0;
  int row = 0;

  // A thread offers its slots in increasing row order, so a full tie keeps
  // the lower row.
  __device__ __forceinline__ void offer(bool ok, int c, unsigned k, int os,
                                        int r) {
    if (ok && (c < cls || (c == cls && (k < key ||
                                        (k == key && os < oseq))))) {
      cls = c;
      key = k;
      oseq = os;
      row = r;
    }
  }
};

// The warp's winner, in every thread: whether any thread has a candidate,
// and its row in `row` when one has.  Without TWO_CLASSES every candidate
// is of class 0, and the class reduction is skipped.  A candidate's score
// is below SCORE_BIG, so its key is never ~0u.
template <bool TWO_CLASSES>
__device__ __forceinline__ bool warp_argmin(const WarpCand& c, int& row) {
  int wcls = 0;
  if (TWO_CLASSES) {
    wcls = __reduce_min_sync(kFull, c.cls);
    if (wcls >= 2) return false;
  }
  const bool in1 = c.cls == wcls;
  const unsigned kmin = __reduce_min_sync(kFull, in1 ? c.key : ~0u);
  if (!TWO_CLASSES && kmin == ~0u) return false;
  const bool in2 = in1 && c.key == kmin;
  const int omin = __reduce_min_sync(kFull, in2 ? c.oseq : INT_MAX);
  row = __reduce_min_sync(kFull, (in2 && c.oseq == omin) ? c.row : INT_MAX);
  return true;
}

// The lowest free row of the warp's slots, in every thread (bit i of
// `freebits`: this thread's row tid + 32 i is free); IBIG when none is.
template <int SPT>
__device__ __forceinline__ int warp_first_free(unsigned freebits) {
  int free_row = IBIG;
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const unsigned m = __ballot_sync(kFull, (freebits >> i) & 1u);
    if (m && free_row == IBIG) free_row = i * 32 + __ffs(m) - 1;
  }
  return free_row;
}

}  // namespace fitscore
