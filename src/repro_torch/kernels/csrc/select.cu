// The fused placement select of the DVBP replay, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fitscore.py::
// fitscore_select_batch_padded (kernel body _select_kernel).  Per lane, over
// the Np slots of its pool: feasibility (size <= 1 - loads + F32_EPS on
// every dim, AND alive, AND the category mask), one of the 8 policy scores,
// the lexicographic (score, open_seq, row) argmin over feasible slots -
// case (a) strictly before case (b) for nrt_prioritized - and the first
// free slot (counts == 0) as fallback.  Writes (slot, found, no_free) to an
// (L, 3) int32 output; without a free slot the slot is 0, as in the JAX
// package.
//
// What bounds it: one pass over the lane's slot state, at most 50 bytes
// per slot (two float4 of loads, counts, alive, open_seq, access_seq,
// closes, cmask).  At the main path's shapes (L = 28..56 lanes, Np =
// 64..256 slots) that is well under a megabyte - a fraction of a
// microsecond at the card's memory rate, far below the cost of a launch,
// so a call costs its launch latency.
//
// Design (simple and right first): one CTA per lane, 256 threads striding
// over the slots, so any Np works, a ragged last stride included.  Each
// thread keeps its running case-(a) and case-(b) candidates and its lowest
// free row in registers; the block reduces them with warp shuffles and then
// through shared memory.  d is padded to 8 (two float4 per slot row), not
// to the TPU's 128 lanes, and Np is the pool size exactly - the TPU's 256-
// slot tiling and its row mask are layout artifacts that do not carry over.
// Infeasible slots skip the loads read.
//
// Launched through a plain C interface (ctypes), on the caller's stream; it
// allocates nothing and does not synchronise.
#include "fitscore_common.cuh"

namespace fitscore {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
select_kernel(const float4* __restrict__ loads,     // (L, Np, 8)
              const int* __restrict__ counts,       // (L, Np)
              const uint8_t* __restrict__ alive,    // (L, Np) bool
              const int* __restrict__ open_seq,     // (L, Np)
              const int* __restrict__ access_seq,   // (L, Np)
              const float* __restrict__ closes,     // (L, Np)
              const float* __restrict__ size,       // (L, 8)
              const float* __restrict__ dmask,      // (L, 8)
              const uint8_t* __restrict__ cmask,    // (L, Np) bool or null
              const float* __restrict__ pdep,       // (L,)
              const float* __restrict__ now,        // (L,)
              int* __restrict__ out,                // (L, 3)
              int Np, int policy) {
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;

  float sz[DPAD], dm[DPAD];
#pragma unroll
  for (int k = 0; k < DPAD; ++k) {
    sz[k] = size[lane * DPAD + k];
    dm[k] = dmask[lane * DPAD + k];
  }
  const float t = now[lane];
  const float pd = pdep[lane];

  Cand ca = no_cand();   // case (a); every policy but nrt_prioritized
  Cand cb = no_cand();   // case (b) of nrt_prioritized
  int free_row = IBIG;

  const long long base = static_cast<long long>(lane) * Np;
  for (int r = tid; r < Np; r += kThreads) {
    const long long i = base + r;
    if (counts[i] == 0) free_row = min(free_row, r);
    if (!alive[i] || (cmask != nullptr && !cmask[i])) continue;
    const float4 lo = loads[2 * i];
    const float4 hi = loads[2 * i + 1];
    const float l[DPAD] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    if (!fits(l, sz)) continue;
    bool case_b;
    const Cand c{policy_score(policy, l, sz, dm, open_seq[i],
                              [&] { return access_seq[i]; },
                              [&] { return closes[i]; }, t, pd, case_b),
                 open_seq[i], r};
    Cand& best = case_b ? cb : ca;
    if (lex_less(c, best)) best = c;
  }

  __shared__ SelectScratch<kWarps> sh;
  int slot;
  bool found, no_free;
  block_select(sh, ca, cb, free_row, slot, found, no_free);
  if (tid != 0) return;
  out[lane * 3 + 0] = slot;
  out[lane * 3 + 1] = found ? 1 : 0;
  out[lane * 3 + 2] = no_free ? 1 : 0;
}

}  // namespace fitscore

extern "C" {

// Launches the select for L lanes on `stream` of card `device`; returns the
// cudaError_t of the launch (0 on success).
int fitscore_select_launch(const void* loads, const void* counts,
                           const void* alive, const void* open_seq,
                           const void* access_seq, const void* closes,
                           const void* size, const void* dmask,
                           const void* cmask, const void* pdep,
                           const void* now, void* out, int L, int Np,
                           int policy, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  fitscore::select_kernel<<<L, fitscore::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(loads), static_cast<const int*>(counts),
      static_cast<const uint8_t*>(alive), static_cast<const int*>(open_seq),
      static_cast<const int*>(access_seq), static_cast<const float*>(closes),
      static_cast<const float*>(size), static_cast<const float*>(dmask),
      static_cast<const uint8_t*>(cmask), static_cast<const float*>(pdep),
      static_cast<const float*>(now), static_cast<int*>(out), Np, policy);
  return static_cast<int>(cudaGetLastError());
}

const char* fitscore_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
