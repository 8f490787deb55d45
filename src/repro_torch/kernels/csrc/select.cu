// The fused placement select of the DVBP replay, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fitscore.py::
// fitscore_select_batch_padded (kernel body _select_kernel).  Per lane, over
// the Np slots of its pool: feasibility (size <= 1 - loads + F32_EPS on
// every dim, AND alive, AND the category mask), one of the 8 policy scores,
// the lexicographic (score, open_seq, row) argmin over feasible slots -
// case (a) strictly before case (b) for nrt_prioritized - and the first
// free slot (counts == 0) as fallback.  Writes slot (int32), found and
// no_free (bool) per lane; without a free slot the slot is 0, as in the JAX
// package.
//
// What bounds it: one pass over the lane's slot state, at most 50 bytes
// per slot (two float4 of loads, counts, alive, open_seq, access_seq,
// closes, cmask).  At the main path's shapes (L = 28..56 lanes, Np =
// 64..256 slots) that is about a tenth of a megabyte - tens of nanoseconds
// at the card's memory rate.  A call costs its launch and the latency of
// its few dependent steps: a global load, the scores, the argmin.  The per-
// event replay launches it once an event from a CUDA graph
// (core/torchsim.py), so what is left is its time on the device.
//
// Two routes, chosen by the wrapper from the pool size alone
// (ops.select_route):
//
//   * warp (1 <= Np <= 256, every pool of the main path): one warp a lane,
//     four lanes a 128-thread CTA.  Thread i owns slots i + 32 k, k < SPT
//     (SPT = 2, 4 or 8 for up to 64, 128 or 256 slots, a template), and
//     issues every load of its slots before the first score, so a lane
//     costs one round trip to memory.  The argmin reduces by
//     __reduce_min_sync over an order-preserving key of the score, then
//     open_seq, then row, and the free row comes from __ballot_sync
//     (warp_select.cuh, shared with the replay megakernel's warp kernel):
//     no shared memory, no __syncthreads.
//   * cta (larger pools, up to the overflow ladder's MAX_BINS_CAP): one
//     256-thread CTA a lane striding over the slots; each thread keeps its
//     case-(a) and case-(b) candidates and its lowest free row, and the
//     block reduces them with warp shuffles and then through shared memory
//     (block_select, fitscore_common.cuh).  Infeasible slots skip the loads
//     read.
//
// d is padded to 8 (two float4 per slot row), not to the TPU's 128 lanes,
// and Np is the pool size exactly - the TPU's 256-slot tiling and its row
// mask are layout artifacts that do not carry over.
//
// Launched through a plain C interface (ctypes), on the caller's stream; it
// allocates nothing and does not synchronise.
#include "warp_select.cuh"

namespace fitscore {

constexpr int kCtaThreads = 256;
constexpr int kCtaWarps = kCtaThreads / 32;
constexpr int kWarpLanes = 4;   // lanes (one warp each) a CTA, warp route
constexpr int kSelectWarpMaxSlots = 256;   // ops.SELECT_WARP_MAX_SLOTS

// The warp route: one warp a lane, slots tid + 32 i, i < SPT.
template <int SPT>
__global__ void __launch_bounds__(kWarpLanes * 32)
select_warp_kernel(const float4* __restrict__ loads,  // (L, Np, 8)
                   const int* __restrict__ counts,    // (L, Np)
                   const uint8_t* __restrict__ alive,  // (L, Np) bool
                   const int* __restrict__ open_seq,  // (L, Np)
                   const int* __restrict__ access_seq,  // (L, Np)
                   const float* __restrict__ closes,  // (L, Np)
                   const float* __restrict__ size,    // (L, 8)
                   const float* __restrict__ dmask,   // (L, 8)
                   const uint8_t* __restrict__ cmask,  // (L, Np) or null
                   const float* __restrict__ pdep,    // (L,)
                   const float* __restrict__ now,     // (L,)
                   int* __restrict__ slot_out,        // (L,)
                   uint8_t* __restrict__ found_out,   // (L,) bool
                   uint8_t* __restrict__ no_free_out,  // (L,) bool
                   int L, int Np, int policy) {
  const int lane = blockIdx.x * kWarpLanes + threadIdx.x / 32;
  if (lane >= L) return;   // the whole warp: its reductions stay full
  const int tid = threadIdx.x & 31;
  const long long base = static_cast<long long>(lane) * Np;
  const bool need_aseq = policy == MRU;
  const bool need_closes = policy == GREEDY || policy == NRT_STANDARD ||
                           policy == NRT_PRIORITIZED;

  // every load first: the slots' reads are independent, so they overlap
  float4 lo[SPT], hi[SPT];
  int cnt[SPT], os[SPT], as[SPT];
  float cl[SPT];
  bool ok[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int r = tid + 32 * i;
    const long long q = base + (r < Np ? r : 0);
    cnt[i] = counts[q];
    const bool al = alive[q] != 0;
    const bool cm = cmask == nullptr || cmask[q] != 0;
    ok[i] = r < Np && al && cm;
    lo[i] = loads[2 * q];
    hi[i] = loads[2 * q + 1];
    os[i] = open_seq[q];
    as[i] = need_aseq ? access_seq[q] : 0;
    cl[i] = need_closes ? closes[q] : 0.0f;
  }
  float sz[DPAD], dm[DPAD];
#pragma unroll
  for (int k = 0; k < DPAD; ++k) {
    sz[k] = size[lane * DPAD + k];
    dm[k] = dmask[lane * DPAD + k];
  }
  const float t = now[lane];
  const float pd = pdep[lane];

  WarpCand best;
  unsigned freebits = 0u;
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int r = tid + 32 * i;
    if (r < Np && cnt[i] == 0) freebits |= 1u << i;
    const float l[DPAD] = {lo[i].x, lo[i].y, lo[i].z, lo[i].w,
                           hi[i].x, hi[i].y, hi[i].z, hi[i].w};
    bool case_b;
    const float sc = policy_score(policy, l, sz, dm, os[i],
                                  [&] { return as[i]; },
                                  [&] { return cl[i]; }, t, pd, case_b);
    best.offer(ok[i] && fits(l, sz) && sc < SCORE_BIG, case_b ? 1 : 0,
               order_key(sc), os[i], r);
  }
  int row = 0;
  const bool found = warp_argmin<true>(best, row);
  const int free_row = warp_first_free<SPT>(freebits);
  if (tid != 0) return;
  const bool no_free = free_row >= IBIG;
  slot_out[lane] = found ? row : (no_free ? 0 : free_row);
  found_out[lane] = found ? 1 : 0;
  no_free_out[lane] = no_free ? 1 : 0;
}

// The cta route: one 256-thread CTA a lane, any Np.
__global__ void __launch_bounds__(kCtaThreads)
select_cta_kernel(const float4* __restrict__ loads,     // (L, Np, 8)
                  const int* __restrict__ counts,       // (L, Np)
                  const uint8_t* __restrict__ alive,    // (L, Np) bool
                  const int* __restrict__ open_seq,     // (L, Np)
                  const int* __restrict__ access_seq,   // (L, Np)
                  const float* __restrict__ closes,     // (L, Np)
                  const float* __restrict__ size,       // (L, 8)
                  const float* __restrict__ dmask,      // (L, 8)
                  const uint8_t* __restrict__ cmask,    // (L, Np) or null
                  const float* __restrict__ pdep,       // (L,)
                  const float* __restrict__ now,        // (L,)
                  int* __restrict__ slot_out,           // (L,)
                  uint8_t* __restrict__ found_out,      // (L,) bool
                  uint8_t* __restrict__ no_free_out,    // (L,) bool
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
  for (int r = tid; r < Np; r += kCtaThreads) {
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

  __shared__ SelectScratch<kCtaWarps> sh;
  int slot;
  bool found, no_free;
  block_select(sh, ca, cb, free_row, slot, found, no_free);
  if (tid != 0) return;
  slot_out[lane] = slot;
  found_out[lane] = found ? 1 : 0;
  no_free_out[lane] = no_free ? 1 : 0;
}

}  // namespace fitscore

extern "C" {

// Launches the select for L lanes on `stream` of card `device`, on the
// warp route (route 0; 1 <= Np <= 256) or the cta route (route 1; any Np);
// returns the cudaError_t of the launch (0 on success).  cudaSetDevice is
// called only when `device` is not the calling thread's current card.
int fitscore_select_launch(const void* loads, const void* counts,
                           const void* alive, const void* open_seq,
                           const void* access_seq, const void* closes,
                           const void* size, const void* dmask,
                           const void* cmask, const void* pdep,
                           const void* now, void* slot, void* found,
                           void* no_free, int L, int Np, int policy,
                           int route, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (L < 1 || Np < 1 || (route == 0 && Np > fitscore::kSelectWarpMaxSlots) ||
      route < 0 || route > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* l4 = static_cast<const float4*>(loads);
  const auto* cn = static_cast<const int*>(counts);
  const auto* al = static_cast<const uint8_t*>(alive);
  const auto* os = static_cast<const int*>(open_seq);
  const auto* as = static_cast<const int*>(access_seq);
  const auto* cl = static_cast<const float*>(closes);
  const auto* sz = static_cast<const float*>(size);
  const auto* dm = static_cast<const float*>(dmask);
  const auto* cm = static_cast<const uint8_t*>(cmask);
  const auto* pd = static_cast<const float*>(pdep);
  const auto* nw = static_cast<const float*>(now);
  auto* so = static_cast<int*>(slot);
  auto* fo = static_cast<uint8_t*>(found);
  auto* no = static_cast<uint8_t*>(no_free);
  const auto st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    fitscore::select_cta_kernel<<<L, fitscore::kCtaThreads, 0, st>>>(
        l4, cn, al, os, as, cl, sz, dm, cm, pd, nw, so, fo, no, Np, policy);
    return static_cast<int>(cudaGetLastError());
  }
  const int grid = (L + fitscore::kWarpLanes - 1) / fitscore::kWarpLanes;
  const int threads = fitscore::kWarpLanes * 32;
  if (Np <= 64)
    fitscore::select_warp_kernel<2><<<grid, threads, 0, st>>>(
        l4, cn, al, os, as, cl, sz, dm, cm, pd, nw, so, fo, no, L, Np,
        policy);
  else if (Np <= 128)
    fitscore::select_warp_kernel<4><<<grid, threads, 0, st>>>(
        l4, cn, al, os, as, cl, sz, dm, cm, pd, nw, so, fo, no, L, Np,
        policy);
  else
    fitscore::select_warp_kernel<8><<<grid, threads, 0, st>>>(
        l4, cn, al, os, as, cl, sz, dm, cm, pd, nw, so, fo, no, L, Np,
        policy);
  return static_cast<int>(cudaGetLastError());
}

const char* fitscore_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
