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
// launch's latency; at 2^20 bins, 30 MB, ~9 us at 3.35 TB/s.  Below ~1 M
// bins the reachable floor is one launch, so the design is one launch.
//
// Design: one launch.  A CTA of 512 threads scores tiles of 512 bins, one
// a thread (each thread reads its bin's d floats, alive flag and open_seq
// key, the next tile's flag and key in flight meanwhile), writes their
// scores and keeps its best candidate; the CTA reduces them (warp
// shuffles, then one warp over the warps' minima).  Staging the rows as a
// float4 stream through shared memory measured slower at every pool size
// on the H100 (PERF.md).  The CTAs' minima meet in one of two ways:
//   * up to 8 tiles (4096 bins, the main path's pool) the grid is one
//     thread block cluster: after a cluster barrier CTA 0 reads every
//     CTA's minimum from its shared memory and writes the chosen row, with
//     no round trip through device memory;
//   * above, the grid is one wave of full SMs at most (four CTAs an SM),
//     each CTA walking its tiles; it writes its (score, open_seq, row)
//     partial, fences and counts itself on an int32 counter, and the last
//     CTA to arrive reduces the partials, writes the chosen row and resets
//     the counter to zero for the next launch (decode attention's merge).
//     The counter is the caller's, one a stream, so launches that share it
//     run in order.
// The TPU kernel's running argmin over tiles in order becomes this
// reduction: rows are unique, so the lexicographic minimum is one element
// whatever order the reduction takes, and the result is deterministic.  The
// rows are read without the TPU's padding of d to 128 lanes.
//
// Launched through a plain C interface (ctypes), on the caller's stream; it
// allocates nothing (the wrapper passes the partials' scratch and the
// counter) and does not synchronise.
#include <cooperative_groups.h>

#include <atomic>
#include <cmath>

#include "fitscore_common.cuh"

namespace fitscore {

constexpr float LEGACY_EPS = 1e-9f;
constexpr float LEGACY_BIG = 3.0e38f;
constexpr int kLegacyThreads = 512;   // bins a tile: one a thread
constexpr int kLegacyWarps = kLegacyThreads / 32;
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int kMaxBlocks = 1024;
constexpr int kBlocksPerSM = 2048 / kLegacyThreads;   // a full SM
constexpr int kMaxCards = 64;

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
// thread 0): warp shuffles, then one warp over the warps' minima.
__device__ __forceinline__ Cand block_lex_min(Cand c, Cand* sh) {
  c = warp_lex_min(c);
  const int tid = threadIdx.x;
  if ((tid & 31) == 0) sh[tid / 32] = c;
  __syncthreads();
  if (tid < 32) c = warp_lex_min(tid < kLegacyWarps ? sh[tid]
                                                    : no_legacy_cand());
  return c;
}

// CLUSTER: the grid is one cluster, whose CTAs' minima meet in CTA 0's
// shared memory; else the last CTA to count itself on `counter` reduces
// the CTAs' partials.
template <bool CLUSTER>
__global__ void __launch_bounds__(kLegacyThreads)
legacy_kernel(const float* __restrict__ remaining,  // (N, d)
              const uint8_t* __restrict__ alive,    // (N,) bool
              const float* __restrict__ item,       // (d,)
              const int* __restrict__ open_seq,     // (N,) or null
              float* __restrict__ scores,           // (N,)
              Cand* __restrict__ partial,           // (gridDim.x,)
              int* __restrict__ counter,            // zero between launches
              int* __restrict__ best_row, int N, int d, int norm) {
  __shared__ Cand sh[kLegacyWarps];
  __shared__ Cand cta_best;
  __shared__ bool last;
  const int stride = gridDim.x * kLegacyThreads;
  Cand best = no_legacy_cand();
  // a bin a thread and tile; the next tile's alive flag and open_seq key
  // are loaded while this one is scored
  int r = blockIdx.x * kLegacyThreads + threadIdx.x;
  bool ok = r < N && alive[r] != 0;
  int os = r < N && open_seq != nullptr ? open_seq[r] : r;
  for (; r < N; r += stride) {
    const int rn = r + stride;
    const bool ok_next = rn < N && alive[rn] != 0;
    const int os_next = rn < N && open_seq != nullptr ? open_seq[rn] : rn;
    const float* row = remaining + static_cast<long long>(r) * d;
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
    ok = ok_next;
    os = os_next;
  }
  const int tid = threadIdx.x;
  best = block_lex_min(best, sh);
  if constexpr (CLUSTER) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    if (tid == 0) cta_best = best;
    cluster.sync();
    if (cluster.block_rank() == 0 && tid < 32) {
      Cand c = no_legacy_cand();
      if (tid < static_cast<int>(cluster.num_blocks()))
        c = *cluster.map_shared_rank(&cta_best, tid);
      c = warp_lex_min(c);
      if (tid == 0) *best_row = c.row < IBIG ? c.row : -1;
    }
    cluster.sync();   // CTA 0 has read every CTA's minimum
    return;
  }
  if (tid == 0) {
    partial[blockIdx.x] = best;
    __threadfence();
    last = atomicAdd(counter, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last CTA: every partial is written and fenced
  __threadfence();
  best = no_legacy_cand();
  for (int i = tid; i < static_cast<int>(gridDim.x); i += kLegacyThreads) {
    const Cand p{__ldcg(&partial[i].score), __ldcg(&partial[i].oseq),
                 __ldcg(&partial[i].row)};
    if (lex_less(p, best)) best = p;
  }
  best = block_lex_min(best, sh);
  if (tid == 0) {
    *best_row = best.row < IBIG ? best.row : -1;
    *counter = 0;
  }
}

template <bool CLUSTER>
cudaError_t launch_legacy(int blocks, cudaStream_t stream,
                          const float* remaining, const uint8_t* alive,
                          const float* item, const int* open_seq,
                          float* scores, Cand* partial, int* counter,
                          int* best, int N, int d, int norm) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kLegacyThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER ? blocks : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, legacy_kernel<CLUSTER>, remaining,
                            alive, item, open_seq, scores, partial, counter,
                            best, N, d, norm);
}

__global__ void empty_kernel() {}

}  // namespace fitscore

extern "C" {

// At most as many CTAs for N bins as a launch takes (a tile of
// kLegacyThreads each, at most kMaxBlocks): the size of the partials'
// scratch (12 bytes each) the wrapper allocates.
int fitscore_legacy_blocks(int N) {
  using namespace fitscore;
  const int blocks = (N + kLegacyThreads - 1) / kLegacyThreads;
  return blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

// Scores N bins and chooses one on `stream` of card `device`, in one
// launch: up to kMaxCluster tiles a cluster of CTAs, else CTAs merged by
// their last; `counter` is an int32 that is zero between launches (the
// kernel leaves it so).  Returns the cudaError_t of the launch (0 on
// success).
int fitscore_legacy_launch(const void* remaining, const void* alive,
                           const void* item, const void* open_seq,
                           void* scores, void* partial, void* counter,
                           void* best, int N, int d, int norm, int device,
                           void* stream) {
  using namespace fitscore;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxCards)
    return static_cast<int>(cudaErrorInvalidDevice);
  // one wave of full SMs at most, each CTA walking its tiles
  static std::atomic<int> sms[kMaxCards];
  if (sms[device].load(std::memory_order_relaxed) == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[device].store(n, std::memory_order_relaxed);
  }
  const int wave = kBlocksPerSM * sms[device].load();
  const int blocks = fitscore_legacy_blocks(N) < wave
                         ? fitscore_legacy_blocks(N)
                         : wave;
  const auto launch = blocks <= kMaxCluster ? launch_legacy<true>
                                            : launch_legacy<false>;
  err = launch(blocks, static_cast<cudaStream_t>(stream),
               static_cast<const float*>(remaining),
               static_cast<const uint8_t*>(alive),
               static_cast<const float*>(item),
               static_cast<const int*>(open_seq), static_cast<float*>(scores),
               static_cast<Cand*>(partial), static_cast<int*>(counter),
               static_cast<int*>(best), N, d, norm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel's launch on `stream`: the floor one launch sets.
int fitscore_empty_launch(int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  fitscore::empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
