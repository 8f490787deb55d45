// What the two event-blocked replay megakernels share: the packed carry's
// layout, the event codes and tags, the launch arguments, and the RCP row
// maximum.  replay_block_sm90.cu (one warp a lane, the carry in shared
// memory; the route for pools of up to kWarpMaxSlots slots) and
// replay_block.cu (one 256-thread CTA a lane, the carry in global memory;
// every larger pool) include it.
#pragma once

#include "fitscore_common.cuh"

namespace fitscore {

// Kernel families, in the order of REPLAY_FAMILIES.
enum Family : int { SCORE = 0, CBD = 1, HYBRID = 2, RCP = 3, LA = 4,
                    ADAPTIVE = 5 };

// Packed-carry columns (repro_torch/kernels/fitscore.py; a CPU test,
// tests/test_torch_replay_block.py, holds these constants to that module's).
constexpr int COLS = 8;
constexpr int SLOTF_CLOSES = 0, SLOTF_OPEN_TIME = 1;
constexpr int SLOTI_COUNTS = 0, SLOTI_ALIVE = 1, SLOTI_OSEQ = 2,
              SLOTI_ASEQ = 3, SLOTI_TAG = 4;
constexpr int ITEMI_PLACE = 0, ITEMI_AUX = 1;
constexpr int SF_USAGE = 0, SF_ALPHA = 1, SF_ERR = 2;
constexpr int SI_SEQ = 0, SI_OPENED = 1, SI_OVERFLOW = 2, SI_BASE = 3;
constexpr int KCAT = 64;
constexpr int RAGG_BASE = 3 * KCAT;
constexpr int RAGG_ROWS = RAGG_BASE + 8;
constexpr int ARRIVAL = 1, DEPARTURE = 0, MIGRATION = 2;
constexpr int TAG_GENERAL = -2, TAG_BASE = -3, TAG_LARGE = -4,
              TAG_NONE = -99;
constexpr int LOC_G = 0, LOC_B = 1, LOC_C = 2, LOC_L = 3;

// The largest slot pool the warp kernel takes (ops.REPLAY_WARP_MAX_SLOTS;
// a CPU test holds the two equal): eight slots a thread.
constexpr int kWarpMaxSlots = 256;

struct ReplayArgs {
  float* loads;      // (L, Np, 8)
  float* slotf;      // (L, Np, 8)
  int* sloti;        // (L, Np, 8)
  int* itemi;        // (L, R, 8)
  float* sf;         // (L, 8)
  int* si;           // (L, 8)
  float* hagg;       // (L, R, 8)          hybrid
  float* ragg;       // (L, RAGG_ROWS, 8) rcp
  int* ron;          // (L, KCAT, 8)       rcp
  const int* evi;    // streams (kind, item, extras...) x lanes x T
  const float* evf;  // streams (t, pdep, extras...) x lanes x T
  const float* size; // lanes x T x 8
  const float* dmask;      // (L, 8)
  const float* rcp_rsqrt;  // (KCAT,) the reference's rsqrt(x), x = 1..64
  long long ev_plane, ev_lane, size_lane;   // strides in elements
  int Np, R, T, d, policy;
  int large_bins, adaptive_alpha, direct_sum, la_geometric;
  float la_split, low, high;
};

// The family's extra event streams past (kind, item) / (t, pdep):
// REPLAY_EV_I / REPLAY_EV_F of repro_torch/kernels/fitscore.py.
__host__ __device__ inline int extra_int_streams(int fam) {
  return fam == HYBRID ? 2 : fam == RCP ? 3 : (fam == CBD || fam == LA) ? 1
                                                                       : 0;
}
__host__ __device__ inline int extra_float_streams(int fam) {
  return (fam == HYBRID || fam == RCP || fam == ADAPTIVE) ? 1 : 0;
}

__device__ __forceinline__ float row_max(const float* row,
                                         const float (&add)[DPAD]) {
  float m = row[0] + add[0];
#pragma unroll
  for (int k = 1; k < DPAD; ++k) m = fmaxf(m, row[k] + add[k]);
  return m;
}

// Fills a ReplayArgs from the launchers' plain C arguments.
inline ReplayArgs make_replay_args(
    void* loads, void* slotf, void* sloti, void* itemi, void* sf, void* si,
    void* hagg, void* ragg, void* ron, const void* evi, const void* evf,
    const void* size, const void* dmask, const void* rcp_rsqrt,
    long long ev_plane, long long ev_lane, long long size_lane, int Np,
    int R, int T, int d, int policy, int large_bins, int adaptive_alpha,
    int direct_sum, int la_geometric, float la_split, float low,
    float high) {
  ReplayArgs a;
  a.loads = static_cast<float*>(loads);
  a.slotf = static_cast<float*>(slotf);
  a.sloti = static_cast<int*>(sloti);
  a.itemi = static_cast<int*>(itemi);
  a.sf = static_cast<float*>(sf);
  a.si = static_cast<int*>(si);
  a.hagg = static_cast<float*>(hagg);
  a.ragg = static_cast<float*>(ragg);
  a.ron = static_cast<int*>(ron);
  a.evi = static_cast<const int*>(evi);
  a.evf = static_cast<const float*>(evf);
  a.size = static_cast<const float*>(size);
  a.dmask = static_cast<const float*>(dmask);
  a.rcp_rsqrt = static_cast<const float*>(rcp_rsqrt);
  a.ev_plane = ev_plane;
  a.ev_lane = ev_lane;
  a.size_lane = size_lane;
  a.Np = Np;
  a.R = R;
  a.T = T;
  a.d = d;
  a.policy = policy;
  a.large_bins = large_bins;
  a.adaptive_alpha = adaptive_alpha;
  a.direct_sum = direct_sum;
  a.la_geometric = la_geometric;
  a.la_split = la_split;
  a.low = low;
  a.high = high;
  return a;
}

}  // namespace fitscore
