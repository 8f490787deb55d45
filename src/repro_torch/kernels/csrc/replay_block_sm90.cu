// The event-blocked replay megakernel of the DVBP replay for pools of up to
// kWarpMaxSlots = 256 slots, redesigned for Hopper (sm_90a): one warp a
// lane, the lane's slot state and the event block in shared memory.
//
// Replaces the TPU kernel repro/kernels/fitscore.py::fitscore_replay_block
// (fitscore.py:865, kernel body _replay_block_kernel :444, the MIGRATE
// branch :849-859) on the main path's pools (64 and 128 slots, 256 under
// consolidation); replay_block.cu keeps the larger pools.  It computes what
// that kernel computes, bit for bit: one launch replays a block of T
// consecutive events of every lane - the departure (with PPE's alpha and
// the adaptive switch's error learning), the family's category update, the
// category-masked select and the commit - for the six kernel families
// score, cbd, hybrid, rcp, la and adaptive, and with the compile-time flag
// MIGRATE a MIGRATE event as the item's departure without the learning
// updates, then its arrival with the source slot kept out of the select's
// feasibility (and out of RCP's base-bin test) but not out of the free-slot
// stage.  The plain version is repro_torch/kernels/fitscore.py::
// replay_block_ref, held equal to this kernel on the card.
//
// What bounds it: the events of a lane form a serial chain - each event's
// select reads the state the previous commit wrote - so a block costs T
// dependent steps a lane.  The bytes a block must move (the lane's slot
// state once each way, the rows its events name, the event streams) take a
// few microseconds at 3.35 TB/s; the chain's latency is the bound that
// binds, and the design shortens each link of it:
//
//   * One warp (one 32-thread CTA) a lane, so no __syncthreads: thread i
//     owns slots i, i + 32, ...; the argmin over (score, open_seq, row)
//     reduces by __reduce_min_sync over an order-preserving integer key of
//     the score, the lowest free row by __ballot_sync (warp_select.cuh,
//     shared with the select's warp route), and every thread gets the
//     winner; __syncwarp orders the shared-memory phases.  At L
//     lanes the grid is L one-warp CTAs; past 132 lanes the SMs hold
//     several each.
//   * The lane's slot state lives in shared memory for the whole launch,
//     column by column (loads, closes, open_time, counts, alive, open_seq,
//     access_seq, tag: 60 B a slot, 15 KB at 256 slots), staged in at the
//     start and written back at the end; so do RCP's aggregates (ragg, 6.4
//     KB) and ON flags, and the lane's scalars (sf, si) live in registers.
//     itemi and hybrid's hagg, indexed by item or key over up to R rows,
//     stay in global memory.
//   * The event streams are staged into shared memory kWarpTile = 256
//     events at a time, and the loop ends at the tile's last real event (a
//     __reduce_max_sync over the kinds): a PAD event costs a shared-memory
//     read, a MIGRATE launch its real events.
//   * The one dependent global load of an event, a departure's itemi row
//     (its slot and, for hybrid and RCP, its aux column), is prefetched for
//     every departure and migration of the tile when the tile is staged,
//     into c_place / c_aux; each commit forwards the item row it writes to
//     the tile's later events of the same item, and an RCP base conversion
//     turns LOC_B into LOC_C there as in itemi.
//   * RCP's serial loops run across the warp: the bcat zeroing and merge
//     (512 floats, 16 a thread), the dom scan over 64 categories (two a
//     thread, then two reductions), the 8-wide row updates (one dim a
//     thread).  A base conversion rewrites the LOC_B rows of itemi to
//     LOC_C; which rows those are, a bitmap in shared memory says (one bit
//     an item row, read from itemi by the launch's first conversion, kept
//     up to date by every commit after it), so only the launch's first
//     conversion reads all R rows.  The bitmap always fits: every
//     instantiation may take up to kWarpSmemMax of shared memory (the
//     sm_90 opt-in limit, ~1.5 M item rows a lane at 256 slots), and a
//     launch that needs more is refused.
//   * The select runs under a compile-time policy (switched once an
//     arrival on the warp-uniform code) with the slots a thread owns
//     (SPT = 2, 4 or 8 for up to 64, 128 or 256 slots) unrolled, so the
//     loads and scores of a thread's slots overlap.
//
// Rounding is the JAX package's: built with --fmad=false, the l2 norm the
// explicit fmaf chain of fitscore_common.cuh, every aggregate update in the
// reference's order (fitscore.py:754-784); the warp-wide maxima and the
// argmin do not depend on the reduction order.
//
// Launched through a plain C interface (ctypes), on the caller's stream; it
// allocates nothing and does not synchronise.
#include <atomic>

#include "replay_common.cuh"
#include "warp_select.cuh"

namespace fitscore {

constexpr int kWarpTile = 256;   // events staged in shared memory at a time
constexpr int kEvLane = kWarpTile / 32;   // events of a tile a thread stages
// the slot rows are staged as float4 / float2 / int4: columns in this order
static_assert(SLOTF_CLOSES == 0 && SLOTF_OPEN_TIME == 1, "slotf columns");
static_assert(SLOTI_COUNTS == 0 && SLOTI_ALIVE == 1 && SLOTI_OSEQ == 2 &&
              SLOTI_ASEQ == 3, "sloti columns");
// dynamic shared memory a CTA may take on sm_90 once opted in (227 KB)
constexpr int kWarpSmemMax = 227 * 1024;
constexpr int kMaxCards = 64;

// 4-byte words of dynamic shared memory a CTA takes: the event tile (size
// rows, kind, item, the family's int streams, t, pdep, its float streams,
// the prefetched item rows), the slot state (8 load columns and 7 more),
// and RCP's aggregates, ON flags, rsqrt table and LOC_B bitmap; each
// section starts at a multiple of 16 bytes (float4 stores).
__host__ __device__ inline int round4(int words) { return (words + 3) & ~3; }
__host__ __device__ inline int tile_words(int fam, int tile) {
  return round4(tile * (DPAD + 6 + extra_int_streams(fam) +
                        extra_float_streams(fam)));
}
__host__ __device__ inline int loc_words(int R) { return (R + 31) / 32; }
__host__ __device__ inline int warp_smem_words(int fam, int Np, int tile,
                                               int R) {
  return tile_words(fam, tile) + round4(Np * (DPAD + 7)) +
         (fam == RCP ? RAGG_ROWS * DPAD + 2 * KCAT + loc_words(R) : 0);
}

// Maximum over the 8 threads of each aligned group (one dim a thread).
__device__ __forceinline__ float max8(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 4));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return v;
}

// The lane's slot state in shared memory, column by column.
struct Slots {
  float* loads;   // [DPAD][Np]
  float* closes;
  float* otime;
  int* cnt;
  int* alive;
  int* oseq;
  int* aseq;
  int* tag;
  int Np;
};

// The select's outcome, with the JAX package's semantics: the best
// case-(a) slot, else the best case-(b) slot, else the first free slot,
// else slot 0 with no_free.
struct Pick {
  int b;
  bool found, no_free;
};

// One arrival's select for the whole warp under the compile-time policy
// POL: thread i owns slots i + 32 k, k < SPT.  A first pass reads which of
// them could take the item at all (alive, the family's tag, not the
// migrant's source) and which are free; the second scores the 32-slot
// chunks two at a time, skipping a pair no thread has a live slot in (live
// slots sit in the low rows: the free-slot stage opens the lowest), each
// pair without branches so the two slots' loads and scores overlap.  Each
// thread keeps its best (class, score, open_seq, row) - class 1, case (b)
// of NRT_PRIORITIZED and LA's fallback bins, ranks after every class-0 slot
// - and the warp's winner comes out of warp_argmin (warp_select.cuh), in
// every thread.
template <int FAM, bool MIGRATE, int SPT, int POL>
__device__ __forceinline__ Pick warp_select(
    const Slots& s, const float (&sz)[DPAD], const float (&dm)[DPAD],
    float t, float pd, int want, int catj, int excl, int la_geometric,
    float la_split) {
  constexpr bool TAGGED = FAM == CBD || FAM == HYBRID || FAM == RCP;
  constexpr bool NEED_B = POL == NRT_PRIORITIZED || FAM == LA;
  static_assert(SPT % 2 == 0 && SPT * 32 <= kWarpMaxSlots, "SPT");
  const int tid = threadIdx.x;
  unsigned okbits = 0u, freebits = 0u;
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int r = tid + 32 * i;
    const bool in = r < s.Np;
    const int q = in ? r : 0;
    const int cnt = s.cnt[q], alive = s.alive[q];
    const int tag = TAGGED ? s.tag[q] : 0;
    if (in && cnt == 0) freebits |= 1u << i;
    const bool ok = in && alive != 0 && !(MIGRATE && r == excl) &&
                    (!TAGGED || tag == want);
    if (ok) okbits |= 1u << i;
  }
  WarpCand best;
  auto consider = [&](int i) {
    const int r = tid + 32 * i;
    const int q = r < s.Np ? r : 0;
    bool ok = (okbits >> i) & 1u;
    bool in_b = false;   // la: the slot is a fallback (foreign-class) bin
    if (FAM == LA) {
      const float remt = fmaxf(s.closes[q], t) - t;
      int bincat;
      if (la_geometric) {
        bincat = remt < 1.0f
            ? 0 : ((__float_as_int(remt) >> 23) & 0xFF) - 126;
      } else {
        bincat = remt >= la_split ? 1 : 0;
      }
      in_b = catj != 0 && bincat != catj;
    }
    float l[DPAD];
#pragma unroll
    for (int k = 0; k < DPAD; ++k) l[k] = s.loads[k * s.Np + q];
    ok = ok && fits(l, sz);
    const int os = s.oseq[q];
    bool case_b;
    const float sc = policy_score(POL, l, sz, dm, os,
                                  [&] { return s.aseq[q]; },
                                  [&] { return s.closes[q]; }, t, pd,
                                  case_b);
    ok = ok && sc < SCORE_BIG;   // a candidate, as in select.cu
    best.offer(ok, (case_b || in_b) ? 1 : 0, order_key(sc), os, r);
  };
#pragma unroll
  for (int i = 0; i < SPT; i += 2) {
    if (!__any_sync(kFull, (okbits >> i) & 3u)) continue;
    consider(i);
    consider(i + 1);
  }
  Pick p;
  p.found = warp_argmin<NEED_B>(best, p.b);
  p.no_free = false;
  if (!p.found) {
    const int free_row = warp_first_free<SPT>(freebits);
    p.no_free = free_row >= IBIG;
    p.b = p.no_free ? 0 : free_row;
  }
  return p;
}

// The select under the family's policy: compile-time where the family
// fixes it, else switched once an arrival on the (warp-uniform) code.
template <int FAM, bool MIGRATE, int SPT>
__device__ __forceinline__ Pick select_policy(
    int policy, const Slots& s, const float (&sz)[DPAD],
    const float (&dm)[DPAD], float t, float pd, int want, int catj,
    int excl, int la_geometric, float la_split) {
#define FITSCORE_SELECT(POL)                                              \
  warp_select<FAM, MIGRATE, SPT, POL>(s, sz, dm, t, pd, want, catj, excl, \
                                      la_geometric, la_split)
  if constexpr (FAM == CBD || FAM == HYBRID || FAM == RCP) {
    return FITSCORE_SELECT(FIRST_FIT);
  } else if constexpr (FAM == LA) {
    return FITSCORE_SELECT(BEST_FIT_LINF);
  } else if constexpr (FAM == ADAPTIVE) {
    if (policy == NRT_PRIORITIZED) return FITSCORE_SELECT(NRT_PRIORITIZED);
    if (policy == GREEDY) return FITSCORE_SELECT(GREEDY);
    return FITSCORE_SELECT(FIRST_FIT);
  } else {
    switch (policy) {
      case FIRST_FIT: return FITSCORE_SELECT(FIRST_FIT);
      case BEST_FIT_L1: return FITSCORE_SELECT(BEST_FIT_L1);
      case BEST_FIT_L2: return FITSCORE_SELECT(BEST_FIT_L2);
      case MRU: return FITSCORE_SELECT(MRU);
      case GREEDY: return FITSCORE_SELECT(GREEDY);
      case NRT_STANDARD: return FITSCORE_SELECT(NRT_STANDARD);
      case NRT_PRIORITIZED: return FITSCORE_SELECT(NRT_PRIORITIZED);
      default: return FITSCORE_SELECT(BEST_FIT_LINF);
    }
  }
#undef FITSCORE_SELECT
}

template <int FAM, bool MIGRATE, int SPT>
__global__ void __launch_bounds__(32)
replay_warp_kernel(const ReplayArgs a) {
  constexpr bool TAGGED = FAM == CBD || FAM == HYBRID || FAM == RCP;
  constexpr bool HAS_AUX = FAM == HYBRID || FAM == RCP;
  const int NI = extra_int_streams(FAM), NF = extra_float_streams(FAM);
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int kk = tid & (DPAD - 1);   // the dim of this thread in row ops
  const int Np = a.Np;
  const int tile = min(a.T, kWarpTile);

  extern __shared__ float4 smem4[];
  float* s_size = reinterpret_cast<float*>(smem4);   // [tile][DPAD]
  int* s_kind = reinterpret_cast<int*>(s_size + tile * DPAD);
  int* s_item = s_kind + tile;
  int* s_exi = s_item + tile;                         // NI planes
  float* s_t = reinterpret_cast<float*>(s_exi + NI * tile);
  float* s_pd = s_t + tile;
  float* s_exf = s_pd + tile;                         // NF planes
  int* c_place = reinterpret_cast<int*>(s_exf + NF * tile);
  int* c_aux = c_place + tile;
  Slots sl;
  sl.Np = Np;
  sl.loads = s_size + tile_words(FAM, tile);
  sl.closes = sl.loads + DPAD * Np;
  sl.otime = sl.closes + Np;
  sl.cnt = reinterpret_cast<int*>(sl.otime + Np);
  sl.alive = sl.cnt + Np;
  sl.oseq = sl.alive + Np;
  sl.aseq = sl.oseq + Np;
  sl.tag = sl.aseq + Np;
  float* s_ragg = sl.loads + round4(Np * (DPAD + 7));   // rcp [ROWS][8]
  int* s_ron = reinterpret_cast<int*>(s_ragg + RAGG_ROWS * DPAD);
  float* s_rsqrt = reinterpret_cast<float*>(s_ron + KCAT);
  unsigned* s_locb = reinterpret_cast<unsigned*>(s_rsqrt + KCAT);
  float* const s_cat = s_ragg + KCAT * DPAD;
  float* const s_bcat = s_ragg + 2 * KCAT * DPAD;
  float* const s_brow = s_ragg + RAGG_BASE * DPAD;

  float* g_loads = a.loads + static_cast<long long>(lane) * Np * DPAD;
  float* g_slotf = a.slotf + static_cast<long long>(lane) * Np * COLS;
  int* g_sloti = a.sloti + static_cast<long long>(lane) * Np * COLS;
  int* itemi = a.itemi + static_cast<long long>(lane) * a.R * COLS;
  float* g_sf = a.sf + lane * COLS;
  int* g_si = a.si + lane * COLS;
  float* hagg = FAM == HYBRID
      ? a.hagg + static_cast<long long>(lane) * a.R * DPAD : nullptr;
  float* g_ragg = FAM == RCP
      ? a.ragg + static_cast<long long>(lane) * RAGG_ROWS * DPAD
      : nullptr;
  int* g_ron = FAM == RCP ? a.ron + lane * KCAT * COLS : nullptr;
  const int* evi = a.evi + lane * a.ev_lane;
  const float* evf = a.evf + lane * a.ev_lane;
  const float* evsize = a.size + lane * a.size_lane;
  const long long P = a.ev_plane;

  // ---------------------------------------------- stage the lane's state
  // (every load of a thread issued before its first store: one warp has
  // only its own loads in flight to cover the latency)
  {
    float4 lv[SPT][2];
    float2 fv[SPT];
    int4 iv[SPT];
    int tv[SPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int r = min(tid + 32 * i, Np - 1);
      const float4* lr = reinterpret_cast<const float4*>(g_loads + r * DPAD);
      lv[i][0] = lr[0];
      lv[i][1] = lr[1];
      fv[i] = *reinterpret_cast<const float2*>(g_slotf + r * COLS);
      iv[i] = *reinterpret_cast<const int4*>(g_sloti + r * COLS);
      tv[i] = g_sloti[r * COLS + SLOTI_TAG];
    }
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int r = tid + 32 * i;
      if (r >= Np) continue;
      const float l8[DPAD] = {lv[i][0].x, lv[i][0].y, lv[i][0].z, lv[i][0].w,
                              lv[i][1].x, lv[i][1].y, lv[i][1].z, lv[i][1].w};
#pragma unroll
      for (int k = 0; k < DPAD; ++k) sl.loads[k * Np + r] = l8[k];
      sl.closes[r] = fv[i].x;
      sl.otime[r] = fv[i].y;
      sl.cnt[r] = iv[i].x;
      sl.alive[r] = iv[i].y;
      sl.oseq[r] = iv[i].z;
      sl.aseq[r] = iv[i].w;
      sl.tag[r] = tv[i];
    }
  }
  if (FAM == RCP) {
    constexpr int kChunks = RAGG_ROWS * DPAD / 4;   // float4s of ragg
    float4 rv[(kChunks + 31) / 32];
    const float4* gr = reinterpret_cast<const float4*>(g_ragg);
#pragma unroll
    for (int m = 0; m * 32 < kChunks; ++m)
      if (tid + 32 * m < kChunks) rv[m] = gr[tid + 32 * m];
    int on[KCAT / 32];
    float rs[KCAT / 32];
#pragma unroll
    for (int m = 0; m < KCAT / 32; ++m) {
      on[m] = g_ron[(tid + 32 * m) * COLS];
      rs[m] = a.rcp_rsqrt[tid + 32 * m];
    }
#pragma unroll
    for (int m = 0; m * 32 < kChunks; ++m)
      if (tid + 32 * m < kChunks)
        reinterpret_cast<float4*>(s_ragg)[tid + 32 * m] = rv[m];
#pragma unroll
    for (int m = 0; m < KCAT / 32; ++m) {
      s_ron[tid + 32 * m] = on[m];
      s_rsqrt[tid + 32 * m] = rs[m];
    }
  }
  // rcp: the LOC_B rows of itemi as a bitmap, read at the launch's first
  // base conversion and kept up to date after it
  bool locb_ok = false;
  // the lane's scalars, in every thread's registers (uniform)
  float usage = g_sf[SF_USAGE], alpha = g_sf[SF_ALPHA], err = g_sf[SF_ERR];
  int seq = g_si[SI_SEQ], opened = g_si[SI_OPENED];
  int overflow = g_si[SI_OVERFLOW], base = g_si[SI_BASE];
  float dm[DPAD];
#pragma unroll
  for (int k = 0; k < DPAD; ++k) dm[k] = a.dmask[lane * DPAD + k];

  for (int e0 = 0; e0 < a.T; e0 += tile) {
    // ------------------------------------------------ stage a tile
    // (each thread loads its events e = tid + 32 u, u < kEvLane, plane by
    // plane, all before it stores them)
    const int n = min(tile, a.T - e0);
    int kinds[kEvLane];
#pragma unroll
    for (int u = 0; u < kEvLane; ++u) {
      const int e = tid + 32 * u;
      kinds[u] = e < n ? evi[e0 + e] : -1;
    }
    int mine = -1;
#pragma unroll
    for (int u = 0; u < kEvLane; ++u) {
      const int e = tid + 32 * u;
      if (e < n) s_kind[e] = kinds[u];
      if (kinds[u] == ARRIVAL || kinds[u] == DEPARTURE ||
          (MIGRATE && kinds[u] == MIGRATION))
        mine = e;
    }
    const int last = __reduce_max_sync(kFull, mine);
    if (last < 0) continue;   // all PAD
    {
      int items[kEvLane], xi[3][kEvLane];
      float ts[kEvLane], pds[kEvLane], xf[kEvLane];
#pragma unroll
      for (int u = 0; u < kEvLane; ++u) {
        const int e = e0 + tid + 32 * u;
        if (tid + 32 * u > last) continue;
        items[u] = evi[P + e];
        ts[u] = evf[e];
        pds[u] = evf[P + e];
#pragma unroll
        for (int p = 0; p < 3; ++p)
          if (p < NI) xi[p][u] = evi[(2 + p) * P + e];
        if (NF) xf[u] = evf[2 * P + e];
      }
      // the prefetch: each departure's and migration's item row as it
      // stands at the tile's start
      int pl[kEvLane], ax[kEvLane];
#pragma unroll
      for (int u = 0; u < kEvLane; ++u) {
        if (tid + 32 * u > last) continue;
        if (kinds[u] == DEPARTURE || (MIGRATE && kinds[u] == MIGRATION)) {
          const int* irow = itemi + static_cast<long long>(items[u]) * COLS;
          pl[u] = irow[ITEMI_PLACE];
          if (HAS_AUX) ax[u] = irow[ITEMI_AUX];
        }
      }
#pragma unroll
      for (int u = 0; u < kEvLane; ++u) {
        const int e = tid + 32 * u;
        if (e > last) continue;
        s_item[e] = items[u];
        s_t[e] = ts[u];
        s_pd[e] = pds[u];
#pragma unroll
        for (int p = 0; p < 3; ++p)
          if (p < NI) s_exi[p * tile + e] = xi[p][u];
        if (NF) s_exf[e] = xf[u];
        if (kinds[u] == DEPARTURE || (MIGRATE && kinds[u] == MIGRATION)) {
          c_place[e] = pl[u];
          if (HAS_AUX) c_aux[e] = ax[u];
        }
      }
    }
    {
      // the sizes: two float4 an event
      const float4* gs = reinterpret_cast<const float4*>(
          evsize + static_cast<long long>(e0) * DPAD);
      float4* ss = reinterpret_cast<float4*>(s_size);
      const int nc = 2 * (last + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 sv[kEvLane];
#pragma unroll
        for (int m = 0; m < kEvLane; ++m) {
          const int c = tid + 32 * (h * kEvLane + m);
          if (c < nc) sv[m] = gs[c];
        }
#pragma unroll
        for (int m = 0; m < kEvLane; ++m) {
          const int c = tid + 32 * (h * kEvLane + m);
          if (c < nc) ss[c] = sv[m];
        }
      }
    }
    __syncwarp();

    for (int e = 0; e <= last; ++e) {
      // the event's scalars, read together (one shared-memory round trip)
      const int kind = s_kind[e];
      const int j = s_item[e];
      const float t = s_t[e];
      const float pd = s_pd[e];
      const int cplace = c_place[e];   // departures and migrations only
      const int caux = HAS_AUX ? c_aux[e] : 0;
      const bool mig = MIGRATE && kind == MIGRATION;
      if (kind != ARRIVAL && kind != DEPARTURE && !mig) continue;   // PAD
      float sz[DPAD];
      {
        const float4* s4 = reinterpret_cast<const float4*>(s_size + e * DPAD);
        const float4 lo = s4[0], hi = s4[1];
        sz[0] = lo.x; sz[1] = lo.y; sz[2] = lo.z; sz[3] = lo.w;
        sz[4] = hi.x; sz[5] = hi.y; sz[6] = hi.z; sz[7] = hi.w;
      }
      const float szk = s_size[e * DPAD + kk];

      // ---------------------------------------------------- departure
      // (a MIGRATE's too: then without the learning updates, and its
      // arrival below must not pick the source slot `excl`)
      // (an item with no slot, placement -1, has nothing to leave: no
      // replay's streams depart one, and the warp skips it rather than
      // touch a row outside its pool)
      int excl = -1;
      if ((kind == DEPARTURE || mig) && cplace >= 0) {
        const int b = cplace;
        const int aux = caux;
        if (mig) excl = b;
        const int cnt = sl.cnt[b] - 1;
        const bool closing = cnt == 0;
        const float otime = sl.otime[b];
        const float lk = sl.loads[kk * Np + b];
        float* hrow = nullptr;
        float hk = 0.0f;
        int catj = 0, on = 0;
        float genk = 0.0f, catk = 0.0f, browk = 0.0f, bcatk = 0.0f;
        if (FAM == HYBRID) {
          hrow = hagg + static_cast<long long>(s_exi[e]) * DPAD;
          hk = hrow[kk];
        } else if (FAM == RCP) {
          catj = s_exi[e];
          genk = s_ragg[catj * DPAD + kk];
          catk = s_cat[catj * DPAD + kk];
          bcatk = s_bcat[catj * DPAD + kk];
          browk = s_brow[kk];
          on = s_ron[catj];
        }
        __syncwarp();
        if (closing) usage = usage + (t - otime);
        if (tid < DPAD) sl.loads[tid * Np + b] = closing ? 0.0f : lk - szk;
        if (tid == 0) {
          sl.cnt[b] = cnt;
          if (closing) {
            sl.alive[b] = 0;
            sl.closes[b] = SCORE_NEG;
          }
        }
        if (FAM == HYBRID) {
          const bool wasg = aux > 0;
          if (tid < DPAD) hrow[tid] = fmaxf(hk - (wasg ? szk : 0.0f), 0.0f);
        } else if (FAM == RCP) {
          const int locd = aux;
          const float g = fmaxf(genk - (locd == LOC_G ? szk : 0.0f), 0.0f);
          const float c = fmaxf(catk - (locd == LOC_C ? szk : 0.0f), 0.0f);
          const float cmax = max8(c);
          const bool base_closed = closing && base >= 0 && b == base;
          const float szb = locd == LOC_B ? szk : 0.0f;
          if (tid < DPAD) {
            s_ragg[catj * DPAD + tid] = g;
            s_cat[catj * DPAD + tid] = c;
            s_brow[tid] = base_closed ? 0.0f : fmaxf(browk - szb, 0.0f);
            if (!base_closed)
              s_bcat[catj * DPAD + tid] = fmaxf(bcatk - szb, 0.0f);
          }
          if (tid == 0 && locd == LOC_C && on != 0 && cmax < 0.5f)
            s_ron[catj] = 0;
          if (base_closed) {
            for (int i = tid; i < KCAT * DPAD; i += 32) s_bcat[i] = 0.0f;
            base = -1;
          }
          if (a.adaptive_alpha && !mig) alpha = fmaxf(alpha, s_exf[e]);
        } else if (FAM == ADAPTIVE && !mig) {
          err = fmaxf(err, s_exf[e]);
        }
        __syncwarp();
        if (!mig) continue;
      }
      if (kind == DEPARTURE) continue;

      // ------------------------------------------------------ arrival
      // The family's inputs to the select, computed by every thread from
      // the same (unchanged until the commit) state.
      int policy = a.policy;
      int want = 0;              // cbd / hybrid / rcp: the tag a slot needs
      bool is_gen = false;       // hybrid
      int catj = 0;              // cbd / rcp / la: the item's class
      bool d_large = false, d_gen = false, d_cat = false, d_base = false,
           d_catf = false, has_base = false;   // rcp
      float* hrow = nullptr;     // hybrid: the key's aggregate row
      float hk = 0.0f;
      if (FAM == CBD) {
        catj = s_exi[e];
        want = catj;
      } else if (FAM == HYBRID) {
        const int keyj = s_exi[e];
        const int clsj = s_exi[tile + e];
        hrow = hagg + static_cast<long long>(keyj) * DPAD;
        float h[DPAD];
#pragma unroll
        for (int k = 0; k < DPAD; ++k) h[k] = hrow[k];
        float norm;
        if (a.direct_sum) {
          norm = 0.0f;
#pragma unroll
          for (int k = 0; k < DPAD; ++k)
            if (k == clsj) norm = h[k] + sz[k];
        } else {
          norm = row_max(h, sz);
        }
#pragma unroll
        for (int k = 0; k < DPAD; ++k)
          if (k == kk) hk = h[k];
        is_gen = norm <= s_exf[e] + F32_EPS;
        want = is_gen ? clsj : a.d + keyj;
      } else if (FAM == RCP) {
        catj = s_exi[e];
        const int x = min(max(s_exi[2 * tile + e], 1), KCAT);
        float thr = s_rsqrt[x - 1];
        if (a.adaptive_alpha) thr = alpha * thr;
        const bool fits_gen = row_max(s_ragg + catj * DPAD, sz) <=
                              thr + F32_EPS;
        has_base = base >= 0;
        bool base_fits = true;
        if (has_base) {
          float bl[DPAD];
#pragma unroll
          for (int k = 0; k < DPAD; ++k) bl[k] = sl.loads[k * Np + base];
          base_fits = fits(bl, sz);
        }
        if (mig && base == excl) base_fits = false;   // off the base bin
        const bool is_on = s_ron[catj] != 0;
        d_large = a.large_bins && s_exi[tile + e] != 0;
        const bool fall = !d_large && !fits_gen;
        d_gen = !d_large && fits_gen;
        d_cat = fall && is_on;
        d_base = fall && !is_on && base_fits;
        d_catf = fall && !is_on && !base_fits;
        want = d_gen ? TAG_GENERAL
                     : d_cat ? catj
                             : (d_base && has_base) ? TAG_BASE : TAG_NONE;
      } else if (FAM == LA) {
        catj = s_exi[e];
      } else if (FAM == ADAPTIVE) {
        policy = err < a.low ? NRT_PRIORITIZED
                             : err < a.high ? GREEDY : FIRST_FIT;
      }
      const Pick pk = select_policy<FAM, MIGRATE, SPT>(
          policy, sl, sz, dm, t, pd, want, catj, excl, a.la_geometric,
          a.la_split);
      const int b = pk.b;
      const bool found = pk.found;

      // ------------------------------------------------------- commit
      const float lk = sl.loads[kk * Np + b];
      const int cnt_b = sl.cnt[b];
      const float cl_b = sl.closes[b];
      const int tag_b = TAGGED ? sl.tag[b] : 0;
      float genk = 0.0f, catk = 0.0f, bcatk = 0.0f, browk = 0.0f;
      if (FAM == RCP) {
        genk = s_ragg[catj * DPAD + kk];
        catk = s_cat[catj * DPAD + kk];
        bcatk = s_bcat[catj * DPAD + kk];
        browk = s_brow[kk];
      }
      __syncwarp();
      if (tid < DPAD) sl.loads[tid * Np + b] = lk + szk;
      if (tid == 0) {
        sl.cnt[b] = cnt_b + 1;
        sl.alive[b] = 1;
        if (!found) {
          sl.oseq[b] = seq;
          sl.otime[b] = t;
        }
        sl.aseq[b] = seq;
        sl.closes[b] = fmaxf(found ? cl_b : SCORE_NEG, fmaxf(pd, t));
        itemi[static_cast<long long>(j) * COLS + ITEMI_PLACE] = b;
      }
      opened += found ? 0 : 1;
      overflow |= (!found && pk.no_free) ? 1 : 0;
      seq = seq + 1;

      int new_aux = 0;     // hybrid / rcp: the item's aux column now
      bool conv = false;   // rcp: this arrival converted the base bin
      if (FAM == CBD) {
        if (!found && tid == 0) sl.tag[b] = want;
      } else if (FAM == HYBRID) {
        if (!found && tid == 0) sl.tag[b] = want;
        if (tid < DPAD) hrow[tid] = hk + (is_gen ? szk : 0.0f);
        new_aux = is_gen ? 1 : 0;
        if (tid == 0)
          itemi[static_cast<long long>(j) * COLS + ITEMI_AUX] = new_aux;
      } else if (FAM == RCP) {
        // the reference's order (fitscore.py:754-784): the catj row of the
        // category block is read before the whole-block add and written
        // last; one dim a thread
        const int open_tag = d_large ? TAG_LARGE
            : d_gen ? TAG_GENERAL : d_base ? TAG_BASE : catj;
        int tag1 = found ? tag_b : open_tag;
        const bool new_base = d_base && !has_base;
        const int base_a = new_base ? b : base;
        const float cat_row = catk + ((d_cat || d_catf) ? szk : 0.0f);
        const float bcj = (new_base ? 0.0f : bcatk) + (d_base ? szk : 0.0f);
        const float brn = (new_base ? 0.0f : browk) + (d_base ? szk : 0.0f);
        const float bmax = max8(brn);
        conv = d_base && bmax > 0.5f;
        if (tid < DPAD) {
          s_ragg[catj * DPAD + tid] = genk + (d_gen ? szk : 0.0f);
          s_bcat[catj * DPAD + tid] = bcj;
          s_brow[tid] = brn;
        }
        if (new_base)
          for (int i = tid; i < KCAT * DPAD; i += 32)
            if (i / DPAD != catj) s_bcat[i] = 0.0f;
        new_aux = d_gen ? LOC_G : d_base ? LOC_B : d_large ? LOC_L : LOC_C;
        if (tid == 0) {
          if (d_catf) s_ron[catj] = 1;
          itemi[static_cast<long long>(j) * COLS + ITEMI_AUX] = new_aux;
          if (locb_ok) {
            const unsigned bit = 1u << (j & 31);
            s_locb[j >> 5] = new_aux == LOC_B ? (s_locb[j >> 5] | bit)
                                              : (s_locb[j >> 5] & ~bit);
          }
        }
        if (conv) {
          __syncwarp();
          // dom: the first category whose bcat row holds the maximum
          unsigned mkey = 0u;
          int mrow = INT_MAX;
          for (int r = tid; r < KCAT; r += 32) {
            const float* row = s_bcat + r * DPAD;
            float m = row[0];
#pragma unroll
            for (int k = 1; k < DPAD; ++k) m = fmaxf(m, row[k]);
            const unsigned key = order_key(m);
            if (r == tid || key > mkey) {
              mkey = key;
              mrow = r;
            }
          }
          const unsigned top = __reduce_max_sync(kFull, mkey);
          const int dom = __reduce_min_sync(kFull,
                                            mkey == top ? mrow : INT_MAX);
          tag1 = dom;
          if (tid == 0) s_ron[dom] = 1;
          // the whole category block absorbs bcat (the catj row from its
          // updated value), bcat and the base row empty; i % 8 == kk
          for (int i = tid; i < KCAT * DPAD; i += 32) {
            s_cat[i] = (i / DPAD == catj ? cat_row : s_cat[i]) + s_bcat[i];
            s_bcat[i] = 0.0f;
          }
          if (tid < DPAD) s_brow[tid] = 0.0f;
        } else if (tid < DPAD) {
          s_cat[catj * DPAD + tid] = cat_row;
        }
        if (tid == 0) sl.tag[b] = tag1;
        base = conv ? -1 : base_a;
      }
      if (FAM == RCP) __syncwarp();   // lane 0's itemi and bitmap writes
      if (FAM == RCP && conv) {
        // the converted base bin's items become category items: the LOC_B
        // rows of itemi, from the bitmap (read from itemi at the launch's
        // first conversion)
        const int words = loc_words(a.R);
        if (!locb_ok) {
          for (int w0 = 0; w0 < words; w0 += 16) {
            int v[16];
#pragma unroll
            for (int u = 0; u < 16; ++u) {
              const int i = (w0 + u) * 32 + tid;
              v[u] = i < a.R ? itemi[static_cast<long long>(i) * COLS +
                                     ITEMI_AUX] : -1;
            }
#pragma unroll
            for (int u = 0; u < 16; ++u) {
              const unsigned m = __ballot_sync(kFull, v[u] == LOC_B);
              if (tid == u && w0 + u < words) s_locb[w0 + u] = m;
            }
          }
          locb_ok = true;
          __syncwarp();
        }
        for (int w = tid; w < words; w += 32) {
          unsigned m = s_locb[w];
          while (m) {
            const int i = w * 32 + __ffs(m) - 1;
            m &= m - 1;
            itemi[static_cast<long long>(i) * COLS + ITEMI_AUX] = LOC_C;
          }
          s_locb[w] = 0u;
        }
      }
      // forward the item row just written to the tile's later events of
      // the same item (a departure right after its arrival, a MIGRATE's
      // departure), and the conversion to every prefetched aux column
      {
        int fi[kEvLane], fa[kEvLane];
#pragma unroll
        for (int u = 0; u < kEvLane; ++u) {
          const int e2 = e + 1 + tid + 32 * u;
          fi[u] = e2 <= last ? s_item[e2] : -1;
          fa[u] = (FAM == RCP && conv && e2 <= last) ? c_aux[e2] : -1;
        }
        const int fwd_aux =
            (FAM == RCP && conv && new_aux == LOC_B) ? LOC_C : new_aux;
#pragma unroll
        for (int u = 0; u < kEvLane; ++u) {
          const int e2 = e + 1 + tid + 32 * u;
          if (fi[u] == j) {
            c_place[e2] = b;
            c_aux[e2] = fwd_aux;
          } else if (fa[u] == LOC_B) {
            c_aux[e2] = LOC_C;
          }
        }
      }
      __syncwarp();
    }
  }

  // -------------------------------------------- write the lane's state
  __syncwarp();
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int r = tid + 32 * i;
    if (r >= Np) continue;
    float4* lr = reinterpret_cast<float4*>(g_loads + r * DPAD);
    lr[0] = make_float4(sl.loads[0 * Np + r], sl.loads[1 * Np + r],
                        sl.loads[2 * Np + r], sl.loads[3 * Np + r]);
    lr[1] = make_float4(sl.loads[4 * Np + r], sl.loads[5 * Np + r],
                        sl.loads[6 * Np + r], sl.loads[7 * Np + r]);
    *reinterpret_cast<float2*>(g_slotf + r * COLS) =
        make_float2(sl.closes[r], sl.otime[r]);
    *reinterpret_cast<int4*>(g_sloti + r * COLS) =
        make_int4(sl.cnt[r], sl.alive[r], sl.oseq[r], sl.aseq[r]);
    if (TAGGED) g_sloti[r * COLS + SLOTI_TAG] = sl.tag[r];
  }
  if (FAM == RCP) {
    for (int i = tid; i < RAGG_ROWS * DPAD; i += 32) g_ragg[i] = s_ragg[i];
    for (int i = tid; i < KCAT; i += 32) g_ron[i * COLS] = s_ron[i];
  }
  if (tid == 0) {
    g_sf[SF_USAGE] = usage;
    if (FAM == RCP) g_sf[SF_ALPHA] = alpha;
    if (FAM == ADAPTIVE) g_sf[SF_ERR] = err;
    g_si[SI_SEQ] = seq;
    g_si[SI_OPENED] = opened;
    g_si[SI_OVERFLOW] = overflow;
    if (FAM == RCP) g_si[SI_BASE] = base;
  }
}

// One launch of an instantiation; its shared-memory limit is raised to
// kWarpSmemMax once a card.
template <int FAM, bool MIGRATE, int SPT>
cudaError_t launch_one(const ReplayArgs& a, int L, int bytes, int device,
                       cudaStream_t stream) {
  auto kern = replay_warp_kernel<FAM, MIGRATE, SPT>;
  static std::atomic<bool> smem_set[kMaxCards];
  if (device < 0 || device >= kMaxCards) return cudaErrorInvalidDevice;
  if (!smem_set[device].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kWarpSmemMax);
    if (err != cudaSuccess) return err;
    smem_set[device].store(true, std::memory_order_release);
  }
  kern<<<L, 32, bytes, stream>>>(a);
  return cudaGetLastError();
}

// Slots a thread: 2 up to 64 slots, 4 up to 128, 8 up to kWarpMaxSlots.
template <int FAM, bool MIGRATE>
cudaError_t launch_spt(const ReplayArgs& a, int L, int bytes, int device,
                       cudaStream_t stream) {
  if (a.Np <= 64)
    return launch_one<FAM, MIGRATE, 2>(a, L, bytes, device, stream);
  if (a.Np <= 128)
    return launch_one<FAM, MIGRATE, 4>(a, L, bytes, device, stream);
  return launch_one<FAM, MIGRATE, 8>(a, L, bytes, device, stream);
}

// The launch's shared memory in bytes (rcp: its LOC_B bitmap included).
inline int warp_smem_bytes(int fam, int Np, int T, int R) {
  return 4 * warp_smem_words(fam, Np, T < kWarpTile ? T : kWarpTile, R);
}

template <int FAM>
cudaError_t launch_warp(const ReplayArgs& a, int L, bool migrate, int device,
                        cudaStream_t stream) {
  const int bytes = warp_smem_bytes(FAM, a.Np, a.T, a.R);
  if (bytes > kWarpSmemMax) return cudaErrorInvalidValue;
  return migrate ? launch_spt<FAM, true>(a, L, bytes, device, stream)
                 : launch_spt<FAM, false>(a, L, bytes, device, stream);
}

}  // namespace fitscore

extern "C" {

// Launches one block of T events for L lanes of at most kWarpMaxSlots
// slots on `stream` of card `device` (`migrate`: the kernel with the
// MIGRATE branch); returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for a pool outside 1..kWarpMaxSlots, or for more
// than fitscore_replay_block_warp_smem_max() bytes of shared memory).  The
// arguments are fitscore_replay_block_launch's (replay_block.cu).
int fitscore_replay_block_warp_launch(
    void* loads, void* slotf, void* sloti, void* itemi, void* sf, void* si,
    void* hagg, void* ragg, void* ron, const void* evi, const void* evf,
    const void* size, const void* dmask, const void* rcp_rsqrt,
    long long ev_plane, long long ev_lane, long long size_lane, int L,
    int Np, int R, int T, int d, int family, int policy, int large_bins,
    int adaptive_alpha, int direct_sum, int la_geometric, int migrate,
    float la_split, float low, float high, int device, void* stream) {
  using namespace fitscore;
  if (Np < 1 || Np > kWarpMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const ReplayArgs a = make_replay_args(
      loads, slotf, sloti, itemi, sf, si, hagg, ragg, ron, evi, evf, size,
      dmask, rcp_rsqrt, ev_plane, ev_lane, size_lane, Np, R, T, d, policy,
      large_bins, adaptive_alpha, direct_sum, la_geometric, la_split, low,
      high);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mig = migrate != 0;
  cudaError_t err;
  switch (family) {
    case SCORE: err = launch_warp<SCORE>(a, L, mig, device, s); break;
    case CBD: err = launch_warp<CBD>(a, L, mig, device, s); break;
    case HYBRID: err = launch_warp<HYBRID>(a, L, mig, device, s); break;
    case RCP: err = launch_warp<RCP>(a, L, mig, device, s); break;
    case LA: err = launch_warp<LA>(a, L, mig, device, s); break;
    case ADAPTIVE: err = launch_warp<ADAPTIVE>(a, L, mig, device, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of one CTA of the warp kernel, in bytes, for R
// item rows, and the most a launch may take.
int fitscore_replay_block_warp_smem_bytes(int family, int Np, int T, int R) {
  return fitscore::warp_smem_bytes(family, Np, T, R);
}
int fitscore_replay_block_warp_smem_max() { return fitscore::kWarpSmemMax; }

}  // extern "C"
