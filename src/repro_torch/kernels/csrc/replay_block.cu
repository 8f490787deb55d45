// The event-blocked replay megakernel of the DVBP replay, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fitscore.py::fitscore_replay_block
// (fitscore.py:865, kernel body _replay_block_kernel).  One launch replays a
// block of T consecutive events of every lane: the departure (with PPE's
// alpha and the adaptive switch's error learning), the family's category
// update, the category-masked select and the commit, for the six kernel
// families score, cbd, hybrid, rcp, la and adaptive (REPLAY_FAMILIES in
// repro_torch/kernels/fitscore.py, whose replay_block_ref is the plain
// version: the same fp32 op sequence, held equal to this kernel on the
// card).  With the compile-time flag MIGRATE set (consolidation, the
// reference's migrate=True, fitscore.py:849-859) a MIGRATE event is the
// item's full departure without the learning updates, then the arrival on
// the post-departure state with the item's source slot kept out of the
// select's feasibility (and out of RCP's base-bin test) but not out of its
// free-slot stage; without it, MIGRATE events are no-ops and the kernel is
// the exact migration-free one.
//
// What bounds it: the events of a lane form a serial chain - each event's
// select reads the state the previous commit wrote - so a block costs T
// dependent steps per lane, each a pass over the lane's Np slots plus a
// block-wide reduction and two __syncthreads.  The bytes are small: the
// carry a block must read and write once (slot state Np x 3 rows of 32 B,
// the item and aggregate rows the events touch) plus the event streams
// (~12 B + 32 B of size per event) - a few microseconds of memory traffic
// at the main path's shapes (L = 28..56 lanes, Np = 64..128, T = 256),
// far below T serial steps of latency.
//
// Design: one CTA per lane, 256 threads looping over the block's events,
// the carry in global memory.  This is the route for pools of more than
// kWarpMaxSlots = 256 slots, up to MAX_BINS_CAP = 65536, where a lane's
// slot state (96 B a slot) outgrows shared memory; smaller pools take the
// warp kernel of replay_block_sm90.cu, which keeps the slot state and the
// event block in shared memory (ops.replay_route decides from the pool
// size).  Per event every thread reads the event's scalars; a departure is
// applied by thread 0 alone (one slot row, one item row, the family's
// aggregate rows); an arrival's family inputs are computed by every thread
// from the same state, the select is a block-wide reduction over the Np
// slots with the family's mask applied per slot, and thread 0 commits.
// __syncthreads separates the phases.  The family is a template parameter;
// the policy code and the family flags are runtime ints.  Built with
// --fmad=false, so the capacity, time and aggregate arithmetic rounds once
// per operation as in the JAX package; the l2 norm is the explicit fmaf
// chain of fitscore_common.cuh.  At the main path's pools (64-128 slots) it
// took 0.47 ms per 256-event block, 1.8-4.7 us a chained event (PERF.md
// section 6): per event two or three __syncthreads over 8 warps, thread 0
// walking the warps' partials, the carry read back from L1/L2 right after
// thread 0 wrote it, and RCP's 512-float loops on thread 0 alone.
//
// Launched through a plain C interface (ctypes), on the caller's stream; it
// allocates nothing and does not synchronise.
#include "replay_common.cuh"

namespace fitscore {

constexpr int kBlockThreads = 256;
constexpr int kBlockWarps = kBlockThreads / 32;

template <int FAM, bool MIGRATE>
__global__ void __launch_bounds__(kBlockThreads)
replay_block_kernel(const ReplayArgs a) {
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int Np = a.Np;
  float* loads = a.loads + static_cast<long long>(lane) * Np * DPAD;
  float* slotf = a.slotf + static_cast<long long>(lane) * Np * COLS;
  int* sloti = a.sloti + static_cast<long long>(lane) * Np * COLS;
  int* itemi = a.itemi + static_cast<long long>(lane) * a.R * COLS;
  float* sf = a.sf + lane * COLS;
  int* si = a.si + lane * COLS;
  float* hagg = FAM == HYBRID
      ? a.hagg + static_cast<long long>(lane) * a.R * DPAD : nullptr;
  float* ragg = FAM == RCP
      ? a.ragg + static_cast<long long>(lane) * RAGG_ROWS * DPAD
      : nullptr;
  int* ron = FAM == RCP ? a.ron + lane * KCAT * COLS : nullptr;
  const int* evi = a.evi + lane * a.ev_lane;
  const float* evf = a.evf + lane * a.ev_lane;
  const float* evsize = a.size + lane * a.size_lane;
  const long long P = a.ev_plane;

  float dm[DPAD];
#pragma unroll
  for (int k = 0; k < DPAD; ++k) dm[k] = a.dmask[lane * DPAD + k];

  __shared__ SelectScratch<kBlockWarps> sh;
  __shared__ int sh_conv;   // rcp: this arrival converted the base bin

  for (int e = 0; e < a.T; ++e) {
    const int kind = evi[e];
    const bool mig = MIGRATE && kind == MIGRATION;
    if (kind != ARRIVAL && kind != DEPARTURE && !mig) continue;   // PAD
    const int j = evi[P + e];
    const float t = evf[e];
    const float pd = evf[P + e];
    float sz[DPAD];
#pragma unroll
    for (int k = 0; k < DPAD; ++k) sz[k] = evsize[e * DPAD + k];
    int* irow = itemi + static_cast<long long>(j) * COLS;

    // ------------------------------------------------------ departure
    // (a MIGRATE's too: then without the learning updates, and its arrival
    // below must not pick the source slot `excl`)
    int excl = -1;
    if (kind == DEPARTURE || mig) {
      if (mig) excl = irow[ITEMI_PLACE];
      if (tid == 0) {
        const int b = irow[ITEMI_PLACE];
        int* srow = sloti + b * COLS;
        float* frow = slotf + b * COLS;
        float* lrow = loads + b * DPAD;
        const int cnt = srow[SLOTI_COUNTS] - 1;
        const bool closing = cnt == 0;
        if (closing) sf[SF_USAGE] = sf[SF_USAGE] + (t - frow[SLOTF_OPEN_TIME]);
#pragma unroll
        for (int k = 0; k < DPAD; ++k)
          lrow[k] = closing ? 0.0f : lrow[k] - sz[k];
        srow[SLOTI_COUNTS] = cnt;
        if (closing) {
          srow[SLOTI_ALIVE] = 0;
          frow[SLOTF_CLOSES] = SCORE_NEG;
        }
        if (FAM == HYBRID) {
          const bool wasg = irow[ITEMI_AUX] > 0;
          float* hrow = hagg + static_cast<long long>(evi[2 * P + e]) * DPAD;
#pragma unroll
          for (int k = 0; k < DPAD; ++k)
            hrow[k] = fmaxf(hrow[k] - (wasg ? sz[k] : 0.0f), 0.0f);
        } else if (FAM == RCP) {
          const int catj = evi[2 * P + e];
          const int locd = irow[ITEMI_AUX];
          const int base = si[SI_BASE];
          float* gen = ragg + catj * DPAD;
          float* cat = ragg + (KCAT + catj) * DPAD;
          float* brow = ragg + RAGG_BASE * DPAD;
          float* bcat = ragg + 2 * KCAT * DPAD;
          float cmax = 0.0f;
#pragma unroll
          for (int k = 0; k < DPAD; ++k) {
            gen[k] = fmaxf(gen[k] - (locd == LOC_G ? sz[k] : 0.0f), 0.0f);
            cat[k] = fmaxf(cat[k] - (locd == LOC_C ? sz[k] : 0.0f), 0.0f);
            cmax = k == 0 ? cat[k] : fmaxf(cmax, cat[k]);
          }
          if (locd == LOC_C && ron[catj * COLS] != 0 && cmax < 0.5f)
            ron[catj * COLS] = 0;
          const bool base_closed = closing && base >= 0 && b == base;
#pragma unroll
          for (int k = 0; k < DPAD; ++k) {
            const float szb = locd == LOC_B ? sz[k] : 0.0f;
            brow[k] = base_closed ? 0.0f : fmaxf(brow[k] - szb, 0.0f);
            bcat[catj * DPAD + k] = fmaxf(bcat[catj * DPAD + k] - szb, 0.0f);
          }
          if (base_closed) {
            for (int i = 0; i < KCAT * DPAD; ++i) bcat[i] = 0.0f;
            si[SI_BASE] = -1;
          }
          if (a.adaptive_alpha && !mig)
            sf[SF_ALPHA] = fmaxf(sf[SF_ALPHA], evf[2 * P + e]);
        } else if (FAM == ADAPTIVE && !mig) {
          sf[SF_ERR] = fmaxf(sf[SF_ERR], evf[2 * P + e]);
        }
      }
      __syncthreads();
      if (!mig) continue;
    }

    // -------------------------------------------------------- arrival
    // The family's inputs to the select, computed by every thread from the
    // same (unchanged until the commit) state.
    int policy = a.policy;
    int want = 0;              // cbd / hybrid / rcp: the tag a slot needs
    bool is_gen = false;       // hybrid
    int catj = 0;              // cbd / rcp / la: the item's class
    bool d_large = false, d_gen = false, d_cat = false, d_base = false,
         d_catf = false, has_base = false;   // rcp
    int base = -1;
    if (FAM == CBD) {
      catj = evi[2 * P + e];
      want = catj;
      policy = FIRST_FIT;
    } else if (FAM == HYBRID) {
      const int keyj = evi[2 * P + e];
      const int clsj = evi[3 * P + e];
      const float* hrow = hagg + static_cast<long long>(keyj) * DPAD;
      float norm;
      if (a.direct_sum) {
        norm = 0.0f;
#pragma unroll
        for (int k = 0; k < DPAD; ++k)
          if (k == clsj) norm = hrow[k] + sz[k];
      } else {
        norm = row_max(hrow, sz);
      }
      is_gen = norm <= evf[2 * P + e] + F32_EPS;
      want = is_gen ? clsj : a.d + keyj;
      policy = FIRST_FIT;
    } else if (FAM == RCP) {
      catj = evi[2 * P + e];
      const int x = min(max(evi[4 * P + e], 1), KCAT);
      float thr = a.rcp_rsqrt[x - 1];
      if (a.adaptive_alpha) thr = sf[SF_ALPHA] * thr;
      const bool fits_gen = row_max(ragg + catj * DPAD, sz) <= thr + F32_EPS;
      base = si[SI_BASE];
      has_base = base >= 0;
      bool base_fits = true;
      if (has_base) {
        float bl[DPAD];
#pragma unroll
        for (int k = 0; k < DPAD; ++k) bl[k] = loads[base * DPAD + k];
        base_fits = fits(bl, sz);
      }
      if (mig && base == excl) base_fits = false;   // off the base bin
      const bool is_on = ron[catj * COLS] != 0;
      d_large = a.large_bins && evi[3 * P + e] != 0;
      const bool fall = !d_large && !fits_gen;
      d_gen = !d_large && fits_gen;
      d_cat = fall && is_on;
      d_base = fall && !is_on && base_fits;
      d_catf = fall && !is_on && !base_fits;
      want = d_gen ? TAG_GENERAL
                   : d_cat ? catj : (d_base && has_base) ? TAG_BASE : TAG_NONE;
      policy = FIRST_FIT;
    } else if (FAM == LA) {
      catj = evi[2 * P + e];
      policy = BEST_FIT_LINF;
    } else if (FAM == ADAPTIVE) {
      const float err = sf[SF_ERR];
      policy = err < a.low ? NRT_PRIORITIZED
                           : err < a.high ? GREEDY : FIRST_FIT;
    }

    // the select: every thread scans its slots
    Cand ca = no_cand(), cb = no_cand();
    int free_row = IBIG;
    for (int r = tid; r < Np; r += kBlockThreads) {
      const int* srow = sloti + r * COLS;
      if (srow[SLOTI_COUNTS] == 0) free_row = min(free_row, r);
      if (!srow[SLOTI_ALIVE] || (MIGRATE && r == excl)) continue;
      const float* frow = slotf + r * COLS;
      bool in_b = false;   // la: the slot is a fallback (foreign-class) bin
      if (FAM == CBD || FAM == HYBRID || FAM == RCP) {
        if (srow[SLOTI_TAG] != want) continue;
      } else if (FAM == LA) {
        const float remt = fmaxf(frow[SLOTF_CLOSES], t) - t;
        int bincat;
        if (a.la_geometric) {
          bincat = remt < 1.0f
              ? 0 : ((__float_as_int(remt) >> 23) & 0xFF) - 126;
        } else {
          bincat = remt >= a.la_split ? 1 : 0;
        }
        const bool same = bincat == catj;
        const bool shrt = catj == 0;
        in_b = !shrt && !same;
      }
      float l[DPAD];
#pragma unroll
      for (int k = 0; k < DPAD; ++k) l[k] = loads[r * DPAD + k];
      if (!fits(l, sz)) continue;
      bool case_b;
      const Cand c{policy_score(policy, l, sz, dm, srow[SLOTI_OSEQ],
                                [&] { return srow[SLOTI_ASEQ]; },
                                [&] { return frow[SLOTF_CLOSES]; }, t, pd,
                                case_b),
                   srow[SLOTI_OSEQ], r};
      Cand& best = (case_b || in_b) ? cb : ca;
      if (lex_less(c, best)) best = c;
    }
    int b;
    bool found, no_free;
    block_select(sh, ca, cb, free_row, b, found, no_free);

    // thread 0: the shared commit, then the family's post-placement update
    if (tid == 0) {
      int* srow = sloti + b * COLS;
      float* frow = slotf + b * COLS;
      float* lrow = loads + b * DPAD;
      const int seq = si[SI_SEQ];
#pragma unroll
      for (int k = 0; k < DPAD; ++k) lrow[k] = lrow[k] + sz[k];
      srow[SLOTI_COUNTS] += 1;
      srow[SLOTI_ALIVE] = 1;
      if (!found) {
        srow[SLOTI_OSEQ] = seq;
        frow[SLOTF_OPEN_TIME] = t;
      }
      srow[SLOTI_ASEQ] = seq;
      frow[SLOTF_CLOSES] = fmaxf(found ? frow[SLOTF_CLOSES] : SCORE_NEG,
                                 fmaxf(pd, t));
      irow[ITEMI_PLACE] = b;
      si[SI_OPENED] += found ? 0 : 1;
      si[SI_OVERFLOW] |= (!found && no_free) ? 1 : 0;
      si[SI_SEQ] = seq + 1;

      if (FAM == CBD) {
        if (!found) srow[SLOTI_TAG] = want;
      } else if (FAM == HYBRID) {
        if (!found) srow[SLOTI_TAG] = want;
        float* hrow = hagg + static_cast<long long>(evi[2 * P + e]) * DPAD;
#pragma unroll
        for (int k = 0; k < DPAD; ++k)
          hrow[k] = hrow[k] + (is_gen ? sz[k] : 0.0f);
        irow[ITEMI_AUX] = is_gen ? 1 : 0;
      } else if (FAM == RCP) {
        // the reference's order (fitscore.py:754-784): the catj row of the
        // category block is read before the whole-block add and written
        // last
        float* gen = ragg + catj * DPAD;
        float* catblk = ragg + KCAT * DPAD;
        float* bcat = ragg + 2 * KCAT * DPAD;
        float* brow = ragg + RAGG_BASE * DPAD;
        const int open_tag = d_large ? TAG_LARGE
            : d_gen ? TAG_GENERAL : d_base ? TAG_BASE : catj;
        int tag1 = found ? srow[SLOTI_TAG] : open_tag;
        const bool new_base = d_base && !has_base;
        const int base_a = new_base ? b : base;
        if (new_base)
          for (int i = 0; i < KCAT * DPAD; ++i) bcat[i] = 0.0f;
        float cat_row[DPAD];
        float bmax = 0.0f;
#pragma unroll
        for (int k = 0; k < DPAD; ++k) {
          gen[k] = gen[k] + (d_gen ? sz[k] : 0.0f);
          cat_row[k] = catblk[catj * DPAD + k] +
                       ((d_cat || d_catf) ? sz[k] : 0.0f);
          bcat[catj * DPAD + k] = bcat[catj * DPAD + k] +
                                  (d_base ? sz[k] : 0.0f);
          brow[k] = (new_base ? 0.0f : brow[k]) + (d_base ? sz[k] : 0.0f);
          bmax = k == 0 ? brow[k] : fmaxf(bmax, brow[k]);
        }
        if (d_catf) ron[catj * COLS] = 1;
        irow[ITEMI_AUX] = d_gen ? LOC_G : d_base ? LOC_B
                                 : d_large ? LOC_L : LOC_C;
        const bool conv = d_base && bmax > 0.5f;
        if (conv) {
          // dom: the first category whose bcat row holds the maximum
          int dom = 0;
          float mmax = 0.0f;
          for (int r = 0; r < KCAT; ++r) {
            float m = bcat[r * DPAD];
#pragma unroll
            for (int k = 1; k < DPAD; ++k) m = fmaxf(m, bcat[r * DPAD + k]);
            if (r == 0 || m > mmax) {
              mmax = m;
              dom = r;
            }
          }
          tag1 = dom;
          ron[dom * COLS] = 1;
#pragma unroll
          for (int k = 0; k < DPAD; ++k)
            cat_row[k] = cat_row[k] + bcat[catj * DPAD + k];
          for (int i = 0; i < KCAT * DPAD; ++i) {
            catblk[i] = catblk[i] + bcat[i];
            bcat[i] = 0.0f;
          }
#pragma unroll
          for (int k = 0; k < DPAD; ++k) brow[k] = 0.0f;
        }
#pragma unroll
        for (int k = 0; k < DPAD; ++k) catblk[catj * DPAD + k] = cat_row[k];
        srow[SLOTI_TAG] = tag1;
        si[SI_BASE] = conv ? -1 : base_a;
        sh_conv = conv ? 1 : 0;
      }
    }
    __syncthreads();
    if (FAM == RCP && sh_conv) {
      // the converted base bin's items become category items
      for (int i = tid; i < a.R; i += kBlockThreads)
        if (itemi[i * COLS + ITEMI_AUX] == LOC_B)
          itemi[i * COLS + ITEMI_AUX] = LOC_C;
      __syncthreads();
    }
  }
}

template <int FAM>
cudaError_t launch(const ReplayArgs& a, int L, bool migrate,
                   cudaStream_t stream) {
  if (migrate)
    replay_block_kernel<FAM, true><<<L, kBlockThreads, 0, stream>>>(a);
  else
    replay_block_kernel<FAM, false><<<L, kBlockThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace fitscore

extern "C" {

// Launches one block of T events for L lanes on `stream` of card `device`
// (`migrate`: the kernel with the MIGRATE branch); returns the cudaError_t
// of the launch (0 on success).
int fitscore_replay_block_launch(
    void* loads, void* slotf, void* sloti, void* itemi, void* sf, void* si,
    void* hagg, void* ragg, void* ron, const void* evi, const void* evf,
    const void* size, const void* dmask, const void* rcp_rsqrt,
    long long ev_plane, long long ev_lane, long long size_lane, int L,
    int Np, int R, int T, int d, int family, int policy, int large_bins,
    int adaptive_alpha, int direct_sum, int la_geometric, int migrate,
    float la_split, float low, float high, int device, void* stream) {
  using namespace fitscore;
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
    case SCORE: err = launch<SCORE>(a, L, mig, s); break;
    case CBD: err = launch<CBD>(a, L, mig, s); break;
    case HYBRID: err = launch<HYBRID>(a, L, mig, s); break;
    case RCP: err = launch<RCP>(a, L, mig, s); break;
    case LA: err = launch<LA>(a, L, mig, s); break;
    case ADAPTIVE: err = launch<ADAPTIVE>(a, L, mig, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
