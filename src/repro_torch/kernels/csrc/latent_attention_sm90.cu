// The absorbed MLA's attention over the latent cache (DeepSeek-V2) on
// Hopper's tensor cores, for bf16 (sm_90a: TMA, mbarrier, wgmma, thread
// block clusters).
//
// Replaces no Pallas kernel: the reference computes it in XLA
// (repro/models/attention.py::mla_attention_block with absorb=True, its
// gqa_attention call at :313), and the port's rule is that every attention
// call goes through a hand-written kernel.  The wrapper
// (kernels/ops.py::latent_launch) sends bf16 calls with D and Dv multiples
// of 8 here (ops.latent_route "tc") and the rest to the CUDA-core kernel of
// latent_attention.cu.  Semantics are that kernel's: q (B, Sq, H, D), the
// queries absorbed through W_UK, then their rope part (D = lora + r = 576
// at deepseek-v2-lite-16b's width, H = 16); lat (B, Sk, D), one latent row
// a position, K the whole row and V its first Dv columns (Dv = lora = 512);
// out (B, Sq, H, Dv) bf16.  Query i of row b sits at qpos = q_offset[b] + i
// (0 + i without q_offset) and reads the keys j <= qpos with j <
// min(kv_len[b], Sk) (Sk without kv_len).  Scores (q . k) * scale (the
// caller's); running max, denominator and accumulator in fp32; out = acc /
// max(l, 1e-30), so a query with no key gives zeros.
//
// What bounds it on this card: the latent bytes at a decode step (1152 a
// row in bf16, about 15 operations a byte at H = 16: far below the card's
// balance of ~295), the tensor cores at a long prefill (2 * pairs * H * (D
// + Dv) operations).  At the served sizes neither: a CTA takes ~2.5 us a
// 64-key tile (S over D = 576 twice, P . V, the softmax between them) and
// ~7.5 us for its first (launch, Q and the first tile in flight, the
// stores), whatever the number of CTAs streaming beside it (PERF.md),
// so the time is the number of key tiles on the longest CTA.  The design:
//
// - One CTA takes a tile of 64 rows: P = 64 / H consecutive query positions
//   of one batch row x all H heads (4 x 16 at deepseek's width), so a latent
//   row is read once for all of them.  Row r of the tile is (position i0 +
//   r / H, head r % H): the (Sq * H, D) view of q, one TMA box of 64 rows.
//   A decode step fills H of the 64 rows.
// - Warpgroup 2 is the producer (it gives its registers to the consumers by
//   setmaxnreg: 24 a thread against their 240); one thread loads Q once and
//   tiles of 64 latent rows into a ring of two stages (TMA, 128-byte
//   swizzle, full / empty mbarriers).  Q and two stages are 3 x 72 KB, so
//   one CTA an SM.  V is not loaded: it is the first Dv columns of the
//   staged K tile.  A tile that reaches past kv_len (rows that may hold
//   anything, NaN included) has those rows zeroed in shared memory before
//   either product reads it; rows past Sk are TMA's zero fill.
// - Consumer warpgroups 0 and 1 own V columns 0-255 and 256-511.  Each
//   computes S = Q . K^T itself (wgmma m64n64k16, both from shared memory,
//   K-major, D / 16 steps), runs the online softmax on the accumulator
//   fragment (the scale folded into exp2, per-row causal masks only on the
//   tiles that straddle a row's limit or the split's end), rounds P to bf16
//   in registers and uses it as the A operand of O += P . V (wgmma
//   m64n256k16, V MN-major from the same tile).  Rounding P to bf16 is the
//   one numeric difference from the plain version (about 2^-9 of each p).
//   Scoring half the keys each and exchanging P through shared memory
//   measured no faster (PERF.md), so each scores them all.
// - Splits, so that the longest CTA walks few key tiles: the grid is
//   (n_split, tiles, B) in clusters of (n_split, 1, 1), n_split <= 8 from
//   the shapes alone (ops.latent_splits: one CTA an SM).  Each CTA splits
//   its tile's visible keys [0, min(kv_len, last position + 1)) on the card
//   into n_split parts of whole 64-key tiles (ceil(tiles / n_split) each),
//   so only splits past the visible keys are empty.  The splits merge in
//   shared memory across the cluster: each keeps its partial (acc of the
//   tile's valid rows, m, l, in fp32) in its own idle K ring, and after a
//   cluster barrier every CTA of the cluster reads its share of the output
//   from the partials of the splits that read keys (distributed shared
//   memory, 16 bytes a load), so no partial goes to device memory and the
//   merge runs on all the cluster's SMs at once.  One launch a call.
//
// The tensor maps are encoded on the host for each call through the
// driver's cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint, so
// the library does not link libcuda.  Launched through a plain C interface
// (ctypes) on the caller's stream; it allocates nothing and does not
// synchronise.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "tma_common.cuh"
#include "wgmma_common.cuh"

namespace attn_lat90 {

using namespace tma;
using namespace wgmma;

constexpr int kBM = 64;                    // tile rows: positions x heads
constexpr int kBN = 64;                    // keys a tile
constexpr int kBox = 64;                   // bf16 columns of one 128 B row
constexpr int kBoxBytes = kBM * 128;       // one box of 64 rows
constexpr int kDMax = 576, kDvMax = 512, kHMax = 16;
constexpr int kBoxes = kDMax / kBox;       // boxes of a full row
constexpr int kTileBytes = kBoxBytes * kBoxes;   // 73,728
constexpr int kStages = 2;
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 128; // + the producer warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kMaxSplit = 8;               // a cluster's portable size
// Dynamic shared memory, from a 1024-byte aligned base: Q, kStages K tiles,
// then q_full, k_full and empty for each stage: 222,248 bytes.  After the
// last tile the merge reuses the K ring for the partial acc (64 x Dv fp32)
// and Q for m, l (2 x 64) and the weights (kMaxSplit x 64) and 1 / den.
constexpr int kQ = 0;
constexpr int kK = kTileBytes;
constexpr int kBar = kK + kStages * kTileBytes;
constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
static_assert(kBM * kDvMax * 4 <= kStages * kTileBytes,
              "a partial acc fits the K ring");
static_assert((2 + kMaxSplit + 1) * kBM * 4 <= kTileBytes,
              "m, l and the weights fit Q's room");

// bar.sync over the two consumer warpgroups (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// The cluster's barrier: every non-exited thread of its CTAs; the
// shared-memory writes before it are seen by the reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The address of the same shared-memory location in CTA `rank` of the
// cluster, and loads from there.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ float ld_peer(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_peer4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
latent_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const int* __restrict__ q_offset,
                   const int* __restrict__ kv_len,
                   __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                   int D, int Dv, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + kQ, sK = base + kK;
  const uint32_t bar_q = base + kBar;
  auto bar_k = [&](int st) { return bar_q + 8u * (1 + st); };
  auto bar_e = [&](int st) { return bar_q + 8u * (1 + kStages + st); };
  uint8_t* aligned = smem_raw + (base - smem_u32(smem_raw));

  const int split = blockIdx.x, b = blockIdx.z;
  const int n_split = gridDim.x;             // the cluster's size
  const int P = kBM / H;                     // positions a tile
  const int i0 = blockIdx.y * P;
  const int n_pos = min(P, Sq - i0);
  const int rows = n_pos * H;                // valid rows of the tile
  const int off = q_offset ? q_offset[b] : 0;
  const int klen = kv_len ? max(0, min(kv_len[b], Sk)) : Sk;
  const int first = off + i0;                // the tile's first position
  const int vis = max(0, min(klen, first + n_pos));
  // this split's keys: whole 64-key tiles of [0, vis) in n_split parts of
  // ceil(tiles / n_split) (ops.latent_split_range); the splits s < n_ne
  // read keys
  const int n_kt = (vis + kBN - 1) / kBN;
  const int per = (n_kt + n_split - 1) / n_split;
  const int n_ne = per > 0 ? (n_kt + per - 1) / per : 0;
  const int kt0 = min(split * per, n_kt), kt1 = min(kt0 + per, n_kt);
  const int n_it = kt1 - kt0;
  const int ke = min(kt1 * kBN, vis);        // the split's key end
  const int n_box = (D + kBox - 1) / kBox;   // boxes of a row
  const int ksteps = (D + 15) / 16;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_k(st), 1);
      mbar_init(bar_e(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread issues every TMA load; the warpgroup then
    // exits (the cluster's barriers wait for non-exited threads only)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x != kConsumers || n_it == 0) return;
    mbar_expect_tx(bar_q, n_box * kBoxBytes);
    for (int c = 0; c < n_box; ++c)
      tma_load_3d(sQ + c * kBoxBytes, &tm_q, c * kBox, i0 * H, b, bar_q);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(bar_e(st), ((it / kStages) - 1) & 1);
      const int k0 = (kt0 + it) * kBN;
      mbar_expect_tx(bar_k(st), n_box * kBoxBytes);
      for (int c = 0; c < n_box; ++c)
        tma_load_3d(sK + st * kTileBytes + c * kBoxBytes, &tm_k, c * kBox,
                    k0, b, bar_k(st));
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  // ---- consumers: warpgroup wg owns V columns 256 wg .. + 255; this
  // thread holds tile rows r0 and r1 = r0 + 8 (at positions qp0, qp1),
  // key / value columns 8 n + 2 (lane % 4) + {0, 1}
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int r1 = r0 + 8;
  const int qp0 = first + r0 / H, qp1 = first + r1 / H;
  const int cq = 2 * (lane % 4);
  const bool active = wg * 256 < Dv;         // any of its columns is output
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale_log2 = scale * kLog2e;

  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  if (n_it > 0) mbar_wait(bar_q, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const uint32_t par = (it / kStages) & 1;
    const int k0 = (kt0 + it) * kBN;
    const uint32_t sk = sK + st * kTileBytes;
    mbar_wait(bar_k(st), par);
    if (k0 + kBN > klen && klen < Sk) {
      // rows past the key bound (inside the cache) may hold anything: zero
      // them (whole 128-byte rows of each box, whatever the swizzle) before
      // either product reads the tile, so that p = 0 meets 0
      const int first_row = max(0, klen - k0);
      const int units = n_box * 8;
      for (int x = threadIdx.x; x < (kBN - first_row) * units;
           x += kConsumers) {
        const int row = first_row + x / units, c = (x % units) / 8,
                  u = x % 8;
        st_zero16(sk + c * kBoxBytes + row * 128 + u * 16);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      consumers_sync();
    }
    if (!active) {
      mbar_arrive(bar_e(st));
      continue;
    }

    // S = Q K^T over D / 16 steps of 16
    float s[kBN / 2];
    wgmma_fence();
#pragma unroll 4
    for (int j = 0; j < ksteps; ++j) {
      const uint32_t qa = sQ + (j / 4) * kBoxBytes + (j % 4) * 32;
      const uint32_t ka = sk + (j / 4) * kBoxBytes + (j % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(qa, 16, 1024), sw128_desc(ka, 16, 1024),
                   j > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // masks, only where the tile straddles the split's end or some row's
    // causal limit
    if (k0 + kBN > ke || k0 + kBN - 1 > first) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int kpos = k0 + 8 * (i / 4) + cq + (i & 1);
        const int qpos = (i & 2) ? qp1 : qp0;
        if (kpos >= ke || kpos > qpos) s[i] = -INFINITY;
      }
    }

    // online softmax on the fragment: rows r0 (i & 2 == 0) and r1
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    // scaled maxima (0 while a row has seen no valid key, so that exp2 of a
    // masked score stays 0 and no -inf - -inf appears)
    const float b0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
    const float b1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
    const float a0 = ex2(m0 * scale_log2 - b0);
    const float a1 = ex2(m1 * scale_log2 - b1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      const float p0 = ex2(fmaf(s[4 * n], scale_log2, -b0));
      const float p1 = ex2(fmaf(s[4 * n + 1], scale_log2, -b0));
      const float p2 = ex2(fmaf(s[4 * n + 2], scale_log2, -b1));
      const float p3 = ex2(fmaf(s[4 * n + 3], scale_log2, -b1));
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      // the A fragment of keys 16 (n / 2) .. + 15: registers (row r0, keys
      // 2q..), (r1, 2q..), (r0, 8 + 2q..), (r1, 8 + 2q..)
      pa[n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      o[4 * n] *= a0;
      o[4 * n + 1] *= a0;
      o[4 * n + 2] *= a1;
      o[4 * n + 3] *= a1;
    }

    // O += P V over kBN / 16 steps of 16 keys, V = the tile's columns
    // 256 wg .. + 255 (boxes 4 wg .. 4 wg + 3)
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs_n256(o, pa[kk],
                    sw128_desc(sk + 4 * wg * kBoxBytes + kk * 16 * 128,
                               kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(bar_e(st));
  }

  // the row sums completed across the quad
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const size_t row0 = (static_cast<size_t>(b) * Sq + i0) * H;  // out's row
  if (n_split == 1) {
    if (!active) return;
    const float i0_ = 1.f / fmaxf(l0, 1e-30f), i1_ = 1.f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = out + row0 * Dv + 256 * wg + cq;
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      if (256 * wg + 8 * n + cq >= Dv) continue;
      if (r0 < rows)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * Dv + 8 * n) =
            __floats2bfloat162_rn(o[4 * n] * i0_, o[4 * n + 1] * i0_);
      if (r1 < rows)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * Dv + 8 * n) =
            __floats2bfloat162_rn(o[4 * n + 2] * i1_, o[4 * n + 3] * i1_);
    }
    return;
  }

  // ---- the merge across the cluster: a split that read keys keeps its
  // partial in its own shared memory (acc [rows][Dv] in the K ring, m and l
  // in Q's room); then out = sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30),
  // w_s = 2^((m_s - M) scale log2 e) (0 where m_s = -inf) over the splits
  // s < n_ne, each CTA writing its share of the tile's output
  float* acc_s = reinterpret_cast<float*>(aligned + kK);
  float* ml = reinterpret_cast<float*>(aligned + kQ);  // [m, l][kBM]
  float* w = ml + 2 * kBM;                               // [kMaxSplit][kBM]
  float* den = w + kMaxSplit * kBM;                      // [kBM]
  // both warpgroups are past their last product on Q and the K ring (one
  // may run a tile behind the other) before either is overwritten
  consumers_sync();
  if (n_it > 0) {
    if (active) {
#pragma unroll
      for (int n = 0; n < 32; ++n) {
        const int c = 256 * wg + 8 * n + cq;
        if (c >= Dv) continue;
        if (r0 < rows)
          *reinterpret_cast<float2*>(acc_s + r0 * Dv + c) =
              make_float2(o[4 * n], o[4 * n + 1]);
        if (r1 < rows)
          *reinterpret_cast<float2*>(acc_s + r1 * Dv + c) =
              make_float2(o[4 * n + 2], o[4 * n + 3]);
      }
    }
    if (wg == 0 && lane % 4 == 0) {
      ml[r0] = m0;
      ml[kBM + r0] = l0;
      ml[r1] = m1;
      ml[kBM + r1] = l1;
    }
  }
  cluster_sync();
  const uint32_t ml_addr = base + kQ, acc_addr = base + kK;
  // the weights of each row: every split's m and l loaded at once
  for (int r = threadIdx.x; r < rows; r += kConsumers) {
    float ms[kMaxSplit], ls[kMaxSplit];
    float mx = -INFINITY;
#pragma unroll
    for (int s_ = 0; s_ < kMaxSplit; ++s_) {
      if (s_ < n_ne) {
        ms[s_] = ld_peer(peer_addr(ml_addr + 4 * r, s_));
        ls[s_] = ld_peer(peer_addr(ml_addr + 4 * (kBM + r), s_));
      }
    }
    float d = 0.f;
#pragma unroll
    for (int s_ = 0; s_ < kMaxSplit; ++s_)
      if (s_ < n_ne) mx = fmaxf(mx, ms[s_]);
#pragma unroll
    for (int s_ = 0; s_ < kMaxSplit; ++s_) {
      if (s_ < n_ne) {
        const float f =
            ms[s_] == -INFINITY ? 0.f : ex2((ms[s_] - mx) * scale_log2);
        w[s_ * kBM + r] = f;
        d = fmaf(ls[s_], f, d);
      }
    }
    den[r] = 1.f / fmaxf(d, 1e-30f);
  }
  consumers_sync();
  // this CTA's share of the tile's 16-byte output pieces, two a thread at
  // a time, every split's piece loaded at once
  const int c4 = Dv / 4, pieces = rows * c4;
  const int chunk = (pieces + n_split - 1) / n_split;
  const int x1 = min(pieces, (split + 1) * chunk);
  for (int xa = split * chunk + threadIdx.x; xa < x1;
       xa += 2 * kConsumers) {
    float4 v[2][kMaxSplit];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int x = xa + u * kConsumers;
      const int r = x / c4, c = x - r * c4;
#pragma unroll
      for (int s_ = 0; s_ < kMaxSplit; ++s_)
        if (s_ < n_ne && x < x1)
          v[u][s_] = ld_peer4(peer_addr(acc_addr + 4 * (r * Dv + 4 * c),
                                        s_));
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int x = xa + u * kConsumers;
      if (x >= x1) continue;
      const int r = x / c4, c = x - r * c4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s_ = 0; s_ < kMaxSplit; ++s_) {
        if (s_ < n_ne) {
          const float f = w[s_ * kBM + r];
          acc.x = fmaf(v[u][s_].x, f, acc.x);
          acc.y = fmaf(v[u][s_].y, f, acc.y);
          acc.z = fmaf(v[u][s_].z, f, acc.z);
          acc.w = fmaf(v[u][s_].w, f, acc.w);
        }
      }
      const float inv = den[r];
      __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
      __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(out + (row0 + r) * Dv + 4 * c) = packed;
    }
  }
  // no CTA leaves (freeing its shared memory) while another reads it
  cluster_sync();
}

// ---- host side

// A 3-D map (D, rows, B) of a contiguous (B, rows, D) bf16 tensor, read in
// boxes of (64, 64, 1) with 128-byte swizzle; rows past `rows` and columns
// past D read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int B, int rows, int D) {
  const EncodeTiled enc = encode_fn();
  if (!enc) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBox),
                             static_cast<cuuint32_t>(kBM), 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Cards whose kernel has been given its dynamic shared memory size (once a
// card: the attribute stays set for the process).
constexpr int kMaxCards = 64;

cudaError_t launch(const void* q, const void* lat, const int* q_offset,
                   const int* kv_len, void* out, int B, int Sq, int Sk,
                   int H, int D, int Dv, float scale, int n_split,
                   int device, cudaStream_t stream) {
  CUtensorMap mq, mk;
  if (!make_map(&mq, q, B, Sq * H, D) || !make_map(&mk, lat, B, Sk, D))
    return cudaErrorInvalidValue;
  static std::atomic<bool> smem_set[kMaxCards];
  if (device < 0 || device >= kMaxCards) return cudaErrorInvalidDevice;
  if (!smem_set[device].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        latent_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBytes);
    if (err != cudaSuccess) return err;
    smem_set[device].store(true, std::memory_order_release);
  }
  const int P = kBM / H;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, (Sq + P - 1) / P, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, latent_sm90_kernel, mq, mk, q_offset, kv_len,
      static_cast<__nv_bfloat16*>(out), Sq, Sk, H, D, Dv, scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace attn_lat90

extern "C" {

// Launches the tensor-core latent attention on `stream` of card `device`;
// q, lat and out bf16; q_offset and kv_len are (B,) int32 or null (0 and
// Sk).  The caller guarantees 1 <= H <= 16, D <= 576 and Dv <= min(D, 512)
// both multiples of 8, Sq, Sk >= 1, contiguous tensors with 16-byte aligned
// q and lat, 1 <= n_split <= 8 (the cluster's size).  One kernel launch.
// Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue if a tensor map cannot be encoded,
// cudaErrorMisalignedAddress for q or lat not 16-byte aligned).
int latent_attention_tc_launch(const void* q, const void* lat,
                               const void* q_offset, const void* kv_len,
                               void* out, int B, int Sq, int Sk, int H,
                               int D, int Dv, float scale, int n_split,
                               int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  using namespace attn_lat90;
  if (H < 1 || H > kHMax || D < 8 || D > kDMax || D % 8 || Dv < 8 ||
      Dv > D || Dv > kDvMax || Dv % 8 || Sq < 1 || Sk < 1 || n_split < 1 ||
      n_split > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(lat) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return static_cast<int>(attn_lat90::launch(
      q, lat, static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_len), out, B, Sq, Sk, H, D, Dv, scale,
      n_split, device, static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of one CTA.
int latent_attention_tc_smem_bytes() { return attn_lat90::kBytes; }

// How many clusters of n_split CTAs of the kernel card `device` holds at
// once (cudaOccupancyMaxActiveClusters: a cluster's CTAs share one GPC),
// or minus the cudaError_t of the query.
int latent_attention_tc_max_clusters(int n_split, int device) {
  using namespace attn_lat90;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(latent_sm90_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, 1, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kBytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, latent_sm90_kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // extern "C"
