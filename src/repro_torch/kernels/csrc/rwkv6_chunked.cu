// Chunked linear attention (RWKV6, and the SSD heads of a hybrid model) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_chunked
// (kernel body _kernel), and computes the SSD case of the JAX package's
// models/linear_scan.py::chunked_linear_attention (which that package runs
// in XLA).  r, k (B, S, H, K) and v (B, S, H, V) in fp32 or bf16, logw (B,
// S, H, K) fp32, u (H, K) fp32 or none, and S0 (B, H, K, V) fp32 or none,
// the model's layout read directly (no transposes).  Per (batch row b, head
// h), from the state S0 (zeros without one):
//
//   S_t = diag(exp(clip(logw_t, -4, 0))) S_{t-1} + k_t v_t^T,
//   RWKV6 (POST = false):  y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),
//   SSD (POST = true):     y_t = r_t . S_t   (+ r_t . diag(u) k_t v_t^T),
//
// in chunks of L steps, the Pallas kernel's chunk-factorized form: with cum
// the inclusive cumsum of the clipped log-decay over the chunk, the query
// side's lq = cum - logw (before the update) or cum (after it) and tot =
// cum[L - 1],
//
//   A[i][j] = sum_c r[i][c] e^{lq[i][c]} k[j][c] e^{-cum[j][c]}, j < i
//   A[i][i] = sum_c r[i][c] d[c] k[i][c]     (d = u, or 1 + u with POST)
//   y       = A v + (r e^{lq}) S_{n-1}
//   S_n     = e^{tot} S_{n-1} + U_n,  U_n = (k e^{tot - cum})^T v
//
// The two variants differ in two places: which running product of the
// decays scales r, and the diagonal's weight (the step's own k v^T, whose
// decay e^{cum_i} e^{-cum_i} is exactly 1, enters as the exact r . k, not
// as the product of the two rounded factors); a missing u is a zero u.
//
// y (B, S, H, V) and the final state (B, H, K, V) are fp32.  Rows past S
// (the tail of the last chunk) are identity rows: they load as r = k = v =
// 0 and logw = 0, so they add nothing to the state and decay nothing, and
// their y is not stored; this is the zero padding of the reference's
// models/linear_scan.py without a padded copy.
//
// What bounds it.  The function's own bound is a few microseconds at the
// serving path's shapes (B 1, H 32, K = V = 64, S <= 512: ~2 MB and ~0.3
// GFLOP of fp32 work).  What kept the first design (one CTA a (b, h), five
// phases and six barriers a chunk) 29x above it was the chain: every chunk
// waited for the previous one's state, and its work ran on 32 CTAs in fp32
// on the CUDA cores.  Only the state's recurrence is serial, and it is
// elementwise in S once U_n is known; everything else (the cumsum, the
// decayed tiles, A, A v, the bonus, U_n) is independent across chunks.
// The design takes that work off the chain:
//
//   * One CTA of 16 warps per (b, h, block of kVB = 16 of the state's V
//     columns): the columns are independent, so 4 CTAs a head at V = 64
//     (128 CTAs at the path's B 1, H 32) with no reduction between them;
//     each recomputes the chunk's decayed tiles and A.
//   * The CTA walks the sequence in windows of kWin = 8 chunks, one a pair
//     of warps, each warp half of the chunk's channels; the pair meets at
//     named barriers only.  Per chunk: the running product of the rows'
//     decays gives e^{cum} (one exponential a row; e^{cum_exc} is the
//     previous row's), two channels a lane with the rows split between
//     the half-warps (joined by one shuffle); r e^{lq}, k e^{-cum} and
//     e^{tot} go to shared memory, the diagonal r d k is summed over the
//     channels through a transpose in shared memory; then A over each
//     warp's channels (the two partials summed, r d k on the diagonal),
//     A v for each warp's 8 columns (kept in registers) and U_n
//     = (k e^{-cum} e^{tot})^T v for each warp's channels (to the slot's
//     state tile).
//   * __syncthreads; then each thread owns fixed (c, 2 columns) entries of
//     the state and runs S <- e^{tot_n[c]} S + U_n[c][col] over the
//     window's chunks in registers, no barrier between chunks, writing the
//     S_{n-1} it passes into the slot where U_n was.  __syncthreads; each
//     warp adds r_dec S_{n-1} over its channels, the pair trades the
//     partials of each other's columns, and each warp stores y.  Two CTA
//     barriers a window instead of six a chunk.
//   * The three products (r_dec k_idec^T, A v + r_dec S, k_dec^T v) run on
//     the tensor cores, mma.sync.m16n8k8 in TF32 with the 3xTF32 split: x
//     = hi + lo, hi = x rounded to TF32 to nearest (cvt.rna.tf32.f32's
//     result, in two integer operations), lo = x - hi rounded the same way,
//     and a b = a_hi b_lo + a_lo b_hi + a_hi b_hi accumulated in fp32 (a
//     bf16 v is exact in TF32, so its lo term is dropped).  One pass of
//     TF32 misses the 1e-4 tolerance on most of y (tests/test_torch_rwkv.py
//     emulates both); a chunk's 16 rows are exactly the mma's M, while
//     wgmma's 64-row tile would stack four chunks and waste three quarters
//     of the block-diagonal pair product.  Long sums run as two
//     accumulators, halving the chains of dependent mma.
//   * A chunk's r, k, logw and v tiles come in as four TMA boxes (tensor
//     maps encoded on the host for each call), completing on the slot's
//     mbarrier: rows past S, channels past K and columns past V read as
//     zeros.  The next window's boxes are issued as soon as the slot's
//     tiles are consumed (r, logw and k after the decays, v after U_n), so
//     they fly through the rest of the window.  Inputs whose rows are not
//     16-byte multiples (odd K or V) or that are not 16-byte aligned take
//     plain loads instead.
//
// Measured on the H100 (PERF.md; scripts/rwkv6_phase_clocks.py), a
// window's time is spread over its steps (the decays, the products, the
// recurrence, the read-out), none much above a fifth of it; the kernel is
// 5-6x its bound at the serving path's lengths.
//
// Shared memory: 8 slots of the staged tiles, k e^{-cum}, r_dec, A, the
// state tile (64 x 16, XOR-swizzled so the mma's B fragments fall in
// distinct banks), e^{tot}, the bonus partials and the mbarrier: 182 KB
// for bf16, 218 KB for fp32, opted in once a card.  Any K, V <= 64 and L
// <= 16 take the same code: tiles are 16 rows (rows past L stay zero) and
// 64 channels (channels past K are zero), and the products skip the k-steps
// and m-tiles past K; K = 64 is a compile-time specialisation.
//
// Launched through a plain C interface (ctypes), on the caller's stream; it
// allocates nothing and does not synchronise.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tma_common.cuh"

namespace rwkv6 {

using namespace tma;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kWin = kWarps / 2;    // chunks a window: two warps a chunk
constexpr int kL = 16;              // rows of a chunk tile: the mma's M
constexpr int kMaxKV = 64;          // K and V
constexpr int kVB = 16;             // state columns a CTA
constexpr int kTS = kMaxKV + 4;     // row stride (floats) of the fp32 tiles
constexpr int kAS = kL + 4;         // row stride of the pair matrix
constexpr float kLogDecayMin = -4.f;
constexpr int kMaxCards = 64;

// Byte offsets of one chunk's slot, each 128-byte aligned (TMA's
// destinations).  Staged in the inputs' types: r, k [16][64], v [16][16];
// logw [16][64] fp32.  Then fp32: k e^{-cum} and r_dec [16][kTS], the pair
// matrix [16][kAS] (also the pair's exchange of partial sums), the state
// tile [64][kVB] (U_n, then S_{n-1}; see su_idx), e^{tot} [64] and the
// two warps' bonus partials [2][16].  The strides put a fragment's rows in
// distinct banks.
template <typename T>
struct Slot {
  static constexpr int r = 0;
  static constexpr int k = r + kL * kMaxKV * sizeof(T);
  static constexpr int lw = k + kL * kMaxKV * sizeof(T);
  static constexpr int v = lw + kL * kMaxKV * 4;
  static constexpr int ki = v + kL * kVB * sizeof(T);
  static constexpr int rd = ki + kL * kTS * 4;
  static constexpr int A = rd + kL * kTS * 4;
  static constexpr int su = A + kL * kAS * 4;
  static constexpr int etot = su + kMaxKV * kVB * 4;
  static constexpr int bon = etot + kMaxKV * 4;
  static constexpr int bar = bon + 2 * kL * 4;   // the loads' mbarrier
  static constexpr int bytes = bar + 128;         // slots 128-byte aligned
};

template <typename T>
constexpr int smem_bytes() {
  return kWin * Slot<T>::bytes + kMaxKV * 4;   // the slots, then u
}
static_assert(smem_bytes<float>() <= 232448 &&
                  smem_bytes<__nv_bfloat16>() <= 232448,
              "the slots exceed 227 KB");
static_assert(Slot<float>::bytes % 128 == 0 &&
                  Slot<__nv_bfloat16>::bytes % 128 == 0 &&
                  Slot<float>::ki % 128 == 0 &&
                  Slot<__nv_bfloat16>::ki % 128 == 0,
              "slots and staged tiles must stay 128-byte aligned");
// the state tile's element (row c, column col): columns XOR 8 on rows 2, 3
// mod 4, so a B fragment's rows 8 ks + t (t < 4) fall in distinct banks
__device__ __forceinline__ int su_idx(int c, int col) {
  return c * kVB + (col ^ ((c & 2) << 2));
}

// two adjacent elements (the first 4- or 8-byte aligned) as fp32
__device__ __forceinline__ float2 to_f32x2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 to_f32x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <typename E>
__device__ __forceinline__ E zero_of() { return E(0.f); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// the two warps of slot `pair` (named barrier 1 + pair, 64 threads)
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;" ::"r"(1 + pair) : "memory");
}

// ------------------------------------------------------------ 3xTF32 mma
// x rounded to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32
// for every finite x, in two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
// a B fragment value of v: bf16 is exact in TF32 (its lo part is zero and
// unused); fp32 is split
__device__ __forceinline__ void split_v(float x, uint32_t& hi, uint32_t& lo) {
  split(x, hi, lo);
}
__device__ __forceinline__ void split_v(__nv_bfloat16 x, uint32_t& hi,
                                        uint32_t& lo) {
  hi = __float_as_uint(__bfloat162float(x));
  lo = 0u;
}

// d (16 x 8) += a (16 x 8, row) b (8 x 8, col) in TF32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small terms first; B_EXACT: b is exact in TF32
// (its lo part is zero), so its term is skipped
template <bool B_EXACT = false>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if constexpr (!B_EXACT) mma_tf32(d, ah, bl);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bh);
}

// The A fragment (rows g, g + 8; columns c, c + 4) of a row-major fp32
// tile with row stride `ld`, split.
__device__ __forceinline__ void a_frag(const float* tile, int ld, int g,
                                       int c, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  split(tile[g * ld + c], ah[0], al[0]);
  split(tile[(g + 8) * ld + c], ah[1], al[1]);
  split(tile[g * ld + c + 4], ah[2], al[2]);
  split(tile[(g + 8) * ld + c + 4], ah[3], al[3]);
}


// ------------------------------------------------------------ the loads
// The inputs (B, S, H, n) as 4-D tensor maps (n, H, S, B), read in boxes of
// (64 or 16 columns, 1, L rows, 1): columns past n and rows past S read as
// zeros.
struct Maps {
  CUtensorMap r, k, lw, v;
};

template <typename T>
struct Src {
  const T* r;
  const T* k;
  const T* v;
  const float* lw;
  int b, h, S, H, K, V, L, col0;
};

// Rows t0 .. t0 + L - 1 of an input (columns c0 .. c0 + W - 1 of its rows
// of n elements) into a staged tile of W elements a row by the calling
// warp's plain loads, zeros past S and past n columns: the path of inputs
// whose rows are not 16-byte multiples (odd K or V).
template <int W, typename E, typename T>
__device__ __forceinline__ void load_plain(E* dst, const E* src, int n,
                                           int c0, const Src<T>& s, int t0,
                                           int lane) {
  for (int x = lane; x < s.L * W; x += 32) {
    const int i = x / W, c = x - i * W, t = t0 + i;
    dst[x] = t < s.S && c0 + c < n
                 ? src[(static_cast<size_t>(s.b) * s.S + t) * s.H * n +
                       static_cast<size_t>(s.h) * n + c0 + c]
                 : zero_of<E>();
  }
}

// A warp's share of the loads of the chunk starting at time t0 into
// `slot`: part 0 (warp 0 of the pair) r and logw, part 1 (warp 1) k, part
// 2 (warp 1, once v is consumed) v.  maps: one TMA box each, issued by
// lane 0, completing on the slot's mbarrier, which part 0 arms with the
// bytes of all three; else plain loads.  Staged rows past L are zero from
// the kernel's start and never written.
template <typename T>
__device__ __forceinline__ void load_part(uint8_t* slot, const Maps* maps,
                                          const Src<T>& s, int t0, int part,
                                          int lane) {
  using SL = Slot<T>;
  T* r = reinterpret_cast<T*>(slot + SL::r);
  T* k = reinterpret_cast<T*>(slot + SL::k);
  float* lw = reinterpret_cast<float*>(slot + SL::lw);
  T* v = reinterpret_cast<T*>(slot + SL::v);
  if (maps == nullptr) {
    if (part == 0) {
      load_plain<kMaxKV>(r, s.r, s.K, 0, s, t0, lane);
      load_plain<kMaxKV>(lw, s.lw, s.K, 0, s, t0, lane);
    } else if (part == 1) {
      load_plain<kMaxKV>(k, s.k, s.K, 0, s, t0, lane);
    } else {
      load_plain<kVB>(v, s.v, s.V, s.col0, s, t0, lane);
    }
    return;
  }
  if (lane) return;
  const uint32_t bar = smem_u32(slot + SL::bar);
  if (part == 0) {
    mbar_expect_tx(bar, s.L * (kMaxKV * (2 * sizeof(T) + 4) +
                               kVB * sizeof(T)));
    tma_load_4d(smem_u32(r), &maps->r, 0, s.h, t0, s.b, bar);
    tma_load_4d(smem_u32(lw), &maps->lw, 0, s.h, t0, s.b, bar);
  } else if (part == 1) {
    tma_load_4d(smem_u32(k), &maps->k, 0, s.h, t0, s.b, bar);
  } else {
    tma_load_4d(smem_u32(v), &maps->v, s.col0, s.h, t0, s.b, bar);
  }
}

// ------------------------------------------------ a chunk, phase 1
// The two warps of the chunk's slot (half hf of its channels and of its
// columns each) take the staged tiles to r_dec, k e^{-cum}, e^{tot}, the
// pair matrix, U_n (to the slot's state tile) and y = A v (returned in
// `yacc`: rows g, g + 8 of columns 8 hf + 2 t, + 1).  The loads of chunk
// ci + kWin into the slot (r, logw and k) are issued once their tiles are
// consumed.
template <typename T, int KF, bool POST>
__device__ __forceinline__ void chunk_products(uint8_t* slot, const float* us,
                                               const Src<T>& s, int ci,
                                               int n_chunks, int pair, int hf,
                                               int lane, const Maps* maps,
                                               float (&yacc)[4]) {
  using SL = Slot<T>;
  constexpr bool kVExact = sizeof(T) == 2;   // bf16 v: exact in TF32
  const int K = KF ? KF : s.K;
  const T* rs = reinterpret_cast<const T*>(slot + SL::r);
  const T* kst = reinterpret_cast<const T*>(slot + SL::k);
  const float* lws = reinterpret_cast<const float*>(slot + SL::lw);
  const T* vs = reinterpret_cast<const T*>(slot + SL::v);
  float* ki = reinterpret_cast<float*>(slot + SL::ki);
  float* rd = reinterpret_cast<float*>(slot + SL::rd);
  float* At = reinterpret_cast<float*>(slot + SL::A);
  float* su = reinterpret_cast<float*>(slot + SL::su);
  float* etot = reinterpret_cast<float*>(slot + SL::etot);
  float* bonp = reinterpret_cast<float*>(slot + SL::bon);
  if (maps) mbar_wait(smem_u32(slot + SL::bar), (ci / kWin) & 1);
  pair_sync(pair);

  // 1. two channels a lane (of this warp's half), rows 0-7 in lanes 0-15
  //    and rows 8-15 in lanes 16-31: e^{cum} is the running product of the
  //    rows' decays, so e^{cum_exc} is the previous row's and one
  //    exponential a row serves both; the second half's products take the
  //    first half's total by a shuffle.  Then r e^{lq} (e^{cum} with
  //    POST), k e^{-cum}, e^{tot}, and the diagonal terms r d k of each
  //    row, summed over the lane's two channels and transposed through
  //    this warp's half of the state tile (free until U_n is written; rows 18 floats apart, so the
  //    two halves' rows fall in distinct banks)
  float* bt = su + hf * kL * 32;   // [row][18]
  {
    const int q = lane & 15, rh = lane >> 4, c = 32 * hf + 2 * q;
    float2 ep[kL / 2 + 1];   // e^{cum} before each of this half's rows
    ep[0] = make_float2(1.f, 1.f);
#pragma unroll
    for (int m = 0; m < kL / 2; ++m) {
      const float2 lw = *reinterpret_cast<const float2*>(
          lws + (8 * rh + m) * kMaxKV + c);
      ep[m + 1].x = ep[m].x * expf(fminf(fmaxf(lw.x, kLogDecayMin), 0.f));
      ep[m + 1].y = ep[m].y * expf(fminf(fmaxf(lw.y, kLogDecayMin), 0.f));
    }
    float2 f = make_float2(__shfl_sync(0xffffffffu, ep[kL / 2].x, q),
                           __shfl_sync(0xffffffffu, ep[kL / 2].y, q));
    if (!rh) f = make_float2(1.f, 1.f);
    const float2 uc = *reinterpret_cast<const float2*>(us + c);
#pragma unroll
    for (int m = 0; m < kL / 2; ++m) {
      const int i = 8 * rh + m;
      const float2 rv = to_f32x2(rs + i * kMaxKV + c);
      const float2 kv = to_f32x2(kst + i * kMaxKV + c);
      const float2 eq = POST ? ep[m + 1] : ep[m];   // e^{lq} / f
      *reinterpret_cast<float2*>(rd + i * kTS + c) = make_float2(
          rv.x * (f.x * eq.x), rv.y * (f.y * eq.y));
      *reinterpret_cast<float2*>(ki + i * kTS + c) =
          make_float2(__fdividef(kv.x, f.x * ep[m + 1].x),
                      __fdividef(kv.y, f.y * ep[m + 1].y));
      bt[i * 18 + q] = rv.x * uc.x * kv.x + rv.y * uc.y * kv.y;
    }
    if (rh)
      *reinterpret_cast<float2*>(etot + c) =
          make_float2(f.x * ep[kL / 2].x, f.y * ep[kL / 2].y);
  }
  __syncwarp();
  //    row lane % 16's bonus over this warp's channels: half a row a lane,
  //    then the two halves
  {
    const int row = lane & 15, h16 = lane >> 4;
    float b = 0.f;
#pragma unroll
    for (int m = 0; m < 8; ++m) b += bt[row * 18 + 8 * h16 + m];
    b += __shfl_xor_sync(0xffffffffu, b, 16);
    if (lane < 16) bonp[hf * kL + row] = b;
  }
  pair_sync(pair);
  if (ci + kWin < n_chunks)
    load_part(slot, maps, s, (ci + kWin) * s.L, hf, lane);

  // 2. the pair matrix (r e^{lq}) (k e^{-cum})^T over this warp's
  //    channels (k-steps 4 hf .. 4 hf + 3), both column tiles; warp 1's
  //    partial goes through the A tile to warp 0, which adds it and stores
  //    A: below the diagonal, the bonus on it, zeros above
  const int g = lane >> 2, t = lane & 3;
  const int nks = (K + 7) / 8;
  {
    float a[2][4] = {}, odd[2][4] = {};   // even and odd k-steps
#pragma unroll
    for (int kk = 0; kk < kMaxKV / 16; ++kk) {
      const int ks = 4 * hf + kk;
      if (ks < nks) {
        const int c = 8 * ks + t;
        uint32_t ah[4], al[4];
        a_frag(rd, kTS, g, c, ah, al);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = 8 * nt + g;
          uint32_t bh[2], bl[2];
          split(ki[j * kTS + c], bh[0], bl[0]);
          split(ki[j * kTS + c + 4], bh[1], bl[1]);
          if (kk & 1)
            mma3(odd[nt], ah, al, bh, bl);
          else
            mma3(a[nt], ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[nt][e] += odd[nt][e];
    if (hf == 1)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          At[(g + 8 * (e >> 1)) * kAS + 8 * nt + 2 * t + (e & 1)] = a[nt][e];
    pair_sync(pair);
    if (hf == 0)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = g + 8 * (e >> 1), jj = 8 * nt + 2 * t + (e & 1);
          float* x = At + i * kAS + jj;
          *x = jj < i    ? a[nt][e] + *x
               : jj == i ? bonp[i] + bonp[kL + i]
                         : 0.f;
        }
  }
  pair_sync(pair);

  // 3. v's B fragments (rows j = 8 ks + t, + 4; column 8 nt + g); y = A v
  //    for this warp's columns
  uint32_t vh[2][2][2], vl[2][2][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        split_v(vs[(8 * ks + t + 4 * q) * kVB + 8 * nt + g],
                vh[ks][nt][q], vl[ks][nt][q]);
#pragma unroll
  for (int e = 0; e < 4; ++e) yacc[e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t ah[4], al[4];
    a_frag(At, kAS, g, 8 * ks + t, ah, al);
    mma3<kVExact>(yacc, ah, al, vh[ks][hf], vl[ks][hf]);
  }

  // 4. U_n = (k e^{tot - cum})^T v for this warp's channel tiles 2 hf,
  //    2 hf + 1: the A fragment (channels c, c + 8; rows j, j + 4) is
  //    k e^{-cum} times e^{tot}
  const int nmt = (K + 15) / 16;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int mt = 2 * hf + m;
    if (mt < nmt) {
      float uacc[2][4] = {};
      const int c = 16 * mt + g;
      const float et[2] = {etot[c], etot[c + 8]};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int j = 8 * ks + t;
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int cq = c + 8 * (q & 1), jq = j + 4 * (q >> 1);
          split(ki[jq * kTS + cq] * et[q & 1], ah[q], al[q]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma3<kVExact>(uacc[nt], ah, al, vh[ks][nt], vl[ks][nt]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = 16 * mt + g, col = 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(su + su_idx(c, col)) =
            make_float2(uacc[nt][0], uacc[nt][1]);
        *reinterpret_cast<float2*>(su + su_idx(c + 8, col)) =
            make_float2(uacc[nt][2], uacc[nt][3]);
      }
    }
  }
}

// ------------------------------------------------ a chunk, phase 3
// y += r_dec S_{n-1} (the slot's state tile now holds S_{n-1}), over this
// warp's channels for both column tiles; the two warps trade the partials
// of each other's columns through the A tile, then each stores its columns.
template <typename T, int KF>
__device__ __forceinline__ void chunk_output(uint8_t* slot, const Src<T>& s,
                                             int ci, int pair, int hf,
                                             int lane, float (&yacc)[4],
                                             float* __restrict__ y) {
  using SL = Slot<T>;
  const int K = KF ? KF : s.K;
  const float* rd = reinterpret_cast<const float*>(slot + SL::rd);
  const float* su = reinterpret_cast<const float*>(slot + SL::su);
  float* xs = reinterpret_cast<float*>(slot + SL::A);   // [2][16][8]
  const int g = lane >> 2, t = lane & 3;
  const int nks = (K + 7) / 8;
  float part[2][4] = {}, odd[2][4] = {};   // even and odd k-steps
#pragma unroll
  for (int kk = 0; kk < kMaxKV / 16; ++kk) {
    const int ks = 4 * hf + kk;
    if (ks < nks) {
      const int c = 8 * ks + t;
      uint32_t ah[4], al[4];
      a_frag(rd, kTS, g, c, ah, al);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t bh[2], bl[2];
        split(su[su_idx(c, 8 * nt + g)], bh[0], bl[0]);
        split(su[su_idx(c + 4, 8 * nt + g)], bh[1], bl[1]);
        if (kk & 1)
          mma3(odd[nt], ah, al, bh, bl);
        else
          mma3(part[nt], ah, al, bh, bl);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[nt][e] += odd[nt][e];
  float2* mine = reinterpret_cast<float2*>(xs + hf * kL * 8);
  const float2* theirs =
      reinterpret_cast<const float2*>(xs + (1 - hf) * kL * 8);
  mine[g * 4 + t] = make_float2(part[1 - hf][0], part[1 - hf][1]);
  mine[(g + 8) * 4 + t] = make_float2(part[1 - hf][2], part[1 - hf][3]);
  pair_sync(pair);
  const float2 o0 = theirs[g * 4 + t], o1 = theirs[(g + 8) * 4 + t];
  yacc[0] += part[hf][0] + o0.x;
  yacc[1] += part[hf][1] + o0.y;
  yacc[2] += part[hf][2] + o1.x;
  yacc[3] += part[hf][3] + o1.y;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = g + 8 * (e >> 1), tt = ci * s.L + i;
    const int col = s.col0 + 8 * hf + 2 * t + (e & 1);
    if (i < s.L && tt < s.S && col < s.V)
      y[((static_cast<size_t>(s.b) * s.S + tt) * s.H + s.h) * s.V + col] =
          yacc[e];
  }
}

// KF: compile-time K (64) or 0 for K given at run time; POST: the SSD's
// post-update output.  u and s0 may be null (a zero bonus, a zero state).
template <typename T, int KF, bool POST>
__global__ void __launch_bounds__(kThreads, 1)
rwkv6_chunked_kernel(const __grid_constant__ Maps tm,
                     const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ logw,
                     const float* __restrict__ u,
                     const float* __restrict__ s0, float* __restrict__ y,
                     float* __restrict__ state_out, int S, int H, int K_,
                     int V, int L, int use_maps) {
  using SL = Slot<T>;
  extern __shared__ __align__(128) uint8_t smem[];
  const Maps* maps = use_maps ? &tm : nullptr;
  const int K = KF ? KF : K_;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pair = warp >> 1, hf = warp & 1;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const Src<T> s{r, k, v, logw, b, h, S, H, K, V, L,
                 static_cast<int>(blockIdx.y) * kVB};
  float* us = reinterpret_cast<float*>(smem + kWin * SL::bytes);
  uint8_t* slot = smem + pair * SL::bytes;
  const int n_chunks = (S + L - 1) / L;
  // zeros where the loads never write (rows past L, channels past K,
  // columns past V), the mbarriers, u
  for (int x = tid; x < kWin * SL::bytes / 16; x += kThreads)
    reinterpret_cast<float4*>(smem)[x] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  if (tid < kWin) mbar_init(smem_u32(smem + tid * SL::bytes + SL::bar), 1);
  if (tid < kMaxKV) {   // the diagonal's weight d
    const float uc = tid < K && u ? u[static_cast<size_t>(h) * K + tid] : 0.f;
    us[tid] = tid < K && POST ? uc + 1.f : uc;
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n"
               "fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (pair < n_chunks) {
    load_part(slot, maps, s, pair * L, hf, lane);
    if (hf == 1) load_part(slot, maps, s, pair * L, 2, lane);
  }

  // the state entries this thread carries: row sc, columns sq, sq + 1,
  // from S0 where there is one
  const int sc = tid >> 3, sq = (tid & 7) * 2;
  float2 st = make_float2(0.f, 0.f);
  if (s0 != nullptr && sc < K) {
    const float* si = s0 + (static_cast<size_t>(bh) * K + sc) * V + s.col0;
    if (s.col0 + sq < V) st.x = si[sq];
    if (s.col0 + sq + 1 < V) st.y = si[sq + 1];
  }
  float yacc[4];
  for (int w0 = 0; w0 < n_chunks; w0 += kWin) {
    const int ci = w0 + pair, n_valid = min(kWin, n_chunks - w0);
    const bool mine = ci < n_chunks;
    if (mine)
      chunk_products<T, KF, POST>(slot, us, s, ci, n_chunks, pair, hf, lane,
                                  maps, yacc);
    __syncthreads();
    if (mine && hf == 1 && ci + kWin < n_chunks)   // v is consumed now
      load_part(slot, maps, s, (ci + kWin) * L, 2, lane);
    // 2. the recurrence over the window's chunks, in registers
#pragma unroll
    for (int n = 0; n < kWin; ++n) {
      if (n >= n_valid) break;
      uint8_t* sl = smem + n * SL::bytes;
      float2* p = reinterpret_cast<float2*>(
          reinterpret_cast<float*>(sl + SL::su) + su_idx(sc, sq));
      const float e = reinterpret_cast<const float*>(sl + SL::etot)[sc];
      const float2 un = *p;
      *p = st;
      if (sc < K) {
        st.x = fmaf(e, st.x, un.x);
        st.y = fmaf(e, st.y, un.y);
      }
    }
    __syncthreads();
    if (mine) chunk_output<T, KF>(slot, s, ci, pair, hf, lane, yacc, y);
  }

  if (sc < K) {
    float* so = state_out + (static_cast<size_t>(bh) * K + sc) * V + s.col0;
    if (s.col0 + sq < V) so[sq] = st.x;
    if (s.col0 + sq + 1 < V) so[sq + 1] = st.y;
  }
}

// ---- host side

// A 4-D map (n, H, S, B) of a contiguous (B, S, H, n) tensor of E, read in
// boxes of (cols, 1, L, 1) without swizzle; reads out of range are zeros.
template <typename E>
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int n,
              int cols, int L) {
  const EncodeTiled enc = encode_fn();
  if (!enc) return false;
  const cuuint64_t e = sizeof(E);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {n * e, H * n * e,
                                 static_cast<cuuint64_t>(S) * H * n * e};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(L), 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return enc(map,
             sizeof(E) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             4, const_cast<void*>(ptr), dims, strides, box, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int KF, bool POST>
cudaError_t launch(const Maps& maps, int use_maps, const void* r,
                   const void* k, const void* v, const void* logw,
                   const void* u, const void* s0, void* y, void* state,
                   int B, int S, int H, int K, int V, int L, int device,
                   cudaStream_t stream) {
  auto kern = rwkv6_chunked_kernel<T, KF, POST>;
  static std::atomic<bool> smem_set[kMaxCards];
  constexpr int bytes = smem_bytes<T>();
  if (device < 0 || device >= kMaxCards) return cudaErrorInvalidDevice;
  if (!smem_set[device].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    smem_set[device].store(true, std::memory_order_release);
  }
  const dim3 grid(B * H, (V + kVB - 1) / kVB);
  kern<<<grid, kThreads, bytes, stream>>>(
      maps, static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(state), S, H, K, V, L,
      use_maps);
  return cudaGetLastError();
}

template <typename T, bool POST>
cudaError_t launch_sizes(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, const void* s0,
                         void* y, void* state, int B, int S, int H, int K,
                         int V, int L, int device, cudaStream_t stream) {
  // TMA needs 16-byte aligned tensors whose rows are 16-byte multiples;
  // other inputs take the plain loads
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int use_maps = S > 0 && al(r) && al(k) && al(v) && al(logw) &&
                       (K * sizeof(T)) % 16 == 0 && (K * 4) % 16 == 0 &&
                       (V * sizeof(T)) % 16 == 0;
  Maps maps = {};
  if (use_maps &&
      !(make_map<T>(&maps.r, r, B, S, H, K, kMaxKV, L) &&
        make_map<T>(&maps.k, k, B, S, H, K, kMaxKV, L) &&
        make_map<float>(&maps.lw, logw, B, S, H, K, kMaxKV, L) &&
        make_map<T>(&maps.v, v, B, S, H, V, kVB, L)))
    return cudaErrorInvalidValue;
  if (K == kMaxKV)
    return launch<T, kMaxKV, POST>(maps, use_maps, r, k, v, logw, u, s0, y,
                                   state, B, S, H, K, V, L, device, stream);
  return launch<T, 0, POST>(maps, use_maps, r, k, v, logw, u, s0, y, state,
                            B, S, H, K, V, L, device, stream);
}

template <typename T>
cudaError_t launch_variant(const void* r, const void* k, const void* v,
                           const void* logw, const void* u, const void* s0,
                           void* y, void* state, int B, int S, int H, int K,
                           int V, int L, int post, int device,
                           cudaStream_t stream) {
  return post ? launch_sizes<T, true>(r, k, v, logw, u, s0, y, state, B, S,
                                      H, K, V, L, device, stream)
              : launch_sizes<T, false>(r, k, v, logw, u, s0, y, state, B, S,
                                       H, K, V, L, device, stream);
}

}  // namespace rwkv6

extern "C" {

// The launch's shape: chunks a window, state columns a CTA (the grid is
// (B * H, ceil(V / columns))), and dynamic shared memory a CTA.
int rwkv6_chunked_window() { return rwkv6::kWin; }
int rwkv6_chunked_col_block() { return rwkv6::kVB; }
int rwkv6_chunked_smem_bytes(int bf16) {
  return bf16 ? rwkv6::smem_bytes<__nv_bfloat16>()
              : rwkv6::smem_bytes<float>();
}

// Launches the chunked kernel on `stream` of card `device`; `bf16` selects
// the type of r, k and v (0: fp32), `post` the SSD's post-update output (0:
// RWKV6's pre-update one); u (the bonus) and s0 (the initial state) may be
// null.  The caller guarantees contiguous tensors, 1 <= K, V <= 64, 1 <= L
// <= 16, B * H >= 1.  Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue if a tensor map cannot be encoded).
int rwkv6_chunked_launch(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, const void* s0,
                         void* y, void* state, int B, int S, int H, int K,
                         int V, int L, int bf16, int post, int device,
                         void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K < 1 || K > rwkv6::kMaxKV || V < 1 || V > rwkv6::kMaxKV || L < 1 ||
      L > rwkv6::kL || B < 1 || H < 1 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? rwkv6::launch_variant<__nv_bfloat16>(
                   r, k, v, logw, u, s0, y, state, B, S, H, K, V, L, post,
                   device, s)
             : rwkv6::launch_variant<float>(r, k, v, logw, u, s0, y, state,
                                            B, S, H, K, V, L, post, device,
                                            s);
  return static_cast<int>(err);
}

}  // extern "C"
