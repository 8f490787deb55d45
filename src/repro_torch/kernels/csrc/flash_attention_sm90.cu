// Blockwise (flash) GQA attention forward on Hopper's tensor cores, for bf16
// inputs with head dim 64, 128, 192 or 256 (sm_90a: TMA, mbarrier, wgmma).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (kernel body _kernel) for the calls it takes; the wrapper
// (kernels/ops.py::flash_attention) routes fp32 and other head dims to the
// CUDA-core kernel of flash_attention.cu.  Semantics are that kernel's: q
// (B, Sq, H, hd), k and v (B, Skv, KV, hd), out (B, Sq, H, hd), the JAX
// package's layout; query head h reads kv head h / G; query i of row b at
// qpos = q_offset[b] + i (0 + i without q_offset), key j at j; scores (q .
// k) * scale, then with softcap > 0 tanh(s * (1 / softcap)) * softcap; a
// score is masked where kpos >= min(kv_len[b], Skv) (Skv without kv_len),
// where causal and kpos > qpos and where window > 0 and qpos - kpos >=
// window; a masked position gets p = 0; out = acc / max(l, 1e-30), so a
// row with no valid key gives zeros.  The V rows of a tile past the key
// bound (a cache's rows, which may hold anything) are zeroed in shared
// memory before the P . V product reads them.
//
// What bounds it: operations above a few hundred rows (2 * 2 * valid pairs
// * H * hd at the 989 TFLOP/s bf16 tensor-core rate), bytes below.  The
// design puts both products on the tensor cores:
//
// - One CTA per (128-row Q tile, q head, batch row); the grid's slowest
//   axis is the tile, longest (last) tiles first, so causal work is
//   balanced.  Consumer warpgroups 0 and 1 own 64 query rows each; warp 8
//   is the producer (above hd 128 warpgroup 2, which gives its registers
//   to the consumers by setmaxnreg: 24 a thread against their 240).
// - The producer loads Q once and K, V tiles of 64 keys into a ring of
//   kStages stages (three; two at hd 256, where three would not fit the
//   227 KB a CTA may have) with TMA (128-byte swizzle, full / empty
//   mbarrier pairs).  The tensor maps are 4-D (hd, heads, S, B), so TMA
//   zero-fills the rows past Sq or Skv of each batch row and never reads
//   the next one's.
// - S = Q . K^T by wgmma m64n64k16 (Q and K from shared memory, K-major),
//   hd / 16 steps, fp32 accumulators.  The online softmax runs on the
//   accumulator fragment in registers (row max and sum across the 4
//   threads of a row by shuffles, exp2 with the scale folded in);
//   per-element masks only on tiles that straddle the diagonal, the
//   window's edge or the ragged end; a warpgroup skips the tiles its rows
//   cannot see.
// - P is rounded to bf16 in registers and is the register A operand of
//   O += P . V (wgmma m64nHDk16, V from shared memory MN-major, i.e. with
//   the transpose flag; hd / 64 boxes of 64 columns a wgmma).  This
//   rounding is the one numeric difference from the plain version, which
//   keeps p in fp32: about 2^-9 of each p.  A consumer thread holds hd / 2
//   fp32 accumulators (128 at hd 256) beside the 32 of S and the 16 of P:
//   ptxas must report no spill.
// - At an offset (a chunked prefill) the tile range, the skipping and the
//   masks move with the row's offset and key bound; the tensor maps still
//   span the whole cache (Skv rows).
// - out = acc / max(l, 1e-30) in fp32, rounded to bf16 and stored from
//   registers; rows >= Sq are not written.
//
// The tensor maps are encoded on the host for each call through the
// driver's cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint,
// so the library does not link libcuda.  Launched through a plain C
// interface (ctypes) on the caller's stream; it allocates nothing and does
// not synchronise.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

#include "tma_common.cuh"
#include "wgmma_common.cuh"

namespace attn90 {

using namespace tma;
using namespace wgmma;

constexpr int kBM = 128;                   // query rows a CTA
constexpr int kBN = 64;                    // keys a tile
constexpr int kConsumers = 256;            // two warpgroups of 64 rows
constexpr int kBox = 64;                   // bf16 columns of one 128 B row

// Dynamic shared memory, from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes): Q (hd / 64 boxes of kBM
// rows), then kStages K tiles and kStages V tiles (hd / 64 boxes of kBN
// rows each), then the mbarriers: 192 KB at hd 192 (three stages) and at
// hd 256 (two).
template <int HD>
struct Layout {
  static_assert(HD % kBox == 0 && HD <= 256, "hd: 64, 128, 192 or 256");
  static constexpr int kStages = HD > 192 ? 2 : 3;
  // Above hd 128 the producer is a whole warpgroup, so that setmaxnreg can
  // move registers to the consumers (ptxas budgets a wgmma kernel's
  // registers by warpgroup: 168 a thread at three, where hd 256 spills).
  static constexpr bool kWide = HD > 128;
  static constexpr int kThreads = kConsumers + (kWide ? 128 : 32);
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  static constexpr int kQBox = kBM * 128;             // bytes of a Q box
  static constexpr int kKVBox = kBN * 128;            // of a K or V box
  static constexpr int kKVTile = kKVBox * (HD / kBox);
  static constexpr int kQ = 0;
  static constexpr int kK = kQBox * (HD / kBox);
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kBar = kV + kStages * kKVTile;
  // q_full, then k_full, v_full and empty for each stage
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(Layout<HD>::kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const int* __restrict__ q_offset,
                  const int* __restrict__ kv_len,
                  __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H,
                  int KV, float scale, float softcap, int causal,
                  int window) {
  using L = Layout<HD>;
  constexpr int kStages = L::kStages;
  constexpr int kChunks = HD / kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  auto bar_k = [&](int st) { return bar_q + 8u * (1 + st); };
  auto bar_v = [&](int st) { return bar_q + 8u * (1 + kStages + st); };
  auto bar_e = [&](int st) { return bar_q + 8u * (1 + 2 * kStages + st); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int tile = gridDim.z - 1 - blockIdx.z;       // longest tiles first
  const int q0 = tile * kBM;
  const int kvh = h / (H / KV);
  const int off = q_offset ? q_offset[b] : 0;
  const int klen = kv_len ? max(0, min(kv_len[b], Skv)) : Skv;
  // the keys any row of this tile can see (positions), in whole tiles
  // from kt0
  const int q_last = off + min(q0 + kBM, Sq) - 1;
  const int k_end = causal ? min(klen, q_last + 1) : klen;
  const int kt0 =
      window > 0 ? (max(0, off + q0 - window + 1) / kBN) * kBN : 0;
  const int n_tiles = k_end > kt0 ? (k_end - kt0 + kBN - 1) / kBN : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_k(st), 1);
      mbar_init(bar_v(st), 1);
      mbar_init(bar_e(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread issues every TMA load
    if constexpr (L::kWide)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
                       L::kProducerRegs));
    if (threadIdx.x != kConsumers) return;
    mbar_expect_tx(bar_q, kBM * HD * 2);
    for (int c = 0; c < kChunks; ++c)
      tma_load_4d(sQ + c * L::kQBox, &tm_q, c * kBox, h, q0, b, bar_q);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(bar_e(st), ((it / kStages) - 1) & 1);
      const int k0 = kt0 + it * kBN;
      mbar_expect_tx(bar_k(st), kBN * HD * 2);
      for (int c = 0; c < kChunks; ++c)
        tma_load_4d(sK + st * L::kKVTile + c * L::kKVBox, &tm_k, c * kBox,
                    kvh, k0, b, bar_k(st));
      mbar_expect_tx(bar_v(st), kBN * HD * 2);
      for (int c = 0; c < kChunks; ++c)
        tma_load_4d(sV + st * L::kKVTile + c * L::kKVBox, &tm_v, c * kBox,
                    kvh, k0, b, bar_v(st));
    }
    return;
  }

  if constexpr (L::kWide)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
                     L::kConsumerRegs));
  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. + 63; this thread
  // holds rows r0 and r1 = r0 + 8 of them (at positions qp0, qp1),
  // columns 8 n + 2 (lane % 4) + {0, 1}
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int wg_first = off + q0 + 64 * wg, wg_last = wg_first + 63;
  const int r0 = q0 + 64 * wg + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int r1 = r0 + 8;
  const int qp0 = off + r0, qp1 = off + r1;
  const int cq = 2 * (lane % 4);
  // the exponent's factor: the scale folded in, or with a softcap log2(e)
  // on the capped scores
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale_log2 = softcap > 0.f ? kLog2e : scale * kLog2e;
  const float cap_scale = softcap > 0.f ? scale * (1.f / softcap) : 0.f;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const uint32_t par = (it / kStages) & 1;
    const int k0 = kt0 + it * kBN;
    mbar_wait(bar_k(st), par);
    // a tile that no row of this warpgroup can see: release it unread
    if ((causal && k0 > wg_last) ||
        (window > 0 && wg_first - (k0 + kBN - 1) >= window)) {
      mbar_wait(bar_v(st), par);
      mbar_arrive(bar_e(st));
      continue;
    }

    // S = Q K^T over hd / 16 steps of 16
    float s[kBN / 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      const uint32_t qa =
          sQ + (j / 4) * L::kQBox + wg * 64 * 128 + (j % 4) * 32;
      const uint32_t ka = sK + st * L::kKVTile + (j / 4) * L::kKVBox +
                          (j % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(qa, 16, 1024), sw128_desc(ka, 16, 1024),
                   j > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        s[i] = tanhf(s[i] * cap_scale) * softcap;
    }

    // masks, only where the tile straddles the key bound, the diagonal or
    // the window's edge for some row of this warpgroup
    if (k0 + kBN > klen || (causal && k0 + kBN - 1 > wg_first) ||
        (window > 0 && wg_last - k0 >= window)) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int kpos = k0 + 8 * (i / 4) + cq + (i & 1);
        const int qpos = (i & 2) ? qp1 : qp0;
        const bool ok = kpos < klen && (!causal || kpos <= qpos) &&
                        (window <= 0 || qpos - kpos < window);
        if (!ok) s[i] = -INFINITY;
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
    for (int n = 0; n < HD / 8; ++n) {
      o[4 * n] *= a0;
      o[4 * n + 1] *= a0;
      o[4 * n + 2] *= a1;
      o[4 * n + 3] *= a1;
    }

    // O += P V over kBN / 16 steps of 16 keys
    mbar_wait(bar_v(st), par);
    if (k0 + kBN > klen && klen < Skv) {
      // V rows past the key bound (inside the cache) may hold anything:
      // zero them (whole 128-byte rows of each box, whatever the swizzle),
      // so that p = 0 meets 0.  Both warpgroups write the same zeros; the
      // stage is refilled only after both have released it.
      const int first = max(0, klen - k0), units = kChunks * 8;
      const uint32_t sv = sV + st * L::kKVTile;
      for (int x = threadIdx.x % 128; x < (kBN - first) * units; x += 128) {
        const int row = first + x / units, c = (x % units) / 8, u = x % 8;
        st_zero16(sv + c * L::kKVBox + row * 128 + u * 16);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t vd = sw128_desc(sV + st * L::kKVTile + kk * 16 * 128,
                                     L::kKVBox, 1024);
      if constexpr (HD == 64)
        wgmma_rs_n64(o, pa[kk], vd);
      else if constexpr (HD == 128)
        wgmma_rs_n128(o, pa[kk], vd);
      else if constexpr (HD == 192)
        wgmma_rs_n192(o, pa[kk], vd);
      else
        wgmma_rs_n256(o, pa[kk], vd);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(bar_e(st));
  }

  // out = acc / max(l, 1e-30), the row sums completed across the quad
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  const size_t row_stride = static_cast<size_t>(H) * HD;
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * Sq * row_stride +
                      static_cast<size_t>(h) * HD + cq;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * row_stride + 8 * n) =
          __floats2bfloat162_rn(o[4 * n] * i0, o[4 * n + 1] * i0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * row_stride + 8 * n) =
          __floats2bfloat162_rn(o[4 * n + 2] * i1, o[4 * n + 3] * i1);
  }
}

// ---- host side

// A 4-D map (hd, heads, S, B) of a contiguous (B, S, heads, hd) bf16 tensor,
// read in boxes of (64, 1, rows, 1) with 128-byte swizzle; rows past S read
// as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int hd, int rows) {
  const EncodeTiled enc = encode_fn();
  if (!enc) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(heads) * hd * 2,
                                 static_cast<cuuint64_t>(S) * heads * hd * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBox), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Cards whose kernel at HD has been given its dynamic shared memory size
// (once a card: the attribute stays set for the process).
constexpr int kMaxCards = 64;

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int* q_offset, const int* kv_len, int B, int Sq,
                   int Skv, int H, int KV, float scale, float softcap,
                   int causal, int window, int device, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, Sq, H, HD, kBM) ||
      !make_map(&mk, k, B, Skv, KV, HD, kBN) ||
      !make_map(&mv, v, B, Skv, KV, HD, kBN))
    return cudaErrorInvalidValue;
  auto kern = flash_sm90_kernel<HD>;
  const int smem = Layout<HD>::kBytes;
  static std::atomic<bool> smem_set[kMaxCards];
  if (device < 0 || device >= kMaxCards) return cudaErrorInvalidDevice;
  if (!smem_set[device].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[device].store(true, std::memory_order_release);
  }
  const dim3 grid(H, B, (Sq + kBM - 1) / kBM);
  kern<<<grid, Layout<HD>::kThreads, smem, stream>>>(
      mq, mk, mv, q_offset, kv_len, static_cast<__nv_bfloat16*>(out), Sq,
      Skv, H, KV, scale, softcap, causal, window);
  return cudaGetLastError();
}

}  // namespace attn90

extern "C" {

// Launches the tensor-core flash attention on `stream` of card `device`;
// q_offset and kv_len are (B,) int32 or null (0 and Skv).  The caller
// guarantees bf16 tensors, H % KV == 0, Sq, Skv >= 1,
// contiguous tensors with 16-byte aligned pointers.  Returns
// the cudaError_t of the launch (0 on success; cudaErrorInvalidValue if a
// tensor map cannot be encoded, cudaErrorMisalignedAddress for a pointer
// that is not 16-byte aligned).
int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                void* out, const void* q_offset,
                                const void* kv_len, int B, int Sq, int Skv,
                                int H, int KV, int hd, float scale,
                                float softcap, int causal, int window,
                                int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if ((hd != 64 && hd != 128 && hd != 192 && hd != 256) || KV < 1 ||
      H % KV || Sq < 1 || Skv < 1 || softcap < 0.f)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* off = static_cast<const int*>(q_offset);
  const int* len = static_cast<const int*>(kv_len);
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = hd == 64    ? attn90::launch<64>
                : hd == 128 ? attn90::launch<128>
                : hd == 192 ? attn90::launch<192>
                            : attn90::launch<256>;
  return static_cast<int>(launch(q, k, v, out, off, len, B, Sq, Skv, H, KV,
                                 scale, softcap, causal, window, device, s));
}

// Dynamic shared memory of one CTA at head dim hd (64, 128, 192 or 256;
// 0 for any other).
int flash_attention_sm90_smem_bytes(int hd) {
  return hd == 64    ? attn90::Layout<64>::kBytes
         : hd == 128 ? attn90::Layout<128>::kBytes
         : hd == 192 ? attn90::Layout<192>::kBytes
         : hd == 256 ? attn90::Layout<256>::kBytes
                     : 0;
}

}  // extern "C"
