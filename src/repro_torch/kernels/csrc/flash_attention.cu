// Blockwise (flash) GQA attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (kernel body _kernel), and takes the cases the reference's XLA path
// (models/attention.py::gqa_attention) computes around it: queries at an
// offset over a cache bounded by kv_len (a chunked prefill), the logit
// softcap and an int8 cache.  q (B, Sq, H, hd), k and v (B, Skv, KV, hd),
// in fp32 or bf16, the JAX package's layout; out (B, Sq, H, hd) in q's
// type.  Query head h reads kv head h / G (G = H / KV, any integer: 5 at
// qwen2.5-14b's width).  Query i of row b sits at qpos = q_offset[b] + i
// (0 + i without q_offset), key j at kpos = j.  Scores are (q . k) * scale
// in fp32, then with softcap > 0 tanh(s * (1 / softcap)) * softcap; a
// score is masked to NEG_INF = -1e30 where kpos >= min(kv_len[b], Skv)
// (Skv without kv_len), where causal and kpos > qpos, and where window > 0
// and qpos - kpos >= window.  Running max, denominator and accumulator are
// fp32 for both input types; out = acc / max(l, 1e-30).  A masked
// position contributes p = 0 and its V row past the key bound is never
// read, so a row with no valid key (none on the serving path) gives zeros,
// where the Pallas kernel would average padded V rows.  An int8 cache
// (k, v int8; k_scale, v_scale (B, Skv, KV) fp32) is dequantized on load,
// each element rounded to q's type as the reference's dequant_kv does
// ((float) k * scale, then to bf16 or fp32) before it enters a product:
// the cache is read as int8, with no dequantized copy.
//
// What bounds it: at the serving path's prefill (H = 40, KV = 8, hd = 128,
// causal) the work is 2 * 2 * Sq * Skv / 2 * H * hd operations against
// ~(2 Sq H + 2 Skv KV) * hd elements moved, so operations bound it above a
// few hundred rows; this simple kernel runs them on the CUDA cores in fp32
// (67 TFLOP/s peak), not on the tensor cores.
//
// Design (simple and right first): one CTA of 256 threads per (query tile
// of 32 rows, q head, batch row).  The CTA stages its Q tile once and then
// loops over KV tiles of 64 rows in shared memory (converted to fp32 on
// load; K rows padded by one word against bank conflicts).  Per tile: each
// thread scores one key against 8 query rows, one warp per 4 rows updates
// the running max and denominator with shuffles, and each thread updates
// its share of the (32 x hd) accumulator, kept in registers.  KV tiles
// that the causal or window mask leaves wholly empty for the whole Q tile
// are skipped.  Tensor cores (mma / wgmma), TMA and warp specialisation are
// later work.
//
// Launched through a plain C interface (ctypes), on the caller's stream; it
// allocates nothing and does not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;            // query rows per CTA
constexpr int kBK = 64;            // key rows per shared-memory tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

__device__ __forceinline__ bool key_valid(int qpos, int kpos, int klen,
                                          bool causal, int window) {
  return kpos < klen && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
}

// f rounded to T and back (the activations' type of a dequantized value)
__device__ __forceinline__ float round_to(float f, const float*) { return f; }
__device__ __forceinline__ float round_to(float f, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(f));
}

// An element of k or v as the products read it: fp32 from T, or an int8
// cache's value dequantized and rounded to T.
template <typename T>
__device__ __forceinline__ float kv_elem(const T* p, size_t off,
                                         const float*) {
  return to_f32(p[off]);
}
template <typename T>
__device__ __forceinline__ float kv_elem(const int8_t* p, size_t off,
                                         const float* scale) {
  return round_to(static_cast<float>(p[off]) * *scale,
                  static_cast<const T*>(nullptr));
}

// Shared memory, in floats: Q (kBQ x hd), K (kBK x (hd + 1)), V (kBK x hd),
// scores / probabilities (kBQ x (kBK + 1)), running max, denominator and
// rescale factor (kBQ each).
inline size_t flash_smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * hd +
                          static_cast<size_t>(kBK) * (hd + 1) +
                          static_cast<size_t>(kBK) * hd +
                          kBQ * (kBK + 1) + 3 * kBQ);
}

// HD_MAX bounds hd (64, 128 or 256): it sizes the per-thread accumulator.
// KT is k's and v's type: T, or int8_t for an int8 cache.
template <typename T, typename KT, int HD_MAX>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const KT* __restrict__ k,
             const KT* __restrict__ v, const float* __restrict__ k_scale,
             const float* __restrict__ v_scale,
             const int* __restrict__ q_offset, const int* __restrict__ kv_len,
             T* __restrict__ out, int Sq, int Skv, int H, int KV, int hd,
             float scale, float softcap, int causal, int window) {
  constexpr int kAcc = kBQ * HD_MAX / kThreads;
  extern __shared__ float smem[];
  float* Qs = smem;                          // [kBQ][hd]
  float* Ks = Qs + kBQ * hd;                 // [kBK][hd + 1]
  float* Vs = Ks + kBK * (hd + 1);           // [kBK][hd]
  float* Ps = Vs + kBK * hd;                 // [kBQ][kBK + 1]
  float* Ms = Ps + kBQ * (kBK + 1);          // running max
  float* Ls = Ms + kBQ;                      // running denominator
  float* As = Ls + kBQ;                      // this tile's rescale factor

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_row = static_cast<size_t>(H) * hd;     // stride of a qpos
  const size_t k_row = static_cast<size_t>(KV) * hd;    // stride of a kpos
  const T* qb = q + (static_cast<size_t>(b) * Sq) * q_row + h * hd;
  const KT* kb = k + (static_cast<size_t>(b) * Skv) * k_row + kvh * hd;
  const KT* vb = v + (static_cast<size_t>(b) * Skv) * k_row + kvh * hd;
  // an int8 cache's scales: one a (position, kv head)
  const size_t s_base = static_cast<size_t>(b) * Skv * KV + kvh;
  const int off = q_offset ? q_offset[b] : 0;
  const int klen = kv_len ? max(0, min(kv_len[b], Skv)) : Skv;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  for (int x = tid; x < kBQ * hd; x += kThreads) {
    const int i = x / hd, d = x - i * hd;
    Qs[x] = q0 + i < Sq ? to_f32(qb[(q0 + i) * q_row + d]) : 0.f;
  }
  if (tid < kBQ) {
    Ms[tid] = kNegInf;
    Ls[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = 0.f;

  // the key range any row of this tile can see (positions)
  const int q_last = off + min(q0 + kBQ, Sq) - 1;
  const int k_end = causal ? min(klen, q_last + 1) : klen;
  const int k_lo = window > 0 ? max(0, off + q0 - window + 1) : 0;
  const int j = tid & (kBK - 1), ig = tid / kBK;   // scoring: key j, rows ig + 4r

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    for (int x = tid; x < kBK * hd; x += kThreads) {
      const int jj = x / hd, d = x - jj * hd;
      const bool in = k0 + jj < klen;   // rows past the bound: never read
      const size_t e = static_cast<size_t>(k0 + jj) * k_row + d;
      const size_t si = s_base + static_cast<size_t>(k0 + jj) * KV;
      Ks[jj * (hd + 1) + d] = in ? kv_elem<T>(kb, e, k_scale + si) : 0.f;
      Vs[jj * hd + d] = in ? kv_elem<T>(vb, e, v_scale + si) : 0.f;
    }
    __syncthreads();

    // scores: thread (ig, j) takes key j against rows ig, ig + 4, ...
    float s[kBQ / 4];
#pragma unroll
    for (int r = 0; r < kBQ / 4; ++r) s[r] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float kv = Ks[j * (hd + 1) + d];
#pragma unroll
      for (int r = 0; r < kBQ / 4; ++r)
        s[r] = fmaf(Qs[(ig + 4 * r) * hd + d], kv, s[r]);
    }
#pragma unroll
    for (int r = 0; r < kBQ / 4; ++r) {
      float sc = s[r] * scale;
      if (softcap > 0.f) sc = tanhf(sc * inv_cap) * softcap;
      Ps[(ig + 4 * r) * (kBK + 1) + j] = sc;
    }
    __syncthreads();

    // running softmax: warp w owns rows w, w + 8, w + 16, w + 24
    for (int i = warp; i < kBQ; i += kWarps) {
      const int qpos = off + q0 + i;
      const bool live = q0 + i < Sq;
      const bool v0 = live && key_valid(qpos, k0 + lane, klen, causal,
                                        window);
      const bool v1 = live && key_valid(qpos, k0 + lane + 32, klen, causal,
                                        window);
      const float s0 = v0 ? Ps[i * (kBK + 1) + lane] : kNegInf;
      const float s1 = v1 ? Ps[i * (kBK + 1) + lane + 32] : kNegInf;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = Ms[i];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = v0 ? expf(s0 - m_new) : 0.f;
      const float p1 = v1 ? expf(s1 - m_new) : 0.f;
      Ps[i * (kBK + 1) + lane] = p0;
      Ps[i * (kBK + 1) + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        As[i] = alpha;
        Ls[i] = Ls[i] * alpha + sum;
        Ms[i] = m_new;
      }
    }
    __syncthreads();

    // accumulator: thread owns (row, dim) pairs tid, tid + 256, ...
    const int n_keys = min(kBK, klen - k0);
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int x = tid + r * kThreads;
      if (x < kBQ * hd) {
        const int i = x / hd, d = x - i * hd;
        float a = acc[r] * As[i];
        const float* pi = Ps + i * (kBK + 1);
        for (int jj = 0; jj < n_keys; ++jj)
          a = fmaf(pi[jj], Vs[jj * hd + d], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();

  T* ob = out + (static_cast<size_t>(b) * Sq) * q_row + h * hd;
#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int x = tid + r * kThreads;
    if (x < kBQ * hd) {
      const int i = x / hd, d = x - i * hd;
      if (q0 + i < Sq)
        from_f32(acc[r] / fmaxf(Ls[i], 1e-30f),
                 &ob[(q0 + i) * q_row + d]);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;
  const int *q_offset, *kv_len;
  void* out;
  int B, Sq, Skv, H, KV, hd;
  float scale, softcap;
  int causal, window;
};

template <typename T, typename KT, int HD_MAX>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes(a.hd);
  auto kern = flash_kernel<T, KT, HD_MAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), a.k_scale, a.v_scale, a.q_offset,
      a.kv_len, static_cast<T*>(a.out), a.Sq, a.Skv, a.H, a.KV, a.hd,
      a.scale, a.softcap, a.causal, a.window);
  return cudaGetLastError();
}

template <typename T, typename KT>
cudaError_t launch_hd(const Args& a, cudaStream_t stream) {
  if (a.hd <= 64) return launch<T, KT, 64>(a, stream);
  if (a.hd <= 128) return launch<T, KT, 128>(a, stream);
  return launch<T, KT, 256>(a, stream);
}

}  // namespace attn

extern "C" {

// Launches flash attention on `stream` of card `device`; `bf16` selects
// q's type (0: fp32); k_scale and v_scale non-null make k and v an int8
// cache; q_offset and kv_len are (B,) int32 or null (0 and Skv).  The
// caller guarantees 1 <= hd <= 256, H % KV == 0, Sq, Skv >= 1, contiguous
// tensors.  Returns the cudaError_t of the launch (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, const void* k_scale,
                           const void* v_scale, const void* q_offset,
                           const void* kv_len, int B, int Sq, int Skv, int H,
                           int KV, int hd, float scale, float softcap,
                           int causal, int window, int bf16, int device,
                           void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (hd < 1 || hd > 256 || KV < 1 || H % KV || softcap < 0.f ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const attn::Args a{q, k, v, static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale),
                     static_cast<const int*>(q_offset),
                     static_cast<const int*>(kv_len), out, B, Sq, Skv, H,
                     KV, hd, scale, softcap, causal, window};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool int8 = k_scale != nullptr;
  cudaError_t err;
  if (bf16)
    err = int8 ? attn::launch_hd<__nv_bfloat16, int8_t>(a, s)
               : attn::launch_hd<__nv_bfloat16, __nv_bfloat16>(a, s);
  else
    err = int8 ? attn::launch_hd<float, int8_t>(a, s)
               : attn::launch_hd<float, float>(a, s);
  return static_cast<int>(err);
}

}  // extern "C"
