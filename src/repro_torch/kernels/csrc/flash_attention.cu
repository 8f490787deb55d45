// Blockwise (flash) GQA attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (kernel body _kernel).  q (B, Sq, H, hd), k and v (B, Skv, KV, hd), in
// fp32 or bf16, the JAX package's layout; out (B, Sq, H, hd) in q's type.
// Query head h reads kv head h / G (G = H / KV, any integer: 5 at
// qwen2.5-14b's width).  Scores are (q . k) * scale in fp32; a score is
// masked to NEG_INF = -1e30 where kpos >= Skv, where causal and kpos > qpos
// (top-left aligned, both from 0), and where window > 0 and
// qpos - kpos >= window.  Running max, denominator and accumulator are fp32
// for both input types; out = acc / max(l, 1e-30).  A masked position
// contributes p = 0 and its V row is never read, so a row with no valid
// key (none on the serving path) gives zeros, where the Pallas kernel
// would average padded V rows.
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

__device__ __forceinline__ bool key_valid(int qpos, int kpos, int Skv,
                                          bool causal, int window) {
  return kpos < Skv && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
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
template <typename T, int HD_MAX>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
             int H, int KV, int hd, float scale, int causal, int window) {
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
  const T* kb = k + (static_cast<size_t>(b) * Skv) * k_row + kvh * hd;
  const T* vb = v + (static_cast<size_t>(b) * Skv) * k_row + kvh * hd;

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

  // the key range any row of this tile can see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j = tid & (kBK - 1), ig = tid / kBK;   // scoring: key j, rows ig + 4r

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    for (int x = tid; x < kBK * hd; x += kThreads) {
      const int jj = x / hd, d = x - jj * hd;
      const bool in = k0 + jj < Skv;
      const size_t off = static_cast<size_t>(k0 + jj) * k_row + d;
      Ks[jj * (hd + 1) + d] = in ? to_f32(kb[off]) : 0.f;
      Vs[jj * hd + d] = in ? to_f32(vb[off]) : 0.f;
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
    for (int r = 0; r < kBQ / 4; ++r) Ps[(ig + 4 * r) * (kBK + 1) + j] =
        s[r] * scale;
    __syncthreads();

    // running softmax: warp w owns rows w, w + 8, w + 16, w + 24
    for (int i = warp; i < kBQ; i += kWarps) {
      const int qpos = q0 + i;
      const bool v0 = qpos < Sq && key_valid(qpos, k0 + lane, Skv, causal,
                                             window);
      const bool v1 = qpos < Sq && key_valid(qpos, k0 + lane + 32, Skv,
                                             causal, window);
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
    const int n_keys = min(kBK, Skv - k0);
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

template <typename T, int HD_MAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int KV, int hd,
                   float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes(hd);
  auto kern = flash_kernel<T, HD_MAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, KV, hd,
      scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v,
                      void* out, int B, int Sq, int Skv, int H, int KV,
                      int hd, float scale, int causal, int window,
                      cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, KV, hd, scale, causal,
                         window, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, KV, hd, scale,
                          causal, window, stream);
  return launch<T, 256>(q, k, v, out, B, Sq, Skv, H, KV, hd, scale, causal,
                        window, stream);
}

}  // namespace attn

extern "C" {

// Launches flash attention on `stream` of card `device`; `bf16` selects
// the input type (0: fp32).  The caller guarantees 1 <= hd <= 256,
// H % KV == 0, Sq, Skv >= 1, contiguous tensors.  Returns the cudaError_t
// of the launch (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Skv, int H, int KV,
                           int hd, float scale, int causal, int window,
                           int bf16, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (hd < 1 || hd > 256 || KV < 1 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? attn::launch_hd<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KV,
                                            hd, scale, causal, window, s)
           : attn::launch_hd<float>(q, k, v, out, B, Sq, Skv, H, KV, hd,
                                    scale, causal, window, s);
  return static_cast<int>(err);
}

}  // extern "C"
