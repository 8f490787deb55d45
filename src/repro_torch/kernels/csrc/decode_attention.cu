// Single-token GQA decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// decode_attention (kernel body _kernel).  q (B, H, hd) holds one new token
// per batch row; k and v (B, S, KV, hd) are the cache, in fp32 or bf16, the
// JAX package's layout; kv_len (B,) int32.  Query head h reads kv head
// h / G (G = H / KV).  Positions >= min(kv_len[b], S) are masked: they get
// p = 0 and their K and V rows are never read, so a row with kv_len = 0
// gives zeros, as the Pallas kernel does.  Scores (q . k) * scale, the
// running max, denominator and accumulator are fp32 for both input types;
// out = acc / max(l, 1e-30) in q's type.
//
// What bounds it: the cache.  Each valid K and V row is read once and
// carries 2 * G * hd multiply-adds, G = 5 on the serving path: about 2.5
// operations a byte in bf16, far below the card's balance, so the bytes
// bound it (the K and V rows below kv_len, q and out).
//
// Design (simple and right first): one CTA of 256 threads per (kv head,
// batch row), so the G query rows that share a kv head read each K and V
// row once.  The 8 warps take the valid positions in turn (warp w: w,
// w + 8, ...), each lane holding hd / 32 dims of q, of the row and of the
// accumulator; a warp reduces each of its G dot products with shuffles and
// keeps its own running softmax.  The 8 partial softmaxes are merged
// through shared memory at the end.  Split-S across CTAs (more than B * KV
// CTAs on 132 SMs), vector loads and TMA are later work.
//
// Launched through a plain C interface (ctypes), on the caller's stream; it
// allocates nothing and does not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_decode {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGMax = 8;           // query heads per kv head
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

// Shared memory, in floats: each warp's accumulator (G x hd), running max
// and denominator (G each).
inline size_t decode_smem_bytes(int G, int hd) {
  return sizeof(float) * kWarps * static_cast<size_t>(G) * (hd + 2);
}

// HDC = ceil(hd / 32) bound: 2, 4 or 8 dims a lane.
template <typename T, int HDC>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_len,
              T* __restrict__ out, int S, int H, int KV, int hd,
              float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  float* Acc = smem;                               // [kWarps][G][hd]
  float* Mw = Acc + kWarps * G * hd;               // [kWarps][G]
  float* Lw = Mw + kWarps * G;                     // [kWarps][G]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int n = max(0, min(kv_len[b], S));
  const size_t k_row = static_cast<size_t>(KV) * hd;
  const T* qb = q + (static_cast<size_t>(b) * H + kvh * G) * hd;
  const T* kb = k + static_cast<size_t>(b) * S * k_row + kvh * hd;
  const T* vb = v + static_cast<size_t>(b) * S * k_row + kvh * hd;

  float qr[kGMax][HDC], acc[kGMax][HDC], m[kGMax], l[kGMax];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < HDC; ++c) {
      const int d = lane + 32 * c;
      qr[g][c] = g < G && d < hd ? to_f32(qb[g * hd + d]) : 0.f;
      acc[g][c] = 0.f;
    }
  }

  for (int s = warp; s < n; s += kWarps) {
    float kr[HDC], vr[HDC];
#pragma unroll
    for (int c = 0; c < HDC; ++c) {
      const int d = lane + 32 * c;
      kr[c] = d < hd ? to_f32(kb[s * k_row + d]) : 0.f;
      vr[c] = d < hd ? to_f32(vb[s * k_row + d]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      if (g >= G) break;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < HDC; ++c) dot = fmaf(qr[g][c], kr[c], dot);
#pragma unroll
      for (int o = 16; o; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const float sc = dot * scale;
      const float m_new = fmaxf(m[g], sc);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(sc - m_new);
      l[g] = l[g] * alpha + p;
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < HDC; ++c) acc[g][c] = fmaf(p, vr[c],
                                                     acc[g][c] * alpha);
    }
  }

  // merge the warps' partial softmaxes
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int c = 0; c < HDC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) Acc[(warp * G + g) * hd + d] = acc[g][c];
    }
    if (lane == 0) {
      Mw[warp * G + g] = m[g];
      Lw[warp * G + g] = l[g];
    }
  }
  __syncthreads();
  T* ob = out + (static_cast<size_t>(b) * H + kvh * G) * hd;
  for (int x = tid; x < G * hd; x += kThreads) {
    const int g = x / hd, d = x - g * hd;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, Mw[w * G + g]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(Mw[w * G + g] - mx);
      num = fmaf(Acc[(w * G + g) * hd + d], f, num);
      den = fmaf(Lw[w * G + g], f, den);
    }
    from_f32(num / fmaxf(den, 1e-30f), &ob[x]);
  }
}

template <typename T, int HDC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* out, int B, int S, int H,
                   int KV, int hd, float scale, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(H / KV, hd);
  auto kern = decode_kernel<T, HDC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(out), S, H, KV, hd, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v,
                      const void* kv_len, void* out, int B, int S, int H,
                      int KV, int hd, float scale, cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 2>(q, k, v, kv_len, out, B, S, H, KV, hd, scale,
                        stream);
  if (hd <= 128)
    return launch<T, 4>(q, k, v, kv_len, out, B, S, H, KV, hd, scale,
                        stream);
  return launch<T, 8>(q, k, v, kv_len, out, B, S, H, KV, hd, scale, stream);
}

}  // namespace attn_decode

extern "C" {

// Launches decode attention on `stream` of card `device`; `bf16` selects
// the input type (0: fp32).  The caller guarantees 1 <= hd <= 256,
// H % KV == 0, 1 <= H / KV <= 8, contiguous tensors.  Returns the
// cudaError_t of the launch (0 on success).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* kv_len, void* out, int B, int S,
                            int H, int KV, int hd, float scale, int bf16,
                            int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (hd < 1 || hd > 256 || KV < 1 || H % KV ||
      H / KV > attn_decode::kGMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? attn_decode::launch_hd<__nv_bfloat16>(q, k, v, kv_len, out, B,
                                                   S, H, KV, hd, scale, s)
           : attn_decode::launch_hd<float>(q, k, v, kv_len, out, B, S, H,
                                           KV, hd, scale, s);
  return static_cast<int>(err);
}

}  // extern "C"
