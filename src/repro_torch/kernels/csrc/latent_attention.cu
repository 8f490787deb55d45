// The absorbed MLA's attention over the latent cache (DeepSeek-V2) on the
// CUDA cores, for fp32 and for the bf16 shapes the tensor-core kernel does
// not take (kernels/ops.py::latent_route "simt"; bf16 with D and Dv
// multiples of 8 runs latent_attention_sm90.cu, whose header says what
// bounds this attention on the card).  Replaces no Pallas kernel: the
// reference computes it in XLA (repro/models/attention.py:313).
//
// Semantics: q (B, Sq, H, D), lat (B, Sk, D), K the whole latent row and V
// its first Dv columns, out (B, Sq, H, Dv) in q's type; query i of row b at
// qpos = q_offset[b] + i reads the keys j <= qpos with j < min(kv_len[b],
// Sk); scores (q . k) * scale (the caller's); max, denominator and
// accumulator in fp32; out = acc / max(l, 1e-30).
//
// Design: one CTA of 256 threads per (key split, query position, batch row)
// holds all H heads of that position.  The keys [0, min(kv_len, qpos + 1))
// are split as the decode kernel splits its cache (kernels/ops.py::
// decode_splits, with B * Sq rows).  A split walks its keys in chunks of 32
// rows staged in shared memory in fp32 (row pitch D + 1 words against bank
// conflicts); per chunk each thread scores one key against two heads, one
// warp per two heads updates the running max and denominator, and each
// thread accumulates two of the Dv columns for all H heads, reading V from
// the same staged rows.  Each split writes its partial (m, l, acc) in fp32
// to scratch the wrapper allocates, and the last CTA of a (row, query
// position) to finish (an atomic counter, reset by that CTA) merges them,
// so a call is one launch; with one split the CTA writes the output
// directly.
//
// Launched through a plain C interface (ctypes), on the caller's stream; it
// allocates nothing and does not synchronise.  The counters must be zero
// before the launch and are zero after it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_latent {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHMax = 16;          // query heads
constexpr int kDMax = 576;         // latent columns
constexpr int kDvMax = 512;        // value columns
constexpr int kCh = 32;            // keys a chunk
constexpr int kCols = kDvMax / kThreads;   // value columns a thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

// The chunk's rows (kCh x (D + 1) floats), whose room the merge's weights
// ((n_split + 1) x kHMax) reuse.
__host__ __device__ inline int rows_floats(int D, int n_split) {
  const int rows = kCh * (D + 1), merge = (n_split + 1) * kHMax;
  return rows > merge ? rows : merge;
}

// Shared memory, in floats: Q (kHMax x D), the chunk's rows, scores /
// probabilities (kHMax x (kCh + 1)), running max, denominator and rescale
// (kHMax each), then the merge flag.
inline int smem_bytes(int D, int n_split) {
  return 4 * (kHMax * D + rows_floats(D, n_split) + kHMax * (kCh + 1) +
              3 * kHMax + 1);
}

// Two CTAs a multiprocessor: shared memory (about 113 KB a CTA at D = 576)
// allows no more, so each thread may hold 128 registers; without the bound
// ptxas aims at 64 and spills the accumulators.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
latent_kernel(const T* __restrict__ q, const T* __restrict__ lat,
              const int* __restrict__ q_offset,
              const int* __restrict__ kv_len, T* __restrict__ out,
              float* __restrict__ part_acc, float* __restrict__ part_ml,
              int* __restrict__ counter, int Sq, int Sk, int H, int D,
              int Dv, float scale, int split_len) {
  extern __shared__ float smem[];
  float* Qs = smem;                          // [kHMax][D]
  float* Ks = Qs + kHMax * D;                // [kCh][D + 1]
  float* Ps = Ks + rows_floats(D, gridDim.x);   // [kHMax][kCh + 1]
  float* Ms = Ps + kHMax * (kCh + 1);
  float* Ls = Ms + kHMax;
  float* As = Ls + kHMax;
  int* last = reinterpret_cast<int*>(As + kHMax);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, i = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int qpos = (q_offset ? q_offset[b] : 0) + i;
  const int klen = kv_len ? max(0, min(kv_len[b], Sk)) : Sk;
  const int kend = max(0, min(klen, qpos + 1));
  const int s0 = split * split_len, s1 = min(s0 + split_len, kend);
  const size_t bi = static_cast<size_t>(b) * Sq + i;   // (row, position)
  const T* qb = q + bi * H * D;
  const T* lb = lat + static_cast<size_t>(b) * Sk * D;

  for (int x = tid; x < kHMax * D; x += kThreads) {
    const int g = x / D;
    Qs[x] = g < H ? to_f32(qb[x]) : 0.f;
  }
  if (tid < kHMax) {
    Ms[tid] = kNegInf;
    Ls[tid] = 0.f;
  }
  float acc[kHMax][kCols];
#pragma unroll
  for (int g = 0; g < kHMax; ++g)
#pragma unroll
    for (int u = 0; u < kCols; ++u) acc[g][u] = 0.f;

  const int j = tid % kCh, gs = tid / kCh;   // scoring: key j, heads gs, +8
  for (int c0 = s0; c0 < s1; c0 += kCh) {
    const int cnt = min(kCh, s1 - c0);
    __syncthreads();   // the previous chunk's readers are done
    for (int x = tid; x < cnt * D; x += kThreads) {
      const int r = x / D, d = x - r * D;
      Ks[r * (D + 1) + d] = to_f32(lb[static_cast<size_t>(c0 + r) * D + d]);
    }
    __syncthreads();

    if (j < cnt) {
      float s_lo = 0.f, s_hi = 0.f;
      const float* kr = Ks + j * (D + 1);
      const float* qlo = Qs + gs * D;
      const float* qhi = Qs + (gs + 8) * D;
      for (int d = 0; d < D; ++d) {
        const float kv = kr[d];
        s_lo = fmaf(qlo[d], kv, s_lo);
        s_hi = fmaf(qhi[d], kv, s_hi);
      }
      Ps[gs * (kCh + 1) + j] = s_lo * scale;
      Ps[(gs + 8) * (kCh + 1) + j] = s_hi * scale;
    }
    __syncthreads();

    // running softmax: warp w owns heads w and w + 8, lane = key
    for (int g = warp; g < H; g += kWarps) {
      const bool ok = lane < cnt;
      const float sv = ok ? Ps[g * (kCh + 1) + lane] : kNegInf;
      float mx = sv;
#pragma unroll
      for (int o = 16; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = Ms[g], m_new = fmaxf(m_prev, mx);
      const float p = ok ? expf(sv - m_new) : 0.f;
      Ps[g * (kCh + 1) + lane] = p;
      float sum = p;
#pragma unroll
      for (int o = 16; o; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        As[g] = alpha;
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: thread owns columns tid, tid + 256 of V
#pragma unroll
    for (int g = 0; g < kHMax; ++g) {
      if (g < H) {
        const float a = As[g];
#pragma unroll
        for (int u = 0; u < kCols; ++u) acc[g][u] *= a;
      }
    }
    for (int jj = 0; jj < cnt; ++jj) {
      float vv[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int c = tid + u * kThreads;
        vv[u] = c < Dv ? Ks[jj * (D + 1) + c] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kHMax; ++g) {
        if (g < H) {
          const float p = Ps[g * (kCh + 1) + jj];
#pragma unroll
          for (int u = 0; u < kCols; ++u) acc[g][u] = fmaf(p, vv[u],
                                                          acc[g][u]);
        }
      }
    }
  }
  __syncthreads();

  T* ob = out + bi * H * Dv;
  if (n_split == 1) {
#pragma unroll
    for (int g = 0; g < kHMax; ++g)
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int c = tid + u * kThreads;
        if (g < H && c < Dv)
          from_f32(acc[g][u] / fmaxf(Ls[g], 1e-30f), &ob[g * Dv + c]);
      }
    return;
  }
  // this split's partial, then the last split of (b, i) merges all:
  // out = sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30), w_s = e^(m_s - M)
  float* pa = part_acc + (bi * n_split + split) * H * Dv;
  float* pm = part_ml + (bi * n_split + split) * H * 2;
#pragma unroll
  for (int g = 0; g < kHMax; ++g)
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int c = tid + u * kThreads;
      if (g < H && c < Dv) pa[g * Dv + c] = acc[g][u];
    }
  if (tid < H) {
    pm[2 * tid] = Ms[tid];
    pm[2 * tid + 1] = Ls[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(counter + bi, 1) == n_split - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const float* qa = part_acc + bi * n_split * H * Dv;
  const float* qm = part_ml + bi * n_split * H * 2;
  float* w = Ks;                       // [n_split][H]: m_s, then w_s
  float* den = Ks + n_split * H;       // [H]
  for (int x = tid; x < n_split * H; x += kThreads) w[x] = __ldcg(qm + 2 * x);
  __syncthreads();
  if (tid < H) {
    float mx = kNegInf;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, w[s * H + tid]);
    float dsum = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float f = expf(w[s * H + tid] - mx);
      w[s * H + tid] = f;
      dsum = fmaf(__ldcg(qm + 2 * (s * H + tid) + 1), f, dsum);
    }
    den[tid] = fmaxf(dsum, 1e-30f);
  }
  __syncthreads();
  for (int x = tid; x < H * Dv; x += kThreads) {
    const int g = x / Dv;
    float num = 0.f;
    for (int s = 0; s < n_split; ++s)
      num = fmaf(__ldcg(qa + static_cast<size_t>(s) * H * Dv + x),
                 w[s * H + g], num);
    from_f32(num / den[g], &ob[x]);
  }
  if (tid == 0) counter[bi] = 0;
}

template <typename T>
cudaError_t launch(const void* q, const void* lat, const int* q_offset,
                   const int* kv_len, void* out, float* part_acc,
                   float* part_ml, int* counter, int B, int Sq, int Sk,
                   int H, int D, int Dv, float scale, int n_split,
                   int split_len, cudaStream_t stream) {
  const int smem = smem_bytes(D, n_split);
  auto kern = latent_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_split, Sq, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(lat), q_offset,
      kv_len, static_cast<T*>(out), part_acc, part_ml, counter, Sq, Sk, H,
      D, Dv, scale, split_len);
  return cudaGetLastError();
}

}  // namespace attn_latent

extern "C" {

// Launches the latent attention on `stream` of card `device`; `bf16`
// selects the type of q, lat and out (0: fp32); q_offset and kv_len are
// (B,) int32 or null (0 and Sk).  The caller guarantees 1 <= H <= 16,
// 1 <= Dv <= min(D, 512), D <= 576, contiguous tensors, n_split *
// split_len >= Sk and, when n_split > 1, scratch of B * Sq * n_split * H *
// Dv floats (part_acc) and of B * Sq * n_split * H * 2 (part_ml) and B *
// Sq zeroed int32 counters.  One kernel launch.  Returns the cudaError_t of
// the launch (0 on success).
int latent_attention_launch(const void* q, const void* lat,
                            const void* q_offset, const void* kv_len,
                            void* out, void* part_acc, void* part_ml,
                            void* counter, int B, int Sq, int Sk, int H,
                            int D, int Dv, float scale, int n_split,
                            int split_len, int bf16, int device,
                            void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (H < 1 || H > attn_latent::kHMax || D < 1 || D > attn_latent::kDMax ||
      Dv < 1 || Dv > D || Dv > attn_latent::kDvMax ||
      n_split < 1 || split_len < 1 ||
      static_cast<long long>(n_split) * split_len < Sk ||
      (n_split > 1 && (!part_acc || !part_ml || !counter)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(q_offset);
  const int* len = static_cast<const int*>(kv_len);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int* cnt = static_cast<int*>(counter);
  const cudaError_t err =
      bf16 ? attn_latent::launch<__nv_bfloat16>(q, lat, off, len, out, pa,
                                                pm, cnt, B, Sq, Sk, H, D, Dv,
                                                scale, n_split, split_len,
                                                s)
           : attn_latent::launch<float>(q, lat, off, len, out, pa, pm, cnt,
                                        B, Sq, Sk, H, D, Dv, scale, n_split,
                                        split_len, s);
  return static_cast<int>(err);
}

// Dynamic shared memory of one CTA at D latent columns and n_split splits.
int latent_attention_smem_bytes(int D, int n_split) {
  return attn_latent::smem_bytes(D, n_split);
}

}  // extern "C"
