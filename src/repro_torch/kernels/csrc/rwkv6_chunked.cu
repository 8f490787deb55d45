// RWKV6 chunked linear attention from a zero state, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_chunked
// (kernel body _kernel).  r, k (B, S, H, K) and v (B, S, H, V) in fp32 or
// bf16, logw (B, S, H, K) fp32 and u (H, K) fp32, the model's layout read
// directly (no transposes).  Per (batch row b, head h), from S = 0:
//
//   y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),
//   S_t = diag(exp(clip(logw_t, -4, 0))) S_{t-1} + k_t v_t^T,
//
// in chunks of L steps, the Pallas kernel's chunk-factorized form: with cum
// the inclusive cumsum of the clipped log-decay over the chunk, cum_exc =
// cum - logw and tot = cum[L - 1],
//
//   A[i][j] = sum_c r[i][c] e^{cum_exc[i][c]} k[j][c] e^{-cum[j][c]}, j < i
//   y[i]    = sum_{j<i} A[i][j] v[j] + (r[i] e^{cum_exc[i]}) S
//             + (sum_c r[i][c] u[c] k[i][c]) v[i]
//   S       = e^{tot} S + sum_j (k[j] e^{tot - cum[j]})^T v[j]
//
// y (B, S, H, V) and the final state (B, H, K, V) are fp32.  Rows past S
// (the tail of the last chunk) are identity rows: they load as r = k = v =
// 0 and logw = 0, so they add nothing to the state and decay nothing, and
// their y is not stored; this is the zero padding of the reference's
// models/linear_scan.py without a padded copy.
//
// What bounds it: bytes and fp32 operations about equally.  Each element
// of r, k, v, logw is read once and y written once; a chunk of one (b, h)
// carries 2 L K V multiply-adds against the state (plus the L^2 pair
// terms) for 14 KB of input and output at L = 16, K = V = 64 with bf16 r,
// k, v: ~19 fp32 operations a byte, at the card's fp32 balance (67 TFLOP/s
// over 3.35 TB/s, ~20).  On the serving path (B = 1, H = 32, S <= 512)
// both bounds are a few microseconds, and the kernel's serial chain of
// S / L chunks, each five dependent phases, sets its time.
//
// Design (simple and right first): one CTA of 256 threads per (b, h) and a
// loop over the chunks, the sequential grid axis of the Pallas kernel.  The
// (K, V) fp32 state lives in shared memory (16 KB at 64 x 64) for the
// whole sequence.  Each chunk, with __syncthreads between the phases:
//   1. the r, k, v, logw tiles go from registers to shared memory (bf16
//      converted to fp32 here, logw clipped), and the next chunk's tiles
//      are loaded into registers in their own type, in flight while this
//      chunk computes;
//   2. K threads take the per-channel cumsum over L in place (and cum_exc
//      = cum - logw, as the Pallas kernel forms it); then every thread
//      forms the decayed tiles r e^{cum_exc}, k e^{-cum}, k e^{tot - cum}
//      and r u elementwise;
//   3. one thread per (i, j <= i) forms the pair matrix: one dot product
//      over K, of r e^{cum_exc} with k e^{-cum} below the diagonal and of
//      r u with k on it (the u-bonus); zeros above;
//   4. one thread per (column, four rows) forms y;
//   5. one thread per (column, K / 4 state rows) updates S in registers.
// Each element keeps one sum in order (over j, then over K), so a result
// does not depend on the specialisation.  Tiles are zeroed once and rows
// are padded to 68 floats: K, L and the tile rows are read four at a time
// (float4; the pad columns and rows stay zero), and eight rows read at one
// column fall in distinct banks.  The serving path's K = V = 64, L = 16 is
// a compile-time specialisation (its loops unrolled); other sizes take the
// same code with the sizes at run time.  wgmma on the pair and state
// products, TMA loads and splitting S over CTAs (B * H = 32 CTAs on 132
// SMs) are later work.
//
// Launched through a plain C interface (ctypes), on the caller's stream; it
// allocates nothing and does not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rwkv6 {

constexpr int kThreads = 256;
constexpr int kMaxL = 16;          // chunk length
constexpr int kMaxKV = 64;         // K and V
constexpr int kRow = kMaxKV + 4;   // row stride of a (L, K) tile, 16-byte rows
constexpr int kARow = kMaxL + 4;   // row stride of the pair matrix
constexpr int kPer = kMaxL * kMaxKV / kThreads;   // tile elements a thread
constexpr int kGroups = kThreads / kMaxKV;        // row groups of phases 4-5
constexpr int kStRows = kMaxKV / kGroups;         // state rows a thread
constexpr float kLogDecayMin = -4.f;
// the (L, K) tiles
enum { kR = 0, kK, kLw, kRd, kKi, kKd, kTiles };
// kLw: clipped logw, then its cumsum, then r u; kRd: cum_exc, then
// r e^{cum_exc}; kKi: k e^{-cum}; kKd: k e^{tot - cum}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T zero_of() { return T(0.f); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Thread tid's elements tid + m * kThreads of one chunk's r, k, logw
// (L, K) and v (L, V) tiles into registers, in their own types (converted
// when stored, so the loads stay in flight); rows past S are identity rows.
template <typename T>
__device__ __forceinline__ void load_tiles(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ logw, int b, int h,
    int S, int H, int K, int V, int L, int t0, T (&pr)[kPer],
    T (&pk)[kPer], float (&pl)[kPer], T (&pv)[kPer]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int x = tid + m * kThreads;
    pr[m] = pk[m] = pv[m] = zero_of<T>();
    pl[m] = 0.f;
    if (x < L * K) {
      const int i = x / K, c = x - i * K, t = t0 + i;
      if (t < S) {
        const size_t off =
            ((static_cast<size_t>(b) * S + t) * H + h) * K + c;
        pr[m] = r[off];
        pk[m] = k[off];
        pl[m] = logw[off];
      }
    }
    if (x < L * V) {
      const int i = x / V, c = x - i * V, t = t0 + i;
      if (t < S) pv[m] = v[((static_cast<size_t>(b) * S + t) * H + h) * V + c];
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// KVF, LF: compile-time K = V and L, or 0 for the sizes given at run time.
template <typename T, int KVF, int LF>
__global__ void __launch_bounds__(kThreads)
rwkv6_chunked_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ logw,
                     const float* __restrict__ u, float* __restrict__ y,
                     float* __restrict__ state_out, int S, int H, int K_,
                     int V_, int L_) {
  const int K = KVF ? KVF : K_, V = KVF ? KVF : V_, L = LF ? LF : L_;
  const int K4 = (K + 3) / 4, L4 = (L + 3) / 4;
  __shared__ __align__(16) float tl[kTiles][kMaxL][kRow];
  __shared__ __align__(16) float A[kMaxL][kARow];   // the pair matrix
  __shared__ float st[kMaxKV][kMaxKV];   // the carried state S[c][col]
  __shared__ float vs[kMaxL][kMaxKV];    // v
  __shared__ float us[kMaxKV];           // u of this head
  __shared__ float tot[kMaxKV];          // the chunk's total log-decay
  __shared__ float etot[kMaxKV];         // e^{tot}

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int col = tid % kMaxKV, grp = tid / kMaxKV;   // phases 4-5
  for (int x = tid; x < kTiles * kMaxL * kRow; x += kThreads)
    (&tl[0][0][0])[x] = 0.f;
  for (int x = tid; x < kMaxL * kARow; x += kThreads) (&A[0][0])[x] = 0.f;
  for (int x = tid; x < kMaxKV * kMaxKV; x += kThreads) (&st[0][0])[x] = 0.f;
  for (int x = tid; x < kMaxL * kMaxKV; x += kThreads) (&vs[0][0])[x] = 0.f;
  if (tid < kMaxKV) {
    us[tid] = tid < K ? u[static_cast<size_t>(h) * K + tid] : 0.f;
    tot[tid] = etot[tid] = 0.f;
  }

  T pr[kPer], pk[kPer], pv[kPer];
  float pl[kPer];
  load_tiles(r, k, v, logw, b, h, S, H, K, V, L, 0, pr, pk, pl, pv);
  __syncthreads();
  const int n_chunks = (S + L - 1) / L;
  for (int n = 0; n < n_chunks; ++n) {
    const int t0 = n * L;
    // 1. this chunk's tiles into shared memory, the next one's loads issued
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int x = tid + m * kThreads;
      if (x < L * K) {
        const int i = x / K, c = x - i * K;
        tl[kR][i][c] = to_f32(pr[m]);
        tl[kK][i][c] = to_f32(pk[m]);
        tl[kLw][i][c] = fminf(fmaxf(pl[m], kLogDecayMin), 0.f);
      }
      if (x < L * V) {
        const int i = x / V;
        vs[i][x - i * V] = to_f32(pv[m]);
      }
    }
    __syncthreads();
    if (n + 1 < n_chunks)
      load_tiles(r, k, v, logw, b, h, S, H, K, V, L, t0 + L, pr, pk, pl, pv);

    // 2. per-channel inclusive cumsum over the chunk, in place
    if (tid < K) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxL; ++i) {
        if (i < L) {
          const float lw = tl[kLw][i][tid];
          acc += lw;
          tl[kLw][i][tid] = acc;
          tl[kRd][i][tid] = acc - lw;
        }
      }
      tot[tid] = acc;
      etot[tid] = expf(acc);
    }
    __syncthreads();
    //    the decayed tiles and r u, elementwise
    for (int x = tid; x < L * K; x += kThreads) {
      const int i = x / K, c = x - i * K;
      const float cum = tl[kLw][i][c], rv = tl[kR][i][c], kv = tl[kK][i][c];
      tl[kRd][i][c] = rv * expf(tl[kRd][i][c]);
      tl[kKi][i][c] = kv * expf(-cum);
      tl[kKd][i][c] = kv * expf(tot[c] - cum);
      tl[kLw][i][c] = rv * us[c];
    }
    __syncthreads();

    // 3. the pair matrix: below the diagonal (r e^{cum_exc}) . (k e^{-cum}),
    //    on it (r u) . k, zeros above (from the start)
    for (int x = tid; x < L * L; x += kThreads) {
      const int i = x / L, j = x - i * L;
      if (j <= i) {
        const float4* xr =
            reinterpret_cast<const float4*>(tl[j < i ? kRd : kLw][i]);
        const float4* yr =
            reinterpret_cast<const float4*>(j < i ? tl[kKi][j] : tl[kK][i]);
        float a = 0.f;
#pragma unroll 4
        for (int q = 0; q < K4; ++q) a = dot4(xr[q], yr[q], a);
        A[i][j] = a;
      }
    }
    __syncthreads();

    // 4. y = A v + r_dec S (the state as it stood before the chunk): rows
    //    grp, grp + 4, ... of column col
    if (col < V) {
      float acc[kMaxL / kGroups];
#pragma unroll
      for (int m = 0; m < kMaxL / kGroups; ++m) acc[m] = 0.f;
#pragma unroll 4
      for (int q = 0; q < L4; ++q) {
        const float4 v4 = make_float4(vs[4 * q][col], vs[4 * q + 1][col],
                                      vs[4 * q + 2][col], vs[4 * q + 3][col]);
#pragma unroll
        for (int m = 0; m < kMaxL / kGroups; ++m)
          acc[m] = dot4(*reinterpret_cast<const float4*>(
                            &A[grp + kGroups * m][4 * q]), v4, acc[m]);
      }
#pragma unroll 4
      for (int q = 0; q < K4; ++q) {
        const float4 s4 = make_float4(st[4 * q][col], st[4 * q + 1][col],
                                      st[4 * q + 2][col], st[4 * q + 3][col]);
#pragma unroll
        for (int m = 0; m < kMaxL / kGroups; ++m)
          acc[m] = dot4(*reinterpret_cast<const float4*>(
                            &tl[kRd][grp + kGroups * m][4 * q]), s4, acc[m]);
      }
#pragma unroll
      for (int m = 0; m < kMaxL / kGroups; ++m) {
        const int i = grp + kGroups * m, t = t0 + i;
        if (i < L && t < S)
          y[((static_cast<size_t>(b) * S + t) * H + h) * V + col] = acc[m];
      }
    }
    __syncthreads();

    // 5. S = e^{tot} S + k_dec^T v: state rows c0 .. c0 + 15 of column col,
    //    in registers
    if (col < V) {
      const int c0 = grp * kStRows;
      float acc[kStRows];
#pragma unroll
      for (int m = 0; m < kStRows; ++m)
        acc[m] = etot[c0 + m] * st[c0 + m][col];
#pragma unroll 4
      for (int j = 0; j < L; ++j) {
        const float vj = vs[j][col];
        const float4* kr = reinterpret_cast<const float4*>(&tl[kKd][j][c0]);
#pragma unroll
        for (int q = 0; q < kStRows / 4; ++q) {
          const float4 k4 = kr[q];
          acc[4 * q] = fmaf(k4.x, vj, acc[4 * q]);
          acc[4 * q + 1] = fmaf(k4.y, vj, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(k4.z, vj, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(k4.w, vj, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int m = 0; m < kStRows; ++m)
        if (c0 + m < K) st[c0 + m][col] = acc[m];
    }
    __syncthreads();
  }

  float* so = state_out + static_cast<size_t>(bh) * K * V;
  for (int x = tid; x < K * V; x += kThreads) so[x] = st[x / V][x % V];
}

template <typename T, int KVF, int LF>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, void* y, void* state,
                   int B, int S, int H, int K, int V, int L,
                   cudaStream_t stream) {
  rwkv6_chunked_kernel<T, KVF, LF><<<B * H, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(state), S, H, K, V, L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sizes(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, void* y,
                         void* state, int B, int S, int H, int K, int V,
                         int L, cudaStream_t stream) {
  if (K == kMaxKV && V == kMaxKV && L == kMaxL)
    return launch<T, kMaxKV, kMaxL>(r, k, v, logw, u, y, state, B, S, H, K,
                                    V, L, stream);
  return launch<T, 0, 0>(r, k, v, logw, u, y, state, B, S, H, K, V, L,
                         stream);
}

}  // namespace rwkv6

extern "C" {

// Launches the RWKV6 chunked kernel on `stream` of card `device`; `bf16`
// selects the type of r, k and v (0: fp32).  The caller guarantees
// contiguous tensors, 1 <= K, V <= 64, 1 <= L <= 16, B * H >= 1.  Returns
// the cudaError_t of the launch (0 on success).
int rwkv6_chunked_launch(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, void* y,
                         void* state, int B, int S, int H, int K, int V,
                         int L, int bf16, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (K < 1 || K > rwkv6::kMaxKV || V < 1 || V > rwkv6::kMaxKV || L < 1 ||
      L > rwkv6::kMaxL || B < 1 || H < 1 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? rwkv6::launch_sizes<__nv_bfloat16>(r, k, v, logw, u, y, state,
                                                B, S, H, K, V, L, s)
           : rwkv6::launch_sizes<float>(r, k, v, logw, u, y, state, B, S, H,
                                        K, V, L, s);
  return static_cast<int>(err);
}

}  // extern "C"
