// Single-token GQA decode attention over a KV cache, split over the cache
// positions (flash-decoding), for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// decode_attention (kernel body _kernel).  q (B, H, hd) holds one new token
// per batch row; k and v (B, S, KV, hd) are the cache, in fp32 or bf16, the
// JAX package's layout; kv_len (B,) int32.  Query head h reads kv head
// h / G (G = H / KV <= 16: 12 at nemotron-4-340b's width).  Row b reads the
// positions [lo, min(kv_len[b], S)), lo = max(0, kv_len[b] - window) for a
// sliding window (window > 0: gemma3's local layers; the TPU kernel has no
// window, the reference's models mask q_pos - k_pos >= window through XLA)
// and 0 without.  The other positions are masked: they get p = 0 and their
// K and V rows are never read, so a row with no valid position gives
// zeros, as the Pallas kernel does at kv_len = 0.  Scores (q . k) * scale,
// with softcap > 0 then tanh(s * (1 / softcap)) * softcap (the reference's
// gqa_attention), the running max, denominator and accumulator are fp32
// for both input types; out = acc / max(l, 1e-30) in q's type.
//
// An int8 cache (the reference's kv_cache_int8: k and v int8, k_scale and
// v_scale (B, S, KV) fp32, one a position and kv head) is read as int8:
// the chunk loader dequantizes each element as the reference's dequant_kv
// rounds it, (float) q * scale rounded to q's type, and stages it in
// shared memory in that type (bf16 for the tensor-core route), so the
// products run as they do on a bf16 / fp32 cache, one launch a call and no
// dequantized copy of the cache.  Its loads are plain (8 bytes a thread),
// not cp.async: a chunk's conversion waits for its bytes.
//
// What bounds it: the cache.  Each valid K and V row is read once and
// carries 2 * G * hd multiply-adds, G = 5 on the serving path: about 2.5
// operations a byte in bf16, far below the card's balance, so the bytes
// bound it (the K and V rows below kv_len, q and out).  The design keeps
// enough bytes in flight on every SM and the arithmetic off the critical
// path:
//
// - Grid (n_split, KV, B): the wrapper splits the cache's S positions into
//   n_split ranges of split_len (ops.decode_splits: about two CTAs an SM),
//   so B = 4 puts 256 CTAs on the 132 SMs, not 32.  A CTA holds the G query
//   rows of one kv head, so each K and V row is read once.
// - A split walks its positions in chunks, K and V staged in shared memory
//   by 16-byte cp.async (8 or 4 where the rows are not 16-byte multiples),
//   only rows in [lo, min(kv_len, S)); the next chunks' copies fly while
//   one is scored.  A split that starts at or past min(kv_len, S), or ends
//   at or before lo, copies nothing and writes an empty partial (m =
//   NEG_INF, l = 0); a split that straddles lo starts its walk at lo, so
//   its chunks hold only valid rows and need no window mask.
// - bf16 (the serving path; the wrapper's ops.decode_route names it and
//   passes it as `mma`): decode_mma_kernel, both products on the tensor
//   cores by mma.sync (see its note), a ring of 3 chunks of 64 positions
//   (32 above hd 128, so that two CTAs still fit an SM).
// - fp32: decode_kernel on the CUDA cores in fp32, two buffers of 64
//   positions (32 for rows over 528 bytes).  Per chunk a
//   thread a position scores it against the G query rows (held in shared
//   memory in fp32); one max / sum reduction a query row for the whole
//   chunk (a warp a row); then P . V, thread (row set, position group, 16
//   bytes of hd), each row set 8 query rows (two sets above G = 8, so a
//   thread's accumulator stays 8 rows), summed over the groups at the end
//   of the split.
// - Merge (finish): each split writes its partial (m, l, acc[G][hd]) in
//   fp32 to scratch the wrapper allocates; the last CTA of a (batch row, kv
//   head) to finish (an atomic counter, reset by that CTA) merges them,
//   out = sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30) with w_s =
//   e^(m_s - max m), so a call is one launch.  With one split the CTA
//   writes the output directly.
//
// Launched through a plain C interface (ctypes), on the caller's stream; it
// allocates nothing and does not synchronise.  The counters must be zero
// before the launch and are zero after it; two launches that share them
// must run in order (one stream).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace attn_decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGMax = 16;          // query heads per kv head
constexpr int kRowSet = 8;         // query rows a thread accumulates
constexpr int kMaxGroups = 16;     // position groups of the P . V pass
constexpr float kNegInf = -1e30f;

template <typename T>
struct Vec {                       // elements of T in 16 bytes
  static constexpr int kN = 16 / sizeof(T);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

// 16 bytes of shared memory as floats
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

// How a split lays a chunk out, for hd and the element size (host and
// device compute it alike).
struct Geo {
  int hdp;     // hd padded to 16 bytes
  int pitch;   // bytes of a K or V row in shared memory (+16 against bank
               // conflicts between neighbouring rows)
  int nd;      // 16-byte vectors of a row
  int npg;     // position groups of the P . V pass
  int chunk;   // positions a chunk
};

__host__ __device__ inline Geo geometry(int hd, int esize) {
  const int vec = 16 / esize;
  Geo g;
  g.hdp = (hd + vec - 1) / vec * vec;
  g.pitch = g.hdp * esize + 16;
  g.nd = g.hdp / vec;
  g.npg = kThreads / g.nd < kMaxGroups ? kThreads / g.nd : kMaxGroups;
  g.chunk = g.pitch > 528 ? 32 : 64;
  return g;
}

__host__ __device__ inline int max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// Bytes of the region that holds the two K and two V buffers and, at the
// end of a split, the position groups' accumulators, then the merge's
// weights.
__host__ __device__ inline int region_bytes(const Geo& g, int G,
                                            int n_split) {
  return max3(4 * g.chunk * g.pitch, g.npg * G * g.hdp * 4,
              (n_split + 1) * G * 4);
}

inline int smem_bytes(int G, int hd, int esize, int n_split) {
  const Geo g = geometry(hd, esize);
  return region_bytes(g, G, n_split) +
         4 * (G * g.hdp + G * g.chunk + 3 * kGMax + 4);
}

// The positions [s0, s1) that split `split` of a row reads: its range cut
// to [lo, min(len, S)), empty when s0 >= s1.
__device__ __forceinline__ void split_range(int len, int S, int window,
                                            int split, int split_len,
                                            int& s0, int& s1) {
  const int lo = window > 0 ? max(0, len - window) : 0;
  s0 = max(split * split_len, lo);
  s1 = min(split * split_len + split_len, max(0, min(len, S)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Rows pos0 .. pos0 + cnt - 1 of one cache tensor into shared memory rows
// of `pitch` bytes: cp.async of copy_bytes (16, 8 or 4), or element by
// element where the rows allow none of these (copy_bytes 0).
template <typename T>
__device__ __forceinline__ void load_rows(uint8_t* dst, const T* src,
                                          int pos0, int cnt, size_t row,
                                          int hd, int pitch, int copy_bytes) {
  if (copy_bytes) {
    const int nv = hd * static_cast<int>(sizeof(T)) / copy_bytes;
    for (int x = threadIdx.x; x < cnt * nv; x += kThreads) {
      const int r = x / nv, c = x - r * nv;
      const uint8_t* s = reinterpret_cast<const uint8_t*>(
                             src + static_cast<size_t>(pos0 + r) * row) +
                         c * copy_bytes;
      const uint32_t d = smem_u32(dst + r * pitch + c * copy_bytes);
      if (copy_bytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                     "l"(s)
                     : "memory");
      else if (copy_bytes == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d),
                     "l"(s)
                     : "memory");
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                     "l"(s)
                     : "memory");
    }
  } else {
    for (int x = threadIdx.x; x < cnt * hd; x += kThreads) {
      const int r = x / hd, c = x - r * hd;
      reinterpret_cast<T*>(dst + r * pitch)[c] =
          src[static_cast<size_t>(pos0 + r) * row + c];
    }
  }
}

// The int8 cache's rows pos0 .. pos0 + cnt - 1 into shared memory rows of
// `pitch` bytes in T: each element (float) q * scale (the row's scale, at
// sc[pos * KV]) rounded to T, as dequant_kv rounds it; 8 elements a thread
// where the rows and the pointer allow (vec8), else one.
template <typename T>
__device__ __forceinline__ void load_rows_q8(uint8_t* dst,
                                             const int8_t* src,
                                             const float* sc, int pos0,
                                             int cnt, size_t row, int KV,
                                             int hd, int pitch, int vec8) {
  const int w = vec8 ? 8 : 1, nv = hd / w;
  for (int x = threadIdx.x; x < cnt * nv; x += kThreads) {
    const int r = x / nv, c = x - r * nv;
    const size_t pos = static_cast<size_t>(pos0 + r);
    const float s = sc[pos * KV];
    T* d = reinterpret_cast<T*>(dst + r * pitch) + c * w;
    if (vec8) {
      const uint2 raw = *reinterpret_cast<const uint2*>(src + pos * row +
                                                        c * 8);
      const int8_t* b8 = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        from_f32(static_cast<float>(b8[e]) * s, d + e);
    } else {
      from_f32(static_cast<float>(src[pos * row + c]) * s, d);
    }
  }
}

// A chunk of K or V rows into shared memory in T: cp.async of a T cache
// (copy_bytes: 16, 8, 4 or 0), or the int8 cache's dequantizing loader
// (copy_bytes: 8 for its vector loads, else 0).
template <typename T, typename KT>
__device__ __forceinline__ void load_kv(uint8_t* dst, const KT* src,
                                        const float* sc, int pos0, int cnt,
                                        size_t row, int KV, int hd,
                                        int pitch, int copy_bytes) {
  if constexpr (std::is_same<KT, int8_t>::value)
    load_rows_q8<T>(dst, src, sc, pos0, cnt, row, KV, hd, pitch,
                    copy_bytes == 8);
  else
    load_rows(dst, src, pos0, cnt, row, hd, pitch, copy_bytes);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// waits until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The end of a split.  With one split, out = acc / max(l, 1e-30).  Else the
// split's partial (m, l, acc) goes to scratch, and the last split of
// (b, kvh) to arrive merges all of them: out = sum_s acc_s w_s /
// max(sum_s l_s w_s, 1e-30), w_s = e^(m_s - M), M the largest m_s (an
// empty split has m = NEG_INF and l = acc = 0).  acc_at(x) is this CTA's
// accumulator of output x = g * hd + d; Ms and Ls hold its max and
// denominator a query row; `work` is shared memory for (n_split + 1) * G
// floats that acc_at no longer needs once every thread has called it.
template <typename T, typename Acc>
__device__ __forceinline__ void finish(Acc acc_at, const float* Ms,
                                       const float* Ls, int* last,
                                       float* work, T* out, float* part_acc,
                                       float* part_ml, int* counter, int b,
                                       int kvh, int split, int n_split,
                                       int H, int KV, int hd) {
  const int G = H / KV, tid = threadIdx.x;
  const size_t bh = static_cast<size_t>(b) * KV + kvh;
  T* ob = out + (static_cast<size_t>(b) * H + kvh * G) * hd;
  if (n_split == 1) {
    for (int x = tid; x < G * hd; x += kThreads)
      from_f32(acc_at(x) / fmaxf(Ls[x / hd], 1e-30f), &ob[x]);
    return;
  }
  float* pa = part_acc + (bh * n_split + split) * G * hd;
  float* pm = part_ml + (bh * n_split + split) * G * 2;
  for (int x = tid; x < G * hd; x += kThreads) pa[x] = acc_at(x);
  if (tid < G) {
    pm[2 * tid] = Ms[tid];
    pm[2 * tid + 1] = Ls[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(counter + bh, 1) == n_split - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const float* qa = part_acc + bh * n_split * G * hd;
  const float* qm = part_ml + bh * n_split * G * 2;
  float* w = work;                    // [n_split][G]: m_s, then w_s
  float* den = work + n_split * G;    // [G]
  for (int x = tid; x < n_split * G; x += kThreads) w[x] = __ldcg(qm + 2 * x);
  __syncthreads();
  if (tid < G) {
    float mx = kNegInf;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, w[s * G + tid]);
    float d = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float f = expf(w[s * G + tid] - mx);
      w[s * G + tid] = f;
      d = fmaf(__ldcg(qm + 2 * (s * G + tid) + 1), f, d);
    }
    den[tid] = fmaxf(d, 1e-30f);
  }
  __syncthreads();
  // four outputs of one query row a thread where hd allows (16-byte loads,
  // eight splits' loads in flight): at G 12 the merge reads 8 x 2304
  // partials, which one load at a time kept waiting on the L2
  if (hd % 4 == 0) {
    for (int x = 4 * tid; x < G * hd; x += 4 * kThreads) {
      const int g = x / hd;
      float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int s = 0; s < n_split; ++s) {
        const float4 a = __ldcg(reinterpret_cast<const float4*>(
            qa + static_cast<size_t>(s) * G * hd + x));
        const float ws = w[s * G + g];
        num.x = fmaf(a.x, ws, num.x);
        num.y = fmaf(a.y, ws, num.y);
        num.z = fmaf(a.z, ws, num.z);
        num.w = fmaf(a.w, ws, num.w);
      }
      from_f32(num.x / den[g], &ob[x]);
      from_f32(num.y / den[g], &ob[x + 1]);
      from_f32(num.z / den[g], &ob[x + 2]);
      from_f32(num.w / den[g], &ob[x + 3]);
    }
  } else {
    for (int x = tid; x < G * hd; x += kThreads) {
      const int g = x / hd;
      float num = 0.f;
#pragma unroll 4
      for (int s = 0; s < n_split; ++s)
        num = fmaf(__ldcg(qa + static_cast<size_t>(s) * G * hd + x),
                   w[s * G + g], num);
      from_f32(num / den[g], &ob[x]);
    }
  }
  if (tid == 0) counter[bh] = 0;
}

// (kThreads, 1): the ring of a chunk of 32 or 64 rows of up to 1040 bytes
// holds one CTA an SM at the large head dims, so ptxas may use registers
// past the 128 that would keep four CTAs resident, rather than spill
// T: float (bf16 calls take decode_mma_kernel); KT: the cache's type, T or
// int8_t (an int8 cache with k_scale, v_scale)
template <typename T, typename KT, int CH>
__global__ void __launch_bounds__(kThreads, 1)
decode_kernel(const T* __restrict__ q, const KT* __restrict__ k,
              const KT* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ kv_len, T* __restrict__ out,
              float* __restrict__ part_acc, float* __restrict__ part_ml,
              int* __restrict__ counter, int S, int H, int KV, int hd,
              float scale, float softcap, int window, int split_len,
              int copy_bytes) {
  constexpr int kVec = Vec<T>::kN;
  constexpr int kGS = kThreads / CH;             // row sets of the scoring
  constexpr int kGT = kRowSet / kGS;   // rows a thread scores a pass
  extern __shared__ __align__(16) uint8_t smem[];
  const int G = H / KV;
  const Geo geo = geometry(hd, sizeof(T));
  const int pitch = geo.pitch, hdp = geo.hdp;
  float* Red = reinterpret_cast<float*>(smem);   // [npg][G][hdp], at the end
  float* Qs =
      reinterpret_cast<float*>(smem + region_bytes(geo, G, gridDim.x));
  float* Ss = Qs + G * hdp;                      // [G][CH] scores, then p
  float* Ms = Ss + G * CH;                       // running max
  float* Ls = Ms + kGMax;                        // running denominator
  float* As = Ls + kGMax;                        // this chunk's rescale
  int* last = reinterpret_cast<int*>(As + kGMax);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  int s0, s1;
  split_range(kv_len[b], S, window, split, split_len, s0, s1);
  const size_t row = static_cast<size_t>(KV) * hd;   // elements a position
  const T* qb = q + (static_cast<size_t>(b) * H + kvh * G) * hd;
  const KT* kb = k + static_cast<size_t>(b) * S * row + kvh * hd;
  const KT* vb = v + static_cast<size_t>(b) * S * row + kvh * hd;
  const size_t sbase = static_cast<size_t>(b) * S * KV + kvh;
  const float* ksb = k_scale ? k_scale + sbase : nullptr;
  const float* vsb = v_scale ? v_scale + sbase : nullptr;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  if (s0 < s1) {   // the first chunk into buffer 0
    load_kv<T>(smem, kb, ksb, s0, min(CH, s1 - s0), row, KV, hd, pitch,
               copy_bytes);
    load_kv<T>(smem + 2 * CH * pitch, vb, vsb, s0, min(CH, s1 - s0), row,
               KV, hd, pitch, copy_bytes);
  }
  cp_async_commit();
  for (int x = tid; x < G * hdp; x += kThreads) {
    const int g = x / hdp, d = x - g * hdp;
    Qs[x] = d < hd ? to_f32(qb[g * hd + d]) : 0.f;
  }
  // K's pad columns meet q's zero pad: keep them finite
  for (int x = tid; x < 2 * CH * (hdp - hd); x += kThreads) {
    const int r = x / (hdp - hd), d = hd + x % (hdp - hd);
    from_f32(0.f, reinterpret_cast<T*>(smem + r * pitch) + d);
  }
  if (tid < kGMax) {
    Ms[tid] = kNegInf;
    Ls[tid] = 0.f;
  }
  // P . V: thread (row set rs, position group pg, 16 bytes dv of hd)
  // accumulates query rows g0 .. g0 + 7 (those below G)
  const int n_rs = (G + kRowSet - 1) / kRowSet;
  const int npg = geo.npg / n_rs;
  const int pgr = tid / geo.nd, dv = tid - pgr * geo.nd;
  const int rs = pgr % n_rs, pg = pgr / n_rs, g0 = rs * kRowSet;
  const bool pv_thread = pgr < npg * n_rs;
  float acc[kRowSet][kVec];
#pragma unroll
  for (int r = 0; r < kRowSet; ++r)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;

  for (int c0 = s0, it = 0; c0 < s1; c0 += CH, ++it) {
    const int cnt = min(CH, s1 - c0), buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();   // chunk c0 visible; the other buffer's readers done
    if (c0 + CH < s1) {
      const int nxt = min(CH, s1 - c0 - CH);
      load_kv<T>(smem + (buf ^ 1) * CH * pitch, kb, ksb, c0 + CH, nxt, row,
                 KV, hd, pitch, copy_bytes);
      load_kv<T>(smem + (2 + (buf ^ 1)) * CH * pitch, vb, vsb, c0 + CH, nxt,
                 row, KV, hd, pitch, copy_bytes);
      cp_async_commit();
    }
    const uint8_t* Kc = smem + buf * CH * pitch;
    const uint8_t* Vc = smem + (2 + buf) * CH * pitch;

    // scores: thread (js, gs) takes position js against rows gs, gs + kGS,
    // .. of each row set of 8 (a second pass above G = 8)
    {
      const int js = tid % CH, gs = tid / CH;
      for (int gp = 0; gp < G && js < cnt; gp += kRowSet) {
        float dot[kGT];
#pragma unroll
        for (int t = 0; t < kGT; ++t) dot[t] = 0.f;
        const uint4* kr = reinterpret_cast<const uint4*>(Kc + js * pitch);
        for (int dd = 0; dd < geo.nd; ++dd) {
          float kf[kVec];
          unpack(kr[dd], kf);
#pragma unroll
          for (int t = 0; t < kGT; ++t) {
            const int g = gp + gs + t * kGS;
            if (g < G) {
              const float4* qv =
                  reinterpret_cast<const float4*>(Qs + g * hdp + dd * kVec);
#pragma unroll
              for (int e = 0; e < kVec / 4; ++e) {
                const float4 qq = qv[e];
                dot[t] = fmaf(qq.x, kf[4 * e], dot[t]);
                dot[t] = fmaf(qq.y, kf[4 * e + 1], dot[t]);
                dot[t] = fmaf(qq.z, kf[4 * e + 2], dot[t]);
                dot[t] = fmaf(qq.w, kf[4 * e + 3], dot[t]);
              }
            }
          }
        }
#pragma unroll
        for (int t = 0; t < kGT; ++t) {
          const int g = gp + gs + t * kGS;
          float sc = dot[t] * scale;
          if (softcap > 0.f) sc = tanhf(sc * inv_cap) * softcap;
          if (g < G) Ss[g * CH + js] = sc;
        }
      }
    }
    __syncthreads();

    // the chunk's softmax statistics, one reduction a query row
    for (int g = warp; g < G; g += kWarps) {
      float sv[CH / 32];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < CH / 32; ++u) {
        const int j = lane + 32 * u;
        sv[u] = j < cnt ? Ss[g * CH + j] : kNegInf;
        mx = fmaxf(mx, sv[u]);
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = Ms[g], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < CH / 32; ++u) {
        const int j = lane + 32 * u;
        const float p = j < cnt ? expf(sv[u] - m_new) : 0.f;
        Ss[g * CH + j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[g] = alpha;
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: thread (pg, dv) takes positions pg, pg +
    // npg, ... and the 16 bytes dv of hd
    if (pv_thread) {
#pragma unroll
      for (int r = 0; r < kRowSet; ++r) {
        if (g0 + r < G) {
          const float a = As[g0 + r];
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[r][e] *= a;
        }
      }
      for (int j = pg; j < cnt; j += npg) {
        float vf[kVec];
        unpack(*reinterpret_cast<const uint4*>(Vc + j * pitch + dv * 16), vf);
#pragma unroll
        for (int r = 0; r < kRowSet; ++r) {
          if (g0 + r < G) {
            const float p = Ss[(g0 + r) * CH + j];
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[r][e] = fmaf(p, vf[e],
                                                          acc[r][e]);
          }
        }
      }
    }
  }
  __syncthreads();   // the buffers' last readers are done: reuse as Red
  if (pv_thread) {
#pragma unroll
    for (int r = 0; r < kRowSet; ++r) {
      if (g0 + r < G) {
        float4* w = reinterpret_cast<float4*>(
            Red + (pg * G + g0 + r) * hdp + dv * kVec);
#pragma unroll
        for (int e = 0; e < kVec / 4; ++e)
          w[e] = make_float4(acc[r][4 * e], acc[r][4 * e + 1],
                             acc[r][4 * e + 2], acc[r][4 * e + 3]);
      }
    }
  }
  __syncthreads();

  finish(
      [&](int x) {
        const int g = x / hd, d = x - g * hd;
        float sum = 0.f;
        for (int p = 0; p < npg; ++p) sum += Red[(p * G + g) * hdp + d];
        return sum;
      },
      Ms, Ls, last, reinterpret_cast<float*>(smem), out, part_acc, part_ml,
      counter, b, kvh, split, n_split, H, KV, hd);
}

// ---- bf16: both products on the tensor cores (mma.sync)
//
// A warp takes 16 positions of each 64-position chunk and keeps its own
// running softmax.  S^T is never formed: scores = Q (the G query rows,
// padded to 16, as the A operand in registers) x K^T (B fragments read
// straight from the K rows in shared memory); thread (g, t) of the warp
// then holds query row g's scores of positions 2t, 2t + 1 of each 8 (and,
// with HI, above G = 8, row g + 8's), so a row's max and sum are two
// shuffles, and its p values are the A operand of P . V as they stand
// (rounded to bf16, about 2^-9 of each p), with V's B fragments by
// ldmatrix.trans.  Without HI rows 8-15 of the tile are zero and their
// statistics are not carried.  K and V come through a ring of kMmaStages
// chunks of cp.async; the four warps' softmaxes are merged at the end of
// the split.
//
// Above hd 128 (HALVES) a ring of 64-position chunks would hold one CTA an
// SM (202 752 B at hd 256), where ops.decode_splits sizes the grid for
// two.  There a chunk is 32 positions (101 376 B at hd 256, 76 800 at
// 192): warps w and w + 2 score the same 16 positions (the Q . K^T
// products twice, cheap beside the bytes) and carry the same softmax, and
// each takes half of hd's 16-dim tiles in P . V, so a thread holds hd / 4
// accumulators a query row, not hd / 2.  The merge weighs each half of
// hd by its two warps.

constexpr int kMmaStages = 3;
constexpr int kMmaChunk = 64;      // positions a chunk, 16 a warp
constexpr int kMmaChunkHalves = 32;   // above hd 128: 16 a warp pair
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int mma_hdp(int hd) { return (hd + 15) / 16 * 16; }
__host__ __device__ inline int mma_pitch(int hd) {
  return mma_hdp(hd) * 2 + 16;
}
__host__ __device__ inline int mma_chunk(int hd) {
  return hd > 128 ? kMmaChunkHalves : kMmaChunk;
}

// the ring; then the warps' partials (acc, m, l and the merge factor, a
// query row each); then the merge's weights
__host__ __device__ inline int mma_region_bytes(int G, int hd, int n_split) {
  return max3(kMmaStages * 2 * mma_chunk(hd) * mma_pitch(hd),
              kWarps * kGMax * (mma_hdp(hd) + 3) * 4, (n_split + 1) * G * 4);
}

inline int mma_smem_bytes(int G, int hd, int n_split) {
  return mma_region_bytes(G, hd, n_split) + 4 * (2 * kGMax + 4);
}

// d += A (16 x 16 bf16: a0 / a2 row g, a1 / a3 row g + 8, zero for a
// tile of 8 rows) . B (16 x 8)
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The running softmax of one query row in a warp: max m (over the warp's
// positions so far), this thread's share l of the denominator; update()
// takes the scores of this thread's 4 positions of a 16-position slice
// (-INFINITY where masked) and returns the rescale of the row's
// accumulators, the p values left in sc.
struct RowSoftmax {
  float m = -INFINITY, l = 0.f;
  __device__ __forceinline__ float update(float (&sc)[4]) {
    float mx = m;
#pragma unroll
    for (int e = 0; e < 4; ++e) mx = fmaxf(mx, sc[e]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mb = mx == -INFINITY ? 0.f : mx;   // no -inf - -inf
    const float alpha = ex2((m - mb) * kLog2e);
    m = mx;
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[e] = ex2((sc[e] - mb) * kLog2e);
    l = l * alpha + (sc[0] + sc[1]) + (sc[2] + sc[3]);
    return alpha;
  }
};

// NK bounds hd / 16 (4, 8, 12 or 16): it sizes the q fragments and
// accumulators; above 8 the warps take halves of hd (HALVES, see above).
// HI: G > 8, rows 8-15 of the tile live.  KT: the cache's type, bf16 or
// int8_t (an int8 cache with k_scale, v_scale, staged as bf16).
template <int NK, bool HI, typename KT>
__global__ void __launch_bounds__(kThreads)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const KT* __restrict__ k, const KT* __restrict__ v,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ kv_len,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int* __restrict__ counter,
                  int S, int H, int KV, int hd, float scale, float softcap,
                  int window, int split_len, int copy_bytes) {
  using bf = __nv_bfloat16;
  constexpr bool kHalves = NK > 8;    // hd > 128, as mma_chunk(hd) decides
  constexpr int CH = kHalves ? kMmaChunkHalves : kMmaChunk;
  constexpr int ND = kHalves ? NK / 2 : NK;   // 16-dim tiles of P . V a warp
  constexpr int kRows = HI ? 2 : 1;   // query rows a thread: g (and g + 8)
  extern __shared__ __align__(16) uint8_t smem[];
  const int G = H / KV;
  const int hdp = mma_hdp(hd), pitch = mma_pitch(hd), nk = hdp / 16;
  const int n_split = gridDim.x;
  float* Ms = reinterpret_cast<float*>(smem + mma_region_bytes(G, hd,
                                                               n_split));
  float* Ls = Ms + kGMax;
  int* last = reinterpret_cast<int*>(Ls + kGMax);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  int s0, s1;
  split_range(kv_len[b], S, window, split, split_len, s0, s1);
  const int n_chunks = s1 > s0 ? (s1 - s0 + CH - 1) / CH : 0;
  const size_t row = static_cast<size_t>(KV) * hd;
  const KT* kb = k + static_cast<size_t>(b) * S * row + kvh * hd;
  const KT* vb = v + static_cast<size_t>(b) * S * row + kvh * hd;
  const size_t sbase = static_cast<size_t>(b) * S * KV + kvh;
  const float* ksb = k_scale ? k_scale + sbase : nullptr;
  const float* vsb = v_scale ? v_scale + sbase : nullptr;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  auto stage_k = [&](int st) { return smem + (2 * st) * CH * pitch; };
  auto stage_v = [&](int st) { return smem + (2 * st + 1) * CH * pitch; };

  // zero the ring once: pad columns and rows past a chunk's end stay
  // finite (a p = 0 meets them)
  for (int x = tid; x < kMmaStages * 2 * CH * pitch / 16; x += kThreads)
    reinterpret_cast<uint4*>(smem)[x] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int c = 0; c < kMmaStages - 1; ++c) {
    if (c < n_chunks) {
      const int pos = s0 + c * CH, cnt = min(CH, s1 - pos);
      load_kv<bf>(stage_k(c), kb, ksb, pos, cnt, row, KV, hd, pitch,
                  copy_bytes);
      load_kv<bf>(stage_v(c), vb, vsb, pos, cnt, row, KV, hd, pitch,
                  copy_bytes);
    }
    cp_async_commit();
  }

  // q fragments: query row g + 8 r of this kv head, dims 16 kk + 2t (+ 8),
  // + 1 (row r = 1 only with HI)
  uint32_t qa[kRows][NK][2];
  {
    const uint16_t* qr = reinterpret_cast<const uint16_t*>(q) +
                         (static_cast<size_t>(b) * H + kvh * G) * hd;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int gr = g + 8 * r, d = 16 * kk + 8 * h2 + 2 * t;
          const uint16_t* qg = qr + static_cast<size_t>(gr) * hd;
          const uint32_t lo = gr < G && d < hd ? qg[d] : 0u;
          const uint32_t hi = gr < G && d + 1 < hd ? qg[d + 1] : 0u;
          qa[r][kk][h2] = lo | (hi << 16);
        }
  }
  // this warp's 16 positions of a chunk and its first 16-dim tile of P . V
  const int p0 = 16 * (kHalves ? warp & 1 : warp);
  const int dt0 = kHalves ? (warp >> 1) * ND : 0;
  // o[i][0..1]: row g, dims 16 dt0 + 8 i + 2t, + 1; o[i][2..3]: row g + 8
  float o[2 * ND][4];
#pragma unroll
  for (int i = 0; i < 2 * ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  RowSoftmax sm[kRows];

  for (int it = 0; it < n_chunks; ++it) {
    const int st = it % kMmaStages;
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();   // chunk it visible; the stage refilled below is free
    {
      const int c = it + kMmaStages - 1;
      if (c < n_chunks) {
        const int pos = s0 + c * CH, cnt = min(CH, s1 - pos);
        load_kv<bf>(stage_k(c % kMmaStages), kb, ksb, pos, cnt, row, KV, hd,
                    pitch, copy_bytes);
        load_kv<bf>(stage_v(c % kMmaStages), vb, vsb, pos, cnt, row, KV, hd,
                    pitch, copy_bytes);
      }
      cp_async_commit();
    }
    const int cnt = min(CH, s1 - (s0 + it * CH));
    if (p0 >= cnt) continue;
    const uint8_t* Kc = stage_k(st);
    const uint8_t* Vc = stage_v(st);

    // scores of positions p0 + 8 nt + 2t (+ 1): sc[nt][0..1] row g,
    // sc[nt][2..3] row g + 8
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
      const uint8_t* kr = Kc + (p0 + 8 * nt + g) * pitch + 4 * t;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        if (kk < nk)
          mma_16816(sc[nt], qa[0][kk][0], HI ? qa[kRows - 1][kk][0] : 0u,
                    qa[0][kk][1], HI ? qa[kRows - 1][kk][1] : 0u,
                    *reinterpret_cast<const uint32_t*>(kr + 32 * kk),
                    *reinterpret_cast<const uint32_t*>(kr + 32 * kk + 16));
    }
    // per row r: its 4 scores (positions 2t, 2t + 1 of slices nt = 0, 1),
    // masked past the chunk's end, through the running softmax
    float p[kRows][4], alpha[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = p0 + 8 * nt + 2 * t + e < cnt;
          float x = sc[nt][2 * r + e] * scale;
          if (softcap > 0.f) x = tanhf(x * inv_cap) * softcap;
          p[r][2 * nt + e] = ok ? x : -INFINITY;
        }
      alpha[r] = sm[r].update(p[r]);
    }
    const uint32_t a0 = pack_bf16(p[0][0], p[0][1]);
    const uint32_t a2 = pack_bf16(p[0][2], p[0][3]);
    const uint32_t a1 = HI ? pack_bf16(p[kRows - 1][0], p[kRows - 1][1]) : 0u;
    const uint32_t a3 = HI ? pack_bf16(p[kRows - 1][2], p[kRows - 1][3]) : 0u;
#pragma unroll
    for (int i = 0; i < 2 * ND; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      if (HI) {
        o[i][2] *= alpha[kRows - 1];
        o[i][3] *= alpha[kRows - 1];
      }
    }
    // O += P V, 16 dims of hd an ldmatrix.x4.trans
    const int mi = lane >> 3;
    const uint32_t va = smem_u32(Vc + (p0 + (lane & 7) + 8 * (mi & 1)) *
                                          pitch + 16 * (mi >> 1));
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      if (dt0 + j < nk) {
        uint32_t r0, r1, r2, r3;
        ldsm_x4_trans(va + 32 * (dt0 + j), r0, r1, r2, r3);
        mma_16816(o[2 * j], a0, a1, a2, a3, r0, r1);
        mma_16816(o[2 * j + 1], a0, a1, a2, a3, r2, r3);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    sm[r].l += __shfl_xor_sync(0xffffffffu, sm[r].l, 1);
    sm[r].l += __shfl_xor_sync(0xffffffffu, sm[r].l, 2);
  }

  // merge the four warps: warp w's acc (its dims), m, l and factor of each
  // row; with kHalves warps w and w + 2 carry the same m and l
  __syncthreads();   // the ring's last readers are done
  float* Wo = reinterpret_cast<float*>(smem);        // [kWarps][kGMax][hdp]
  float* Wm = Wo + kWarps * kGMax * hdp;             // [kWarps][kGMax]
  float* Wl = Wm + kWarps * kGMax;
  float* Wf = Wl + kWarps * kGMax;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int gr = g + 8 * r;
    float* wo = Wo + (warp * kGMax + gr) * hdp + 16 * dt0 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2 * ND; ++i)
      if (16 * dt0 + 8 * i < hdp) *reinterpret_cast<float2*>(wo + 8 * i) =
          make_float2(o[i][2 * r], o[i][2 * r + 1]);
    if (t == 0) {
      Wm[warp * kGMax + gr] = sm[r].m == -INFINITY ? kNegInf : sm[r].m;
      Wl[warp * kGMax + gr] = sm[r].l;
    }
  }
  __syncthreads();
  if (tid < G) {
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, Wm[w * kGMax + tid]);
    float den = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(Wm[w * kGMax + tid] - mx);
      Wf[w * kGMax + tid] = f;
      if (!kHalves || w < 2) den = fmaf(Wl[w * kGMax + tid], f, den);
    }
    Ms[tid] = mx;
    Ls[tid] = den;
  }
  __syncthreads();
  finish(
      [&](int x) {
        const int gg = x / hd, d = x - gg * hd;
        float sum = 0.f;
        if constexpr (kHalves) {   // dim d's half: warps 2 (d / 16 ND) + 0, 1
          const int w0 = 2 * (d / (16 * ND));
#pragma unroll
          for (int w = w0; w < w0 + 2; ++w)
            sum = fmaf(Wo[(w * kGMax + gg) * hdp + d], Wf[w * kGMax + gg],
                       sum);
        } else {
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            sum = fmaf(Wo[(w * kGMax + gg) * hdp + d], Wf[w * kGMax + gg],
                       sum);
        }
        return sum;
      },
      Ms, Ls, last, Wo, out, part_acc, part_ml, counter, b, kvh, split,
      n_split, H, KV, hd);
}

// the widest cp.async the rows and both cache pointers allow (0: none)
inline int copy_width(const void* k, const void* v, int row_bytes) {
  for (int cb = 16; cb >= 4; cb /= 2)
    if (row_bytes % cb == 0 && reinterpret_cast<uintptr_t>(k) % cb == 0 &&
        reinterpret_cast<uintptr_t>(v) % cb == 0)
      return cb;
  return 0;
}

// the int8 loader's width: 8 where the rows and both pointers allow it
inline int q8_width(const void* k, const void* v, int hd) {
  return hd % 8 == 0 && reinterpret_cast<uintptr_t>(k) % 8 == 0 &&
                 reinterpret_cast<uintptr_t>(v) % 8 == 0
             ? 8
             : 0;
}

template <typename K>
cudaError_t set_smem(K kern, int smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

int smem_for(int mma, int G, int hd, int n_split) {
  return mma ? mma_smem_bytes(G, hd, n_split) : smem_bytes(G, hd, 4, n_split);
}

struct Args {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;
  const int* kv_len;
  void* out;
  float* part_acc;
  float* part_ml;
  int* counter;
  int B, S, H, KV, hd;
  float scale, softcap;
  int window, n_split, split_len;
};

template <typename T, typename KT>
cudaError_t launch_core(const Args& a, cudaStream_t stream) {
  const int smem = smem_bytes(a.H / a.KV, a.hd, sizeof(T), a.n_split);
  const int cb = std::is_same<KT, int8_t>::value
                     ? q8_width(a.k, a.v, a.hd)
                     : copy_width(a.k, a.v, a.hd * static_cast<int>(sizeof(T)));
  auto kern = geometry(a.hd, sizeof(T)).chunk == 64
                  ? decode_kernel<T, KT, 64>
                  : decode_kernel<T, KT, 32>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.n_split, a.KV, a.B), kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), a.k_scale, a.v_scale, a.kv_len,
      static_cast<T*>(a.out), a.part_acc, a.part_ml, a.counter, a.S, a.H,
      a.KV, a.hd, a.scale, a.softcap, a.window, a.split_len, cb);
  return cudaGetLastError();
}

template <typename KT>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  const int smem = mma_smem_bytes(a.H / a.KV, a.hd, a.n_split);
  const int cb = std::is_same<KT, int8_t>::value
                     ? q8_width(a.k, a.v, a.hd)
                     : copy_width(a.k, a.v, a.hd * 2);
  const bool hi = a.H / a.KV > 8;
  auto kern = a.hd <= 64    ? (hi ? decode_mma_kernel<4, true, KT>
                                  : decode_mma_kernel<4, false, KT>)
              : a.hd <= 128 ? (hi ? decode_mma_kernel<8, true, KT>
                                  : decode_mma_kernel<8, false, KT>)
              : a.hd <= 192 ? (hi ? decode_mma_kernel<12, true, KT>
                                  : decode_mma_kernel<12, false, KT>)
                            : (hi ? decode_mma_kernel<16, true, KT>
                                  : decode_mma_kernel<16, false, KT>);
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  using bf = __nv_bfloat16;
  kern<<<dim3(a.n_split, a.KV, a.B), kThreads, smem, stream>>>(
      static_cast<const bf*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), a.k_scale, a.v_scale, a.kv_len,
      static_cast<bf*>(a.out), a.part_acc, a.part_ml, a.counter, a.S, a.H,
      a.KV, a.hd, a.scale, a.softcap, a.window, a.split_len, cb);
  return cudaGetLastError();
}

}  // namespace attn_decode

extern "C" {

// Launches decode attention on `stream` of card `device`; `mma` names the
// route ops.decode_route decided: 1, bf16 q on the tensor cores
// (decode_mma_kernel); 0, fp32 q on the CUDA cores (decode_kernel).
// k_scale and v_scale non-null make k and v an int8
// cache; `window` > 0 reads only the last `window` positions before kv_len
// (0: all); softcap > 0 caps the scores (0: none).  The caller guarantees
// 1 <= hd <= 256, H % KV == 0, 1 <= H / KV <= 16, contiguous tensors,
// n_split * split_len >= S and, when n_split > 1, scratch of B * KV *
// n_split * G * hd floats (part_acc) and of B * KV * n_split * G * 2
// (part_ml) and B * KV zeroed int32 counters.  One kernel launch.  Returns
// the cudaError_t of the launch (0 on success).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* k_scale, const void* v_scale,
                            const void* kv_len, void* out, void* part_acc,
                            void* part_ml, void* counter, int B, int S, int H,
                            int KV, int hd, float scale, float softcap,
                            int window, int n_split, int split_len, int mma,
                            int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (hd < 1 || hd > 256 || KV < 1 || H % KV ||
      H / KV > attn_decode::kGMax || window < 0 || n_split < 1 ||
      split_len < 1 || softcap < 0.f ||
      (k_scale == nullptr) != (v_scale == nullptr) ||
      static_cast<long long>(n_split) * split_len < S ||
      (n_split > 1 && (!part_acc || !part_ml || !counter)))
    return static_cast<int>(cudaErrorInvalidValue);
  const attn_decode::Args a{
      q, k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(kv_len),
      out, static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<int*>(counter), B, S, H, KV, hd, scale, softcap, window,
      n_split, split_len};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool int8 = k_scale != nullptr;
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (mma)
    err = int8 ? attn_decode::launch_mma<int8_t>(a, s)
               : attn_decode::launch_mma<bf>(a, s);
  else
    err = int8 ? attn_decode::launch_core<float, int8_t>(a, s)
               : attn_decode::launch_core<float, float>(a, s);
  return static_cast<int>(err);
}

// Dynamic shared memory of one CTA for G query heads a kv head at head dim
// hd and n_split splits on the route `mma` names (as for the launch).
int decode_attention_smem_bytes(int G, int hd, int mma, int n_split) {
  return attn_decode::smem_for(mma, G, hd, n_split);
}

}  // extern "C"
