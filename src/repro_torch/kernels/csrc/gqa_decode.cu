// One-token grouped-query attention over a KV cache (flash decoding) on
// Hopper.
//
//   out[b, h] = sum_t softmax_t(s[b, h, t]) v[b, t, h / G]
//   s[b, h, t] = q[b, h] . k[b, t, h / G] / sqrt(hd)   where slot t is valid,
//              = -1e30                                 where it is not,
//   valid(t)  = k_pos[t] >= 0 && k_pos[t] <= q_pos
//               && (window <= 0 || k_pos[t] > q_pos - window)
//
//   q: (B, H, hd), k: (B, T, K, hd), v: (B, T, K, hd_v), k_pos: (T,) int32
//   (-1 marks an empty slot; in a rolling cache slot order is not position
//   order), q_pos and window ints -> out: (B, H, hd_v) in q's dtype.
//   G = H / K query heads share one KV head.  Two entry points: float32,
//   and bfloat16 q, k, v and out; every product and sum is float32.
//
// Replaces the Pallas TPU kernel `gqa_decode` in
// src/repro/kernels/gqa_decode.py.  There the grid (B, T/bt) walks the
// cache in order, one batch row at a time, with the online-softmax state
// (m, l, acc) in VMEM scratch.  On Hopper a block per (b, KV head) alone
// gives B * K = 64 blocks at the serving shape, under half of the 132 SMs,
// so the cache is split along T as in flash decoding:
//
//   gqa_split_kernel: one block per (128-slot T-chunk, KV head, b).  It holds
//     the G query rows of the KV head in shared memory, reads each K row of
//     the chunk once for all G heads (one warp per slot, lanes over hd,
//     a warp sum per head), turns the chunk's scores into exp(s - m) with
//     the chunk's own max m and sum l, then reads each V row once (threads
//     over hd_v, all G heads in registers) and writes its partial
//     (m, l, acc) for the G heads.
//   gqa_combine_kernel: one block per (KV head, b) merges the partials in a
//     fixed order: M = max m_s, L = sum exp(m_s - M) l_s,
//     out = sum exp(m_s - M) acc_s / max(L, 1e-30).
//
// No atomics, so reruns give the same bits.  The ragged end of T is masked
// here; the cache is not padded.  Masked scores are -1e30, not -inf, as in
// the reference: a chunk whose slots are all masked has m = -1e30 and gives
// weight exp(-1e30 - M) = 0 once any chunk has a valid slot, and a query
// with no valid slot at all averages v over every slot, as the reference
// does; no inf - inf, no NaN.  A masked slot's K row is not read (its score
// is -1e30 whatever it holds); every V row is read, so a non-finite value
// in a masked slot propagates as in the reference (0 * NaN).
//
// Bound on the H100: bytes.  At the serving shape (qwen3-4b: B = 8,
// T = 4160, K = 8, G = 4, hd = hd_v = 128, bf16) K and V are read once:
// 2 * 8 * 4160 * 8 * 128 * 2 B = 136.3 MB, 40.7 us at 3.35 TB/s, against
// about 0.55 GFLOP (2 * 2 * B * H * T * hd), negligible.  The partials add
// B * K * 33 * G * (hd_v + 2) * 4 B = 4.4 MB written and read once.  Loads
// are plain coalesced loads (no TMA, no cp.async) and there are no tensor
// cores: the bytes are the lever, in later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;   // cache slots per gqa_split_kernel block
constexpr int kMaxG = 16;     // query heads per KV head
constexpr int kMaxHd = 256;   // hd and hd_v
constexpr int kUnroll = 8;    // V rows in flight per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// grid (n_split, K, B), kThreads threads, dynamic shared memory
// (G * hd + G * kChunk) floats.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gqa_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ k_pos,
             float* __restrict__ part_m, float* __restrict__ part_l,
             float* __restrict__ part_acc, int n_t, int H, int K, int hd,
             int hd_v, int q_pos, int window, float scale) {
  extern __shared__ float smem[];
  __shared__ float m_sh[kMaxG];
  __shared__ float l_sh[kMaxG];
  const int G = H / K;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int t0 = split * kChunk;
  const int n = min(kChunk, n_t - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* q_sh = smem;               // (G, hd), scaled
  float* p_sh = smem + G * hd;      // (G, kChunk): scores, then exp(s - m)

  const T* q_b = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * G)
                     * hd;
  for (int i = tid; i < G * hd; i += kThreads)
    q_sh[i] = to_float(q_b[i]) * scale;
  __syncthreads();

  // scores: one warp per slot, lanes over hd
  const size_t k_row = static_cast<size_t>(K) * hd;
  const T* k_b = k + (static_cast<size_t>(b) * n_t + t0) * k_row
                   + static_cast<size_t>(kh) * hd;
  for (int t = warp; t < n; t += kWarps) {
    const int p = k_pos[t0 + t];
    const bool valid = p >= 0 && p <= q_pos
                       && (window <= 0 || p > q_pos - window);
    if (!valid) {                   // warp-uniform
      for (int g = lane; g < G; g += 32) p_sh[g * kChunk + t] = kNegInf;
      continue;
    }
    const T* k_t = k_b + static_cast<size_t>(t) * k_row;
    float kv[kMaxHd / 32];
#pragma unroll
    for (int i = 0; i < kMaxHd / 32; ++i) {
      const int d = lane + 32 * i;
      kv[i] = d < hd ? to_float(k_t[d]) : 0.f;
    }
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxHd / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) s += q_sh[g * hd + d] * kv[i];
      }
      s = warp_sum(s);
      if (lane == 0) p_sh[g * kChunk + t] = s;
    }
  }
  __syncthreads();

  // the chunk's max and sum per head; scores become exp(s - m)
  for (int g = warp; g < G; g += kWarps) {
    float* row = p_sh + g * kChunk;
    float m = kNegInf;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float e = expf(row[t] - m);
      row[t] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_sh[g] = m;
      l_sh[g] = l;
    }
  }
  __syncthreads();

  // acc[g, d] = sum_t p[g, t] v[t, d]: threads over d (two columns at most),
  // every head in registers, kUnroll V rows loaded before they are used
  const size_t v_row = static_cast<size_t>(K) * hd_v;
  const T* v_b = v + (static_cast<size_t>(b) * n_t + t0) * v_row
                   + static_cast<size_t>(kh) * hd_v;
  float acc[2][kMaxG];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[j][g] = 0.f;
  for (int t = 0; t < n; t += kUnroll) {
    float vv[kUnroll][2];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = tid + kThreads * j;
        vv[u][j] = (t + u < n && d < hd_v)
                       ? to_float(v_b[static_cast<size_t>(t + u) * v_row + d])
                       : 0.f;
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u >= n) break;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float p = p_sh[g * kChunk + t + u];
        acc[0][g] += p * vv[u][0];
        acc[1][g] += p * vv[u][1];
      }
    }
  }

  const size_t base = (static_cast<size_t>(b) * K + kh) * n_split + split;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = tid + kThreads * j;
      if (d < hd_v) part_acc[(base * G + g) * hd_v + d] = acc[j][g];
    }
  }
  if (tid < G) {
    part_m[base * G + tid] = m_sh[tid];
    part_l[base * G + tid] = l_sh[tid];
  }
}

// grid (K, B), kThreads threads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gqa_combine_kernel(const float* __restrict__ part_m,
               const float* __restrict__ part_l,
               const float* __restrict__ part_acc, T* __restrict__ out,
               int n_split, int H, int K, int hd_v) {
  const int G = H / K;
  const int kh = blockIdx.x, b = blockIdx.y;
  const size_t base = (static_cast<size_t>(b) * K + kh) * n_split;
  for (int g = 0; g < G; ++g) {
    float m_max = kNegInf;
    for (int s = 0; s < n_split; ++s)
      m_max = fmaxf(m_max, part_m[(base + s) * G + g]);
    float l = 0.f;
    for (int s = 0; s < n_split; ++s)
      l += expf(part_m[(base + s) * G + g] - m_max)
           * part_l[(base + s) * G + g];
    const float denom = fmaxf(l, 1e-30f);
    for (int d = threadIdx.x; d < hd_v; d += kThreads) {
      float a = 0.f;
      for (int s = 0; s < n_split; ++s)
        a += expf(part_m[(base + s) * G + g] - m_max)
             * part_acc[((base + s) * G + g) * hd_v + d];
      store(out + (static_cast<size_t>(b) * H + kh * G + g) * hd_v + d,
            a / denom);
    }
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const int* k_pos, T* out,
           float* part_m, float* part_l, float* part_acc, int B, int n_t,
           int H, int K, int hd, int hd_v, int q_pos, int window,
           cudaStream_t stream) {
  if (B < 1 || n_t < 1 || H < 1 || K < 1 || hd < 1 || hd_v < 1
      || H % K != 0 || H / K > kMaxG || hd > kMaxHd || hd_v > kMaxHd
      || K > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / K;
  const int n_split = (n_t + kChunk - 1) / kChunk;
  const size_t smem = sizeof(float) * (static_cast<size_t>(G) * hd
                                       + static_cast<size_t>(G) * kChunk);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  gqa_split_kernel<T><<<dim3(n_split, K, B), kThreads, smem, stream>>>(
      q, k, v, k_pos, part_m, part_l, part_acc, n_t, H, K, hd, hd_v, q_pos,
      window, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gqa_combine_kernel<T><<<dim3(K, B), kThreads, 0, stream>>>(
      part_m, part_l, part_acc, out, n_split, H, K, hd_v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The partials part_m, part_l: (B, K, n_split, G) and part_acc:
// (B, K, n_split, G, hd_v), float32 scratch allocated by the caller, with
// n_split = ceil(T / 128).  All pointers contiguous, on the device of
// `stream`.  Returns the launches' cudaError_t (cudaErrorInvalidValue for
// a shape the kernel does not take: G > 16, hd or hd_v > 256).
extern "C" int gqa_decode_f32(const float* q, const float* k, const float* v,
                              const int* k_pos, float* out, float* part_m,
                              float* part_l, float* part_acc, int B, int n_t,
                              int H, int K, int hd, int hd_v, int q_pos,
                              int window, cudaStream_t stream) {
  return launch(q, k, v, k_pos, out, part_m, part_l, part_acc, B, n_t, H, K,
                hd, hd_v, q_pos, window, stream);
}

// The same with bfloat16 q, k, v and out.
extern "C" int gqa_decode_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, const int* k_pos,
                               __nv_bfloat16* out, float* part_m,
                               float* part_l, float* part_acc, int B, int n_t,
                               int H, int K, int hd, int hd_v, int q_pos,
                               int window, cudaStream_t stream) {
  return launch(q, k, v, k_pos, out, part_m, part_l, part_acc, B, n_t, H, K,
                hd, hd_v, q_pos, window, stream);
}
