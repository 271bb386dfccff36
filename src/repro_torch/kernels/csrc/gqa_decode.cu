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
//   gqa_split_kernel: one block of 5 warps per (split, KV head, b).  The
//     cache is cut into 32-slot tiles and the tiles into splits of
//     `split_tiles` (ops.gqa_plan: 6 splits of 22 tiles at the serving
//     shape, one wave of 3 blocks an SM).  A block walks its split once:
//     a producer warp copies the tiles' K and V rows into a 3-stage ring
//     in shared memory (cp.async, each stage completing on an mbarrier),
//     and for each tile the 4 consumer warps take
//       1. the G heads' scores from shared memory, with no warp shuffles:
//          bfloat16 on the tensor cores (mma.sync m16n8k16 from ldmatrix,
//          8 slots a warp, the G query rows padded to 16, float32
//          accumulate; bf16 products are exact in float32), the
//          1/sqrt(hd) scale applied to the float32 score; float32 one
//          (head, slot) pair a thread, FFMA over the K row in 16-byte
//          pieces, q pre-scaled;
//       2. the online softmax, a warp a head, a lane a slot: the running
//          max m and sum l in shared memory, p = exp(s - m) in float32;
//       3. acc = acc * exp(m_old - m) + P V in float32 (FFMA; P is never
//          rounded to bf16), threads over hd_v in pairs, the heads shared
//          out between groups of threads, acc in registers across tiles.
//     Then it writes its partial (m, l, acc) for the G heads.
//   gqa_combine_kernel: one block per (KV head, b) merges the partials in a
//     fixed order: M = max m_s, L = sum exp(m_s - M) l_s,
//     out = sum exp(m_s - M) acc_s / max(L, 1e-30).
//
// No atomics, so reruns give the same bits.  The ragged end of T is
// zero-filled by the copies and left out of the softmax; the cache is not
// padded.  Masked scores are -1e30, not -inf, as in the reference: slots
// that are all masked so far give m = -1e30 and weight exp(-1e30 - M) = 0
// once a valid slot is met, and a query with no valid slot at all
// averages v over every slot, as the reference does; no inf - inf, no NaN.
// A masked slot's score is -1e30 whatever its K row holds; every V row is
// read, so a non-finite value in a masked slot's V row propagates as in
// the reference (0 * NaN).
//
// Bound on the H100: bytes.  At the serving shape (qwen3-4b: B = 8,
// T = 4160, K = 8, G = 4, hd = hd_v = 128, bf16) K and V are read once:
// 2 * 8 * 4160 * 8 * 128 * 2 B = 136.3 MB, 40.7 us at 3.35 TB/s, against
// about 0.55 GFLOP, about 4 FLOP a byte.  The partials add
// B * K * 6 * G * (hd_v + 2) * 4 B = 0.8 MB written and read once.  So the
// design keeps bytes in flight without holding the arithmetic up: three
// tiles in the ring, 61.1 KB of shared memory a block (3 blocks an SM),
// the copies started by a warp of their own (started by every thread,
// the 16-byte copies stalled the threads for longer than the tile's
// arithmetic took).  Rows whose width is not a multiple of 16 bytes, or
// bases that are not 16-byte aligned, take plain element copies through
// the same ring.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "mma_sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 128;           // 4 warps: scores, softmax, P V
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;  // and a producer warp: the copies
constexpr int kTile = 32;     // cache slots per tile (a lane each)
constexpr int kStages = 3;    // tiles in the ring
constexpr int kMaxG = 16;     // query heads per KV head
constexpr int kMaxHd = 256;   // hd and hd_v
constexpr float kNegInf = -1e30f;

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// a 16-byte piece of a staged row, as float32
__device__ __forceinline__ void unpack(const float* p, float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}
__device__ __forceinline__ void unpack(const bf16* p, float (&o)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {     // element 2i is the low half
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// elements 2c and 2c + 1 of a staged row, as float32
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
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

// two 8 x 8 b16 matrices: lanes 0-7 and 8-15 give the row addresses, lane
// l receives row l / 4, 32-bit column l % 4 of each
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
// c += a b for one 16 x 8 x 16 bf16 tile, float32 accumulate.  Fragments
// (g = lane / 4, t4 = lane % 4): a = {(g, 2 t4..), (g + 8, 2 t4..),
// (g, 2 t4 + 8..), (g + 8, 2 t4 + 8..)}, b = {(k = 2 t4.., n = g),
// (k = 2 t4 + 8.., n = g)}, c = {(g, 2 t4), (g, 2 t4 + 1), (g + 8, 2 t4),
// (g + 8, 2 t4 + 1)}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mbar_init(void* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// one arrival on `bar` once every cp.async the thread has started is
// complete (the arrival is counted in the barrier's expected count)
__device__ __forceinline__ void mbar_arrive_copies(void* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(void* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// the consumer warps' barrier (named barrier 1; the producer is not in it)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(void* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// elements of a staged row w wide: w rounded up to 16 bytes, plus 16
// bytes, so that 8 consecutive rows of an even number of 16-byte pieces
// (hd = 64, 128, 256 ...) start in 8 distinct 16-byte bank groups
// (ldmatrix, and the 16-byte reads of the float32 score pass)
template <typename T>
__host__ __device__ constexpr int row_ld(int w) {
  constexpr int p = 16 / static_cast<int>(sizeof(T));
  return (w + p - 1) / p * p + p;
}

// the dynamic shared memory of gqa_split_kernel: the ring (kStages tiles
// of kTile K rows, then kTile V rows), the scores of two tiles (2, kMaxG,
// kTile) float32, the tiles' slot positions (kStages, kTile) int32, and
// the query rows: (16, ldk) bf16, rows >= G zero, for the score mma;
// (G, hd) float32, pre-scaled, otherwise
struct Layout {
  int ldk, ldv, stage;     // elements of a K row, a V row, a ring stage
  int s_off, p_off, q_off, bytes;
};

template <typename T, bool MMA>
__host__ __device__ Layout layout(int G, int hd, int hd_v) {
  Layout L;
  L.ldk = row_ld<T>(hd);
  L.ldv = row_ld<T>(hd_v);
  L.stage = kTile * (L.ldk + L.ldv);
  L.s_off = kStages * L.stage * static_cast<int>(sizeof(T));
  L.p_off = L.s_off + 2 * kMaxG * kTile * static_cast<int>(sizeof(float));
  L.q_off = L.p_off + kStages * kTile * static_cast<int>(sizeof(int));
  L.bytes = L.q_off + (MMA ? 16 * L.ldk * static_cast<int>(sizeof(T))
                           : G * hd * static_cast<int>(sizeof(float)));
  return L;
}

// grid (n_split, K, B), kThreads threads, layout<T, MMA>(...).bytes of
// dynamic shared memory.  VEC: K and V rows of whole 16-byte pieces and
// 16-byte aligned k and v (16-byte cp.async copies); MMA (bf16 only): VEC
// and hd % 16 == 0 (scores on the tensor cores).
//
// Warps 0-3 compute; warp 4 makes the copies.  Stage `buf` of the ring
// has two mbarriers: full[buf] completes when each of the producer's 32
// lanes has arrived once its copies into the stage are complete;
// empty[buf] when the kConsumers threads have arrived after their last
// read of it.  The consumers sync among themselves (named barrier 1)
// after the scores and after the softmax; the scores are double-buffered,
// so no third barrier is needed before the next tile's scores.
template <typename T, bool VEC, bool MMA>
__global__ void __launch_bounds__(kThreads, 3)
gqa_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ k_pos,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc, int n_t, int H, int K, int hd,
                 int hd_v, int q_pos, int window, float scale,
                 int split_tiles) {
  static_assert(kTile == 32, "the softmax pass gives a lane to a slot");
  static_assert(kTile == 8 * kWarps, "the score mma gives 8 slots a warp");
  static_assert(!MMA || (VEC && kIsBf16<T>), "the score mma takes bf16");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_sh[kMaxG];    // running max of each head
  __shared__ float l_sh[kMaxG];    // running sum of exp(s - m)
  __shared__ float c_sh[kMaxG];    // this tile's exp(m_old - m)
  __shared__ __align__(8) unsigned long long full[kStages];
  __shared__ __align__(8) unsigned long long empty[kStages];
  const int G = H / K;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout L = layout<T, MMA>(G, hd, hd_v);
  T* ring = reinterpret_cast<T*>(smem);
  int* pos_sh = reinterpret_cast<int*>(smem + L.p_off);
  const int tile0 = split * split_tiles;
  const int n_tiles = min(split_tiles, (n_t + kTile - 1) / kTile - tile0);

  // the KV head's G query rows
  const T* q_b = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * G)
                     * hd;
  if constexpr (MMA) {
    T* qs = reinterpret_cast<T*>(smem + L.q_off);
    for (int i = tid; i < 16 * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      qs[r * L.ldk + d] = r < G ? q_b[i] : __float2bfloat16(0.f);
    }
  } else {
    float* qf = reinterpret_cast<float*>(smem + L.q_off);
    for (int i = tid; i < G * hd; i += kThreads)
      qf[i] = to_float(q_b[i]) * scale;
  }
  if (tid < kMaxG) {
    m_sh[tid] = kNegInf;
    l_sh[tid] = 0.f;
  }
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 32);
      mbar_init(&empty[st], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // the producer: each tile's slot positions and K and V rows into its
    // ring stage once the consumers have left it, zero past T.  With VEC
    // the lanes walk the tile's (row, 16-byte piece) pairs with cp.async
    // and arrive when their copies land, so no consumer waits while a copy
    // is started; otherwise they copy element by element and then arrive.
    constexpr int P = 16 / static_cast<int>(sizeof(T));
    const int kp = hd / P, vp = hd_v / P;
    const size_t k_row = static_cast<size_t>(K) * hd;
    const size_t v_row = static_cast<size_t>(K) * hd_v;
    const T* k_b = k + static_cast<size_t>(b) * n_t * k_row
                   + static_cast<size_t>(kh) * hd;
    const T* v_b = v + static_cast<size_t>(b) * n_t * v_row
                   + static_cast<size_t>(kh) * hd_v;
    // the rows of a stage, as 16-byte pieces: lane, lane + 32, ...
    auto pieces = [&](T* dst, int ld, const T* src, size_t row, int np,
                      int n_in) {
      for (int r = lane / np, c = lane % np; r < kTile;) {
        const bool ok = r < n_in;
        cp_async16(dst + r * ld + c * P, ok ? src + r * row + c * P : src,
                   ok);
        r += 32 / np;
        c += 32 % np;
        if (c >= np) {
          c -= np;
          ++r;
        }
      }
    };
    for (int it = 0; it < n_tiles; ++it) {
      const int buf = it % kStages;
      if (it >= kStages) mbar_wait(&empty[buf], (it / kStages - 1) & 1);
      T* ks = ring + buf * L.stage;
      T* vs = ks + kTile * L.ldk;
      const int t0 = (tile0 + it) * kTile;
      const int n_in = min(kTile, n_t - t0);
      if constexpr (VEC) {
        cp_async4(pos_sh + buf * kTile + lane,
                  lane < n_in ? k_pos + t0 + lane : k_pos, lane < n_in);
        pieces(ks, L.ldk, k_b + t0 * k_row, k_row, kp, n_in);
        pieces(vs, L.ldv, v_b + t0 * v_row, v_row, vp, n_in);
        mbar_arrive_copies(&full[buf]);
      } else {
        pos_sh[buf * kTile + lane] = lane < n_in ? k_pos[t0 + lane] : -1;
        for (int i = lane; i < kTile * hd; i += 32) {
          const int r = i / hd, d = i - r * hd;
          store(ks + r * L.ldk + d,
                r < n_in ? to_float(k_b[(t0 + r) * k_row + d]) : 0.f);
        }
        for (int i = lane; i < kTile * hd_v; i += 32) {
          const int r = i / hd_v, d = i - r * hd_v;
          store(vs + r * L.ldv + d,
                r < n_in ? to_float(v_b[(t0 + r) * v_row + d]) : 0.f);
        }
        mbar_arrive(&full[buf]);
      }
    }
    return;
  }

  // the consumers.  P V: thread (grp, cp) owns columns 2 cp and 2 cp + 1
  // of heads g = grp + n_grp * j; a group is 32, 64 or 128 threads
  const int cp_n = (hd_v + 1) / 2;
  const int gw = cp_n <= 32 ? 32 : cp_n <= 64 ? 64 : 128;
  const int n_grp = kConsumers / gw;
  const int grp = tid / gw, cp = tid % gw;
  float acc[kMaxG][2];
#pragma unroll
  for (int j = 0; j < kMaxG; ++j) acc[j][0] = acc[j][1] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it % kStages;
    mbar_wait(&full[buf], (it / kStages) & 1);
    const T* ks = ring + buf * L.stage;
    const T* vs = ks + kTile * L.ldk;
    const int* pos = pos_sh + buf * kTile;
    float* s_sh = reinterpret_cast<float*>(smem + L.s_off)
                  + (it % 2) * kMaxG * kTile;
    const int n_in = min(kTile, n_t - (tile0 + it) * kTile);
    // slot r of the tile: in the cache and valid
    auto valid = [&](int r) {
      const int p = pos[r];
      return r < n_in && p >= 0 && p <= q_pos
             && (window <= 0 || p > q_pos - window);
    };

    // 1. scores s_sh[g, r] of the tile's slots
    if constexpr (MMA) {
      const T* qs = reinterpret_cast<const T*>(smem + L.q_off);
      const int n0 = warp * 8;               // the warp's 8 slots
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int kk = 0; kk < hd; kk += 16) {
        unsigned a[4];
        unsigned bk[2];
        ldmatrix_x4(a, qs + (lane % 16) * L.ldk + kk + (lane / 16) * 8);
        ldmatrix_x2(bk, ks + (n0 + lane % 8) * L.ldk + kk
                            + ((lane / 8) % 2) * 8);
        mma_bf16(c, a, bk[0], bk[1]);
      }
      const int g = lane / 4, t4 = lane % 4;
#pragma unroll
      for (int j = 0; j < 2; ++j) {          // heads g and g + 8
        const int r = n0 + 2 * t4 + j;
        const bool ok = valid(r);
        if (g < G) s_sh[g * kTile + r] = ok ? c[j] * scale : kNegInf;
        if (g + 8 < G)
          s_sh[(g + 8) * kTile + r] = ok ? c[2 + j] * scale : kNegInf;
      }
    } else {
      const float* qf = reinterpret_cast<const float*>(smem + L.q_off);
      for (int e = tid; e < G * kTile; e += kConsumers) {
        const int g = e / kTile, r = e % kTile;
        float s = kNegInf;
        if (valid(r)) {
          const T* kr = ks + r * L.ldk;
          const float* qg = qf + g * hd;
          s = 0.f;
          if constexpr (VEC) {
            constexpr int P = 16 / static_cast<int>(sizeof(T));
            for (int d = 0; d < hd; d += P) {
              float kv[P];
              unpack(kr + d, kv);
#pragma unroll
              for (int i = 0; i < P; ++i) s = fmaf(qg[d + i], kv[i], s);
            }
          } else {
            for (int d = 0; d < hd; ++d) s = fmaf(qg[d], to_float(kr[d]), s);
          }
        }
        s_sh[g * kTile + r] = s;
      }
    }
    consumer_sync();

    // 2. online softmax: a warp a head, a lane a slot; slots past T are
    // left out (p = 0)
    for (int g = warp; g < G; g += kWarps) {
      const float s = lane < n_in ? s_sh[g * kTile + lane] : -INFINITY;
      const float m_old = m_sh[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = lane < n_in ? expf(s - m_new) : 0.f;
      s_sh[g * kTile + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_sh[g] = corr;
        l_sh[g] = l_sh[g] * corr + sum;
        m_sh[g] = m_new;
      }
    }
    consumer_sync();

    // 3. acc = acc * corr + P V, slots in order (past T: p = 0, v = 0)
    if (cp < cp_n) {
#pragma unroll
      for (int j = 0; j < kMaxG; ++j) {
        const int g = grp + n_grp * j;
        if (g >= G) break;
        acc[j][0] *= c_sh[g];
        acc[j][1] *= c_sh[g];
      }
#pragma unroll
      for (int r = 0; r < kTile; r += 4) {
        float2 vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          vv[u] = load_pair(vs + (r + u) * L.ldv + 2 * cp);
#pragma unroll
        for (int j = 0; j < kMaxG; ++j) {
          const int g = grp + n_grp * j;
          if (g >= G) break;
          const float4 p = *reinterpret_cast<const float4*>(
              s_sh + g * kTile + r);
          const float pu[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[j][0] = fmaf(pu[u], vv[u].x, acc[j][0]);
            acc[j][1] = fmaf(pu[u], vv[u].y, acc[j][1]);
          }
        }
      }
    }
    mbar_arrive(&empty[buf]);                 // the stage is read
  }

  const size_t base = (static_cast<size_t>(b) * K + kh) * gridDim.x + split;
  if (cp < cp_n) {
#pragma unroll
    for (int j = 0; j < kMaxG; ++j) {
      const int g = grp + n_grp * j;
      if (g >= G) break;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int d = 2 * cp + i;
        if (d < hd_v) part_acc[(base * G + g) * hd_v + d] = acc[j][i];
      }
    }
  }
  if (tid < G) {
    part_m[base * G + tid] = m_sh[tid];
    part_l[base * G + tid] = l_sh[tid];
  }
}

// grid (K, B), kThreads threads, 2 * n_split * G floats of dynamic shared
// memory: the partials' m and l, loaded at once, then each head's weights
// exp(m_s - M) in their place, taken by a thread a head in split order;
// then the outputs a thread each, every sum over the splits in order
template <typename T>
__global__ void __launch_bounds__(kThreads)
gqa_combine_kernel(const float* __restrict__ part_m,
                   const float* __restrict__ part_l,
                   const float* __restrict__ part_acc, T* __restrict__ out,
                   int n_split, int H, int K, int hd_v) {
  extern __shared__ float w_sh[];        // (n_split, G): m, then weights
  __shared__ float denom_sh[kMaxG];      // max(L, 1e-30)
  const int G = H / K;
  const int kh = blockIdx.x, b = blockIdx.y;
  const size_t base = (static_cast<size_t>(b) * K + kh) * n_split;
  float* l_sh = w_sh + n_split * G;
  for (int i = threadIdx.x; i < n_split * G; i += kThreads) {
    w_sh[i] = part_m[base * G + i];
    l_sh[i] = part_l[base * G + i];
  }
  __syncthreads();
  const int g = threadIdx.x;
  if (g < G) {
    float m_max = kNegInf;
    for (int s = 0; s < n_split; ++s) m_max = fmaxf(m_max, w_sh[s * G + g]);
    float l = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(w_sh[s * G + g] - m_max);
      w_sh[s * G + g] = w;
      l += w * l_sh[s * G + g];
    }
    denom_sh[g] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * hd_v; i += kThreads) {
    const int h = i / hd_v, d = i - h * hd_v;
    const float* pa = part_acc + (base * G + h) * hd_v + d;
    float a = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s)
      a += w_sh[s * G + h] * pa[static_cast<size_t>(s) * G * hd_v];
    store(out + (static_cast<size_t>(b) * H + kh * G + h) * hd_v + d,
          a / denom_sh[h]);
  }
}

template <typename T, bool VEC, bool MMA>
int launch_split(const T* q, const T* k, const T* v, const int* k_pos,
                 float* part_m, float* part_l, float* part_acc, int B,
                 int n_t, int H, int K, int hd, int hd_v, int q_pos,
                 int window, float scale, int split_tiles, int n_split,
                 cudaStream_t stream) {
  const int bytes = layout<T, MMA>(H / K, hd, hd_v).bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      gqa_split_kernel<T, VEC, MMA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gqa_split_kernel<T, VEC, MMA><<<dim3(n_split, K, B), kThreads, bytes,
                                  stream>>>(
      q, k, v, k_pos, part_m, part_l, part_acc, n_t, H, K, hd, hd_v, q_pos,
      window, scale, split_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const int* k_pos, T* out,
           float* part_m, float* part_l, float* part_acc, int B, int n_t,
           int H, int K, int hd, int hd_v, int q_pos, int window,
           int split_tiles, cudaStream_t stream) {
  if (B < 1 || n_t < 1 || H < 1 || K < 1 || hd < 1 || hd_v < 1
      || H % K != 0 || H / K > kMaxG || hd > kMaxHd || hd_v > kMaxHd
      || K > 65535 || B > 65535 || split_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_split = ((n_t + kTile - 1) / kTile + split_tiles - 1)
                      / split_tiles;
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  const auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  constexpr int P = 16 / static_cast<int>(sizeof(T));
  const bool vec = hd % P == 0 && hd_v % P == 0 && aligned(k) && aligned(v);
  // the combine, once the split pass has launched
  const auto finish = [&](int err) {
    if (err != 0) return err;
    const int bytes = 2 * n_split * (H / K) * static_cast<int>(sizeof(float));
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          gqa_combine_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    gqa_combine_kernel<T><<<dim3(K, B), kThreads, bytes, stream>>>(
        part_m, part_l, part_acc, out, n_split, H, K, hd_v);
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (kIsBf16<T>) {
    if (vec && hd % 16 == 0)
      return finish(launch_split<T, true, true>(
          q, k, v, k_pos, part_m, part_l, part_acc, B, n_t, H, K, hd, hd_v,
          q_pos, window, scale, split_tiles, n_split, stream));
  }
  return finish(vec ? launch_split<T, true, false>(
                          q, k, v, k_pos, part_m, part_l, part_acc, B, n_t,
                          H, K, hd, hd_v, q_pos, window, scale, split_tiles,
                          n_split, stream)
                    : launch_split<T, false, false>(
                          q, k, v, k_pos, part_m, part_l, part_acc, B, n_t,
                          H, K, hd, hd_v, q_pos, window, scale, split_tiles,
                          n_split, stream));
}

}  // namespace

// The partials part_m, part_l: (B, K, n_split, G) and part_acc:
// (B, K, n_split, G, hd_v), float32 scratch allocated by the caller, with
// n_split = ceil(ceil(T / 32) / split_tiles) (ops.gqa_plan).  All pointers
// contiguous, on the device of `stream`.  Returns the launches'
// cudaError_t (cudaErrorInvalidValue for a shape the kernel does not take:
// G > 16, hd or hd_v > 256, split_tiles < 1).
extern "C" int gqa_decode_f32(const float* q, const float* k, const float* v,
                              const int* k_pos, float* out, float* part_m,
                              float* part_l, float* part_acc, int B, int n_t,
                              int H, int K, int hd, int hd_v, int q_pos,
                              int window, int split_tiles,
                              cudaStream_t stream) {
  return launch(q, k, v, k_pos, out, part_m, part_l, part_acc, B, n_t, H, K,
                hd, hd_v, q_pos, window, split_tiles, stream);
}

// The same with bfloat16 q, k, v and out.
extern "C" int gqa_decode_bf16(const bf16* q, const bf16* k, const bf16* v,
                               const int* k_pos, bf16* out, float* part_m,
                               float* part_l, float* part_acc, int B,
                               int n_t, int H, int K, int hd, int hd_v,
                               int q_pos, int window, int split_tiles,
                               cudaStream_t stream) {
  return launch(q, k, v, k_pos, out, part_m, part_l, part_acc, B, n_t, H, K,
                hd, hd_v, q_pos, window, split_tiles, stream);
}
