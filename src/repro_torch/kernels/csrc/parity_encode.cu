// Local parity encoding (paper eq. 19) on Hopper, all clients at once or
// one client.
//
//   parity_b = G_b diag(w_b) X_b      G_b: (u, l), w_b: (l,), X_b: (l, q)
//
// Replaces the Pallas TPU kernels `parity_encode_batched` (grid (n, U/bu,
// Q/bq, L/bl)) and `parity_encode` (grid (U/bu, Q/bq, L/bl), one client,
// `encoding.encode_local`) in src/repro/kernels/parity_encode.py; both fuse
// diag(w) into the generator tile.  The single-client entry point is the
// batched one with n = 1, and every output's sum runs in an order that
// depends only on its row, its column and the inputs, never on n: a
// client's parity set is the same bits either way.
//
// Bound on the H100: operations for the features, bytes for the labels.
// At the main-path shape n = 30, u = 2400, l = 400, q = 2000 the encode
// does 2*n*u*l*q = 115 GFLOP against 787 MB moved; taken as 3xTF32 on the
// tensor cores (three TF32 products for each float32 one, 495 TFLOP/s
// dense) the least time is 0.70 ms.  The label encode (q = c = 10) does
// 0.6 GFLOP against 118 MB and is bound by reading G: 0.034 ms.
//
// Wide q (q > 16): a float32 GEMM on the tensor cores in 3xTF32 (see
// mma_sm90.cuh), one block of 8 warps per (client, 128-row u tile,
// 128-column q tile), each warp a 32 x 64 part of it as 2 x 8 m16n8k8
// tiles.  G and X are staged through a ring of 3 shared-memory buffers of
// 16 K steps each with cp.async (16-byte copies where l and q are
// multiples of 4, 4-byte copies otherwise; zero-filled past the edges).
// diag(w) is applied to the G fragments as they leave shared memory, in
// float32 (G w rounds as the reference's G * w does), so G diag(w) is never
// written out.  The tensor cores' float32 sums round toward zero: every 16
// K steps of 8 each thread adds them into float32 registers with an
// ordinary add.
//
// Narrow q (q <= 16, the label encode): a float32 FFMA pass, two threads
// per row of G, G staged through a cp.async ring 32 K steps at a time; a
// tile 128 columns wide would waste 92% of its products at q = 10.
#include <cstdint>

#include "mma_sm90.cuh"

namespace {

using namespace sm90;

constexpr int THREADS = 256;
constexpr int BM = 128;           // rows of u per block
constexpr int BN = 128;           // columns of q per block
constexpr int BK = 16;            // K per stage (two m16n8k8 steps)
constexpr int STAGES = 3;
constexpr int A_LD = BK + 4;      // 80-byte rows: ldmatrix's 8 rows hit 8
                                  // distinct 16-byte bank groups
constexpr int B_LD = BN + 8;      // the 32 lanes' B reads hit 32 banks
constexpr int FLUSH = 16;         // K steps of 8 between float32 adds
constexpr int SMEM_BYTES = STAGES * (BM * A_LD + BK * B_LD) * 4;

// split_tf32 (mma_sm90.cuh) in fewer operations: adding half a TF32 ulp
// (0x1000) to the bits and clearing the 13 low ones rounds the magnitude to
// nearest, ties away from zero, as cvt.rna.tf32.f32 does for every finite
// value; an add and a logic op each run at full rate, where a conversion
// does not.  The small part v - big is exact in float32 and is passed
// whole: the tensor cores read the top 19 bits of a TF32 operand.  A NaN
// keeps its NaN in the small part (NaN - big); Inf gives big = Inf and a
// NaN small part, as with cvt.rna.
__device__ __forceinline__ void split_tf32_int(unsigned v, unsigned& big,
                                               unsigned& small) {
  big = (v + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(v) - __uint_as_float(big));
}

// out_b = G_b diag(w_b) X_b over a (BM, BN) tile; VEC: l % 4 == 0,
// q % 4 == 0 and 16-byte aligned bases (16-byte copies)
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
encode_tc_kernel(const float* __restrict__ G, const float* __restrict__ w,
                 const float* __restrict__ X, float* __restrict__ out, int M,
                 int K, int N) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                          // [STAGES][BM][A_LD]
  float* Bs = smem + STAGES * BM * A_LD;     // [STAGES][BK][B_LD]
  const long long b = blockIdx.z;
  G += b * M * (long long)K;
  w += b * K;
  X += b * K * (long long)N;
  out += b * M * (long long)N;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const int wm = warp / 2;        // 4 x 2 warps of 32 x 64
  const int wn = warp % 2;
  const int g = lane / 4;
  const int t4 = lane % 4;

  auto load = [&](int buf, int k0) {
    float* as = As + buf * BM * A_LD;
    float* bs = Bs + buf * BK * B_LD;
    if (VEC) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {           // 128 rows x 4 chunks of 4
        const int e = t + u * THREADS;
        const int r = e / 4;
        const int kc = (e % 4) * 4;
        const bool ok = row0 + r < M && k0 + kc < K;
        cp_async16(as + r * A_LD + kc,
                   ok ? G + (long long)(row0 + r) * K + k0 + kc : G, ok);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {           // 16 rows x 32 chunks of 4
        const int e = t + u * THREADS;
        const int kk = e / 32;
        const int j = (e % 32) * 4;
        const bool ok = k0 + kk < K && col0 + j < N;
        cp_async16(bs + kk * B_LD + j,
                   ok ? X + (long long)(k0 + kk) * N + col0 + j : X, ok);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = t + u * THREADS;
        const int r = e / BK;
        const int kk = e % BK;
        const bool ok = row0 + r < M && k0 + kk < K;
        cp_async4(as + r * A_LD + kk,
                  ok ? G + (long long)(row0 + r) * K + k0 + kk : G, ok);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = t + u * THREADS;
        const int kk = e / BN;
        const int j = e % BN;
        const bool ok = k0 + kk < K && col0 + j < N;
        cp_async4(bs + kk * B_LD + j,
                  ok ? X + (long long)(k0 + kk) * N + col0 + j : X, ok);
      }
    }
  };

  float acc[2][8][4];
  float tot[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0.0f;
        tot[mi][ni][e] = 0.0f;
      }

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, st * BK);
    cp_async_commit();
  }
  int step = 0;                               // K steps of 8 taken
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage kt is complete; stage kt-1's buffer is free
    if (kt + STAGES - 1 < nk)
      load((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BK);
    cp_async_commit();
    const float* as = As + buf * BM * A_LD;
    const float* bs = Bs + buf * BK * B_LD;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const int k = kt * BK + ks * 8 + t4;
      const float w0 = k < K ? __ldg(w + k) : 0.0f;
      const float w1 = k + 4 < K ? __ldg(w + k + 4) : 0.0f;
      unsigned a_big[2][4];
      unsigned a_small[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        unsigned raw[4];
        ldmatrix_x4(raw, as + (wm * 32 + mi * 16 + lane % 16) * A_LD +
                             ks * 8 + (lane / 16) * 4);
        // fragments (g, t4), (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4):
        // G diag(w), rounded to float32 before the split
        raw[0] = __float_as_uint(__uint_as_float(raw[0]) * w0);
        raw[1] = __float_as_uint(__uint_as_float(raw[1]) * w0);
        raw[2] = __float_as_uint(__uint_as_float(raw[2]) * w1);
        raw[3] = __float_as_uint(__uint_as_float(raw[3]) * w1);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32_int(raw[e], a_big[mi][e], a_small[mi][e]);
      }
      const float* bk = bs + (ks * 8 + t4) * B_LD + wn * 64 + g;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        unsigned b_big[2];
        unsigned b_small[2];
        split_tf32_int(__float_as_uint(bk[ni * 8]), b_big[0], b_small[0]);
        split_tf32_int(__float_as_uint(bk[4 * B_LD + ni * 8]), b_big[1],
                       b_small[1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_tf32(acc[mi][ni], a_small[mi], b_big[0], b_big[1]);
          mma_tf32(acc[mi][ni], a_big[mi], b_small[0], b_small[1]);
          mma_tf32(acc[mi][ni], a_big[mi], b_big[0], b_big[1]);
        }
      }
      // the tensor cores' partial sums into float32 registers
      if (++step % FLUSH == 0) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[mi][ni][e] += acc[mi][ni][e];
              acc[mi][ni][e] = 0.0f;
            }
      }
    }
  }
  cp_async_wait_all();

  const bool pairs = N % 2 == 0;   // float2 stores stay 8-byte aligned
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm * 32 + mi * 16 + g + h * 8;
      if (r >= M) continue;
      float* orow = out + (long long)r * N;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int j = col0 + wn * 64 + ni * 8 + 2 * t4;
        const float v0 = tot[mi][ni][2 * h] + acc[mi][ni][2 * h];
        const float v1 = tot[mi][ni][2 * h + 1] + acc[mi][ni][2 * h + 1];
        if (pairs && j + 1 < N) {
          *reinterpret_cast<float2*>(orow + j) = make_float2(v0, v1);
        } else {
          if (j < N) orow[j] = v0;
          if (j + 1 < N) orow[j + 1] = v1;
        }
      }
    }
  }
}

// q <= 16: two threads per row of G, one for each half of a 32-wide K
// step, their sums added at the end (h = 0 first); G (64 rows x 32 K
// steps), w and X (32 x NC) staged through a ring of 3 shared-memory
// buffers with cp.async, G in 16-byte copies where l is a multiple of 4
constexpr int NR_ROWS = 64;
constexpr int NR_THREADS = 2 * NR_ROWS;
constexpr int NR_BK = 32;
constexpr int NR_LD = NR_BK + 4;   // 144-byte rows: a quarter warp's
                                   // 16-byte reads hit 32 distinct banks
constexpr int NR_STAGES = 3;

template <int NC>
constexpr int nr_smem_bytes() {
  return NR_STAGES * (NR_ROWS * NR_LD + NR_BK * NC + NR_BK) * 4;
}

template <int NC, bool VEC>
__global__ void __launch_bounds__(NR_THREADS)
encode_narrow_kernel(const float* __restrict__ G,
                     const float* __restrict__ w,
                     const float* __restrict__ X, float* __restrict__ out,
                     int M, int K, int N) {
  extern __shared__ __align__(16) float smem[];
  float* Gs = smem;                                // [STAGES][ROWS][LD]
  float* Xs = Gs + NR_STAGES * NR_ROWS * NR_LD;    // [STAGES][BK][NC]
  float* ws = Xs + NR_STAGES * NR_BK * NC;         // [STAGES][BK]
  const long long b = blockIdx.y;
  G += b * M * (long long)K;
  w += b * K;
  X += b * K * (long long)N;
  out += b * M * (long long)N;
  const int row0 = blockIdx.x * NR_ROWS;
  const int t = threadIdx.x;
  const int r = t / 2;             // the thread's row
  const int h = t % 2;             // its half of each K step

  auto load = [&](int buf, int k0) {
    float* gs = Gs + buf * NR_ROWS * NR_LD;
    if (VEC) {
#pragma unroll
      for (int u = 0; u < NR_ROWS * NR_BK / 4 / NR_THREADS; ++u) {
        const int e = t + u * NR_THREADS;
        const int rr = e / (NR_BK / 4);
        const int kc = (e % (NR_BK / 4)) * 4;
        const bool ok = row0 + rr < M && k0 + kc < K;
        cp_async16(gs + rr * NR_LD + kc,
                   ok ? G + (long long)(row0 + rr) * K + k0 + kc : G, ok);
      }
    } else {
#pragma unroll 4
      for (int u = 0; u < NR_ROWS * NR_BK / NR_THREADS; ++u) {
        const int e = t + u * NR_THREADS;
        const int rr = e / NR_BK;
        const int kk = e % NR_BK;
        const bool ok = row0 + rr < M && k0 + kk < K;
        cp_async4(gs + rr * NR_LD + kk,
                  ok ? G + (long long)(row0 + rr) * K + k0 + kk : G, ok);
      }
    }
    for (int e = t; e < NR_BK * NC; e += NR_THREADS) {
      const int kk = e / NC;
      const int cc = e % NC;
      const bool ok = k0 + kk < K && cc < N;
      cp_async4(Xs + buf * NR_BK * NC + e,
                ok ? X + (long long)(k0 + kk) * N + cc : X, ok);
    }
    if (t < NR_BK)
      cp_async4(ws + buf * NR_BK + t, k0 + t < K ? w + k0 + t : w,
                k0 + t < K);
  };

  float acc[NC];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) acc[cc] = 0.0f;
  const int nk = (K + NR_BK - 1) / NR_BK;
#pragma unroll
  for (int st = 0; st < NR_STAGES - 1; ++st) {
    if (st < nk) load(st, st * NR_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt % NR_STAGES;
    cp_async_wait<NR_STAGES - 2>();
    __syncthreads();   // step kt has landed; step kt-1's buffer is free
    if (kt + NR_STAGES - 1 < nk)
      load((kt + NR_STAGES - 1) % NR_STAGES, (kt + NR_STAGES - 1) * NR_BK);
    cp_async_commit();
    const float* gs = Gs + buf * NR_ROWS * NR_LD + r * NR_LD + h * 16;
    const float* xs = Xs + buf * NR_BK * NC + h * 16 * NC;
    const float* wk = ws + buf * NR_BK + h * 16;
#pragma unroll
    for (int k4 = 0; k4 < 16; k4 += 4) {
      const float4 gv = *reinterpret_cast<const float4*>(gs + k4);
      const float4 wv = *reinterpret_cast<const float4*>(wk + k4);
      const float a[4] = {gv.x * wv.x, gv.y * wv.y, gv.z * wv.z,
                          gv.w * wv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c2 = 0; c2 < NC / 2; ++c2) {
          const float2 xv = *reinterpret_cast<const float2*>(
              xs + (k4 + e) * NC + 2 * c2);
          acc[2 * c2] = fmaf(a[e], xv.x, acc[2 * c2]);
          acc[2 * c2 + 1] = fmaf(a[e], xv.y, acc[2 * c2 + 1]);
        }
      }
    }
  }
  cp_async_wait_all();
  // the pair's halves, h = 0 first
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) {
    const float other = __shfl_xor_sync(0xffffffffu, acc[cc], 1);
    acc[cc] = h == 0 ? acc[cc] + other : other + acc[cc];
  }
  if (h == 0 && row0 + r < M) {
    float* orow = out + (long long)(row0 + r) * N;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
      if (cc < N) orow[cc] = acc[cc];
  }
}

template <int NC>
int launch_narrow(const float* g, const float* w, const float* x, float* out,
                  int n, int u, int l, int q, bool vec,
                  cudaStream_t stream) {
  constexpr int smem = nr_smem_bytes<NC>();
  const dim3 grid((u + NR_ROWS - 1) / NR_ROWS, n);
  if (vec)
    encode_narrow_kernel<NC, true><<<grid, NR_THREADS, smem, stream>>>(
        g, w, x, out, u, l, q);
  else
    encode_narrow_kernel<NC, false><<<grid, NR_THREADS, smem, stream>>>(
        g, w, x, out, u, l, q);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_tc(const float* g, const float* w, const float* x, float* out,
              int n, int u, int l, int q, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      encode_tc_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((q + BN - 1) / BN, (u + BM - 1) / BM, n);
  encode_tc_kernel<VEC><<<grid, THREADS, SMEM_BYTES, stream>>>(g, w, x, out,
                                                               u, l, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: (n, u, l), w: (n, l), x: (n, l, q), out: (n, u, q); float32,
// contiguous, on the device of `stream`.  Returns the launch's cudaError_t.
extern "C" int parity_encode_batched_f32(const float* g, const float* w,
                                         const float* x, float* out, int n,
                                         int u, int l, int q,
                                         cudaStream_t stream) {
  if (n < 1 || u < 1 || l < 1 || q < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  const bool g_vec = l % 4 == 0 && aligned(g);
  if (q <= 4)
    return launch_narrow<4>(g, w, x, out, n, u, l, q, g_vec, stream);
  if (q <= 8)
    return launch_narrow<8>(g, w, x, out, n, u, l, q, g_vec, stream);
  if (q <= 12)
    return launch_narrow<12>(g, w, x, out, n, u, l, q, g_vec, stream);
  if (q <= 16)
    return launch_narrow<16>(g, w, x, out, n, u, l, q, g_vec, stream);
  if (l % 4 == 0 && q % 4 == 0 && aligned(g) && aligned(x))
    return launch_tc<true>(g, w, x, out, n, u, l, q, stream);
  return launch_tc<false>(g, w, x, out, n, u, l, q, stream);
}

// g: (u, l), w: (l,), x: (l, q), out: (u, q); float32, contiguous, on the
// device of `stream`.  Returns the launch's cudaError_t.
extern "C" int parity_encode_f32(const float* g, const float* w,
                                 const float* x, float* out, int u, int l,
                                 int q, cudaStream_t stream) {
  return parity_encode_batched_f32(g, w, x, out, 1, u, l, q, stream);
}
