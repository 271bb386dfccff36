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
// Wide q (q > 16): the float32 tile of tc_gemm_f32.cuh on the tensor cores
// in 3xTF32 (128 x 128 blocks of 8 warps, a 3-stage cp.async ring, partial
// sums added into float32 registers every 16 K steps), with diag(w) applied
// to the G fragments as they leave shared memory, in float32 (G w rounds as
// the reference's G * w does), so G diag(w) is never written out.
//
// Narrow q (q <= 16, the label encode): a float32 FFMA pass, two threads
// per row of G, G staged through a cp.async ring 32 K steps at a time; a
// tile 128 columns wide would waste 92% of its products at q = 10.
#include <cstdint>

#include "mma_sm90.cuh"
#include "tc_gemm_f32.cuh"

namespace {

using namespace sm90;

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
  return tc_gemm::launch<true>(g, w, x, out, n, u, l, q, tc_gemm::Store{},
                              stream);
}

// g: (u, l), w: (l,), x: (l, q), out: (u, q); float32, contiguous, on the
// device of `stream`.  Returns the launch's cudaError_t.
extern "C" int parity_encode_f32(const float* g, const float* w,
                                 const float* x, float* out, int u, int l,
                                 int q, cudaStream_t stream) {
  return parity_encode_batched_f32(g, w, x, out, 1, u, l, q, stream);
}
