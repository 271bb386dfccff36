// Float32 matrix product on the Hopper tensor cores in 3xTF32, shared by
// parity_encode.cu (the parity encode, A scaled by diag(w)) and rff_embed.cu
// (the RFF embedding, a cosine at the store).
//
//   C_b[i, j] = epi(j, sum_k A_b[i, k] w_b[k] B_b[k, j])   (SCALE)
//   C_b[i, j] = epi(j, sum_k A_b[i, k] B_b[k, j])          (no scale)
//
//   A_b: (M, K), w_b: (K,), B_b: (K, N), C_b: (M, N), float32, row-major and
//   contiguous, b = blockIdx.z over a batch of such products.
//
// One block of 8 warps per (b, 128-row M tile, 128-column N tile), each
// warp a 32 x 64 part of it as 2 x 8 m16n8k8 tiles (see mma_sm90.cuh for
// 3xTF32).  A and B are staged through a ring of 3 shared-memory buffers of
// 16 K steps each with cp.async (16-byte copies where K and N are multiples
// of 4 and both bases 16-byte aligned, 4-byte copies otherwise; zero-filled
// past the edges, so a ragged M, N or K needs no other mask).  With SCALE,
// w is applied to the A fragments as they leave shared memory, in float32
// (A w rounds as the reference's A * w does), so A diag(w) is never written
// out; without it A goes to the split as it is, with no multiply.  The
// tensor cores' float32 sums round toward zero: every 16 K steps of 8 each
// thread adds them into float32 registers with an ordinary add.  Each
// output's sum runs in an order that depends only on its row, its column
// and the inputs, never on the batch or the grid, so reruns give the same
// bits.  epi(j, v) maps each finished float32 value of column j as it is
// stored.
#pragma once

#include <cstdint>

#include "mma_sm90.cuh"

namespace tc_gemm {

using namespace sm90;

constexpr int THREADS = 256;
constexpr int BM = 128;           // rows of M per block
constexpr int BN = 128;           // columns of N per block
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

// the plain store: C = the product
struct Store {
  __device__ __forceinline__ float operator()(int, float v) const {
    return v;
  }
};

// C_b = epi(A_b [diag(w_b)] B_b) over a (BM, BN) tile; VEC: K % 4 == 0,
// N % 4 == 0 and 16-byte aligned bases of A and B (16-byte copies)
template <bool VEC, bool SCALE, class Epi>
__global__ void __launch_bounds__(THREADS)
tc_gemm_kernel(const float* __restrict__ A, const float* __restrict__ w,
               const float* __restrict__ B, float* __restrict__ C, int M,
               int K, int N, Epi epi) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                          // [STAGES][BM][A_LD]
  float* Bs = smem + STAGES * BM * A_LD;     // [STAGES][BK][B_LD]
  const long long b = blockIdx.z;
  A += b * M * (long long)K;
  if (SCALE) w += b * K;
  B += b * K * (long long)N;
  C += b * M * (long long)N;
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
                   ok ? A + (long long)(row0 + r) * K + k0 + kc : A, ok);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {           // 16 rows x 32 chunks of 4
        const int e = t + u * THREADS;
        const int kk = e / 32;
        const int j = (e % 32) * 4;
        const bool ok = k0 + kk < K && col0 + j < N;
        cp_async16(bs + kk * B_LD + j,
                   ok ? B + (long long)(k0 + kk) * N + col0 + j : B, ok);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = t + u * THREADS;
        const int r = e / BK;
        const int kk = e % BK;
        const bool ok = row0 + r < M && k0 + kk < K;
        cp_async4(as + r * A_LD + kk,
                  ok ? A + (long long)(row0 + r) * K + k0 + kk : A, ok);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = t + u * THREADS;
        const int kk = e / BN;
        const int j = e % BN;
        const bool ok = k0 + kk < K && col0 + j < N;
        cp_async4(bs + kk * B_LD + j,
                  ok ? B + (long long)(k0 + kk) * N + col0 + j : B, ok);
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
      float w0 = 1.0f;
      float w1 = 1.0f;
      if (SCALE) {
        const int k = kt * BK + ks * 8 + t4;
        w0 = k < K ? __ldg(w + k) : 0.0f;
        w1 = k + 4 < K ? __ldg(w + k + 4) : 0.0f;
      }
      unsigned a_big[2][4];
      unsigned a_small[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        unsigned raw[4];
        ldmatrix_x4(raw, as + (wm * 32 + mi * 16 + lane % 16) * A_LD +
                             ks * 8 + (lane / 16) * 4);
        // fragments (g, t4), (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4):
        // A diag(w), rounded to float32 before the split
        if (SCALE) {
          raw[0] = __float_as_uint(__uint_as_float(raw[0]) * w0);
          raw[1] = __float_as_uint(__uint_as_float(raw[1]) * w0);
          raw[2] = __float_as_uint(__uint_as_float(raw[2]) * w1);
          raw[3] = __float_as_uint(__uint_as_float(raw[3]) * w1);
        }
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
      float* crow = C + (long long)r * N;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int j = col0 + wn * 64 + ni * 8 + 2 * t4;
        if (j >= N) continue;
        const float v0 = epi(j, tot[mi][ni][2 * h] + acc[mi][ni][2 * h]);
        if (j + 1 >= N) {
          crow[j] = v0;
          continue;
        }
        const float v1 =
            epi(j + 1, tot[mi][ni][2 * h + 1] + acc[mi][ni][2 * h + 1]);
        if (pairs) {
          *reinterpret_cast<float2*>(crow + j) = make_float2(v0, v1);
        } else {
          crow[j] = v0;
          crow[j + 1] = v1;
        }
      }
    }
  }
}

template <bool VEC, bool SCALE, class Epi>
int launch_tile(const float* a, const float* w, const float* b, float* c,
                int batch, int M, int K, int N, Epi epi,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tc_gemm_kernel<VEC, SCALE, Epi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  tc_gemm_kernel<VEC, SCALE, Epi><<<grid, THREADS, SMEM_BYTES, stream>>>(
      a, w, b, c, M, K, N, epi);
  return static_cast<int>(cudaGetLastError());
}

// Launch C_b = epi(A_b [diag(w_b)] B_b) for b < batch on `stream` (w is
// read only with SCALE); returns the launch's cudaError_t.
template <bool SCALE, class Epi>
int launch(const float* a, const float* w, const float* b, float* c,
           int batch, int M, int K, int N, Epi epi, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  if (K % 4 == 0 && N % 4 == 0 && aligned(a) && aligned(b))
    return launch_tile<true, SCALE>(a, w, b, c, batch, M, K, N, epi, stream);
  return launch_tile<false, SCALE>(a, w, b, c, batch, M, K, N, epi, stream);
}

}  // namespace tc_gemm
