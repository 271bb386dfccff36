// Batched float32 GEMM tile shared by rff_embed.cu and parity_encode.cu.
//
//   C_b[i, j] = epi(j, sum_k A_b[i, k] * s_b[k] * B_b[k, j])
//
// A_b: (M, K), B_b: (K, N), C_b: (M, N), all row-major and contiguous; s_b:
// (K,) per-column scale of A (nullptr: no scale); b = blockIdx.z.  One block
// of 256 threads computes a 64 x 64 tile of C, looping over K in steps of 16
// through shared memory.  Each thread owns a 4 x 4 set of outputs spread
// 16 rows / 16 columns apart, so the shared-memory reads of a warp are
// either broadcasts (A) or 16 distinct consecutive banks (B), and the
// stores of C are coalesced along a row.  Ragged edges are masked: loads
// past M, N or K read 0, stores past M or N are skipped.
//
// Plain float32 FFMA, no tensor cores and no TF32: the reference computes
// in float32.  Each output is a sum over k in ascending order, so a rerun
// gives the same bits.
#pragma once

#include <cuda_runtime.h>

namespace tiled {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int ROWS_T = BM / TM;          // 16 thread rows
constexpr int COLS_T = BN / TN;          // 16 thread columns
constexpr int THREADS = ROWS_T * COLS_T;  // 256

template <class Epilogue>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const float* __restrict__ A, const float* __restrict__ s,
            const float* __restrict__ B, float* __restrict__ C,
            int M, int N, int K, long long stride_a, long long stride_s,
            long long stride_b, long long stride_c, Epilogue epi) {
  // A tile stored transposed (As[k][i]); the +4 pad spreads the column
  // stores of one warp over the banks
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];

  const long long b = blockIdx.z;
  A += b * stride_a;
  B += b * stride_b;
  C += b * stride_c;
  if (s != nullptr) s += b * stride_s;

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tr = tid / COLS_T;
  const int tc = tid % COLS_T;

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: 16 neighbouring threads read 16 neighbouring k of one row
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int i = e / BK;
      const int kk = e % BK;
      const int gi = row0 + i;
      const int gk = k0 + kk;
      float v = 0.0f;
      if (gi < M && gk < K) {
        v = A[(long long)gi * K + gk];
        if (s != nullptr) v *= s[gk];
      }
      As[kk][i] = v;
    }
    // B tile: 64 neighbouring threads read one row segment
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN;
      const int j = e % BN;
      const int gk = k0 + kk;
      const int gj = col0 + j;
      Bs[kk][j] = (gk < K && gj < N) ? B[(long long)gk * N + gj] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float bv[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = As[kk][tr + r * ROWS_T];
#pragma unroll
      for (int c = 0; c < TN; ++c) bv[c] = Bs[kk][tc + c * COLS_T];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gi = row0 + tr + r * ROWS_T;
    if (gi >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gj = col0 + tc + c * COLS_T;
      if (gj < N) C[(long long)gi * N + gj] = epi(gj, acc[r][c]);
    }
  }
}

// Launch one batch of `batch` products on `stream`; returns the launch's
// cudaError_t (0 on success).
template <class Epilogue>
int launch_gemm(const float* A, const float* s, const float* B, float* C,
                int batch, int M, int N, int K, long long stride_a,
                long long stride_s, long long stride_b, long long stride_c,
                Epilogue epi, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  gemm_kernel<Epilogue><<<grid, THREADS, 0, stream>>>(
      A, s, B, C, M, N, K, stride_a, stride_s, stride_b, stride_c, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tiled
