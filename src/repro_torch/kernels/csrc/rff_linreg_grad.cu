// Fused RFF embedding -> per-client masked linear-regression gradients
// (paper eq. 18 and eq. 7/10/28) on Hopper.
//
//   phi_b = sqrt(2/q_true) cos(X_b Omega + delta)     b <  n_real (raw rows)
//   phi_b = pphi                                       b >= n_real (parity)
//   g_b   = phi_b^T diag(mask_b) (phi_b theta - Y_b)
//
//   X: (n_real, L, d), Omega: (d, q), delta: (q,), theta: (q, c),
//   Y: (rows, L, c), mask: (rows, L) float32, pphi: (L, q) or nullptr
//   -> g: (rows, q, c) float32, with R: (rows, L, c) float32 scratch.
//
// X, Omega, delta, theta, Y and pphi are all float or all __nv_bfloat16
// (two entry points); every product and sum is float32, and so are the
// mask (the parity row's 1/u scale would lose bits in bf16) and g.
//
// Replaces the Pallas TPU kernel `rff_linreg_grad_masked` in
// src/repro/kernels/rff_linreg_grad.py.  There Omega (d, q) and theta stay
// resident in VMEM for the whole grid; a (bm, q) row block of phi is
// embedded into scratch at j == 0 and phi^T R accumulates into an output
// block that the sequential grid revisits.  On Hopper Omega alone (6.3 MB
// at d = 784, q = 2000) is far beyond a block's 227 KB, blocks run in no
// order, and phi must not go to device memory.  So two passes, each
// embedding phi tile by tile in shared memory:
//
//   residual_kernel: one block per (client, 64-row L tile, 16-wide c chunk)
//     walks q in 64-column tiles.  Each tile of phi is the tiled float32
//     product of tiled_gemm.cuh (Omega streamed over d in steps of 16), the
//     cosine is taken in registers, the tile is parked in shared memory and
//     contracted with the matching 64 rows of theta.  At the end it writes
//     R = mask (phi theta - Y).
//   gradient_kernel: one block per (client, 64-column q tile, c chunk)
//     walks all L rows in 64-row tiles, embeds phi[rows, q tile] again and
//     accumulates phi^T R in registers; it writes its (64, c chunk) of g.
//
// Each phi tile is the same FFMA chain and epilogue as rff_embed.cu, so phi
// has the same bits as that kernel's output.  No atomics: every sum runs in
// a fixed order, so reruns give the same bits.  Rows with mask 0 are not
// skipped: a NaN in a masked row propagates, as in the reference.
//
// Bound on the H100: operations.  At the main-path shape (31 rows, 30 of
// them raw, L = 2400, d = 784, q = 2000, c = 10) the embedding is
// 2*30*2400*784*2000 = 226 GFLOP and the gradient 6 GFLOP, against 250 MB
// of inputs: 3.46 ms at 67 TFLOP/s (float32, no tensor cores).  This design
// does the embedding twice (452 GFLOP), in FFMA; 5/6 of the rows it embeds
// there are zero-mask padding (L = max(l_max, u) = 2400, l = 400).
#include <cmath>

#include "tiled_gemm.cuh"

namespace {

using tiled::BM;
using tiled::BN;
using tiled::COLS_T;
using tiled::ROWS_T;
using tiled::THREADS;
using tiled::TM;
using tiled::TN;
using tiled::to_float;

constexpr int CMAX = 16;                 // label columns per pass
constexpr int PER_T = 4;                 // R / g sums per thread
constexpr int T_PER_ROW = CMAX / PER_T;  // threads sharing one row of sums
static_assert(BM == BN, "one shared side tile serves both passes");
static_assert(THREADS * PER_T == BM * CMAX, "one sum set per thread");

struct Shared {
  tiled::Smem gemm;
  float phi[BM][BN + 1];   // +1: the column reads of a warp hit 8 banks
  float side[BN][CMAX];    // theta rows (residual) or R rows (gradient)
};

// phi[i][j] for rows row0 + i of client b and columns col0 + j: embedded
// for b < n_real, read from pphi otherwise; 0 past L or q.  Every thread
// calls it; the tile is complete after the caller's next __syncthreads().
template <class T>
__device__ __forceinline__ void phi_tile(
    const T* __restrict__ x, const T* __restrict__ omega,
    const T* __restrict__ delta, const T* __restrict__ pphi, int b,
    int n_real, int L, int d, int q, int row0, int col0, float scale,
    Shared& sm) {
  if (b < n_real) {
    float acc[TM][TN];
    tiled::tile_product<T>(x + (long long)b * L * d, nullptr, omega, L, q, d,
                           row0, col0, sm.gemm, acc);
    const int tr = threadIdx.x / COLS_T;
    const int tc = threadIdx.x % COLS_T;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int i = tr + r * ROWS_T;
        const int j = tc + c * COLS_T;
        const int gj = col0 + j;
        sm.phi[i][j] = (row0 + i < L && gj < q)
                           ? scale * cosf(acc[r][c] + to_float(delta[gj]))
                           : 0.0f;
      }
    }
  } else {
    for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
      const int i = e / BN;
      const int j = e % BN;
      const int gi = row0 + i;
      const int gj = col0 + j;
      sm.phi[i][j] =
          (gi < L && gj < q) ? to_float(pphi[(long long)gi * q + gj]) : 0.0f;
    }
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS)
residual_kernel(const T* __restrict__ x, const T* __restrict__ omega,
                const T* __restrict__ delta, const T* __restrict__ theta,
                const T* __restrict__ y, const float* __restrict__ mask,
                const T* __restrict__ pphi, float* __restrict__ r, int n_real,
                int L, int d, int q, int c, float scale) {
  __shared__ Shared sm;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * CMAX;
  const int cw = min(CMAX, c - c0);
  const int i = threadIdx.x / T_PER_ROW;           // row of R summed here
  const int cg = (threadIdx.x % T_PER_ROW) * PER_T;

  float acc[PER_T];
#pragma unroll
  for (int k = 0; k < PER_T; ++k) acc[k] = 0.0f;
  for (int col0 = 0; col0 < q; col0 += BN) {
    phi_tile<T>(x, omega, delta, pphi, b, n_real, L, d, q, row0, col0, scale,
                sm);
    for (int e = threadIdx.x; e < BN * CMAX; e += THREADS) {
      const int j = e / CMAX;
      const int cc = e % CMAX;
      const int gj = col0 + j;
      sm.side[j][cc] = (gj < q && cc < cw)
                           ? to_float(theta[(long long)gj * c + c0 + cc])
                           : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < BN; ++j) {
      const float p = sm.phi[i][j];
#pragma unroll
      for (int k = 0; k < PER_T; ++k)
        acc[k] = fmaf(p, sm.side[j][cg + k], acc[k]);
    }
    __syncthreads();
  }
  const int gi = row0 + i;
  if (gi < L) {
    const long long row = (long long)b * L + gi;
    const float w = mask[row];
#pragma unroll
    for (int k = 0; k < PER_T; ++k) {
      const int cc = cg + k;
      if (cc < cw) {
        const long long o = row * c + c0 + cc;
        r[o] = (acc[k] - to_float(y[o])) * w;
      }
    }
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS)
gradient_kernel(const T* __restrict__ x, const T* __restrict__ omega,
                const T* __restrict__ delta, const T* __restrict__ pphi,
                const float* __restrict__ r, float* __restrict__ g,
                int n_real, int L, int d, int q, int c, float scale) {
  __shared__ Shared sm;
  const int b = blockIdx.z;
  const int col0 = blockIdx.x * BN;
  const int c0 = blockIdx.y * CMAX;
  const int cw = min(CMAX, c - c0);
  const int j = threadIdx.x / T_PER_ROW;           // column of phi summed here
  const int cg = (threadIdx.x % T_PER_ROW) * PER_T;
  const float* rb = r + (long long)b * L * c;

  float acc[PER_T];
#pragma unroll
  for (int k = 0; k < PER_T; ++k) acc[k] = 0.0f;
  for (int row0 = 0; row0 < L; row0 += BM) {
    phi_tile<T>(x, omega, delta, pphi, b, n_real, L, d, q, row0, col0, scale,
                sm);
    for (int e = threadIdx.x; e < BM * CMAX; e += THREADS) {
      const int kk = e / CMAX;
      const int cc = e % CMAX;
      const int gk = row0 + kk;
      sm.side[kk][cc] =
          (gk < L && cc < cw) ? rb[(long long)gk * c + c0 + cc] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BM; ++kk) {
      const float p = sm.phi[kk][j];
#pragma unroll
      for (int k = 0; k < PER_T; ++k)
        acc[k] = fmaf(p, sm.side[kk][cg + k], acc[k]);
    }
    __syncthreads();
  }
  const int gj = col0 + j;
  if (gj < q) {
    float* gr = g + ((long long)b * q + gj) * c + c0;
#pragma unroll
    for (int k = 0; k < PER_T; ++k)
      if (cg + k < cw) gr[cg + k] = acc[k];
  }
}

template <class T>
int launch(const T* x, const T* omega, const T* delta, const T* theta,
           const T* y, const float* mask, const T* pphi, float* r, float* g,
           int rows, int n_real, int L, int d, int q, int c, int q_true,
           cudaStream_t stream) {
  const float scale = static_cast<float>(std::sqrt(2.0 / q_true));
  const int c_chunks = (c + CMAX - 1) / CMAX;
  const dim3 res_grid((L + BM - 1) / BM, c_chunks, rows);
  residual_kernel<T><<<res_grid, THREADS, 0, stream>>>(
      x, omega, delta, theta, y, mask, pphi, r, n_real, L, d, q, c, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grad_grid((q + BN - 1) / BN, c_chunks, rows);
  gradient_kernel<T><<<grad_grid, THREADS, 0, stream>>>(
      x, omega, delta, pphi, r, g, n_real, L, d, q, c, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n_real, L, d), omega: (d, q), delta: (q,), theta: (q, c),
// y: (rows, L, c), mask: (rows, L) float32, pphi: (L, q) or nullptr (then
// rows == n_real), r: (rows, L, c) float32 scratch, g: (rows, q, c)
// float32; contiguous, on the device of `stream`.  Returns the first
// failing launch's cudaError_t.
extern "C" int rff_linreg_grad_masked_f32(
    const float* x, const float* omega, const float* delta,
    const float* theta, const float* y, const float* mask, const float* pphi,
    float* r, float* g, int rows, int n_real, int L, int d, int q, int c,
    int q_true, cudaStream_t stream) {
  return launch(x, omega, delta, theta, y, mask, pphi, r, g, rows, n_real, L,
                d, q, c, q_true, stream);
}

// The same with bfloat16 x, omega, delta, theta, y and pphi.
extern "C" int rff_linreg_grad_masked_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* omega,
    const __nv_bfloat16* delta, const __nv_bfloat16* theta,
    const __nv_bfloat16* y, const float* mask, const __nv_bfloat16* pphi,
    float* r, float* g, int rows, int n_real, int L, int d, int q, int c,
    int q_true, cudaStream_t stream) {
  return launch(x, omega, delta, theta, y, mask, pphi, r, g, rows, n_real, L,
                d, q, c, q_true, stream);
}
