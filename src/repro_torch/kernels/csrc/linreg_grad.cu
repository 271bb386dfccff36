// Per-client row-masked linear-regression gradients (paper eq. 7/10/28).
//
//   g_b = X_b^T diag(mask_b) (X_b theta - Y_b)
//   X: (n, L, q), theta: (q, c), Y: (n, L, c), mask: (n, L) -> g: (n, q, c)
//
// A null mask weighs every row 1 (`linreg_grad_batched`, no tensor of ones
// is made), and `linreg_grad_f32` is the single-matrix gradient
// g = X^T (X theta - Y) as n = 1 with a null mask.
//
// Replaces the Pallas TPU kernels `linreg_grad_masked` and `linreg_grad`
// in src/repro/kernels/linreg_grad.py.  There the residual of a row block is
// formed once (at j == 0) and X_blk^T R is accumulated into an output block
// that the sequential TPU grid revisits.  Hopper runs blocks in parallel and
// in no order, so nothing can carry from one block to the next; the work is
// split into two launches instead:
//
//   residual_kernel: R[b, k, :] = mask[b, k] * (X[b, k, :] theta - Y[b, k, :])
//                    one warp per row of X, lanes striding over q, then a
//                    butterfly shuffle reduction of the c partial sums.
//   xtr_kernel:      g[b, i, :] = sum_k X[b, k, i] R[b, k, :]
//                    one block per (client, 128-column q tile, 16-wide c
//                    chunk); each thread owns one column i of X and walks
//                    all L rows, with R staged in shared memory.
//
// No atomics: every sum runs in a fixed order inside one thread or one
// warp, so reruns (and resumed runs) give the same bits.
//
// Bound on the H100: bytes.  At the main-path shape (31, 2400, 2000) with
// c = 10, X alone is 595 MB and the work is 4*n*L*q*c = 6 GFLOP (about
// 10 FLOP per byte, below the float32 ridge of 20): the least time is one
// read of X at 3.35 TB/s, about 178 us.  This design reads X twice, as the
// TPU kernel does; the two reads are each coalesced (a warp reads 128
// consecutive bytes of a row).  theta is passed transposed, (c, q), so the
// lanes of the residual warp read it at consecutive addresses too.
#include <cuda_runtime.h>

namespace {

constexpr int CMAX = 16;           // label columns per pass (c chunks of 16)
constexpr int RES_WARPS = 8;       // rows per residual block
constexpr int XTR_THREADS = 128;   // q columns per xtr block
constexpr int XTR_ROWS = 64;       // rows of R staged per shared-memory tile

__global__ void __launch_bounds__(RES_WARPS * 32)
residual_kernel(const float* __restrict__ x, const float* __restrict__ theta_t,
                const float* __restrict__ y, const float* __restrict__ mask,
                float* __restrict__ r, long long rows, int q, int c) {
  const int lane = threadIdx.x % 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * RES_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int c0 = blockIdx.y * CMAX;
  const int cw = min(CMAX, c - c0);
  const float* xr = x + row * q;

  float acc[CMAX];
#pragma unroll
  for (int cc = 0; cc < CMAX; ++cc) acc[cc] = 0.0f;
#pragma unroll 4
  for (int i = lane; i < q; i += 32) {
    const float xv = xr[i];
#pragma unroll
    for (int cc = 0; cc < CMAX; ++cc)
      if (cc < cw) acc[cc] = fmaf(xv, theta_t[(long long)(c0 + cc) * q + i],
                                  acc[cc]);
  }
#pragma unroll
  for (int cc = 0; cc < CMAX; ++cc) {
    float v = acc[cc];
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    acc[cc] = v;
  }
  if (lane < cw) {
    // static indexing into acc keeps it in registers
    float v = 0.0f;
#pragma unroll
    for (int cc = 0; cc < CMAX; ++cc)
      if (cc == lane) v = acc[cc];
    const long long o = row * c + c0 + lane;
    r[o] = (v - y[o]) * (mask != nullptr ? mask[row] : 1.0f);
  }
}

__global__ void __launch_bounds__(XTR_THREADS)
xtr_kernel(const float* __restrict__ x, const float* __restrict__ r,
           float* __restrict__ g, int L, int q, int c) {
  __shared__ float rs[XTR_ROWS][CMAX];
  const long long b = blockIdx.z;
  const int i = blockIdx.x * XTR_THREADS + threadIdx.x;
  const int c0 = blockIdx.y * CMAX;
  const int cw = min(CMAX, c - c0);
  const float* xb = x + b * L * q;
  const float* rb = r + b * L * c;

  float acc[CMAX];
#pragma unroll
  for (int cc = 0; cc < CMAX; ++cc) acc[cc] = 0.0f;
  for (int k0 = 0; k0 < L; k0 += XTR_ROWS) {
    const int kn = min(XTR_ROWS, L - k0);
    for (int e = threadIdx.x; e < XTR_ROWS * CMAX; e += XTR_THREADS) {
      const int kk = e / CMAX;
      const int cc = e % CMAX;
      rs[kk][cc] = (kk < kn && cc < cw)
                       ? rb[(long long)(k0 + kk) * c + c0 + cc] : 0.0f;
    }
    __syncthreads();
    if (i < q) {
#pragma unroll 8
      for (int kk = 0; kk < kn; ++kk) {
        const float xv = xb[(long long)(k0 + kk) * q + i];
#pragma unroll
        for (int cc = 0; cc < CMAX; ++cc) acc[cc] = fmaf(xv, rs[kk][cc], acc[cc]);
      }
    }
    __syncthreads();
  }
  if (i < q) {
    float* gi = g + (b * q + i) * c + c0;
#pragma unroll
    for (int cc = 0; cc < CMAX; ++cc)
      if (cc < cw) gi[cc] = acc[cc];
  }
}

}  // namespace

// x: (n, L, q), theta_t: (c, q) (theta transposed), y: (n, L, c),
// mask: (n, L) or nullptr (every row weighs 1), r: (n, L, c) scratch,
// g: (n, q, c); float32, contiguous, on the device of `stream`.  Returns the
// first failing launch's cudaError_t.
extern "C" int linreg_grad_masked_f32(const float* x, const float* theta_t,
                                      const float* y, const float* mask,
                                      float* r, float* g, int n, int L, int q,
                                      int c, cudaStream_t stream) {
  const int c_chunks = (c + CMAX - 1) / CMAX;
  const long long rows = static_cast<long long>(n) * L;
  const dim3 res_grid(static_cast<unsigned>((rows + RES_WARPS - 1) / RES_WARPS),
                      c_chunks);
  residual_kernel<<<res_grid, RES_WARPS * 32, 0, stream>>>(
      x, theta_t, y, mask, r, rows, q, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 xtr_grid((q + XTR_THREADS - 1) / XTR_THREADS, c_chunks, n);
  xtr_kernel<<<xtr_grid, XTR_THREADS, 0, stream>>>(x, r, g, L, q, c);
  return static_cast<int>(cudaGetLastError());
}

// g = x^T (x theta - y): x: (m, q), theta_t: (c, q), y: (m, c), r: (m, c)
// scratch, g: (q, c).  At the parity set's shape (2400, 2000), c = 10, the
// xtr pass has only 16 blocks (one per 128-column q tile): a first kernel
// that is right; splitting L over more blocks is later work.
extern "C" int linreg_grad_f32(const float* x, const float* theta_t,
                               const float* y, float* r, float* g, int m,
                               int q, int c, cudaStream_t stream) {
  return linreg_grad_masked_f32(x, theta_t, y, nullptr, r, g, 1, m, q, c,
                                stream);
}
