// Per-client row-masked linear-regression gradients (paper eq. 7/10/28).
//
//   g_b = X_b^T diag(mask_b) (X_b theta - Y_b)
//   X: (n, L, q), theta: (q, c), Y: (n, L, c), mask: (n, L) -> g: (n, q, c)
//
// A null mask weighs every row 1 (`linreg_grad_batched`, no tensor of ones
// is made).  `linreg_grad_f32` is the single-matrix gradient
// g = X^T (X theta - Y), with launches of its own (below).
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
//
// `linreg_grad_f32`, the single-matrix gradient (the TPU kernel
// `linreg_grad`), has launches of its own.  Its shapes are the parity set
// (2400, 2000) and one legacy client (l_j <= 400, 2000): one block per
// 128-column q tile would be 16 blocks on 132 SMs, each thread walking
// every row with one dependent load at a time.  So its X^T r pass also
// splits L: a grid of (q tiles x L splits x c chunks), the split count
// chosen by the wrapper (ops.linreg_grad_splits) to fill the card, each
// block writing a (q tile, c) partial over its rows, and a short combine
// launch sums the partials in split order.  Its residual pass is split over
// 512-column chunks of q as well: each block stages its chunk of theta in
// shared memory once and reads it there for 4 rows a warp (one warp per
// row would read all of theta, 80 KB, for every row of X), and writes
// partial residuals that the X^T r pass sums as it stages R.  X is read
// with 16-byte loads where q is a multiple of 4.  Its bound is the
// same single read of X: 19.2 MB, 5.8 us at (2400, 2000).
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

// Partial residuals p[ch, k, :] = x[k, chunk ch] theta[chunk ch, :] over
// LG_QB-column chunks of q, LG_ROWS_W rows a warp: a block stages its chunk
// of theta (q, c) once in shared memory as ths[cc][i] (16-byte loads of the
// contiguous rows) and every warp reads it from there for LG_ROWS_W rows;
// X is read with 16-byte loads where q % 4 == 0.  The X^T r pass sums the
// chunks in order and subtracts y as it stages R.
constexpr int LG_WARPS = 8;        // warps per residual block
constexpr int LG_ROWS_W = 4;       // rows per warp
constexpr int LG_QB = 512;         // columns of q per block

template <bool VEC>
__global__ void __launch_bounds__(LG_WARPS * 32)
lg_residual_kernel(const float* __restrict__ x,
                   const float* __restrict__ theta, float* __restrict__ p,
                   int m, int q, int c) {
  __shared__ __align__(16) float ths[CMAX][LG_QB];
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * LG_WARPS + threadIdx.x / 32) * LG_ROWS_W;
  const int i0 = blockIdx.y * LG_QB;
  const int qb = min(LG_QB, q - i0);
  const int c0 = blockIdx.z * CMAX;
  const int cw = min(CMAX, c - c0);

  // theta rows i0 .. i0 + qb are contiguous; q % 4 == 0 keeps the chunk's
  // start 16-byte aligned and its length a multiple of 4
  const float* tb = theta + (long long)i0 * c;
  const int n = qb * c;
  if (VEC) {
    for (int f0 = threadIdx.x; f0 < n / 4; f0 += 4 * LG_WARPS * 32) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = f0 + u * LG_WARPS * 32;
        v[u] = f < n / 4 ? reinterpret_cast<const float4*>(tb)[f]
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = f0 + u * LG_WARPS * 32;
        const float w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int e = 4 * f + h;
          const int cc = e % c - c0;
          if (f < n / 4 && cc >= 0 && cc < cw) ths[cc][e / c] = w[h];
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < n; e += LG_WARPS * 32) {
      const int cc = e % c - c0;
      if (cc >= 0 && cc < cw) ths[cc][e / c] = tb[e];
    }
  }
  __syncthreads();

  float acc[LG_ROWS_W][CMAX];
#pragma unroll
  for (int k = 0; k < LG_ROWS_W; ++k)
#pragma unroll
    for (int cc = 0; cc < CMAX; ++cc) acc[k][cc] = 0.0f;
  if (VEC) {
#pragma unroll 2
    for (int i = 4 * lane; i < qb; i += 4 * 32) {
      float4 xv[LG_ROWS_W];
#pragma unroll
      for (int k = 0; k < LG_ROWS_W; ++k)
        xv[k] = row0 + k < m
                    ? *reinterpret_cast<const float4*>(
                          x + (long long)(row0 + k) * q + i0 + i)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int cc = 0; cc < CMAX; ++cc) {
        if (cc < cw) {
          const float4 tv = *reinterpret_cast<const float4*>(&ths[cc][i]);
#pragma unroll
          for (int k = 0; k < LG_ROWS_W; ++k) {
            acc[k][cc] = fmaf(xv[k].x, tv.x, acc[k][cc]);
            acc[k][cc] = fmaf(xv[k].y, tv.y, acc[k][cc]);
            acc[k][cc] = fmaf(xv[k].z, tv.z, acc[k][cc]);
            acc[k][cc] = fmaf(xv[k].w, tv.w, acc[k][cc]);
          }
        }
      }
    }
  } else {
#pragma unroll 2
    for (int i = lane; i < qb; i += 32) {
      float xv[LG_ROWS_W];
#pragma unroll
      for (int k = 0; k < LG_ROWS_W; ++k)
        xv[k] = row0 + k < m ? x[(long long)(row0 + k) * q + i0 + i] : 0.0f;
#pragma unroll
      for (int cc = 0; cc < CMAX; ++cc) {
        if (cc < cw) {
          const float tv = ths[cc][i];
#pragma unroll
          for (int k = 0; k < LG_ROWS_W; ++k)
            acc[k][cc] = fmaf(xv[k], tv, acc[k][cc]);
        }
      }
    }
  }
  float* pb = p + (long long)blockIdx.y * m * c;
#pragma unroll
  for (int k = 0; k < LG_ROWS_W; ++k) {
    float mine = 0.0f;
#pragma unroll
    for (int cc = 0; cc < CMAX; ++cc) {
      float v = acc[k][cc];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (cc == lane) mine = v;
    }
    if (lane < cw && row0 + k < m)
      pb[(long long)(row0 + k) * c + c0 + lane] = mine;
  }
}

// part[s, i, :] = sum over rows k of split s of X[k, i] R[k, :], with
// R[k, :] = sum over the q chunks ch of p[ch, k, :] (in order) - y[k, :]
// staged 64 rows at a time; each thread owns column i and keeps 16 rows of
// X loads in flight
constexpr int XTR_BATCH = 16;

__global__ void __launch_bounds__(XTR_THREADS)
lg_xtr_split_kernel(const float* __restrict__ x, const float* __restrict__ p,
                    const float* __restrict__ y, float* __restrict__ part,
                    int m, int q, int c, int chunks, int rows_per_split) {
  __shared__ __align__(16) float rs[XTR_ROWS][CMAX];
  const int i = blockIdx.x * XTR_THREADS + threadIdx.x;
  const int split = blockIdx.y;
  const int c0 = blockIdx.z * CMAX;
  const int cw = min(CMAX, c - c0);
  const int k_begin = split * rows_per_split;
  const int k_end = min(m, k_begin + rows_per_split);
  const long long mc = (long long)m * c;

  float acc[CMAX];
#pragma unroll
  for (int cc = 0; cc < CMAX; ++cc) acc[cc] = 0.0f;
  for (int k0 = k_begin; k0 < k_end; k0 += XTR_ROWS) {
    const int kn = min(XTR_ROWS, k_end - k0);
    {   // the 8 elements of R a thread stages, their loads in flight together
      constexpr int PER_T = XTR_ROWS * CMAX / XTR_THREADS;
      float v[PER_T];
      long long o[PER_T];
      bool ok[PER_T];
#pragma unroll
      for (int u = 0; u < PER_T; ++u) {
        const int e = threadIdx.x + u * XTR_THREADS;
        ok[u] = e / CMAX < kn && e % CMAX < cw;
        o[u] = (long long)(k0 + e / CMAX) * c + c0 + e % CMAX;
        v[u] = ok[u] ? p[o[u]] : 0.0f;
      }
      for (int ch = 1; ch < chunks; ++ch)
#pragma unroll
        for (int u = 0; u < PER_T; ++u)
          if (ok[u]) v[u] += p[ch * mc + o[u]];
#pragma unroll
      for (int u = 0; u < PER_T; ++u) {
        const int e = threadIdx.x + u * XTR_THREADS;
        rs[e / CMAX][e % CMAX] = ok[u] ? v[u] - y[o[u]] : 0.0f;
      }
    }
    __syncthreads();
    if (i < q) {
      for (int kk = 0; kk < kn; kk += XTR_BATCH) {
        float xv[XTR_BATCH];
#pragma unroll
        for (int u = 0; u < XTR_BATCH; ++u)
          xv[u] = kk + u < kn ? x[(long long)(k0 + kk + u) * q + i] : 0.0f;
#pragma unroll
        for (int u = 0; u < XTR_BATCH; ++u) {
          const float4* rk = reinterpret_cast<const float4*>(rs[kk + u]);
#pragma unroll
          for (int v4 = 0; v4 < CMAX / 4; ++v4) {
            const float4 w = rk[v4];
            acc[4 * v4 + 0] = fmaf(xv[u], w.x, acc[4 * v4 + 0]);
            acc[4 * v4 + 1] = fmaf(xv[u], w.y, acc[4 * v4 + 1]);
            acc[4 * v4 + 2] = fmaf(xv[u], w.z, acc[4 * v4 + 2]);
            acc[4 * v4 + 3] = fmaf(xv[u], w.w, acc[4 * v4 + 3]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (i < q) {
    float* pi = part + ((long long)split * q + i) * c + c0;
#pragma unroll
    for (int cc = 0; cc < CMAX; ++cc)
      if (cc < cw) pi[cc] = acc[cc];
  }
}

// g[e] = sum over s of part[s, e] in order s = 0 .. splits-1
__global__ void lg_combine_kernel(const float* __restrict__ part,
                                  float* __restrict__ g, int qc, int splits) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= qc) return;
  float v = part[e];
  for (int s = 1; s < splits; ++s) v += part[(long long)s * qc + e];
  g[e] = v;
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

// g = x^T (x theta - y): x: (m, q), theta: (q, c), y: (m, c),
// p: (ceil(q / 512), m, c) scratch (the partial residuals), part:
// (splits, q, c) scratch (nullptr when splits == 1), g: (q, c).  Returns
// the first failing launch's cudaError_t.
extern "C" int linreg_grad_f32(const float* x, const float* theta,
                               const float* y, float* p, float* part,
                               float* g, int m, int q, int c, int splits,
                               cudaStream_t stream) {
  if (splits < 1 || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int c_chunks = (c + CMAX - 1) / CMAX;
  const int chunks = (q + LG_QB - 1) / LG_QB;
  constexpr int rows_per_block = LG_WARPS * LG_ROWS_W;
  const dim3 res_grid((m + rows_per_block - 1) / rows_per_block, chunks,
                      c_chunks);
  const bool vec = q % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(theta) % 16 == 0;
  if (vec)
    lg_residual_kernel<true><<<res_grid, LG_WARPS * 32, 0, stream>>>(
        x, theta, p, m, q, c);
  else
    lg_residual_kernel<false><<<res_grid, LG_WARPS * 32, 0, stream>>>(
        x, theta, p, m, q, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_split = (m + splits - 1) / splits;
  const dim3 xtr_grid((q + XTR_THREADS - 1) / XTR_THREADS, splits, c_chunks);
  lg_xtr_split_kernel<<<xtr_grid, XTR_THREADS, 0, stream>>>(
      x, p, y, splits == 1 ? g : part, m, q, c, chunks, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int qc = q * c;
  lg_combine_kernel<<<(qc + 255) / 256, 256, 0, stream>>>(part, g, qc,
                                                          splits);
  return static_cast<int>(cudaGetLastError());
}
