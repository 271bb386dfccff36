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
// in no order, so nothing can carry from one block to the next.
//
// `linreg_grad_masked_f32` (masked_kernel below) takes only the leading
// live rows of each row b: live_c for b < n - 1 and live_l for the last
// row (the fused coded round's parity pseudo-row), every row by default.
// Bound on the H100: bytes.  At the main-path shape (31, 2400, 2000) with
// c = 10 and live rows (l_max = 400, u = 2400) the live part of X is
// 96 MB of clients and 19.2 MB of parity rows, and the work is
// 4 * 14400 * 2000 * 10 = 1.2 GFLOP (about 10 FLOP per byte, below the
// float32 ridge of 20): the least time is one read of those rows at
// 3.35 TB/s, about 34 us (178 us with every row of L = 2400 live).  The
// design reads each live element of X from HBM once, into a shared-memory
// ring, and both the residual and the X^T R phase read it there; theta is
// staged in shared memory once a block; the live rows of all rows are cut
// into equal chains of 8-row slabs, one block each, so that every SM is
// busy whatever the rows' live counts, and a combine launch sums each
// row's pieces in order.  No atomics: every sum runs in a fixed order
// inside one thread, one warp or one block, so reruns (and resumed runs)
// give the same bits.
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

#include "mma_sm90.cuh"

namespace {

using namespace sm90;

constexpr int CMAX = 16;           // label columns per pass (c chunks of 16)
constexpr int XTR_THREADS = 128;   // q columns per xtr block
constexpr int XTR_ROWS = 64;       // rows of R staged per shared-memory tile

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

// ------------------------------------------------- linreg_grad_masked_f32
// A slab is 8 (or 4) consecutive live rows of a row.  The slabs of all
// rows, in row order, are cut into chains of `chain` slabs, one block of
// MK_THREADS threads per (chain, c chunk, q part), so that the blocks fill
// the card however the live rows are spread over the rows (the coded
// round's parity row has 6x a client's).  A q part is 4 * MK_THREADS * J
// columns (J = 1 up to q = 1024, else 2; NC, the label columns of a pass,
// is c rounded up to even), and the thread owns float4 column groups t,
// t + MK_THREADS, ... of it: in the residual phase and in the gradient
// phase alike, so each element of X is copied from HBM into shared memory
// once (cp.async, a ring of 2 or 3 slabs) and read from there by the same
// thread in both phases.  Per slab:
//   1. partial residuals p[r][cc] = sum over the thread's columns of
//      X[k, i] theta[i, cc], with theta^T of the block's own part staged in
//      shared memory once a block (other parts, where q > 2048, from
//      device memory, their X slabs passing through the ring first);
//   2. p is reduced over the block in a fixed order: a butterfly
//      reduce-scatter inside each warp (each lane ends with a few of the
//      SLAB * NC sums), then the 8 warps' sums in warp order, and every
//      warp writes its own copy of R = mask (p - Y) to shared memory (Y
//      and mask come through the ring with the slab);
//   3. the thread's gradient columns acc[i][cc] += X[k, i] R[k, cc].
// Rows past the live count are zero-filled, never read, and given R = 0.
// Where its chain leaves a row, a block writes its sum for that row as a
// segment of its own, and a combine launch sums each row's segments in
// block order.  No atomics.
constexpr int MK_THREADS = 256;
constexpr int MK_WARPS = MK_THREADS / 32;
constexpr int MK_ROWS = 8;         // rows per slab
constexpr int MK_ROWS_WIDE = 4;    // rows per slab where theta^T and a
                                   // ring of 8-row slabs do not fit
constexpr int MK_MAX_SMEM = 232448;

__host__ __device__ constexpr int mk_chunk(int J) { return 4 * MK_THREADS * J; }

// theta^T, the X ring, the warps' sums, each warp's R, and the Y and mask
// ring
__host__ __device__ constexpr long long mk_smem_bytes(int NC, int J, int rows,
                                                      int stages) {
  return 4LL * (NC * mk_chunk(J) + stages * rows * mk_chunk(J) +
                MK_WARPS * rows * NC + MK_WARPS * rows * CMAX +
                stages * rows * (CMAX + 1));
}

// 8-row slabs in a ring of 2 or 3 where they fit beside theta^T (every
// NC with 1024-column parts, NC <= 10 with 2048), else 4-row slabs (ops.py
// mirrors this rule in masked_slab_rows)
__host__ __device__ constexpr int mk_rows(int NC, int J) {
  return J == 2 && NC > 10 ? MK_ROWS_WIDE : MK_ROWS;
}
__host__ __device__ constexpr int mk_stages(int NC, int J) {
  return mk_smem_bytes(NC, J, mk_rows(NC, J), 3) <= MK_MAX_SMEM ? 3 : 2;
}

struct MaskedArgs {
  const float* x;
  const float* theta_t;   // (c, q)
  const float* y;
  const float* mask;      // nullptr: every row weighs 1
  float* out;             // the partial of every (block, row) segment
  int n, L, q, c, live_c, live_l, chain, parts;
};

// One level of a butterfly reduce-scatter of v[0 .. V) over the 32 lanes
// of a warp, levels xor 16, 8, 4, 2, 1: while the count M of sums a lane
// holds is even, a lane keeps one half (the upper where its bit is set) and
// adds its partner's copy of it; once M is odd, the remaining levels add
// whole sets.  Returns with lane l holding the warp's sums of v[base ..
// base + M_final) in v[0 .. M_final); lanes that differ only in the bits
// of the whole-set levels hold the same sums.
template <int V, int M, int LVL>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int lane,
                                               int& base) {
  if constexpr (LVL < 5) {
    constexpr int off = 16 >> LVL;
    const bool up = (lane & off) != 0;
    if constexpr (M % 2 == 0) {
      constexpr int half = M / 2;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = up ? v[i] : v[i + half];
        const float keep = up ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
      if (up) base += half;
      reduce_scatter<V, half, LVL + 1>(v, lane, base);
    } else {
#pragma unroll
      for (int i = 0; i < M; ++i)
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
      reduce_scatter<V, M, LVL + 1>(v, lane, base);
    }
  }
}

// M_final of reduce_scatter<V, V, 0>
template <int M, int LVL = 0>
__host__ __device__ constexpr int reduce_scatter_count() {
  if constexpr (LVL == 5) {
    return M;
  } else if constexpr (M % 2 == 0) {
    return reduce_scatter_count<M / 2, LVL + 1>();
  } else {
    return reduce_scatter_count<M, LVL + 1>();
  }
}

template <int NC, int J, bool VEC>
__global__ void __launch_bounds__(MK_THREADS, 1)
masked_kernel(MaskedArgs a) {
  constexpr int CHUNK = mk_chunk(J);
  constexpr int SLAB = mk_rows(NC, J);   // rows per slab
  constexpr int V = SLAB * NC;
  constexpr int STAGES = mk_stages(NC, J);
  extern __shared__ __align__(16) float smem[];
  float* ths = smem;                              // [NC][CHUNK] theta^T
  float* ring = ths + NC * CHUNK;                 // [STAGES][SLAB][CHUNK]
  float* red = ring + STAGES * SLAB * CHUNK;  // [WARPS][V]
  float* yring = red + MK_WARPS * V + MK_WARPS * SLAB * CMAX;
                                                  // [STAGES][SLAB][CMAX]
  float* mring = yring + STAGES * SLAB * CMAX;  // [STAGES][SLAB]

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  float* rs = red + MK_WARPS * V + warp * SLAB * CMAX;  // the warp's R,
                                                        // [SLAB][CMAX]
  const int q = a.q;
  const int c = a.c;
  const int c0 = blockIdx.y * CMAX;
  const int cw = min(CMAX, c - c0);
  const int part = blockIdx.z;
  // block x walks slabs [g0, g1) of the list of every row's slabs in row
  // order (slabs_c for each row b < n - 1, slabs_l for the last row)
  const int bx = blockIdx.x;
  const int slabs_c = a.n > 1 ? (a.live_c + SLAB - 1) / SLAB : 0;
  const int slabs_l = (a.live_l + SLAB - 1) / SLAB;
  const int g0 = bx * a.chain;
  const int g1 = min((a.n - 1) * slabs_c + slabs_l, g0 + a.chain);
  const int items = max(0, g1 - g0) * a.parts;
  auto row_of = [&](int g) {
    return g < (a.n - 1) * slabs_c ? g / slabs_c : a.n - 1;
  };

  // theta^T of the own part, zero past q and past the chunk's cw columns,
  // copied asynchronously with the first slab (its commit group)
  const int own0 = part * CHUNK;
  const int own_w = min(CHUNK, q - own0);
  for (int e = t; e < NC * CHUNK / 4; e += MK_THREADS) {
    const int cc = e / (CHUNK / 4);
    const int j = (e % (CHUNK / 4)) * 4;
    const float* src = a.theta_t + (long long)(c0 + cc) * q + own0 + j;
    if (VEC) {
      const bool ok = cc < cw && j < own_w;
      cp_async16(ths + cc * CHUNK + j, ok ? src : a.theta_t, ok);
    } else {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const bool ok = cc < cw && j + h < own_w;
        cp_async4(ths + cc * CHUNK + j + h, ok ? src + h : a.theta_t, ok);
      }
    }
  }

  // item it: slab g0 + it / parts, q part (part + 1 + it % parts) % parts,
  // so that the block's own part comes last
  auto chunk_of = [&](int it) { return (part + 1 + it % a.parts) % a.parts; };
  auto load = [&](int it) {
    float* dst = ring + (it % STAGES) * SLAB * CHUNK;
    const int g = g0 + it / a.parts;
    const int b = row_of(g);
    const int live = b < a.n - 1 ? a.live_c : a.live_l;
    const int k0 = (g - b * slabs_c) * SLAB;
    const float* xb = a.x + (long long)b * a.L * q;
    const int col0 = chunk_of(it) * CHUNK;
    const int w4 = (min(CHUNK, q - col0) + 3) / 4;
    // the slab's labels and mask ride along, so that forming R waits on
    // no load of its own
    if (t < SLAB * CMAX) {
      const int r = t / CMAX;
      const int cc = t % CMAX;
      const bool ok = k0 + r < live && cc < cw;
      cp_async4(yring + (it % STAGES) * SLAB * CMAX + t,
                ok ? a.y + ((long long)b * a.L + k0 + r) * c + c0 + cc : a.y,
                ok);
    } else if (t < SLAB * CMAX + SLAB) {
      const int r = t - SLAB * CMAX;
      const bool ok = k0 + r < live && a.mask != nullptr;
      cp_async4(mring + (it % STAGES) * SLAB + r,
                ok ? a.mask + (long long)b * a.L + k0 + r : a.y, ok);
    }
    for (int e = t; e < SLAB * w4; e += MK_THREADS) {
      const int r = e / w4;
      const int j = (e % w4) * 4;
      const bool row_ok = k0 + r < live;
      const float* src = xb + (long long)(k0 + r) * q + col0 + j;
      if (VEC) {
        cp_async16(dst + r * CHUNK + j, row_ok ? src : a.x, row_ok);
      } else {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const bool ok = row_ok && col0 + j + h < q;
          cp_async4(dst + r * CHUNK + j + h, ok ? src + h : a.x, ok);
        }
      }
    }
  };

  float p[V];
  float acc[J][4][NC];
#pragma unroll
  for (int jj = 0; jj < J; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) acc[jj][e][cc] = 0.0f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < items) load(st);
    cp_async_commit();
  }
  for (int it = 0; it < items; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // item it has landed; item it-1's buffer is free
    if (it + STAGES - 1 < items) load(it + STAGES - 1);
    cp_async_commit();
    const float* xs = ring + (it % STAGES) * SLAB * CHUNK;
    const int ch = chunk_of(it);
    const int col0 = ch * CHUNK;
    const int width = min(CHUNK, q - col0);
    const bool own = ch == part;
    const bool first = it % a.parts == 0;
    const bool final_part = it % a.parts == a.parts - 1;

    // 1. partial residuals over the thread's columns of this part
    if (first) {
#pragma unroll
      for (int i = 0; i < V; ++i) p[i] = 0.0f;
    }
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const int j = 4 * (t + jj * MK_THREADS);
      if (j >= width) continue;
      float4 xv[SLAB];
#pragma unroll
      for (int r = 0; r < SLAB; ++r)
        xv[r] = *reinterpret_cast<const float4*>(xs + r * CHUNK + j);
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        float4 th;
        if (own) {
          th = *reinterpret_cast<const float4*>(ths + cc * CHUNK + j);
        } else if (cc < cw) {
          const float* src = a.theta_t + (long long)(c0 + cc) * q + col0 + j;
          if (VEC) {
            th = __ldg(reinterpret_cast<const float4*>(src));
          } else {
            th.x = __ldg(src);
            th.y = col0 + j + 1 < q ? __ldg(src + 1) : 0.0f;
            th.z = col0 + j + 2 < q ? __ldg(src + 2) : 0.0f;
            th.w = col0 + j + 3 < q ? __ldg(src + 3) : 0.0f;
          }
        } else {
          th = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int r = 0; r < SLAB; ++r) {
          float v = p[r * NC + cc];
          v = fmaf(xv[r].x, th.x, v);
          v = fmaf(xv[r].y, th.y, v);
          v = fmaf(xv[r].z, th.z, v);
          v = fmaf(xv[r].w, th.w, v);
          p[r * NC + cc] = v;
        }
      }
    }
    if (!final_part) continue;
    const int g = g0 + it / a.parts;     // the slab, its row, its live rows
    const int b = row_of(g);
    const int live = b < a.n - 1 ? a.live_c : a.live_l;

    // 2. R = mask (sum over the block - Y), summed in a fixed order
    {   // p is summed in place; the next slab starts it anew
      int base = 0;
      reduce_scatter<V, V, 0>(p, lane, base);
      constexpr int M = reduce_scatter_count<V>();
#pragma unroll
      for (int i = 0; i < M; ++i) red[warp * V + base + i] = p[i];
    }
    __syncthreads();
    // every warp forms all of R itself, into its own copy: no second
    // barrier before the gradient phase
    for (int e = lane; e < V; e += 32) {
      const int r = e / NC;
      const int cc = e % NC;
      const int k = (g - b * slabs_c) * SLAB + r;
      float sum = red[e];
#pragma unroll
      for (int w = 1; w < MK_WARPS; ++w) sum += red[w * V + e];
      float res = 0.0f;
      if (k < live && cc < cw) {
        const int st = it % STAGES;
        const float wgt =
            a.mask != nullptr ? mring[st * SLAB + r] : 1.0f;
        res = (sum - yring[st * SLAB * CMAX + r * CMAX + cc]) * wgt;
      }
      rs[r * CMAX + cc] = res;
    }
    __syncwarp();

    // 3. the gradient of the thread's columns of its own part
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const int j = 4 * (t + jj * MK_THREADS);
      if (j >= width) continue;
#pragma unroll
      for (int r = 0; r < SLAB; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + r * CHUNK + j);
        const float xe[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int c2 = 0; c2 < NC / 2; ++c2) {
          const float2 rv =
              *reinterpret_cast<const float2*>(rs + r * CMAX + 2 * c2);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[jj][e][2 * c2 + 0] = fmaf(xe[e], rv.x, acc[jj][e][2 * c2 + 0]);
            acc[jj][e][2 * c2 + 1] = fmaf(xe[e], rv.y, acc[jj][e][2 * c2 + 1]);
          }
        }
      }
    }

    // the block's last slab of row b: its (q part, c chunk) of the
    // segment (block bx, row b), index bx + b, stored (c, q) so that a
    // warp writes consecutive columns; then a fresh sum
    if (g + 1 == g1 || row_of(g + 1) != b) {
      float* out = a.out + (long long)(bx + b) * q * c;
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        const int i = own0 + 4 * (t + jj * MK_THREADS);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          float* o = out + (long long)(c0 + cc) * q + i;
          if (cc < cw && VEC && i < q) {
            *reinterpret_cast<float4*>(o) =
                make_float4(acc[jj][0][cc], acc[jj][1][cc], acc[jj][2][cc],
                            acc[jj][3][cc]);
          } else if (cc < cw) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (i + e < q) o[e] = acc[jj][e][cc];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[jj][e][cc] = 0.0f;
        }
      }
    }
  }
  cp_async_wait_all();
}

// g[b] = sum of the segments (block k, row b), each (c, q), k = k0 .. k1
// the blocks whose slabs meet row b, in block order; segment (k, b) is
// partial k + b (a block ends where the next one starts, a row likewise,
// so k + b numbers the segments in order, with a gap where the two
// coincide).  One block per (row b, 32 columns of q): it reads the
// segments along q and writes g[b] (q, c) through a transposing tile, both
// coalesced.
constexpr int CB_COLS = 32;
constexpr int CB_THREADS = 256;

__global__ void __launch_bounds__(CB_THREADS)
masked_combine_kernel(const float* __restrict__ part, float* __restrict__ g,
                      int q, int c, int n, int slabs_c, int slabs_l,
                      int chain) {
  __shared__ float tile[CB_COLS][CB_COLS + 1];
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * CB_COLS;
  const int t = threadIdx.x;
  const long long qc = (long long)q * c;
  const int first = b * slabs_c;
  const int k0 = first / chain;
  const int S = (first + (b < n - 1 ? slabs_c : slabs_l) - 1) / chain - k0 + 1;
  const float* pb = part + (long long)(k0 + b) * qc;
  float* gb = g + b * qc;
  for (int cc0 = 0; cc0 < c; cc0 += CB_COLS) {
    const int cw = min(CB_COLS, c - cc0);
    for (int e = t; e < CB_COLS * CB_COLS; e += CB_THREADS) {
      const int ii = e % CB_COLS;
      const int cl = e / CB_COLS;
      if (cl >= cw || i0 + ii >= q) continue;
      const float* p = pb + (long long)(cc0 + cl) * q + i0 + ii;
      float v = p[0];
      int s = 1;
      for (; s + 4 <= S; s += 4) {   // four loads in flight, added in order
        const float a0 = p[s * qc];
        const float a1 = p[(s + 1) * qc];
        const float a2 = p[(s + 2) * qc];
        const float a3 = p[(s + 3) * qc];
        v += a0;
        v += a1;
        v += a2;
        v += a3;
      }
      for (; s < S; ++s) v += p[s * qc];
      tile[ii][cl] = v;
    }
    __syncthreads();
    for (int e = t; e < CB_COLS * cw; e += CB_THREADS) {
      const int ii = e / cw;
      const int cl = e % cw;
      if (i0 + ii < q) gb[(long long)(i0 + ii) * c + cc0 + cl] = tile[ii][cl];
    }
    __syncthreads();
  }
}

template <int NC, int J, bool VEC>
int masked_launch(MaskedArgs a, float* g, float* part, cudaStream_t stream) {
  constexpr long long smem =
      mk_smem_bytes(NC, J, mk_rows(NC, J), mk_stages(NC, J));
  static_assert(smem <= MK_MAX_SMEM, "shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      masked_kernel<NC, J, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int rows = mk_rows(NC, J);
  const int slabs_c = a.n > 1 ? (a.live_c + rows - 1) / rows : 0;
  const int slabs_l = (a.live_l + rows - 1) / rows;
  const int total = (a.n - 1) * slabs_c + slabs_l;
  a.out = part;
  const dim3 grid((total + a.chain - 1) / a.chain, (a.c + CMAX - 1) / CMAX,
                  a.parts);
  masked_kernel<NC, J, VEC><<<grid, MK_THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 cgrid((a.q + CB_COLS - 1) / CB_COLS, a.n);
  masked_combine_kernel<<<cgrid, CB_THREADS, 0, stream>>>(
      part, g, a.q, a.c, a.n, slabs_c, slabs_l, a.chain);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, int J>
int masked_launch_nc_j(const MaskedArgs& a, bool vec, float* g, float* part,
                       cudaStream_t stream) {
  return vec ? masked_launch<NC, J, true>(a, g, part, stream)
             : masked_launch<NC, J, false>(a, g, part, stream);
}

template <int J>
int masked_launch_j(const MaskedArgs& a, bool vec, float* g, float* part,
                    cudaStream_t stream) {
  // NC: the widest c chunk rounded up to an even width
  switch ((a.c < CMAX ? a.c : CMAX) + 1) {
    case 2: case 3: return masked_launch_nc_j<2, J>(a, vec, g, part, stream);
    case 4: case 5: return masked_launch_nc_j<4, J>(a, vec, g, part, stream);
    case 6: case 7: return masked_launch_nc_j<6, J>(a, vec, g, part, stream);
    case 8: case 9: return masked_launch_nc_j<8, J>(a, vec, g, part, stream);
    case 10: case 11:
      return masked_launch_nc_j<10, J>(a, vec, g, part, stream);
    case 12: case 13:
      return masked_launch_nc_j<12, J>(a, vec, g, part, stream);
    case 14: case 15:
      return masked_launch_nc_j<14, J>(a, vec, g, part, stream);
    default: return masked_launch_nc_j<16, J>(a, vec, g, part, stream);
  }
}

}  // namespace

// x: (n, L, q), theta_t: (c, q) (theta transposed), y: (n, L, c),
// mask: (n, L) or nullptr (every row weighs 1), part: (blocks + n, q, c)
// scratch (the segments), g: (n, q, c); float32, contiguous, on the
// device of `stream`.  Rows b < n - 1 read their first live_c rows, row
// n - 1 its first live_l (each in [1, L]; the caller guarantees x = y =
// mask = 0 past them); each block walks `chain` slabs of all rows' slabs
// in row order, blocks = ceil(slabs / chain) (ops.masked_plan).  Returns
// the first failing launch's cudaError_t.
extern "C" int linreg_grad_masked_f32(const float* x, const float* theta_t,
                                      const float* y, const float* mask,
                                      float* part, float* g, int n, int L,
                                      int q, int c, int live_c, int live_l,
                                      int chain, cudaStream_t stream) {
  if (n < 1 || L < 1 || q < 1 || c < 1 || live_c < 1 || live_c > L ||
      live_l < 1 || live_l > L || chain < 1 || part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  MaskedArgs a;
  a.x = x;
  a.theta_t = theta_t;
  a.y = y;
  a.mask = mask;
  a.out = g;
  a.n = n;
  a.L = L;
  a.q = q;
  a.c = c;
  a.live_c = live_c;
  a.live_l = live_l;
  a.chain = chain;
  const int J = q <= mk_chunk(1) ? 1 : 2;
  a.parts = (q + mk_chunk(J) - 1) / mk_chunk(J);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const bool vec = q % 4 == 0 && aligned(x) && aligned(theta_t);
  return J == 1 ? masked_launch_j<1>(a, vec, g, part, stream)
                : masked_launch_j<2>(a, vec, g, part, stream);
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
