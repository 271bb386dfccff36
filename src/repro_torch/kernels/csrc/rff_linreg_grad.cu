// Fused RFF embedding -> per-client masked linear-regression gradients
// (paper eq. 18 and eq. 7/10/28) on Hopper.
//
//   phi_b = sqrt(2/q_true) cos(X_b Omega + delta)     b <  n_real (raw rows)
//   phi_b = pphi                                       b >= n_real (parity)
//   g_b   = phi_b^T diag(mask_b) (phi_b theta - Y_b)
//
//   X: (n_real, L, d), Omega: (d, q), delta: (q,), theta: (q, c),
//   Y: (rows, L, c), mask: (rows, L) float32, pphi: (L, q) or nullptr
//   -> g: (rows, q, c) float32.
//
// X, Omega, delta, theta, Y and pphi are all float or all __nv_bfloat16
// (two entry points); the mask (the parity row's 1/u scale would lose bits
// in bf16), phi, every sum and g are float32.  Only the first `live_raw`
// rows of each raw client and the first `live_par` rows of the parity row
// are read: the caller guarantees that the rows past them hold x = 0,
// y = 0 and mask = 0 (see ops.rff_linreg_grad_masked for why skipping
// them is exact).
//
// Replaces the Pallas TPU kernel `rff_linreg_grad_masked` in
// src/repro/kernels/rff_linreg_grad.py.  There Omega (d, q) and theta stay
// resident in VMEM for the whole grid, a (bm, q) row block of phi is
// embedded into VMEM scratch once, and phi^T R accumulates into an output
// block that the sequential grid revisits.  On Hopper Omega alone (6.3 MB
// at d = 784, q = 2000) is far beyond one SM's 227 KB, so the row block of
// phi is spread over a thread-block cluster instead:
//
//   One cluster of CL <= 8 CTAs per (row b, group s of slabs).  A slab is
//   R (64, or 32 / 16 where q is large) consecutive live rows of row b; the
//   group walks slabs s, s + S, s + 2S, ..., with S groups for each raw row
//   and its own S for the parity row (whose slabs need no embedding, and
//   whose u live rows outnumber a client's l_max).  CTA k of the cluster
//   owns the QC columns [k QC, (k + 1) QC) of q and keeps its (R, QC) part
//   of phi in shared memory, float32.  Per slab:
//     1. embed: 64 x 256 tiles of X Omega over d on the tensor cores
//        (mma.sync), X and Omega staged in shared memory in a ring of 3
//        buffers (cp.async, 16-byte copies where the widths allow).
//        bfloat16: m16n8k16, fragments from ldmatrix; bf16 products are
//        exact in float32 and the sums float32, as the TPU's MXU computes.
//        float32: 3xTF32, each element split into a big and a small TF32
//        part and three m16n8k8 products (small*big, big*small, big*big),
//        about 2^-22 relative a product against float32's 2^-24; never
//        single-pass TF32.  The tensor cores' float32 sums round toward
//        zero, so every 16 K steps their partial sums are added into phi in
//        shared memory with an ordinary float32 add (at the main path's
//        shape on an H100, chip_smoke.py's check of g: 4.7e-4 with one
//        accumulator over d = 784, 6.1e-5 with the adds).  The cosine
//        epilogue writes phi straight into shared memory.  The parity row
//        copies pphi instead.
//     2. residual: each CTA contracts its columns of phi with theta into a
//        partial (R, 16) residual (4 x 4 register blocks, float4 reads of
//        phi and theta); after a cluster barrier every CTA reads
//        the CL partials through distributed shared memory and sums them in
//        rank order 0..CL-1, so all CTAs hold the same bits of
//        R = mask (phi theta - Y).
//     3. gradient: each CTA accumulates phi^T R for its columns from the
//        phi it already holds.
//   Steps 2-3 repeat per 16-wide chunk of c over the same phi, so each phi
//   element is computed once per launch and never leaves the SM.  The sum
//   over the slabs of a group runs in slab order (each output element has
//   one owner thread, which reads and adds it back); where a row has more
//   than one group, a short combine launch sums its groups' partial
//   gradients in group order.  No
//   atomics anywhere: reruns give the same bits.  Rows with mask 0 inside
//   the live range are computed, so a NaN there propagates (0 * NaN), as in
//   the reference.
//
// Bound on the H100: operations.  At the main-path shape (31 rows, 30 of
// them raw, d = 784, q = 2000, c = 10) with l_max = 400 live client rows
// and u = 2400 parity rows the embedding is 2*30*400*784*2000 = 37.6 GFLOP
// and the two contractions (FFMA) 4*(30*400 + 2400)*2000*10 = 1.2 GFLOP:
// 0.25 ms for 3xTF32 at 495/3 TFLOP/s, 0.06 ms in bf16 at 989 TFLOP/s.
// With every row of L = 2400 live the embedding is 226 GFLOP.
#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int TILE_M = 64;        // rows of an embedding tile (R <= 64)
constexpr int TILE_N = 256;       // columns of an embedding tile
constexpr int CMAX = 16;          // label columns per pass
constexpr int MAX_CLUSTER = 8;
constexpr int PHI_PAD = 4;        // keeps phi rows 16-byte aligned
constexpr int MAX_SMEM = 232448;  // a block's dynamic shared memory

// float32 (3xTF32) tile: Xs[row][k] and Bs[k][col], K steps of 8; bf16
// tile: the same with K steps of 16.  Both in a ring of 3 stages; the pads
// put the 8 rows an ldmatrix reads in 8 distinct 16-byte bank groups
// (48-byte rows of X; 528-byte bf16 rows of Omega) and the float32 B reads
// of a warp in 32 distinct banks (264-float rows)
constexpr int STAGES = 3;
constexpr int F_BK = 8;
constexpr int F_LDA = F_BK + 4;
constexpr int F_LDB = TILE_N + 8;
constexpr int F_FLUSH = 16;       // K steps between adds into phi
constexpr int H_BK = 16;
constexpr int H_LDA = H_BK + 8;
constexpr int H_LDB = TILE_N + 8;

// the staging area: the GEMM's buffers, then a 256-row piece of theta and
// the residual's four quarter sums
constexpr int STAGE_BYTES = 34560;
static_assert(STAGES * (TILE_M * F_LDA + F_BK * F_LDB) * 4 <= STAGE_BYTES,
              "f32");
static_assert(STAGES * (TILE_M * H_LDA + H_BK * H_LDB) * 2 <= STAGE_BYTES,
              "bf16");
static_assert((CMAX * TILE_N + 4 * TILE_M * CMAX) * 4 <= STAGE_BYTES,
              "theta piece and the residual's quarter sums");
static_assert(TILE_N == THREADS && CMAX == 16 && TILE_M == 64,
              "one theta row a thread; 4 x 4 register blocks");

template <class T>
struct Args {
  const T* x;
  const T* omega;
  const T* delta;
  const T* theta;
  const T* y;
  const float* mask;
  const T* pphi;
  float* out;      // g, or the partials of every (row, group) cluster
  int n_real, L, d, q, c, live_raw, live_par, R, QC, S_raw, S_par;
  float scale;
  bool vec;        // 16-byte copies of X and Omega are aligned
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float phi_of(float acc, float delta, float scale) {
  return scale * cosf(acc + delta);
}

// ------------------------------------------------------ tensor-core tiles
// Both tiles compute phi[r][joff + j] = scale cos(sum_k X[row0 + r, k]
// Omega[k, n0 + j] + delta[n0 + j]) for r < R, j < 256 (0 for r >= n_rows
// or n0 + j >= q) with mma.sync: warp (wm, wn) of the 2 x 4 warp grid owns
// rows wm*32 .. +31 and columns wn*64 .. +63, 2 x 8 accumulator tiles of
// 16 x 8.  X and Omega are staged in a ring of 3 shared-memory buffers
// (cp.async); step kt waits for its own copy only, while the copies of the
// next two steps are in flight (one commit group a step, empty past the
// end).
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the cosine epilogue of either tile: accumulator (mi, ni) holds rows g
// and g + 8 and columns 2 t4 and 2 t4 + 1 of its 16 x 8 tile
template <class T>
__device__ __forceinline__ void store_phi(const float (&acc)[2][8][4],
                                          const Args<T>& a, int n_rows,
                                          int n0, float* phi, int ldphi,
                                          int joff, bool flushed) {
  const int lane = threadIdx.x % 32;
  const int wm = threadIdx.x / 32 / 4;
  const int wn = threadIdx.x / 32 % 4;
  const int g = lane / 4;
  const int t4 = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + mi * 16 + g + h * 8;
      if (r >= a.R) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int j = wn * 64 + ni * 8 + 2 * t4;
        const int gj = n0 + j;
        float2* p = reinterpret_cast<float2*>(phi + r * ldphi + joff + j);
        const float2 s = flushed ? *p : make_float2(0.0f, 0.0f);
        float2 v;
        v.x = (r < n_rows && gj < a.q)
                  ? phi_of(s.x + acc[mi][ni][2 * h], to_float(a.delta[gj]),
                           a.scale)
                  : 0.0f;
        v.y = (r < n_rows && gj + 1 < a.q)
                  ? phi_of(s.y + acc[mi][ni][2 * h + 1],
                           to_float(a.delta[gj + 1]), a.scale)
                  : 0.0f;
        *p = v;
      }
    }
  }
}

// ---------------------------------------------------------------- float32
// 3xTF32 on the tensor cores, K steps of 8: Xs[row][k] (48-byte rows) and
// Bs[k][col] (264 floats, so the 32 lanes' scalar B reads hit 32 banks).
// Each fragment element is split into big + small TF32 parts and each
// 16 x 8 tile takes three m16n8k8 products, small terms first.
__device__ __forceinline__ void embed_tile(const Args<float>& a, int b,
                                           int row0, int n_rows, int n0,
                                           char* stage, float* phi,
                                           int ldphi, int joff) {
  float* Xs = reinterpret_cast<float*>(stage);   // [3][TILE_M][F_LDA]
  float* Bs = Xs + STAGES * TILE_M * F_LDA;      // [3][F_BK][F_LDB]
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const int wm = warp / 4;
  const int wn = warp % 4;
  const int d = a.d;
  const int q = a.q;
  const float* xb = a.x + ((long long)b * a.L + row0) * d;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  auto load = [&](int buf, int k0) {
    if (a.vec) {
      if (t < TILE_M * 2) {                   // 64 rows x 2 chunks of 4
        const int r = t / 2;
        const int kc = (t % 2) * 4;
        const bool ok = r < n_rows && k0 + kc < d;
        cp_async16(&Xs[(buf * TILE_M + r) * F_LDA + kc],
                   ok ? xb + (long long)r * d + k0 + kc : a.x, ok);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {           // 8 rows x 64 chunks of 4
        const int e = t + u * THREADS;
        const int kk = e / (TILE_N / 4);
        const int j = (e % (TILE_N / 4)) * 4;
        const int gk = k0 + kk;
        const bool ok = gk < d && n0 + j < q;
        cp_async16(&Bs[(buf * F_BK + kk) * F_LDB + j],
                   ok ? a.omega + (long long)gk * q + n0 + j : a.omega, ok);
      }
    } else {
      for (int e = t; e < TILE_M * F_BK; e += THREADS) {
        const int r = e / F_BK;
        const int gk = k0 + e % F_BK;
        Xs[(buf * TILE_M + r) * F_LDA + e % F_BK] =
            (r < n_rows && gk < d) ? xb[(long long)r * d + gk] : 0.0f;
      }
      for (int e = t; e < F_BK * TILE_N; e += THREADS) {
        const int kk = e / TILE_N;
        const int j = e % TILE_N;
        const int gk = k0 + kk;
        Bs[(buf * F_BK + kk) * F_LDB + j] =
            (gk < d && n0 + j < q) ? a.omega[(long long)gk * q + n0 + j]
                                   : 0.0f;
      }
    }
  };

  const int g = lane / 4;
  const int t4 = lane % 4;
  const int nk = (d + F_BK - 1) / F_BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, st * F_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // step kt's tile is complete; step kt-1's is free
    if (kt + STAGES - 1 < nk)
      load((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * F_BK);
    cp_async_commit();
    unsigned a_big[2][4];
    unsigned a_small[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      unsigned raw[4];
      ldmatrix_x4(raw, &Xs[(buf * TILE_M + wm * 32 + mi * 16 + lane % 16)
                              * F_LDA + (lane / 16) * 4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(raw[e], a_big[mi][e],
                                             a_small[mi][e]);
    }
    const float* bk = Bs + (buf * F_BK + t4) * F_LDB + wn * 64 + g;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      unsigned b_big[2];
      unsigned b_small[2];
      split_tf32(__float_as_uint(bk[ni * 8]), b_big[0], b_small[0]);
      split_tf32(__float_as_uint(bk[4 * F_LDB + ni * 8]), b_big[1],
                 b_small[1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_tf32(acc[mi][ni], a_small[mi], b_big[0], b_big[1]);
        mma_tf32(acc[mi][ni], a_big[mi], b_small[0], b_small[1]);
        mma_tf32(acc[mi][ni], a_big[mi], b_big[0], b_big[1]);
      }
    }
    // every F_FLUSH steps the tensor cores' partial sums are added to the
    // thread's own elements of phi with a float32 add: their accumulator
    // then never carries more than 3 F_FLUSH products per element
    if ((kt + 1) % F_FLUSH == 0 && kt + 1 < nk) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mi * 16 + g + h * 8;
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            if (r < a.R) {
              float2* p = reinterpret_cast<float2*>(
                  phi + r * ldphi + joff + wn * 64 + ni * 8 + 2 * t4);
              const float2 s = kt + 1 == F_FLUSH ? make_float2(0.0f, 0.0f)
                                                 : *p;
              *p = make_float2(s.x + acc[mi][ni][2 * h],
                               s.y + acc[mi][ni][2 * h + 1]);
            }
            acc[mi][ni][2 * h] = 0.0f;
            acc[mi][ni][2 * h + 1] = 0.0f;
          }
        }
    }
  }
  cp_async_wait_all();
  __syncthreads();   // the stage is free for the caller
  store_phi(acc, a, n_rows, n0, phi, ldphi, joff, nk > F_FLUSH);
}

// ---------------------------------------------------------------- bfloat16
// bf16 on the tensor cores, K steps of 16: Xs[row][k] (48-byte rows) and
// Bs[k][col] (528-byte rows), so the 8 rows an ldmatrix reads fall in 8
// distinct 16-byte bank groups; one ldmatrix.x4 per 16 rows of X and one
// ldmatrix.x4.trans per 16 columns of Omega a step.
__device__ __forceinline__ void embed_tile(const Args<bf16>& a, int b,
                                           int row0, int n_rows, int n0,
                                           char* stage, float* phi,
                                           int ldphi, int joff) {
  bf16* Xs = reinterpret_cast<bf16*>(stage);     // [3][TILE_M][H_LDA]
  bf16* Bs = Xs + STAGES * TILE_M * H_LDA;       // [3][H_BK][H_LDB]
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const int wm = warp / 4;
  const int wn = warp % 4;
  const int d = a.d;
  const int q = a.q;
  const bf16* xb = a.x + ((long long)b * a.L + row0) * d;
  const bf16 zero = __float2bfloat16(0.0f);

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  auto load = [&](int buf, int k0) {
    if (a.vec) {
      if (t < TILE_M * 2) {                   // 64 rows x 2 chunks of 8
        const int r = t / 2;
        const int kc = (t % 2) * 8;
        const bool ok = r < n_rows && k0 + kc < d;
        cp_async16(&Xs[(buf * TILE_M + r) * H_LDA + kc],
                   ok ? xb + (long long)r * d + k0 + kc : a.x, ok);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {           // 16 rows x 32 chunks of 8
        const int e = t + u * THREADS;
        const int kk = e / (TILE_N / 8);
        const int j = (e % (TILE_N / 8)) * 8;
        const int gk = k0 + kk;
        const bool ok = gk < d && n0 + j < q;
        cp_async16(&Bs[(buf * H_BK + kk) * H_LDB + j],
                   ok ? a.omega + (long long)gk * q + n0 + j : a.omega, ok);
      }
    } else {
      for (int e = t; e < TILE_M * H_BK; e += THREADS) {
        const int r = e / H_BK;
        const int gk = k0 + e % H_BK;
        Xs[(buf * TILE_M + r) * H_LDA + e % H_BK] =
            (r < n_rows && gk < d) ? xb[(long long)r * d + gk] : zero;
      }
      for (int e = t; e < H_BK * TILE_N; e += THREADS) {
        const int kk = e / TILE_N;
        const int j = e % TILE_N;
        const int gk = k0 + kk;
        Bs[(buf * H_BK + kk) * H_LDB + j] =
            (gk < d && n0 + j < q) ? a.omega[(long long)gk * q + n0 + j]
                                   : zero;
      }
    }
  };

  const int nk = (d + H_BK - 1) / H_BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, st * H_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // step kt's tile is complete; step kt-1's is free
    if (kt + STAGES - 1 < nk)
      load((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * H_BK);
    cp_async_commit();
    unsigned af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(af[mi], &Xs[(buf * TILE_M + wm * 32 + mi * 16 + lane % 16)
                                  * H_LDA + (lane / 16) * 8]);
#pragma unroll
    for (int np = 0; np < 4; ++np) {   // n tiles 2 np and 2 np + 1
      unsigned bfr[4];
      ldmatrix_x4_trans(bfr, &Bs[(buf * H_BK + lane % 16) * H_LDB + wn * 64 +
                                 np * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc[mi][2 * np], af[mi], bfr[0], bfr[1]);
        mma_bf16(acc[mi][2 * np + 1], af[mi], bfr[2], bfr[3]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();   // the stage is free for the caller
  store_phi(acc, a, n_rows, n0, phi, ldphi, joff, false);
}

// ---------------------------------------------------------------- kernel
template <class T>
__global__ void __launch_bounds__(THREADS, 2) fused_kernel(Args<T> a) {
  extern __shared__ float4 smem4[];
  char* stage = reinterpret_cast<char*>(smem4);
  const int R = a.R;
  const int QC = a.QC;
  const int ldphi = QC + PHI_PAD;
  float* Ps = reinterpret_cast<float*>(stage + STAGE_BYTES);  // [R][CMAX]
  float* Rv = Ps + R * CMAX;                                  // [R][CMAX]
  float* phi = Rv + R * CMAX;                                 // [R][ldphi]
  float* ths = reinterpret_cast<float*>(stage);               // [256][CMAX]
  float* red = ths + TILE_N * CMAX;                           // [4][64][CMAX]

  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int col0 = static_cast<int>(cluster.block_rank()) * QC;
  // cluster y: raw row y / S_raw, group y % S_raw; then the parity row's
  // S_par groups
  const int y = blockIdx.y;
  const int raw_clusters = a.n_real * a.S_raw;
  const bool raw = y < raw_clusters;
  const int b = raw ? y / a.S_raw : a.n_real;
  const int s = raw ? y % a.S_raw : y - raw_clusters;
  const int S = raw ? a.S_raw : a.S_par;
  const int q = a.q;
  const int c = a.c;
  const int live = raw ? a.live_raw : a.live_par;
  const int n_slabs = (live + R - 1) / R;
  const bool direct = a.S_raw == 1 && a.S_par == 1;
  float* out = a.out + (long long)(direct ? b : y) * q * c;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;

  bool first = true;
  for (int slab = s; slab < n_slabs; slab += S) {
    const int row0 = slab * R;
    const int n_rows = min(R, live - row0);
    __syncthreads();   // the previous slab is done with phi and the stage
    // 1. this CTA's (R, QC) part of phi
    if (raw) {
      for (int j0 = 0; j0 < QC; j0 += TILE_N) {
        if (col0 + j0 < q) {
          embed_tile(a, b, row0, n_rows, col0 + j0, stage, phi, ldphi, j0);
        } else {
          for (int e = t; e < R * TILE_N; e += THREADS)
            phi[(e / TILE_N) * ldphi + j0 + e % TILE_N] = 0.0f;
        }
      }
    } else {   // 16 rows of loads in flight a thread (R % 16 == 0)
      for (int r0 = 0; r0 < R; r0 += 16) {
        for (int j = t; j < QC; j += THREADS) {
          const int gj = col0 + j;
          float v[16];
#pragma unroll
          for (int u = 0; u < 16; ++u)
            v[u] = (r0 + u < n_rows && gj < q)
                       ? to_float(a.pphi[(long long)(row0 + r0 + u) * q + gj])
                       : 0.0f;
#pragma unroll
          for (int u = 0; u < 16; ++u) phi[(r0 + u) * ldphi + j] = v[u];
        }
      }
    }
    __syncthreads();

    for (int c0 = 0; c0 < c; c0 += CMAX) {
      const int cw = min(CMAX, c - c0);
      // 2a. partial residual of this CTA's columns.  Thread (rg, cg) of
      //     warp (rh, js) sums rows rh*8 + rg + 16k (k < R/16) and label
      //     columns cg*4 .. +3 over the 64 columns js*64 .. +63 of each
      //     256-column piece: 8 float4 reads of phi and theta feed 64 FMA.
      //     The four column quarters are added in order through shared
      //     memory.
      {
        const int rg = lane % 8;
        const int cg = lane / 8;
        const int rh = warp % 2;
        const int js = warp / 2;
        float acc[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int h = 0; h < 4; ++h) acc[k][h] = 0.0f;
        for (int p0 = 0; p0 < QC && col0 + p0 < q; p0 += TILE_N) {
          {   // thread t stages theta's row col0 + p0 + t: 16 loads in flight
            const int gj = col0 + p0 + t;
            float v[CMAX];
#pragma unroll
            for (int cc = 0; cc < CMAX; ++cc)
              v[cc] = (cc < cw && gj < q)
                          ? to_float(a.theta[(long long)gj * c + c0 + cc])
                          : 0.0f;
#pragma unroll
            for (int v4 = 0; v4 < CMAX / 4; ++v4)
              *reinterpret_cast<float4*>(ths + t * CMAX + 4 * v4) =
                  make_float4(v[4 * v4], v[4 * v4 + 1], v[4 * v4 + 2],
                              v[4 * v4 + 3]);
          }
          __syncthreads();
#pragma unroll 4
          for (int jj = 0; jj < TILE_N / 4; jj += 4) {
            const int j = js * (TILE_N / 4) + jj;
            float4 ph[4];
            float4 th[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int r = rh * 8 + rg + 16 * k;
              ph[k] = r < R ? *reinterpret_cast<const float4*>(
                                  phi + r * ldphi + p0 + j)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
#pragma unroll
            for (int h = 0; h < 4; ++h)
              th[h] = *reinterpret_cast<const float4*>(
                  ths + (j + h) * CMAX + cg * 4);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float pk[4] = {ph[k].x, ph[k].y, ph[k].z, ph[k].w};
#pragma unroll
              for (int h = 0; h < 4; ++h) {
                acc[k][0] = fmaf(pk[h], th[h].x, acc[k][0]);
                acc[k][1] = fmaf(pk[h], th[h].y, acc[k][1]);
                acc[k][2] = fmaf(pk[h], th[h].z, acc[k][2]);
                acc[k][3] = fmaf(pk[h], th[h].w, acc[k][3]);
              }
            }
          }
          __syncthreads();   // the next piece restages theta
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = rh * 8 + rg + 16 * k;
          if (r < R)
            *reinterpret_cast<float4*>(red + (js * TILE_M + r) * CMAX +
                                       cg * 4) =
                make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
        }
        __syncthreads();
        for (int e = t; e < R * CMAX; e += THREADS)
          Ps[e] = ((red[e] + red[TILE_M * CMAX + e]) +
                   red[2 * TILE_M * CMAX + e]) +
                  red[3 * TILE_M * CMAX + e];
      }
      // 2b. R = mask (sum over the cluster's CTAs in rank order - Y)
      cluster.sync();
      for (int e = t; e < R * CMAX; e += THREADS) {
        const int r = e / CMAX;
        const int cc = e % CMAX;
        float v = 0.0f;
        if (r < n_rows && cc < cw) {
          float p[MAX_CLUSTER];   // the CL remote reads in flight together
#pragma unroll
          for (int k = 0; k < MAX_CLUSTER; ++k)
            p[k] = k < CL ? cluster.map_shared_rank(Ps, k)[e] : 0.0f;
          v = p[0];
#pragma unroll
          for (int k = 1; k < MAX_CLUSTER; ++k)
            if (k < CL) v += p[k];
          const long long row = (long long)b * a.L + row0 + r;
          v = (v - to_float(a.y[row * c + c0 + cc])) * a.mask[row];
        }
        Rv[e] = v;
      }
      cluster.sync();   // every CTA has read the partials; Rv is complete
      // 3. phi^T R for this CTA's columns, added to the group's sum:
      //    thread (jg, cg) sums columns jg*4 .. +3 and label columns
      //    cg*4 .. +3 of each 256-column piece over the slab's rows, two
      //    float4 reads and 16 FMA a row
      {
        const int cg = t % 4;
        const int jg = t / 4;
        for (int p0 = 0; p0 < QC && col0 + p0 < q; p0 += TILE_N) {
          const int j = p0 + jg * 4;
          float acc[4][4];
#pragma unroll
          for (int h = 0; h < 4; ++h)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[h][k] = 0.0f;
#pragma unroll 4
          for (int r = 0; r < n_rows; ++r) {
            const float4 ph =
                *reinterpret_cast<const float4*>(phi + r * ldphi + j);
            const float4 rv =
                *reinterpret_cast<const float4*>(Rv + r * CMAX + cg * 4);
            const float pk[4] = {ph.x, ph.y, ph.z, ph.w};
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              acc[h][0] = fmaf(pk[h], rv.x, acc[h][0]);
              acc[h][1] = fmaf(pk[h], rv.y, acc[h][1]);
              acc[h][2] = fmaf(pk[h], rv.z, acc[h][2]);
              acc[h][3] = fmaf(pk[h], rv.w, acc[h][3]);
            }
          }
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int gj = col0 + j + h;
            if (gj >= q) continue;
            float* o = out + (long long)gj * c + c0 + cg * 4;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (cg * 4 + k < cw) o[k] = first ? acc[h][k] : o[k] + acc[h][k];
          }
        }
      }
    }
    first = false;
  }
  if (first) {   // a group with no live slab
    for (int j = t; j < QC; j += THREADS) {
      const int gj = col0 + j;
      if (gj < q)
        for (int cc = 0; cc < c; ++cc) out[(long long)gj * c + cc] = 0.0f;
    }
  }
}

// g[b] = sum over the groups s of row b of its partial, in order s = 0, 1,
// ...: S_raw groups for a raw row, S_par for the parity row
__global__ void combine_kernel(const float* __restrict__ part,
                               float* __restrict__ g, long long rows_qc,
                               long long qc, int n_real, int S_raw,
                               int S_par) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows_qc) return;
  const long long b = i / qc;
  const int S = b < n_real ? S_raw : S_par;
  const float* p = part + (b < n_real ? b * S_raw : (long long)n_real * S_raw)
                   * qc + i % qc;
  float v = p[0];
  for (int s = 1; s < S; ++s) v += p[s * qc];
  g[i] = v;
}

long long smem_bytes(int R, int QC) {
  return STAGE_BYTES + 2LL * R * CMAX * 4 + (long long)R * (QC + PHI_PAD) * 4;
}

cudaLaunchConfig_t config(int cluster, int clusters, long long smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, clusters, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// how many clusters of this shape the device holds at once
template <class T>
int max_clusters(int R, int cluster, int QC) {
  const long long smem = smem_bytes(R, QC);
  if (smem > MAX_SMEM || cluster < 1 || cluster > MAX_CLUSTER)
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster, 1, smem, nullptr, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, fused_kernel<T>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <class T>
int launch(Args<T> a, int rows, int cluster, float* g, float* part,
           cudaStream_t stream) {
  const int R = a.R;
  const long long smem = smem_bytes(R, a.QC);
  if ((R != 16 && R != 32 && R != 64) || cluster < 1 ||
      cluster > MAX_CLUSTER || a.QC < TILE_N || a.QC % TILE_N != 0 ||
      (long long)cluster * a.QC < a.q || (cluster - 1) * a.QC >= a.q ||
      a.S_raw < 1 || a.S_par < 1 || smem > MAX_SMEM ||
      (rows > a.n_real && a.pphi == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool direct = a.S_raw == 1 && a.S_par == 1;
  if (!direct && part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a.out = direct ? g : part;
  const int clusters = a.n_real * a.S_raw + (rows > a.n_real ? a.S_par : 0);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster, clusters, smem, stream, attr);
  err = cudaLaunchKernelEx(&cfg, fused_kernel<T>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!direct) {
    const long long qc = (long long)a.q * a.c;
    const long long n = rows * qc;
    combine_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                     stream>>>(part, g, n, qc, a.n_real, a.S_raw, a.S_par);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int entry(const T* x, const T* omega, const T* delta, const T* theta,
          const T* y, const float* mask, const T* pphi, float* part,
          float* g, int rows, int n_real, int L, int d, int q, int c,
          int q_true, int live_raw, int live_par, int slab_rows,
          int cluster, int cols_per_cta, int groups_raw, int groups_par,
          cudaStream_t stream) {
  constexpr int epv = 16 / sizeof(T);   // elements per 16-byte copy
  const auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  Args<T> a;
  a.x = x;
  a.omega = omega;
  a.delta = delta;
  a.theta = theta;
  a.y = y;
  a.mask = mask;
  a.pphi = pphi;
  a.out = g;
  a.n_real = n_real;
  a.L = L;
  a.d = d;
  a.q = q;
  a.c = c;
  a.live_raw = live_raw;
  a.live_par = live_par;
  a.R = slab_rows;
  a.QC = cols_per_cta;
  a.S_raw = groups_raw;
  a.S_par = groups_par;
  a.scale = static_cast<float>(std::sqrt(2.0 / q_true));
  a.vec = q % epv == 0 && d % epv == 0 && aligned(omega) && aligned(x);
  return launch(a, rows, cluster, g, part, stream);
}

}  // namespace

// x: (n_real, L, d), omega: (d, q), delta: (q,), theta: (q, c),
// y: (rows, L, c), mask: (rows, L) float32, pphi: (L, q) or nullptr (then
// rows == n_real); part: (n_real * groups_raw + groups_par, q, c) float32
// scratch (nullptr when both group counts are 1), g: (rows, q, c) float32;
// contiguous, on the device of `stream`.  The launch plan (slab_rows in
// {16, 32, 64}, cluster <= 8 CTAs of cols_per_cta columns each, a multiple
// of 256, and the groups of slabs of a raw row and of the parity row)
// comes from ops.fused_plan.  Returns the first failing call's cudaError_t
// (cudaErrorInvalidValue for a plan the kernel does not take).
extern "C" int rff_linreg_grad_masked_f32(
    const float* x, const float* omega, const float* delta,
    const float* theta, const float* y, const float* mask, const float* pphi,
    float* part, float* g, int rows, int n_real, int L, int d, int q, int c,
    int q_true, int live_raw, int live_par, int slab_rows, int cluster,
    int cols_per_cta, int groups_raw, int groups_par, cudaStream_t stream) {
  return entry(x, omega, delta, theta, y, mask, pphi, part, g, rows, n_real,
               L, d, q, c, q_true, live_raw, live_par, slab_rows, cluster,
               cols_per_cta, groups_raw, groups_par, stream);
}

// The same with bfloat16 x, omega, delta, theta, y and pphi.
extern "C" int rff_linreg_grad_masked_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* omega,
    const __nv_bfloat16* delta, const __nv_bfloat16* theta,
    const __nv_bfloat16* y, const float* mask, const __nv_bfloat16* pphi,
    float* part, float* g, int rows, int n_real, int L, int d, int q, int c,
    int q_true, int live_raw, int live_par, int slab_rows, int cluster,
    int cols_per_cta, int groups_raw, int groups_par, cudaStream_t stream) {
  return entry(x, omega, delta, theta, y, mask, pphi, part, g, rows, n_real,
               L, d, q, c, q_true, live_raw, live_par, slab_rows, cluster,
               cols_per_cta, groups_raw, groups_par, stream);
}

// The number of clusters of `cluster` CTAs, each holding a (slab_rows,
// cols_per_cta) part of phi, that the current device holds at once
// (cudaOccupancyMaxActiveClusters); a negative value is a cudaError_t.
extern "C" int rff_linreg_grad_max_clusters(int bf16, int slab_rows,
                                            int cluster, int cols_per_cta) {
  return bf16 ? max_clusters<__nv_bfloat16>(slab_rows, cluster, cols_per_cta)
              : max_clusters<float>(slab_rows, cluster, cols_per_cta);
}
