// Fused RFF embedding -> per-client masked linear-regression gradients
// (paper eq. 18 and eq. 7/10/28) on Hopper.
//
//   phi_b = sqrt(2/q_true) cos(X_b Omega + delta)     b <  n_real (raw rows)
//   phi_b = pphi                                       b >= n_real (parity)
//   g_b   = phi_b^T diag(mask_b) (phi_b theta - Y_b)
//
//   X: (n_real, L, d), Omega^T: (q, d), both prepared once
//   (ops.prepare_rff_operands: float32 as their big and small TF32 parts,
//   bfloat16 as they are), delta: (q,), theta: (q, c), Y: (rows, L, c),
//   mask: (rows, L) float32, pphi: (L, q) or nullptr -> g: (rows, q, c)
//   float32.
//
// X, Omega, delta, theta, Y and pphi are all float or all __nv_bfloat16
// (two entry points, one kernel template); the mask (the parity row's 1/u
// scale would lose bits in bf16), phi, every sum and g are float32.  Only
// the first `live_raw` rows of each raw client and the first `live_par`
// rows of the parity row are read: the caller guarantees that the rows past
// them hold x = 0, y = 0 and mask = 0 (see ops.rff_linreg_grad_masked for
// why skipping them is exact).  d is a multiple of 16 bytes of elements
// (the wrapper pads X and Omega^T with zero columns, which add 0 to X Omega).
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
//   R (112, or 64 / 32 / 16 where q is wide) consecutive live rows of row b;
//   the group walks slabs s, s + S, s + 2S, ..., with S groups for each raw
//   row and its own S for the parity row (whose slabs need no embedding).
//   CTA k of the cluster owns the QC columns [k QC, (k + 1) QC) of q and
//   keeps its (R, QC) part of phi in shared memory, float32.  A CTA is three
//   warpgroups: in step 1 warpgroups 0 and 1 compute and one thread of
//   warpgroup 2 copies; all three share steps 2a-2b.  Per slab:
//     1. embed, per 128-column tile of the CTA's columns: the copying
//        thread walks d in stages of 64 bytes (16 float32 or 32 bf16 of K)
//        through a ring of `stages` shared-memory stages, filled by TMA:
//        the slab's X rows in 16-row slices, each slice loaded by one CTA
//        of the cluster and multicast to all of them (X is read once per
//        cluster), and this CTA's (128, K) tile of Omega^T, big and small
//        parts of both in float32, 64-byte swizzled as wgmma reads them.  A
//        stage completes on its `full` mbarrier (transaction bytes) and
//        goes back on its `empty` mbarrier, which counts both compute
//        warpgroups of every CTA of the cluster (a multicast slice lands in
//        all of them).  Warpgroup w takes rows 64 w .. 64 w + 63 of the
//        slab (warpgroup 1 idles where the slab has no such row) and issues
//        wgmma.mma_async m64n128 with both operands in shared memory, two K
//        steps a stage: bfloat16 one m64n128k16 a step; float32 3xTF32,
//        three m64n128k8 products a step, small*big, big*small, big*big
//        (both parts split as cvt.rna splits them, at set-up), about 2^-22
//        relative a product against float32's 2^-24; never single-pass
//        TF32.  The two warpgroups issue in turns, so that one's products
//        run while the other hands back its stage and waits for the next.
//        The tensor cores' float32 sums round toward zero, so every 128 of
//        K their partial sums are added into a register sum with an
//        ordinary float32 add, which lands in phi at the tile's end.  A
//        cosine pass over each 256-column piece then turns the sums into
//        phi (cos_rr: straight-line, within cosf's error).  The parity row
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
//   element is computed once per launch and never leaves the SM.  Step 2's
//   theta piece, quarter sums and partial residual reuse the stage ring;
//   the copying thread starts the next slab's copies only after the last
//   cluster barrier of the slab, when every CTA of the cluster is past
//   them.  The sum over the slabs of a group runs in slab order (each
//   output element has one owner thread, which reads and adds it back);
//   where a row has more than one group, a short combine launch sums its
//   groups' partial gradients in group order.  No atomics anywhere: reruns
//   give the same bits.  Rows with mask 0 inside the live range are
//   computed, so a NaN there propagates (0 * NaN), as in the reference.
//
// Bound on the H100: operations.  At the main-path shape (31 rows, 30 of
// them raw, d = 784, q = 2000, c = 10) with l_max = 400 live client rows
// and u = 2400 parity rows the embedding is 2*30*400*784*2000 = 37.6 GFLOP
// and the two contractions (FFMA) 4*(30*400 + 2400)*2000*10 = 1.2 GFLOP:
// 0.25 ms for 3xTF32 at 495/3 TFLOP/s, 0.06 ms in bf16 at 989 TFLOP/s.
// With every row of L = 2400 live the embedding is 226 GFLOP.  L2 traffic:
// each CTA reads its 256 columns of Omega^T (0.8 MB, twice that as big and
// small parts) once per 112-row slab, 1.5 GB a call at the main shape.
// What bounds the main shape is the ring: 3 stages of 32 KB are what fits
// beside phi, and the stages' copies and hand-backs leave the tensor cores
// busy about three quarters of the embedding on an H100.
#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 384;      // warpgroups 0, 1 compute; 2 copies
constexpr int CONSUMERS = 256;    // the compute warpgroups' threads
constexpr int PIECE = 256;        // a CTA's columns come in 256-column pieces
constexpr int TILE_N = 128;       // columns of an embedding tile (wgmma N)
constexpr int WG_ROWS = 64;       // rows of a warpgroup's tile (wgmma M)
constexpr int MAX_SLAB = 128;     // rows of the stage's X tiles
constexpr int CMAX = 16;          // label columns per pass
constexpr int MAX_CLUSTER = 8;
constexpr int PHI_PAD = 4;        // keeps phi rows 16-byte aligned
constexpr int MAX_SMEM = 232448;  // a block's dynamic shared memory

// A stage holds 64 bytes of K: the big and small parts of up to 128 rows of
// X in 16-row slices (one TMA box each) and of the (128, K) tile of
// Omega^T, all 64-byte swizzled; every tile starts on a 1024-byte boundary
constexpr int K_BYTES = 64;
constexpr int SLICE_ROWS = 16;
constexpr int X_BYTES = MAX_SLAB * K_BYTES;
constexpr int B_BYTES = TILE_N * K_BYTES;
constexpr int STAGE_BYTES = 32768;
constexpr int MAX_STAGES = 3;
constexpr int FLUSH_K = 128;      // K between float32 adds of the products
static_assert(STAGE_BYTES == 2 * X_BYTES + 2 * B_BYTES, "stage layout");
static_assert(X_BYTES % 1024 == 0 && B_BYTES % 1024 == 0, "tile alignment");
static_assert(PIECE == CONSUMERS && PIECE % TILE_N == 0 && CMAX == 16 &&
                  MAX_SLAB == 2 * WG_ROWS,
              "one theta row a thread; 4 x 4 register blocks");

template <class T>
struct Args {
  CUtensorMap xb;  // X (big parts in float32): boxes of 16 rows x 64 bytes
  CUtensorMap xs;  // X small parts (float32 only)
  CUtensorMap tb;  // Omega^T (big parts in float32): 128 rows x 64 bytes
  CUtensorMap ts;  // Omega^T small parts (float32 only)
  const T* delta;
  const T* theta;
  const T* y;
  const float* mask;
  const T* pphi;
  float* out;      // g, or the partials of every (row, group) cluster
  int n_real, L, d, q, c, live_raw, live_par, R, QC, S_raw, S_par, stages;
  float scale;
};

template <class T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int K = 16;            // K a stage, two products' K
  static constexpr bool split = true;     // 3xTF32
  static constexpr CUtensorMapDataType tma = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Elem<bf16> {
  static constexpr int K = 32;
  static constexpr bool split = false;
  static constexpr CUtensorMapDataType tma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

// cos(x) within 1.5 ulp of float64's (cosf: 2 ulp), in straight-line code
// so that a thread's cosines interleave: q = x 2/pi rounded, r = x - q pi/2
// in three FMA steps (Cody-Waite), then the minimax polynomials of cos and
// sin on [-pi/4, pi/4] (Cephes' cosf and sinf) by the quadrant q mod 4;
// cosf past |x| = 8192 (the caller's branch, outside the straight line)
__device__ __forceinline__ float cos_rr(float x) {
  const float q = rintf(x * 0.636619772367581343f);
  float r = fmaf(q, -1.57079601e+00f, x);
  r = fmaf(q, -3.13916473e-07f, r);
  r = fmaf(q, -5.39030253e-15f, r);
  const float z = r * r;
  const float c =
      fmaf(fmaf(fmaf(fmaf(2.443315711809948e-5f, z, -1.388731625493765e-3f),
                     z, 4.166664568298827e-2f),
                z, -0.5f),
           z, 1.0f);
  const float sn = fmaf(
      fmaf(fmaf(-1.9515295891e-4f, z, 8.3321608736e-3f), z, -1.6666654611e-1f),
      z * r, r);
  const int k = static_cast<int>(q) & 3;
  const float v = k & 1 ? sn : c;
  return k == 1 || k == 2 ? -v : v;
}

// ------------------------------------------- mbarriers, TMA and clusters
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// arrive on the barrier at the same offset in CTA `cta` of the cluster
__device__ __forceinline__ void mbar_arrive_at(uint64_t* bar, unsigned cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(cta)
      : "memory");
}
// wait for the phase of parity `parity` to complete; a barrier that never
// completes (a fault, not a slow copy) traps after ~2^32 clocks instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  long long start = -1;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) start = now;
    if (now - start > (1LL << 32)) __trap();
  }
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
// the same box into the same offset of every CTA in `mask`, completing on
// each one's barrier at the offset of `bar`
__device__ __forceinline__ void tma_load_3d_multicast(
    void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
    unsigned short mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "h"(mask),
      "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// every warp of the CTA (barrier 1; the products' turns use 2 and 3)
__device__ __forceinline__ void cta_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}
// The compute warpgroups issue their products in turns (barrier 2: warpgroup
// 0 has issued, 3: warpgroup 1 has), so that one's products run while the
// other waits for its own and hands its stage back
__device__ __forceinline__ void take_turn(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(3 - wg), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void pass_turn(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 + wg), "n"(CONSUMERS)
               : "memory");
}

// ------------------------------------------------------------------ wgmma
// a (rows, 64-byte) K-major tile, 64-byte swizzled: 8-row groups 512 bytes
// apart (SBO), the leading offset unused (1), layout type 2 (64B swizzle);
// the product over its second 32 bytes of K starts 32 bytes in (+2)
__device__ __forceinline__ uint64_t b_desc(const void* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) |
         (2ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until the warpgroup's committed products are done
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from touching the accumulators across the async
// products (they are read and written by the tensor cores until the wait)
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                             \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                        \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                      \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                      \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                      \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                      \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                      \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_D8(i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),     \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_DREGS                                                  \
  WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), \
      WG_D8(48), WG_D8(56)

// d += a b over one warpgroup: a (64, K) of X and b (128, K) of Omega^T,
// both from shared memory; d[4 j + 2 h + e] is row 16 warp + lane / 4 +
// 8 h, column 8 j + 2 (lane % 4) + e of the 64 x 128 tile
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b,
                                      float) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_D
      ", %64, %65, p, 1, 1;\n}\n"
      : WG_DREGS
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b,
                                      bf16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_DREGS
      : "l"(a), "l"(b), "r"(1));
}

// ------------------------------------------------------- the embedding
// the stage goes back to every CTA of the cluster: threads 0, 16, 32, ...
// of the warpgroup each tell one (the products are the warpgroup's,
// complete for all its warps after its wait)
__device__ __forceinline__ void release(uint64_t* empty, int stage, int CL) {
  const int w = threadIdx.x % 128;
  if (w % 16 == 0 && w / 16 < CL) mbar_arrive_at(&empty[stage], w / 16);
}

// A warpgroup's 64 x 128 tile of X Omega at column joff of the CTA's part
// of phi, over d: each product's K (3xTF32 small*big, big*small, big*big,
// small terms first; or one bf16 product), two a stage, goes into `acc`, and
// every FLUSH_K of K `acc` is added into `sum` with a float32 add.  The
// sums land in phi (rows wrow, wrow + 8, columns 8 j + 2 (lane % 4) (+ 1)),
// the rows the slab has.  A warpgroup whose rows are all past the slab
// (`active` false) hands each stage back unread.
template <class T>
__device__ __forceinline__ void embed_tile(
    const Args<T>& a, unsigned char* smem, uint64_t* full, uint64_t* empty,
    int& stage, unsigned& phase, int nk, int CL, bool active, float* phi,
    int ldphi, int joff, int wrow) {
  constexpr int KS = Elem<T>::K;
  const int t4 = threadIdx.x % 4;
  const int arow = threadIdx.x / 128 * WG_ROWS;   // the tile's rows of X
  float acc[64];
  float sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.0f;
    sum[i] = 0.0f;
  }
  const int wg = threadIdx.x / 128;
  if (!active) {   // rows past the slab: the turns and the stages go by
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[stage], phase);
      take_turn(wg);
      pass_turn(wg);
      release(empty, stage, CL);
      if (++stage == a.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(&full[stage], phase);
    const unsigned char* st = smem + stage * STAGE_BYTES;
    const uint64_t xbig = b_desc(st + arow * K_BYTES);
    const uint64_t xsmall = b_desc(st + X_BYTES + arow * K_BYTES);
    const uint64_t big = b_desc(st + 2 * X_BYTES);
    const uint64_t small = b_desc(st + 2 * X_BYTES + B_BYTES);
    take_turn(wg);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if constexpr (Elem<T>::split) {
        wgmma(acc, xsmall + 2 * s, big + 2 * s, T());
        wgmma(acc, xbig + 2 * s, small + 2 * s, T());
        wgmma(acc, xbig + 2 * s, big + 2 * s, T());
      } else {
        wgmma(acc, xbig + 2 * s, big + 2 * s, T());
      }
    }
    wgmma_commit();
    pass_turn(wg);
    wgmma_wait_all();
    fence_acc(acc);
    release(empty, stage, CL);
    if (++stage == a.stages) {
      stage = 0;
      phase ^= 1;
    }
    if ((kt + 1) % (FLUSH_K / KS) == 0 || kt + 1 == nk) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sum[i] += acc[i];
        acc[i] = 0.0f;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow + 8 * h;
    if (r >= a.R) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(phi + r * ldphi + joff + 8 * j + 2 * t4) =
          make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
  }
}

// The copying thread's part of a 256-column piece at column n0 of q: for
// its two tiles, every stage of K once the cluster has handed the stage
// back: this CTA's 16-row slices of the slab's X, multicast to the cluster,
// and the piece's (128, K) tile of Omega^T (big and small parts of both in
// float32)
template <class T>
__device__ __forceinline__ void copy_piece(const Args<T>& a,
                                           unsigned char* smem,
                                           uint64_t* full, uint64_t* empty,
                                           int& stage, unsigned& phase,
                                           int nk, int CL, int rank, int b,
                                           int row0, int n_rows, int n0) {
  constexpr int KS = Elem<T>::K;
  constexpr int parts = Elem<T>::split ? 2 : 1;
  const int slices = (n_rows + SLICE_ROWS - 1) / SLICE_ROWS;
  const unsigned bytes = parts * (slices * SLICE_ROWS * K_BYTES + B_BYTES);
  const unsigned short all = static_cast<unsigned short>((1 << CL) - 1);
  for (int j0 = 0; j0 < PIECE; j0 += TILE_N) {
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_expect_tx(&full[stage], bytes);
      unsigned char* st = smem + stage * STAGE_BYTES;
      for (int i = rank; i < slices; i += CL) {
        for (int part = 0; part < parts; ++part) {
          void* dst = st + part * X_BYTES + i * SLICE_ROWS * K_BYTES;
          const CUtensorMap* map = part ? &a.xs : &a.xb;
          if (CL > 1)
            tma_load_3d_multicast(dst, map, &full[stage], kt * KS,
                                  row0 + i * SLICE_ROWS, b, all);
          else
            tma_load_3d(dst, map, &full[stage], kt * KS,
                        row0 + i * SLICE_ROWS, b);
        }
      }
      tma_load_2d(st + 2 * X_BYTES, &a.tb, &full[stage], kt * KS, n0 + j0);
      if (Elem<T>::split)
        tma_load_2d(st + 2 * X_BYTES + B_BYTES, &a.ts, &full[stage],
                    kt * KS, n0 + j0);
      if (++stage == a.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// the cosine over a 256-column piece of phi: thread t < 256 takes column
// joff + t down every row, 8 rows at a time; 0 past n_rows or q
template <class T>
__device__ __forceinline__ void cos_piece(const Args<T>& a, float* phi,
                                          int ldphi, int joff, int n0,
                                          int n_rows) {
  const int gj = n0 + threadIdx.x;
  const bool col = gj < a.q;
  const float dl = col ? to_float(a.delta[gj]) : 0.0f;
  float* p = phi + joff + threadIdx.x;
  for (int r0 = 0; r0 < a.R; r0 += 8) {   // R % 16 == 0
    float x[8];
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      x[u] = p[(r0 + u) * ldphi] + dl;
      v[u] = cos_rr(x[u]);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (fabsf(x[u]) > 8192.0f) v[u] = cosf(x[u]);
      p[(r0 + u) * ldphi] = col && r0 + u < n_rows ? a.scale * v[u] : 0.0f;
    }
  }
}

// ---------------------------------------------------------------- kernel
template <class T>
__global__ void __launch_bounds__(THREADS, 1)
    fused_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int KS = Elem<T>::K;
  const int R = a.R;
  const int QC = a.QC;
  const int S = a.stages;
  const int ldphi = QC + PHI_PAD;
  float* Rv = reinterpret_cast<float*>(smem + S * STAGE_BYTES);  // [R][CMAX]
  float* phi = Rv + R * CMAX;                                    // [R][ldphi]
  uint64_t* full = reinterpret_cast<uint64_t*>(phi + R * ldphi);
  uint64_t* empty = full + S;
  // step 2 reuses the ring: theta's piece, the quarter sums, and this
  // CTA's partial residual, which the cluster reads before the ring fills
  float* ths = reinterpret_cast<float*>(smem);                   // [256][CMAX]
  float* red = ths + PIECE * CMAX;                               // [4][R][CMAX]
  float* Ps = red + 4 * R * CMAX;                                // [R][CMAX]

  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int col0 = rank * QC;
  // cluster y: raw row y / S_raw, group y % S_raw; then the parity row's
  // S_par groups
  const int y = blockIdx.y;
  const int raw_clusters = a.n_real * a.S_raw;
  const bool raw = y < raw_clusters;
  const int b = raw ? y / a.S_raw : a.n_real;
  const int s = raw ? y % a.S_raw : y - raw_clusters;
  const int S_ = raw ? a.S_raw : a.S_par;
  const int q = a.q;
  const int c = a.c;
  const int live = raw ? a.live_raw : a.live_par;
  const int n_slabs = (live + R - 1) / R;
  const int nk = (a.d + KS - 1) / KS;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const int wg = t / 128;
  // a compute thread's first row of the slab in its warpgroup's tile
  const int wrow = wg * WG_ROWS + (warp % 4) * 16 + lane / 4;
  const bool direct = a.S_raw == 1 && a.S_par == 1;
  float* out = a.out + (long long)(direct ? b : y) * q * c;
  int stage = 0;   // the ring's position, for the copier and the computers
  unsigned phase = 0;

  if (t == 0) {
    if (smem_addr(smem) % 1024 != 0) __trap();   // the tiles' alignment
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CL * (CONSUMERS / 128));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // every CTA's barriers are set before a copy or an arrive reaches them
  cluster_sync();
  if (wg == 1) pass_turn(1);   // warpgroup 0 issues first

  bool first = true;
  for (int slab = s; slab < n_slabs; slab += S_) {
    const int row0 = slab * R;
    const int n_rows = min(R, live - row0);
    cta_sync();   // the previous slab is done with phi
    // 1. this CTA's (R, QC) part of phi
    if (raw) {
      const bool active = wg * WG_ROWS < n_rows;
      for (int p0 = 0; p0 < QC; p0 += PIECE) {
        if (t < CONSUMERS) {
          for (int j0 = p0; j0 < p0 + PIECE; j0 += TILE_N)
            embed_tile(a, smem, full, empty, stage, phase, nk, CL, active,
                       phi, ldphi, j0, wrow);
        } else if (t == CONSUMERS) {
          copy_piece(a, smem, full, empty, stage, phase, nk, CL, rank, b,
                     row0, n_rows, col0 + p0);
        }
        cta_sync();   // the piece's sums are in phi
        if (t < PIECE) cos_piece(a, phi, ldphi, p0, col0 + p0, n_rows);
      }
    } else {   // element t + THREADS i: 8 loads in flight a thread
      for (int e0 = t; e0 < R * QC; e0 += 8 * THREADS) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + u * THREADS;
          const int r = e / QC;
          const int gj = col0 + e % QC;
          v[u] = e < R * QC && r < n_rows && gj < q
                     ? to_float(a.pphi[(long long)(row0 + r) * q + gj])
                     : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + u * THREADS;
          if (e < R * QC) phi[e / QC * ldphi + e % QC] = v[u];
        }
      }
    }
    cta_sync();

    for (int c0 = 0; c0 < c; c0 += CMAX) {
      const int cw = min(CMAX, c - c0);
      // 2a. partial residual of this CTA's columns.  Thread (rg, cg) of
      //     warp (js, rp) sums rows 8 kb + rg (kb = rp, rp + 3, ...,
      //     kb < R/8) and label columns cg*4 .. +3 over the 64 columns
      //     js*64 .. +63 of each 256-column piece: float4 reads of phi and
      //     theta feed 16 FMA each.  The four column quarters are added in
      //     order through shared memory.
      {
        constexpr int KB = (MAX_SLAB / 8 + 2) / 3;   // row blocks a thread
        const int rg = lane % 8;
        const int cg = lane / 8;
        const int js = warp % 4;
        const int rp = warp / 4;
        float acc[KB][4];
#pragma unroll
        for (int k = 0; k < KB; ++k)
#pragma unroll
          for (int h = 0; h < 4; ++h) acc[k][h] = 0.0f;
        for (int p0 = 0; p0 < QC && col0 + p0 < q; p0 += PIECE) {
          if (t < PIECE) {   // theta's row col0 + p0 + t: 16 loads in flight
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
          cta_sync();
#pragma unroll 2
          for (int jj = 0; jj < PIECE / 4; jj += 4) {
            const int j = js * (PIECE / 4) + jj;
            float4 th[4];
#pragma unroll
            for (int h = 0; h < 4; ++h)
              th[h] = *reinterpret_cast<const float4*>(
                  ths + (j + h) * CMAX + cg * 4);
#pragma unroll
            for (int k = 0; k < KB; ++k) {
              const int r = 8 * (rp + 3 * k) + rg;
              if (r >= R) continue;
              const float4 ph =
                  *reinterpret_cast<const float4*>(phi + r * ldphi + p0 + j);
              const float pk[4] = {ph.x, ph.y, ph.z, ph.w};
#pragma unroll
              for (int h = 0; h < 4; ++h) {
                acc[k][0] = fmaf(pk[h], th[h].x, acc[k][0]);
                acc[k][1] = fmaf(pk[h], th[h].y, acc[k][1]);
                acc[k][2] = fmaf(pk[h], th[h].z, acc[k][2]);
                acc[k][3] = fmaf(pk[h], th[h].w, acc[k][3]);
              }
            }
          }
          cta_sync();   // the next piece restages theta
        }
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          const int r = 8 * (rp + 3 * k) + rg;
          if (r < R)
            *reinterpret_cast<float4*>(red + (js * R + r) * CMAX + cg * 4) =
                make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
        }
        cta_sync();
        for (int e = t; e < R * CMAX; e += THREADS)
          Ps[e] = ((red[e] + red[R * CMAX + e]) + red[2 * R * CMAX + e]) +
                  red[3 * R * CMAX + e];
      }
      // the stage ring's next copies (async proxy) come after these reads
      // and writes of it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // 2b. R = mask (sum over the cluster's CTAs in rank order - Y)
      cluster_sync();
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
      cluster_sync();   // every CTA has read the partials; Rv is complete
      // 3. phi^T R for this CTA's columns, added to the group's sum:
      //    thread (jg, cg) of the first 256 sums columns jg*4 .. +3 and
      //    label columns cg*4 .. +3 of each 256-column piece over the
      //    slab's rows, two float4 reads and 16 FMA a row
      if (t < PIECE) {
        const int cg = t % 4;
        const int jg = t / 4;
        for (int p0 = 0; p0 < QC && col0 + p0 < q; p0 += PIECE) {
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
  if (wg == 0) take_turn(0);   // the last turn warpgroup 1 passed
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

// the stage ring, the residual, phi, the barriers
long long smem_bytes(int R, int QC, int stages) {
  return (long long)stages * STAGE_BYTES + (long long)R * CMAX * 4 +
         (long long)R * (QC + PHI_PAD) * 4 + 16LL * stages;
}

bool plan_ok(int R, int QC, int stages) {
  return R >= SLICE_ROWS && R <= MAX_SLAB && R % SLICE_ROWS == 0 &&
         QC >= PIECE && QC % PIECE == 0 && stages >= 1 &&
         stages <= MAX_STAGES &&
         stages * STAGE_BYTES >= (PIECE + 5 * R) * CMAX * 4 &&
         smem_bytes(R, QC, stages) <= MAX_SMEM;
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
int max_clusters(int R, int cluster, int QC, int stages) {
  const long long smem = smem_bytes(R, QC, stages);
  if (!plan_ok(R, QC, stages) || cluster < 1 || cluster > MAX_CLUSTER)
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

// cuTensorMapEncodeTiled from the driver, through the runtime (no link
// against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a tiled map over `rank` dims (innermost first) with boxes of `box`;
// elements outside the tensor read as 0
bool encode(CUtensorMap* map, CUtensorMapDataType type, int rank,
            const void* ptr, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box,
            CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  const cuuint32_t step[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class T>
int entry(const T* x_big, const T* x_small, const T* omega_big,
          const T* omega_small,
          const T* delta, const T* theta, const T* y, const float* mask,
          const T* pphi, float* part, float* g, int rows, int n_real, int L,
          int d, int q, int c, int q_true, int live_raw, int live_par,
          int slab_rows, int cluster, int cols_per_cta, int groups_raw,
          int groups_par, int stages, cudaStream_t stream) {
  constexpr int es = sizeof(T);
  constexpr int KS = Elem<T>::K;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  const bool split = Elem<T>::split;
  if (!plan_ok(slab_rows, cols_per_cta, stages) || cluster < 1 ||
      cluster > MAX_CLUSTER || (long long)cluster * cols_per_cta < q ||
      (cluster - 1) * cols_per_cta >= q || groups_raw < 1 ||
      groups_par < 1 || (rows > n_real && pphi == nullptr) ||
      d % (16 / es) != 0 || !aligned(x_big) || !aligned(omega_big) ||
      (split && (x_small == nullptr || omega_small == nullptr ||
                 !aligned(x_small) || !aligned(omega_small))))
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a;
  // the four maps of the last call, reused while its tensors and shapes
  // stay (encoding one is a driver call)
  struct Maps {
    const void* ptr[4];
    int d, L, n_real, q;
    CUtensorMap xb, xs, tb, ts;
  };
  static thread_local Maps last = {};
  const void* ptr[4] = {x_big, split ? x_small : x_big, omega_big,
                        split ? omega_small : omega_big};
  if (last.ptr[0] != ptr[0] || last.ptr[1] != ptr[1] ||
      last.ptr[2] != ptr[2] || last.ptr[3] != ptr[3] || last.d != d ||
      last.L != L || last.n_real != n_real || last.q != q) {
    const cuuint64_t x_dims[3] = {static_cast<cuuint64_t>(d),
                                  static_cast<cuuint64_t>(L),
                                  static_cast<cuuint64_t>(n_real)};
    const cuuint64_t x_strides[2] = {static_cast<cuuint64_t>(d) * es,
                                     static_cast<cuuint64_t>(L) * d * es};
    const cuuint32_t x_box[3] = {KS, SLICE_ROWS, 1};   // 64 bytes of K
    const cuuint64_t b_dims[2] = {static_cast<cuuint64_t>(d),
                                  static_cast<cuuint64_t>(q)};
    const cuuint64_t b_strides[1] = {static_cast<cuuint64_t>(d) * es};
    const cuuint32_t b_box[2] = {KS, TILE_N};
    last.ptr[0] = nullptr;   // unusable until all four are encoded
    if (!encode(&last.xb, Elem<T>::tma, 3, ptr[0], x_dims, x_strides, x_box,
                CU_TENSOR_MAP_SWIZZLE_64B) ||
        !encode(&last.xs, Elem<T>::tma, 3, ptr[1], x_dims, x_strides, x_box,
                CU_TENSOR_MAP_SWIZZLE_64B) ||
        !encode(&last.tb, Elem<T>::tma, 2, ptr[2], b_dims, b_strides, b_box,
                CU_TENSOR_MAP_SWIZZLE_64B) ||
        !encode(&last.ts, Elem<T>::tma, 2, ptr[3], b_dims, b_strides, b_box,
                CU_TENSOR_MAP_SWIZZLE_64B))
      return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < 4; ++i) last.ptr[i] = ptr[i];
    last.d = d;
    last.L = L;
    last.n_real = n_real;
    last.q = q;
  }
  a.xb = last.xb;
  a.xs = last.xs;
  a.tb = last.tb;
  a.ts = last.ts;
  a.delta = delta;
  a.theta = theta;
  a.y = y;
  a.mask = mask;
  a.pphi = pphi;
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
  a.stages = stages;
  a.scale = static_cast<float>(std::sqrt(2.0 / q_true));
  const bool direct = groups_raw == 1 && groups_par == 1;
  if (!direct && part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a.out = direct ? g : part;
  const long long smem = smem_bytes(slab_rows, cols_per_cta, stages);
  const int clusters = n_real * groups_raw + (rows > n_real ? groups_par : 0);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster, clusters, smem, stream, attr);
  err = cudaLaunchKernelEx(&cfg, fused_kernel<T>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!direct) {
    const long long qc = (long long)q * c;
    const long long n = rows * qc;
    combine_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                     stream>>>(part, g, n, qc, n_real, groups_raw,
                               groups_par);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_big / x_small: (n_real, L, d) X and omega_big / omega_small: (q, d)
// Omega^T, each as its big and small TF32 parts (ops.prepare_rff_operands),
// delta: (q,), theta: (q, c), y: (rows, L, c), mask: (rows, L) float32,
// pphi: (L, q) or nullptr (then rows == n_real); part: (n_real * groups_raw
// + groups_par, q, c) float32 scratch (nullptr when both group counts are
// 1), g: (rows, q, c) float32; contiguous, 16-byte aligned, d a multiple of
// 4, on the device of `stream`.  The launch plan (slab_rows a multiple of
// 16 up to 128, cluster <= 8 CTAs of cols_per_cta columns each, a multiple
// of 256, the groups of slabs of a raw row and of the parity row, and the
// stages of the copy ring) comes from ops.fused_plan.  Returns the first
// failing call's cudaError_t (cudaErrorInvalidValue for a plan or a layout
// the kernel does not take).
extern "C" int rff_linreg_grad_masked_f32(
    const float* x_big, const float* x_small, const float* omega_big,
    const float* omega_small, const float* delta, const float* theta,
    const float* y, const float* mask, const float* pphi, float* part,
    float* g, int rows, int n_real, int L, int d, int q, int c, int q_true,
    int live_raw, int live_par, int slab_rows, int cluster, int cols_per_cta,
    int groups_raw, int groups_par, int stages, cudaStream_t stream) {
  return entry(x_big, x_small, omega_big, omega_small, delta, theta, y, mask,
               pphi, part,
               g, rows, n_real, L, d, q, c, q_true, live_raw, live_par,
               slab_rows, cluster, cols_per_cta, groups_raw, groups_par,
               stages, stream);
}

// The same with bfloat16 X and Omega^T (x_big, omega_big; the small parts
// unused), delta, theta, y and pphi; d a multiple of 8.
extern "C" int rff_linreg_grad_masked_bf16(
    const __nv_bfloat16* x_big, const __nv_bfloat16* x_small,
    const __nv_bfloat16* omega_big, const __nv_bfloat16* omega_small,
    const __nv_bfloat16* delta,
    const __nv_bfloat16* theta, const __nv_bfloat16* y, const float* mask,
    const __nv_bfloat16* pphi, float* part, float* g, int rows, int n_real,
    int L, int d, int q, int c, int q_true, int live_raw, int live_par,
    int slab_rows, int cluster, int cols_per_cta, int groups_raw,
    int groups_par, int stages, cudaStream_t stream) {
  return entry(x_big, x_small, omega_big, omega_small, delta, theta, y, mask,
               pphi, part,
               g, rows, n_real, L, d, q, c, q_true, live_raw, live_par,
               slab_rows, cluster, cols_per_cta, groups_raw, groups_par,
               stages, stream);
}

// The number of clusters of `cluster` CTAs, each holding a (slab_rows,
// cols_per_cta) part of phi and `stages` copy stages, that the current
// device holds at once (cudaOccupancyMaxActiveClusters); a negative value
// is a cudaError_t.
extern "C" int rff_linreg_grad_max_clusters(int bf16, int slab_rows,
                                            int cluster, int cols_per_cta,
                                            int stages) {
  return bf16 ? max_clusters<__nv_bfloat16>(slab_rows, cluster, cols_per_cta,
                                            stages)
              : max_clusters<float>(slab_rows, cluster, cols_per_cta,
                                    stages);
}
