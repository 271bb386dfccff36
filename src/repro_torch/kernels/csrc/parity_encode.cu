// All-clients local parity encoding (paper eq. 19) on Hopper.
//
//   parity_b = G_b diag(w_b) X_b      G_b: (u, l), w_b: (l,), X_b: (l, q)
//
// Replaces the Pallas TPU kernel `parity_encode_batched` in
// src/repro/kernels/parity_encode.py (grid (n, U/bu, Q/bq, L/bl), diag(w)
// fused into the generator tile).
//
// Bound on the H100: operations for the features, bytes for the labels.
// At the main-path shape n = 30, u = 2400, l = 400, q = 2000 it does
// 2*n*u*l*q = 115 GFLOP against 787 MB moved (about 146 FLOP per byte,
// above the float32 ridge of 20); the label encode (q = c = 10) does
// 0.6 GFLOP against 118 MB and is bound by reading G.
//
// Design: the shared tiled float32 GEMM (tiled_gemm.cuh) with one block per
// (client, 64-row u tile, 64-column q tile) and a loop over l.  w scales
// the G tile as it is loaded into shared memory, so G diag(w) is never
// written out.  Float32 FFMA, no TF32; wgmma/TMA is later work.
#include "tiled_gemm.cuh"

namespace {

struct Identity {
  __device__ float operator()(int, float acc) const { return acc; }
};

}  // namespace

// g: (n, u, l), w: (n, l), x: (n, l, q), out: (n, u, q); float32,
// contiguous, on the device of `stream`.  Returns the launch's cudaError_t.
extern "C" int parity_encode_batched_f32(const float* g, const float* w,
                                         const float* x, float* out, int n,
                                         int u, int l, int q,
                                         cudaStream_t stream) {
  return tiled::launch_gemm(
      g, w, x, out, n, u, q, l, static_cast<long long>(u) * l,
      static_cast<long long>(l), static_cast<long long>(l) * q,
      static_cast<long long>(u) * q, Identity{}, stream);
}
