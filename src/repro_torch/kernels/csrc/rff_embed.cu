// Random Fourier feature embedding (paper eq. 18) on Hopper.
//
//   out[i, s] = sqrt(2 / q_true) * cos(sum_k x[i, k] * omega[k, s] + delta[s])
//
// Replaces the Pallas TPU kernel `rff_embed` in src/repro/kernels/rff_embed.py
// (grid (M/bm, Q/bq, D/bk), cosine fused into the last K step).
//
// Bound on the H100: operations.  At the main-path shape (12000, 784) x
// (784, 2000) it does 2*m*d*q = 38 GFLOP against 140 MB of inputs and
// output, about 270 FLOP per byte, far above the float32 ridge of
// 67 TFLOP/s over 3.35 TB/s (20 FLOP per byte).
//
// Design: the shared tiled float32 GEMM (tiled_gemm.cuh), with the bias add,
// cosine and scale fused into the store, so the (m, q) product never goes
// to device memory before the cosine.  Full-precision cosf, not __cosf: the
// argument x.omega + delta spans several units at d = 784, where the fast
// intrinsic loses accuracy.  No tensor cores yet (the reference is float32;
// TF32 would keep about three digits): a wgmma/TMA version is later work.
#include <cmath>

#include "tiled_gemm.cuh"

namespace {

struct CosEpilogue {
  const float* delta;
  float scale;
  __device__ float operator()(int j, float acc) const {
    return scale * cosf(acc + delta[j]);
  }
};

}  // namespace

// x: (m, d), omega: (d, q), delta: (q,), out: (m, q); float32, contiguous,
// on the device of `stream`.  Returns the launch's cudaError_t.
extern "C" int rff_embed_f32(const float* x, const float* omega,
                             const float* delta, float* out, int m, int d,
                             int q, int q_true, cudaStream_t stream) {
  const CosEpilogue epi{delta,
                        static_cast<float>(std::sqrt(2.0 / q_true))};
  return tiled::launch_gemm(x, nullptr, omega, out, 1, m, q, d, 0, 0, 0, 0,
                            epi, stream);
}
