// Random Fourier feature embedding (paper eq. 18) on Hopper.
//
//   out[i, s] = sqrt(2 / q_true) * cos(sum_k x[i, k] * omega[k, s] + delta[s])
//
// Replaces the Pallas TPU kernel `rff_embed` in src/repro/kernels/rff_embed.py
// (grid (M/bm, Q/bq, D/bk), cosine fused into the last K step).
//
// Bound on the H100: operations.  At the main-path shape (12000, 784) x
// (784, 2000) it does 2*m*d*q = 37.6 GFLOP against 140 MB of inputs and
// output.  Taken as 3xTF32 on the tensor cores (three TF32 products for each
// float32 one, 495 TFLOP/s dense) the least time is 0.228 ms; the bytes
// alone take 0.042 ms.
//
// Design: the float32 tile of tc_gemm_f32.cuh (the parity encode's), with
// A = x, B = omega and no scale of A, in 3xTF32 with float32 adds every 16
// K steps (never single-pass TF32: the reference is float32), and the bias
// add, cosine and scale applied to each finished value at the store, so
// the (m, q) product never goes to device memory before the cosine.
// Full-precision cosf, not __cosf: the argument x.omega + delta spans
// several units at d = 784, where the fast intrinsic loses accuracy.
#include <cmath>

#include "tc_gemm_f32.cuh"

namespace {

struct CosEpilogue {
  const float* delta;
  float scale;
  __device__ __forceinline__ float operator()(int j, float acc) const {
    return scale * cosf(acc + __ldg(delta + j));
  }
};

}  // namespace

// x: (m, d), omega: (d, q), delta: (q,), out: (m, q); float32, contiguous,
// on the device of `stream`.  Returns the launch's cudaError_t.
extern "C" int rff_embed_f32(const float* x, const float* omega,
                             const float* delta, float* out, int m, int d,
                             int q, int q_true, cudaStream_t stream) {
  if (m < 1 || d < 1 || q < 1 || q_true < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const CosEpilogue epi{delta,
                        static_cast<float>(std::sqrt(2.0 / q_true))};
  return tc_gemm::launch<false>(x, nullptr, omega, out, 1, m, d, q, epi,
                                stream);
}
