// The motion prediction of the per-frame program (K7): the constant-velocity
// pose and its tracker hypotheses, one launch a tracked frame.
//
// predict_kernel replaces the eager chain of frame_step._track_pyr's
// prediction, T_cv = (T_last T_prelast^-1) T_last and
// tracker.motion_hypotheses(T_cv, num), a few hundred torch launches on
// 4 x 4 matrices; the JAX package runs the same chain inside its per-frame
// XLA program (ldso_tpu/tracker.py::motion_hypotheses). Its plain version
// is that chain, tracker.predict_hypotheses_torch.
//
// Contract, for num >= 1: hypothesis k of [num, 4, 4] is se3_exp of
//   k = 0, 1, 2, 3: xi, 0.5 xi, 2 xi, 0;
//   k = 4 .. 21:    xi + delta[k - 4], the 18 small rotations of
//                   tracker._hypothesis_deltas in its order (kDeltaSign);
//   k >= 22:        xi;
// with xi = se3_log(T_cv), row 3 written (0, 0, 0, 1).
//
// Design: the work is ~5 kflop on under 2 KB, so what matters is one launch
// and no round trip. One CTA of one warp: every thread takes the
// prediction and the logarithm itself (the same bits in every lane, no
// barrier and no shared memory), then thread k makes hypotheses k,
// k + 32, ... and writes each as a whole 4 x 4.
//
// Every expression keeps torch's operation order on the card (lie.cuh:
// inverse34, mul4, log34, exp34), so the output is the plain chain's bit
// for bit; the file is built with -fmad=false (kernels/predict.py), so nvcc
// contracts nothing, and the small matrix products are written out as
// cuBLAS sums them (lie.cuh's OneRules and Rules).
//
// Plain C interface (bound with ctypes): the entry point launches on the
// given stream, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>

#include "lie.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kDeltas = 18;

// the sign (+1, -1, or 0 for none) of each rotation axis in
// tracker._hypothesis_deltas' rows: each axis at +-rot, then each pair of
// axes (0, 1), (0, 2), (1, 2) at (+-rot, +-rot)
__constant__ signed char kDeltaSign[kDeltas][3] = {
    {1, 0, 0},  {-1, 0, 0},  {0, 1, 0},  {0, -1, 0},  {0, 0, 1},  {0, 0, -1},
    {1, 1, 0},  {1, -1, 0},  {-1, 1, 0}, {-1, -1, 0}, {1, 0, 1},  {1, 0, -1},
    {-1, 0, 1}, {-1, 0, -1}, {0, 1, 1},  {0, 1, -1},  {0, -1, 1}, {0, -1, -1}};

__global__ void __launch_bounds__(kThreads)
    predict_kernel(const float* __restrict__ T_last, const float* __restrict__ T_prelast, int num,
                   float* __restrict__ out) {
  float Tl[16], Tp[12], inv[16], vel[12], cv[12], xi[6];
#pragma unroll
  for (int i = 0; i < 16; ++i) Tl[i] = T_last[i];
#pragma unroll
  for (int i = 0; i < 12; ++i) Tp[i] = T_prelast[i];
  // lie.se3_inverse's rows 0-2, and its row 3 as lie.se3 makes it
  lie::inverse34(Tp, inv, lie::kOne.inv1);
  inv[12] = 0.f;
  inv[13] = 0.f;
  inv[14] = 0.f;
  inv[15] = 1.f;
  lie::mul4(Tl, inv, vel, lie::kOne.mul1);
  lie::mul4(vel, Tl, cv, lie::kOne.mul1);
  lie::log34(cv, xi);
  const lie::Rules ru = lie::rules(num);
  // python's float 0.02, as torch.tensor(rows, dtype=float32) rounds it
  const float rot = static_cast<float>(0.02);
  for (int k = threadIdx.x; k < num; k += kThreads) {
    float h[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      if (k == 1) {
        h[c] = 0.5f * xi[c];
      } else if (k == 2) {
        h[c] = 2.f * xi[c];
      } else if (k == 3) {
        h[c] = 0.f;
      } else if (k >= 4 && k < 4 + kDeltas) {
        h[c] = xi[c] + (c < 3 ? 0.f : static_cast<float>(kDeltaSign[k - 4][c - 3]) * rot);
      } else {
        h[c] = xi[c];
      }
    }
    float E[12];
    lie::exp34(h, ru, E);
    float* o = out + 16 * k;
#pragma unroll
    for (int i = 0; i < 12; ++i) o[i] = E[i];
    o[12] = 0.f;
    o[13] = 0.f;
    o[14] = 0.f;
    o[15] = 1.f;
  }
}

}  // namespace

extern "C" int ldso_predict_hypotheses(const void* T_last, const void* T_prelast, int num,
                                       void* out, void* stream) {
  if (num < 1) return static_cast<int>(cudaErrorInvalidValue);
  predict_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(T_last), static_cast<const float*>(T_prelast), num,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
