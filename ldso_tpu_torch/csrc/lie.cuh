// SE(3) expressions of the kernels that make their own slot tables from the
// window's state (ba.cu, trace.cu) and of the motion prediction
// (predict.cu), in torch's operation order on the card, so that their
// results equal the plain versions' bit for bit: lie.se3_exp (over so3_exp,
// _sinc_coeffs and so3_left_jacobian), alone or times a pose, lie.se3_log,
// lie.se3_inverse, and the products of two poses. torch's small matrix
// products run in cuBLAS, which accumulates a dot product by fused
// multiply-adds in index order from zero, in one chain or, for some shapes,
// in two chains added (Rules); its 3-value sum (torch.sum of phi * phi)
// adds (x0 + x2) + x1. Both are written out (dot3, dot4): a file that
// includes this header is built with -fmad=false, so that nvcc contracts
// nothing else. A pose is held as its rows 0-2, 4 columns each (row 3 is
// (0, 0, 0, 1)).

#pragma once

#include <math.h>

namespace lie {

// a dot product as cuBLAS accumulates it: fused multiply-adds in index
// order from +0 (the start shows only in the sign of an exact zero); or,
// ``split``, the terms 0-1 and the rest in two such chains, then added
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2, float b2,
                                      bool split = false) {
  const float h = fmaf(a1, b1, fmaf(a0, b0, 0.f));
  return split ? h + fmaf(a2, b2, 0.f) : fmaf(a2, b2, h);
}

__device__ __forceinline__ float dot4(float a0, float b0, float a1, float b1, float a2, float b2,
                                      float a3, float b3, bool split = false) {
  const float h = fmaf(a1, b1, fmaf(a0, b0, 0.f));
  return split ? h + fmaf(a3, b3, fmaf(a2, b2, 0.f)) : fmaf(a3, b3, fmaf(a2, b2, h));
}

// which of torch's small products cuBLAS (CUDA 12.8, H100) sums split, read
// off its results (tests/test_torch_ba_kernel.py and
// tests/test_torch_trace_kernel.py hold the tables to the plain versions at
// F = 1, 3, 10, 32):
//   slot: the [F, 4, 4] batched products (se3_exp times T_eval, the
//     inverse's R^T t) split for a batch of one matrix (F = 1), else chain;
//   vrho: the exponential's V rho always splits;
//   rel:  the einsum of T_t and T_h^-1 over the window's slots (ba.cu's
//     "tij,hjk->htik", trace.cu's "fij,hjk->fhik": one 4F x 4 by 4 x 4F
//     product) splits at F <= 4;
//   adj:  hat(t) R of the [F, F] adjoints splits at F = 1;
//   hn:   trace.cu's T_new_cw @ T_all^-1, a [4, 4] by an [F, 4, 4] (a batch
//     of F products of the broadcast T_new_cw), splits at F = 1
struct Rules {
  bool slot, vrho, rel, adj, hn;
};

__device__ __forceinline__ Rules rules(int F) {
  return Rules{F == 1, true, F <= 4, F == 1, F == 1};
}

// rows 0-2 of an SE(3) inverse (lie.se3_inverse: [R^T, -(R^T t)]) from
// rows 0-2 of T
__device__ __forceinline__ void inverse34(const float* T, float* out, bool split) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out[4 * i + j] = T[4 * j + i];
    out[4 * i + 3] = -dot3(T[i], T[3], T[4 + i], T[7], T[8 + i], T[11], split);
  }
}

// rows 0-2 of A B: A's rows 0-2, B's rows 0-2 (B's row 3 (0, 0, 0, 1))
__device__ __forceinline__ void mul34(const float* A, const float* B, float* out, bool split) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[4 * i + k] = dot4(A[4 * i], B[k], A[4 * i + 1], B[4 + k], A[4 * i + 2], B[8 + k],
                            A[4 * i + 3], k == 3 ? 1.f : 0.f, split);
  }
}

// rows 0-2 of se3_exp(xi[0:6]) Te, Te a whole [4, 4] pose (its row 3 read)
__device__ __forceinline__ void exp_times34(const float* xi, const float* Te, const Rules& ru,
                                            float* out) {
  const float r0 = xi[0], r1 = xi[1], r2 = xi[2], p0 = xi[3], p1 = xi[4], p2 = xi[5];
  const float q0 = p0 * p0, q1 = p1 * p1, q2 = p2 * p2;
  const float tsq = (q0 + q2) + q1;                     // torch.sum(phi * phi, -1) on the card
  const bool small = tsq < 1e-8f;
  const float safe = small ? 1.f : tsq;
  const float th = sqrtf(safe);
  const float sn = sinf(th), cs = cosf(th);
  // x / k for a python float k is x * (1 / k) in torch's kernel
  const float A = small ? 1.f - tsq * (1.f / 6.f) : sn / th;
  const float B = small ? 0.5f - tsq * (1.f / 24.f) : (1.f - cs) / safe;
  const float C = small ? (1.f / 6.f) - tsq * (1.f / 120.f) : (th - sn) / (safe * th);
  const float K[3][3] = {{0.f, -p2, p1}, {p2, 0.f, -p0}, {-p1, p0, 0.f}};
  float R[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float kk = dot3(K[i][0], K[0][j], K[i][1], K[1][j], K[i][2], K[2][j], ru.slot);
      const float e = i == j ? 1.f : 0.f;
      R[i][j] = (e + A * K[i][j]) + B * kk;
      V[i][j] = (e + B * K[i][j]) + C * kk;
    }
  }
  float t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = dot3(V[i][0], r0, V[i][1], r1, V[i][2], r2, ru.vrho);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[4 * i + k] = dot4(R[i][0], Te[k], R[i][1], Te[4 + k], R[i][2], Te[8 + k], t[i],
                            Te[12 + k], ru.slot);
  }
}

// The motion prediction (predict.cu) takes products and reductions of one
// pose, not of a batch of slots; their orders on the card, read off the
// same way (scripts/torch_table_rules.py, "predict" lines):
//   inv1: se3_inverse's R^T t of one pose, a [3, 3] by [3, 1] mm;
//   mul1: the product of two [4, 4] poses;
//   kk1:  so3_left_jacobian's K K of one rotation vector, a [3, 3] mm;
// torch.linalg.norm of a quaternion adds its rounded squares
// (x0 + x2) + (x1 + x3), and torch.sum of three rounded squares
// (x0 + x2) + x1, as for the slots.
struct OneRules {
  bool inv1, mul1, kk1;
};

constexpr OneRules kOne{true, true, true};

// rows 0-2 of A B: A's rows 0-2, B a whole [4, 4] pose (its row 3 read)
__device__ __forceinline__ void mul4(const float* A, const float* B, float* out, bool split) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[4 * i + k] = dot4(A[4 * i], B[k], A[4 * i + 1], B[4 + k], A[4 * i + 2], B[8 + k],
                            A[4 * i + 3], B[12 + k], split);
  }
}

// rows 0-2 of se3_exp(xi[0:6]) (lie.se3_exp: so3_exp, so3_left_jacobian,
// V rho; exp_times34's expressions without the product by T_eval)
__device__ __forceinline__ void exp34(const float* xi, const Rules& ru, float* out) {
  const float r0 = xi[0], r1 = xi[1], r2 = xi[2], p0 = xi[3], p1 = xi[4], p2 = xi[5];
  const float q0 = p0 * p0, q1 = p1 * p1, q2 = p2 * p2;
  const float tsq = (q0 + q2) + q1;
  const bool small = tsq < 1e-8f;
  const float safe = small ? 1.f : tsq;
  const float th = sqrtf(safe);
  const float sn = sinf(th), cs = cosf(th);
  const float A = small ? 1.f - tsq * (1.f / 6.f) : sn / th;
  const float B = small ? 0.5f - tsq * (1.f / 24.f) : (1.f - cs) / safe;
  const float C = small ? (1.f / 6.f) - tsq * (1.f / 120.f) : (th - sn) / (safe * th);
  const float K[3][3] = {{0.f, -p2, p1}, {p2, 0.f, -p0}, {-p1, p0, 0.f}};
  float V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float kk = dot3(K[i][0], K[0][j], K[i][1], K[1][j], K[i][2], K[2][j], ru.slot);
      const float e = i == j ? 1.f : 0.f;
      out[4 * i + j] = (e + A * K[i][j]) + B * kk;
      V[i][j] = (e + B * K[i][j]) + C * kk;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[4 * i + 3] = dot3(V[i][0], r0, V[i][1], r1, V[i][2], r2, ru.vrho);
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }

// se3_log of a pose's rows 0-2 in torch's order (lie.se3_log): the
// quaternion of lie.matrix_to_quat (the first largest of its four
// candidates, normalized), lie.so3_log, so3_left_jacobian of its phi
// (kk1) and Cramer's solve33 for rho. xi = [rho, phi]. A division by a
// python float k is a product by 1 / k, and k / x is (1 / x) k, as torch
// computes them.
__device__ __forceinline__ void log34(const float* T, float* xi) {
  const float m00 = T[0], m01 = T[1], m02 = T[2];
  const float m10 = T[4], m11 = T[5], m12 = T[6];
  const float m20 = T[8], m21 = T[9], m22 = T[10];
  const float tiny = static_cast<float>(1e-12);
  const float tr = (m00 + m11) + m22;
  const float qw = sqrtf(clamp_min(1.f + tr, tiny)) * 0.5f;
  const float qx = sqrtf(clamp_min(((1.f + m00) - m11) - m22, tiny)) * 0.5f;
  const float qy = sqrtf(clamp_min(((1.f - m00) + m11) - m22, tiny)) * 0.5f;
  const float qz = sqrtf(clamp_min(((1.f - m00) - m11) + m22, tiny)) * 0.5f;
  int c = 0;
  float top = qw;
  if (qx > top) { c = 1; top = qx; }
  if (qy > top) { c = 2; top = qy; }
  if (qz > top) c = 3;
  float q[4];
  if (c == 0) {
    const float d = 4.f * clamp_min(qw, tiny);
    q[0] = (m21 - m12) / d; q[1] = (m02 - m20) / d; q[2] = (m10 - m01) / d; q[3] = qw;
  } else if (c == 1) {
    const float d = 4.f * clamp_min(qx, tiny);
    q[0] = qx; q[1] = (m01 + m10) / d; q[2] = (m02 + m20) / d; q[3] = (m21 - m12) / d;
  } else if (c == 2) {
    const float d = 4.f * clamp_min(qy, tiny);
    q[0] = (m01 + m10) / d; q[1] = qy; q[2] = (m12 + m21) / d; q[3] = (m02 - m20) / d;
  } else {
    const float d = 4.f * clamp_min(qz, tiny);
    q[0] = (m02 + m20) / d; q[1] = (m12 + m21) / d; q[2] = qz; q[3] = (m10 - m01) / d;
  }
  const float nq = sqrtf((q[0] * q[0] + q[2] * q[2]) + (q[1] * q[1] + q[3] * q[3]));
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / nq;
  // so3_log: the quaternion with w >= 0
  const float sgn = q[3] < 0.f ? -1.f : 1.f;
  const float v[3] = {q[0] * sgn, q[1] * sgn, q[2] * sgn};
  const float w = q[3] * sgn;
  const float nsq = (v[0] * v[0] + v[2] * v[2]) + v[1] * v[1];
  const bool small = nsq < static_cast<float>(1e-16);
  const float n = sqrtf(small ? 1.f : nsq);
  const float s_small = ((1.f / clamp_min(w, tiny)) * 2.f)
                        * (1.f - nsq / (3.f * clamp_min(w * w, tiny)));
  const float s_big = (2.f * atan2f(n, w)) / n;
  const float scale = small ? s_small : s_big;
  const float p0 = scale * v[0], p1 = scale * v[1], p2 = scale * v[2];
  // so3_left_jacobian(phi)
  const float tsq = (p0 * p0 + p2 * p2) + p1 * p1;
  const bool tsmall = tsq < 1e-8f;
  const float safe = tsmall ? 1.f : tsq;
  const float th = sqrtf(safe);
  const float B = tsmall ? 0.5f - tsq * (1.f / 24.f) : (1.f - cosf(th)) / safe;
  const float C = tsmall ? (1.f / 6.f) - tsq * (1.f / 120.f) : (th - sinf(th)) / (safe * th);
  const float K[3][3] = {{0.f, -p2, p1}, {p2, 0.f, -p0}, {-p1, p0, 0.f}};
  float a[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float kk = dot3(K[i][0], K[0][j], K[i][1], K[1][j], K[i][2], K[2][j], kOne.kk1);
      a[i][j] = ((i == j ? 1.f : 0.f) + B * K[i][j]) + C * kk;
    }
  }
  // solve33(V, t)
  const float c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
  const float c01 = a[0][2] * a[2][1] - a[0][1] * a[2][2];
  const float c02 = a[0][1] * a[1][2] - a[0][2] * a[1][1];
  const float c10 = a[1][2] * a[2][0] - a[1][0] * a[2][2];
  const float c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0];
  const float c12 = a[0][2] * a[1][0] - a[0][0] * a[1][2];
  const float c20 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
  const float c21 = a[0][1] * a[2][0] - a[0][0] * a[2][1];
  const float c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0];
  const float det = (a[0][0] * c00 + a[0][1] * c10) + a[0][2] * c20;
  const float inv_det = 1.f / det;
  const float b0 = T[3], b1 = T[7], b2 = T[11];
  xi[0] = ((c00 * b0 + c01 * b1) + c02 * b2) * inv_det;
  xi[1] = ((c10 * b0 + c11 * b1) + c12 * b2) * inv_det;
  xi[2] = ((c20 * b0 + c21 * b1) + c22 * b2) * inv_det;
  xi[3] = p0;
  xi[4] = p1;
  xi[5] = p2;
}

}  // namespace lie
