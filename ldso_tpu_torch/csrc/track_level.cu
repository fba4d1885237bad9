// One pyramid level of the coarse tracker: the whole Levenberg-Marquardt
// loop of K lanes (motion hypotheses) in ONE launch.
//
// Replaces the XLA program of ldso_tpu/tracker.py::track_level (:165-224, a
// lax.while_loop over _level_system / _level_residuals :105-162, vmapped
// over the hypotheses at :255); the JAX package has no Pallas source for
// it. Contract, per lane, that of tracker.track_level_torch:
//   per point: project through the level intrinsics under (T, a, b);
//     ok_z = z > 1e-6; in = in_bounds(uv', w, h, 2) & ok_z & valid;
//     (I, dx, dy) = clamped bilinear sample of the [H, W, 3] stack at uv'
//     (at (2, 2) when not in); r = I - e^a color - b; saturated = |r| >
//     cutoff; Huber weight; omega = in & !saturated ? weight : 0; the
//     8-vector J = [dI/dxi (6), -e^a color, -1];
//   per evaluation: H = sum omega J J^T, b = sum omega r J, E = sum omega
//     r^2, n_ok = #(omega > 0), n_in = #in, n_sat = #(saturated & in);
//   per iteration: Hd = H with diag * (1 + lam) + 1e-4 I max(tr H / 8,
//     1e-6); step = -Hd^-1 b; T' = exp(step[:6]) T; ab' = ab + step[6:];
//     one evaluation at (T', ab'); accept iff E'/max(n_ok', 1) <
//     E/max(n_ok, 1), then the state and its system are carried; lam ->
//     max(lam lam_success, 1e-5) on accept, lam lam_fail otherwise;
//     done = (accept & max|step| < step_eps) | lam > 1e3;
//   the lane's loop ends on done or after `iters` iterations.
// The corner-packed gather of kernels/interp.pack_corners is a TPU layout
// trick: here the four corners are read directly (the same values).
//
// What bounds it on Hopper: neither bytes nor arithmetic. A frame's five
// levels read ~4.9 MB of (I, dx, dy) stacks and do ~272k point
// evaluations of ~250 flops (a few microseconds at the card's rates); the
// time is the chain of up to 12 + 12 + 50 + 30 + 16 dependent iterations,
// each a block-wide reduction and a serial 8x8 solve. The design keeps that
// chain on the card and short:
//   * one block per lane and the lane's whole loop inside the block: no
//     launch, no host round trip per iteration, no grid-wide sync;
//   * per evaluation each thread takes points tid, tid + blockDim, ... and
//     keeps the 36 upper-triangle H sums, 8 b sums and E in registers;
//   * the block reduction runs in a fixed order (shuffles down each warp,
//     the warps' partials summed in warp order by one thread per value), so
//     a lane's result repeats bit for bit from run to run;
//   * the damped 8x8 solve is an LU factorisation with partial pivoting in
//     float32 (what LAPACK's getrf/getrs do behind the reference's
//     jnp.linalg.solve and torch.linalg.solve_ex), on thread 0 in shared
//     memory, followed there by the SE(3) exponential (math/lie.py's
//     small-angle branches: _sinc_coeffs, so3_left_jacobian, eps 1e-8) and
//     the accept / lambda / done logic;
//   * the level intrinsics are read through a pointer (a device tensor) and
//     the iteration cap is an argument; the lane stops early on its own
//     done flag, so nothing is read back by the host.
//
// Plain C interface (bound with ctypes): the entry point launches on the
// given stream, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kNH = 36;              // upper triangle of the 8x8 H, row by row
constexpr int kNB = kNH;             // then b (8)
constexpr int kNE = kNH + 8;         // then E
constexpr int kNV = kNH + 8 + 1;
constexpr float kLieEps = 1e-8f;     // math/lie.py _EPS

struct Params {
  const float* img3;                 // [H, W, 3] (I, dx, dy)
  int H, W;
  const float* uv;                   // [N, 2]
  const float* idepth;               // [N]
  const float* color;                // [N]
  const unsigned char* valid;        // [N] bool
  int N;
  const float* T0;                   // [K, 4, 4]
  const float* ab0;                  // [K, 2]
  const float* intr;                 // [4] fx, fy, cx, cy of this level
  int iters;
  float cutoff, huber, lam0, lam_success, lam_fail, step_eps;
  float* T_out;                      // [K, 4, 4]
  float* ab_out;                     // [K, 2]
  float* rmse_out;                   // [K]
  int64_t* n_ok_out;                 // [K]
  int64_t* n_in_out;
  int64_t* n_sat_out;
  int32_t* n_iter_out;               // [K] iterations run
  int64_t* n_ok_sum_out;             // [K] n_ok summed over the lane's evaluations
};

struct System {                      // a lane's GN system at one state
  float v[kNV];                      // H (upper triangle), b, E
  int n[3];                          // n_ok, n_in, n_sat
};

__device__ __forceinline__ int tri(int i, int j) {   // i <= j
  return i * 8 - (i * (i - 1)) / 2 + (j - i);
}

// Clamped bilinear sample of the (I, dx, dy) stack, as
// kernels/interp.bilinear_packed over pack_corners: the 2x2 footprint's
// origin is clamped into the image and its far corners to the last row
// and column.
__device__ __forceinline__ void sample3(const float* __restrict__ img, int H, int W,
                                        float u, float v, float out[3]) {
  const float fu = floorf(u), fv = floorf(v);
  const float du = u - fu, dv = v - fv;
  const int u0 = min(max(static_cast<int>(fu), 0), W - 1);
  const int v0 = min(max(static_cast<int>(fv), 0), H - 1);
  const int u1 = min(u0 + 1, W - 1), v1 = min(v0 + 1, H - 1);
  const float* p00 = img + 3 * (v0 * W + u0);
  const float* p10 = img + 3 * (v0 * W + u1);
  const float* p01 = img + 3 * (v1 * W + u0);
  const float* p11 = img + 3 * (v1 * W + u1);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = __ldg(p00 + c) * (1.f - du) + __ldg(p10 + c) * du;
    const float bot = __ldg(p01 + c) * (1.f - du) + __ldg(p11 + c) * du;
    out[c] = top * (1.f - dv) + bot * dv;
  }
}

// The lane's system at (T, ab), both in shared memory, into *out. Every
// thread of the block takes part; returns after a __syncthreads, with *out
// complete.
__device__ void evaluate(const Params& p, const float* T, const float* ab,
                         float (*red)[kNV], int (*redn)[3], System* out) {
  const float fx = __ldg(p.intr + 0), fy = __ldg(p.intr + 1);
  const float cx = __ldg(p.intr + 2), cy = __ldg(p.intr + 3);
  const float R00 = T[0], R01 = T[1], R02 = T[2], t0 = T[3];
  const float R10 = T[4], R11 = T[5], R12 = T[6], t1 = T[7];
  const float R20 = T[8], R21 = T[9], R22 = T[10], t2 = T[11];
  const float ea = expf(ab[0]), bb = ab[1];
  // in_bounds(uv, w, h, 2): 2 <= u < w - 3, 2 <= v < h - 3
  const float u_hi = static_cast<float>(p.W) - 3.f, v_hi = static_cast<float>(p.H) - 3.f;

  float acc[kNV];
#pragma unroll
  for (int i = 0; i < kNV; ++i) acc[i] = 0.f;
  int n_ok = 0, n_in = 0, n_sat = 0;

  for (int i = threadIdx.x; i < p.N; i += blockDim.x) {
    const float u = __ldg(p.uv + 2 * i), v = __ldg(p.uv + 2 * i + 1);
    const float id = __ldg(p.idepth + i), col = __ldg(p.color + i);
    const bool val = p.valid[i] != 0;
    const float xh0 = (u - cx) / fx, xh1 = (v - cy) / fy;
    const float X0 = (R00 * xh0 + R01 * xh1 + R02) + t0 * id;
    const float X1 = (R10 * xh0 + R11 * xh1 + R12) + t1 * id;
    const float X2 = (R20 * xh0 + R21 * xh1 + R22) + t2 * id;
    const bool ok_z = X2 > 1e-6f;
    const float sz = ok_z ? X2 : 1.f;
    const float up = X0 / sz, vp = X1 / sz, nid = id / sz;
    const float un = fx * up + cx, vn = fy * vp + cy;
    const bool in = (un >= 2.f) && (un < u_hi) && (vn >= 2.f) && (vn < v_hi) && ok_z && val;
    float hit[3];
    sample3(p.img3, p.H, p.W, in ? un : 2.f, in ? vn : 2.f, hit);
    const float r = (hit[0] - __fmul_rn(ea, col)) - bb;
    const float ar = fabsf(r);
    const bool sat = ar > p.cutoff;
    const float hw = ar < p.huber ? 1.f : p.huber / fmaxf(ar, 1e-12f);
    const float om = (in && !sat) ? hw : 0.f;
    n_in += in;
    n_sat += (sat && in);
    if (om > 0.f) {
      ++n_ok;
      const float gx = hit[1], gy = hit[2];
      float J[8];
      J[0] = gx * (nid * fx);
      J[1] = gy * (nid * fy);
      J[2] = gx * (-nid * up * fx) + gy * (-nid * vp * fy);
      J[3] = gx * (-up * vp * fx) + gy * (-(1.f + vp * vp) * fy);
      J[4] = gx * ((1.f + up * up) * fx) + gy * (up * vp * fy);
      J[5] = gx * (-vp * fx) + gy * (up * fy);
      J[6] = -ea * col;
      J[7] = -1.f;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float jw = J[a] * om;
#pragma unroll
        for (int c = a; c < 8; ++c) acc[tri(a, c)] += jw * J[c];
        acc[kNB + a] += jw * r;
      }
      acc[kNE] += (om * r) * r;
    }
  }

  // fixed-order block reduction: down each warp, then the warps in order
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    float s = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(full, s, off);
    if (lane == 0) red[warp][i] = s;
  }
  n_ok = __reduce_add_sync(full, n_ok);
  n_in = __reduce_add_sync(full, n_in);
  n_sat = __reduce_add_sync(full, n_sat);
  if (lane == 0) {
    redn[warp][0] = n_ok;
    redn[warp][1] = n_in;
    redn[warp][2] = n_sat;
  }
  __syncthreads();
  const int nw = blockDim.x >> 5;
  if (threadIdx.x < kNV) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += red[w][threadIdx.x];
    out->v[threadIdx.x] = s;
  } else if (threadIdx.x < kNV + 3) {
    const int c = threadIdx.x - kNV;
    int s = 0;
    for (int w = 0; w < nw; ++w) s += redn[w][c];
    out->n[c] = s;
  }
  __syncthreads();
}

// One damped LM step of a lane (thread 0): step = -Hd^-1 b by LU with
// partial pivoting on the augmented [Hd | b] in shared memory A, then
// T_new = exp(step[:6]) T and ab_new = ab + step[6:8].
__device__ void lm_step(const System& s, float lam, const float* T, const float* ab,
                        float* T_new, float* ab_new, float* step, float (*A)[9]) {
  float tr = 0.f;
  for (int i = 0; i < 8; ++i) tr += s.v[tri(i, i)];
  const float damp = 1e-4f * fmaxf(tr / 8.f, 1e-6f);
  for (int i = 0; i < 8; ++i) {
    for (int j = 0; j < 8; ++j) A[i][j] = s.v[i <= j ? tri(i, j) : tri(j, i)];
    A[i][i] = __fadd_rn(__fmul_rn(A[i][i], 1.f + lam), damp);
    A[i][8] = s.v[kNB + i];
  }
  for (int k = 0; k < 8; ++k) {
    int piv = k;
    float best = fabsf(A[k][k]);
    for (int i = k + 1; i < 8; ++i) {
      if (fabsf(A[i][k]) > best) { best = fabsf(A[i][k]); piv = i; }
    }
    if (piv != k) {
      for (int j = k; j < 9; ++j) { const float x = A[k][j]; A[k][j] = A[piv][j]; A[piv][j] = x; }
    }
    const float inv = 1.f / A[k][k];
    for (int i = k + 1; i < 8; ++i) {
      const float l = A[i][k] * inv;
      for (int j = k + 1; j < 9; ++j) A[i][j] -= l * A[k][j];
    }
  }
  float x[8];
  for (int i = 7; i >= 0; --i) {
    float acc = A[i][8];
    for (int j = i + 1; j < 8; ++j) acc -= A[i][j] * x[j];
    x[i] = acc / A[i][i];
  }
  for (int i = 0; i < 8; ++i) step[i] = -x[i];

  // se3_exp([rho, phi]) with the small-angle branches of math/lie.py
  const float r0 = step[0], r1 = step[1], r2 = step[2];
  const float p0 = step[3], p1 = step[4], p2 = step[5];
  const float tsq = p0 * p0 + p1 * p1 + p2 * p2;
  const bool small = tsq < kLieEps;
  const float sts = small ? 1.f : tsq;
  const float th = sqrtf(sts);
  const float sn = sinf(th), cs = cosf(th);
  const float ca = small ? 1.f - tsq / 6.f : sn / th;
  const float cb = small ? 0.5f - tsq / 24.f : (1.f - cs) / sts;
  const float cc = small ? 1.f / 6.f - tsq / 120.f : (th - sn) / (sts * th);
  const float Kx[9] = {0.f, -p2, p1, p2, 0.f, -p0, -p1, p0, 0.f};     // hat(phi)
  float K2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      K2[3 * i + j] = Kx[3 * i] * Kx[j] + Kx[3 * i + 1] * Kx[3 + j] + Kx[3 * i + 2] * Kx[6 + j];
  float D[16];                                                  // exp(step[:6])
  for (int i = 0; i < 3; ++i) {
    float V[3];
    for (int j = 0; j < 3; ++j) {
      const float e = (i == j) ? 1.f : 0.f;
      D[4 * i + j] = e + ca * Kx[3 * i + j] + cb * K2[3 * i + j];
      V[j] = e + cb * Kx[3 * i + j] + cc * K2[3 * i + j];
    }
    D[4 * i + 3] = V[0] * r0 + V[1] * r1 + V[2] * r2;
  }
  D[12] = 0.f; D[13] = 0.f; D[14] = 0.f; D[15] = 1.f;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      T_new[4 * i + j] = D[4 * i] * T[j] + D[4 * i + 1] * T[4 + j]
                         + D[4 * i + 2] * T[8 + j] + D[4 * i + 3] * T[12 + j];
  ab_new[0] = ab[0] + step[6];
  ab_new[1] = ab[1] + step[7];
}

__global__ void __launch_bounds__(kMaxThreads) track_level_kernel(Params p) {
  __shared__ float sT[16], sTn[16], sab[2], sabn[2], sstep[8];
  __shared__ float sA[8][9];
  __shared__ System sys, sys2;
  __shared__ float red[kMaxWarps][kNV];
  __shared__ int redn[kMaxWarps][3];
  __shared__ int s_done;
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < 16) sT[tid] = p.T0[16 * k + tid];
  if (tid < 2) sab[tid] = p.ab0[2 * k + tid];
  if (tid == 0) s_done = 0;
  __syncthreads();
  evaluate(p, sT, sab, red, redn, &sys);

  float lam = p.lam0;                // used by thread 0 only
  int64_t ok_sum = sys.n[0];         // thread 0's is written out
  int it = 0;
  for (; it < p.iters; ++it) {
    if (s_done) break;               // uniform: written before the last barrier
    if (tid == 0) lm_step(sys, lam, sT, sab, sTn, sabn, sstep, sA);
    __syncthreads();
    evaluate(p, sTn, sabn, red, redn, &sys2);
    if (tid == 0) {
      const float e_new = sys2.v[kNE] / static_cast<float>(max(sys2.n[0], 1));
      const float e_old = sys.v[kNE] / static_cast<float>(max(sys.n[0], 1));
      const bool accept = e_new < e_old;
      ok_sum += sys2.n[0];
      if (accept) {
        for (int i = 0; i < 16; ++i) sT[i] = sTn[i];
        sab[0] = sabn[0];
        sab[1] = sabn[1];
        sys = sys2;
      }
      lam = accept ? fmaxf(lam * p.lam_success, 1e-5f) : lam * p.lam_fail;
      float max_step = 0.f;
      for (int i = 0; i < 8; ++i) max_step = fmaxf(max_step, fabsf(sstep[i]));
      s_done = (accept && max_step < p.step_eps) || lam > 1e3f;
    }
    __syncthreads();
  }

  if (tid == 0) {
    for (int i = 0; i < 16; ++i) p.T_out[16 * k + i] = sT[i];
    p.ab_out[2 * k] = sab[0];
    p.ab_out[2 * k + 1] = sab[1];
    p.rmse_out[k] = sqrtf(sys.v[kNE] / static_cast<float>(max(sys.n[0], 1)));
    p.n_ok_out[k] = sys.n[0];
    p.n_in_out[k] = sys.n[1];
    p.n_sat_out[k] = sys.n[2];
    p.n_iter_out[k] = it;
    p.n_ok_sum_out[k] = ok_sum;
  }
}

}  // namespace

// One launch: K blocks, 256 threads (512 for 1024 points or more).
extern "C" int ldso_track_level(
    const void* img3, int H, int W, const void* uv, const void* idepth, const void* color,
    const void* valid, int N, const void* T0, const void* ab0, const void* intr, int K,
    int iters, float cutoff, float huber, float lam0, float lam_success, float lam_fail,
    float step_eps, void* T_out, void* ab_out, void* rmse_out, void* n_ok_out,
    void* n_in_out, void* n_sat_out, void* n_iter_out, void* n_ok_sum_out, void* stream) {
  if (K <= 0) return 0;
  Params p;
  p.img3 = static_cast<const float*>(img3);
  p.H = H;
  p.W = W;
  p.uv = static_cast<const float*>(uv);
  p.idepth = static_cast<const float*>(idepth);
  p.color = static_cast<const float*>(color);
  p.valid = static_cast<const unsigned char*>(valid);
  p.N = N;
  p.T0 = static_cast<const float*>(T0);
  p.ab0 = static_cast<const float*>(ab0);
  p.intr = static_cast<const float*>(intr);
  p.iters = iters;
  p.cutoff = cutoff;
  p.huber = huber;
  p.lam0 = lam0;
  p.lam_success = lam_success;
  p.lam_fail = lam_fail;
  p.step_eps = step_eps;
  p.T_out = static_cast<float*>(T_out);
  p.ab_out = static_cast<float*>(ab_out);
  p.rmse_out = static_cast<float*>(rmse_out);
  p.n_ok_out = static_cast<int64_t*>(n_ok_out);
  p.n_in_out = static_cast<int64_t*>(n_in_out);
  p.n_sat_out = static_cast<int64_t*>(n_sat_out);
  p.n_iter_out = static_cast<int32_t*>(n_iter_out);
  p.n_ok_sum_out = static_cast<int64_t*>(n_ok_sum_out);
  const int threads = N >= 1024 ? kMaxThreads : 256;
  track_level_kernel<<<K, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
