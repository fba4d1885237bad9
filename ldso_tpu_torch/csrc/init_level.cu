// The monocular bootstrap's Gauss-Newton loop at one pyramid level, all of
// its iterations in ONE launch.
//
// Replaces the XLA program of ldso_tpu/init2f.py::init_level (:51-177, a
// jax.jit over a lax.scan at :171 whose body is :135-167, the system at
// :80-133); the JAX package has no Pallas source for it. Contract, that of
// init2f.init_level_torch at level l (s = 2^-l):
//   once a launch: uv_l = uv s + (0.5 s - 0.5); the level intrinsics fx s,
//     fy s, (cx + 0.5) s - 0.5, (cy + 0.5) s - 0.5; a point's 8 pattern rays
//     xh = ((uv_l + pattern - c) / f, 1); the start state's system;
//   an evaluation at (T, ab, d, iR, good), per sample of a point:
//     X = R xh + t d; ok_z = z > 1e-6; the projection; inb = in_bounds(uv',
//     w, h, 2) & ok_z; the clamped bilinear (I, dx, dy) at uv'
//     (kernels/interp.bilinear: each corner's index clamped into the image);
//     r = I - e^a color - b; the Huber weight hw; om = (inb & good) ? hw :
//     0; the 8-vector Jx = [dI/dxi (6), -e^a color, -1] and the scalar Jd;
//   per point: Hxd = sum om Jx Jd (8), Hdd = sum om Jd^2, bd = sum om Jd r,
//     pt_ok = (#inb >= 6); the prior: before the snap Hdd += alpha_w, bd +=
//     alpha_w (d - 1); after it Hdd += coupling, bd += coupling (d - iR);
//   global sums: H = sum om Jx Jx^T (36), b = sum om Jx r (8), E = sum om
//     r^2 (2 - hw); before the snap H_ii += alpha_w n_pts and b_i += alpha_w
//     t_i n_pts for i < 3, n_pts = max(#good, 1);
//   an iteration, from the carried system, lambda from 0.1: inv_dd = 1 /
//     (Hdd (1 + lam) + 1e-10); the Schur sums H_sc = sum Hxd inv_dd Hxd^T,
//     b_sc = sum Hxd inv_dd bd; Hf = H with its diagonal x (1 + lam), minus
//     H_sc, plus 1e-6 I max(tr H, 1); dx = -Hf^-1 (b - b_sc) by LU with
//     partial pivoting (getrf's rule: the first row of largest |a|); dd =
//     -(bd + Hxd . dx) inv_dd; d' = clamp(d + dd, 1e-3, 50); iR' = (1 -
//     reg_weight) d' + reg_weight median(the OLD iR of the K neighbours),
//     the median the mean of the two middle values (jnp.median's
//     "midpoint"); good' = good & pt_ok; T' = exp(dx[:6]) T
//     (lie.cuh's exp_times34); ab' = ab + dx[6:]; one evaluation at the
//     trial state; accept iff E' < E, then the state and its system are
//     carried; lam -> max(lam / 2, 1e-5) on accept, 4 lam otherwise;
//   the outputs: T, ab, d, iR, good & pt_ok of the carried system, E,
//     |t|^2 and #(good & pt_ok).
// Both packages compute a per-point energy e_pt (init2f.py:81) that neither
// reads: the kernel leaves it out. Where the plain version masks a sample by
// multiplying with om = 0, the kernel skips it (its bilinear sample too):
// the same sums for finite samples.
//
// What bounds it on Hopper: neither bytes nor arithmetic. A default
// bootstrap frame (1024 points, 8 samples each, 400 iterations over five
// levels) does ~0.85 Gflop and reads a few MB of (I, dx, dy) stacks, some
// microseconds at the card's rates; the time is the chain of `iters`
// dependent iterations, each two block-wide reductions and a serial 8x8
// solve. The design keeps that chain in one CTA:
//   * one CTA of 512 threads a launch, point p on thread p mod 512 in every
//     phase (two points a thread at N = 1024). A cluster of CTAs would
//     spread the samples wider but add an exchange to both reductions of
//     every iteration, and every CTA would need every point's iR for the
//     neighbour medians: one CTA keeps them in one shared memory;
//   * each point's state and system live in dynamic shared memory,
//     double-buffered (the accepted and the trial copy: d, iR, Hxd, Hdd, bd
//     and the good / pt_ok flags, 98 B a point); accepting swaps an index,
//     and the neighbours read the old iR while the new one is written;
//   * a reduction: each thread's 48 partial sums in registers, a warp's by
//     a reduce-scatter of shuffles (as csrc/track_level.cu), the warps' in
//     warp order by warp 0: a fixed order, no atomics, so a second launch
//     gives the same bits;
//   * the step in warp 0: every lane solves the whole 8x9 system in its own
//     registers (static indices), lane 0 writes the trial state and dx;
//   * four __syncthreads an iteration, no host read inside the level.
//
// Plain C interface (bound with ctypes): the entry point launches on the
// given stream, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "lie.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 1024;          // points: preset("default")'s init_points
constexpr int kMaxK = 16;            // neighbours of a point
constexpr int kNS = 48;              // the sums of a reduction
constexpr int kB = 36;               // after H's upper triangle (36): b (8)
constexpr int kE = 44;               // then E
constexpr int kGood = 45;            // then #good of the evaluated state
constexpr int kOk = 46;              // then #samples with om > 0
constexpr unsigned kFull = 0xffffffffu;
// per point and buffer in dynamic shared memory, floats: d, iR, Hdd, bd,
// Hxd (8); then the flags, a byte a point and buffer
constexpr int kPointFloats = 12;
constexpr unsigned char kGoodBit = 1, kOkBit = 2;

// core/window.PATTERN_OFFSETS (config.PATTERN)
__constant__ float kPattern[8][2] = {{0.f, -2.f}, {-1.f, -1.f}, {1.f, -1.f}, {-2.f, 0.f},
                                     {0.f, 0.f},  {2.f, 0.f},   {-1.f, 1.f}, {0.f, 2.f}};

struct Params {
  const float* img3;                 // [H, W, 3] (I, dx, dy) of the new frame's level
  const float* uv;                   // [N, 2] level-0 coordinates
  const float* colors;               // [N, 8] the first frame's colours at this level
  const int* nbr;                    // [N, K] neighbour indices, in [0, N)
  const float* T0;                   // [4, 4]
  const float* ab0;                  // [2]
  const float* d0;                   // [N]
  const float* iR0;                  // [N]
  const unsigned char* good0;        // [N] bool
  const float* intr0;                // [4] level-0 fx, fy, cx, cy
  int H, W, N, K, level, iters, snapped;
  float alpha_w, coupling, reg_keep, reg_weight, huber;
  float* T_out;                      // [4, 4]
  float* ab_out;                     // [2]
  float* d_out;                      // [N]
  float* iR_out;                     // [N]
  unsigned char* good_out;           // [N] bool
  float* scalars_out;                // [2]: E, |t|^2
  int64_t* counts_out;               // [2]: #(good & pt_ok), #(om > 0) over every evaluation
  float* ladder_out;                 // [iters, 2] or null: E and the trial's E' each iteration
};

// The level's geometry.
struct Geo {
  float s, off;                      // uv_l = uv s + off
  float fx, fy, cx, cy;
  float u_hi, v_hi;                  // in_bounds(uv, w, h, 2): 2 <= u < w - 3, 2 <= v < h - 3
};

struct Shared {
  float red[kWarps][kNS];            // the warps' partials
  float sys[2][kNS];                 // the accepted / trial state's sums, priors added
  float sc[kNS];                     // an iteration's Schur sums
  float st[2][18];                   // the accepted / trial T (16), ab (2)
  float dx[8];
  int accept;
};

__device__ __forceinline__ int tri(int i, int j) {   // i <= j
  return i * 8 - (i * (i - 1)) / 2 + (j - i);
}

// kernels/interp.bilinear of the (I, dx, dy) stack at (u, v).
__device__ __forceinline__ void sample3(const float* __restrict__ img, int H, int W, float u,
                                        float v, float out[3]) {
  const float fu = floorf(u), fv = floorf(v);
  const float du = u - fu, dv = v - fv;
  const int iu = static_cast<int>(fu), iv = static_cast<int>(fv);
  const int u0 = min(max(iu, 0), W - 1), u1 = min(max(iu + 1, 0), W - 1);
  const int v0 = min(max(iv, 0), H - 1), v1 = min(max(iv + 1, 0), H - 1);
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

// One point's system at the state (st: T 16, ab 2; d, iR, good): Hxd, Hdd,
// bd with the prior, pt_ok; its terms of the global sums added to acc.
__device__ __forceinline__ void eval_point(const Params& P, const Geo& g, const float* st,
                                           int p, float d, float iR, bool good, float hxd[8],
                                           float& hdd, float& bd, bool& pt_ok,
                                           float acc[kNS]) {
  const float R00 = st[0], R01 = st[1], R02 = st[2], t0 = st[3];
  const float R10 = st[4], R11 = st[5], R12 = st[6], t1 = st[7];
  const float R20 = st[8], R21 = st[9], R22 = st[10], t2 = st[11];
  const float ea = expf(st[16]), b = st[17];
  const float fx = g.fx, fy = g.fy, cx = g.cx, cy = g.cy;
  const float ul = __ldg(P.uv + 2 * p) * g.s + g.off;
  const float vl = __ldg(P.uv + 2 * p + 1) * g.s + g.off;
#pragma unroll
  for (int a = 0; a < 8; ++a) hxd[a] = 0.f;
  hdd = 0.f;
  bd = 0.f;
  int n_inb = 0;
#pragma unroll 1
  for (int k = 0; k < 8; ++k) {
    const float x0 = ((ul + kPattern[k][0]) - cx) / fx;
    const float x1 = ((vl + kPattern[k][1]) - cy) / fy;
    const float X0 = (R00 * x0 + R01 * x1 + R02) + t0 * d;
    const float X1 = (R10 * x0 + R11 * x1 + R12) + t1 * d;
    const float X2 = (R20 * x0 + R21 * x1 + R22) + t2 * d;
    const bool ok_z = X2 > 1e-6f;
    const float zs = ok_z ? X2 : 1.f;
    const float up = X0 / zs, vp = X1 / zs;
    const float un = fx * up + cx, vn = fy * vp + cy;
    const bool inb = (un >= 2.f) && (un < g.u_hi) && (vn >= 2.f) && (vn < g.v_hi) && ok_z;
    n_inb += inb ? 1 : 0;
    if (!(inb && good)) continue;    // om = 0: no term anywhere
    float hit[3];
    sample3(P.img3, P.H, P.W, un, vn, hit);
    const float col = __ldg(P.colors + 8 * p + k);
    const float r = (hit[0] - ea * col) - b;
    const float ar = fabsf(r);
    const float om = ar < P.huber ? 1.f : P.huber / fmaxf(ar, 1e-12f);
    const float gx = hit[1], gy = hit[2];
    const float nid = d / zs, dre = 1.f / zs;
    float J[8];
    J[0] = gx * (nid * fx);
    J[1] = gy * (nid * fy);
    J[2] = gx * (-nid * up * fx) + gy * (-nid * vp * fy);
    J[3] = gx * (-up * vp * fx) + gy * (-(1.f + vp * vp) * fy);
    J[4] = gx * ((1.f + up * up) * fx) + gy * (up * vp * fy);
    J[5] = gx * (-vp * fx) + gy * (up * fy);
    J[6] = -ea * col;
    J[7] = -1.f;
    const float jd = gx * (fx * dre * (t0 - t2 * up)) + gy * (fy * dre * (t1 - t2 * vp));
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float jw = J[a] * om;
#pragma unroll
      for (int c = a; c < 8; ++c) acc[tri(a, c)] += jw * J[c];
      acc[kB + a] += jw * r;
      hxd[a] += jw * jd;
    }
    hdd += om * jd * jd;
    bd += om * jd * r;
    acc[kE] += om * r * r * (2.f - om);
    acc[kOk] += 1.f;
  }
  pt_ok = n_inb >= 6;
  if (good) acc[kGood] += 1.f;
  if (P.snapped) {
    hdd += P.coupling;
    bd += P.coupling * (d - iR);
  } else {
    hdd += P.alpha_w;
    bd += P.alpha_w * (d - 1.f);
  }
}

// One halving step of the warp's reduce-scatter: of the first 2 * HALF
// values, a thread whose lane has bit OFF set keeps the upper half, the
// other the lower, each summed with its partner's copy.
template <int HALF, int OFF>
__device__ __forceinline__ void scatter_step(float a[kNS], int lane) {
  const bool up = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? a[i] : a[i + HALF];
    const float keep = up ? a[i + HALF] : a[i];
    a[i] = keep + __shfl_xor_sync(kFull, send, OFF);
  }
}

// The CTA's sums of the threads' acc, into out[0..47], as warp 0 sees them
// (a __syncwarp after): each warp by a reduce-scatter (afterwards a[0..2] of
// lane l hold the warp's sums of values base(l) + 0..2), then warp 0 adds
// the warps' in warp order. Every thread takes part; the caller keeps the
// warps from writing `red` again before warp 0 has read it.
__device__ __forceinline__ void block_sum(float a[kNS], Shared& s, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  scatter_step<24, 16>(a, lane);
  scatter_step<12, 8>(a, lane);
  scatter_step<6, 4>(a, lane);
  scatter_step<3, 2>(a, lane);
#pragma unroll
  for (int i = 0; i < 3; ++i) a[i] += __shfl_xor_sync(kFull, a[i], 1);
  const int base = 24 * ((lane >> 4) & 1) + 12 * ((lane >> 3) & 1) + 6 * ((lane >> 2) & 1)
                   + 3 * ((lane >> 1) & 1);
  if ((lane & 1) == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) s.red[warp][base + j] = a[j];
  }
  __syncthreads();
  if (warp == 0) {
    const int hi = 32 + (lane & 15);
    float v0 = s.red[0][lane], v1 = s.red[0][hi];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      v0 += s.red[w][lane];
      v1 += s.red[w][hi];
    }
    out[lane] = v0;
    if (lane < 16) out[hi] = v1;
    __syncwarp();
  }
}

// The α-prior on the global sums of an evaluation at the state st, before
// the snap (lane 0 of warp 0).
__device__ __forceinline__ void pose_prior(const Params& P, const float* st, float* sys) {
  if (P.snapped) return;
  const float n_pts = fmaxf(sys[kGood], 1.f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sys[tri(i, i)] += P.alpha_w * n_pts;
    sys[kB + i] += P.alpha_w * st[4 * i + 3] * n_pts;
  }
}

// x = A^-1 A[:, 8] for the 8x9 system A, in the thread's registers: LU with
// partial pivoting by getrf's rule (the first row of largest |a|; a strict
// compare, so a NaN never wins), then the back substitution column by
// column (getrs).
__device__ __forceinline__ void solve8(float A[8][9], float x[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int piv = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 8; ++i) {
      const float v = fabsf(A[i][k]);
      if (v > best) {
        best = v;
        piv = i;
      }
    }
    if (piv != k) {                  // the same for every lane: no divergence
#pragma unroll
      for (int j = k; j < 9; ++j) {  // swap rows k and piv
        const float rk = A[k][j];
        float y = rk;
#pragma unroll
        for (int i = k + 1; i < 8; ++i) {
          const float ai = A[i][j];
          y = piv == i ? ai : y;
          A[i][j] = piv == i ? rk : ai;
        }
        A[k][j] = y;
      }
    }
    const float inv = 1.f / A[k][k];
#pragma unroll
    for (int i = k + 1; i < 8; ++i) {
      const float l = A[i][k] * inv;
#pragma unroll
      for (int j = k + 1; j < 9; ++j) A[i][j] -= l * A[k][j];
    }
  }
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    x[k] = A[k][8] / A[k][k];
#pragma unroll
    for (int i = 0; i < k; ++i) A[i][8] -= A[i][k] * x[k];
  }
}

// The damped Schur step by warp 0 (every lane the same): dx, then the trial
// state exp(dx[:6]) T, ab + dx[6:] from the accepted one; lane 0 writes both.
__device__ __forceinline__ void gn_step(Shared& s, int c, float lam, int lane) {
  const float* sys = s.sys[c];
  float tr = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) tr += sys[tri(i, i)];
  const float damp = 1e-6f * fmaxf(tr, 1.f);
  float A[8][9];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = i <= j ? tri(i, j) : tri(j, i);
      A[i][j] = i == j ? (sys[e] * (1.f + lam) - s.sc[e]) + damp : sys[e] - s.sc[e];
    }
    A[i][8] = sys[kB + i] - s.sc[kB + i];
  }
  float x[8];
  solve8(A, x);
  float dx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) dx[i] = -x[i];
  const float* T = s.st[c];
  float Tn[12];
  lie::exp_times34(dx, T, lie::rules(1), Tn);
  if (lane == 0) {
    float* trial = s.st[1 - c];
#pragma unroll
    for (int i = 0; i < 12; ++i) trial[i] = Tn[i];
#pragma unroll
    for (int i = 12; i < 16; ++i) trial[i] = T[i];
    trial[16] = T[16] + dx[6];
    trial[17] = T[17] + dx[7];
#pragma unroll
    for (int i = 0; i < 8; ++i) s.dx[i] = dx[i];
  }
}

// (x_m0 + x_m1) / 2 of the sorted values of iR at the K neighbours, m0 =
// (K - 1) / 2, m1 = K / 2: an odd-even transposition sort of kMaxK values
// (the missing ones +inf) in registers.
__device__ __forceinline__ float median_mid(const float* iR, const int* nb, int K) {
  float v[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) v[j] = j < K ? iR[__ldg(nb + j)] : __int_as_float(0x7f800000);
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
#pragma unroll
    for (int j = r & 1; j + 1 < kMaxK; j += 2) {
      const float lo = fminf(v[j], v[j + 1]), hi = fmaxf(v[j], v[j + 1]);
      v[j] = lo;
      v[j + 1] = hi;
    }
  }
  const int m0 = (K - 1) / 2, m1 = K / 2;
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    a = j == m0 ? v[j] : a;
    b = j == m1 ? v[j] : b;
  }
  return (a + b) * 0.5f;
}

__global__ void __launch_bounds__(kThreads) init_level_kernel(const __grid_constant__ Params P) {
  __shared__ Shared s;
  extern __shared__ float dyn[];
  const int N = P.N, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // [buffer][point] arrays; Hxd [buffer][8][point]
  float* const sd = dyn;
  float* const siR = dyn + 2 * N;
  float* const shdd = dyn + 4 * N;
  float* const sbd = dyn + 6 * N;
  float* const shxd = dyn + 8 * N;
  unsigned char* const sfl = reinterpret_cast<unsigned char*>(dyn + kPointFloats * 2 * N);

  Geo g;
  g.s = ldexpf(1.f, -P.level);
  g.off = 0.5f * g.s - 0.5f;
  g.fx = __ldg(P.intr0) * g.s;
  g.fy = __ldg(P.intr0 + 1) * g.s;
  g.cx = (__ldg(P.intr0 + 2) + 0.5f) * g.s - 0.5f;
  g.cy = (__ldg(P.intr0 + 3) + 0.5f) * g.s - 0.5f;
  g.u_hi = static_cast<float>(P.W) - 3.f;
  g.v_hi = static_cast<float>(P.H) - 3.f;
  if (tid < 16) s.st[0][tid] = __ldg(P.T0 + tid);
  else if (tid < 18) s.st[0][tid] = __ldg(P.ab0 + tid - 16);
  __syncthreads();

  float acc[kNS];
  float hxd[8], hdd, bd;
  bool pt_ok;
  int64_t n_ok = 0;                  // warp 0's
  // the start state's system, into buffer 0
#pragma unroll
  for (int i = 0; i < kNS; ++i) acc[i] = 0.f;
  for (int p = tid; p < N; p += kThreads) {
    const float d = __ldg(P.d0 + p), iR = __ldg(P.iR0 + p);
    const bool good = P.good0[p] != 0;
    eval_point(P, g, s.st[0], p, d, iR, good, hxd, hdd, bd, pt_ok, acc);
    sd[p] = d;
    siR[p] = iR;
    shdd[p] = hdd;
    sbd[p] = bd;
#pragma unroll
    for (int a = 0; a < 8; ++a) shxd[a * N + p] = hxd[a];
    sfl[p] = (good ? kGoodBit : 0) | (pt_ok ? kOkBit : 0);
  }
  block_sum(acc, s, s.sys[0]);
  if (warp == 0 && lane == 0) {
    pose_prior(P, s.st[0], s.sys[0]);
    n_ok = static_cast<int64_t>(s.sys[0][kOk]);
  }
  __syncthreads();

  int c = 0;                         // the accepted buffer
  float lam = 0.1f;
  for (int it = 0; it < P.iters; ++it) {
    const int t = 1 - c;
    const float damp = 1.f + lam;
    // the Schur sums over the points
#pragma unroll
    for (int i = 0; i < kNS; ++i) acc[i] = 0.f;
    for (int p = tid; p < N; p += kThreads) {
      const float inv_dd = 1.f / (shdd[c * N + p] * damp + 1e-10f);
      const float ib = inv_dd * sbd[c * N + p];
#pragma unroll
      for (int a = 0; a < 8; ++a) hxd[a] = shxd[(c * 8 + a) * N + p];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float w = hxd[a] * inv_dd;
#pragma unroll
        for (int b2 = a; b2 < 8; ++b2) acc[tri(a, b2)] += w * hxd[b2];
        acc[kB + a] += hxd[a] * ib;
      }
    }
    block_sum(acc, s, s.sc);
    if (warp == 0) gn_step(s, c, lam, lane);
    __syncthreads();

    // the trial state, point by point, and its system into buffer t
    float dx[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) dx[a] = s.dx[a];
#pragma unroll
    for (int i = 0; i < kNS; ++i) acc[i] = 0.f;
    for (int p = tid; p < N; p += kThreads) {
      const float inv_dd = 1.f / (shdd[c * N + p] * damp + 1e-10f);
      float hx = 0.f;
#pragma unroll
      for (int a = 0; a < 8; ++a) hx += shxd[(c * 8 + a) * N + p] * dx[a];
      const float dd = -(sbd[c * N + p] + hx) * inv_dd;
      const float x = sd[c * N + p] + dd;
      const float d = x != x ? x : fminf(fmaxf(x, 1e-3f), 50.f);   // torch.clamp keeps NaN
      const float iR = P.reg_keep * d
                       + P.reg_weight * median_mid(siR + c * N, P.nbr + p * P.K, P.K);
      const unsigned char fl = sfl[c * N + p];
      const bool good = (fl & kGoodBit) && (fl & kOkBit);
      eval_point(P, g, s.st[t], p, d, iR, good, hxd, hdd, bd, pt_ok, acc);
      sd[t * N + p] = d;
      siR[t * N + p] = iR;
      shdd[t * N + p] = hdd;
      sbd[t * N + p] = bd;
#pragma unroll
      for (int a = 0; a < 8; ++a) shxd[(t * 8 + a) * N + p] = hxd[a];
      sfl[t * N + p] = (good ? kGoodBit : 0) | (pt_ok ? kOkBit : 0);
    }
    block_sum(acc, s, s.sys[t]);
    if (warp == 0 && lane == 0) {
      pose_prior(P, s.st[t], s.sys[t]);
      n_ok += static_cast<int64_t>(s.sys[t][kOk]);
      const float e_cur = s.sys[c][kE], e_new = s.sys[t][kE];
      s.accept = e_new < e_cur;
      if (P.ladder_out != nullptr) {
        P.ladder_out[2 * it] = e_cur;
        P.ladder_out[2 * it + 1] = e_new;
      }
    }
    __syncthreads();
    const bool accept = s.accept != 0;
    c = accept ? t : c;
    lam = accept ? fmaxf(lam * 0.5f, 1e-5f) : lam * 4.f;
  }

  // the outputs of the carried state
#pragma unroll
  for (int i = 0; i < kNS; ++i) acc[i] = 0.f;
  for (int p = tid; p < N; p += kThreads) {
    const unsigned char fl = sfl[c * N + p];
    const bool ok = (fl & kGoodBit) && (fl & kOkBit);
    P.d_out[p] = sd[c * N + p];
    P.iR_out[p] = siR[c * N + p];
    P.good_out[p] = ok ? 1 : 0;
    acc[0] += ok ? 1.f : 0.f;
  }
  block_sum(acc, s, s.sc);
  if (warp == 0 && lane == 0) {
    const float* T = s.st[c];
#pragma unroll
    for (int i = 0; i < 16; ++i) P.T_out[i] = T[i];
    P.ab_out[0] = T[16];
    P.ab_out[1] = T[17];
    P.scalars_out[0] = s.sys[c][kE];
    P.scalars_out[1] = T[3] * T[3] + T[7] * T[7] + T[11] * T[11];
    P.counts_out[0] = static_cast<int64_t>(s.sc[0]);
    P.counts_out[1] = n_ok;
  }
}

}  // namespace

// One launch: one CTA of kThreads threads, 98 B of dynamic shared memory a
// point. N <= kMaxN, 1 <= K <= kMaxK.
extern "C" int ldso_init_level(
    const void* img3, int H, int W, const void* uv, const void* colors, const void* nbr, int N,
    int K, const void* T0, const void* ab0, const void* d0, const void* iR0, const void* good0,
    const void* intr0, int level, int iters, int snapped, float alpha_w, float coupling,
    float reg_keep, float reg_weight, float huber, void* T_out, void* ab_out, void* d_out,
    void* iR_out, void* good_out, void* scalars_out, void* counts_out, void* ladder_out,
    void* stream) {
  if (N < 1 || N > kMaxN || K < 1 || K > kMaxK || H < 1 || W < 1 || level < 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.img3 = static_cast<const float*>(img3);
  p.uv = static_cast<const float*>(uv);
  p.colors = static_cast<const float*>(colors);
  p.nbr = static_cast<const int*>(nbr);
  p.T0 = static_cast<const float*>(T0);
  p.ab0 = static_cast<const float*>(ab0);
  p.d0 = static_cast<const float*>(d0);
  p.iR0 = static_cast<const float*>(iR0);
  p.good0 = static_cast<const unsigned char*>(good0);
  p.intr0 = static_cast<const float*>(intr0);
  p.H = H;
  p.W = W;
  p.N = N;
  p.K = K;
  p.level = level;
  p.iters = iters;
  p.snapped = snapped;
  p.alpha_w = alpha_w;
  p.coupling = coupling;
  p.reg_keep = reg_keep;
  p.reg_weight = reg_weight;
  p.huber = huber;
  p.T_out = static_cast<float*>(T_out);
  p.ab_out = static_cast<float*>(ab_out);
  p.d_out = static_cast<float*>(d_out);
  p.iR_out = static_cast<float*>(iR_out);
  p.good_out = static_cast<unsigned char*>(good_out);
  p.scalars_out = static_cast<float*>(scalars_out);
  p.counts_out = static_cast<int64_t*>(counts_out);
  p.ladder_out = static_cast<float*>(ladder_out);
  const size_t smem = (sizeof(float) * kPointFloats + 1) * 2 * static_cast<size_t>(N);
  // above 48 KB of dynamic shared memory the kernel must ask for it; the
  // attribute is the device's, so it is set on every launch that needs it
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        init_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  init_level_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
