// The coarse tracker's Levenberg-Marquardt loop: a chain of pyramid levels
// for K lanes (motion hypotheses) in ONE launch.
//
// Replaces the XLA program of ldso_tpu/tracker.py::track_level (:165-224, a
// lax.while_loop over _level_system / _level_residuals :105-162, vmapped
// over the hypotheses at :255, the winner picked at :265); the JAX package
// has no Pallas source for it. Contract, per lane and level, that of
// tracker.track_level_torch:
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
//   the lane's loop at a level ends on done or after the level's cap; the
//   next level of the launch starts from the lane's result (as
//   tracker.track_frame chains levels), lambda from lam0 again.
// With a winner table (pick_rmse), every lane first takes the start state
// of the lane that torch.argmin(torch.nan_to_num(rmse, nan=inf, posinf=inf,
// neginf=inf)) picks: NaN and +-inf count as +inf, the lowest index wins a
// tie. tracker.track_frame is two launches: the coarse levels for every
// lane, then that pick and the fine levels for the winner.
// The corner-packed gather of kernels/interp.pack_corners is a TPU layout
// trick: here the four corners are read directly (the same values).
//
// What bounds it on Hopper: neither bytes nor arithmetic. A frame's five
// levels read a few MB of (I, dx, dy) stacks and do ~272k point
// evaluations of ~250 flops (a few microseconds at the card's rates); the
// time is the chain of up to 12 + 12 + 50 + 30 + 16 dependent iterations,
// each a reduction over the lane's points and a serial 8x8 solve. The
// design keeps that chain on the card and each link short:
//   * a lane is a thread-block cluster of C CTAs (the wrapper launches one
//     CTA a lane for many lanes, a cluster of 8 for one lane); global
//     thread g of the lane takes points g, g + C * blockDim, ..., staged at each level in
//     its CTA's shared memory (xh computed once, by the same expression);
//     each thread keeps the 36 upper-triangle H sums, 8 b sums, E and the
//     three counts (as floats: exact below 2^24) in registers;
//   * each warp reduces them by a reduce-scatter (in each halving step a
//     thread sends half of the values it still holds and keeps the other
//     half summed: 48 shuffles a warp, not 5 per value); warp 0 loads the
//     warps' partials, then sums them in warp order into the CTA's partial;
//   * warp 0 of every CTA pushes its partial into each peer's shared
//     memory (st.async into distributed shared memory, each store counted
//     on the peer's mbarrier; the helpers and the reduce-scatter are
//     csrc/cluster.cuh's, shared with init_level.cu), waits on its own
//     mbarrier for the peers' partials, sums the C partials in rank order and takes the step
//     itself: the CTAs of a lane compute the same bits, so no state is
//     broadcast and no cluster-wide barrier runs in the loop (the partials
//     are double-buffered, so a peer can send the next evaluation's while
//     this one's are still read; a peer is never two evaluations ahead);
//     with C = 1 the CTA's partial is the system;
//   * the step runs in warp 0's registers: the damped 8x9 LU with partial
//     pivoting (getrf's rule: the first row of largest |a|), one row a
//     thread, the pivot found by a warp max and a ballot and its row
//     broadcast by shuffles; the back substitution column by column (as
//     getrs / trsm); math/lie.py's SE(3) exponential with its small-angle
//     branches (eps 1e-8); the accept test, lambda and done. The accepted
//     and the trial state and system are double-buffered in shared memory:
//     accepting swaps an index;
//   * no sum uses atomics, and every order is fixed: a lane's result repeats
//     bit for bit from run to run, and a one-level launch gives the bits of
//     the same level inside a chained launch of the same cluster size and
//     block size.
// Under -DTRACK_LEVEL_PHASES thread 0 of each lane's rank-0 CTA stamps
// clock64() around the point loop, the warp reduction, the cross-warp sum,
// the cross-CTA sum (the exchange with the peers included), the step and the last
// barrier of an iteration, and inside the step around the system's rows,
// the LU, the back substitution and the exponential, and writes the cycles
// per level (a second library; the main path's is built without it).
//
// Plain C interface (bound with ctypes): the entry point launches on the
// given stream, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxLevels = 8;
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int kNH = 36;              // upper triangle of the 8x8 H, row by row
constexpr int kNB = kNH;             // then b (8)
constexpr int kNE = kNH + 8;         // then E
constexpr int kNC = kNE + 1;         // then the counts n_ok, n_in, n_sat, as floats (exact)
constexpr int kNS = 48;              // the 48 sums of an evaluation
constexpr int kStage = 1024;         // a CTA's points staged in shared memory at a level
constexpr float kLieEps = 1e-8f;     // math/lie.py _EPS
constexpr unsigned kFull = 0xffffffffu;

struct Level {
  const float* img3;                 // [H, W, 3] (I, dx, dy)
  const float* uv;                   // [N, 2]
  const float* idepth;               // [N]
  const float* color;                // [N]
  const unsigned char* valid;        // [N] bool
  int H, W, N, iters;
  int intr_row;                      // row of intr: fx, fy, cx, cy of this level
  int slot;                          // row of the [slots, lanes_cap] outputs
  float cutoff;
};

struct Params {
  Level lv[kMaxLevels];
  int n_levels;
  const float* intr;                 // [rows, 4]
  const float* T0;                   // lane k starts at T0 + k * T0_stride (16 floats)
  const float* ab0;                  // and ab0 + k * ab0_stride (2 floats; stride 0: shared)
  int T0_stride, ab0_stride;
  const float* pick_rmse;            // [k_in] or null: every lane starts from the winner
  int k_in;
  int lanes_cap;
  float huber, lam0, lam_success, lam_fail, step_eps;
  float* T_out;                      // [slots, lanes_cap, 4, 4]
  float* ab_out;                     // [slots, lanes_cap, 2]
  float* rmse_out;                   // [slots, lanes_cap]
  int64_t* n_ok_out;                 // [slots, lanes_cap]
  int64_t* n_in_out;
  int64_t* n_sat_out;
  int32_t* n_iter_out;               // iterations run
  int64_t* n_ok_sum_out;             // n_ok summed over the lane's evaluations at the level
  int32_t* best_out;                 // [1] the picked lane (with pick_rmse)
  long long* phases_out;             // [slots, lanes_cap, 8] (instrumented build)
};

__device__ __forceinline__ int tri(int i, int j) {   // i <= j
  return i * 8 - (i * (i - 1)) / 2 + (j - i);
}

#ifdef TRACK_LEVEL_PHASES
constexpr int kPhases = 12;          // see the TRACK_LEVEL_PHASES note above
#define STAMP(i)                                                   \
  do {                                                             \
    if (stamper) {                                                 \
      const long long t_ = clock64();                              \
      ph[i] += t_ - t_last;                                        \
      t_last = t_;                                                 \
    }                                                              \
  } while (0)
// the step's own parts, into sub[0..3] (thread 0 of warp 0 only)
#define SUBSTAMP(i)                                                \
  do {                                                             \
    if (sub != nullptr) {                                          \
      const long long t_ = clock64();                              \
      sub[i] += t_ - t_sub;                                        \
      t_sub = t_;                                                  \
    }                                                              \
  } while (0)
#else
#define STAMP(i) ((void)0)
#define SUBSTAMP(i) ((void)0)
#endif

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

struct Shared {
  unsigned long long mbar[2];        // the arrival of the peers' partials, per buffer
  float st[2][18];                   // accepted / trial state: T (16), ab (2)
  float sy[2][kNS];                  // their systems: H (36), b (8), E, counts (3)
  float red[kMaxWarps][kNS];         // the warps' partials
  float recv[2][kMaxCluster][kNS];   // the CTAs' partials by rank, double-buffered
  int ctl[2];                        // accepted index, done
  float4 pts[kStage];                // this CTA's points at the level: xh (2), idepth, color
  unsigned char pval[kStage];        // and valid
};

// Stage this thread's points of the level: its m-th point (g + m stride)
// at slot m blockDim + tid, while slots last. Only this thread reads them.
__device__ __forceinline__ void stage_points(Shared& s, const Level& L, const float4 in,
                                             int g, int stride) {
  const int nt = blockDim.x, mcap = kStage / nt;
  int m = 0;
  for (int i = g; i < L.N && m < mcap; i += stride, ++m) {
    const float u = __ldg(L.uv + 2 * i), v = __ldg(L.uv + 2 * i + 1);
    s.pts[m * nt + threadIdx.x] = make_float4((u - in.z) / in.x, (v - in.w) / in.y,
                                              __ldg(L.idepth + i), __ldg(L.color + i));
    s.pval[m * nt + threadIdx.x] = L.valid[i];
  }
}

// This thread's share of a lane's sums at the state st (T 16, ab 2): points
// g, g + stride, ... (from the stage, then from device memory). A point
// that is not valid adds nothing, so it is skipped.
__device__ __forceinline__ void point_sums(const Shared& s, const Level& L, const float4 in,
                                           float huber, const float* st, int g, int stride,
                                           float acc[kNS]) {
  const float fx = in.x, fy = in.y, cx = in.z, cy = in.w;
  const float R00 = st[0], R01 = st[1], R02 = st[2], t0 = st[3];
  const float R10 = st[4], R11 = st[5], R12 = st[6], t1 = st[7];
  const float R20 = st[8], R21 = st[9], R22 = st[10], t2 = st[11];
  const float ea = expf(st[16]), bb = st[17];
  // in_bounds(uv, w, h, 2): 2 <= u < w - 3, 2 <= v < h - 3
  const float u_hi = static_cast<float>(L.W) - 3.f, v_hi = static_cast<float>(L.H) - 3.f;
  const int nt = blockDim.x, mcap = kStage / nt;
#pragma unroll
  for (int i = 0; i < kNS; ++i) acc[i] = 0.f;
  int m = 0;
  for (int i = g; i < L.N; i += stride, ++m) {
    float xh0, xh1, id, col;
    bool val;
    if (m < mcap) {
      const float4 q = s.pts[m * nt + threadIdx.x];
      xh0 = q.x; xh1 = q.y; id = q.z; col = q.w;
      val = s.pval[m * nt + threadIdx.x] != 0;
    } else {
      const float u = __ldg(L.uv + 2 * i), v = __ldg(L.uv + 2 * i + 1);
      xh0 = (u - cx) / fx;
      xh1 = (v - cy) / fy;
      id = __ldg(L.idepth + i);
      col = __ldg(L.color + i);
      val = L.valid[i] != 0;
    }
    if (!val) continue;
    const float X0 = (R00 * xh0 + R01 * xh1 + R02) + t0 * id;
    const float X1 = (R10 * xh0 + R11 * xh1 + R12) + t1 * id;
    const float X2 = (R20 * xh0 + R21 * xh1 + R22) + t2 * id;
    const bool ok_z = X2 > 1e-6f;
    const float sz = ok_z ? X2 : 1.f;
    const float up = X0 / sz, vp = X1 / sz, nid = id / sz;
    const float un = fx * up + cx, vn = fy * vp + cy;
    const bool inb = (un >= 2.f) && (un < u_hi) && (vn >= 2.f) && (vn < v_hi) && ok_z;
    float hit[3];
    sample3(L.img3, L.H, L.W, inb ? un : 2.f, inb ? vn : 2.f, hit);
    const float r = (hit[0] - __fmul_rn(ea, col)) - bb;
    const float ar = fabsf(r);
    const bool sat = ar > L.cutoff;
    const float hw = ar < huber ? 1.f : huber / fmaxf(ar, 1e-12f);
    const float om = (inb && !sat) ? hw : 0.f;
    acc[kNC + 1] += inb ? 1.f : 0.f;
    acc[kNC + 2] += (sat && inb) ? 1.f : 0.f;
    if (om > 0.f) {
      acc[kNC] += 1.f;
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
}

using dsm::map_rank;
using dsm::mbar_expect;
using dsm::mbar_init;
using dsm::mbar_wait;
using dsm::smem_addr;
using dsm::st_async;
using dsm::warp_reduce_scatter;

// A lane's system at state index si into sy[si], as warp 0 of every CTA of
// the cluster sees it. Every thread takes part.
__device__ __forceinline__ void evaluate(Shared& s, unsigned C, unsigned rank,
                                         unsigned& mphase, const Level& L, float4 intr,
                                         float huber, int si, int pb, int g, int stride
#ifdef TRACK_LEVEL_PHASES
                                         , bool stamper, long long& t_last, long long ph[kPhases]
#endif
) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[kNS];
  point_sums(s, L, intr, huber, s.st[si], g, stride, acc);
  STAMP(0);
  const int base = warp_reduce_scatter(acc, lane);
  if ((lane & 1) == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) s.red[warp][base + j] = acc[j];
  }
  STAMP(1);
  __syncthreads();
  // lane l sums values l and 32 + (l & 15): every load first, then the sum
  // in a fixed order (the warps, then the CTAs)
  const int hi = 32 + (lane & 15);
  float v0 = 0.f, v1 = 0.f;
  if (warp == 0) {                   // the CTA's partial: the warps in order
    const int nw = blockDim.x >> 5;
    float x0[kMaxWarps], x1[kMaxWarps];
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w) {
      if (w < nw) {
        x0[w] = s.red[w][lane];
        x1[w] = s.red[w][hi];
      }
    }
    v0 = x0[0];
    v1 = x1[0];
#pragma unroll
    for (int w = 1; w < kMaxWarps; ++w) {
      if (w < nw) {
        v0 += x0[w];
        v1 += x1[w];
      }
    }
  }
  STAMP(2);
  if (warp == 0) {
    if (C == 1) {                    // the CTA's partial is the lane's system
      s.sy[si][lane] = v0;
      if (lane < 16) s.sy[si][hi] = v1;
    } else {
      // to every peer, then the peers' partials: the CTAs in rank order
      s.recv[pb][rank][lane] = v0;
      if (lane < 16) s.recv[pb][rank][hi] = v1;
      __syncwarp();                  // lane l reads what lane l & 15 wrote
      const unsigned bar = smem_addr(&s.mbar[pb]);
      const unsigned d0 = smem_addr(&s.recv[pb][rank][lane]);
      const unsigned d1 = smem_addr(&s.recv[pb][rank][hi]);
      for (unsigned r = 0; r < C; ++r) {
        if (r == rank) continue;
        const unsigned rb = map_rank(bar, r);
        st_async(map_rank(d0, r), v0, rb);
        if (lane < 16) st_async(map_rank(d1, r), v1, rb);
      }
      mbar_wait(bar, (mphase >> pb) & 1u);
      mphase ^= 1u << pb;
      float y0[kMaxCluster], y1[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < static_cast<int>(C)) {
          y0[r] = s.recv[pb][r][lane];
          y1[r] = s.recv[pb][r][hi];
        }
      }
      float w0 = y0[0], w1 = y1[0];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r) {
        if (r < static_cast<int>(C)) {
          w0 += y0[r];
          w1 += y1[r];
        }
      }
      s.sy[si][lane] = w0;
      if (lane < 16) s.sy[si][hi] = w1;
      if (lane == 0) mbar_expect(bar, (C - 1) * kNS * 4);   // the buffer's next use
    }
    __syncwarp();
  }
  STAMP(3);
}

// One damped LM step by warp 0 from the system sys at state st: every
// thread of the warp solves the whole 8x9 system [Hd | b] in its own
// registers (static indices, no traffic between threads), so that no
// column waits on a shuffle. Writes exp(step[:6]) T and ab + step[6:] to
// trial; returns max|step|.
__device__ float lm_step_warp(const float* sys, float lam, const float* st, float* trial,
                              int lane, long long* sub) {
#ifdef TRACK_LEVEL_PHASES
  long long t_sub = clock64();
#endif
  float tr = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) tr += sys[tri(i, i)];
  const float damp = 1e-4f * fmaxf(tr / 8.f, 1e-6f);
  float A[8][9];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) A[i][j] = sys[i <= j ? tri(i, j) : tri(j, i)];
    A[i][i] = __fadd_rn(__fmul_rn(A[i][i], 1.f + lam), damp);
    A[i][8] = sys[kNB + i];
  }
  SUBSTAMP(0);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    // pivot: getrf's scan, the first row of largest |a| (a strict compare:
    // a NaN never wins, a NaN diagonal keeps row k)
    int piv = k;
    float best = fabsf(A[k][k]);
    float inv = __frcp_rn(A[k][k]);  // beside the search: the pivot is mostly the diagonal
#pragma unroll
    for (int i = k + 1; i < 8; ++i) {
      const float v = fabsf(A[i][k]);
      if (v > best) { best = v; piv = i; }
    }
    if (piv != k) {                  // the same for every thread: no divergence
#pragma unroll
      for (int j = k; j < 9; ++j) {  // swap rows k and piv
        const float rk = A[k][j];
        float x = rk;
#pragma unroll
        for (int i = k + 1; i < 8; ++i) {
          const float ai = A[i][j];
          x = piv == i ? ai : x;
          A[i][j] = piv == i ? rk : ai;
        }
        A[k][j] = x;
      }
      inv = __frcp_rn(A[k][k]);
    }
#pragma unroll
    for (int i = k + 1; i < 8; ++i) {
      const float l = A[i][k] * inv;
#pragma unroll
      for (int j = k + 1; j < 9; ++j) A[i][j] -= l * A[k][j];
    }
  }
  SUBSTAMP(1);
  float step[8], rhs[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rhs[i] = A[i][8];
#pragma unroll
  for (int k = 7; k >= 0; --k) {     // column by column, as trsm
    const float xk = rhs[k] / A[k][k];
    step[k] = -xk;
#pragma unroll
    for (int i = 0; i < k; ++i) rhs[i] -= A[i][k] * xk;
  }
  float max_step = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) max_step = fmaxf(max_step, fabsf(step[i]));

  SUBSTAMP(2);
  // se3_exp([rho, phi]) with the small-angle branches of math/lie.py
  const float r0 = step[0], r1 = step[1], r2 = step[2];
  const float p0 = step[3], p1 = step[4], p2 = step[5];
  const float tsq = p0 * p0 + p1 * p1 + p2 * p2;
  float ca, cb, cc;                  // one branch for the whole warp
  if (tsq < kLieEps) {
    ca = 1.f - tsq / 6.f;
    cb = 0.5f - tsq / 24.f;
    cc = 1.f / 6.f - tsq / 120.f;
  } else {
    const float th = sqrtf(tsq);
    const float sn = sinf(th), cs = cosf(th);
    ca = sn / th;
    cb = (1.f - cs) / tsq;
    cc = (th - sn) / (tsq * th);
  }
  const float Kx[9] = {0.f, -p2, p1, p2, 0.f, -p0, -p1, p0, 0.f};     // hat(phi)
  float K2[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      K2[3 * i + j] = Kx[3 * i] * Kx[j] + Kx[3 * i + 1] * Kx[3 + j] + Kx[3 * i + 2] * Kx[6 + j];
  float D[16];                                                  // exp(step[:6])
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float V[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float e = (i == j) ? 1.f : 0.f;
      D[4 * i + j] = e + ca * Kx[3 * i + j] + cb * K2[3 * i + j];
      V[j] = e + cb * Kx[3 * i + j] + cc * K2[3 * i + j];
    }
    D[4 * i + 3] = V[0] * r0 + V[1] * r1 + V[2] * r2;
  }
  D[12] = 0.f; D[13] = 0.f; D[14] = 0.f; D[15] = 1.f;
  // entry (i, j) of exp(step[:6]) T by thread 4 i + j
  const int qi = (lane >> 2) & 3, qj = lane & 3;
  float d[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    d[c] = qi == 0 ? D[c] : (qi == 1 ? D[4 + c] : (qi == 2 ? D[8 + c] : D[12 + c]));
  const float t = d[0] * st[qj] + d[1] * st[4 + qj] + d[2] * st[8 + qj] + d[3] * st[12 + qj];
  if (lane < 16) trial[lane] = t;
  if (lane == 16) trial[16] = st[16] + step[6];
  if (lane == 17) trial[17] = st[17] + step[7];
  SUBSTAMP(3);
  return max_step;
}

// The lane that torch.argmin(nan_to_num(rm, nan=inf, posinf=inf,
// neginf=inf)) picks, by warp 0: lane l scans entries l, l + 32, ...
// keeping the first smallest, then a butterfly keeps the smaller value and
// at equal values the lower index. Every lane returns it.
__device__ int pick_winner(const float* rm, int k_in, int lane) {
  float v = __int_as_float(0x7f800000);
  int idx = 0x7fffffff;
  for (int q = lane; q < k_in; q += 32) {
    float x = rm[q];
    if (isnan(x) || isinf(x)) x = __int_as_float(0x7f800000);
    if (idx == 0x7fffffff || x < v) { v = x; idx = q; }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    if (ov < v || (ov == v && oi < idx)) { v = ov; idx = oi; }
  }
  return idx;
}

__global__ void __launch_bounds__(kMaxThreads) track_levels_kernel(const __grid_constant__ Params p) {
  __shared__ Shared s;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned C = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int k = blockIdx.x / C;      // the lane
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = rank * blockDim.x + tid, stride = C * blockDim.x;
  const bool writer = rank == 0 && warp == 0;
#ifdef TRACK_LEVEL_PHASES
  const bool stamper = rank == 0 && tid == 0;
  long long ph[kPhases];
  long long t_last = clock64();
#define PH_ARGS , stamper, t_last, ph
#define SUB (stamper ? ph + 8 : nullptr)
#else
#define PH_ARGS
#define SUB nullptr
#endif

  if (warp == 0) {
    int src = k;
    if (p.pick_rmse != nullptr) {
      src = pick_winner(p.pick_rmse, p.k_in, lane);
      if (rank == 0 && k == 0 && lane == 0) *p.best_out = src;
    }
    if (lane < 16) s.st[0][lane] = p.T0[src * p.T0_stride + lane];
    else if (lane < 18) s.st[0][lane] = p.ab0[src * p.ab0_stride + lane - 16];
  }
  if (C > 1) {                       // arm both buffers' barriers before any peer sends
    if (tid == 0) {
      const unsigned b0 = smem_addr(&s.mbar[0]), b1 = smem_addr(&s.mbar[1]);
      mbar_init(b0);
      mbar_init(b1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      mbar_expect(b0, (C - 1) * kNS * 4);
      mbar_expect(b1, (C - 1) * kNS * 4);
    }
    cluster.sync();
  }
  int c = 0;                         // the accepted state's index
  int pb = 0;                        // the partial buffer of the next evaluation
  unsigned mphase = 0;               // warp 0's: the phase parity of each buffer's barrier
  for (int li = 0; li < p.n_levels; ++li) {
    const Level& L = p.lv[li];
    const float4 intr = make_float4(__ldg(p.intr + 4 * L.intr_row), __ldg(p.intr + 4 * L.intr_row + 1),
                                    __ldg(p.intr + 4 * L.intr_row + 2), __ldg(p.intr + 4 * L.intr_row + 3));
#ifdef TRACK_LEVEL_PHASES
#pragma unroll
    for (int i = 0; i < kPhases; ++i) ph[i] = 0;
    const long long t_level = clock64();
    t_last = t_level;
#endif
    stage_points(s, L, intr, g, stride);
    __syncthreads();
    evaluate(s, C, rank, mphase, L, intr, p.huber, c, pb, g, stride PH_ARGS);
    pb ^= 1;
    float lam = p.lam0, max_step = 0.f;  // warp 0's
    int64_t ok_sum = 0;              // warp 0's: n_ok over the level's evaluations
    float e_cur = 0.f;               // warp 0's: the accepted state's energy per point
    if (warp == 0) {
      ok_sum = static_cast<int64_t>(s.sy[c][kNC]);
      e_cur = s.sy[c][kNE] / fmaxf(s.sy[c][kNC], 1.f);
    }
    if (warp == 0 && L.iters > 0)
      max_step = lm_step_warp(s.sy[c], lam, s.st[c], s.st[1 - c], lane, SUB);
    STAMP(4);
    __syncthreads();
    STAMP(5);
    int it = 0;
    bool done = false;
    while (it < L.iters && !done) {
      const int t = 1 - c;
      evaluate(s, C, rank, mphase, L, intr, p.huber, t, pb, g, stride PH_ARGS);
      pb ^= 1;
      if (warp == 0) {
        const float e_new = s.sy[t][kNE] / fmaxf(s.sy[t][kNC], 1.f);
        const bool accept = e_new < e_cur;
        if (accept) e_cur = e_new;
        ok_sum += static_cast<int64_t>(s.sy[t][kNC]);
        const int c_next = accept ? t : c;
        lam = accept ? fmaxf(lam * p.lam_success, 1e-5f) : lam * p.lam_fail;
        const bool d = (accept && max_step < p.step_eps) || lam > 1e3f;
        if (!d && it + 1 < L.iters)
          max_step = lm_step_warp(s.sy[c_next], lam, s.st[c_next], s.st[1 - c_next], lane, SUB);
        if (lane == 0) {
          s.ctl[0] = c_next;
          s.ctl[1] = d;
        }
      }
      STAMP(4);
      __syncthreads();
      STAMP(5);
      c = s.ctl[0];
      done = s.ctl[1] != 0;
      ++it;
    }
    if (writer) {
      const int o = L.slot * p.lanes_cap + k;
      if (lane < 16) p.T_out[16 * o + lane] = s.st[c][lane];
      else if (lane < 18) p.ab_out[2 * o + lane - 16] = s.st[c][lane];
      else if (lane == 18) p.rmse_out[o] = sqrtf(e_cur);
      else if (lane == 19) p.n_ok_out[o] = static_cast<int64_t>(s.sy[c][kNC]);
      else if (lane == 20) p.n_in_out[o] = static_cast<int64_t>(s.sy[c][kNC + 1]);
      else if (lane == 21) p.n_sat_out[o] = static_cast<int64_t>(s.sy[c][kNC + 2]);
      else if (lane == 22) p.n_iter_out[o] = it;
      else if (lane == 23) p.n_ok_sum_out[o] = ok_sum;
    }
#ifdef TRACK_LEVEL_PHASES
    if (stamper && p.phases_out != nullptr) {
      long long* out = p.phases_out + kPhases * (L.slot * p.lanes_cap + k);
      for (int i = 0; i < 6; ++i) out[i] = ph[i];
      out[6] = clock64() - t_level;
      out[7] = 1 + it;               // evaluations
      for (int i = 8; i < kPhases; ++i) out[i] = ph[i];
    }
#endif
  }
  // no CTA leaves while a peer may still send into its shared memory
  if (C > 1) cluster.sync();
}

}  // namespace

// One launch: lanes clusters of `cluster` CTAs of `threads` threads.
// levels: n_levels entries of 5 pointers (img3, uv, idepth, color, valid),
// 6 ints (H, W, N, iters, intr_row, slot) and a cutoff.
extern "C" int ldso_track_levels(
    const void* const* level_ptrs, const int* level_ints, const float* cutoffs, int n_levels,
    const void* intr, const void* T0, int T0_stride, const void* ab0, int ab0_stride,
    const void* pick_rmse, int k_in, int lanes, int lanes_cap, int cluster, int threads,
    float huber, float lam0, float lam_success, float lam_fail, float step_eps,
    void* T_out, void* ab_out, void* rmse_out, void* n_ok_out, void* n_in_out,
    void* n_sat_out, void* n_iter_out, void* n_ok_sum_out, void* best_out, void* phases_out,
    void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || lanes < 1 || lanes > lanes_cap
      || cluster < 1 || cluster > kMaxCluster || threads < 32 || threads > kMaxThreads
      || threads % 32 != 0 || (pick_rmse != nullptr && (k_in < 1 || best_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  for (int i = 0; i < n_levels; ++i) {
    Level& L = p.lv[i];
    L.img3 = static_cast<const float*>(level_ptrs[5 * i]);
    L.uv = static_cast<const float*>(level_ptrs[5 * i + 1]);
    L.idepth = static_cast<const float*>(level_ptrs[5 * i + 2]);
    L.color = static_cast<const float*>(level_ptrs[5 * i + 3]);
    L.valid = static_cast<const unsigned char*>(level_ptrs[5 * i + 4]);
    L.H = level_ints[6 * i];
    L.W = level_ints[6 * i + 1];
    L.N = level_ints[6 * i + 2];
    L.iters = level_ints[6 * i + 3];
    L.intr_row = level_ints[6 * i + 4];
    L.slot = level_ints[6 * i + 5];
    L.cutoff = cutoffs[i];
  }
  p.n_levels = n_levels;
  p.intr = static_cast<const float*>(intr);
  p.T0 = static_cast<const float*>(T0);
  p.ab0 = static_cast<const float*>(ab0);
  p.T0_stride = T0_stride;
  p.ab0_stride = ab0_stride;
  p.pick_rmse = static_cast<const float*>(pick_rmse);
  p.k_in = k_in;
  p.lanes_cap = lanes_cap;
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
  p.best_out = static_cast<int32_t*>(best_out);
  p.phases_out = static_cast<long long*>(phases_out);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lanes * cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, track_levels_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
