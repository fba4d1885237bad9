// The windowed BA's linearization (K4): every (point, target slot, pattern
// point) residual of the window, its FEJ Jacobians and Huber weight, and the
// block-structured Gauss-Newton system they make, in two launches an
// evaluation (ba_linearize, then ba_reduce).
//
// Replaces the XLA program of ldso_tpu/ba/residuals.py::assemble (:153-368,
// with precompute_pairs :80) and that of energy_only (:372-417); the JAX
// package has no Pallas source for either. The plain versions are the port's
// ba/residuals.assemble_torch and energy_only_torch; the per-slot-pair work
// (precompute_pairs: the [F, F] relative poses, FEJ adjoints and affine
// transfers) stays in torch before the launch and comes in as flat tables
// (ba/residuals.ba_slot_tables).
//
// Contract (that of assemble_torch), per point p with host slot h and target
// slot f, pattern point k: the current projection of (u, v) + pattern[k]
// through c, R_cur[h, f], t_cur[h, f] and the current inverse depth, in
// bounds at border 2 with z > 1e-6; the FEJ projection of the centre through
// c_zero, R_fej, t_fej and idepth_zero, also in bounds with z > 1e-6, gives
// the geometric Jacobians (pose 2x6, intrinsics 2x4, inverse depth 2) shared
// by the 8 pattern points; a sample is valid when both projections are, the
// pair's res_mask, the point's p_valid and the slot's frame_valid hold. A
// valid sample reads the clamped bilinear (I, dx, dy) of images[f], makes
// r = I - b_t - alpha_cur (color - b_h), the gradient weight
// sqrt(s / (s + |g|^2)), w = ((w_tgt + weight) / 2)^2 * huber weight, the
// energy w r^2 (2 - hw), and the rows target8 = [g Jp_pose, -a_fej col0, -1],
// host8 = [-(g Jp_pose) Adj_fej, a_fej col0, a_fej], cam4 = g Jp_cam,
// d = g Jp_d; in mode fej the residual of the gradient is
// r - (target8 dF[f] + host8 dF[h] + cam4 dC + d (idepth - idepth_zero)).
// An invalid sample contributes nothing (in the plain version its weight
// is 0 and every factor finite, so its terms are exact zeros): it is
// skipped here. energy_only is the same first pass without the FEJ
// projection's test or any Jacobian (its validity is the plain
// energy_only_torch's: the current projection, res_mask, p_valid,
// frame_valid), writing each point's energy and count.
//
// Order of the sums, fixed, so that a second launch on the same inputs
// gives the same bits (no atomics anywhere):
//   ba_linearize, a warp a point, lane 8 g + k = target slot 4 pass + g,
//   pattern point k (3 passes for F = 10). Each lane's sample values go to
//   the warp's shared memory; a pair's sums (TT, HT, TC, BT, hx_t, e_pair)
//   run over k = 0..7 in order, on the group's lane that owns the entry; a
//   point's sums over all its pairs (HH, HC, BH, CC, BC, hx_h, hx_c, H_dd,
//   b_d, energy, count) run pass by pass, each pass's 32 samples in lane
//   order, on the lane that owns the entry. The pair sums are written to the
//   point's record (zeros for a pair with no valid sample), the point sums
//   after the last pass; H_xd, H_dd, b_d, e_pair and the masks are written
//   straight to their outputs (the host block of H_xd as hx_t + hx_h).
//   ba_reduce, a thread per (entry of H, b, energy or count; slice of
//   points): the entry's terms are read from each point's record by the
//   caller's table (kernels/ba.reduce_table: up to 4 record words, each
//   counted always or only when the point's host is a given slot); a
//   point's terms are added in table order, the points of a slice in point
//   order; the 32 slices (contiguous ranges of points) are then added in
//   slice order. The entry is written to H at (row, col) and (col, row).
//
// What bounds it on Hopper: bytes. A default window (2048 points, 10 slots
// of 640x480 (I, dx, dy), 163,840 samples) needs each point's inputs once
// (~90 B), the distinct texels of the valid samples (at most 7.9 MB at 12 B
// a corner, less as neighbouring samples share texels) and the outputs
// once (H_xd is 0.69 MB of them): a few microseconds at 3.35 TB/s, against
// ~100 Mflop, a microsecond and a half at 67 TFLOP/s. The torch composition
// it replaces spends its time on ~150 launches and on intermediates written
// to device memory: the window's corner pack (147 MB a call), the [P, F, 8, 8]
// row factors and the [P, F, 8, 8] cross blocks. This design keeps a
// sample's Jacobians in registers and shared memory, gathers the four
// corners straight from the [F, H, W, 3] stacks (no corner pack), and
// writes only the compact per-point record (140 floats a pair, 92 a point:
// 12 MB for the default window) that the second launch reads back, once,
// mostly from L2. The record is what makes the cross-point sums
// deterministic without atomics; its traffic, and the reduce's loop over
// every point for each of the 3,656 entries, are what keep this first
// version above its bound.
//
// To follow the plain version's float32 rounding up to the order of the
// sums, every expression keeps torch's operation order (each torch operator
// rounds its result): the file is built with -fmad=false (kernels/ba.py), so
// nvcc contracts nothing, and the plain version's small matrix products
// (cuBLAS, accumulating by fused multiply-adds from the first index) are
// written out as fmaf chains: the projections, g Jp_pose, g Jp_cam, g Jp_d,
// the adjoint and the transported residual. A residual is then the plain
// version's bit for bit where the pair tables are, and the outputs part
// only by the order of their sums (a residual several ulps apart moves a
// gradient entry that cancels, such as b_d, by far more: seen with
// contraction on, 0.3% of a point's b_d).
//
// Plain C interface (bound with ctypes): the entry points launch on the
// given stream, allocate nothing, do not synchronise, and return the
// cudaError_t of the launch.

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;               // 4 points (warps) a CTA
constexpr int kMaxSlots = 32;
constexpr unsigned kFull = 0xffffffffu;
// the pair table of ba/residuals.ba_slot_tables, per [host, target]
constexpr int kPairTable = 62;              // R_cur 9, t_cur 3, R_fej 9, t_fej 3, adj 36, alpha_cur, alpha_fej
constexpr int kRcur = 0, kTcur = 9, kRfej = 12, kTfej = 21, kAdj = 24, kAcur = 60, kAfej = 61;
// the per-point record (kernels/ba.py's PAIR_WORDS / POINT_WORDS)
constexpr int kPairWords = 140;             // per target slot: TT 36, HT 64, TC 32, BT 8
constexpr int kHT = 36, kTC = 100, kBT = 132;    // TT at 0
constexpr int kPointWords = 92;             // HH 36, HC 32, BH 8, CC 10, BC 4, energy, count
constexpr int kPairOut = 149;               // a pair's sums: the record's 140, hx_t 8, e_pair
constexpr int kPointOut = 106;              // a point's sums: the record's 90 + E + N, hx_h 8, hx_c 4, H_dd, b_d
constexpr int kOutHx = 90, kOutHc = 98, kOutHdd = 102, kOutBd = 103, kOutE = 104, kOutN = 105;
constexpr int kSample = 24;                 // a sample in shared memory: t 8, h 8, c 4, d, w, wr, e
constexpr int kSlices = 32;                 // ba_reduce: slices of points, a warp each
constexpr int kTableWords = 12;             // kernels/ba.reduce_table's row

// core/window.PATTERN_OFFSETS (config.PATTERN)
__constant__ float kPat[8][2] = {{0.f, -2.f}, {-1.f, -1.f}, {1.f, -1.f}, {-2.f, 0.f},
                                 {0.f, 0.f},  {2.f, 0.f},   {-1.f, 1.f}, {0.f, 2.f}};

struct LinParams {
  const float* images;                 // [F, H, W, 3] level-0 (I, dx, dy)
  int H, W, P, F;
  const unsigned char* frame_valid;    // [F] bool
  const float* pair;                   // [F, F, kPairTable] per [host, target]
  const float* slot;                   // [F, 3] b_host_cur, b_host_fej, b_tgt_cur
  const float* c;                      // [4] current intrinsics
  const float* c_zero;                 // [4] FEJ intrinsics
  const unsigned char* p_valid;        // [P] bool
  const int32_t* p_host;               // [P]
  const float* p_uv;                   // [P, 2]
  const float* p_color;                // [P, 8]
  const float* p_weight;               // [P, 8]
  const float* p_idepth;               // [P]
  const float* p_idepth_zero;          // [P]
  const unsigned char* res_mask;       // [P, F] bool
  const float* delta;                  // [8F + 4] state delta (mode fej), else null
  float huber, outlier_sum;
  int energy_only;
  float* record;                       // [P, R]: R = F kPairWords + kPointWords, or 2 (energy_only)
  float* H_xd;                         // [P, 8F + 4]
  float* H_dd;                         // [P]
  float* b_d;                          // [P]
  float* e_pair;                       // [P, F]
  unsigned char* valid_pair;           // [P, F] bool
  unsigned char* oob_pair;             // [P, F] bool
};

struct ReduceParams {
  const int32_t* table;                // [n, kTableWords]
  int n, P, R, F;
  const float* record;                 // [P, R]
  const int32_t* p_host;               // [P]
  float* out;                          // H, b, energy (flat), as the table's out columns say
  long long* count;                    // [1]
};

// kernels/interp.in_bounds at border 2
__device__ __forceinline__ bool in_bounds2(float u, float v, int W, int H) {
  return u >= 2.f && u < static_cast<float>(W) - 3.f && v >= 2.f
      && v < static_cast<float>(H) - 3.f;
}

// the clamped bilinear (I, dx, dy) of kernels/interp.bilinear_packed: the
// 2x2 footprint's origin clamped into the image, its far corners to the
// last row and column (pack_corners replicates them)
__device__ __forceinline__ void sample3(const float* __restrict__ img, int W, int H, float u,
                                        float v, float out[3]) {
  const int iu = static_cast<int>(floorf(u)), iv = static_cast<int>(floorf(v));
  const float du = u - static_cast<float>(iu), dv = v - static_cast<float>(iv);
  const int u0 = min(max(iu, 0), W - 1), v0 = min(max(iv, 0), H - 1);
  const int u1 = min(u0 + 1, W - 1), v1 = min(v0 + 1, H - 1);
  const float* c00 = img + 3 * (v0 * W + u0);
  const float* c10 = img + 3 * (v0 * W + u1);
  const float* c01 = img + 3 * (v1 * W + u0);
  const float* c11 = img + 3 * (v1 * W + u1);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float top = __ldg(c00 + i) * (1.f - du) + __ldg(c10 + i) * du;
    const float bot = __ldg(c01 + i) * (1.f - du) + __ldg(c11 + i) * du;
    out[i] = top * (1.f - dv) + bot * dv;
  }
}

// the entry (a, b) of the upper triangle at packed index i
__device__ __forceinline__ void sym_entry(int i, int n, int& a, int& b) {
  a = 0;
  while (i >= n - a) {
    i -= n - a;
    ++a;
  }
  b = a + i;
}

// R x + t s for a row-major 3x3 R (a matrix product and an add, as the
// plain version's einsum and add)
__device__ __forceinline__ void transform(const float* T, int rot, int tr, const float x[3],
                                          float s, float X[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    X[i] = fmaf(T[rot + 3 * i + 2], x[2], fmaf(T[rot + 3 * i + 1], x[1], T[rot + 3 * i] * x[0]))
           + T[tr + i] * s;
}

// a pair's sum number o (0 <= o < kPairOut) over the 8 samples of group g
__device__ __forceinline__ float pair_sum(const float* s, int g, int o) {
  float acc = 0.f;
  if (o < kHT) {
    int a, b;
    sym_entry(o, 8, a, b);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float* x = s + (8 * g + k) * kSample;
      acc += (x[21] * x[a]) * x[b];
    }
  } else if (o < kTC) {
    const int a = (o - kHT) >> 3, b = (o - kHT) & 7;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float* x = s + (8 * g + k) * kSample;
      acc += (x[21] * x[8 + a]) * x[b];
    }
  } else if (o < kBT) {
    const int a = (o - kTC) >> 2, j = (o - kTC) & 3;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float* x = s + (8 * g + k) * kSample;
      acc += (x[21] * x[a]) * x[16 + j];
    }
  } else if (o < kPairWords) {
    const int a = o - kBT;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float* x = s + (8 * g + k) * kSample;
      acc += x[a] * x[22];
    }
  } else if (o < kPairWords + 8) {
    const int a = o - kPairWords;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float* x = s + (8 * g + k) * kSample;
      acc += x[a] * (x[21] * x[20]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += s[(8 * g + k) * kSample + 23];
  }
  return acc;
}

// a point's sum number o (0 <= o < kPointOut) over one pass's 32 samples,
// in lane order, added to acc; n_valid counts the pass's valid samples
__device__ __forceinline__ float point_sum(const float* s, int o, float acc, unsigned valid) {
  if (o == kOutN) return acc + static_cast<float>(__popc(valid));
  for (int l = 0; l < 32; ++l) {
    if (!((valid >> l) & 1u)) continue;          // an invalid sample adds exact zeros
    const float* x = s + l * kSample;
    const float w = x[21], wr = x[22], wd = w * x[20];
    float v;
    if (o < 36) {
      int a, b;
      sym_entry(o, 8, a, b);
      v = (w * x[8 + a]) * x[8 + b];
    } else if (o < 68) {
      v = (w * x[8 + ((o - 36) >> 2)]) * x[16 + ((o - 36) & 3)];
    } else if (o < 76) {
      v = x[8 + (o - 68)] * wr;
    } else if (o < 86) {
      int i, j;
      sym_entry(o - 76, 4, i, j);
      v = (w * x[16 + i]) * x[16 + j];
    } else if (o < 90) {
      v = x[16 + (o - 86)] * wr;
    } else if (o < kOutHc) {
      v = x[8 + (o - kOutHx)] * wd;
    } else if (o < kOutHdd) {
      v = x[16 + (o - kOutHc)] * wd;
    } else if (o == kOutHdd) {
      v = wd * x[20];
    } else if (o == kOutBd) {
      v = x[20] * wr;
    } else {
      v = x[23];
    }
    acc += v;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads) ba_linearize_kernel(const __grid_constant__ LinParams p) {
  __shared__ float smem[kThreads / 32][32 * kSample + 8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pt = blockIdx.x * (kThreads / 32) + warp;
  if (pt >= p.P) return;
  float* s = smem[warp];
  float* s_hx = s + 32 * kSample;        // hx_t of the host's own slot
  const int F = p.F, D = 8 * F + 4;
  const int g = lane >> 3, k = lane & 7;
  const int h = min(max(static_cast<int>(p.p_host[pt]), 0), F - 1);
  const bool pv = p.p_valid[pt] != 0;
  const float fx = p.c[0], fy = p.c[1], cx = p.c[2], cy = p.c[3];
  const float fx0 = p.c_zero[0], fy0 = p.c_zero[1], cx0 = p.c_zero[2], cy0 = p.c_zero[3];
  const float u = p.p_uv[2 * pt], v = p.p_uv[2 * pt + 1];
  const float xh[3] = {((u + kPat[k][0]) - cx) / fx, ((v + kPat[k][1]) - cy) / fy, 1.f};
  const float xc[3] = {(u - cx0) / fx0, (v - cy0) / fy0, 1.f};
  const float idepth = p.p_idepth[pt], idepth0 = p.p_idepth_zero[pt];
  const float color = p.p_color[8 * pt + k], weight = p.p_weight[8 * pt + k];
  const float bh_cur = p.slot[3 * h], bh_fej = p.slot[3 * h + 1];
  const size_t plane = static_cast<size_t>(p.H) * p.W * 3;
  const int R = p.energy_only ? 2 : F * kPairWords + kPointWords;
  float* rec = p.record + static_cast<size_t>(pt) * R;
  // lane l owns the point sums l, l + 32, l + 64, l + 96
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float e_own = 0.f, n_own = 0.f;        // energy_only: this lane's samples
  const int passes = (F + 3) / 4;
  for (int pass = 0; pass < passes; ++pass) {
    const int f = 4 * pass + g;
    const bool requested = f < F && pv && p.res_mask[pt * F + f] && p.frame_valid[f];
    bool valid = false;
    float t8[8], h8[8], c4[4], d = 0.f, w = 0.f, wr = 0.f, e = 0.f;
    if (requested) {
      const float* T = p.pair + (h * F + f) * kPairTable;
      float X[3];
      transform(T, kRcur, kTcur, xh, idepth, X);
      const bool okz = X[2] > 1e-6f;
      const float zs = okz ? X[2] : 1.f;
      const float un = (fx * X[0]) / zs + cx, vn = (fy * X[1]) / zs + cy;
      valid = okz && in_bounds2(un, vn, p.W, p.H);
      float up0 = 0.f, vp0 = 0.f, dre = 1.f;
      if (valid && !p.energy_only) {
        float X0[3];
        transform(T, kRfej, kTfej, xc, idepth0, X0);
        const bool ok0 = X0[2] > 1e-6f;
        dre = 1.f / (ok0 ? X0[2] : 1.f);
        up0 = X0[0] * dre;
        vp0 = X0[1] * dre;
        valid = ok0 && in_bounds2(fx0 * up0 + cx0, fy0 * vp0 + cy0, p.W, p.H);
      }
      if (valid) {
        float hit[3];
        sample3(p.images + f * plane, p.W, p.H, un, vn, hit);
        const float r = (hit[0] - p.slot[3 * f + 2]) - T[kAcur] * (color - bh_cur);
        const float gx = hit[1], gy = hit[2];
        const float w_tgt = sqrtf(p.outlier_sum / (p.outlier_sum + (gx * gx + gy * gy)));
        const float w_stat = 0.5f * (w_tgt + weight);
        const float ar = fabsf(r);
        const float hw = ar < p.huber ? 1.f : p.huber / fmaxf(ar, 1e-12f);
        w = (w_stat * w_stat) * hw;
        e = ((w * r) * r) * (2.f - hw);
        if (!p.energy_only) {
          // the geometric Jacobians at the FEJ state (assemble_torch's
          // _pose_jacobian, _cam_jacobian and Jp_d), then times g
          const float nid = idepth0 * dre;
          const float Ju[6] = {nid * fx0, 0.f, ((-nid) * up0) * fx0, ((-up0) * vp0) * fx0,
                               (1.f + up0 * up0) * fx0, (-vp0) * fx0};
          const float Jv[6] = {0.f, nid * fy0, ((-nid) * vp0) * fy0,
                               (-(1.f + vp0 * vp0)) * fy0, (up0 * vp0) * fy0, up0 * fy0};
#pragma unroll
          for (int j = 0; j < 6; ++j) t8[j] = fmaf(gy, Jv[j], gx * Ju[j]);
#pragma unroll
          for (int j = 0; j < 6; ++j) {
            float a = 0.f;
#pragma unroll
            for (int i = 0; i < 6; ++i) a = fmaf(t8[i], T[kAdj + 6 * i + j], a);
            h8[j] = -a;
          }
          // d(normalized host dir)/d(fx, fy, cx, cy), through R_fej's first two columns
          const float dxh[4] = {-xc[0] / fx0, 0.f, -1.f / fx0, 0.f};
          const float dyh[4] = {0.f, -xc[1] / fy0, 0.f, -1.f / fy0};
          const float* Rf = T + kRfej;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float dX0 = Rf[0] * dxh[j] + Rf[1] * dyh[j];
            const float dX1 = Rf[3] * dxh[j] + Rf[4] * dyh[j];
            const float dX2 = Rf[6] * dxh[j] + Rf[7] * dyh[j];
            const float cu = fx0 * (dre * (dX0 - up0 * dX2)) + (j == 0 ? up0 : j == 2 ? 1.f : 0.f);
            const float cv = fy0 * (dre * (dX1 - vp0 * dX2)) + (j == 1 ? vp0 : j == 3 ? 1.f : 0.f);
            c4[j] = fmaf(gy, cv, gx * cu);
          }
          const float* tf = T + kTfej;
          d = fmaf(gy, (fy0 * dre) * (tf[1] - tf[2] * vp0), gx * ((fx0 * dre) * (tf[0] - tf[2] * up0)));
          const float a_fej = T[kAfej], col0 = color - bh_fej;
          t8[6] = -a_fej * col0;
          t8[7] = -1.f;
          h8[6] = a_fej * col0;
          h8[7] = a_fej;
          float r_used = r;
          if (p.delta) {
            const float* dF = p.delta;
            float jd = 0.f;
#pragma unroll
            for (int a = 0; a < 8; ++a) jd = fmaf(t8[a], dF[8 * f + a], jd);
            float jh = 0.f;
#pragma unroll
            for (int a = 0; a < 8; ++a) jh = fmaf(h8[a], dF[8 * h + a], jh);
            float jc = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) jc = fmaf(c4[j], dF[8 * F + j], jc);
            r_used = r - (((jd + jh) + jc) + d * (idepth - idepth0));
          }
          wr = w * r_used;
        }
      }
    }
    if (p.energy_only) {
      e_own += e;
      n_own += valid ? 1.f : 0.f;
      continue;
    }
    if (!valid) {
#pragma unroll
      for (int j = 0; j < 8; ++j) t8[j] = h8[j] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) c4[j] = 0.f;
    }
    float* mine = s + lane * kSample;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mine[j] = t8[j];
      mine[8 + j] = h8[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) mine[16 + j] = c4[j];
    mine[20] = d;
    mine[21] = w;
    mine[22] = wr;
    mine[23] = e;
    const unsigned vmask = __ballot_sync(kFull, valid);
    __syncwarp();
    if (f < F) {
      // the pair's sums: entry o on the group's lane o % 8
      float* prec = rec + f * kPairWords;
      for (int o = k; o < kPairOut; o += 8) {
        const float x = pair_sum(s, g, o);
        if (o < kPairWords) {
          prec[o] = x;
        } else if (o < kPairWords + 8) {
          if (f == h)
            s_hx[o - kPairWords] = x;
          else
            p.H_xd[static_cast<size_t>(pt) * D + 8 * f + (o - kPairWords)] = x;
        } else {
          p.e_pair[pt * F + f] = x;
        }
      }
      if (k == 0) {
        const bool any = ((vmask >> (8 * g)) & 0xffu) != 0u;
        p.valid_pair[pt * F + f] = any;
        p.oob_pair[pt * F + f] = requested && !any;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (lane + 32 * q < kPointOut) acc[q] = point_sum(s, lane + 32 * q, acc[q], vmask);
    __syncwarp();
  }
  if (p.energy_only) {
    // the lanes' sums by a fixed shuffle tree
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      e_own += __shfl_down_sync(kFull, e_own, off);
      n_own += __shfl_down_sync(kFull, n_own, off);
    }
    if (lane == 0) {
      rec[0] = e_own;
      rec[1] = n_own;
    }
    return;
  }
  float* prec = rec + F * kPairWords;
  float* hx = p.H_xd + static_cast<size_t>(pt) * D;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int o = lane + 32 * q;
    const float x = acc[q];
    if (o < 90) {
      prec[o] = x;
    } else if (o < kOutHc) {
      hx[8 * h + (o - kOutHx)] = s_hx[o - kOutHx] + x;
    } else if (o < kOutHdd) {
      hx[8 * F + (o - kOutHc)] = x;
    } else if (o == kOutHdd) {
      p.H_dd[pt] = x;
    } else if (o == kOutBd) {
      p.b_d[pt] = x;
    } else if (o == kOutE) {
      prec[90] = x;
    } else if (o == kOutN) {
      prec[91] = x;
    }
  }
}

__global__ void __launch_bounds__(32 * kSlices) ba_reduce_kernel(const __grid_constant__ ReduceParams p) {
  __shared__ float part[kSlices][32];
  __shared__ long long part_n[kSlices][32];
  const int slice = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * 32 + lane;
  const int32_t* row = p.table + static_cast<size_t>(min(e, p.n - 1)) * kTableWords;
  const bool counting = row[0] == 1;
  const int chunk = (p.P + kSlices - 1) / kSlices;
  const int p0 = slice * chunk, p1 = min(p.P, p0 + chunk);
  float acc = 0.f;
  long long n = 0;
  if (e < p.n) {
    int cond[4], off[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      cond[t] = row[3 + 2 * t];
      off[t] = row[4 + 2 * t];
    }
    for (int pt = p0; pt < p1; ++pt) {
      const float* rec = p.record + static_cast<size_t>(pt) * p.R;
      const int h = min(max(static_cast<int>(p.p_host[pt]), 0), p.F - 1);
      // every term's word is read (an unused term reads word 0), then the
      // terms that count are added: the loads of a point do not wait on
      // its host
      float v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) v[t] = __ldg(rec + off[t]);
      float x = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (cond[t] == -1 || cond[t] == h) x += v[t];
      if (counting)
        n += static_cast<long long>(x);
      else
        acc += x;
    }
  }
  part[slice][lane] = acc;
  part_n[slice][lane] = n;
  __syncthreads();
  if (slice != 0 || e >= p.n) return;
  for (int s = 1; s < kSlices; ++s) {
    acc += part[s][lane];
    n += part_n[s][lane];
  }
  if (counting) {
    p.count[0] = n;
  } else {
    p.out[row[1]] = acc;
    if (row[2] >= 0) p.out[row[2]] = acc;
  }
}

}  // namespace

extern "C" int ldso_ba_linearize(
    const void* images, int H, int W, int F, const void* frame_valid, const void* pair,
    const void* slot, const void* c, const void* c_zero, int P, const void* p_valid,
    const void* p_host, const void* p_uv, const void* p_color, const void* p_weight,
    const void* p_idepth, const void* p_idepth_zero, const void* res_mask, const void* delta,
    float huber, float outlier_sum, int energy_only, void* record, void* H_xd, void* H_dd,
    void* b_d, void* e_pair, void* valid_pair, void* oob_pair, void* stream) {
  if (P < 0 || H < 1 || W < 1 || F < 1 || F > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  LinParams p;
  p.images = static_cast<const float*>(images);
  p.H = H;
  p.W = W;
  p.P = P;
  p.F = F;
  p.frame_valid = static_cast<const unsigned char*>(frame_valid);
  p.pair = static_cast<const float*>(pair);
  p.slot = static_cast<const float*>(slot);
  p.c = static_cast<const float*>(c);
  p.c_zero = static_cast<const float*>(c_zero);
  p.p_valid = static_cast<const unsigned char*>(p_valid);
  p.p_host = static_cast<const int32_t*>(p_host);
  p.p_uv = static_cast<const float*>(p_uv);
  p.p_color = static_cast<const float*>(p_color);
  p.p_weight = static_cast<const float*>(p_weight);
  p.p_idepth = static_cast<const float*>(p_idepth);
  p.p_idepth_zero = static_cast<const float*>(p_idepth_zero);
  p.res_mask = static_cast<const unsigned char*>(res_mask);
  p.delta = static_cast<const float*>(delta);
  p.huber = huber;
  p.outlier_sum = outlier_sum;
  p.energy_only = energy_only;
  p.record = static_cast<float*>(record);
  p.H_xd = static_cast<float*>(H_xd);
  p.H_dd = static_cast<float*>(H_dd);
  p.b_d = static_cast<float*>(b_d);
  p.e_pair = static_cast<float*>(e_pair);
  p.valid_pair = static_cast<unsigned char*>(valid_pair);
  p.oob_pair = static_cast<unsigned char*>(oob_pair);
  const int per_cta = kThreads / 32;
  ba_linearize_kernel<<<(P + per_cta - 1) / per_cta, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ldso_ba_reduce(const void* table, int n, int P, int R, int F, const void* record,
                              const void* p_host, void* out, void* count, void* stream) {
  if (n < 1 || P < 0 || R < 1 || F < 1 || F > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  ReduceParams p;
  p.table = static_cast<const int32_t*>(table);
  p.n = n;
  p.P = P;
  p.R = R;
  p.F = F;
  p.record = static_cast<const float*>(record);
  p.p_host = static_cast<const int32_t*>(p_host);
  p.out = static_cast<float*>(out);
  p.count = static_cast<long long*>(count);
  ba_reduce_kernel<<<(n + 31) / 32, 32 * kSlices, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
