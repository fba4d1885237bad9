// The immature bank's two programs: the epipolar trace of every candidate
// against a new frame (trace_bank, one launch a traced frame) and the
// activation GN of the candidates against the whole window (activate_bank,
// one launch a keyframe).
//
// trace_bank replaces the XLA program of ldso_tpu/trace.py::trace_points
// (:46-222) inside ldso_tpu/frame_step.py::_trace_core (:129-183);
// activate_bank that of ldso_tpu/trace.py::optimize_idepth_bank (:292-372)
// under activate_candidates_device (:376-400). The JAX package has no
// Pallas source for either. Their plain versions are the port's
// frame_step._trace_core_torch and trace.activate_candidates_torch.
//
// Each kernel makes its own slot tables from the window's state, in torch's
// operation order on the card (lie.cuh), so that they equal the plain
// versions' per-slot values bit for bit (frame_step.trace_slot_tables,
// trace.activation_slot_tables, the yardsticks): a CTA's first threads make
// one slot row each in shared memory while the CTA's row loads are in
// flight. trace_bank's row of slot f is its hostToNew pose T_new_cw
// T_all[f]^-1, T_all = se3_exp(x[f, :6]) T_eval[f], and its affine transfer
// to the new frame alpha = (exposure_new e^{ab_abs[0]}) /
// clamp(exposure[f] e^{x[f, 6]}, 1e-12), beta = ab_abs[1] - alpha x[f, 7];
// activate_bank's row of slot f is T_all[f], its inverse, exposure[f]
// e^{x[f, 6]} and x[f, 7], and each lane group makes its (target, host)
// entry from two rows: T_all[f] T_all[h]^-1, alpha = ea[f] / clamp(ea[h],
// 1e-12), beta = x[f, 7] - alpha x[h, 7]. A debug pointer, when given,
// receives CTA 0's tables in the plain versions' layout.
//
// Contract of trace_bank, per bank row (that of _trace_core_torch):
//   an invalid row keeps its fields (status UNINITIALIZED);
//   a valid row: a first trace (NaN idepth_max) searches [0, 1e8]; the
//   central ray pr = K R K^-1 (u, v, 1) and Kt = K t of its host slot's
//   hostToNew pose; p_min, p_max the projections of the interval's ends; an
//   unbounded far end (behind the camera, or idepth_max > 1e6) walks
//   max_search along the analytic epipolar direction at idepth_min (its
//   sign that of z_min: 0 gives an empty segment); the segment clamped to
//   max_search and cut at the caller's linspace(0, 1, K); at each sample
//   the SSD of the sweep pattern against alpha * color + beta, +inf unless
//   every pattern point is inside the border of 2 px; the best sample (the
//   first minimum, NaN first, as torch.argmin) and the best outside +-2
//   samples; quality = second / max(best, 1e-6); gn_iters GN steps along
//   the line with the full 8-point pattern; the new interval at
//   best +- err_px on the better-conditioned axis; the gradient along the
//   line at the match; the status in the reference's priority order
//   (UNINITIALIZED > OOB > SKIPPED > OUTLIER (energy) > BADCONDITION >
//   OUTLIER (quality) > GOOD); then the bank update: a GOOD row takes the
//   new interval (its minimum clamped at 0), a valid row the quality and
//   status, an OUTLIER a strike, and OOB or the 8th strike drops the row.
//   The outputs are fresh arrays: the bank is not written in place (the
//   async modes trace from a snapshot).
// Contract of activate_bank, per bank row (that of
// activate_candidates_torch): can = valid & GOOD & quality > min_quality &
// idepth_max not NaN & idepth_min + idepth_max > 0; d0 = clamp(mid, 1e-3,
// 50); iters GN steps d <- clamp(d - b / (H + 1e-6), 1e-5, 50) and a last
// evaluation, each over every valid target slot other than the host and
// the 8 pattern points: projection, in-bounds at border 2 with z > 1e-6,
// the clamped bilinear (I, dx, dy) sample, r = I - alpha color - beta,
// the Huber weight, Jd, and H += w Jd^2, b += w Jd r, E += w r^2 (2 - w),
// count += in. The sums run slot after slot, each slot's 8 points summed
// first and added to the running sum: the JAX package's order (the plain
// version sums the slots and points in one reduction, so the two agree to
// rounding). Rows that are no candidate keep d0 and zero sums.
//
// Both gathers read the four corners of the [H, W, 3] stacks themselves:
// the corner packing of kernels/interp.pack_corners is a TPU layout trick.
// The 2x2 footprint's origin is clamped into the image and its far corners
// to the last row and column, which gives the packed gather's values.
//
// What bounds them on Hopper: bytes in principle, latency in practice. A
// trace of a 2048-row bank at 640x480 needs well under a megabyte: each
// row read and written once, the distinct texels of the sweep's in-bounds
// samples (intensity) and of the refine's ((I, dx, dy)), a fraction of a
// microsecond at 3.35 TB/s; its ~8 Mflop take a tenth of that at 67
// TFLOP/s. The activation's 4 x 80 samples a row touch a few hundred kB.
// What a row costs is its chain of dependent steps: a gather, a warp
// reduction, the next gather. The torch compositions they replace spend
// their time elsewhere: a few hundred launches, and intermediates of
// [2048, 32, 4] (and the frame's 14.7 MB corner pack, the window's 147 MB)
// written to and read back from device memory. The design keeps every
// intermediate in registers and reads the stacks in place:
//   * the trace: one warp a row (4 rows a 128-thread CTA; 2048 rows fill
//     the card); every lane computes the row's scalars itself (a few dozen
//     flops, cheaper than a broadcast). A row is a chain of dependent
//     trips to device memory, so each is cut to what the data needs: the
//     row's loads (its fields, the sample fractions) all issued before the
//     first branch, alongside the slot table's; the sweep's gathers; the
//     GN refine's gn_iters gathers; the gather at the match; the writes.
//     The sweep puts a sample on a lane (a second one for K > 32), so the
//     32 samples of the default run in one pass; the argmin and the
//     runner-up are warp reductions (xor butterflies, the lowest index at a
//     tie, so their result does not depend on the reduction order), and the
//     best sample's position comes from the lane that computed it by a
//     shuffle; the refine puts the 8 pattern points on lanes 0-7 and sums
//     them by shuffles in the tree order torch's reduction kernel uses for
//     8 values ((x0 + x4) + (x2 + x6)) + ((x1 + x5) + (x3 + x7)) (read off
//     the plain version's GN steps: this order gives every row's step of
//     a bench frame bit for bit, the order (x0 + x1) + ... half of them);
//   * the activation: ceil(F / 4) warps a row, target slot f on the 8
//     lanes (one a pattern point) of group f % 4 of the row's warp f / 4,
//     so every slot of an evaluation gathers at once: iters + 1 dependent
//     gather rounds a candidate row. Each slot's 8 points are summed by the
//     same tree into shared memory, then every thread of the row adds the
//     F slot sums in slot order from 0 (the order of the JAX package's
//     slot-after-slot loop), one CTA a row. A row that is no candidate
//     leaves before it makes or reads a table;
//   * no sum uses atomics and every order is fixed, so a launch repeats bit
//     for bit.
// To follow the plain versions' float32 rounding, every expression keeps
// torch's operation order: each torch operator rounds its result, so
// a * b + c is two roundings. The file is built with -fmad=false (see
// kernels/trace.py), so nvcc contracts nothing, and the products of the
// plain versions' small matrix products (cuBLAS, which accumulates by
// fused multiply-adds) are written out as fmaf chains. Sums of squares in
// torch.linalg.norm round each square.
//
// Plain C interface (bound with ctypes): the entry points launch on the
// given stream, allocate nothing, do not synchronise, and return the
// cudaError_t of the launch.

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#include "lie.cuh"

namespace {

constexpr int kThreads = 128;              // trace_bank: 4 rows a CTA
constexpr int kMaxSamples = 64;            // two samples a lane
constexpr int kMaxSlots = 32;
// activate_bank: a CTA a row, ceil(F / 4) warps (4 slots a warp)
constexpr int kMaxActThreads = 32 * ((kMaxSlots + 3) / 4);
constexpr unsigned kFull = 0xffffffffu;
// trace_bank's slot row in shared memory: T_hn rows 0-2, alpha, beta
constexpr int kTraceSlot = 14, kAlpha = 12, kBeta = 13;
constexpr int kTraceDebug = 18;            // its debug row: T_hn [4, 4], alpha, beta
// activate_bank's slot row: T_all rows 0-2, T_all^-1 rows 0-2, exposure
// e^a, b
constexpr int kActSlot = 26, kTinv = 12, kEa = 24, kB = 25;

enum Status { GOOD = 0, OOB = 1, OUTLIER = 2, SKIPPED = 3, BADCONDITION = 4, UNINITIALIZED = 5 };

// core/window.PATTERN_OFFSETS (config.PATTERN)
__constant__ float kPat[8][2] = {{0.f, -2.f}, {-1.f, -1.f}, {1.f, -1.f}, {-2.f, 0.f},
                                 {0.f, 0.f},  {2.f, 0.f},   {-1.f, 1.f}, {0.f, 2.f}};

struct TraceParams {
  const float* img3;                   // [H, W, 3] (I, dx, dy) of the new frame
  int H, W, N, F, K;
  const unsigned char* valid;          // [N] bool
  const int32_t* host_slot;            // [N]
  const float* uv;                     // [N, 2]
  const float* color;                  // [N, 8]
  const float* idepth_min;             // [N]
  const float* idepth_max;             // [N] (NaN: never traced)
  const float* quality;                // [N]
  const int32_t* last_status;          // [N]
  const int32_t* outlier_count;        // [N]
  const float* T_eval;                 // [F, 4, 4] the window's linearization poses
  const float* x;                      // [F, 8] its state (pose offset, a, b)
  const float* exposure;               // [F]
  const float* T_new_cw;               // [4, 4] the new frame's worldToCam
  const float* ab_abs;                 // [2] its absolute affine (a, b)
  float exposure_new;
  const float* intr;                   // [4] fx, fy, cx, cy
  const float* steps;                  // [K] torch.linspace(0, 1, K)
  int sweep;                           // the pattern points the sweep scores, 3 bits each
  int sweep_n, gn_iters;
  float max_search, outlier_gate, min_quality, step_size, slack, gn_threshold, err_px;
  unsigned char* valid_out;            // [N] bool
  float* idepth_min_out;               // [N]
  float* idepth_max_out;
  float* quality_out;
  int32_t* last_status_out;
  int32_t* outlier_out;
  int32_t* status_out;                 // [N] trace_points' status, or null
  float* best_uv_out;                  // [N, 2], or null
  float* best_idepth_out;              // [N], or null
  float* debug;                        // [F, kTraceDebug], or null
};

struct ActivateParams {
  const float* images;                 // [F, H, W, 3] the window's level-0 stacks
  int H, W, N, F, iters;
  const unsigned char* frame_valid;    // [F] bool
  const float* T_all;                  // [F, 4, 4] the slots' worldToCam
  const float* x;                      // [F, 8] the window's state (its a, b)
  const float* exposure;               // [F]
  const unsigned char* valid;          // [N] bool
  const int32_t* host_slot;            // [N]
  const float* uv;                     // [N, 2]
  const float* color;                  // [N, 8]
  const float* idepth_min;             // [N]
  const float* idepth_max;             // [N]
  const float* quality;                // [N]
  const int32_t* last_status;          // [N]
  const float* intr;                   // [4]
  float min_quality, huber;
  float* idepth_out;                   // [N]
  float* H_out;
  float* E_out;
  float* count_out;                    // [N] float32, as the plain version's
  unsigned char* can_out;              // [N] bool
  float* debug;                        // T_rel [F, F, 4, 4], alpha, beta [F, F], or null
};

// torch.clamp's NaN rule: a NaN stays NaN (fminf / fmaxf would drop it)
__device__ __forceinline__ float clamp_lo(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_hi(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return clamp_hi(clamp_lo(x, lo), hi);
}
// torch.minimum / torch.maximum: NaN if either is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : (a < b ? a : b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : (a > b ? a : b);
}

// kernels/interp.in_bounds at border 2
__device__ __forceinline__ bool in_bounds2(float u, float v, int W, int H) {
  return u >= 2.f && u < static_cast<float>(W) - 3.f && v >= 2.f
      && v < static_cast<float>(H) - 3.f;
}

// The bilinear footprint of (u, v) as kernels/interp.bilinear_packed forms
// it: u0 = int(floor(u)) (saturating, as torch's float -> int32 on the
// card), du = u - float(u0), the origin clamped into the image and its far
// corners to the last row and column (pack_corners replicates them).
struct Footprint {
  int o00, o10, o01, o11;              // texel offsets
  float du, dv;
};

__device__ __forceinline__ Footprint footprint(float u, float v, int W, int H) {
  const int iu = static_cast<int>(floorf(u)), iv = static_cast<int>(floorf(v));
  Footprint fp;
  fp.du = u - static_cast<float>(iu);
  fp.dv = v - static_cast<float>(iv);
  const int u0 = min(max(iu, 0), W - 1), v0 = min(max(iv, 0), H - 1);
  const int u1 = min(u0 + 1, W - 1), v1 = min(v0 + 1, H - 1);
  fp.o00 = v0 * W + u0;
  fp.o10 = v0 * W + u1;
  fp.o01 = v1 * W + u0;
  fp.o11 = v1 * W + u1;
  return fp;
}

// top = c00 (1 - du) + c10 du; bot likewise; top (1 - dv) + bot dv
__device__ __forceinline__ float lerp2(const Footprint& fp, float c00, float c10, float c01,
                                       float c11) {
  const float top = c00 * (1.f - fp.du) + c10 * fp.du;
  const float bot = c01 * (1.f - fp.du) + c11 * fp.du;
  return top * (1.f - fp.dv) + bot * fp.dv;
}

// intensity only (the sweep)
__device__ __forceinline__ float sample1(const float* __restrict__ img, int W, int H, float u,
                                         float v) {
  const Footprint fp = footprint(u, v, W, H);
  return lerp2(fp, __ldg(img + 3 * fp.o00), __ldg(img + 3 * fp.o10), __ldg(img + 3 * fp.o01),
               __ldg(img + 3 * fp.o11));
}

// (I, dx, dy)
__device__ __forceinline__ void sample3(const float* __restrict__ img, int W, int H, float u,
                                        float v, float out[3]) {
  const Footprint fp = footprint(u, v, W, H);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = lerp2(fp, __ldg(img + 3 * fp.o00 + c), __ldg(img + 3 * fp.o10 + c),
                   __ldg(img + 3 * fp.o01 + c), __ldg(img + 3 * fp.o11 + c));
}

// torch.sum over S <= 8 values of a row: torch's reduction kernel gives a
// row of S values bw = last_pow2(S - 1) threads, thread t summing
// x[t] + x[t + bw], then a halving shuffle tree (offsets bw / 2, ..., 1)
__device__ __forceinline__ float torch_sum(const float* x, int S) {
  if (S >= 8)
    return ((x[0] + x[4]) + (x[2] + x[6])) + ((x[1] + x[5]) + (x[3] + x[7]));
  if (S >= 4) return (x[0] + x[2]) + (x[1] + x[3]);
  if (S == 3) return (x[0] + x[2]) + x[1];
  if (S == 2) return x[0] + x[1];
  return x[0];
}

// the same tree over lanes 0-7 of each group of 8: lane 8g holds its sum
__device__ __forceinline__ float tree8(float v) {
  v += __shfl_down_sync(kFull, v, 4, 8);
  v += __shfl_down_sync(kFull, v, 2, 8);
  v += __shfl_down_sync(kFull, v, 1, 8);
  return v;
}

// v[j] for a j known only at run time, by selects (a dynamic index would
// put v in local memory)
__device__ __forceinline__ float pick8(const float (&v)[8], int j) {
  float r = v[0];
#pragma unroll
  for (int q = 1; q < 8; ++q) r = j == q ? v[q] : r;
  return r;
}

// torch.argmin's order: NaN first, then the smaller, then the lower index
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_argmin(float& e, int& k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float oe = __shfl_xor_sync(kFull, e, off);
    const int ok = __shfl_xor_sync(kFull, k, off);
    if (before(oe, ok, e, k)) {
      e = oe;
      k = ok;
    }
  }
}

// the row's segment and ray, computed by every lane of its warp
struct Ray {
  float pr[3], Kt[3];
  float pmin[2], dir[2], length;
  bool ok_min, too_short;
};

__device__ __forceinline__ void project_at(const Ray& r, float d, float out[2], bool& ok) {
  const float ph0 = r.pr[0] + d * r.Kt[0];
  const float ph1 = r.pr[1] + d * r.Kt[1];
  float z = r.pr[2] + d * r.Kt[2];
  ok = z > 1e-6f;
  z = ok ? z : 1.f;
  out[0] = ph0 / z;
  out[1] = ph1 / z;
}

__device__ __forceinline__ void sample_at(const Ray& r, float step, float& su, float& sv) {
  const float s = r.length * step;
  su = r.pmin[0] + s * r.dir[0];
  sv = r.pmin[1] + s * r.dir[1];
}

__device__ __forceinline__ float idepth_from(const Ray& r, bool use_u, float u, float v) {
  const float du = (r.pr[2] * u - r.pr[0]) / (r.Kt[0] - r.Kt[2] * u);
  const float dv = (r.pr[2] * v - r.pr[1]) / (r.Kt[1] - r.Kt[2] * v);
  return use_u ? du : dv;
}

// what trace_bank's row of a slot is made from, loaded by the thread that
// makes it along with its bank row's loads (the table's arithmetic has
// branches, sinf's and cosf's, that would hold back later loads)
struct SlotIn {
  float xi[8], Te[16], expo, Tn[16], ab0, ab1;
};

__device__ __forceinline__ void load_slot(const TraceParams& p, int f, SlotIn& in) {
#pragma unroll
  for (int e = 0; e < 8; ++e) in.xi[e] = p.x[8 * f + e];
#pragma unroll
  for (int e = 0; e < 16; ++e) in.Te[e] = p.T_eval[16 * f + e];
  in.expo = p.exposure[f];
#pragma unroll
  for (int e = 0; e < 16; ++e) in.Tn[e] = p.T_new_cw[e];
  in.ab0 = p.ab_abs[0];
  in.ab1 = p.ab_abs[1];
}

// trace_bank's row of a slot (frame_step.trace_slot_tables); with ``dbg``
// also its debug row (row 3 of T_hn too)
__device__ void trace_slot(const SlotIn& in, float exposure_new, int F, float* s, float* dbg) {
  const lie::Rules ru = lie::rules(F);
  const float ea = in.expo * expf(in.xi[6]);
  const float alpha = (exposure_new * expf(in.ab0)) / clamp_lo(ea, 1e-12f);
  s[kAlpha] = alpha;
  s[kBeta] = in.ab1 - alpha * in.xi[7];
  float T_all[12], T_inv[12];
  lie::exp_times34(in.xi, in.Te, ru, T_all);
  lie::inverse34(T_all, T_inv, ru.slot);
  lie::mul34(in.Tn, T_inv, s, ru.hn);
  if (dbg == nullptr) return;
#pragma unroll
  for (int e = 0; e < 12; ++e) dbg[e] = s[e];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    dbg[12 + k] = lie::dot4(in.Tn[12], T_inv[k], in.Tn[13], T_inv[4 + k], in.Tn[14],
                            T_inv[8 + k], in.Tn[15], k == 3 ? 1.f : 0.f, ru.hn);
  dbg[16] = s[kAlpha];
  dbg[17] = s[kBeta];
}

__global__ void __launch_bounds__(kThreads) trace_bank_kernel(const __grid_constant__ TraceParams p) {
  __shared__ float s_slot[kMaxSlots * kTraceSlot];
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  // every load of the row, issued before the first branch (a CTA's rows
  // past the bank load the last row's and write nothing)
  const int rr = min(row, p.N - 1);
  const bool valid = p.valid[rr] != 0;
  const int hs_in = p.host_slot[rr];
  const float u = p.uv[2 * rr], v = p.uv[2 * rr + 1];
  const float dmin_in = p.idepth_min[rr], dmax_in = p.idepth_max[rr];
  const float quality_in = p.quality[rr];
  const int status_in = p.last_status[rr], strikes_in = p.outlier_count[rr];
  float color[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) color[j] = p.color[8 * rr + j];
  const float step_lane[2] = {p.steps[min(lane, p.K - 1)], p.steps[min(lane + 32, p.K - 1)]};
  const float fx = p.intr[0], fy = p.intr[1], cx = p.intr[2], cy = p.intr[3];
  const int tid = threadIdx.x;
  SlotIn slot_in;
  if (tid < p.F) load_slot(p, tid, slot_in);
  // what needs no slot row, before the barrier
  const float xh0 = (u - cx) / fx, xh1 = (v - cy) / fy;
  const bool first = isnan(dmax_in);
  const float d_min = first ? 0.f : dmin_in;
  const float d_max = first ? 1e8f : dmax_in;
  // the slot table: a thread a slot
  if (tid < p.F)
    trace_slot(slot_in, p.exposure_new, p.F, s_slot + kTraceSlot * tid,
               p.debug != nullptr && blockIdx.x == 0 ? p.debug + kTraceDebug * tid : nullptr);
  __syncthreads();
  if (row >= p.N) return;                      // a whole warp leaves
  if (!valid) {
    if (lane == 0) {
      p.valid_out[row] = 0;
      p.idepth_min_out[row] = dmin_in;
      p.idepth_max_out[row] = dmax_in;
      p.quality_out[row] = quality_in;
      p.last_status_out[row] = status_in;
      p.outlier_out[row] = strikes_in;
      if (p.status_out) p.status_out[row] = UNINITIALIZED;
      if (p.best_uv_out) {
        p.best_uv_out[2 * row] = __int_as_float(0x7fffffff);
        p.best_uv_out[2 * row + 1] = __int_as_float(0x7fffffff);
      }
      if (p.best_idepth_out) p.best_idepth_out[row] = __int_as_float(0x7fffffff);
    }
    return;
  }
  const float* T = s_slot + kTraceSlot * min(max(hs_in, 0), p.F - 1);
  const float alpha = T[kAlpha], beta = T[kBeta];

  // the central ray and K t
  Ray r;
  float Rx[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    Rx[i] = __fmaf_rn(T[4 * i + 2], 1.f, __fmaf_rn(T[4 * i + 1], xh1, T[4 * i] * xh0));
  r.pr[0] = fx * Rx[0] + cx * Rx[2];
  r.pr[1] = fy * Rx[1] + cy * Rx[2];
  r.pr[2] = Rx[2];
  const float t0 = T[3], t1 = T[7], t2 = T[11];
  r.Kt[0] = fx * t0 + cx * t2;
  r.Kt[1] = fy * t1 + cy * t2;
  r.Kt[2] = t2;

  // the segment: near end, far end (bounded or walked), its direction
  float pmax[2];
  bool ok_max;
  project_at(r, d_min, r.pmin, r.ok_min);
  project_at(r, clamp_hi(d_max, 1e8f), pmax, ok_max);
  const float z_min = r.pr[2] + d_min * r.Kt[2];
  const float sgn = static_cast<float>((z_min > 0.f) - (z_min < 0.f));   // torch.sign
  const float e0 = (r.Kt[0] * r.pr[2] - r.pr[0] * r.Kt[2]) * sgn;
  const float e1 = (r.Kt[1] * r.pr[2] - r.pr[1] * r.Kt[2]) * sgn;
  const float en = clamp_lo(sqrtf(e0 * e0 + e1 * e1), 1e-12f);
  if (!ok_max || d_max > 1e6f) {
    pmax[0] = r.pmin[0] + p.max_search * (e0 / en);
    pmax[1] = r.pmin[1] + p.max_search * (e1 / en);
  }
  const float seg0 = pmax[0] - r.pmin[0], seg1 = pmax[1] - r.pmin[1];
  const float seg_len = sqrtf(seg0 * seg0 + seg1 * seg1);
  r.too_short = seg_len < p.slack;
  const float sl = clamp_lo(seg_len, 1e-8f);
  r.dir[0] = seg0 / sl;
  r.dir[1] = seg1 / sl;
  r.length = clamp_hi(seg_len, p.max_search);

  // the sweep: sample k on lane k (and k + 32); the sweep's points s < S,
  // unrolled so that nothing is indexed at run time
  const int S = p.sweep_n;
  float e_lane[2], su[2], sv[2];
  bool any_in = false;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int k = lane + 32 * m;
    e_lane[m] = INFINITY;
    su[m] = sv[m] = 0.f;
    if (k >= p.K) continue;
    sample_at(r, step_lane[m], su[m], sv[m]);
    bool inb = true;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int j = (p.sweep >> (3 * s)) & 7;
      if (s < S) inb = inb && in_bounds2(su[m] + kPat[j][0], sv[m] + kPat[j][1], p.W, p.H);
    }
    if (!inb) continue;
    any_in = true;
    float sq[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int j = (p.sweep >> (3 * s)) & 7;
      if (s >= S) break;
      const float diff = sample1(p.img3, p.W, p.H, su[m] + kPat[j][0], sv[m] + kPat[j][1])
                         - (alpha * pick8(color, j) + beta);
      sq[s] = diff * diff;
    }
    e_lane[m] = torch_sum(sq, S);
  }
  any_in = __any_sync(kFull, any_in);
  float best_e = e_lane[0];
  int best_k = lane;
  if (lane + 32 < p.K && before(e_lane[1], lane + 32, best_e, best_k)) {
    best_e = e_lane[1];
    best_k = lane + 32;
  }
  warp_argmin(best_e, best_k);
  // the runner-up outside +-2 samples of the best
  float second = INFINITY;
  int second_k = kMaxSamples;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int k = lane + 32 * m;
    if (k < p.K && abs(k - best_k) > 2 && before(e_lane[m], k, second, second_k)) {
      second = e_lane[m];
      second_k = k;
    }
  }
  warp_argmin(second, second_k);
  const float quality = second / clamp_lo(best_e, 1e-6f);

  // GN sub-pixel refinement along the line: pattern point j on lane j, from
  // the best sample's position, handed over by the lane that sampled it
  const bool hi = best_k >= 32;
  float bu = __shfl_sync(kFull, hi ? su[1] : su[0], best_k & 31);
  float bv = __shfl_sync(kFull, hi ? sv[1] : sv[0], best_k & 31);
  const int j = lane & 7;
  const float pu = kPat[j][0], pv = kPat[j][1];
  const float pred_j = alpha * pick8(color, j) + beta;
  for (int it = 0; it < p.gn_iters; ++it) {
    float hit[3];
    sample3(p.img3, p.W, p.H, bu + pu, bv + pv, hit);
    const float rk = hit[0] - pred_j;
    const float gk = hit[1] * r.dir[0] + hit[2] * r.dir[1];
    const float Hs = __shfl_sync(kFull, tree8(gk * gk), 0);
    const float bs = __shfl_sync(kFull, tree8(gk * rk), 0);
    float step = clamp2(-bs / clamp_lo(Hs, 1e-6f), -p.step_size, p.step_size);
    step = fabsf(step) < p.gn_threshold ? 0.f : step;
    bu = bu + step * r.dir[0];
    bv = bv + step * r.dir[1];
  }

  // the match back to an interval, on the better-conditioned axis
  const bool use_u = fabsf(r.dir[0]) > fabsf(r.dir[1]);
  const float ex = p.err_px * r.dir[0], ey = p.err_px * r.dir[1];
  const float d_lo = idepth_from(r, use_u, bu - ex, bv - ey);
  const float d_hi = idepth_from(r, use_u, bu + ex, bv + ey);
  const float new_min = nan_min(d_lo, d_hi), new_max = nan_max(d_lo, d_hi);
  float hit[3];
  sample3(p.img3, p.W, p.H, bu, bv, hit);
  const float g_along = fabsf(hit[1] * r.dir[0] + hit[2] * r.dir[1]);

  int status = GOOD;
  if (quality < p.min_quality) status = OUTLIER;
  if (g_along < 1.f || new_max < new_min || new_min < -0.1f) status = BADCONDITION;
  if (best_e > p.outlier_gate) status = OUTLIER;
  if (r.too_short) status = SKIPPED;
  if (!r.ok_min || !any_in) status = OOB;

  if (lane == 0) {
    const bool good = status == GOOD;
    const int strikes = strikes_in + (status == OUTLIER ? 1 : 0);
    p.valid_out[row] = !(status == OOB || strikes >= 8);
    p.idepth_min_out[row] = good ? clamp_lo(new_min, 0.f) : dmin_in;
    p.idepth_max_out[row] = good ? new_max : dmax_in;
    p.quality_out[row] = quality;
    p.last_status_out[row] = status;
    p.outlier_out[row] = strikes;
    if (p.status_out) p.status_out[row] = status;
    if (p.best_uv_out) {
      p.best_uv_out[2 * row] = bu;
      p.best_uv_out[2 * row + 1] = bv;
    }
    if (p.best_idepth_out) p.best_idepth_out[row] = idepth_from(r, use_u, bu, bv);
  }
}

// activate_bank's row of slot f, from its pose and state loaded earlier
__device__ __forceinline__ void act_slot(const float (&T)[12], float expo, float a, float b,
                                         bool split, float* s) {
#pragma unroll
  for (int e = 0; e < 12; ++e) s[e] = T[e];
  lie::inverse34(T, s + kTinv, split);
  s[kEa] = expo * expf(a);
  s[kB] = b;
}

// the (target f, host h) entry of activation_slot_tables from two slot rows:
// rows 0-2 of T_all[f] T_all[h]^-1, alpha and beta
__device__ __forceinline__ void act_pair(const float* sf, const float* sh, bool split,
                                         float (&T)[12], float& alpha, float& beta) {
  lie::mul34(sf, sh + kTinv, T, split);
  alpha = sf[kEa] / clamp_lo(sh[kEa], 1e-12f);
  beta = sf[kB] - alpha * sh[kB];
}

__global__ void __launch_bounds__(kMaxActThreads) activate_bank_kernel(
    const __grid_constant__ ActivateParams p) {
  __shared__ float s_slot[kMaxSlots * kActSlot];
  __shared__ float s_sum[2][kMaxSlots * 4];    // each slot's H, b, E, count, two evaluations
  const int F = p.F, tid = threadIdx.x, lane = tid & 31, row = blockIdx.x;
  // lane = 8 g + j of warp w: pattern point j against target slot 4 w + g
  const int g = lane >> 3, j = lane & 7, f = 4 * (tid >> 5) + g;
  // the row's loads and this thread's slot inputs, issued before the
  // candidate test
  const bool valid = p.valid[row] != 0;
  const int status = p.last_status[row];
  const float quality = p.quality[row];
  const float dmin = p.idepth_min[row], dmax = p.idepth_max[row];
  const int hs_in = p.host_slot[row];
  const float u = p.uv[2 * row], v = p.uv[2 * row + 1];
  const float color = p.color[8 * row + j];
  const bool f_valid = f < F && p.frame_valid[f] != 0;
  float T_own[12], expo = 0.f, a_own = 0.f, b_own = 0.f;
  if (tid < F) {
#pragma unroll
    for (int e = 0; e < 12; ++e) T_own[e] = p.T_all[16 * tid + e];
    expo = p.exposure[tid];
    a_own = p.x[8 * tid + 6];
    b_own = p.x[8 * tid + 7];
  }
  const bool can = valid && status == GOOD && quality > p.min_quality && !isnan(dmax)
                   && (dmax + dmin) > 0.f;
  float d = clamp2(0.5f * ((can ? dmin : 0.f) + (can ? dmax : 1.f)), 1e-3f, 50.f);
  const bool dbg = p.debug != nullptr && blockIdx.x == 0;
  if (!can && tid == 0) {
    // no candidate: every sample is masked, the steps leave d0
    p.idepth_out[row] = d;
    p.H_out[row] = 0.f;
    p.E_out[row] = 0.f;
    p.count_out[row] = 0.f;
    p.can_out[row] = 0;
  }
  if (!can && !dbg) return;                    // the whole CTA
  const lie::Rules ru = lie::rules(F);
  if (tid < F) act_slot(T_own, expo, a_own, b_own, ru.slot, s_slot + kActSlot * tid);
  __syncthreads();
  if (dbg) {
    // activation_slot_tables' layout: T_rel [f, h] (4 x 4), alpha, beta
    for (int i = tid; i < F * F; i += blockDim.x) {
      const int ft = i / F, h = i % F;
      float T[12], a, b;
      act_pair(s_slot + kActSlot * ft, s_slot + kActSlot * h, ru.rel, T, a, b);
      float* o = p.debug + 16 * i;
      const float* Tf = p.T_all + 16 * ft;
      const float* Ti = s_slot + kActSlot * h + kTinv;
#pragma unroll
      for (int e = 0; e < 12; ++e) o[e] = T[e];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[12 + k] = lie::dot4(Tf[12], Ti[k], Tf[13], Ti[4 + k], Tf[14], Ti[8 + k], Tf[15],
                              k == 3 ? 1.f : 0.f, ru.rel);
      p.debug[16 * F * F + i] = a;
      p.debug[17 * F * F + i] = b;
    }
  }
  if (!can) return;
  const int hs = min(max(hs_in, 0), F - 1);
  const bool act = f_valid && f != hs;
  float T[12], alpha = 0.f, beta = 0.f;
  if (act) act_pair(s_slot + kActSlot * f, s_slot + kActSlot * hs, ru.rel, T, alpha, beta);
  const float fx = p.intr[0], fy = p.intr[1], cx = p.intr[2], cy = p.intr[3];
  const float xh0 = ((u + kPat[j][0]) - cx) / fx;
  const float xh1 = ((v + kPat[j][1]) - cy) / fy;
  const float* img = p.images + static_cast<size_t>(act ? f : 0) * p.H * p.W * 3;
  for (int it = 0; it <= p.iters; ++it) {
    float h = 0.f, b = 0.f, e = 0.f, c = 0.f;
    if (act) {
      float X[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        X[i] = __fmaf_rn(T[4 * i + 2], 1.f, __fmaf_rn(T[4 * i + 1], xh1, T[4 * i] * xh0))
               + T[4 * i + 3] * d;
      const float z = X[2];
      const bool okz = z > 1e-6f;
      const float zs = okz ? z : 1.f;
      const float up = X[0] / zs, vp = X[1] / zs;
      const float un = fx * up + cx, vn = fy * vp + cy;
      if (okz && in_bounds2(un, vn, p.W, p.H)) {
        float hit[3];
        sample3(img, p.W, p.H, un, vn, hit);
        const float res = (hit[0] - alpha * color) - beta;
        const float dre = 1.f / zs;
        const float Jd = hit[1] * ((fx * dre) * (T[3] - T[11] * up))
                         + hit[2] * ((fy * dre) * (T[7] - T[11] * vp));
        const float ar = fabsf(res);
        const float hw = ar < p.huber ? 1.f : p.huber / clamp_lo(ar, 1e-12f);
        h = (hw * Jd) * Jd;
        b = (hw * Jd) * res;
        e = ((hw * res) * res) * (2.f - hw);
        c = 1.f;
      }
    }
    h = tree8(h);
    b = tree8(b);
    e = tree8(e);
    c = tree8(c);
    float* sum = s_sum[it & 1];
    if (j == 0 && f < F) {
      sum[4 * f] = h;
      sum[4 * f + 1] = b;
      sum[4 * f + 2] = e;
      sum[4 * f + 3] = c;
    }
    __syncthreads();
    // the slots' sums in slot order, into every thread's running sums (the
    // other buffer takes the next evaluation's, so one barrier an
    // evaluation)
    float Hd = 0.f, bd = 0.f;
    for (int ff = 0; ff < F; ++ff) {
      Hd += sum[4 * ff];
      bd += sum[4 * ff + 1];
    }
    if (it < p.iters) {
      d = clamp2(d - bd / (Hd + 1e-6f), 1e-5f, 50.f);
    } else if (tid == 0) {
      float E = 0.f, cnt = 0.f;
      for (int ff = 0; ff < F; ++ff) {
        E += sum[4 * ff + 2];
        cnt += sum[4 * ff + 3];
      }
      p.idepth_out[row] = d;
      p.H_out[row] = Hd;
      p.E_out[row] = E;
      p.count_out[row] = cnt;
      p.can_out[row] = 1;
    }
  }
}

}  // namespace

extern "C" int ldso_trace_bank(
    const void* img3, int H, int W, const void* valid, const void* host_slot, const void* uv,
    const void* color, const void* idepth_min, const void* idepth_max, const void* quality,
    const void* last_status, const void* outlier_count, int N, const void* T_eval,
    const void* x, const void* exposure, int F, const void* T_new_cw, const void* ab_abs,
    float exposure_new, const void* intr, const void* steps, int K, int sweep, int sweep_n,
    int gn_iters, float max_search, float outlier_gate, float min_quality, float step_size,
    float slack, float gn_threshold, float err_px, void* valid_out, void* idepth_min_out,
    void* idepth_max_out, void* quality_out, void* last_status_out, void* outlier_out,
    void* status_out, void* best_uv_out, void* best_idepth_out, void* debug, void* stream) {
  if (N < 0 || H < 1 || W < 1 || F < 1 || F > kMaxSlots || K < 1 || K > kMaxSamples
      || gn_iters < 0 || sweep_n < 1 || sweep_n > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  TraceParams p;
  p.img3 = static_cast<const float*>(img3);
  p.H = H;
  p.W = W;
  p.N = N;
  p.F = F;
  p.K = K;
  p.valid = static_cast<const unsigned char*>(valid);
  p.host_slot = static_cast<const int32_t*>(host_slot);
  p.uv = static_cast<const float*>(uv);
  p.color = static_cast<const float*>(color);
  p.idepth_min = static_cast<const float*>(idepth_min);
  p.idepth_max = static_cast<const float*>(idepth_max);
  p.quality = static_cast<const float*>(quality);
  p.last_status = static_cast<const int32_t*>(last_status);
  p.outlier_count = static_cast<const int32_t*>(outlier_count);
  p.T_eval = static_cast<const float*>(T_eval);
  p.x = static_cast<const float*>(x);
  p.exposure = static_cast<const float*>(exposure);
  p.T_new_cw = static_cast<const float*>(T_new_cw);
  p.ab_abs = static_cast<const float*>(ab_abs);
  p.exposure_new = exposure_new;
  p.intr = static_cast<const float*>(intr);
  p.steps = static_cast<const float*>(steps);
  p.sweep = sweep;   // the caller's trace.sweep_indices, 3 bits each from the lowest
  p.sweep_n = sweep_n;
  p.gn_iters = gn_iters;
  p.max_search = max_search;
  p.outlier_gate = outlier_gate;
  p.min_quality = min_quality;
  p.step_size = step_size;
  p.slack = slack;
  p.gn_threshold = gn_threshold;
  p.err_px = err_px;
  p.valid_out = static_cast<unsigned char*>(valid_out);
  p.idepth_min_out = static_cast<float*>(idepth_min_out);
  p.idepth_max_out = static_cast<float*>(idepth_max_out);
  p.quality_out = static_cast<float*>(quality_out);
  p.last_status_out = static_cast<int32_t*>(last_status_out);
  p.outlier_out = static_cast<int32_t*>(outlier_out);
  p.status_out = static_cast<int32_t*>(status_out);
  p.best_uv_out = static_cast<float*>(best_uv_out);
  p.best_idepth_out = static_cast<float*>(best_idepth_out);
  p.debug = static_cast<float*>(debug);
  const int rows_per_cta = kThreads / 32;
  trace_bank_kernel<<<(N + rows_per_cta - 1) / rows_per_cta, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ldso_activate_bank(
    const void* images, int H, int W, int F, const void* frame_valid, const void* T_all,
    const void* x, const void* exposure, const void* valid, const void* host_slot,
    const void* uv, const void* color, const void* idepth_min, const void* idepth_max,
    const void* quality, const void* last_status, int N, const void* intr, int iters,
    float min_quality, float huber, void* idepth_out, void* H_out, void* E_out,
    void* count_out, void* can_out, void* debug, void* stream) {
  if (N < 0 || H < 1 || W < 1 || F < 1 || F > kMaxSlots || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  ActivateParams p;
  p.images = static_cast<const float*>(images);
  p.H = H;
  p.W = W;
  p.N = N;
  p.F = F;
  p.iters = iters;
  p.frame_valid = static_cast<const unsigned char*>(frame_valid);
  p.T_all = static_cast<const float*>(T_all);
  p.x = static_cast<const float*>(x);
  p.exposure = static_cast<const float*>(exposure);
  p.valid = static_cast<const unsigned char*>(valid);
  p.host_slot = static_cast<const int32_t*>(host_slot);
  p.uv = static_cast<const float*>(uv);
  p.color = static_cast<const float*>(color);
  p.idepth_min = static_cast<const float*>(idepth_min);
  p.idepth_max = static_cast<const float*>(idepth_max);
  p.quality = static_cast<const float*>(quality);
  p.last_status = static_cast<const int32_t*>(last_status);
  p.intr = static_cast<const float*>(intr);
  p.min_quality = min_quality;
  p.huber = huber;
  p.idepth_out = static_cast<float*>(idepth_out);
  p.H_out = static_cast<float*>(H_out);
  p.E_out = static_cast<float*>(E_out);
  p.count_out = static_cast<float*>(count_out);
  p.can_out = static_cast<unsigned char*>(can_out);
  p.debug = static_cast<float*>(debug);
  const int threads = 32 * ((F + 3) / 4);
  activate_bank_kernel<<<N, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
