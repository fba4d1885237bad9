// The windowed BA's linearization (K4): every (point, target slot, pattern
// point) residual of the window, its FEJ Jacobians and Huber weight, and the
// block-structured Gauss-Newton system they make, in ONE launch an
// evaluation, the pair tables included.
//
// Replaces the XLA program of ldso_tpu/ba/residuals.py::assemble (:153-368,
// with precompute_pairs :80) and that of energy_only (:372-417); the JAX
// package has no Pallas source for either. The plain versions are the port's
// ba/residuals.assemble_torch and energy_only_torch.
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
// r - (target8 dF[f] + host8 dF[h] + cam4 dC + d (idepth - idepth_zero)),
// dF and dC the state's offsets from its FEJ point (core/window.state_delta).
// An invalid sample contributes nothing (in the plain version its weight is
// 0 and every factor finite, so its terms are exact zeros). energy_only is
// the same without the FEJ projection's test or any Jacobian (its validity
// is the plain energy_only_torch's: the current projection, res_mask,
// p_valid, frame_valid): the energy and the count.
//
// The pair tables (precompute_pairs: the [F, F] relative poses, FEJ
// adjoints and affine transfers) are made here from the window's T_eval,
// x, x_zero and exposure, in torch's operation order on the card, so that
// they equal ba/residuals.ba_slot_tables bit for bit: each CTA first makes
// the per-slot table in shared memory (a thread a slot: se3_exp of x[:6]
// times T_eval and the two inverses, lie.cuh's expressions, the
// exposures), then each lane makes its own (host, target) entry from two
// slots' rows when its sample needs it (rel = T_t T_h^-1, the adjoint's
// hat(t) R, the affine quotients). So no [F, F] table is stored and any F
// up to kMaxSlots takes the same route; the 8 lanes of a slot group make
// the same entry in step. How torch's small products and its 3-value sum
// round on the card is lie.cuh's (dot3, dot4, Rules); the file is built
// with -fmad=false (kernels/ba.py) so that nvcc contracts nothing else. A
// debug pointer, when given, receives the whole table from CTA 0 (the
// tests hold it to ba_slot_tables).
//
// Work and order of the sums, fixed, so that a second launch on the same
// inputs gives the same bits (no atomics in any sum):
//   A task is (point, pass): the point's 8 pattern points on the lanes of
//   each of 4 groups, group g taking the (4 pass + g)-th valid slot as its
//   target (the valid slots in slot order). A CTA of kWarps warps takes a
//   tile of NPT = kWarps / QP points, QP = ceil(valid slots / 4) passes
//   each, a task a warp; the CTAs take tiles c, c + grid, ...
//   In a task each lane makes its sample's rows in registers; a pair's 149
//   words (the weighted products TT, HT, TC of target8, host8 and cam4,
//   target8 r, target8 w d, the energy) are summed over the group's 8 lanes
//   and the task's 106 point words (HH, HC, BH, CC, BC, the energy, the
//   count, host8 w d, cam4 w d, H_dd, b_d) over its 32 lanes, 8 words at a
//   time by a butterfly that leaves word k on lane k of a group: lanes
//   (k, k ^ 4), then (k, k ^ 2), then (k, k ^ 1), i.e. ((x0 + x4) + (x2 +
//   x6)) + ((x1 + x5) + (x3 + x7)), a point word then over the groups as
//   (g0 + g1) + (g2 + g3). The words go to the tile's staging in shared
//   memory; a task whose 32 samples are all invalid is marked empty and
//   writes nothing.
//   Then the point's outputs (its H_xd row, H_dd, b_d, e_pair, the masks)
//   are written from the staging by a warp a point, its passes added in
//   pass order; and each entry of the CTA's partial system (the upper
//   triangle of H, b, the energy and the count, in kernels/ba.index_table's
//   order) is owned by one thread, which adds its terms (up to 4: a pair
//   word of a given target slot or a point word, counted always or only
//   when the point's host is a given slot) over the tile's tasks in task
//   order, term by term, into the partial in shared memory.
//   After its tiles a CTA writes its partial to scratch; the last CTA of
//   each group of kGroupSize CTAs (found by a counter and __threadfence)
//   adds the group's partials in CTA order, and the last group to finish
//   adds the group sums in group order into shared memory and writes H
//   (each entry at (row, col) and (col, row)), b and the energy in output
//   order (kernels/ba.output_entries), and the count. The counters are
//   reset by the CTA that reads them last, ready for the next launch on
//   the stream. (Clusters of 8 CTAs adding their partials through
//   distributed shared memory were slower: a grid of them does not fit on
//   the card at once.)
//
// What bounds it on Hopper: bytes. A default window (2048 points, 10 slots
// of 640x480 (I, dx, dy), 163,840 samples) needs each point's inputs once
// (~90 B), the distinct texels of the valid samples and the outputs once
// (H_xd is 0.69 MB of them): a few microseconds at 3.35 TB/s, against
// ~100 Mflop, a microsecond and a half at 67 TFLOP/s. The first version of
// this kernel (two launches) wrote a 1,492-float record a point and read it
// back in a second launch that looped over every point for each of the
// 3,656 entries, with each warp's pair sums on divergent branches, and left
// the pair tables to ~150 torch launches on the host. Here the pair tables
// cost a few hundred register operations a lane, the sums are branch-free
// shuffles in registers, a point's 10-slot work is 2-3 warps so that a
// 1,190-point window keeps 16 warps on every SM, and what crosses device
// memory besides the inputs and outputs is one partial system a CTA, read
// once from L2.
//
// Plain C interface (bound with ctypes): the entry point launches on the
// given stream, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch.

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>
#include <utility>

#include "lie.cuh"

namespace {

using lie::dot3;

constexpr int kWarps = 16;                  // tasks a tile
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSlots = 32;
constexpr int kGroupSize = 16;              // CTAs whose partials one CTA adds
constexpr int kOwn = 4;                     // entries of the partial a thread reads ahead
constexpr unsigned kFull = 0xffffffffu;
constexpr int kModeActive = 0, kModeFej = 1, kModeEnergy = 2;
// a pair's words (kernels/ba.py's GROUP_WORDS): TT the upper triangle of
// w target8 target8^T, HT w host8 target8^T (row-major), TC w target8
// cam4^T, BT target8 wr, HX target8 w d, the energy
constexpr int kGW = 149, kTT = 0, kHT = 36, kTC = 100, kBT = 132, kHX = 140, kGE = 148;
// a task's point words (POINT_WORDS): HH, HC, BH, CC, BC, the energy, the
// count, HXH host8 w d, HXC cam4 w d, H_dd, b_d
constexpr int kPW = 106, kHH = 0, kHC = 36, kBH = 68, kCC = 76, kBC = 86, kPE = 90, kPN = 91,
              kHXH = 92, kHXC = 100, kHDD = 104, kBD = 105;
static_assert(kTT == 0 && kHH == 0, "the first pair word and point word are TT's and HH's");
constexpr int kPointBase = 4 * kGW;         // a task's staging: 4 pairs, then its point words
constexpr int kTaskWords = kPointBase + kPW;
// a task's mask word: bit g a valid sample in group g, bit 4 + g group g
// requested, kNonEmpty any valid sample
constexpr unsigned kNonEmpty = 1u << 8;
// a row of index_table: 4 terms, then the entry's place in H, b and the
// energy (or -1: the count) and its mirror in H (or -1), 2 words of
// padding; a term is word | src << 8 | cond << 16 (src a target slot, or
// kSrcPoint; cond a host slot, or kAlways), -1 unused
constexpr int kSrcPoint = 32, kAlways = 32, kTableWords = 8;
// a sample's row in registers: target8, host8, cam4, d, w, w r, e, r
constexpr int kRow = 25, kD = 20, kW = 21, kWR = 22, kE = 23, kR = 24;
// the per-slot table in shared memory: T_cur rows 0-2, T_cur^-1 rows 0-2,
// T_eval rows 0-2, T_eval^-1 rows 0-2 (4 columns each), the two exposure
// gains, b and b_zero
constexpr int kSlotWords = 52, kTc = 0, kTci = 12, kTe = 24, kTei = 36, kEac = 48, kEaf = 49,
              kBc = 50, kBf = 51;
constexpr int kPairTable = 62;              // ba_slot_tables' [host, target] entry
// the partial's place in shared memory, (kSlotWords + 8) F + 4 + kWarps
// kTaskWords floats in, is 16-byte aligned for its float4 copies
static_assert((kSlotWords + 8) % 4 == 0 && (4 + kWarps * kTaskWords) % 4 == 0,
              "the partial in shared memory is not 16-byte aligned");

// core/window.PATTERN_OFFSETS (config.PATTERN)
__constant__ float kPat[8][2] = {{0.f, -2.f}, {-1.f, -1.f}, {1.f, -1.f}, {-2.f, 0.f},
                                 {0.f, 0.f},  {2.f, 0.f},   {-1.f, 1.f}, {0.f, 2.f}};

struct Params {
  const float* images;                 // [F, H, W, 3] level-0 (I, dx, dy)
  int H, W, P, F;
  const unsigned char* frame_valid;    // [F] bool
  const float* T_eval;                 // [F, 4, 4]
  const float* x;                      // [F, 8]
  const float* x_zero;                 // [F, 8]
  const float* exposure;               // [F]
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
  float huber, outlier_sum;
  int mode;
  const int32_t* table;                // [n, kTableWords] index_table(F), or energy_table()
  int n;
  const int32_t* out_entry;            // [n_out] output_entries(F): each output's entry
  int n_out;                           // D * D + D + 1 (energy_only: 1)
  float* sys;                          // H [D, D], b [D], energy (energy_only: energy)
  float* H_xd;                         // [P, 8F + 4]
  float* H_dd;                         // [P]
  float* b_d;                          // [P]
  float* e_pair;                       // [P, F]
  long long* count;                    // [1]
  unsigned char* valid_pair;           // [P, F] bool
  unsigned char* oob_pair;             // [P, F] bool
  float* part;                         // [grid, n4] scratch (n4: n rounded up to 4)
  float* gpart;                        // [groups, n4] scratch
  unsigned* counters;                  // [groups + 1], zero between launches
  float* debug;                        // [F, F, kPairTable] + [F, 3], or null
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

// slot f's entry of the per-slot table: T_cur = se3_exp(x[f, :6]) T_eval[f]
// (lie.cuh), the inverses, the exposure gains exposure e^a at the current and
// the FEJ state, b and b_zero
__device__ void slot_entry(const Params& p, int f, float* s) {
  const lie::Rules ru = lie::rules(p.F);
  const float* xi = p.x + 8 * f;
  const float* Te = p.T_eval + 16 * f;
  lie::exp_times34(xi, Te, ru, s + kTc);
#pragma unroll
  for (int e = 0; e < 12; ++e) s[kTe + e] = Te[e];
  lie::inverse34(s + kTc, s + kTci, ru.slot);
  lie::inverse34(s + kTe, s + kTei, ru.slot);
  s[kEac] = p.exposure[f] * expf(xi[6]);
  s[kEaf] = p.exposure[f] * expf(p.x_zero[8 * f + 6]);
  s[kBc] = xi[7];
  s[kBf] = p.x_zero[8 * f + 7];
}

// a [host, target] entry of the pair table from the two slots' rows
struct Pair {
  float Rc[9], tc[3], Rf[9], tf[3], tR[9], ac, af;
};

__device__ __forceinline__ void make_pair(const float* sh, const float* sf, int F, Pair& q) {
  const lie::Rules ru = lie::rules(F);
  // rel = T_t T_h^-1 (torch.einsum "tij,hjk->htik")
  float cur[12], fej[12];
  lie::mul34(sf + kTc, sh + kTci, cur, ru.rel);
  lie::mul34(sf + kTe, sh + kTei, fej, ru.rel);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      q.Rc[3 * i + k] = cur[4 * i + k];
      q.Rf[3 * i + k] = fej[4 * i + k];
    }
    q.tc[i] = cur[4 * i + 3];
    q.tf[i] = fej[4 * i + 3];
  }
  // lie.se3_adjoint: hat(t) R
  const float ht[3][3] = {{0.f, -q.tf[2], q.tf[1]}, {q.tf[2], 0.f, -q.tf[0]},
                          {-q.tf[1], q.tf[0], 0.f}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      q.tR[3 * i + j] = dot3(ht[i][0], q.Rf[j], ht[i][1], q.Rf[3 + j], ht[i][2], q.Rf[6 + j],
                             ru.adj);
  }
  q.ac = sf[kEac] / sh[kEac];
  q.af = sf[kEaf] / sh[kEaf];
}

// entry (i, j) of the 6x6 FEJ adjoint [[R, hat(t) R], [0, R]]
__device__ __forceinline__ float adj(const Pair& q, int i, int j) {
  if (i < 3) return j < 3 ? q.Rf[3 * i + j] : q.tR[3 * i + j - 3];
  return j < 3 ? 0.f : q.Rf[3 * (i - 3) + j - 3];
}

// ---- a task's words: the products of a sample's row, by word index

__host__ __device__ constexpr int sym_a(int o, int n) {
  int a = 0;
  while (o >= n - a) {
    o -= n - a;
    ++a;
  }
  return a;
}

__host__ __device__ constexpr int sym_b(int o, int n) {
  int a = 0;
  while (o >= n - a) {
    o -= n - a;
    ++a;
  }
  return a + o;
}

template <int O>
__device__ __forceinline__ float group_word(const float (&x)[kRow], float wd) {
  if constexpr (O < kHT) {
    constexpr int a = sym_a(O, 8), b = sym_b(O, 8);
    return (x[kW] * x[a]) * x[b];
  } else if constexpr (O < kTC) {
    return (x[kW] * x[8 + (O - kHT) / 8]) * x[(O - kHT) % 8];
  } else if constexpr (O < kBT) {
    return (x[kW] * x[(O - kTC) / 4]) * x[16 + (O - kTC) % 4];
  } else if constexpr (O < kHX) {
    return x[O - kBT] * x[kWR];
  } else if constexpr (O < kGE) {
    return x[O - kHX] * wd;
  } else if constexpr (O == kGE) {
    return x[kE];
  } else {
    return 0.f;
  }
}

template <int O>
__device__ __forceinline__ float point_word(const float (&x)[kRow], float wd, float n) {
  if constexpr (O < kHC) {
    constexpr int a = sym_a(O, 8), b = sym_b(O, 8);
    return (x[kW] * x[8 + a]) * x[8 + b];
  } else if constexpr (O < kBH) {
    return (x[kW] * x[8 + (O - kHC) / 4]) * x[16 + (O - kHC) % 4];
  } else if constexpr (O < kCC) {
    return x[8 + O - kBH] * x[kWR];
  } else if constexpr (O < kBC) {
    constexpr int i = sym_a(O - kCC, 4), j = sym_b(O - kCC, 4);
    return (x[kW] * x[16 + i]) * x[16 + j];
  } else if constexpr (O < kPE) {
    return x[16 + O - kBC] * x[kWR];
  } else if constexpr (O == kPE) {
    return x[kE];
  } else if constexpr (O == kPN) {
    return n;
  } else if constexpr (O < kHXC) {
    return x[8 + O - kHXH] * wd;
  } else if constexpr (O < kHDD) {
    return x[16 + O - kHXC] * wd;
  } else if constexpr (O == kHDD) {
    return wd * x[kD];
  } else if constexpr (O == kBD) {
    return wd * x[kR];
  } else {
    return 0.f;
  }
}

// value k of every lane of a group of 8 summed over the group, left on its
// lane k: lanes (k, k ^ 4), then (k, k ^ 2), then (k, k ^ 1)
__device__ __forceinline__ float scatter8(const float (&v)[8], int lane) {
  const bool b4 = (lane & 4) != 0, b2 = (lane & 2) != 0, b1 = (lane & 1) != 0;
  float u[4], y[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = b4 ? v[i + 4] : v[i], send = b4 ? v[i] : v[i + 4];
    u[i] = keep + __shfl_xor_sync(kFull, send, 4);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = b2 ? u[i + 2] : u[i], send = b2 ? u[i] : u[i + 2];
    y[i] = keep + __shfl_xor_sync(kFull, send, 2);
  }
  const float keep = b1 ? y[1] : y[0], send = b1 ? y[0] : y[1];
  return keep + __shfl_xor_sync(kFull, send, 1);
}

template <int C, int... I>
__device__ __forceinline__ void group_chunk(const float (&x)[kRow], float wd, int lane, float* st,
                                            std::integer_sequence<int, I...>) {
  const float v[8] = {group_word<8 * C + I>(x, wd)...};
  const float s = scatter8(v, lane);
  const int o = 8 * C + (lane & 7);
  if (o < kGW) st[(lane >> 3) * kGW + o] = s;
}

template <int C, int... I>
__device__ __forceinline__ void point_chunk(const float (&x)[kRow], float wd, float n, int lane,
                                            float* st, std::integer_sequence<int, I...>) {
  const float v[8] = {point_word<8 * C + I>(x, wd, n)...};
  float s = scatter8(v, lane);
  s += __shfl_xor_sync(kFull, s, 8);
  s += __shfl_xor_sync(kFull, s, 16);
  const int o = 8 * C + lane;
  if (lane < 8 && o < kPW) st[kPointBase + o] = s;
}

template <int... C>
__device__ __forceinline__ void group_words(const float (&x)[kRow], float wd, int lane, float* st,
                                            std::integer_sequence<int, C...>) {
  (group_chunk<C>(x, wd, lane, st, std::make_integer_sequence<int, 8>{}), ...);
}

template <int... C>
__device__ __forceinline__ void point_words(const float (&x)[kRow], float wd, float n, int lane,
                                            float* st, std::integer_sequence<int, C...>) {
  (point_chunk<C>(x, wd, n, lane, st, std::make_integer_sequence<int, 8>{}), ...);
}

// ---- one task: point pt, pass q, on one warp
__device__ void run_task(const Params& p, const float* s_slot, const float* s_delta,
                         const int* s_vslot, int nvalid, int pt, int q, int lane, float* st,
                         unsigned* tmask) {
  const int F = p.F;
  const int g = lane >> 3, k = lane & 7;
  const bool in = pt < p.P;
  const int h = in ? min(max(static_cast<int>(p.p_host[pt]), 0), F - 1) : 0;
  const int vi = 4 * q + g;
  const int f = vi < nvalid ? s_vslot[vi] : -1;
  const bool requested = in && f >= 0 && p.p_valid[pt] && p.res_mask[pt * F + f];
  const bool energy_only = p.mode == kModeEnergy;
  float x[kRow];
#pragma unroll
  for (int j = 0; j < kRow; ++j) x[j] = 0.f;
  bool valid = false;
  if (requested) {
    Pair T;
    make_pair(s_slot + h * kSlotWords, s_slot + f * kSlotWords, F, T);
    const float fx = p.c[0], fy = p.c[1], cx = p.c[2], cy = p.c[3];
    const float u = p.p_uv[2 * pt], v = p.p_uv[2 * pt + 1];
    const float idepth = p.p_idepth[pt];
    const float xh[3] = {((u + kPat[k][0]) - cx) / fx, ((v + kPat[k][1]) - cy) / fy, 1.f};
    float X[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      X[i] = dot3(T.Rc[3 * i], xh[0], T.Rc[3 * i + 1], xh[1], T.Rc[3 * i + 2], xh[2])
             + T.tc[i] * idepth;
    const bool okz = X[2] > 1e-6f;
    const float zs = okz ? X[2] : 1.f;
    const float un = (fx * X[0]) / zs + cx, vn = (fy * X[1]) / zs + cy;
    valid = okz && in_bounds2(un, vn, p.W, p.H);
    const float fx0 = p.c_zero[0], fy0 = p.c_zero[1], cx0 = p.c_zero[2], cy0 = p.c_zero[3];
    const float xc[3] = {(u - cx0) / fx0, (v - cy0) / fy0, 1.f};
    const float idepth0 = p.p_idepth_zero[pt];
    float up0 = 0.f, vp0 = 0.f, dre = 1.f;
    if (valid && !energy_only) {
      float X0[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        X0[i] = dot3(T.Rf[3 * i], xc[0], T.Rf[3 * i + 1], xc[1], T.Rf[3 * i + 2], xc[2])
                + T.tf[i] * idepth0;
      const bool ok0 = X0[2] > 1e-6f;
      dre = 1.f / (ok0 ? X0[2] : 1.f);
      up0 = X0[0] * dre;
      vp0 = X0[1] * dre;
      valid = ok0 && in_bounds2(fx0 * up0 + cx0, fy0 * vp0 + cy0, p.W, p.H);
    }
    if (valid) {
      float hit[3];
      sample3(p.images + static_cast<size_t>(f) * p.H * p.W * 3, p.W, p.H, un, vn, hit);
      const float color = p.p_color[8 * pt + k], weight = p.p_weight[8 * pt + k];
      const float* sh = s_slot + h * kSlotWords;
      const float r = (hit[0] - s_slot[f * kSlotWords + kBc]) - T.ac * (color - sh[kBc]);
      const float gx = hit[1], gy = hit[2];
      const float w_tgt = sqrtf(p.outlier_sum / (p.outlier_sum + (gx * gx + gy * gy)));
      const float w_stat = 0.5f * (w_tgt + weight);
      const float ar = fabsf(r);
      const float hw = ar < p.huber ? 1.f : p.huber / fmaxf(ar, 1e-12f);
      const float w = (w_stat * w_stat) * hw;
      x[kW] = w;
      x[kE] = ((w * r) * r) * (2.f - hw);
      if (!energy_only) {
        // the geometric Jacobians at the FEJ state (assemble_torch's
        // _pose_jacobian, _cam_jacobian and Jp_d), then times g
        const float nid = idepth0 * dre;
        const float Ju[6] = {nid * fx0, 0.f, ((-nid) * up0) * fx0, ((-up0) * vp0) * fx0,
                             (1.f + up0 * up0) * fx0, (-vp0) * fx0};
        const float Jv[6] = {0.f, nid * fy0, ((-nid) * vp0) * fy0,
                             (-(1.f + vp0 * vp0)) * fy0, (up0 * vp0) * fy0, up0 * fy0};
#pragma unroll
        for (int j = 0; j < 6; ++j) x[j] = fmaf(gy, Jv[j], gx * Ju[j]);
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < 6; ++i) a = fmaf(x[i], adj(T, i, j), a);
          x[8 + j] = -a;
        }
        // d(normalized host dir)/d(fx, fy, cx, cy), through R_fej's first two columns
        const float dxh[4] = {-xc[0] / fx0, 0.f, -1.f / fx0, 0.f};
        const float dyh[4] = {0.f, -xc[1] / fy0, 0.f, -1.f / fy0};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float dX0 = T.Rf[0] * dxh[j] + T.Rf[1] * dyh[j];
          const float dX1 = T.Rf[3] * dxh[j] + T.Rf[4] * dyh[j];
          const float dX2 = T.Rf[6] * dxh[j] + T.Rf[7] * dyh[j];
          const float cu = fx0 * (dre * (dX0 - up0 * dX2)) + (j == 0 ? up0 : j == 2 ? 1.f : 0.f);
          const float cv = fy0 * (dre * (dX1 - vp0 * dX2)) + (j == 1 ? vp0 : j == 3 ? 1.f : 0.f);
          x[16 + j] = fmaf(gy, cv, gx * cu);
        }
        x[kD] = fmaf(gy, (fy0 * dre) * (T.tf[1] - T.tf[2] * vp0),
                     gx * ((fx0 * dre) * (T.tf[0] - T.tf[2] * up0)));
        const float a_fej = T.af, col0 = color - sh[kBf];
        x[6] = -a_fej * col0;
        x[7] = -1.f;
        x[14] = a_fej * col0;
        x[15] = a_fej;
        float r_used = r;
        if (p.mode == kModeFej) {
          float jd = 0.f;
#pragma unroll
          for (int a = 0; a < 8; ++a) jd = fmaf(x[a], s_delta[8 * f + a], jd);
          float jh = 0.f;
#pragma unroll
          for (int a = 0; a < 8; ++a) jh = fmaf(x[8 + a], s_delta[8 * h + a], jh);
          float jc = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) jc = fmaf(x[16 + j], s_delta[8 * F + j], jc);
          r_used = r - (((jd + jh) + jc) + x[kD] * (idepth - idepth0));
        }
        x[kR] = r_used;
        x[kWR] = w * r_used;
      }
    }
  }
  const unsigned vm = __ballot_sync(kFull, valid);
  const unsigned rm = __ballot_sync(kFull, requested);
  if (lane == 0) {
    unsigned m = vm ? kNonEmpty : 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      m |= (((vm >> (8 * j)) & 0xffu) ? 1u << j : 0u) | (((rm >> (8 * j)) & 1u) << (4 + j));
    *tmask = m;
  }
  if (vm == 0u) return;                      // an empty task: nothing staged
  const float n = valid ? 1.f : 0.f;
  if (energy_only) {
    float e = x[kE], c = n;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      e += __shfl_xor_sync(kFull, e, off);
      c += __shfl_xor_sync(kFull, c, off);
    }
    if (lane == 0) {
      st[kPointBase + kPE] = e;
      st[kPointBase + kPN] = c;
    }
    return;
  }
  const float wd = x[kW] * x[kD];
  group_words(x, wd, lane, st, std::make_integer_sequence<int, (kGW + 7) / 8>{});
  point_words(x, wd, n, lane, st, std::make_integer_sequence<int, (kPW + 7) / 8>{});
}

// x[0] + x[stride] + ... + x[(rows - 1) stride] (4 entries a float4), in
// row order, read from L2 (other CTAs wrote them), kGroupSize rows at a
// time
__device__ __forceinline__ float4 sum_rows(const float4* x, int stride, int rows) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = 0; r0 < rows; r0 += kGroupSize) {
    float4 w[kGroupSize];
#pragma unroll
    for (int r = 0; r < kGroupSize; ++r)
      if (r0 + r < rows) w[r] = __ldcg(x + static_cast<size_t>(r0 + r) * stride);
#pragma unroll
    for (int r = 0; r < kGroupSize; ++r) {
      if (r0 + r >= rows) continue;
      if (r0 + r == 0) {
        v = w[r];
      } else {
        v.x += w[r].x;
        v.y += w[r].y;
        v.z += w[r].z;
        v.w += w[r].w;
      }
    }
  }
  return v;
}

__global__ void __launch_bounds__(kThreads, 1) ba_kernel(const __grid_constant__ Params p) {
  extern __shared__ float dyn[];
  __shared__ int s_vslot[kMaxSlots], s_vidx[kMaxSlots], s_host[kWarps];
  __shared__ unsigned s_tmask[kWarps], s_hostm[kMaxSlots], s_passm[8];
  __shared__ int s_nvalid;
  __shared__ bool s_last;
  const int F = p.F, D = 8 * F + 4, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool energy_only = p.mode == kModeEnergy;
  float* s_slot = dyn;                                  // [F, kSlotWords]
  float* s_delta = s_slot + F * kSlotWords;             // [8F + 4]
  float* s_stage = s_delta + 8 * F + 4;                 // [kWarps, kTaskWords]
  float* s_part = s_stage + kWarps * kTaskWords;        // [n4], 16-byte aligned
  float4* s_part4 = reinterpret_cast<float4*>(s_part);
  const int n4 = (p.n + 3) & ~3;

  // ---- the per-slot table, the state delta, the valid slots
  if (tid < F) slot_entry(p, tid, s_slot + tid * kSlotWords);
  if (tid < 8 * F)
    s_delta[tid] = p.x[tid] - p.x_zero[tid];
  else if (tid < 8 * F + 4)
    s_delta[tid] = p.c[tid - 8 * F] - p.c_zero[tid - 8 * F];
  if (warp == 0) {
    const bool v = lane < F && p.frame_valid[lane] != 0;
    const unsigned m = __ballot_sync(kFull, v);
    const int idx = __popc(m & ((1u << lane) - 1u));
    if (v) s_vslot[idx] = lane;
    s_vidx[lane] = v ? idx : -1;
    if (lane == 0) s_nvalid = __popc(m);
  }
  for (int e = tid; e < n4; e += kThreads) s_part[e] = 0.f;
  __syncthreads();
  if (p.debug != nullptr && blockIdx.x == 0) {
    for (int i = tid; i < F * F; i += kThreads) {
      const int h = i / F, f = i % F;
      Pair q;
      make_pair(s_slot + h * kSlotWords, s_slot + f * kSlotWords, F, q);
      float* o = p.debug + static_cast<size_t>(i) * kPairTable;
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        o[j] = q.Rc[j];
        o[12 + j] = q.Rf[j];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        o[9 + j] = q.tc[j];
        o[21 + j] = q.tf[j];
      }
#pragma unroll
      for (int i6 = 0; i6 < 6; ++i6) {
#pragma unroll
        for (int j = 0; j < 6; ++j) o[24 + 6 * i6 + j] = adj(q, i6, j);
      }
      o[60] = q.ac;
      o[61] = q.af;
    }
    if (tid < F) {
      float* o = p.debug + static_cast<size_t>(F) * F * kPairTable + 3 * tid;
      o[0] = p.x[8 * tid + 7];
      o[1] = p.x_zero[8 * tid + 7];
      o[2] = p.x[8 * tid + 7];
    }
  }

  const int nvalid = s_nvalid;
  const int QP = max((nvalid + 3) / 4, 1);
  const int NPT = kWarps / QP;
  const int ntask = NPT * QP;
  const int tiles = (p.P + NPT - 1) / NPT;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p0 = tile * NPT;
    if (warp < ntask) {
      const int i = warp / QP, q = warp % QP, pt = p0 + i;
      if (q == 0 && lane == 0)
        s_host[i] = pt < p.P ? min(max(static_cast<int>(p.p_host[pt]), 0), F - 1) : 0;
      run_task(p, s_slot, s_delta, s_vslot, nvalid, pt, q, lane, s_stage + warp * kTaskWords,
               s_tmask + warp);
    }
    __syncthreads();
    // the non-empty tasks of each host slot and of each pass
    if (tid < F) {
      unsigned m = 0u;
      for (int t = 0; t < ntask; ++t)
        if ((s_tmask[t] & kNonEmpty) && s_host[t / QP] == tid) m |= 1u << t;
      s_hostm[tid] = m;
    } else if (tid >= 32 && tid < 32 + QP) {
      unsigned m = 0u;
      for (int t = tid - 32; t < ntask; t += QP)
        if (s_tmask[t] & kNonEmpty) m |= 1u << t;
      s_passm[tid - 32] = m;
    }
    __syncthreads();
    // the points' own outputs, a warp a point
    if (!energy_only && warp < NPT && p0 + warp < p.P) {
      const int i = warp, pt = p0 + i, h = s_host[i], base = i * QP;
      for (int j = lane; j < D; j += 32) {
        float v = 0.f;
        if (j < 8 * F) {
          const int s = j >> 3, vi = s_vidx[s];
          if (vi >= 0) {
            const int t = base + (vi >> 2);
            if (s_tmask[t] & kNonEmpty)
              v = s_stage[t * kTaskWords + (vi & 3) * kGW + kHX + (j & 7)];
          }
          if (s == h) {
            float hh = 0.f;
            for (int qq = 0; qq < QP; ++qq)
              if (s_tmask[base + qq] & kNonEmpty)
                hh += s_stage[(base + qq) * kTaskWords + kPointBase + kHXH + (j & 7)];
            v = v + hh;
          }
        } else {
          for (int qq = 0; qq < QP; ++qq)
            if (s_tmask[base + qq] & kNonEmpty)
              v += s_stage[(base + qq) * kTaskWords + kPointBase + kHXC + (j - 8 * F)];
        }
        p.H_xd[static_cast<size_t>(pt) * D + j] = v;
      }
      if (lane < 2) {
        float v = 0.f;
        for (int qq = 0; qq < QP; ++qq)
          if (s_tmask[base + qq] & kNonEmpty)
            v += s_stage[(base + qq) * kTaskWords + kPointBase + (lane ? kBD : kHDD)];
        (lane ? p.b_d : p.H_dd)[pt] = v;
      }
      if (lane < F) {
        const int vi = s_vidx[lane];
        float e = 0.f;
        bool any = false, req = false;
        if (vi >= 0) {
          const unsigned m = s_tmask[base + (vi >> 2)];
          any = (m >> (vi & 3)) & 1u;
          req = (m >> (4 + (vi & 3))) & 1u;
          if (m & kNonEmpty) e = s_stage[(base + (vi >> 2)) * kTaskWords + (vi & 3) * kGW + kGE];
        }
        p.e_pair[pt * F + lane] = e;
        p.valid_pair[pt * F + lane] = any;
        p.oob_pair[pt * F + lane] = req && !any;
      }
    }
    // each entry of the partial system: its terms over the tile's tasks
    unsigned nonempty = 0u;
    for (int t = 0; t < ntask; ++t)
      if (s_tmask[t] & kNonEmpty) nonempty |= 1u << t;
    if (nonempty) {
      // kOwn entries' rows in flight at a time
      for (int e0 = tid; e0 < p.n; e0 += kThreads * kOwn) {
        int4 rows[kOwn];
#pragma unroll
        for (int u = 0; u < kOwn; ++u) {
          const int e = e0 + u * kThreads;
          rows[u] = e < p.n ? __ldg(reinterpret_cast<const int4*>(p.table + e * kTableWords))
                            : make_int4(-1, -1, -1, -1);
        }
#pragma unroll
        for (int u = 0; u < kOwn; ++u) {
          const int e = e0 + u * kThreads;
          if (e >= p.n) continue;
          const int tt[4] = {rows[u].x, rows[u].y, rows[u].z, rows[u].w};
          float v = s_part[e];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int term = tt[j];
            if (term < 0) continue;
            const int word = term & 255, src = (term >> 8) & 63, cond = (term >> 16) & 63;
            unsigned m = nonempty;
            int off;
            if (src == kSrcPoint) {
              off = kPointBase + word;
            } else {
              const int vi = s_vidx[src];
              if (vi < 0) continue;
              m &= s_passm[vi >> 2];
              off = (vi & 3) * kGW + word;
            }
            if (cond != kAlways) m &= s_hostm[cond];
            if (m == 0u) continue;
            // the matching tasks in task order, their loads issued together
            const float* x = s_stage + off;
            float w[kWarps];
#pragma unroll
            for (int t = 0; t < kWarps; ++t) w[t] = (m >> t) & 1u ? x[t * kTaskWords] : 0.f;
#pragma unroll
            for (int t = 0; t < kWarps; ++t)
              if ((m >> t) & 1u) v += w[t];
          }
          s_part[e] = v;
        }
      }
    }
    __syncthreads();
  }

  // ---- the partials: this CTA's, then its group's, then the whole grid's,
  // rows of n4 floats read and written 4 at a time
  const int w4 = n4 / 4;
  float4* part4 = reinterpret_cast<float4*>(p.part);
  float4* gpart4 = reinterpret_cast<float4*>(p.gpart);
  for (int i = tid; i < w4; i += kThreads)
    part4[static_cast<size_t>(blockIdx.x) * w4 + i] = s_part4[i];
  __threadfence();
  __syncthreads();
  const int grp = blockIdx.x / kGroupSize, g0 = grp * kGroupSize;
  const int g1 = min(g0 + kGroupSize, static_cast<int>(gridDim.x));
  const int groups = (gridDim.x + kGroupSize - 1) / kGroupSize;
  if (tid == 0) s_last = atomicAdd(p.counters + grp, 1u) == static_cast<unsigned>(g1 - g0 - 1);
  __syncthreads();
  if (!s_last) return;
  if (tid == 0) p.counters[grp] = 0u;
  for (int i = tid; i < w4; i += kThreads)
    gpart4[static_cast<size_t>(grp) * w4 + i] = sum_rows(part4 + static_cast<size_t>(g0) * w4 + i,
                                                         w4, g1 - g0);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(p.counters + groups, 1u) == static_cast<unsigned>(groups - 1);
  __syncthreads();
  if (!s_last) return;
  if (tid == 0) p.counters[groups] = 0u;
  // the totals into shared memory, then H (row-major, each entry at (row,
  // col) and (col, row)), b and the energy written in output order
  for (int i = tid; i < w4; i += kThreads) s_part4[i] = sum_rows(gpart4 + i, w4, groups);
  __syncthreads();
  for (int o = tid; o < p.n_out; o += kThreads) p.sys[o] = s_part[__ldg(p.out_entry + o)];
  if (tid == 0) p.count[0] = static_cast<long long>(s_part[p.n - 1]);
}

size_t smem_bytes(int F, int n) {
  return sizeof(float) * (static_cast<size_t>(F) * kSlotWords + 8 * F + 4
                          + static_cast<size_t>(kWarps) * kTaskWords + ((n + 3) & ~3));
}

}  // namespace

extern "C" int ldso_ba_threads() { return kThreads; }

extern "C" int ldso_ba_group_size() { return kGroupSize; }

extern "C" int ldso_ba_assemble(
    const void* images, int H, int W, int F, const void* frame_valid, const void* T_eval,
    const void* x, const void* x_zero, const void* exposure, const void* c, const void* c_zero,
    int P, const void* p_valid, const void* p_host, const void* p_uv, const void* p_color,
    const void* p_weight, const void* p_idepth, const void* p_idepth_zero, const void* res_mask,
    float huber, float outlier_sum, int mode, const void* table, int n, const void* out_entry,
    int n_out, void* sys, void* H_xd,
    void* H_dd, void* b_d, void* e_pair, void* count, void* valid_pair, void* oob_pair,
    void* part, void* gpart, void* counters, void* debug, int grid, void* stream) {
  if (P < 0 || H < 1 || W < 1 || F < 1 || F > kMaxSlots || n < 1 || n_out < 1 || grid < 1
      || mode < kModeActive || mode > kModeEnergy)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.images = static_cast<const float*>(images);
  p.H = H;
  p.W = W;
  p.P = P;
  p.F = F;
  p.frame_valid = static_cast<const unsigned char*>(frame_valid);
  p.T_eval = static_cast<const float*>(T_eval);
  p.x = static_cast<const float*>(x);
  p.x_zero = static_cast<const float*>(x_zero);
  p.exposure = static_cast<const float*>(exposure);
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
  p.huber = huber;
  p.outlier_sum = outlier_sum;
  p.mode = mode;
  p.table = static_cast<const int32_t*>(table);
  p.n = n;
  p.out_entry = static_cast<const int32_t*>(out_entry);
  p.n_out = n_out;
  p.sys = static_cast<float*>(sys);
  p.H_xd = static_cast<float*>(H_xd);
  p.H_dd = static_cast<float*>(H_dd);
  p.b_d = static_cast<float*>(b_d);
  p.e_pair = static_cast<float*>(e_pair);
  p.count = static_cast<long long*>(count);
  p.valid_pair = static_cast<unsigned char*>(valid_pair);
  p.oob_pair = static_cast<unsigned char*>(oob_pair);
  p.part = static_cast<float*>(part);
  p.gpart = static_cast<float*>(gpart);
  p.counters = static_cast<unsigned*>(counters);
  p.debug = static_cast<float*>(debug);
  const size_t smem = smem_bytes(F, n);
  // above 48 KB of dynamic shared memory the kernel must ask for it; the
  // attribute is the device's, so it is set on every launch that needs it
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ba_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ba_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
