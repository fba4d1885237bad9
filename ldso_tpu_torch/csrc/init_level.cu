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
// dependent iterations. In one CTA (the first version of this kernel) an
// iteration took 22-27 us, ~80% of it the trial evaluation: each thread
// carried two points through 8 samples whose projections and gathers ran
// one after another (L2 latency each), and a 16-wide median sort. The
// design keeps each thread's arithmetic and the summation order of that
// version, so the outputs are its bits (chip_smoke.py phase 4e held them to
// the plain version; sums in another order parted from the plain version
// at near-ties beyond that yardstick's bounds), and takes the latency out:
//   * a launch is one thread-block cluster of kCluster = 8 CTAs (the largest
//     portable cluster; on the bench bootstrap 4 CTAs ran within 1% of it
//     and 2 CTAs ~19% slower) of 64 threads: 512 threads in all, global
//     thread g = rank 64 + tid, which takes points g, g + 512, ... in every
//     phase, as the one-CTA version's thread g did;
//   * each CTA holds its own points in dynamic shared memory, at slot
//     64 m + tid for point g + 512 m: the state and system
//     double-buffered (d, iR, Hdd, bd, Hxd and the good / pt_ok flags, the
//     accepted and the trial copy; accepting swaps an index), the 8 pattern
//     rays, made once a launch by the same expression, and the iteration's
//     neighbour median: 166 B a point. kMaxN, the most points the cluster
//     holds, is 21 x 512 = 10,752 (21 x 64 slots x 166 B + the static ~7 KB
//     <= 227 KB); K (at most 16) takes no shared memory;
//   * the medians depend on the accepted iR alone, so warps 1.. of each CTA
//     take them while warp 0 steps, two points a thread, their 2 K loads
//     issued together: a neighbour that another CTA owns is read through
//     distributed shared memory (a generic load of the owner's slot, mapped
//     by mapa), not from a copy of every iR in each CTA (K loads a point
//     against 7 copies of N floats pushed every iteration); a K-value
//     odd-even transposition sort (K rounds), specialised on K. No CTA
//     writes the buffer its peers read in the same pass, and a peer reaches
//     the next pass only after this CTA's next partials;
//   * the trial evaluation is the one-CTA version's, its projections and
//     loads issued 4 samples at a time (asking L1 ahead for every sample's
//     corners, by prefetch at a fast projection, made the pass slower);
//   * a reduction keeps the one-CTA version's order: each warp's 48 sums by
//     csrc/cluster.cuh's reduce-scatter, each warp's partial pushed into
//     every peer's shared memory (st.async on the peer's mbarrier,
//     double-buffered), and every CTA sums the 16 warps' partials in warp
//     order itself; no sum uses atomics, and a second launch gives the same
//     bits;
//   * every CTA takes the step and the accept itself from the same sums (the
//     same bits), so no state is broadcast and no cluster-wide barrier runs
//     in the loop: the step in warp 0, every lane solving the damped 8x9
//     system in its own registers (LU with getrf's pivot rule, then getrs's
//     back substitution; one row a lane, the pivot by shuffles, took more
//     cycles), the exponential by lie.cuh; four __syncthreads an iteration,
//     no host read in the level.
// Under -DINIT_LEVEL_PHASES thread 0 of the rank-0 CTA stamps clock64()
// around the phases of an iteration (kernels/init_level.PHASE_NAMES): the
// Schur pass; each reduction's warp reduce-scatter, cross-warp part (the
// local barrier and the 16 warps' sum) and cross-CTA exchange (the pushes
// and the wait); the step's system rows, LU, back substitution and
// exponential; the barrier after it; the trial pass's depth update (the
// median read), its projections with gathers, and its accumulation; the
// accept. A second library; the main path's is built without it.
//
// Plain C interface (bound with ctypes): the entry point launches on the
// given stream, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "lie.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;        // a launch's threads, its CTAs together
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;          // CTAs a launch, one cluster
constexpr int kCta = kThreads / kCluster;   // threads a CTA (64)
constexpr int kTS = 6;               // log2(kCta)
constexpr int kCtaWarps = kWarps / kCluster;
static_assert((1 << kTS) == kCta, "kTS is log2 of the threads a CTA");
constexpr int kMaxN = 10752;         // points: 21 x 512, what a cluster of 8 holds
constexpr int kMaxK = 16;            // neighbours of a point
constexpr int kNS = dsm::kSums;      // the sums of a reduction (48)
constexpr int kB = 36;               // after H's upper triangle (36): b (8)
constexpr int kE = 44;               // then E
constexpr int kGood = 45;            // then #good of the evaluated state
constexpr int kOk = 46;              // then #samples with om > 0
constexpr int kKept = 47;            // then #(good & pt_ok)
constexpr int kGroup = 4;            // samples whose gathers are in flight together
// per point in dynamic shared memory: 12 floats a buffer (d, iR, Hdd, bd,
// Hxd (8)), the 8 rays (x0, x1), the iteration's median, a flag byte a
// buffer
constexpr int kStateFloats = 12;
constexpr int kSlotBytes = (2 * kStateFloats + 16 + 1) * 4 + 2;
constexpr int kSmemMax = 232448;     // what a CTA may use (227 KB)
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
  int cap;                           // slots a CTA: ceil(N / 512) x kCta
  float alpha_w, coupling, reg_keep, reg_weight, huber;
  float* T_out;                      // [4, 4]
  float* ab_out;                     // [2]
  float* d_out;                      // [N]
  float* iR_out;                     // [N]
  unsigned char* good_out;           // [N] bool
  float* scalars_out;                // [2]: E, |t|^2
  int64_t* counts_out;               // [2]: #(good & pt_ok), #(om > 0) over every evaluation
  float* ladder_out;                 // [iters, 2] or null: E and the trial's E' each iteration
  long long* phases_out;             // [kPhases] or null (instrumented build)
};

// Under -DINIT_LEVEL_PHASES thread 0 of the rank-0 CTA accumulates the
// cycles of each phase (kernels/init_level.py's PHASE_NAMES, in this
// order); the last two entries are the launch's whole cycles and its
// iterations.
#ifdef INIT_LEVEL_PHASES
constexpr int kPhases = 16;
#endif
enum { PH_START, PH_SCHUR, PH_WARP, PH_XWARP, PH_XCTA, PH_ROWS, PH_LU, PH_SOLVE, PH_EXP,
       PH_BARRIER, PH_MEDIAN, PH_GATHER, PH_ACCUM, PH_ACCEPT };
struct Stamps {
#ifdef INIT_LEVEL_PHASES
  bool on;
  long long last, t0, ph[kPhases];
  __device__ void begin(bool who) {
    on = who;
    t0 = last = clock64();
    for (int i = 0; i < kPhases; ++i) ph[i] = 0;
  }
  __device__ __forceinline__ void operator()(int i) {
    if (on) {
      const long long t = clock64();
      ph[i] += t - last;
      last = t;
    }
  }
  // the stamp waits for x (a gathered or computed value) to be there
  __device__ __forceinline__ void after(int i, float x) {
    asm volatile("" :: "f"(x));
    (*this)(i);
  }
  // the cycles so far are the start's
  __device__ void start() {
    if (!on) return;
    long long sum = 0;
    for (int i = 0; i < kPhases; ++i) {
      sum += ph[i];
      ph[i] = 0;
    }
    const long long t = clock64();
    ph[PH_START] = sum + (t - last);
    last = t;
  }
  __device__ void write(long long* out, int iters) {
    if (!on || out == nullptr) return;
    for (int i = 0; i < kPhases - 2; ++i) out[i] = ph[i];
    out[kPhases - 2] = clock64() - t0;
    out[kPhases - 1] = iters;
  }
#else
  __device__ __forceinline__ void begin(bool) {}
  __device__ __forceinline__ void operator()(int) {}
  __device__ __forceinline__ void after(int, float) {}
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void write(long long*, int) {}
#endif
};

// The level's geometry.
struct Geo {
  float s, off;                      // uv_l = uv s + off
  float fx, fy, cx, cy;
  float u_hi, v_hi;                  // in_bounds(uv, w, h, 2): 2 <= u < w - 3, 2 <= v < h - 3
};

struct Shared {
  unsigned long long mbar[2];        // the arrival of the peers' partials, per buffer
  float red[2][kWarps][kNS];         // the 16 warps' partials, double-buffered
  float sys[2][kNS];                 // the accepted / trial state's sums, priors added
  float sc[kNS];                     // an iteration's Schur sums
  float st[2][18];                   // the accepted / trial T (16), ab (2)
  float dx[8];
  int accept;
};

__device__ __forceinline__ int tri(int i, int j) {   // i <= j
  return i * 8 - (i * (i - 1)) / 2 + (j - i);
}

// One point's system at the state (st: T 16, ab 2; d, iR, good): Hxd, Hdd,
// bd with the prior, pt_ok; its terms of the global sums added to acc.
// rays[k * cap] are its pattern rays. kGroup samples are projected and
// their corners loaded (kernels/interp.bilinear's clamped indices) before
// any of them is summed; the sums run in sample order.
__device__ __forceinline__ void eval_point(const Params& P, const Geo& g, const float* st,
                                           const float2* rays, int cap, int p, float d,
                                           float iR, bool good, float hxd[8], float& hdd,
                                           float& bd, bool& pt_ok, float acc[kNS],
                                           Stamps& sp) {
  const float R00 = st[0], R01 = st[1], R02 = st[2], t0 = st[3];
  const float R10 = st[4], R11 = st[5], R12 = st[6], t1 = st[7];
  const float R20 = st[8], R21 = st[9], R22 = st[10], t2 = st[11];
  const float ea = expf(st[16]), b = st[17];
  const float fx = g.fx, fy = g.fy, cx = g.cx, cy = g.cy;
  const int H = P.H, W = P.W;
  const float* __restrict__ img = P.img3;
#pragma unroll
  for (int a = 0; a < 8; ++a) hxd[a] = 0.f;
  hdd = 0.f;
  bd = 0.f;
  int n_inb = 0;
#pragma unroll
  for (int k0 = 0; k0 < 8; k0 += kGroup) {
    float up[kGroup], vp[kGroup], zs[kGroup], du[kGroup], dv[kGroup], col[kGroup];
    float c00[kGroup][3], c10[kGroup][3], c01[kGroup][3], c11[kGroup][3];
    bool use[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const float2 x = rays[(k0 + j) * cap];
      const float X0 = (R00 * x.x + R01 * x.y + R02) + t0 * d;
      const float X1 = (R10 * x.x + R11 * x.y + R12) + t1 * d;
      const float X2 = (R20 * x.x + R21 * x.y + R22) + t2 * d;
      const bool ok_z = X2 > 1e-6f;
      zs[j] = ok_z ? X2 : 1.f;
      up[j] = X0 / zs[j];
      vp[j] = X1 / zs[j];
      const float un = fx * up[j] + cx, vn = fy * vp[j] + cy;
      const bool inb = (un >= 2.f) && (un < g.u_hi) && (vn >= 2.f) && (vn < g.v_hi) && ok_z;
      n_inb += inb ? 1 : 0;
      use[j] = inb && good;          // om = 0 otherwise: no term anywhere
      const float fu = floorf(un), fv = floorf(vn);
      du[j] = un - fu;
      dv[j] = vn - fv;
      const int iu = static_cast<int>(fu), iv = static_cast<int>(fv);
      const int u0 = min(max(iu, 0), W - 1), u1 = min(max(iu + 1, 0), W - 1);
      const int v0 = min(max(iv, 0), H - 1), v1 = min(max(iv + 1, 0), H - 1);
      const float* p00 = img + 3 * (v0 * W + u0);
      const float* p10 = img + 3 * (v0 * W + u1);
      const float* p01 = img + 3 * (v1 * W + u0);
      const float* p11 = img + 3 * (v1 * W + u1);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        c00[j][c] = use[j] ? __ldg(p00 + c) : 0.f;
        c10[j][c] = use[j] ? __ldg(p10 + c) : 0.f;
        c01[j][c] = use[j] ? __ldg(p01 + c) : 0.f;
        c11[j][c] = use[j] ? __ldg(p11 + c) : 0.f;
      }
      col[j] = use[j] ? __ldg(P.colors + 8 * p + k0 + j) : 0.f;
    }
    sp.after(PH_GATHER, c11[kGroup - 1][2] + c00[0][0]);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (!use[j]) continue;
      float hit[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float top = c00[j][c] * (1.f - du[j]) + c10[j][c] * du[j];
        const float bot = c01[j][c] * (1.f - du[j]) + c11[j][c] * du[j];
        hit[c] = top * (1.f - dv[j]) + bot * dv[j];
      }
      const float r = (hit[0] - ea * col[j]) - b;
      const float ar = fabsf(r);
      const float om = ar < P.huber ? 1.f : P.huber / fmaxf(ar, 1e-12f);
      const float gx = hit[1], gy = hit[2];
      const float u = up[j], v = vp[j];
      const float nid = d / zs[j], dre = 1.f / zs[j];
      float J[8];
      J[0] = gx * (nid * fx);
      J[1] = gy * (nid * fy);
      J[2] = gx * (-nid * u * fx) + gy * (-nid * v * fy);
      J[3] = gx * (-u * v * fx) + gy * (-(1.f + v * v) * fy);
      J[4] = gx * ((1.f + u * u) * fx) + gy * (u * v * fy);
      J[5] = gx * (-v * fx) + gy * (u * fy);
      J[6] = -ea * col[j];
      J[7] = -1.f;
      const float jd = gx * (fx * dre * (t0 - t2 * u)) + gy * (fy * dre * (t1 - t2 * v));
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
    sp.after(PH_ACCUM, acc[kE]);
  }
  pt_ok = n_inb >= 6;
  if (good) acc[kGood] += 1.f;
  if (good && pt_ok) acc[kKept] += 1.f;
  if (P.snapped) {
    hdd += P.coupling;
    bd += P.coupling * (d - iR);
  } else {
    hdd += P.alpha_w;
    bd += P.alpha_w * (d - 1.f);
  }
}

// The sums of the threads' acc over the whole cluster, into out[0..47] as
// warp 0 of every CTA sees them (a __syncwarp after), in the one-CTA
// version's order: each warp's partial by the reduce-scatter, written into
// its slot of red[pb] here and in every peer (st.async; of a pair of lanes
// holding the same three sums, the even lane sends to the even ranks, the
// odd lane to the odd ones), then warp 0 waits for the peers' bytes and
// adds the 16 warps' partials in warp order. Every thread takes part; the
// caller keeps red[pb] from being written again before warp 0 has read it
// (a __syncthreads after), and alternates pb. The __syncwarp first orders
// every lane's earlier shared-memory stores (the trial pass's iR, which the
// peers read through distributed shared memory once they hold these
// partials) before the pushes of either lane of a pair, whose completion
// on the peer's mbarrier is the release those reads acquire.
__device__ __forceinline__ void cluster_sum(float a[kNS], Shared& s, float* out, int pb,
                                            unsigned rank, unsigned& mphase, Stamps& sp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncwarp();
  const int base = dsm::warp_reduce_scatter(a, lane);
  sp.after(PH_WARP, a[0]);
  float* const slot = s.red[pb][rank * kCtaWarps + warp] + base;
  if ((lane & 1) == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) slot[j] = a[j];
  }
  const unsigned bar = dsm::smem_addr(&s.mbar[pb]);
  const unsigned dst = dsm::smem_addr(slot);
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    if ((r & 1) != (lane & 1) || r == static_cast<int>(rank)) continue;
    const unsigned rb = dsm::map_rank(bar, r), rd = dsm::map_rank(dst, r);
#pragma unroll
    for (int j = 0; j < 3; ++j) dsm::st_async(rd + 4 * j, a[j], rb);
  }
  sp(PH_XCTA);
  __syncthreads();
  sp(PH_XWARP);
  if (warp == 0) {
    dsm::mbar_wait(bar, (mphase >> pb) & 1u);
    mphase ^= 1u << pb;
    sp(PH_XCTA);
    const int hi = 32 + (lane & 15);
    float v0 = s.red[pb][0][lane], v1 = s.red[pb][0][hi];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      v0 += s.red[pb][w][lane];
      v1 += s.red[pb][w][hi];
    }
    out[lane] = v0;
    if (lane < 16) out[hi] = v1;
    __syncwarp();
    if (lane == 0) dsm::mbar_expect(bar, (kCluster - 1) * kCtaWarps * kNS * 4);   // next use
  }
  sp(PH_XWARP);
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
__device__ __forceinline__ void solve8(float A[8][9], float x[8], Stamps& sp) {
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
  sp.after(PH_LU, A[7][8]);
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    x[k] = A[k][8] / A[k][k];
#pragma unroll
    for (int i = 0; i < k; ++i) A[i][8] -= A[i][k] * x[k];
  }
  sp.after(PH_SOLVE, x[0]);
}

// The damped Schur step by warp 0 of a CTA, every lane alike: dx = -Hf^-1
// (b - b_sc), then the trial state exp(dx[:6]) T, ab + dx[6:] from the
// accepted one; lane 0 writes both. Every lane solves the whole system in
// its own registers (static indices): no column waits on a shuffle.
__device__ __forceinline__ void gn_step(Shared& s, int c, float lam, int lane, Stamps& sp) {
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
  sp.after(PH_ROWS, A[7][8]);
  float x[8];
  solve8(A, x, sp);
  float dx[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) dx[j] = -x[j];
  const float* T = s.st[c];
  float Tn[12];
  lie::exp_times34(dx, T, lie::rules(1), Tn);
  if (lane == 0) {
    float* trial = s.st[1 - c];
#pragma unroll
    for (int j = 0; j < 12; ++j) trial[j] = Tn[j];
#pragma unroll
    for (int j = 12; j < 16; ++j) trial[j] = T[j];
    trial[16] = T[16] + dx[6];
    trial[17] = T[17] + dx[7];
#pragma unroll
    for (int j = 0; j < 8; ++j) s.dx[j] = dx[j];
  }
  sp.after(PH_EXP, Tn[11]);
}

// (x_m0 + x_m1) / 2 of the sorted iR of the K neighbours of two points (nb0,
// nb1), m0 = (K - 1) / 2, m1 = K / 2, by one thread: the 2 K loads issued
// together, then an odd-even transposition sort of each point's K values (K
// rounds sort K values) in registers. iR_c is the accepted buffer's iR of
// this CTA; a neighbour that another CTA owns is read from that CTA's
// shared memory (point j's owner is rank (j mod 512) >> kTS, its slot (j /
// 512) << kTS | (j mod 512) & (kCta - 1)).
template <int K>
__device__ __forceinline__ void median_k(const float* iR_c, const int* nb0, const int* nb1,
                                         unsigned rank, float& m0, float& m1) {
  float v[2][K];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int n = 0; n < K; ++n) {
      const int j = __ldg((h ? nb1 : nb0) + n);
      const int gj = j & (kThreads - 1);
      const unsigned r = static_cast<unsigned>(gj >> kTS);
      const float* src = iR_c + (((j / kThreads) << kTS) | (gj & (kCta - 1)));
      v[h][n] = r == rank ? *src : *dsm::map_generic(src, r);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int round = 0; round < K; ++round) {
#pragma unroll
      for (int n = round & 1; n + 1 < K; n += 2) {
        const float lo = fminf(v[h][n], v[h][n + 1]), hi = fmaxf(v[h][n], v[h][n + 1]);
        v[h][n] = lo;
        v[h][n + 1] = hi;
      }
    }
  }
  m0 = (v[0][(K - 1) / 2] + v[0][K / 2]) * 0.5f;
  m1 = (v[1][(K - 1) / 2] + v[1][K / 2]) * 0.5f;
}

__device__ __forceinline__ void median_pair(const float* iR_c, const int* nb0, const int* nb1,
                                            int K, unsigned rank, float& m0, float& m1) {
  switch (K) {
#define INIT_LEVEL_MEDIAN(n) \
    case n: median_k<n>(iR_c, nb0, nb1, rank, m0, m1); return;
    INIT_LEVEL_MEDIAN(1) INIT_LEVEL_MEDIAN(2) INIT_LEVEL_MEDIAN(3) INIT_LEVEL_MEDIAN(4)
    INIT_LEVEL_MEDIAN(5) INIT_LEVEL_MEDIAN(6) INIT_LEVEL_MEDIAN(7) INIT_LEVEL_MEDIAN(8)
    INIT_LEVEL_MEDIAN(9) INIT_LEVEL_MEDIAN(10) INIT_LEVEL_MEDIAN(11) INIT_LEVEL_MEDIAN(12)
    INIT_LEVEL_MEDIAN(13) INIT_LEVEL_MEDIAN(14) INIT_LEVEL_MEDIAN(15)
#undef INIT_LEVEL_MEDIAN
    default: median_k<kMaxK>(iR_c, nb0, nb1, rank, m0, m1);
  }
}

// One launch: a cluster of kCluster CTAs of kCta threads.
__global__ void __launch_bounds__(kCta) init_level_kernel(const __grid_constant__ Params P) {
  __shared__ Shared s;
  extern __shared__ float4 dyn4[];
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  const int N = P.N, cap = P.cap, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g0 = static_cast<int>(rank) * kCta + tid;   // the thread's first point
  // [buffer][slot] arrays; Hxd [buffer][8][slot]; the rays [8][slot]
  float* const dyn = reinterpret_cast<float*>(dyn4);
  float* const sd = dyn;
  float* const siR = dyn + 2 * cap;
  float* const shdd = dyn + 4 * cap;
  float* const sbd = dyn + 6 * cap;
  float* const shxd = dyn + 8 * cap;
  float2* const sray = reinterpret_cast<float2*>(dyn + 2 * kStateFloats * cap);
  float* const smed = dyn + (2 * kStateFloats + 16) * cap;   // an iteration's medians
  unsigned char* const sfl = reinterpret_cast<unsigned char*>(dyn + (2 * kStateFloats + 17) * cap);
  Stamps sp;
  sp.begin(rank == 0 && tid == 0);

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
  if (tid == 0) {                    // arm both buffers' barriers before any peer sends
    const unsigned b0 = dsm::smem_addr(&s.mbar[0]), b1 = dsm::smem_addr(&s.mbar[1]);
    dsm::mbar_init(b0);
    dsm::mbar_init(b1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    dsm::mbar_expect(b0, (kCluster - 1) * kCtaWarps * kNS * 4);
    dsm::mbar_expect(b1, (kCluster - 1) * kCtaWarps * kNS * 4);
  }
  cl.sync();

  float acc[kNS];
  float hxd[8], hdd, bd;
  bool pt_ok;
  int64_t n_ok = 0;                  // warp 0's
  unsigned mphase = 0;               // warp 0's: the phase parity of each buffer's barrier
  int pb = 0;                        // the partial buffer of the next reduction
  // the rays, then the start state's system, into buffer 0
#pragma unroll
  for (int i = 0; i < kNS; ++i) acc[i] = 0.f;
  for (int m = 0, p = g0; p < N; ++m, p += kThreads) {
    const int q = (m << kTS) | tid;
    const float ul = __ldg(P.uv + 2 * p) * g.s + g.off;
    const float vl = __ldg(P.uv + 2 * p + 1) * g.s + g.off;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      sray[k * cap + q] = make_float2(((ul + kPattern[k][0]) - g.cx) / g.fx,
                                      ((vl + kPattern[k][1]) - g.cy) / g.fy);
    const float d = __ldg(P.d0 + p), iR = __ldg(P.iR0 + p);
    const bool good = P.good0[p] != 0;
    eval_point(P, g, s.st[0], sray + q, cap, p, d, iR, good, hxd, hdd, bd, pt_ok, acc, sp);
    sd[q] = d;
    siR[q] = iR;
    shdd[q] = hdd;
    sbd[q] = bd;
#pragma unroll
    for (int a = 0; a < 8; ++a) shxd[a * cap + q] = hxd[a];
    sfl[q] = (good ? kGoodBit : 0) | (pt_ok ? kOkBit : 0);
  }
  cluster_sum(acc, s, s.sys[0], pb, rank, mphase, sp);
  pb ^= 1;
  if (warp == 0 && lane == 0) {
    pose_prior(P, s.st[0], s.sys[0]);
    n_ok = static_cast<int64_t>(s.sys[0][kOk]);
  }
  __syncthreads();
  sp.start();

  int c = 0;                         // the accepted buffer
  float lam = 0.1f;
  for (int it = 0; it < P.iters; ++it) {
    const int t = 1 - c;
    const float damp = 1.f + lam;
    // the Schur sums over the points
#pragma unroll
    for (int i = 0; i < kNS; ++i) acc[i] = 0.f;
    for (int m = 0, p = g0; p < N; ++m, p += kThreads) {
      const int q = (m << kTS) | tid;
      const float inv_dd = 1.f / (shdd[c * cap + q] * damp + 1e-10f);
      const float ib = inv_dd * sbd[c * cap + q];
#pragma unroll
      for (int a = 0; a < 8; ++a) hxd[a] = shxd[(c * 8 + a) * cap + q];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float w = hxd[a] * inv_dd;
#pragma unroll
        for (int b2 = a; b2 < 8; ++b2) acc[tri(a, b2)] += w * hxd[b2];
        acc[kB + a] += hxd[a] * ib;
      }
    }
    sp.after(PH_SCHUR, acc[0]);
    cluster_sum(acc, s, s.sc, pb, rank, mphase, sp);
    pb ^= 1;
    if (warp == 0) {
      gn_step(s, c, lam, lane, sp);
    } else {
      // while warp 0 steps, the other warps take the medians of the
      // accepted iR (the trial pass's iR' = reg_keep d' + reg_weight
      // median), two slots a thread at a time
      for (int q = tid - 32; q < cap; q += 2 * (kCta - 32)) {
        const int q1 = q + (kCta - 32);
        const int p = ((q >> kTS) * kThreads) | (static_cast<int>(rank) * kCta + (q & (kCta - 1)));
        const int p1 = ((q1 >> kTS) * kThreads) | (static_cast<int>(rank) * kCta + (q1 & (kCta - 1)));
        const bool has1 = q1 < cap && p1 < N;
        if (p >= N) continue;
        float m0, m1;
        median_pair(siR + c * cap, P.nbr + p * P.K, P.nbr + (has1 ? p1 : p) * P.K, P.K, rank,
                    m0, m1);
        smed[q] = m0;
        if (has1) smed[q1] = m1;
      }
    }
    __syncthreads();
    sp(PH_BARRIER);

    // the trial state, point by point, and its system into buffer t
    float dx[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) dx[a] = s.dx[a];
#pragma unroll
    for (int i = 0; i < kNS; ++i) acc[i] = 0.f;
    for (int m = 0, p = g0; p < N; ++m, p += kThreads) {
      const int q = (m << kTS) | tid;
      const float inv_dd = 1.f / (shdd[c * cap + q] * damp + 1e-10f);
      float hx = 0.f;
#pragma unroll
      for (int a = 0; a < 8; ++a) hx += shxd[(c * 8 + a) * cap + q] * dx[a];
      const float dd = -(sbd[c * cap + q] + hx) * inv_dd;
      const float x = sd[c * cap + q] + dd;
      const float d = x != x ? x : fminf(fmaxf(x, 1e-3f), 50.f);   // torch.clamp keeps NaN
      const float iR = P.reg_keep * d + P.reg_weight * smed[q];
      const unsigned char fl = sfl[c * cap + q];
      const bool good = (fl & kGoodBit) && (fl & kOkBit);
      sp.after(PH_MEDIAN, iR);
      eval_point(P, g, s.st[t], sray + q, cap, p, d, iR, good, hxd, hdd, bd, pt_ok, acc, sp);
      sd[t * cap + q] = d;
      siR[t * cap + q] = iR;
      shdd[t * cap + q] = hdd;
      sbd[t * cap + q] = bd;
#pragma unroll
      for (int a = 0; a < 8; ++a) shxd[(t * 8 + a) * cap + q] = hxd[a];
      sfl[t * cap + q] = (good ? kGoodBit : 0) | (pt_ok ? kOkBit : 0);
    }
    sp(PH_ACCUM);
    cluster_sum(acc, s, s.sys[t], pb, rank, mphase, sp);
    pb ^= 1;
    if (warp == 0 && lane == 0) {
      pose_prior(P, s.st[t], s.sys[t]);
      n_ok += static_cast<int64_t>(s.sys[t][kOk]);
      const float e_cur = s.sys[c][kE], e_new = s.sys[t][kE];
      s.accept = e_new < e_cur;
      if (rank == 0 && P.ladder_out != nullptr) {
        P.ladder_out[2 * it] = e_cur;
        P.ladder_out[2 * it + 1] = e_new;
      }
    }
    __syncthreads();
    const bool accept = s.accept != 0;
    c = accept ? t : c;
    lam = accept ? fmaxf(lam * 0.5f, 1e-5f) : lam * 4.f;
    sp(PH_ACCEPT);
  }

  // the outputs of the carried state: each CTA its points, rank 0 the rest
  for (int m = 0, p = g0; p < N; ++m, p += kThreads) {
    const int q = (m << kTS) | tid;
    const unsigned char fl = sfl[c * cap + q];
    P.d_out[p] = sd[c * cap + q];
    P.iR_out[p] = siR[c * cap + q];
    P.good_out[p] = (fl & kGoodBit) && (fl & kOkBit) ? 1 : 0;
  }
  if (rank == 0 && tid == 0) {
    const float* Tc = s.st[c];
#pragma unroll
    for (int i = 0; i < 16; ++i) P.T_out[i] = Tc[i];
    P.ab_out[0] = Tc[16];
    P.ab_out[1] = Tc[17];
    P.scalars_out[0] = s.sys[c][kE];
    P.scalars_out[1] = Tc[3] * Tc[3] + Tc[7] * Tc[7] + Tc[11] * Tc[11];
    P.counts_out[0] = static_cast<int64_t>(s.sys[c][kKept]);
    P.counts_out[1] = n_ok;
  }
  sp.write(P.phases_out, P.iters);
  // no CTA leaves while a peer may still read or write its shared memory
  cl.sync();
}

int launch(const Params& p, size_t smem, cudaStream_t stream) {
  // above 48 KB of shared memory (static and dynamic) the kernel must ask
  // for it; the attribute is the device's, so it is set on every launch
  // that needs it
  if (smem + sizeof(Shared) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        init_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kCta, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, init_level_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch: a cluster of kCluster (8) CTAs of kCta (64) threads,
// kSlotBytes (166 B) of dynamic shared memory a slot, ceil(N / 512) x kCta
// slots a CTA. 1 <= N <= kMaxN, 1 <= K <= kMaxK.
extern "C" int ldso_init_level(
    const void* img3, int H, int W, const void* uv, const void* colors, const void* nbr, int N,
    int K, const void* T0, const void* ab0, const void* d0, const void* iR0, const void* good0,
    const void* intr0, int level, int iters, int snapped, float alpha_w, float coupling,
    float reg_keep, float reg_weight, float huber, void* T_out, void* ab_out, void* d_out,
    void* iR_out, void* good_out, void* scalars_out, void* counts_out, void* ladder_out,
    void* phases_out, void* stream) {
  if (N < 1 || N > kMaxN || K < 1 || K > kMaxK || H < 1 || W < 1 || level < 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.cap = (N + kThreads - 1) / kThreads * kCta;
  const size_t smem = static_cast<size_t>(kSlotBytes) * p.cap;
  if (smem + sizeof(Shared) > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.phases_out = static_cast<long long*>(phases_out);
  return launch(p, smem, static_cast<cudaStream_t>(stream));
}
