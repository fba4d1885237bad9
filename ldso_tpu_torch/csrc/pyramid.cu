// Image pyramid: all L levels of all B frames in ONE launch.
//
// Replaces the TPU kernel ldso_tpu/kernels/pallas_pyramid.py::_level_kernel
// (launched by _level once per level, driven by build_pyramid_pallas).
// Contract: kernels/pyramid.build_pyramid_xla of the JAX package, per frame —
//   dx = 0.5 (right - left), dy = 0.5 (down - up), borders clamped;
//   gsq = dx^2 + dy^2;  next level = mean of each 2x2 block.
//
// What bounds it on Hopper: bytes, not arithmetic. A 640x480 uint8 frame
// over 5 levels reads 307,200 B and writes 16 B per pixel of every level
// (12 B interleaved (I, dx, dy) + 4 B gsq): 6,854,400 B, 2.05 us of HBM
// time at 3.35 TB/s, against ~10 flops per pixel. A launch costs about as
// much as that, so the design is about launches and store width:
//   * one launch for the whole batch: blockIdx.z is the frame, a block owns
//     a 64x32 tile of level 0 and everything above it (32x16 ... 4x2 at
//     level 4), so each level-0 pixel is read from HBM for one tile only
//     and no level is ever read back from HBM;
//   * halo by recomputation: the central differences of level l need one
//     level-l pixel around the tile, 2^l level-0 pixels. The block loads a
//     halo of 2^(L-1) (at least 4) level-0 pixels per side and pools the
//     neighbours' values itself; at 5 levels that is 3x the reads, of
//     1 B/pixel for uint8 against 16 B/pixel of writes, and the overlap is
//     served by L2. No grid-wide sync, no persistent grid;
//   * clamping is at the image border (a pixel's neighbour index is clamped
//     before it is looked up in the tile), never at the tile border;
//     halo pixels outside the image are zero and never read;
//   * wide accesses: the frame is read as uchar4 / float4 groups; results
//     are staged in shared memory in their final interleaved layout and
//     each row segment leaves as float4 (a 4-pixel group is three float4 of
//     the stack and one of gsq). Rows whose global offset is not 16-byte
//     aligned (levels whose width is not a multiple of 4, e.g. 13 at level
//     4 of a 208-wide frame) and ragged row ends fall back to scalar
//     stores, inside the kernel;
//   * partial tiles (480 = 15 x 32, but 240 = 7.5 x 32) are masked.
// Arithmetic order is the five-launch kernel's, so results are bitwise
// equal to it: the mean is 0.25f * ((a + b) + (c + d)) of the previous
// level's rounded values, and gsq is built from separately rounded
// products (no FMA contraction), as torch's multiply and add.
//
// Plain C interface (bound with ctypes): each entry point launches on the
// given stream, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 6;
constexpr int kTileW = 64;      // level-0 pixels of a tile, x
constexpr int kTileH = 32;      // and y; both multiples of 2^(kMaxLevels-1)
constexpr int kThreads = 256;

struct PyramidParams {
  float* out3[kMaxLevels];      // [B, H_l, W_l, 3]
  float* gsq[kMaxLevels];       // [B, H_l, W_l]
  int B, H, W, L;
};

__host__ __device__ constexpr int halo_of(int L) {
  return (1 << (L - 1)) < 4 ? 4 : (1 << (L - 1));
}
__host__ __device__ constexpr int round_up4(int n) { return (n + 3) & ~3; }

// pooled region of level l: width, height, and its offset in shared memory
__host__ __device__ constexpr int region_w(int L, int l) {
  return (kTileW + 2 * halo_of(L)) >> l;
}
__host__ __device__ constexpr int region_h(int L, int l) {
  return (kTileH + 2 * halo_of(L)) >> l;
}
__host__ __device__ constexpr int region_off(int L, int l) {
  int n = 0;
  for (int k = 0; k < l; ++k) n += region_w(L, k) * region_h(L, k);
  return n;
}
// floats of shared memory: the L pooled regions, then the two stages
__host__ __device__ constexpr int region_floats(int L) {
  return round_up4(region_off(L, L));
}
// the stages hold half of a tile's level 0 at a time (or all of the levels
// above it, a third of that): with the whole of level 0 staged, a block
// needs 64 KB and three fit an SM; with half, 48 KB and four
constexpr int kLevel0Parts = 2;
constexpr int kStage3Floats = kTileH / kLevel0Parts * kTileW * 3;
constexpr int kStageGFloats = kTileH / kLevel0Parts * kTileW;

__device__ __forceinline__ void load4(const uint8_t* p, float* dst) {
  const uchar4 v = *reinterpret_cast<const uchar4*>(p);
  dst[0] = static_cast<float>(v.x);
  dst[1] = static_cast<float>(v.y);
  dst[2] = static_cast<float>(v.z);
  dst[3] = static_cast<float>(v.w);
}
__device__ __forceinline__ void load4(const float* p, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// Levels [LA, LB) of this block's tile, of each the rows of part `part` out
// of PARTS equal parts: compute (I, dx, dy, gsq) of every such tile pixel
// inside the image into the stages, then copy the stages' row segments to
// global memory. Ends with a __syncthreads(), so the stages can be reused.
// L, LA, LB and PARTS are compile-time, so after unrolling every size below
// is a constant and the index divisions are multiplications.
template <int L, int LA, int LB, int PARTS>
__device__ __forceinline__ void emit_levels(const PyramidParams& p, const float* s,
                                            float* stage3, float* stageg, int part) {
  const int tid = threadIdx.x;
  const int b = blockIdx.z;

  // ---- compute into the stages (one thread per pixel, levels flattened)
  int o3 = 0, og = 0;           // stage offsets of the current level
#pragma unroll
  for (int l = LA; l < LB; ++l) {
    const int cw = kTileW >> l, ch = (kTileH >> l) / PARTS;   // this part's core
    const int Wl = p.W >> l, Hl = p.H >> l;
    const int hl = halo_of(L) >> l;                      // >= 1
    const int rw = region_w(L, l);
    const int r0 = part * ch;                            // first row, in the tile
    const int x0 = blockIdx.x * cw, y0 = blockIdx.y * (kTileH >> l) + r0;
    const int st3 = round_up4(3 * cw), stg = round_up4(cw);
    const float* sl = s + region_off(L, l);
    for (int i = tid; i < cw * ch; i += kThreads) {
      const int r = i / cw, x = i - r * cw;
      const int xg = x0 + x, yg = y0 + r;
      if (xg >= Wl || yg >= Hl) continue;
      const int rx = x + hl, ry = r0 + r + hl;
      const int xl = xg > 0 ? rx - 1 : rx;
      const int xr = xg < Wl - 1 ? rx + 1 : rx;
      const int yu = yg > 0 ? ry - 1 : ry;
      const int yd = yg < Hl - 1 ? ry + 1 : ry;
      const float c = sl[ry * rw + rx];
      const float dx = 0.5f * (sl[ry * rw + xr] - sl[ry * rw + xl]);
      const float dy = 0.5f * (sl[yd * rw + rx] - sl[yu * rw + rx]);
      float* q = stage3 + o3 + r * st3 + 3 * x;
      q[0] = c;
      q[1] = dx;
      q[2] = dy;
      // separately rounded products (no FMA contraction), as the plain version
      stageg[og + r * stg + x] = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    }
    o3 += ch * st3;
    og += ch * stg;
  }
  __syncthreads();

  // ---- copy the stages out, a float4 per thread where the row allows it
  o3 = 0;
  og = 0;
#pragma unroll
  for (int l = LA; l < LB; ++l) {
    const int cw = kTileW >> l, ch = (kTileH >> l) / PARTS;
    const int Wl = p.W >> l, Hl = p.H >> l;
    const int x0 = blockIdx.x * cw, y0 = blockIdx.y * (kTileH >> l) + part * ch;
    const int st3 = round_up4(3 * cw), stg = round_up4(cw);
    const int vw = min(cw, Wl - x0), vh = min(ch, Hl - y0);   // valid; vh may be <= 0
    // channels = 3: the interleaved stack; channels = 1: gsq
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int chn = pass == 0 ? 3 : 1;
      const int st = pass == 0 ? st3 : stg;
      const float* src = pass == 0 ? stage3 + o3 : stageg + og;
      float* dst = pass == 0 ? p.out3[l] : p.gsq[l];
      const int quads = st >> 2;                  // per row, st % 4 == 0
      const int n = chn * vw;                     // valid floats per row
      for (int i = tid; i < vh * quads; i += kThreads) {
        const int r = i / quads, k = (i - r * quads) << 2;
        if (k >= n) continue;
        const long g = ((static_cast<long>(b) * Hl + (y0 + r)) * Wl + x0) * chn;
        const float* sp = src + r * st + k;
        float* dp = dst + g + k;
        if ((reinterpret_cast<uintptr_t>(dp) & 15) == 0 && k + 4 <= n) {
          *reinterpret_cast<float4*>(dp) = *reinterpret_cast<const float4*>(sp);
        } else {
          const int m = min(4, n - k);
          for (int j = 0; j < m; ++j) dp[j] = sp[j];
        }
      }
    }
    o3 += ch * st3;
    og += ch * stg;
  }
  __syncthreads();
}

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
pyramid_kernel(const T* __restrict__ in, const PyramidParams p) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  constexpr int halo = halo_of(L);
  const int H = p.H, W = p.W;
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  float* stage3 = s + region_floats(L);
  float* stageg = stage3 + kStage3Floats;

  // ---- level 0: the tile and its halo, in groups of 4 pixels
  {
    constexpr int rw = region_w(L, 0), rh = region_h(L, 0);
    constexpr int groups = rw >> 2;                 // rw % 4 == 0
    const int gx0 = blockIdx.x * kTileW - halo, gy0 = blockIdx.y * kTileH - halo;
    for (int i = tid; i < groups * rh; i += kThreads) {
      const int ry = i / groups, rx = (i - ry * groups) << 2;
      const int gy = gy0 + ry, gx = gx0 + rx;
      float* d = s + ry * rw + rx;
      if (gy < 0 || gy >= H || gx + 3 < 0 || gx >= W) {
        d[0] = d[1] = d[2] = d[3] = 0.0f;
        continue;
      }
      const long row = (static_cast<long>(b) * H + gy) * W;
      if (gx >= 0 && gx + 3 < W &&
          (reinterpret_cast<uintptr_t>(in + row + gx) & (4 * sizeof(T) - 1)) == 0) {
        load4(in + row + gx, d);
      } else {
        for (int j = 0; j < 4; ++j) {
          const int x = gx + j;
          d[j] = (x >= 0 && x < W) ? static_cast<float>(in[row + x]) : 0.0f;
        }
      }
    }
  }
  __syncthreads();

  // ---- levels 1..L-1: 2x2 means of the whole region, in shared memory
#pragma unroll
  for (int l = 1; l < L; ++l) {
    const int rw = region_w(L, l), rh = region_h(L, l);
    const int pw = rw << 1;
    const float* sp = s + region_off(L, l - 1);
    float* sl = s + region_off(L, l);
    for (int i = tid; i < rw * rh; i += kThreads) {
      const int y = i / rw, x = i - y * rw;
      const float* q = sp + (2 * y) * pw + 2 * x;
      sl[i] = 0.25f * ((q[0] + q[1]) + (q[pw] + q[pw + 1]));
    }
    __syncthreads();
  }

  // ---- outputs: level 0 in parts that fill the stages, the rest together
  for (int part = 0; part < kLevel0Parts; ++part)
    emit_levels<L, 0, 1, kLevel0Parts>(p, s, stage3, stageg, part);
  if constexpr (L > 1) emit_levels<L, 1, L, 1>(p, s, stage3, stageg, 0);
}

template <typename T, int L>
cudaError_t launch_levels(const T* in, const PyramidParams& p, cudaStream_t stream) {
  constexpr int bytes = static_cast<int>(
      sizeof(float) * (region_floats(L) + kStage3Floats + kStageGFloats));
  const cudaError_t err = cudaFuncSetAttribute(
      pyramid_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.W + kTileW - 1) / kTileW, (p.H + kTileH - 1) / kTileH, p.B);
  pyramid_kernel<T, L><<<grid, kThreads, bytes, stream>>>(in, p);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* in, int B, int H, int W, int L, void* const* out3,
           void* const* gsq, cudaStream_t stream) {
  if (L < 1 || L > kMaxLevels || B < 1 || B > 65535) return cudaErrorInvalidValue;
  const int m = 1 << (L - 1);
  if (H < m || W < m || H % m || W % m) return cudaErrorInvalidValue;
  PyramidParams p;
  for (int l = 0; l < kMaxLevels; ++l) {
    p.out3[l] = l < L ? static_cast<float*>(out3[l]) : nullptr;
    p.gsq[l] = l < L ? static_cast<float*>(gsq[l]) : nullptr;
  }
  p.B = B;
  p.H = H;
  p.W = W;
  p.L = L;
  cudaError_t err = cudaErrorInvalidValue;
  switch (L) {      // one instance per level count: every tile size a constant
    case 1: err = launch_levels<T, 1>(in, p, stream); break;
    case 2: err = launch_levels<T, 2>(in, p, stream); break;
    case 3: err = launch_levels<T, 3>(in, p, stream); break;
    case 4: err = launch_levels<T, 4>(in, p, stream); break;
    case 5: err = launch_levels<T, 5>(in, p, stream); break;
    case 6: err = launch_levels<T, 6>(in, p, stream); break;
  }
  return static_cast<int>(err);
}

}  // namespace

// in: [B, H, W] contiguous; out3 / gsq: L device pointers each, level l
// holding [B, H >> l, W >> l, 3] and [B, H >> l, W >> l] float32.
extern "C" int ldso_pyramid_u8(const void* in, int B, int H, int W, int L,
                               void* const* out3, void* const* gsq,
                               void* stream) {
  return launch(static_cast<const uint8_t*>(in), B, H, W, L, out3, gsq,
                static_cast<cudaStream_t>(stream));
}

extern "C" int ldso_pyramid_f32(const void* in, int B, int H, int W, int L,
                                void* const* out3, void* const* gsq,
                                void* stream) {
  return launch(static_cast<const float*>(in), B, H, W, L, out3, gsq,
                static_cast<cudaStream_t>(stream));
}
