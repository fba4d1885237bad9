// Image pyramid level: (I, dx, dy) stack, squared gradient, next level.
//
// Replaces the TPU kernel ldso_tpu/kernels/pallas_pyramid.py::_level_kernel
// (launched by _level, driven level by level by build_pyramid_pallas).
// Contract: kernels/pyramid.build_pyramid_xla of the JAX package —
//   dx = 0.5 (right - left), dy = 0.5 (down - up), borders clamped;
//   gsq = dx^2 + dy^2;  next = mean of each 2x2 block.
//
// What bounds it on Hopper: bytes, not arithmetic. Per pixel it reads 1 B
// (uint8 level 0) or 4 B (float levels) and writes 16 B (interleaved stack
// + gsq) plus 1/4 of 4 B for the next level, about 6.6 MB per 640x480
// frame over 5 levels: ~2 us of HBM time at 3.35 TB/s. At these sizes the
// five launches (one per level) cost more than the bytes; fusing the
// levels into one launch is later work.
//
// Design, not carried over from the TPU block by block:
//   * one thread per pixel reads its clamped 4-neighbourhood (served from
//     L1/L2: neighbouring threads share the rows) and writes the
//     INTERLEAVED (I, dx, dy) stack directly; the TPU kernel wrote three
//     separate planes only to keep its (8, 128) tiling;
//   * the 2x2 mean reads the block directly (no pooling matmuls) and is
//     written into channel 0 of the next level's stack, which the next
//     launch then reads in place: no separate next-level buffer;
//   * level 0 takes the uint8 frame and widens it in the kernel;
//   * the last level computes no next level.
//
// Plain C interface (bound with ctypes): each entry point launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_px(const uint8_t* p, long i) {
  return static_cast<float>(p[i]);
}
__device__ __forceinline__ float load_px(const float* p, long i) {
  return p[i];
}

// in:       level image, pixel (y, x) at in[(y * W + x) * in_stride]
// out3:     [H, W, 3] (I, dx, dy); channel 0 written only if write_I
// gsq:      [H, W]
// next3:    [H/2, W/2, 3] stack of the next level (channel 0 written) or null
template <typename T>
__global__ void pyramid_level_kernel(const T* __restrict__ in, int in_stride,
                                     int H, int W, float* out3,
                                     float* __restrict__ gsq,
                                     float* __restrict__ next3, int write_I) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;

  const int xl = x > 0 ? x - 1 : 0;
  const int xr = x < W - 1 ? x + 1 : W - 1;
  const int yu = y > 0 ? y - 1 : 0;
  const int yd = y < H - 1 ? y + 1 : H - 1;
  const long row = static_cast<long>(y) * W;
  const float c = load_px(in, (row + x) * in_stride);
  const float l = load_px(in, (row + xl) * in_stride);
  const float r = load_px(in, (row + xr) * in_stride);
  const float u = load_px(in, (static_cast<long>(yu) * W + x) * in_stride);
  const float d = load_px(in, (static_cast<long>(yd) * W + x) * in_stride);
  const float dx = 0.5f * (r - l);
  const float dy = 0.5f * (d - u);

  float* o = out3 + (row + x) * 3;
  if (write_I) o[0] = c;
  o[1] = dx;
  o[2] = dy;
  // separately rounded products (no FMA contraction), as the plain version
  gsq[row + x] = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));

  const int W2 = W >> 1, H2 = H >> 1;
  if (next3 != nullptr && x < W2 && y < H2) {
    const long r0 = static_cast<long>(2 * y) * W + 2 * x;
    const long r1 = r0 + W;
    const float s = (load_px(in, r0 * in_stride) + load_px(in, (r0 + 1) * in_stride)) +
                    (load_px(in, r1 * in_stride) + load_px(in, (r1 + 1) * in_stride));
    next3[(static_cast<long>(y) * W2 + x) * 3] = 0.25f * s;
  }
}

template <typename T>
int launch(const T* in, int in_stride, int H, int W, float* out3, float* gsq,
           float* next3, int write_I, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  pyramid_level_kernel<T><<<grid, block, 0, stream>>>(in, in_stride, H, W, out3,
                                                      gsq, next3, write_I);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ldso_pyramid_level_u8(const void* in, int H, int W, void* out3,
                                     void* gsq, void* next3, void* stream) {
  return launch(static_cast<const uint8_t*>(in), 1, H, W,
                static_cast<float*>(out3), static_cast<float*>(gsq),
                static_cast<float*>(next3), 1,
                static_cast<cudaStream_t>(stream));
}

extern "C" int ldso_pyramid_level_f32(const void* in, int in_stride, int H,
                                      int W, void* out3, void* gsq, void* next3,
                                      int write_I, void* stream) {
  return launch(static_cast<const float*>(in), in_stride, H, W,
                static_cast<float*>(out3), static_cast<float*>(gsq),
                static_cast<float*>(next3), write_I,
                static_cast<cudaStream_t>(stream));
}
