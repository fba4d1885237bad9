// What the kernels that spread one reduction over a thread-block cluster
// share (track_level.cu, K2; init_level.cu, K6): the distributed
// shared-memory exchange (a peer CTA's address of a shared variable, for
// st_async or for an ordinary load; a 4-byte store into it counted on the
// peer's mbarrier; the mbarrier's init, arrival and wait) and the warp's
// 48-value reduce-scatter.
//
// The exchange as both kernels use it: every CTA pushes its partial sums
// into each peer's shared memory with st_async, each store completing 4
// bytes of the peer's mbarrier transaction count; a CTA waits on its own
// mbarrier until the peers' bytes are there (mbar_wait, acquire at cluster
// scope), reads them, and arms the barrier again for the buffer's next use
// (mbar_expect). The buffers are double-buffered, and a CTA sends into a
// buffer only after it has received the peers' previous exchange, so a peer
// is never two exchanges ahead.

#pragma once

#include <cuda_runtime.h>

namespace dsm {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSums = 48;            // the values of a reduce-scatter

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory location in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// The generic address of the same shared-memory location in CTA `rank`:
// an ordinary load through it reads the peer's shared memory.
template <typename T>
__device__ __forceinline__ T* map_generic(T* p, unsigned rank) {
  unsigned long long out;
  asm("mapa.u64 %0, %1, %2;" : "=l"(out) : "l"(reinterpret_cast<unsigned long long>(p)),
      "r"(rank));
  return reinterpret_cast<T*>(out);
}

// A 4-byte store into a peer's shared memory that completes 4 bytes of the
// transaction count of the peer's mbarrier at `bar`.
__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
}

// This CTA's own arrival on its mbarrier, expecting `bytes` from the peers.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// One halving step of the warp's reduce-scatter: of the first 2 * HALF
// values, a thread whose lane has bit OFF set keeps the upper half, the
// other the lower, each summed with its partner's copy.
template <int HALF, int OFF>
__device__ __forceinline__ void scatter_step(float a[kSums], int lane) {
  const bool up = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? a[i] : a[i + HALF];
    const float keep = up ? a[i + HALF] : a[i];
    a[i] = keep + __shfl_xor_sync(kFull, send, OFF);
  }
}

// The warp's sums of 48 values: afterwards a[0..2] of lane l are the sums
// of values base(l) + 0..2, base(l) = 24 b4 + 12 b3 + 6 b2 + 3 b1 from the
// lane's bits (lanes l and l ^ 1 hold the same sums). 48 shuffles a
// thread, not 5 a value.
__device__ __forceinline__ int warp_reduce_scatter(float a[kSums], int lane) {
  scatter_step<24, 16>(a, lane);
  scatter_step<12, 8>(a, lane);
  scatter_step<6, 4>(a, lane);
  scatter_step<3, 2>(a, lane);
#pragma unroll
  for (int i = 0; i < 3; ++i) a[i] += __shfl_xor_sync(kFull, a[i], 1);
  return 24 * ((lane >> 4) & 1) + 12 * ((lane >> 3) & 1) + 6 * ((lane >> 2) & 1)
         + 3 * ((lane >> 1) & 1);
}

}  // namespace dsm
