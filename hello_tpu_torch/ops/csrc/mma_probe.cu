// Probes of the product instructions of the read-conv kernel (read_conv.cu,
// read_conv_wgmma.cuh and read_conv_wgmma_tf32.cuh), for chip_smoke.py:
//   * throughput of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 and
//     mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (the yardsticks
//     beside which the routes' wgmma rates stand), run back to back from
//     registers by every warp with 12 independent accumulator tiles per
//     warp, at one 256-thread block per SM;
//   * one wgmma m64nNk16 bf16 tile (N = 16, 32, 64) with the bf16 route's
//     own descriptors: A read from an activation buffer in the kernel's
//     layout at a given byte offset and LBO, B from the fold's image of a
//     conv at a k-step's offset; the host checks the product exactly, so a
//     wrong descriptor fails by name, not 18 convs later;
//   * throughput of wgmma m64nNk16 from shared memory at the bf16 route's
//     warpgroups per SM: the ceiling of its products at each N;
//   * one wgmma m64nNk8 tf32 tile with the TF32 routes' own A fragments
//     (rct::load_a on an fp32 activation buffer in the kernel's layout,
//     rounded to tf32 as the kernel rounds) and B descriptor (the fold's
//     image of one unit); the host checks the product exactly;
//   * throughput of wgmma m64nNk8 tf32 with A from registers and B from
//     shared memory at the TF32 routes' 3 consumer warpgroups per SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "read_conv_wgmma.cuh"
#include "read_conv_wgmma_tf32.cuh"

namespace {

constexpr int kAcc = 12;

template <bool BF16>
__global__ void mma_probe_kernel(float* out, int iters) {
  float acc[kAcc][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1u, threadIdx.x + 2u,
                         threadIdx.x + 3u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      if constexpr (BF16) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(acc[k][0]), "+f"(acc[k][1]), "+f"(acc[k][2]), "+f"(acc[k][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(it), "r"(k));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(acc[k][0]), "+f"(acc[k][1]), "+f"(acc[k][2]), "+f"(acc[k][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(it), "r"(k));
      }
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) s += acc[k][0] + acc[k][1] + acc[k][2] + acc[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// One timed launch of `kernel` (after an untimed warm-up launch of 16
// iterations) on `stream`; writes its device time to *ms.
int timed(void (*kernel)(float*, int), int blocks, int threads, int iters, void* out,
          void* stream, float* ms) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  cudaEvent_t start, end;
  cudaError_t err = cudaEventCreate(&start);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaEventCreate(&end);
  if (err == cudaSuccess) {
    kernel<<<blocks, threads, 0, s>>>(o, 16);
    cudaEventRecord(start, s);
    kernel<<<blocks, threads, 0, s>>>(o, iters);
    cudaEventRecord(end, s);
    err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaEventSynchronize(end);
    if (err == cudaSuccess) err = cudaEventElapsedTime(ms, start, end);
    cudaEventDestroy(end);
  }
  cudaEventDestroy(start);
  return static_cast<int>(err);
}

// One warpgroup: a (a_bytes) and b (b_bytes) into shared memory, then
// D = A B with A at a_off (LBO a_lbo, SBO 128) and B at b_off (LBO N x 16,
// SBO 128), D written row-major [64][N].
template <int N>
__global__ void wgmma_tile_kernel(const uint8_t* a, int a_bytes, int a_off, int a_lbo,
                                  const uint8_t* b, int b_bytes, int b_off, float* d) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sa = smem;
  uint8_t* sb = smem + ((a_bytes + 127) / 128) * 128;
  for (int i = threadIdx.x * 16; i < a_bytes; i += blockDim.x * 16)
    *reinterpret_cast<uint4*>(sa + i) = *reinterpret_cast<const uint4*>(a + i);
  for (int i = threadIdx.x * 16; i < b_bytes; i += blockDim.x * 16)
    *reinterpret_cast<uint4*>(sb + i) = *reinterpret_cast<const uint4*>(b + i);
  rcw::fence_proxy_async();
  __syncthreads();
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  rcw::wgmma_fence();
  rcw::wgmma<N>(acc, rcw::make_desc(rcw::smem_addr(sa) + a_off, a_lbo, 128),
                rcw::make_desc(rcw::smem_addr(sb) + b_off, N * 16, 128));
  rcw::wgmma_commit();
  rcw::wgmma_wait_all();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int j = i >> 2, h = (i >> 1) & 1, e = i & 1;
    d[(warp * 16 + (lane >> 2) + 8 * h) * N + 8 * j + 2 * (lane & 3) + e] = acc[i];
  }
}

// Every warpgroup issues iters x 4 wgmma m64nNk16 from shared memory into
// one accumulator, keeping up to two commit groups in flight.
template <int N>
__global__ void wgmma_rate_kernel(float* out, int iters) {
  __shared__ __align__(128) uint8_t tiles[64 * 16 * 2 + N * 16 * 2];
  for (int i = threadIdx.x; i < static_cast<int>(sizeof(tiles)) / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(tiles)[i] = 0x3c003c00u;
  rcw::fence_proxy_async();
  __syncthreads();
  const uint64_t ad = rcw::make_desc(rcw::smem_addr(tiles), 64 * 16, 128);
  const uint64_t bd = rcw::make_desc(rcw::smem_addr(tiles + 64 * 16 * 2), N * 16, 128);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  rcw::wgmma_fence();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 4; ++k) rcw::wgmma<N>(acc, ad, bd);
    rcw::wgmma_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  rcw::wgmma_wait_all();
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// Every warpgroup issues iters x 4 wgmma m64nNk8 tf32 products, A from
// registers (1.0) and B from shared memory, into one accumulator, keeping
// up to two commit groups in flight.
template <int N>
__global__ void wgmma_tf32_rate_kernel(float* out, int iters) {
  __shared__ __align__(128) uint32_t b[N * 8];
  for (int i = threadIdx.x; i < N * 8; i += blockDim.x) b[i] = 0x3f800000u;
  rcw::fence_proxy_async();
  __syncthreads();
  const uint64_t bd = rct::b_desc(rcw::smem_addr(b), N, 0);
  const uint32_t a[4] = {0x3f800000u, 0x3f800000u, 0x3f800000u, 0x3f800000u};
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  rcw::wgmma_fence();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 4; ++k) rct::wgmma_tf32<N>(acc, a, bd);
    rcw::wgmma_commit();
    rcw::wgmma_wait<1>();
  }
  rcw::wgmma_wait_all();
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// One warpgroup: the fp32 activation buffer `a` (a_floats, a multiple of
// 4, in the TF32 routes' layout) and one weight unit `b` (b_bytes, the
// fold's image) into shared memory, then D = A B for k-step s of the unit
// on tile `tile` at tap `tap`, A loaded and rounded to tf32 by the
// kernel's own load_a, B through its descriptor; D written row-major
// [64][N].
template <int N, int KIND, int CI>
__global__ void wgmma_tf32_tile_kernel(const float* a, int a_floats, int tile, int tap, int s,
                                       const uint8_t* b, int b_bytes, float* d) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* sa = reinterpret_cast<float*>(smem);
  uint8_t* sb = smem + ((a_floats * 4 + 127) / 128) * 128;
  for (int i = threadIdx.x * 4; i < a_floats; i += blockDim.x * 4)
    *reinterpret_cast<float4*>(sa + i) = *reinterpret_cast<const float4*>(a + i);
  for (int i = threadIdx.x * 16; i < b_bytes; i += blockDim.x * 16)
    *reinterpret_cast<uint4*>(sb + i) = *reinterpret_cast<const uint4*>(b + i);
  rcw::fence_proxy_async();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int LS = rct::load_steps<KIND>();
  uint32_t big[2][4], small[2][4];
  rct::load_a<KIND, CI, 1>(sa, tile * 64 + warp * 16 + (lane >> 2), tap, s - s % LS, big, small);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  rcw::wgmma_fence();
  rct::wgmma_tf32<N>(acc, big[s % LS], rct::b_desc(rcw::smem_addr(sb), N, s));
  rcw::wgmma_commit();
  rcw::wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int j = i >> 2, h = (i >> 1) & 1, e = i & 1;
    d[(warp * 16 + (lane >> 2) + 8 * h) * N + 8 * j + 2 * (lane & 3) + e] = acc[i];
  }
}

template <int N, int KIND, int CI>
int tf32_tile(const void* a, int a_floats, int tile, int tap, int s, const void* b,
              int b_bytes, void* d, void* stream) {
  const int smem = ((a_floats * 4 + 127) / 128) * 128 + b_bytes;
  cudaError_t err = cudaFuncSetAttribute(wgmma_tf32_tile_kernel<N, KIND, CI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_tf32_tile_kernel<N, KIND, CI><<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), a_floats, tile, tap, s, static_cast<const uint8_t*>(b),
      b_bytes, static_cast<float*>(d));
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int tile(const void* a, int a_bytes, int a_off, int a_lbo, const void* b, int b_bytes,
         int b_off, void* d, void* stream) {
  const int smem = ((a_bytes + 127) / 128) * 128 + b_bytes;
  cudaError_t err = cudaFuncSetAttribute(wgmma_tile_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_tile_kernel<N><<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), a_bytes, a_off, a_lbo,
      static_cast<const uint8_t*>(b), b_bytes, b_off, static_cast<float*>(d));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One wgmma m64nNk16 bf16 product (n = 16, 32 or 64) by one warpgroup, with
// the bf16 route's descriptors: `a` (a_bytes, a multiple of 16) and `b`
// (b_bytes) are copied to shared memory; A starts a_off bytes into a's copy
// with LBO a_lbo bytes, B b_off bytes into b's copy with LBO n x 16; SBO is
// 128 for both.  Writes D [64][n] fp32 to `d`; returns the cudaError_t of
// the launch.
extern "C" int wgmma_tile_probe(int n, const void* a, int a_bytes, int a_off, int a_lbo,
                                const void* b, int b_bytes, int b_off, void* d,
                                void* stream) {
  switch (n) {
    case 16: return tile<16>(a, a_bytes, a_off, a_lbo, b, b_bytes, b_off, d, stream);
    case 32: return tile<32>(a, a_bytes, a_off, a_lbo, b, b_bytes, b_off, d, stream);
    case 64: return tile<64>(a, a_bytes, a_off, a_lbo, b, b_bytes, b_off, d, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One timed launch of blocks x threads threads (threads a multiple of
// 128), each warpgroup issuing iters x 4 wgmma m64nNk16 bf16 products from
// shared memory (after an untimed warm-up launch); `out` holds
// blocks * threads floats.  Writes the device time to *ms.
extern "C" int wgmma_rate_probe(int n, int blocks, int threads, int iters, void* out,
                                void* stream, float* ms) {
  switch (n) {
    case 16: return timed(wgmma_rate_kernel<16>, blocks, threads, iters, out, stream, ms);
    case 32: return timed(wgmma_rate_kernel<32>, blocks, threads, iters, out, stream, ms);
    case 64: return timed(wgmma_rate_kernel<64>, blocks, threads, iters, out, stream, ms);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One wgmma m64nNk8 tf32 product by one warpgroup with the TF32 routes' A
// fragments and B descriptor: n = the conv's Co, kind its A kind (0 a
// stride-1 k = 3 conv, 1 stem conv 1, 2 the stride-2 conv, 3 the 1x1
// shortcut, as rct::AKind) and ci its input channels; `a` holds a_floats
// fp32 of activations in the kernel's layout, `b` b_bytes of one unit's
// image; the product is k-step s of the unit on tile `tile` at tap `tap`.
// Writes D [64][n] fp32 to `d`; returns the cudaError_t of the launch.
extern "C" int wgmma_tf32_tile_probe(int n, int kind, int ci, const void* a, int a_floats,
                                     int tile, int tap, int s, const void* b, int b_bytes,
                                     void* d, void* stream) {
#define TF32_TILE(N, KIND, CI)                                                          \
  if (n == N && kind == rct::KIND && ci == CI)                                         \
    return tf32_tile<N, rct::KIND, CI>(a, a_floats, tile, tap, s, b, b_bytes, d, stream);
  TF32_TILE(16, kStem1, 8)
  TF32_TILE(16, kUnit, 16)
  TF32_TILE(32, kUnit, 16)
  TF32_TILE(32, kUnit, 32)
  TF32_TILE(64, kUnit, 64)
  TF32_TILE(64, kDown, 32)
  TF32_TILE(64, kShort, 32)
#undef TF32_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

// One timed launch of blocks x threads threads (threads a multiple of
// 128), each warpgroup issuing iters x 4 wgmma m64nNk8 tf32 products, A
// from registers and B from shared memory (after an untimed warm-up
// launch); `out` holds blocks * threads floats.  Writes the device time to
// *ms.
extern "C" int wgmma_tf32_rate_probe(int n, int blocks, int threads, int iters, void* out,
                                     void* stream, float* ms) {
  switch (n) {
    case 16: return timed(wgmma_tf32_rate_kernel<16>, blocks, threads, iters, out, stream, ms);
    case 32: return timed(wgmma_tf32_rate_kernel<32>, blocks, threads, iters, out, stream, ms);
    case 64: return timed(wgmma_tf32_rate_kernel<64>, blocks, threads, iters, out, stream, ms);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One timed launch of blocks x threads threads, each warp issuing
// iters x 12 mma (after an untimed warm-up launch) on `stream`; `out` holds
// blocks * threads floats.  Writes the device time to *ms; returns the
// cudaError_t (0 on success).  mma_tf32_probe times m16n8k8 TF32 products,
// mma_bf16_probe m16n8k16 bf16 products.
extern "C" int mma_tf32_probe(int blocks, int threads, int iters, void* out,
                              void* stream, float* ms) {
  return timed(mma_probe_kernel<false>, blocks, threads, iters, out, stream, ms);
}

extern "C" int mma_bf16_probe(int blocks, int threads, int iters, void* out,
                              void* stream, float* ms) {
  return timed(mma_probe_kernel<true>, blocks, threads, iters, out, stream, ms);
}
