// Fused read convolver + per-allele reduction for NVIDIA Hopper (sm_90a),
// on the tensor cores through wgmma, in three routes (one per precision
// class of the caller; the fold packs the weights for one):
//   kTF32x3 (highest, high): every product 3xTF32, fp32-class accuracy;
//   kTF32 (default): one TF32 pass per product, XLA's DEFAULT on a GPU;
//       both in read_conv_wgmma_tf32.cuh, one template on the number of
//       passes: wgmma m64nNk8 tf32 products with A (the activations) split
//       in registers and B (the weights) from shared memory;
//   kBF16 (bf16): read_conv_wgmma.cuh, wgmma m64nNk16 products from bf16
//       shared-memory tiles, activations rounded to bf16 where the Pallas
//       kernel's bf16 compute_dtype rounds them.
// The wide read convolver (every channel count doubled) has a kernel of its
// own, at bf16 only: read_conv_wgmma_wide.cuh, launched by
// read_conv_reduce_wide_run.
// The kernels stream their weights by bulk copies on mbarriers
// (wgmma_ptx.cuh holds the PTX helpers they share).  This file holds the C
// interface of the routes.
//
// Replaces the two Pallas TPU kernels of hello_tpu/ops/read_conv.py and the
// masked reduction they end in:
//   _stem_kernel (read_conv.py:252): 3 valid k3 convs with ReLU
//       (C -> 16 -> 16 -> 32) and a k3 s2 max-pool;
//   _tail_kernel (read_conv.py:263): 3 residual blocks at 32 channels, the
//       stride-2 residual block 32 -> 64 with its 1x1 stride-2 shortcut,
//       3 residual blocks at 64 channels, and the per-allele masked sum.
// One launch computes
//   out[a] += row_valid[r] * read_convolver(rows[r])   for row_allele[r] == a
// over packed read rows (rows: uint8 [nb, 150, C], C = 6 or 7; out: fp32
// [A, 36, 64] NWC, zero-filled by the caller).
//
// What bounds it: 5.08 M multiply-adds per row for C = 6 (10.15 MFLOP, the
// 18 convs) against ~0.9 KB of uint8 input, so operations bound it, not
// bytes.  For the kernel phase of chip_smoke.py (38,399 computed rows,
// 389.8 GFLOP) on an H100 SXM at the published dense peaks: 2.36 ms for
// the three TF32 passes of kTF32x3 (3 x 389.8 GFLOP at 495 TFLOP/s), 0.79
// ms for kTF32's one pass, 0.39 ms for kBF16 at 989 TFLOP/s; 5.82 ms at the
// fp32 FMA peak.  Each header's note says what else bounds its route and
// what its design does about it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "read_conv_wgmma.cuh"
#include "read_conv_wgmma_tf32.cuh"
#include "read_conv_wgmma_wide.cuh"

namespace {

// kernel routes, as ops/read_conv.py ROUTE_IDS numbers them
enum Route { kTF32x3 = 0, kTF32 = 1, kBF16 = 2 };

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int C, int P>
cudaError_t launch_tf32(const void* rows, int nb, const void* row_allele,
                        const void* row_valid, const void* weights,
                        int num_alleles, void* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rct::read_conv_reduce_tf32<C, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      rct::kSmemBytes);
  if (err != cudaSuccess) return err;
  rct::read_conv_reduce_tf32<C, P>
      <<<cdiv(nb, rct::kRows), rct::kThreads, rct::kSmemBytes, stream>>>(
          static_cast<const uint8_t*>(rows), nb,
          static_cast<const int32_t*>(row_allele),
          static_cast<const float*>(row_valid),
          static_cast<const float*>(weights), num_alleles,
          static_cast<float*>(out));
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_bf16(const void* rows, int nb, const void* row_allele,
                        const void* row_valid, const void* weights,
                        int num_alleles, void* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rcw::read_conv_reduce_wgmma<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      rcw::kSmemBytes);
  if (err != cudaSuccess) return err;
  rcw::read_conv_reduce_wgmma<C>
      <<<cdiv(nb, rcw::kRows), rcw::kThreads, rcw::kSmemBytes, stream>>>(
          static_cast<const uint8_t*>(rows), nb,
          static_cast<const int32_t*>(row_allele),
          static_cast<const float*>(row_valid),
          static_cast<const uint8_t*>(weights), num_alleles,
          static_cast<float*>(out));
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_wide(const void* rows, int nb, const void* row_allele,
                        const void* row_valid, const void* weights,
                        int num_alleles, void* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rcw2::read_conv_reduce_wide<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      rcw2::kSmemBytes);
  if (err != cudaSuccess) return err;
  rcw2::read_conv_reduce_wide<C>
      <<<cdiv(nb, rcw2::kSpan), rcw2::kThreads, rcw2::kSmemBytes, stream>>>(
          static_cast<const uint8_t*>(rows), nb,
          static_cast<const int32_t*>(row_allele),
          static_cast<const float*>(row_valid),
          static_cast<const uint8_t*>(weights), num_alleles,
          static_cast<float*>(out));
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_route(int route, const void* rows, int nb,
                         const void* row_allele, const void* row_valid,
                         const void* weights, int num_alleles, void* out,
                         cudaStream_t s) {
  switch (route) {
    case kTF32x3:
      return launch_tf32<C, 3>(rows, nb, row_allele, row_valid, weights, num_alleles, out, s);
    case kTF32:
      return launch_tf32<C, 1>(rows, nb, row_allele, row_valid, weights, num_alleles, out, s);
    case kBF16:
      return launch_bf16<C>(rows, nb, row_allele, row_valid, weights, num_alleles, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int C>
const void* kernel_of(int route) {
  return route == kTF32x3 ? reinterpret_cast<const void*>(&rct::read_conv_reduce_tf32<C, 3>)
       : route == kTF32 ? reinterpret_cast<const void*>(&rct::read_conv_reduce_tf32<C, 1>)
       : route == kBF16 ? reinterpret_cast<const void*>(&rcw::read_conv_reduce_wgmma<C>)
       : nullptr;
}

}  // namespace

// Launch the route's kernel (0 = 3xTF32, 1 = TF32, 2 = bf16, the fold's
// weight layout) on `stream` (a cudaStream_t).  Returns the cudaError_t of
// the shared-memory opt-in or of the launch itself (0 on success); the
// caller allocates and zero-fills `out`.
extern "C" int read_conv_reduce_run(const void* rows, int nb, int channels,
                                    int route, const void* row_allele,
                                    const void* row_valid,
                                    const void* weights, int num_alleles,
                                    void* out, void* stream) {
  if (channels != 6 && channels != 7) return static_cast<int>(cudaErrorInvalidValue);
  if (route < kTF32x3 || route > kBF16) return static_cast<int>(cudaErrorInvalidValue);
  if (nb <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      channels == 6
          ? launch_route<6>(route, rows, nb, row_allele, row_valid, weights, num_alleles, out, s)
          : launch_route<7>(route, rows, nb, row_allele, row_valid, weights, num_alleles, out, s));
}

// A route's launch shape on this device: read rows per block, dynamic
// shared memory per block, threads per block and resident blocks per SM.
extern "C" int read_conv_reduce_info(int channels, int route,
                                     int* rows_per_block, int* smem_bytes,
                                     int* threads, int* blocks_per_sm) {
  if (channels != 6 && channels != 7) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = channels == 6 ? kernel_of<6>(route) : kernel_of<7>(route);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16 = route == kBF16;
  *rows_per_block = bf16 ? rcw::kRows : rct::kRows;
  *smem_bytes = bf16 ? rcw::kSmemBytes : rct::kSmemBytes;
  *threads = bf16 ? rcw::kThreads : rct::kThreads;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, *threads, *smem_bytes));
}

// The wide read convolver's kernel (bf16, the fold's bf16 layout at twice
// the width) on `stream`: out [A, 36, 128] fp32, zero-filled by the caller,
// gets each allele's sum.  Returns the cudaError_t of the shared-memory
// opt-in or of the launch (0 on success).
extern "C" int read_conv_reduce_wide_run(const void* rows, int nb, int channels,
                                         const void* row_allele,
                                         const void* row_valid,
                                         const void* weights, int num_alleles,
                                         void* out, void* stream) {
  if (channels != 6 && channels != 7) return static_cast<int>(cudaErrorInvalidValue);
  if (nb <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      channels == 6
          ? launch_wide<6>(rows, nb, row_allele, row_valid, weights, num_alleles, out, s)
          : launch_wide<7>(rows, nb, row_allele, row_valid, weights, num_alleles, out, s));
}

// The wide kernel's launch shape on this device, as read_conv_reduce_info's;
// rows_per_block is the rows a group computes at once.
extern "C" int read_conv_reduce_wide_info(int channels, int* rows_per_block,
                                          int* smem_bytes, int* threads,
                                          int* blocks_per_sm) {
  if (channels != 6 && channels != 7) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = channels == 6
                           ? reinterpret_cast<const void*>(&rcw2::read_conv_reduce_wide<6>)
                           : reinterpret_cast<const void*>(&rcw2::read_conv_reduce_wide<7>);
  *rows_per_block = rcw2::kRows;
  *smem_bytes = rcw2::kSmemBytes;
  *threads = rcw2::kThreads;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, *threads, *smem_bytes));
}
