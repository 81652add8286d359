// Throughput probe for the product instructions of the read-conv kernel
// (read_conv.cu): mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (its
// TF32 routes) and mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (its
// bf16 route), run back to back from registers by every warp, with the
// kernel's 12 independent accumulator tiles per warp.  chip_smoke.py
// launches it at the kernel's occupancy (one 256-thread block per SM) and
// reports each rate as the ceiling that route's tensor-core products can
// reach on the card.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <bool BF16>
int probe(int blocks, int threads, int iters, void* out, void* stream,
          float* ms) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  cudaEvent_t start, end;
  cudaError_t err = cudaEventCreate(&start);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaEventCreate(&end);
  if (err == cudaSuccess) {
    mma_probe_kernel<BF16><<<blocks, threads, 0, s>>>(o, 16);
    cudaEventRecord(start, s);
    mma_probe_kernel<BF16><<<blocks, threads, 0, s>>>(o, iters);
    cudaEventRecord(end, s);
    err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaEventSynchronize(end);
    if (err == cudaSuccess) err = cudaEventElapsedTime(ms, start, end);
    cudaEventDestroy(end);
  }
  cudaEventDestroy(start);
  return static_cast<int>(err);
}

}  // namespace

// One timed launch of blocks x threads threads, each warp issuing
// iters x 12 mma (after an untimed warm-up launch) on `stream`; `out` holds
// blocks * threads floats.  Writes the device time to *ms; returns the
// cudaError_t (0 on success).  mma_tf32_probe times m16n8k8 TF32 products,
// mma_bf16_probe m16n8k16 bf16 products.
extern "C" int mma_tf32_probe(int blocks, int threads, int iters, void* out,
                              void* stream, float* ms) {
  return probe<false>(blocks, threads, iters, out, stream, ms);
}

extern "C" int mma_bf16_probe(int blocks, int threads, int iters, void* out,
                              void* stream, float* ms) {
  return probe<true>(blocks, threads, iters, out, stream, ms);
}
