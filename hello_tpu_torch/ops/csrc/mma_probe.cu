// Throughput probe for mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32,
// the product instruction of the read-conv kernel (read_conv.cu), run
// back to back from registers by every warp, with the kernel's 12
// independent accumulator tiles per warp.  chip_smoke.py launches it at the
// kernel's occupancy (one 256-thread block per SM) and reports the rate as
// the ceiling that kernel's tensor-core products can reach on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAcc = 12;

__global__ void mma_probe_kernel(float* out, int iters) {
  float acc[kAcc][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1u, threadIdx.x + 2u,
                         threadIdx.x + 3u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[k][0]), "+f"(acc[k][1]), "+f"(acc[k][2]), "+f"(acc[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(it), "r"(k));
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) s += acc[k][0] + acc[k][1] + acc[k][2] + acc[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// One timed launch of blocks x threads threads, each warp issuing
// iters x 12 mma (after an untimed warm-up launch) on `stream`; `out` holds
// blocks * threads floats.  Writes the device time to *ms; returns the
// cudaError_t (0 on success).
extern "C" int mma_tf32_probe(int blocks, int threads, int iters, void* out,
                              void* stream, float* ms) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  cudaEvent_t start, end;
  cudaError_t err = cudaEventCreate(&start);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaEventCreate(&end);
  if (err == cudaSuccess) {
    mma_probe_kernel<<<blocks, threads, 0, s>>>(o, 16);
    cudaEventRecord(start, s);
    mma_probe_kernel<<<blocks, threads, 0, s>>>(o, iters);
    cudaEventRecord(end, s);
    err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaEventSynchronize(end);
    if (err == cudaSuccess) err = cudaEventElapsedTime(ms, start, end);
    cudaEventDestroy(end);
  }
  cudaEventDestroy(start);
  return static_cast<int>(err);
}
