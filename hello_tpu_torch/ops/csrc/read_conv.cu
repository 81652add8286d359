// Fused read convolver + per-allele reduction for NVIDIA Hopper (sm_90a).
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
// What bounds it: about 10.1 MFLOP per row (5.08 M fp32 multiply-adds for
// C = 6, summed over the 18 convs) against about 0.9 KB of uint8 input per
// row, i.e. ~11,000 FLOP per byte read: far above the card's fp32 ridge
// (67 TFLOP/s over 3.35 TB/s, ~20 FLOP/byte on H100 SXM), so the kernel is
// bound by fp32 FMA throughput, not by memory bandwidth.
//
// Design, simple and right first:
//   * one 256-thread block per read row; the row is converted to fp32 into
//     shared memory;
//   * the 18 convs run layer after layer on channel-major shared-memory
//     buffers (three of 32 x 148 fp32, 56.8 KB, above the 48 KB default, so
//     the launch raises the dynamic shared-memory limit); padded convs read
//     zeroed halo columns, so no bounds tests sit in the inner loop;
//   * ReLU, the max-pool, the residual adds and the stride-2 shortcut are
//     fused into the conv loops' epilogues;
//   * a thread computes 4 neighbouring positions of one output channel;
//     consecutive threads take consecutive output channels, so weight loads
//     (stored transposed, [K*Ci][Co]) are coalesced and activation loads are
//     shared-memory broadcasts;
//   * the 464 KB of folded weights are read through the read-only cache and
//     stay resident in L2;
//   * the epilogue adds row_valid * frame into out[row_allele] with fp32
//     atomicAdd.  Rows with row_valid == 0 or row_allele outside [0, A) are
//     skipped whole: padding rows are dropped, and a masked row would add
//     exactly 0 * finite frame.
//
// Determinism and tolerance: the atomics make the order of each allele's sum
// vary from run to run, so results are not bitwise reproducible; together
// with a conv summation order unlike cuDNN's, the kernel is held to
// rtol 1e-4 / atol 1e-3 against the plain PyTorch version
// (read_conv_reduce_reference) - the tolerance hello_tpu holds its Pallas
// kernel to (tests/test_pallas_ops.py).
//
// What this simple design leaves on the table: the tensor cores (each conv
// is an im2col product that TF32 or bf16 wgmma could take), and weight reuse
// across rows (every block rereads all weights from L1/L2 for its one row).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 4;            // output positions per thread item
constexpr int kLIn = 150;
constexpr int kL1 = 148;             // after stem conv 1
constexpr int kL2 = 146;             // after stem conv 2
constexpr int kL3 = 144;             // after stem conv 3
constexpr int kLPool = 71;           // (144 - 3) / 2 + 1
constexpr int kLOut = 36;            // (71 + 2 - 3) / 2 + 1
constexpr int kLd32 = kLPool + 2;    // 32-channel rows with halo columns
constexpr int kLd64 = kLOut + 2;     // 64-channel rows with halo columns
constexpr int kCOut = 64;
constexpr int kBuf = 32 * 148;       // floats per buffer (largest: 32 x 144)
constexpr size_t kSmemBytes = 3 * kBuf * sizeof(float);

enum Epilogue { kStore = 0, kAddResidual = 1, kAddShortcut = 2 };

// One conv layer over shared memory.  Output (co, l), tap k reads
// in[ci * in_ld + l * S + k]: callers pass `in` at the first tap of output 0,
// which for a pad-1 conv is the left halo column.  Writes
// out[co * out_ld + l] (kStore: relu; kAddResidual: += relu; kAddShortcut:
// relu + the 1x1 stride-2 shortcut conv over sc_in, which has no ReLU).
// A strip may run past lo_n: those reads stay inside the buffer (the next
// row or its halo) and their results are never written.
template <int K, int S, int EPI>
__device__ __forceinline__ void conv_layer(
    const float* in, int in_ld, int ci_n,
    float* out, int out_ld, int co_n, int lo_n,
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* sc_in = nullptr, int sc_ld = 0, int sc_ci = 0,
    const float* __restrict__ sc_w = nullptr,
    const float* __restrict__ sc_b = nullptr) {
  constexpr int kSpan = (kStrip - 1) * S + K;
  const int items = ((lo_n + kStrip - 1) / kStrip) * co_n;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int co = it % co_n;
    const int l0 = (it / co_n) * kStrip;
    float acc[kStrip];
    const float b = __ldg(bias + co);
#pragma unroll
    for (int j = 0; j < kStrip; ++j) acc[j] = b;
    const float* x = in + l0 * S;
    for (int ci = 0; ci < ci_n; ++ci) {
      float xv[kSpan];
#pragma unroll
      for (int t = 0; t < kSpan; ++t) xv[t] = x[ci * in_ld + t];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float wk = __ldg(w + (k * ci_n + ci) * co_n + co);
#pragma unroll
        for (int j = 0; j < kStrip; ++j) acc[j] = fmaf(wk, xv[j * S + k], acc[j]);
      }
    }
    float sc[kStrip];
    if (EPI == kAddShortcut) {
      const float sb = __ldg(sc_b + co);
#pragma unroll
      for (int j = 0; j < kStrip; ++j) sc[j] = sb;
      const float* xs = sc_in + 2 * l0;
      for (int ci = 0; ci < sc_ci; ++ci) {
        const float wk = __ldg(sc_w + ci * co_n + co);
#pragma unroll
        for (int j = 0; j < kStrip; ++j) sc[j] = fmaf(wk, xs[ci * sc_ld + 2 * j], sc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kStrip; ++j) {
      const int l = l0 + j;
      if (l < lo_n) {
        const float v = fmaxf(acc[j], 0.0f);
        float* o = out + co * out_ld + l;
        if (EPI == kStore) {
          *o = v;
        } else if (EPI == kAddResidual) {
          *o = *o + v;
        } else {
          *o = v + sc[j];
        }
      }
    }
  }
}

// Next conv's weights in the flat buffer: W^T [K*Ci][Co], then b [Co].
__device__ __forceinline__ void take(const float*& p, int k, int ci, int co,
                                     const float*& w, const float*& b) {
  w = p;
  p += k * ci * co;
  b = p;
  p += co;
}

__global__ void __launch_bounds__(kThreads, 2) read_conv_reduce_kernel(
    const uint8_t* __restrict__ rows, int channels,
    const int32_t* __restrict__ row_allele,
    const float* __restrict__ row_valid,
    const float* __restrict__ weights, int num_alleles,
    float* __restrict__ out) {
  const int r = blockIdx.x;
  const int a = row_allele[r];
  const float valid = row_valid[r];
  if (a < 0 || a >= num_alleles || valid == 0.0f) return;  // whole block

  extern __shared__ float smem[];
  float* b0 = smem;
  float* b1 = smem + kBuf;
  float* b2 = smem + 2 * kBuf;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* p = weights;
  const float* w;
  const float* b;

  // uint8 [150, C] -> fp32 channel-major [C][150] in b0
  const uint8_t* src = rows + static_cast<size_t>(r) * kLIn * channels;
  for (int i = tid; i < kLIn * channels; i += nt) {
    b0[(i % channels) * kLIn + i / channels] = static_cast<float>(src[i]);
  }
  __syncthreads();

  // stem: three valid k3 convs with ReLU
  take(p, 3, channels, 16, w, b);
  conv_layer<3, 1, kStore>(b0, kLIn, channels, b1, kL1, 16, kL1, w, b);
  __syncthreads();
  take(p, 3, 16, 16, w, b);
  conv_layer<3, 1, kStore>(b1, kL1, 16, b0, kL2, 16, kL2, w, b);
  __syncthreads();
  take(p, 3, 16, 32, w, b);
  conv_layer<3, 1, kStore>(b0, kL2, 16, b1, kL3, 32, kL3, w, b);
  __syncthreads();

  // max-pool k3 s2 into x = b2 (32 x 71 with halo columns); zero the halo
  // columns of y = b0 in the same pass
  for (int i = tid; i < 32 * kLd32; i += nt) {
    const int c = i / kLd32;
    const int q = i % kLd32;
    float v = 0.0f;
    if (q >= 1 && q <= kLPool) {
      const float* s = b1 + c * kL3 + 2 * (q - 1);
      v = fmaxf(fmaxf(s[0], s[1]), s[2]);
    } else {
      b0[i] = 0.0f;
    }
    b2[i] = v;
  }
  __syncthreads();

  // 3 residual blocks at 32 channels: x += relu(conv(relu(conv(x))))
  for (int blk = 0; blk < 3; ++blk) {
    take(p, 3, 32, 32, w, b);
    conv_layer<3, 1, kStore>(b2, kLd32, 32, b0 + 1, kLd32, 32, kLPool, w, b);
    __syncthreads();
    take(p, 3, 32, 32, w, b);
    conv_layer<3, 1, kAddResidual>(b0, kLd32, 32, b2 + 1, kLd32, 32, kLPool, w, b);
    __syncthreads();
  }

  // halo columns of the 64-channel buffers y = b0 and x' = b1
  for (int i = tid; i < kCOut; i += nt) {
    b0[i * kLd64] = 0.0f;
    b0[i * kLd64 + kLd64 - 1] = 0.0f;
    b1[i * kLd64] = 0.0f;
    b1[i * kLd64 + kLd64 - 1] = 0.0f;
  }
  __syncthreads();

  // stride-2 residual block 32 -> 64: y = relu(conv_s2(x));
  // x' = relu(conv(y)) + conv1x1_s2(x)
  take(p, 3, 32, 64, w, b);
  conv_layer<3, 2, kStore>(b2, kLd32, 32, b0 + 1, kLd64, 64, kLOut, w, b);
  __syncthreads();
  const float* w2;
  const float* bias2;
  take(p, 3, 64, 64, w2, bias2);
  const float* ws;
  const float* bs;
  take(p, 1, 32, 64, ws, bs);
  conv_layer<3, 1, kAddShortcut>(b0, kLd64, 64, b1 + 1, kLd64, 64, kLOut,
                                 w2, bias2, b2 + 1, kLd32, 32, ws, bs);
  __syncthreads();

  // 3 residual blocks at 64 channels, x in b1
  for (int blk = 0; blk < 3; ++blk) {
    take(p, 3, 64, 64, w, b);
    conv_layer<3, 1, kStore>(b1, kLd64, 64, b0 + 1, kLd64, 64, kLOut, w, b);
    __syncthreads();
    take(p, 3, 64, 64, w, b);
    conv_layer<3, 1, kAddResidual>(b0, kLd64, 64, b1 + 1, kLd64, 64, kLOut, w, b);
    __syncthreads();
  }

  // out[a, l, c] += valid * x[c, l]
  float* o = out + static_cast<size_t>(a) * kLOut * kCOut;
  for (int i = tid; i < kLOut * kCOut; i += nt) {
    const int l = i / kCOut;
    const int c = i % kCOut;
    atomicAdd(o + i, valid * b1[c * kLd64 + 1 + l]);
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t).  Returns the cudaError_t of the
// shared-memory opt-in or of the launch itself (0 on success); the caller
// allocates and zero-fills `out`.
extern "C" int read_conv_reduce_f32(const void* rows, int nb, int channels,
                                    const void* row_allele,
                                    const void* row_valid,
                                    const void* weights, int num_alleles,
                                    void* out, void* stream) {
  if (channels != 6 && channels != 7) return static_cast<int>(cudaErrorInvalidValue);
  if (nb <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      read_conv_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  read_conv_reduce_kernel<<<nb, kThreads, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), channels,
      static_cast<const int32_t*>(row_allele),
      static_cast<const float*>(row_valid),
      static_cast<const float*>(weights), num_alleles,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
