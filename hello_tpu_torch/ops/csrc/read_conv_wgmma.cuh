// The bf16 route of read_conv_reduce (read_conv.cu, route id 2) for Hopper:
// every conv a wgmma.mma_async m64nNk16 bf16 product from shared memory,
// the weights streamed one conv per stage by bulk copies that complete on
// mbarriers.  read_conv.cu includes this header for the kernel and
// mma_probe.cu for the descriptors and the layout it probes; the PTX
// helpers it shares with the TF32 routes are in wgmma_ptx.cuh.
//
// Replaces, at bf16, the two Pallas TPU kernels of hello_tpu/ops/read_conv.py
// (_stem_kernel :252 and _tail_kernel :263 with the bf16 compute_dtype of
// :379) and the masked per-allele reduction after them.
//
// What bounds it: 5.08 M multiply-adds per read row (C = 6), against ~0.9 KB
// of uint8 input: operations.  For the kernel phase of chip_smoke.py (38,399
// computed rows, 389.8 GFLOP) that is 0.39 ms at the H100 SXM's 989 TFLOP/s
// dense bf16 peak.  Two more ceilings sit above it: wgmma reads its A tile
// (64 positions x 16 channels, 2 KB) from shared memory for every product,
// so at N = Co = 16 or 32 shared memory's bandwidth, not the tensor cores,
// sets the rate (chip_smoke.py's wgmma probe measures each N); and whatever
// the block does between products (epilogues, barriers, the max-pool, the
// atomics) adds to the time, since one block holds an SM.
//
// Arithmetic, as the Pallas kernel's bf16 path and read_convolver_reference
// round: weights bf16 (rounded at fold time), activations bf16 in shared
// memory (the uint8 input is exact in bf16), products exact, sums in fp32
// registers that start at the fp32 bias; each conv's sum rounded to bf16
// once (ReLU commutes with the rounding); a residual add rounds the branch
// and then the sum, *o = bf16(*o + bf16(relu(v))), and so does y +
// shortcut; the max-pool compares bf16 values; the frames leave as bf16
// values and are summed per allele in fp32 by the atomics, out[a] +=
// row_valid[r] * frame(r).  Rows with row_valid == 0 or row_allele outside
// [0, A) add nothing, and a block of only such rows returns at once.
//
// Design:
//   * Orientation.  out[positions][Co] = im2col(in)[positions][K] x
//     W^T[K][Co]: M = 64 positions per tile, N = Co (16, 32 or 64, each a
//     legal wgmma width, so no tile is half empty), K in steps of 16.
//     kRows = 5 read rows are stacked along the positions, each row with
//     its halo columns: the stem is 12 tiles, a 32-channel conv 6, a
//     64-channel conv 3, split evenly over the block's 3 warpgroups.
//   * Activations in bf16 shared buffers laid out [channel group of 8]
//     [position][8 channels]: 8 consecutive positions x 8 channels are one
//     128-byte no-swizzle K-major core matrix, so a wgmma A descriptor is
//     (start, LBO = the buffer's positions x 16 B between channel groups,
//     SBO = 128 B between 8-position groups), and tap t of a k = 3 conv is
//     the same descriptor 16 t bytes further on.  The last 32-channel
//     residual add writes x as even and odd planes of its padded row, which
//     makes the stride-2 conv (taps: even, odd, even + 1) and its 1x1
//     stride-2 shortcut (odd) plain shifts too.  Stem conv 1 reads the
//     input as [position][8] (C channels, then zeros): one k-step's two
//     core matrices are taps 2s and 2s + 1 (LBO = 16 B, one position), so
//     its K is 4 taps x 8 channels = 32, the fourth tap's weights zero.
//   * Weights.  The fold writes each conv's B operand as its shared-memory
//     image, [K/8][Co][8] bf16 (a K-major core matrix is 8 output channels
//     x 8 K values; LBO = Co x 16 B, SBO = 128 B), followed by its fp32
//     bias; one cp.async.bulk lands a conv in a stage, and a ring of two
//     stages on two mbarriers keeps the next conv's copy in flight while
//     a conv computes.  No barrier per tap: one block barrier per conv
//     publishes its outputs (after fence.proxy.async, since wgmma reads
//     shared memory through the async proxy) and frees its stage.
//   * Epilogues on the accumulators: bias (their initial value), ReLU,
//     bf16 rounding, residual add, two channels per 4-byte store.  Halo
//     and spare positions are computed and never stored; every buffer has
//     room for the reads of the last tile, whose extra rows read stale
//     values that only those rows' outputs see.  The block's rows of one
//     allele (consecutive on the wire) are summed in registers before the
//     atomics.
//   * Shared memory: activations 75,776 B, two weight stages 49,664 B, one
//     384-thread block per SM.
//
// What it leaves (ops/read_conv_variants.py times the block with one part
// taken out): the block's work between its products, the epilogues (issue
// bound: every thread of 12 warps runs them while the tensor cores idle),
// the barriers and waits of 18 convs, the input and the max-pool, takes
// more time than the products, and does not overlap them, since one block
// holds an SM and its registers.  Two row groups per SM in turn (fewer
// registers per thread, or warp-specialised ping-pong) would overlap them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_ptx.cuh"

namespace rcw {

using namespace wgx;

constexpr int kRows = 5;                  // read rows per block
constexpr int kWarpgroups = 3;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTile = 64;                 // positions per wgmma tile (M)
constexpr int kChunk = 4;                 // most tiles a warpgroup holds at once

constexpr int kLIn = 150;
constexpr int kLPool = 71;                // (144 - 3) / 2 + 1
constexpr int kLOut = 36;                 // (71 + 2 - 3) / 2 + 1
constexpr int kCOut = 64;
constexpr int kP32 = 76;                  // row stride, 32 channels: halo, 71, halo, 3 spare
constexpr int kP64 = 38;                  // row stride, 64 channels: halo, 36, halo

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int round8(int n) { return cdiv(n, 8) * 8; }
constexpr int kOdd = round8(kRows * kP64);   // the odd plane's first position
// wgmma tiles of a conv whose outputs are q = r * pq + l, l < lo, r < kRows
__host__ __device__ constexpr int tiles(int pq, int lo) {
  return cdiv((kRows - 1) * pq + lo, kTile);
}

// Positions of each buffer: past the last tile's reads (taps and, for stem
// conv 1, the second core matrix one position on)
constexpr int kPIn = round8(tiles(kLIn, 148) * kTile + 3);       // input [pos][8]
constexpr int kPS = round8(tiles(kLIn, 146) * kTile + 2);        // stem outputs
constexpr int kP32B = round8(tiles(kP32, kLPool) * kTile + 2);   // x32, y32
constexpr int kPPl = kOdd + tiles(kP64, kLOut) * kTile;          // even | odd planes
constexpr int kP64B = round8(tiles(kP64, kLOut) * kTile + 2);    // x64, y64

// bytes of a buffer of `ch` channels over `pos` positions
__host__ __device__ constexpr int buf_bytes(int ch, int pos) { return ch / 8 * pos * 16; }

// Region A: input, stem conv 2's output, x32, y64.  Region B: stem conv 1's
// and 3's outputs, then the planes | y32, then x64 past the planes.
constexpr int kRegA = imax(imax(buf_bytes(8, kPIn), buf_bytes(16, kPS)),
                           imax(buf_bytes(32, kP32B), buf_bytes(64, kP64B)));
constexpr int kPlanesOff = 0;
constexpr int kY32Off = buf_bytes(32, kPPl);
constexpr int kX64Off = kY32Off;
constexpr int kRegB = imax(imax(buf_bytes(16, kPS), buf_bytes(32, kPS)),
                           imax(kY32Off + buf_bytes(32, kP32B),
                                kX64Off + buf_bytes(64, kP64B)));

// The 18 convs in the fold's order (stem 1-3, 6 x RB32, the stride-2 conv,
// its second conv, the 1x1 shortcut, 6 x RB64): K as the products take it
// and Co; each is K x Co bf16 of image, then Co fp32 of bias, in the flat
// buffer (ops/read_conv.py pack_conv).
__host__ __device__ constexpr int conv_k(int i) {
  return i == 0 ? 32 : i <= 2 ? 48 : i <= 9 ? 96 : i == 10 ? 192 : i == 11 ? 32 : 192;
}
__host__ __device__ constexpr int conv_co(int i) { return i <= 1 ? 16 : i <= 8 ? 32 : 64; }
__host__ __device__ constexpr int image_bytes(int i) { return conv_k(i) * conv_co(i) * 2; }
__host__ __device__ constexpr int conv_bytes(int i) { return image_bytes(i) + conv_co(i) * 4; }
__host__ __device__ constexpr int conv_off(int i) {
  return i == 0 ? 0 : conv_off(i - 1) + conv_bytes(i - 1);
}
constexpr int kNumConvs = 18;
// the order the kernel runs them: the shortcut (11) before the second conv
// of the stride-2 block (10)
__host__ __device__ constexpr int exec_conv(int step) {
  return step == 10 ? 11 : step == 11 ? 10 : step;
}
constexpr int kStage = conv_bytes(17);    // the largest: 192 x 64 x 2 + 256
constexpr int kStages = 2;                // the ring of weight stages
constexpr int kSmemBytes = kRegA + kRegB + kStages * (kStage + 8);

// ---------------------------------------------------------------------------
// PTX wrappers (the shared ones are in wgmma_ptx.cuh)
// ---------------------------------------------------------------------------

// D[64][N] += A[64][16] B[16][N], bf16 operands from shared memory (both
// K-major), fp32 accumulators in the m64nNk16 fragment: d[4 j + 2 h + e] is
// row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// ---------------------------------------------------------------------------
// One conv
// ---------------------------------------------------------------------------

// How a conv's A operand reads its input buffer: kUnit, a k = 3 conv with
// stride 1 (tap t: t positions on); kStem1, the [pos][8] input (k-step s:
// taps 2s and 2s + 1, one position apart); kDown, the stride-2 conv on the
// planes (taps: even, odd, even + 1); kShort, the 1x1 stride-2 shortcut
// (odd).
enum AKind { kUnit = 0, kStem1 = 1, kDown = 2, kShort = 3 };
// What the epilogue stores: relu; out += relu (the residual add); linear
// (the shortcut); or the residual add of the last 32-channel block, read
// from x32 and written to the even / odd planes.
enum Epi { kRelu = 0, kReluAdd = 1, kLinear = 2, kReluAddPlanes = 3 };

// A's byte offset of k-step s (from the tile's first position)
template <int KIND, int CI, int A_LBO>
__host__ __device__ constexpr int a_offset(int s) {
  return KIND == kStem1 ? 2 * s * 16
       : KIND == kShort ? kOdd * 16 + 2 * s * A_LBO
       : KIND == kDown
           ? ((s / 2) == 0 ? 0 : (s / 2) == 1 ? kOdd : 1) * 16 + 2 * (s % 2) * A_LBO
           : (s / (CI >= 16 ? CI / 16 : 1)) * 16 + 2 * (s % (CI >= 16 ? CI / 16 : 1)) * A_LBO;
}

// One thread: conv STEP of the run (conv exec_conv(STEP) of the fold), image
// and bias, into its stage, completing on the stage's barrier.  The
// offsets are constants (conv_off recurses).
template <int STEP>
__device__ __forceinline__ void load_stage(uint8_t* stages, uint64_t* bars,
                                           const uint8_t* __restrict__ weights) {
  constexpr int I = exec_conv(STEP);
  constexpr int OFF = conv_off(I);
  constexpr int BYTES = conv_bytes(I);
  bulk_load(stages + (STEP % kStages) * kStage, weights + OFF, BYTES, bars + STEP % kStages);
}

// One thread: the first kStages convs of the run into the ring.
template <int STEP = 0>
__device__ __forceinline__ void fill_ring(uint8_t* stages, uint64_t* bars,
                                          const uint8_t* __restrict__ weights) {
  if constexpr (STEP < kStages) {
    load_stage<STEP>(stages, bars, weights);
    fill_ring<STEP + 1>(stages, bars, weights);
  }
}

// Conv STEP of the run (conv exec_conv(STEP) of the fold), over the block's
// rows: outputs q = r * PQ + l (r < kRows, l < LO) to `out` (OUT_P
// positions per channel group) at q + OUT_OFF, from `in` (IN_P positions
// per group; stem conv 1: [pos][8]).  Waits for its weights, runs its
// k-steps on the warpgroup's tiles, stores, publishes the outputs with one
// block barrier, then thread 0 refills the conv's stage with conv STEP +
// kStages.
template <int STEP, int KIND, int IN_P, int OUT_P, int PQ, int LO, int OUT_OFF, int EPI>
__device__ __forceinline__ void conv(const uint8_t* in, uint8_t* out, const uint8_t* res,
                                     uint8_t* stages, uint64_t* bars,
                                     const uint8_t* __restrict__ weights) {
  constexpr int I = exec_conv(STEP);
  constexpr int CO = conv_co(I);
  constexpr int K = conv_k(I);
  constexpr int CI = KIND == kStem1 ? 8 : KIND == kShort ? K : K / 3;
  constexpr int KSTEPS = K / 16;
  constexpr int TILES = tiles(PQ, LO);
  constexpr int TPW = TILES / kWarpgroups;
  constexpr int CH = TPW < kChunk ? TPW : kChunk;
  constexpr int A_LBO = KIND == kStem1 ? 16 : IN_P * 16;
  constexpr int OUT_LBO = OUT_P * 16;
  static_assert(TILES % kWarpgroups == 0 && TPW % CH == 0,
                "tiles split evenly over the warpgroups and their chunks");
  static_assert(KIND == kStem1 || CI % 16 == 0, "whole k-steps per tap");
  static_assert(image_bytes(I) + CO * 4 <= kStage, "stage holds the conv");

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int qd = lane & 3;
  uint8_t* stage = stages + (STEP % kStages) * kStage;
  mbar_wait(bars + STEP % kStages, (STEP / kStages) & 1);
  const float* bias = reinterpret_cast<const float*>(stage + image_bytes(I));

  const uint32_t a0 = smem_addr(in) + wg * TPW * kTile * 16;
  const uint32_t b0 = smem_addr(stage);
  // the warpgroup's tiles in chunks of at most kChunk, each chunk's
  // products issued back to back and waited for once
#pragma unroll 1
  for (int t0 = 0; t0 < TPW; t0 += CH) {
    float acc[CH][CO / 2];
#pragma unroll
    for (int j = 0; j < CO / 8; ++j) {
      const float bj0 = bias[8 * j + 2 * qd];
      const float bj1 = bias[8 * j + 2 * qd + 1];
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        acc[t][4 * j] = bj0;
        acc[t][4 * j + 1] = bj1;
        acc[t][4 * j + 2] = bj0;
        acc[t][4 * j + 3] = bj1;
      }
    }
#pragma unroll
    for (int t = 0; t < CH; ++t) fence_operands(acc[t]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      const uint64_t bd = make_desc(b0 + s * 2 * CO * 16, CO * 16, 128);
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        const uint64_t ad = make_desc(
            a0 + (t0 + t) * kTile * 16 + a_offset<KIND, CI, A_LBO>(s), A_LBO, 128);
        wgmma<CO>(acc[t], ad, bd);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int t = 0; t < CH; ++t) fence_operands(acc[t]);

#pragma unroll
    for (int t = 0; t < CH; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (wg * TPW + t0 + t) * kTile + warp * 16 + g + 8 * h;
        const int r = p / PQ;
        const int l = p - r * PQ;
        if (r >= kRows || l >= LO) continue;
        int dst = p + OUT_OFF;
        if (EPI == kReluAddPlanes) {
          // column c = l + 1 of the padded row: even -> E[r * 38 + c / 2],
          // odd -> O[r * 38 + c / 2]
          const int c = l + 1;
          dst = (c & 1 ? kOdd : 0) + r * kP64 + (c >> 1);
        }
#pragma unroll
        for (int j = 0; j < CO / 8; ++j) {
          const float v0 = acc[t][4 * j + 2 * h];
          const float v1 = acc[t][4 * j + 2 * h + 1];
          uint32_t* o = reinterpret_cast<uint32_t*>(out + j * OUT_LBO + dst * 16 + 4 * qd);
          if (EPI == kRelu) {
            *o = bf16x2(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
          } else if (EPI == kLinear) {
            *o = bf16x2(v0, v1);
          } else {
            const uint32_t* src =
                EPI == kReluAdd
                    ? o
                    : reinterpret_cast<const uint32_t*>(res + j * kP32B * 16 + (p + 1) * 16 + 4 * qd);
            const float2 x = unpack2(*src);
            const float2 y = unpack2(bf16x2(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f)));
            *o = bf16x2(x.x + y.x, x.y + y.y);
          }
        }
      }
    }
  }
  fence_proxy_async();
  __syncthreads();
  if (STEP + kStages < kNumConvs && tid == 0) {
    load_stage<STEP + kStages < kNumConvs ? STEP + kStages : 0>(stages, bars, weights);
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int C>
__global__ void __launch_bounds__(kThreads, 1) read_conv_reduce_wgmma(
    const uint8_t* __restrict__ rows, int nb, const int32_t* __restrict__ row_allele,
    const float* __restrict__ row_valid, const uint8_t* __restrict__ weights,
    int num_alleles, float* __restrict__ out) {
  const int r0 = blockIdx.x * kRows;
  int allele[kRows];
  float valid[kRows];
  bool any = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    allele[r] = -1;
    valid[r] = 0.0f;
    if (r0 + r < nb) {
      const int a = row_allele[r0 + r];
      const float v = row_valid[r0 + r];
      if (a >= 0 && a < num_alleles && v != 0.0f) {
        allele[r] = a;
        valid[r] = v;
        any = true;
      }
    }
  }
  if (!any) return;  // whole block: padding or masked rows only

  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* reg_a = smem;
  uint8_t* reg_b = smem + kRegA;
  uint8_t* stages = reg_b + kRegB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + kStages * kStage);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + i, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) fill_ring(stages, bars, weights);

  // uint8 rows [kRows * 150][C] -> bf16 [pos][8] in region A: C channels,
  // then zeros; positions past the block's rows are zero
  {
    const int n_pos = min(kRows, nb - r0) * kLIn;
    const uint8_t* src = rows + static_cast<size_t>(r0) * kLIn * C;
    for (int p = tid; p < kPIn; p += kThreads) {
      float v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = (p < n_pos && c < C) ? static_cast<float>(src[p * C + c]) : 0.0f;
      uint4 w;
      w.x = bf16x2(v[0], v[1]);
      w.y = bf16x2(v[2], v[3]);
      w.z = bf16x2(v[4], v[5]);
      w.w = bf16x2(v[6], v[7]);
      *reinterpret_cast<uint4*>(reg_a + p * 16) = w;
    }
  }
  fence_proxy_async();
  __syncthreads();

  // stem: three valid k3 convs with ReLU, positions q = r * 150 + l
  conv<0, kStem1, 0, kPS, kLIn, 148, 0, kRelu>(reg_a, reg_b, nullptr, stages, bars, weights);
  conv<1, kUnit, kPS, kPS, kLIn, 146, 0, kRelu>(reg_b, reg_a, nullptr, stages, bars, weights);
  conv<2, kUnit, kPS, kPS, kLIn, 144, 0, kRelu>(reg_a, reg_b, nullptr, stages, bars, weights);

  // max-pool k3 s2: 32 x 144 per row -> x32 rows [halo, 71, halo, 3 spare]
  // in region A, 8 channels per thread and item
  uint8_t* x32 = reg_a;
  uint8_t* y32 = reg_b + kY32Off;
  uint8_t* planes = reg_b + kPlanesOff;
  for (int i = tid; i < 4 * kP32B; i += kThreads) {
    const int cg = i / kP32B;
    const int pos = i - cg * kP32B;
    const int r = pos / kP32;
    const int col = pos - r * kP32;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < kRows && col >= 1 && col <= kLPool) {
      const uint4* s = reinterpret_cast<const uint4*>(reg_b + cg * kPS * 16) + r * kLIn + 2 * (col - 1);
      const uint4 s0 = s[0], s1 = s[1], s2 = s[2];
      const uint32_t* a = &s0.x;
      const uint32_t* b = &s1.x;
      const uint32_t* c = &s2.x;
      uint32_t* m = &v.x;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 ab = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(a + e),
                                          *reinterpret_cast<const __nv_bfloat162*>(b + e));
        const __nv_bfloat162 abc = __hmax2(ab, *reinterpret_cast<const __nv_bfloat162*>(c + e));
        m[e] = *reinterpret_cast<const uint32_t*>(&abc);
      }
    }
    *reinterpret_cast<uint4*>(x32 + cg * kP32B * 16 + pos * 16) = v;
  }
  fence_proxy_async();
  __syncthreads();
  // y32's halo and spare columns (0, 72..75) and the planes' (even 0, 36,
  // 37; odd 36, 37), which the convs never write
  for (int i = tid; i < 4 * kRows * 10; i += kThreads) {
    const int cg = i / (kRows * 10);
    const int rem = i - cg * (kRows * 10);
    const int r = rem / 10;
    const int h = rem - r * 10;
    uint8_t* dst = h < 5 ? y32 + cg * kP32B * 16 + (r * kP32 + (h == 0 ? 0 : kLPool + h)) * 16
                         : planes + cg * kPPl * 16 +
                               ((h < 8 ? 0 : kOdd) + r * kP64 + (h == 5 ? 0 : h < 8 ? 30 + h : 28 + h)) * 16;
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }

  // 3 residual blocks at 32 channels: x += relu(conv(relu(conv(x)))); the
  // last add writes x as the even / odd planes
  conv<3, kUnit, kP32B, kP32B, kP32, kLPool, 1, kRelu>(x32, y32, nullptr, stages, bars, weights);
  conv<4, kUnit, kP32B, kP32B, kP32, kLPool, 1, kReluAdd>(y32, x32, nullptr, stages, bars, weights);
  conv<5, kUnit, kP32B, kP32B, kP32, kLPool, 1, kRelu>(x32, y32, nullptr, stages, bars, weights);
  conv<6, kUnit, kP32B, kP32B, kP32, kLPool, 1, kReluAdd>(y32, x32, nullptr, stages, bars, weights);
  conv<7, kUnit, kP32B, kP32B, kP32, kLPool, 1, kRelu>(x32, y32, nullptr, stages, bars, weights);
  conv<8, kUnit, kP32B, kPPl, kP32, kLPool, 0, kReluAddPlanes>(y32, planes, x32, stages, bars,
                                                                weights);

  // stride-2 residual block 32 -> 64: y = relu(conv_s2(x)), the shortcut
  // x' = conv1x1_s2(x), then x' += relu(conv(y)); first the halo columns
  // of y64 (region A) and x64 (region B past the planes)
  uint8_t* y64 = reg_a;
  uint8_t* x64 = reg_b + kX64Off;
  for (int i = tid; i < 8 * kRows * 2; i += kThreads) {
    const int cg = i / (kRows * 2);
    const int rem = i - cg * (kRows * 2);
    const int pos = (rem >> 1) * kP64 + (rem & 1) * (kP64 - 1);
    *reinterpret_cast<uint4*>(y64 + (cg * kP64B + pos) * 16) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(x64 + (cg * kP64B + pos) * 16) = make_uint4(0, 0, 0, 0);
  }
  conv<9, kDown, kPPl, kP64B, kP64, kLOut, 1, kRelu>(planes, y64, nullptr, stages, bars, weights);
  conv<10, kShort, kPPl, kP64B, kP64, kLOut, 1, kLinear>(planes, x64, nullptr, stages, bars,
                                                          weights);
  conv<11, kUnit, kP64B, kP64B, kP64, kLOut, 1, kReluAdd>(y64, x64, nullptr, stages, bars, weights);

  // 3 residual blocks at 64 channels, x in x64
  conv<12, kUnit, kP64B, kP64B, kP64, kLOut, 1, kRelu>(x64, y64, nullptr, stages, bars, weights);
  conv<13, kUnit, kP64B, kP64B, kP64, kLOut, 1, kReluAdd>(y64, x64, nullptr, stages, bars, weights);
  conv<14, kUnit, kP64B, kP64B, kP64, kLOut, 1, kRelu>(x64, y64, nullptr, stages, bars, weights);
  conv<15, kUnit, kP64B, kP64B, kP64, kLOut, 1, kReluAdd>(y64, x64, nullptr, stages, bars, weights);
  conv<16, kUnit, kP64B, kP64B, kP64, kLOut, 1, kRelu>(x64, y64, nullptr, stages, bars, weights);
  conv<17, kUnit, kP64B, kP64B, kP64, kLOut, 1, kReluAdd>(y64, x64, nullptr, stages, bars, weights);

  // out[a, l, c] += valid * x[c, l] for each valid row, the block's rows
  // of one allele (consecutive on the wire) summed in registers first
  for (int i = tid; i < kLOut * kCOut; i += kThreads) {
    const int l = i / kCOut;
    const int c = i - l * kCOut;
    const uint8_t* x = x64 + ((c >> 3) * kP64B + 1 + l) * 16 + (c & 7) * 2;
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (allele[r] < 0) continue;
      sum += valid[r] * __bfloat162float(
                            *reinterpret_cast<const __nv_bfloat16*>(x + r * kP64 * 16));
      if (r + 1 == kRows || allele[r + 1] != allele[r]) {
        atomicAdd(out + static_cast<size_t>(allele[r]) * kLOut * kCOut + i, sum);
        sum = 0.0f;
      }
    }
  }
}

}  // namespace rcw
