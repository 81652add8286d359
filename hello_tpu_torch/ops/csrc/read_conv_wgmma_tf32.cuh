// The two TF32 routes of read_conv_reduce (read_conv.cu, route ids 0 and 1)
// for Hopper: every conv a chain of wgmma.mma_async m64nNk8 tf32 products,
// A (the activations) from registers, B (the weights) from shared memory,
// where bulk copies on mbarriers stream it one tap at a time.  One template
// on the number of passes P serves both routes: kTF32x3 (P = 3, highest
// and high) and kTF32 (P = 1, default).  read_conv.cu includes this header
// for the kernel and mma_probe.cu for the fragment loads it probes.
//
// Replaces, at f32, the two Pallas TPU kernels of hello_tpu/ops/read_conv.py
// (_stem_kernel :252: three valid k3 convs with ReLU, C -> 16 -> 16 -> 32,
// and the k3 s2 max-pool; _tail_kernel :263: 3 residual blocks at 32
// channels, the stride-2 block 32 -> 64 with its 1x1 stride-2 shortcut, 3
// residual blocks at 64 channels and the per-allele masked sum) and the
// reduction after them.
//
// What bounds it: 5.08 M multiply-adds per read row (C = 6) against ~0.9 KB
// of uint8 input: operations.  For the kernel phase of chip_smoke.py
// (38,399 computed rows, 389.8 GFLOP) at the H100 SXM's 495 TFLOP/s dense
// TF32 peak: 2.36 ms for kTF32x3's three passes, 0.79 ms for kTF32's one.
// Above that: the products' real rate at each N (chip_smoke.py's probe
// measures wgmma m64nNk8 with A from registers), the weights, which every
// block reads again from L2 (kTF32x3: 922 KB per 5 rows, 7.1 GB for the
// kernel phase), and the block's work between its products (the split of
// A, epilogues, barriers, input, max-pool, atomics), which does not
// overlap them within a block, since one block holds an SM.  On an H100
// SXM at 700 W (chip_smoke.py, ops/read_conv_variants.py) kTF32x3 took
// 4.7 ms, its products 2.8 and the rest 1.9; kTF32 2.7, 0.9 and 1.8.
//
// Arithmetic.  Each activation x splits in registers into big = tf32(x) and
// small = tf32(x - big), both rounded to nearest with ties away from zero
// (cvt.rna's rounding).  The tensor cores read an fp32 bit pattern in tf32
// mode by dropping its 13 low mantissa bits, so rounding first is what
// makes big the nearest tf32 value and gives small its bits.  The fold
// (ops/read_conv.py pack_conv) does the same to the weights, so both images
// of B hold exact tf32 values.  kTF32x3 accumulates, per k-step, small*B_big
// + big*B_small + big*B_big in fp32, small terms first (the dropped
// small*small term is ~2^-22 relative); kTF32 only big*B_big.  The sums
// start at the fp32 bias; ReLU, residual adds, max-pool and the atomics
// are fp32.  The accumulation order differs from cuDNN's and the atomics'
// order from run to run, so kTF32x3 is held to rtol 1e-4 / atol 1e-3
// against read_conv_reduce_reference, the tolerance hello_tpu holds its
// Pallas kernel to (tests/test_pallas_ops.py), and kTF32 to at most twice
// cuDNN's own TF32 error.
//
// Design:
//   * Orientation.  out[positions][Co] = im2col(in)[positions][K] x
//     W^T[K][Co]: M = 64 positions per tile, N = Co (16, 32 or 64), K in
//     steps of 8.  kRows = 5 read rows are stacked along the positions,
//     each with its halo columns: the stem is 12 tiles, a 32-channel conv
//     6, a 64-channel conv 3, split evenly over 3 consumer warpgroups;
//     each warpgroup holds all its tiles' accumulators through a conv.
//   * A from registers.  .tf32 wgmma takes both shared-memory operands
//     K-major and reads them truncated, so A comes from registers: each
//     warp loads its 16 positions of a tile with plain shared loads, and
//     the split is done there.  One load serves all three products, and
//     wgmma reads only B from shared memory.  The register fragment of
//     m64nNk8 tf32 is mma.sync m16n8k8's A per warp: a0..a3 = (row g, col
//     t), (g + 8, t), (g, t + 4), (g + 8, t + 4) for lane 4 g + t.
//   * Activations are fp32, position-major, [position][channels], 16-byte
//     chunks of 4 channels XOR-swizzled by the position's parity when a
//     row has 32 or 64 channels (at<CI>): one 16-byte load per row gives a
//     thread its columns of two k-steps, and the 8 lanes of a quarter warp
//     (two positions) hit distinct banks.  The fold orders each 16 channels
//     of a tap so that this works: k-step 2j + h, column t (t + 4) is
//     channel 16 j + 4 t + 2 h (+ 1).  Stem conv 1 reads its input as
//     [position][8] (C channels, then zeros), one tap per k-step, K = 24:
//     column t (t + 4) is channel 2 t (+ 1).  The stride-2 conv and the 1x1
//     stride-2 shortcut read the 32-channel rows at 2 p + tap and 2 p + 1.
//   * Weights.  The fold writes each conv as units of one tap (stem conv
//     1 and the shortcut: one unit), each the B operand's shared-memory
//     image, [K/4][Co][4] fp32 (a K-major core matrix is 8 output channels
//     x 4 K values, 128 bytes; LBO = Co x 16 B, SBO = 128 B), big then
//     small for kTF32x3; the conv's fp32 bias follows its units.  One
//     thread of a producer warpgroup streams the 50 units through a ring
//     of two stages with cp.async.bulk, each completing on its stage's
//     full mbarrier; each consumer warpgroup arrives on the stage's empty
//     mbarrier once its products of the unit are done, and the producer
//     waits for all three before it refills the stage.  No block barrier
//     per tap: one barrier of the consumer warps per conv publishes its
//     outputs.
//   * Shared memory (kTF32x3 and kTF32 alike): activations 148,736 B in two
//     regions (A: the input, stem conv 2's output, x32; B: stem conv 1's
//     and 3's outputs, y32, then y64 and x64), two stages of 32,768 B (one
//     tap of a 64-channel conv, big and small) and four mbarriers: 214,304
//     B and one 512-thread block per SM.  A whole kTF32x3 conv (98,304 B)
//     does not fit twice beside 5 rows of fp32 activations; one tap does.
//   * Products in flight.  A warpgroup issues, per tile, the products of
//     one A load (kTF32x3: two k-steps, 6 products) or two (kTF32: four
//     k-steps, 4 products) as one commit group, and waits for it before
//     the next group's loads write A registers: ptxas does not keep the
//     register operands of a product in flight (a version that waited one
//     group later computed wrong values with two loads per group), so the
//     loads and the products overlap between warpgroups, not within one.
//   * Registers.  The producer is a whole warpgroup: setmaxnreg leaves
//     its warps 24 registers a thread and gives the consumers 160 (the
//     launch allows 128 to each of 16 warps), so that kTF32x3 keeps its
//     accumulators and split fragments without spilling.
//   * Epilogues on the accumulators: bias (their initial value), ReLU,
//     residual add, the linear shortcut, two channels per 8-byte store.
//     Halo and spare positions are computed and never stored; every buffer
//     has room for the reads of the last tile, whose extra rows read stale
//     values that only those rows' outputs see.  The block's rows of one
//     allele (consecutive on the wire) are summed in registers before the
//     fp32 atomics, out[a] += row_valid[r] * frame(r).  Rows with
//     row_valid == 0 or row_allele outside [0, A) add nothing, and a block
//     of only such rows returns at once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_ptx.cuh"

namespace rct {

using namespace wgx;

constexpr int kRows = 5;                  // read rows per block
constexpr int kWarpgroups = 3;            // consumer warpgroups
constexpr int kConsumers = 128 * kWarpgroups;
// the producer: a whole warpgroup (one thread of it streams the weights),
// so that setmaxnreg can give its registers to the consumers
constexpr int kProducerWarps = 4;
constexpr int kThreads = kConsumers + 32 * kProducerWarps;
constexpr int kProducerRegs = 24;         // registers a thread, after setmaxnreg
constexpr int kConsumerRegs = 160;
constexpr int kTile = 64;                 // positions per wgmma tile (M)
// most A loads of a tile per commit group: kTF32x3 issues 6 products a
// load, kTF32 2 (read_conv_variants.py measured 1 and 2 the faster)
constexpr int kLoads3 = 1;
constexpr int kLoads1 = 2;

constexpr int kLIn = 150;
constexpr int kLPool = 71;                // (144 - 3) / 2 + 1
constexpr int kLOut = 36;                 // (71 + 2 - 3) / 2 + 1
constexpr int kCOut = 64;
constexpr int kP32 = 76;                  // row stride, 32 channels: halo, 71, halo, 3 spare
constexpr int kP64 = 38;                  // row stride, 64 channels: halo, 36, halo

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
// the largest divisor of n that is at most m
__host__ __device__ constexpr int divisor_upto(int n, int m) {
  return n % m == 0 ? m : divisor_upto(n, m - 1);
}
// wgmma tiles of a conv whose outputs are q = r * pq + l, l < lo, r < kRows
__host__ __device__ constexpr int tiles(int pq, int lo) {
  return cdiv((kRows - 1) * pq + lo, kTile);
}

// Positions of each buffer: past the last tile's reads (taps 0..2; the
// stride-2 conv reads 2 p + 2)
constexpr int kPIn = tiles(kLIn, 148) * kTile + 2;     // input [pos][8]
constexpr int kPS = tiles(kLIn, 146) * kTile + 2;      // stem outputs
constexpr int kP32B = tiles(kP32, kLPool) * kTile + 2; // x32, y32
constexpr int kP64B = tiles(kP64, kLOut) * kTile + 2;  // x64, y64

// Regions, in floats.  A: the input, stem conv 2's output, x32.  B: stem
// conv 1's and 3's outputs, y32, then y64 and x64 (x64 after y64).
constexpr int kRegA = imax(imax(kPIn * 8, kPS * 16), kP32B * 32);
constexpr int kRegB = imax(imax(kPS * 32, kP32B * 32), 2 * kP64B * 64);
constexpr int kX64Off = kP64B * 64;

// The 18 convs in the fold's order (stem 1-3, 6 x RB32, the stride-2 conv,
// its second conv, the 1x1 shortcut, 6 x RB64): K as the products take it,
// Co, and the units (taps) the weights are streamed in.  Each conv is, in
// the flat buffer, its units (K / units x Co floats of image, big, then
// small for P = 3), then Co floats of bias (ops/read_conv.py pack_conv).
__host__ __device__ constexpr int conv_k(int i) {
  return i == 0 ? 24 : i <= 2 ? 48 : i <= 9 ? 96 : i == 10 ? 192 : i == 11 ? 32 : 192;
}
__host__ __device__ constexpr int conv_co(int i) { return i <= 1 ? 16 : i <= 8 ? 32 : 64; }
__host__ __device__ constexpr int conv_units(int i) { return i == 0 || i == 11 ? 1 : 3; }
// images of B per unit: big and small (P = 3), or big
__host__ __device__ constexpr int parts(int passes) { return passes == 3 ? 2 : 1; }
template <int P>
__host__ __device__ constexpr int unit_floats(int i) {
  return conv_k(i) / conv_units(i) * conv_co(i) * parts(P);
}
template <int P>
__host__ __device__ constexpr int conv_off(int i) {
  int off = 0;
  for (int j = 0; j < i; ++j) off += conv_k(j) * conv_co(j) * parts(P) + conv_co(j);
  return off;
}
constexpr int kNumConvs = 18;
// the order the kernel runs them: the shortcut (11) before the second conv
// of the stride-2 block (10)
__host__ __device__ constexpr int exec_conv(int step) {
  return step == 10 ? 11 : step == 11 ? 10 : step;
}
// the first unit of step `step` in the order the producer streams them
__host__ __device__ constexpr int first_unit(int step) {
  int u = 0;
  for (int s = 0; s < step; ++s) u += conv_units(exec_conv(s));
  return u;
}
constexpr int kUnits = first_unit(kNumConvs);   // 50
constexpr int kStage = 64 * 64 * 4 * 2;         // the largest unit: one tap, big and small
constexpr int kStages = 2;
constexpr int kSmemBytes = (kRegA + kRegB) * 4 + kStages * kStage + 2 * kStages * 8;

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

// D[64][N] += A[64][8] B[8][N], tf32: A from registers (the m16n8k8 A
// fragment per warp), B from shared memory (K-major), fp32 accumulators in
// the m64nNk8 fragment: d[4 j + 2 h + e] is row 16 warp + lane / 4 + 8 h,
// column 8 j + 2 (lane % 4) + e
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// B descriptor of k-step s of an image of n output channels whose k-step 0
// descriptor is d0: the start address (16-byte units, bits 0-13) s x 2n on
__device__ __forceinline__ uint64_t b_step(uint64_t d0, int n, int s) {
  return d0 + static_cast<uint64_t>(s * 2 * n);
}
// B descriptor of k-step s of an image of n output channels at `addr`
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, int n, int s) {
  return b_step(make_desc(addr, n * 16, 128), n, s);
}

// fp32 -> TF32 bits, round to nearest with ties away from zero: what
// cvt.rna.tf32.f32 gives for finite inputs, in two integer ops
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the consumer warps' barrier (the producer warpgroup has left)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ---------------------------------------------------------------------------
// Activations and A fragments
// ---------------------------------------------------------------------------

// How a conv reads its input: kUnit, a k = 3 conv with stride 1 (tap t: t
// positions on); kStem1, the [pos][8] input, one tap per k-step; kDown, the
// stride-2 conv (2 p + tap); kShort, the 1x1 stride-2 shortcut (2 p + 1).
enum AKind { kUnit = 0, kStem1 = 1, kDown = 2, kShort = 3 };
// What the epilogue stores: relu; out += relu (the residual add); linear.
enum Epi { kRelu = 0, kReluAdd = 1, kLinear = 2 };

// Float index of (position, channel) in a [position][CI] buffer: the
// 16-byte chunk of 4 channels XOR the position's parity x 4 for CI >= 32
template <int CI>
__host__ __device__ constexpr int at(int pos, int ch) {
  return pos * CI + ((((ch >> 2) ^ (CI >= 32 ? (pos & 1) << 2 : 0))) << 2) + (ch & 3);
}

// input position that output position p reads at tap `tap`
template <int KIND>
__device__ __forceinline__ int in_pos(int p, int tap) {
  return KIND == kDown ? 2 * p + tap : KIND == kShort ? 2 * p + 1 : p + tap;
}

// k-steps of one A load: two (16 channels of a tap) or, for stem conv 1,
// one (its 8 input channels)
template <int KIND>
__host__ __device__ constexpr int load_steps() { return KIND == kStem1 ? 1 : 2; }

// A fragments, big and (P = 3) small parts, of the load_steps k-steps from
// k-step `s` (even unless stem conv 1) of tap `tap`, for the warp's rows p
// and p + 8 (p = the tile's first position + 16 warp + lane / 4).  Lane
// 4 g + t reads channels 16 j + 4 t .. + 3 of both rows (j = s / 2), or,
// for stem conv 1, channels 2 t and 2 t + 1 at tap s.
template <int KIND, int CI, int P>
__device__ __forceinline__ void load_a(const float* in, int p, int tap, int s,
                                       uint32_t (&big)[2][4], uint32_t (&small)[2][4]) {
  const int t = threadIdx.x & 3;
  float x[2][4];
  if constexpr (KIND == kStem1) {
    const float2 lo = *reinterpret_cast<const float2*>(in + (p + s) * 8 + 2 * t);
    const float2 hi = *reinterpret_cast<const float2*>(in + (p + 8 + s) * 8 + 2 * t);
    x[0][0] = lo.x; x[0][1] = hi.x; x[0][2] = lo.y; x[0][3] = hi.y;
    x[1][0] = x[1][1] = x[1][2] = x[1][3] = 0.0f;
  } else {
    const int ch = 8 * s + 4 * t;
    const float4 lo = *reinterpret_cast<const float4*>(in + at<CI>(in_pos<KIND>(p, tap), ch));
    const float4 hi = *reinterpret_cast<const float4*>(in + at<CI>(in_pos<KIND>(p + 8, tap), ch));
    x[0][0] = lo.x; x[0][1] = hi.x; x[0][2] = lo.y; x[0][3] = hi.y;
    x[1][0] = lo.z; x[1][1] = hi.z; x[1][2] = lo.w; x[1][3] = hi.w;
  }
#pragma unroll
  for (int h = 0; h < load_steps<KIND>(); ++h) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      big[h][e] = tf32_rna(x[h][e]);
      if constexpr (P == 3) small[h][e] = tf32_rna(x[h][e] - __uint_as_float(big[h][e]));
    }
  }
}

// ---------------------------------------------------------------------------
// The producer
// ---------------------------------------------------------------------------

// One thread: the 50 units of the run, in order, through the ring: unit u
// into stage u % kStages once the consumers have released unit u - kStages.
template <int P>
__device__ __forceinline__ void produce(uint8_t* stages, uint64_t* full, uint64_t* empty,
                                        const float* __restrict__ weights) {
  int u = 0;
  for (int step = 0; step < kNumConvs; ++step) {
    const int i = exec_conv(step);
    const int n = unit_floats<P>(i);
    for (int t = 0; t < conv_units(i); ++t, ++u) {
      const int s = u % kStages;
      if (u >= kStages) mbar_wait(empty + s, ((u / kStages) + 1) & 1);
      bulk_load(stages + s * kStage, weights + conv_off<P>(i) + t * n, n * 4, full + s);
    }
  }
}

// ---------------------------------------------------------------------------
// One conv
// ---------------------------------------------------------------------------

// Conv STEP of the run (conv exec_conv(STEP) of the fold), over the block's
// rows: outputs q = r * PQ + l (r < kRows, l < LO) to `out` ([pos][Co]) at
// q + OUT_OFF, from `in` ([pos][CI]).  Per unit (tap): waits for its stage,
// runs the warpgroup's tiles through its k-steps, and releases the stage
// once those products are done; then the epilogue, and one barrier of the
// consumer warps publishes the outputs.
template <int P, int STEP, int KIND, int CI, int PQ, int LO, int OUT_OFF, int EPI>
__device__ __forceinline__ void conv(const float* in, float* out, uint8_t* stages,
                                     uint64_t* full, uint64_t* empty,
                                     const float* __restrict__ weights) {
  constexpr int I = exec_conv(STEP);
  constexpr int CO = conv_co(I);
  constexpr int UNITS = conv_units(I);
  constexpr int U0 = first_unit(STEP);
  constexpr int KU = conv_k(I) / UNITS;     // K of one unit
  constexpr int KS = KU / 8;                // its k-steps
  constexpr int LS = load_steps<KIND>();
  constexpr int G = divisor_upto(KS / LS, P == 3 ? kLoads3 : kLoads1);   // A loads a group
  constexpr int TILES = tiles(PQ, LO);
  constexpr int TPW = TILES / kWarpgroups;
  static_assert(TILES % kWarpgroups == 0, "tiles split evenly over the warpgroups");
  static_assert(KS % LS == 0 && (KIND == kStem1 ? CI == 8 && KS == 3 : KU == CI),
                "a unit is one tap (stem conv 1: its three taps)");
  static_assert(unit_floats<P>(I) * 4 <= kStage, "a stage holds the unit");

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const float* bias = weights + conv_off<P>(I) + conv_k(I) * CO * parts(P);
  const int p0 = wg * TPW * kTile + warp * 16 + g;

  float acc[TPW][CO / 2];
#pragma unroll
  for (int j = 0; j < CO / 8; ++j) {
    const float bj0 = __ldg(bias + 8 * j + 2 * qd);
    const float bj1 = __ldg(bias + 8 * j + 2 * qd + 1);
#pragma unroll
    for (int t = 0; t < TPW; ++t) {
      acc[t][4 * j] = bj0;
      acc[t][4 * j + 1] = bj1;
      acc[t][4 * j + 2] = bj0;
      acc[t][4 * j + 3] = bj1;
    }
  }
#pragma unroll
  for (int t = 0; t < TPW; ++t) fence_operands(acc[t]);

#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    const int stage = (U0 + u) % kStages;
    mbar_wait(full + stage, ((U0 + u) / kStages) & 1);
    const uint32_t b0 = smem_addr(stages + stage * kStage);
    const uint64_t d_big = b_desc(b0, CO, 0);
    const uint64_t d_small = b_desc(b0 + KU * CO * 4, CO, 0);
#pragma unroll
    for (int s = 0; s < KS; s += LS * G) {
#pragma unroll
      for (int t = 0; t < TPW; ++t) {
        uint32_t big[G][2][4], small[G][2][4];
#pragma unroll
        for (int i = 0; i < G; ++i) {
          // stem conv 1's unit holds its three taps, one per k-step
          load_a<KIND, CI, P>(in, p0 + t * kTile, KIND == kStem1 ? 0 : u, s + i * LS, big[i],
                              small[i]);
        }
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < G; ++i) {
#pragma unroll
          for (int h = 0; h < LS; ++h) {
            const uint64_t bb = b_step(d_big, CO, s + i * LS + h);
            if constexpr (P == 3) {
              wgmma_tf32<CO>(acc[t], small[i][h], bb);
              wgmma_tf32<CO>(acc[t], big[i][h], b_step(d_small, CO, s + i * LS + h));
            }
            wgmma_tf32<CO>(acc[t], big[i][h], bb);
          }
        }
        wgmma_commit();
        // the next group's loads write A registers: ptxas does not keep an
        // in-flight product's register operands, so the group is waited
        // for here (the other warpgroups' products fill the tensor cores)
        wgmma_wait<0>();
      }
    }
    // every product of the unit is done: release its stage
    mbar_arrive(empty + stage, (tid & 127) == 0);
  }
#pragma unroll
  for (int t = 0; t < TPW; ++t) fence_operands(acc[t]);

#pragma unroll
  for (int t = 0; t < TPW; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + t * kTile + 8 * h;
      const int r = p / PQ;
      const int l = p - r * PQ;
      if (r >= kRows || l >= LO) continue;
      const int dst = p + OUT_OFF;
#pragma unroll
      for (int j = 0; j < CO / 8; ++j) {
        const float v0 = acc[t][4 * j + 2 * h];
        const float v1 = acc[t][4 * j + 2 * h + 1];
        float2* o = reinterpret_cast<float2*>(out + at<CO>(dst, 8 * j + 2 * qd));
        if (EPI == kRelu) {
          *o = make_float2(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
        } else if (EPI == kLinear) {
          *o = make_float2(v0, v1);
        } else {
          const float2 x = *o;
          *o = make_float2(x.x + fmaxf(v0, 0.0f), x.y + fmaxf(v1, 0.0f));
        }
      }
    }
  }
  consumer_sync();
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int C, int P>
__global__ void __launch_bounds__(kThreads, 1) read_conv_reduce_tf32(
    const uint8_t* __restrict__ rows, int nb, const int32_t* __restrict__ row_allele,
    const float* __restrict__ row_valid, const float* __restrict__ weights,
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
  float* reg_a = reinterpret_cast<float*>(smem);
  float* reg_b = reg_a + kRegA;
  uint8_t* stages = reinterpret_cast<uint8_t*>(reg_b + kRegB);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kWarpgroups);
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (tid >= kConsumers) {
    if constexpr (kProducerWarps == 4) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    }
    if (tid == kConsumers) produce<P>(stages, full, empty, weights);
    return;
  }
  if constexpr (kProducerWarps == 4) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  }

  // uint8 rows [kRows * 150][C] -> fp32 [pos][8] in region A: C channels,
  // then zeros; positions past the block's rows are zero
  {
    const int n_pos = min(kRows, nb - r0) * kLIn;
    const uint8_t* src = rows + static_cast<size_t>(r0) * kLIn * C;
    for (int p = tid; p < kPIn; p += kConsumers) {
      float v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = (p < n_pos && c < C) ? static_cast<float>(src[p * C + c]) : 0.0f;
      float4* d = reinterpret_cast<float4*>(reg_a + p * 8);
      d[0] = make_float4(v[0], v[1], v[2], v[3]);
      d[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  consumer_sync();

  // stem: three valid k3 convs with ReLU, positions q = r * 150 + l
  conv<P, 0, kStem1, 8, kLIn, 148, 0, kRelu>(reg_a, reg_b, stages, full, empty, weights);
  conv<P, 1, kUnit, 16, kLIn, 146, 0, kRelu>(reg_b, reg_a, stages, full, empty, weights);
  conv<P, 2, kUnit, 16, kLIn, 144, 0, kRelu>(reg_a, reg_b, stages, full, empty, weights);

  // max-pool k3 s2: 32 x 144 per row -> x32 rows [halo, 71, halo, 3 spare]
  // in region A, 4 channels per thread and item
  float* x32 = reg_a;
  float* y32 = reg_b;
  for (int i = tid; i < 8 * kP32B; i += kConsumers) {
    const int pos = i >> 3;
    const int c = (i & 7) * 4;
    const int r = pos / kP32;
    const int col = pos - r * kP32;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < kRows && col >= 1 && col <= kLPool) {
      const int s = r * kLIn + 2 * (col - 1);
      const float4 a = *reinterpret_cast<const float4*>(reg_b + at<32>(s, c));
      const float4 b = *reinterpret_cast<const float4*>(reg_b + at<32>(s + 1, c));
      const float4 d = *reinterpret_cast<const float4*>(reg_b + at<32>(s + 2, c));
      v = make_float4(fmaxf(fmaxf(a.x, b.x), d.x), fmaxf(fmaxf(a.y, b.y), d.y),
                      fmaxf(fmaxf(a.z, b.z), d.z), fmaxf(fmaxf(a.w, b.w), d.w));
    }
    *reinterpret_cast<float4*>(x32 + at<32>(pos, c)) = v;
  }
  consumer_sync();
  // y32's halo and spare columns (0, 72..75), which the convs never write
  for (int i = tid; i < kRows * 5 * 8; i += kConsumers) {
    const int r = i / 40;
    const int h = (i - r * 40) >> 3;
    const int pos = r * kP32 + (h == 0 ? 0 : kLPool + h);
    *reinterpret_cast<float4*>(y32 + at<32>(pos, (i & 7) * 4)) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  // 3 residual blocks at 32 channels: x += relu(conv(relu(conv(x))))
  conv<P, 3, kUnit, 32, kP32, kLPool, 1, kRelu>(x32, y32, stages, full, empty, weights);
  conv<P, 4, kUnit, 32, kP32, kLPool, 1, kReluAdd>(y32, x32, stages, full, empty, weights);
  conv<P, 5, kUnit, 32, kP32, kLPool, 1, kRelu>(x32, y32, stages, full, empty, weights);
  conv<P, 6, kUnit, 32, kP32, kLPool, 1, kReluAdd>(y32, x32, stages, full, empty, weights);
  conv<P, 7, kUnit, 32, kP32, kLPool, 1, kRelu>(x32, y32, stages, full, empty, weights);
  conv<P, 8, kUnit, 32, kP32, kLPool, 1, kReluAdd>(y32, x32, stages, full, empty, weights);

  // stride-2 residual block 32 -> 64: y = relu(conv_s2(x)), the shortcut
  // x' = conv1x1_s2(x), then x' += relu(conv(y)); first the halo columns
  // (0, 37) of y64 and x64 in region B
  float* y64 = reg_b;
  float* x64 = reg_b + kX64Off;
  for (int i = tid; i < kRows * 2 * 16; i += kConsumers) {
    const int r = i >> 5;
    const int pos = r * kP64 + ((i >> 4) & 1) * (kP64 - 1);
    const int c = (i & 15) * 4;
    *reinterpret_cast<float4*>(y64 + at<64>(pos, c)) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<float4*>(x64 + at<64>(pos, c)) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  conv<P, 9, kDown, 32, kP64, kLOut, 1, kRelu>(x32, y64, stages, full, empty, weights);
  conv<P, 10, kShort, 32, kP64, kLOut, 1, kLinear>(x32, x64, stages, full, empty, weights);
  conv<P, 11, kUnit, 64, kP64, kLOut, 1, kReluAdd>(y64, x64, stages, full, empty, weights);

  // 3 residual blocks at 64 channels, x in x64
  conv<P, 12, kUnit, 64, kP64, kLOut, 1, kRelu>(x64, y64, stages, full, empty, weights);
  conv<P, 13, kUnit, 64, kP64, kLOut, 1, kReluAdd>(y64, x64, stages, full, empty, weights);
  conv<P, 14, kUnit, 64, kP64, kLOut, 1, kRelu>(x64, y64, stages, full, empty, weights);
  conv<P, 15, kUnit, 64, kP64, kLOut, 1, kReluAdd>(y64, x64, stages, full, empty, weights);
  conv<P, 16, kUnit, 64, kP64, kLOut, 1, kRelu>(x64, y64, stages, full, empty, weights);
  conv<P, 17, kUnit, 64, kP64, kLOut, 1, kReluAdd>(y64, x64, stages, full, empty, weights);

  // out[a, l, c] += valid * x[c, l] for each valid row, the block's rows
  // of one allele (consecutive on the wire) summed in registers first
  for (int i = tid; i < kLOut * kCOut; i += kConsumers) {
    const int l = i / kCOut;
    const int c = i - l * kCOut;
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (allele[r] < 0) continue;
      sum += valid[r] * x64[at<64>(r * kP64 + 1 + l, c)];
      if (r + 1 == kRows || allele[r + 1] != allele[r]) {
        atomicAdd(out + static_cast<size_t>(allele[r]) * kLOut * kCOut + i, sum);
        sum = 0.0f;
      }
    }
  }
}

}  // namespace rct
