// The bf16 route of read_conv_reduce for the wide read convolver (HELLO's
// architectures/read_convolver_wide.py: the standard topology with every
// channel count doubled, 32 / 64 / 128 channels) on Hopper: read_conv.cu's
// read_conv_reduce_wide_run.  Every conv a wgmma.mma_async m64nNk16 bf16
// product from shared memory; the weights streamed by bulk copies that
// complete on mbarriers.  It shares only the PTX helpers of wgmma_ptx.cuh
// with the width-1 kernel (read_conv_wgmma.cuh), whose plan does not fit
// twice the channels.
//
// Replaces no TPU kernel: hello_tpu's Pallas kernel (hello_tpu/ops/
// read_conv.py) is width-1 only, and hello_tpu runs the wide read convolver
// through its XLA layers.  The port ran it through its layer modules
// (cuDNN's fp32 convs on bf16-valued operands, then separate rounding, add,
// ReLU and cast passes over fp32 activations of every row, then
// nn/moe.ordered_read_reduce); this kernel fuses the 18 convs, the max-pool
// and the per-allele sum into one launch.
//
// What bounds it: 20.2 M multiply-adds per read row (C = 6; 40.4 MFLOP, the
// 18 convs at 32 / 64 / 128 channels) against ~0.9 KB of uint8 input:
// operations.  For the benchmark's batch of 81,900 reads, 3.31 TFLOP: 3.35
// ms at the H100 SXM's 989 TFLOP/s dense bf16 peak.  Two more ceilings:
// the weights (460,352 bf16 values, 920 KB, 754 KB of them in the
// 36-position tail) cross from L2 into shared memory once per group of
// kRows rows, 920 KB x 81,900 / 5 = 15 GB a batch, about 3 ms at ~5 TB/s of
// L2 bandwidth, overlapped with the products by the ring of stages; and the
// block's work between products (epilogues, barriers, the max-pool, the
// input) adds to the time, since one block holds an SM.
//
// Arithmetic, as the width-1 bf16 route and read_convolver_reference round:
// weights bf16 (rounded at fold time), activations bf16 in shared memory
// (the uint8 input is exact in bf16), products exact, sums in fp32
// registers that start at the fp32 bias; each conv's sum rounded to bf16
// once; a residual add rounds the branch and then the sum, and so does y +
// shortcut; the max-pool compares bf16 values; the frames leave as bf16
// values and are summed per allele in fp32, out[a] = sum of row_valid[r] *
// frame(r) over the allele's rows, in row order within each group of rows
// and group after group.  Rows with row_valid == 0
// or row_allele outside [0, A) are never computed.
//
// Design (one 384-thread block per SM, 3 warpgroups):
//   * Blocks own whole alleles.  Block b nominally covers the rows [b kSpan,
//     (b + 1) kSpan) of the wire; it starts at the first row there that
//     begins a run of one row_allele value and ends where block b + 1
//     starts, so every allele whose rows are consecutive (the coded wire's
//     packed rows and the dense [A, R] grid) lies in one block.  The block
//     walks its rows in groups of kRows computed rows (rows that add
//     nothing are skipped).  At the end of a group each thread sums, for
//     its 12 values of the [36][128] frame, the group's rows of each
//     allele in row order and adds that to the zero-filled output: one
//     thread adds to an output value, group after group, in row order, so
//     the sums are the same bits on every run and under graph replay, with
//     no second pass and no host sync.  (Rows of one allele that are not
//     consecutive still add up right, in an order the blocks set.)
//   * Orientation as the width-1 kernel: out[positions][Co] = im2col(in)
//     [positions][K] x W^T[K][Co]; M = 64 positions of the group's kRows =
//     5 rows stacked with their halos (the stem 12 tiles, the 64-channel
//     blocks 6, the 128-channel tail 3), N = Co = 32, 64 or 128, K in steps
//     of 16.  Activations bf16 in [channel group of 8][position][8 channels]
//     buffers: a no-swizzle K-major core matrix per 8 positions x 8
//     channels; tap t is the same descriptor 16 t bytes on; the last
//     64-channel add writes even and odd planes for the stride-2 conv and
//     its shortcut.
//   * Shared memory: three regions of 51,200 B hold every buffer (the stem
//     conv 3's 64 x 776 output takes two), reused in turn; two weight
//     stages of 32,768 B (the most a block can keep beside them: 219,152 B
//     in all).  A conv whose weights exceed a stage (the stride-2 conv and
//     the 128-channel convs, 48 to 96 KB) streams them one tap at a time:
//     a stage holds a K-slice of 128 x 128 (or 64 x 128) bf16, and the
//     warpgroup's accumulators (one 64 x 128 tile, 64 registers) stay live
//     across the three slices, so N stays 128 and each A tile is read once
//     per k-step.  34 slices a group in a ring of two stages: the copy of
//     slice n + 1 is in flight while slice n computes; a block barrier after
//     each slice frees its stage for slice n + 2 (of the next group too).
//   * Biases are read from the weight buffer in global memory (L1).
//
// What it leaves (ops/read_conv_variants.py --route wide --mix cell, the
// benchmark cell's 81,900 reads on an H100 SXM: 9.05 ms, 37% of the 3.35 ms
// bound): without its products the block takes 3.76 ms, without products
// and epilogues 2.26 ms, and the weights' traffic costs 0.4 ms.  The
// barriers (34 a group) drain the warpgroups' products before each refill,
// and the epilogues, the pool and the input do not overlap the products; a
// producer warp with empty barriers, and the weights multicast to a 2-block
// cluster (half the L2 traffic), would.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_ptx.cuh"

namespace rcw2 {

using namespace wgx;

constexpr int kRows = 5;                  // computed read rows per group
constexpr int kSpan = 40;                 // rows of the wire a block nominally covers
constexpr int kWarpgroups = 3;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTile = 64;                 // positions per wgmma tile (M)

constexpr int kLIn = 150;
constexpr int kLPool = 71;                // (144 - 3) / 2 + 1
constexpr int kLOut = 36;                 // (71 + 2 - 3) / 2 + 1
constexpr int kCOut = 128;
constexpr int kPMid = 76;                 // row stride, 64 channels: halo, 71, halo, 3 spare
constexpr int kPTail = 38;                // row stride, 128 channels: halo, 36, halo

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int round8(int n) { return cdiv(n, 8) * 8; }
constexpr int kOdd = round8(kRows * kPTail);  // the odd plane's first position
// wgmma tiles of a conv whose outputs are q = r * pq + l, l < lo, r < kRows
__host__ __device__ constexpr int tiles(int pq, int lo) {
  return cdiv((kRows - 1) * pq + lo, kTile);
}

// Positions of each buffer: past the last tile's reads
constexpr int kPIn = round8(tiles(kLIn, 148) * kTile + 3);       // input [pos][8]
constexpr int kPS = round8(tiles(kLIn, 146) * kTile + 2);        // stem outputs
constexpr int kPMidB = round8(tiles(kPMid, kLPool) * kTile + 2); // x64, y64
constexpr int kPPl = kOdd + tiles(kPTail, kLOut) * kTile;        // even | odd planes
constexpr int kPTailB = round8(tiles(kPTail, kLOut) * kTile + 2);  // x128, y128

// bytes of a buffer of `ch` channels over `pos` positions
__host__ __device__ constexpr int buf_bytes(int ch, int pos) { return ch / 8 * pos * 16; }

// Three regions of kReg bytes.  R3: the input, stem conv 2's output, x64,
// x128.  R1: stem conv 1's output, y64, y128; stem conv 3's output spans
// R1 and R2.  R2: the planes.
constexpr int kReg = imax(imax(imax(buf_bytes(8, kPIn), buf_bytes(32, kPS)),
                               imax(buf_bytes(64, kPMidB), buf_bytes(64, kPPl))),
                          buf_bytes(128, kPTailB));
static_assert(buf_bytes(64, kPS) <= 2 * kReg, "stem conv 3's output fits R1 and R2");

// The 18 convs in the fold's order (stem 1-3, 6 x RB64, the stride-2 conv,
// its second conv, the 1x1 shortcut, 6 x RB128): K as the products take it
// and Co; each is K x Co bf16 of image, then Co fp32 of bias, in the flat
// buffer (ops/read_conv.py pack_conv, as for the width-1 kernel).
__host__ __device__ constexpr int conv_k(int i) {
  return i == 0 ? 32 : i <= 2 ? 96 : i <= 9 ? 192 : i == 10 ? 384 : i == 11 ? 64 : 384;
}
__host__ __device__ constexpr int conv_co(int i) { return i <= 1 ? 32 : i <= 8 ? 64 : 128; }
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
constexpr int kStage = 128 * 128 * 2;     // one tap of a 128 -> 128 conv
constexpr int kStages = 2;                // the ring of weight stages
// the slices a conv's weights stream in: one, or one per tap
__host__ __device__ constexpr int conv_units(int i) { return image_bytes(i) > kStage ? 3 : 1; }
__host__ __device__ constexpr int unit_bytes(int i) { return image_bytes(i) / conv_units(i); }
// slices of the run's steps before `step`
__host__ __device__ constexpr int units_before(int step) {
  return step == 0 ? 0 : units_before(step - 1) + conv_units(exec_conv(step - 1));
}
constexpr int kUnits = units_before(kNumConvs);   // slices a group
static_assert(kUnits % kStages == 0, "each group starts on stage 0");
// the step, and the slice within it, of the group's slice j
__host__ __device__ constexpr int unit_step(int j) {
  int s = 0;
  while (j >= conv_units(exec_conv(s))) {
    j -= conv_units(exec_conv(s));
    ++s;
  }
  return s;
}
__host__ __device__ constexpr int unit_sub(int j) { return j - units_before(unit_step(j)); }

constexpr int kSmemBytes = 3 * kReg + kStages * kStage + kStages * 8;

// ---------------------------------------------------------------------------
// PTX wrappers (the shared ones are in wgmma_ptx.cuh)
// ---------------------------------------------------------------------------

// D[64][N] += A[64][16] B[16][N], bf16 operands from shared memory (both
// K-major), fp32 accumulators in the m64nNk16 fragment: d[4 j + 2 h + e] is
// row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b);

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

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
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
// The group's rows
// ---------------------------------------------------------------------------

// One warp: the first row at or after `from` (below nb) that begins a run
// of one row_allele value, or nb
__device__ __forceinline__ int run_start(const int32_t* __restrict__ row_allele, int nb,
                                         int from) {
  const int lane = threadIdx.x & 31;
  for (int base = from; base < nb; base += 32) {
    const int r = base + lane;
    const bool starts = r < nb && (r == 0 || row_allele[r] != row_allele[r - 1]);
    const unsigned m = __ballot_sync(0xffffffffu, starts);
    if (m) return base + __ffs(m) - 1;
  }
  return nb;
}

// What a group computes: its rows (at most kRows, in wire order), their
// alleles and validities, whether another group follows, and where the
// next group's search starts
struct Group {
  int idx[kRows];
  int allele[kRows];
  float valid[kRows];
  int n;
  int more;
  int cursor;
};

// One warp: the next kRows computed rows from g->cursor, below `end`, and
// whether one more follows them
__device__ __forceinline__ void next_group(Group* g, const int32_t* __restrict__ row_allele,
                                           const float* __restrict__ row_valid, int end,
                                           int num_alleles) {
  const int lane = threadIdx.x & 31;
  int found = 0;
  int cursor = end;
  for (int base = g->cursor; found <= kRows && base < end; base += 32) {
    const int r = base + lane;
    int a = -1;
    float v = 0.0f;
    if (r < end) {
      a = row_allele[r];
      v = row_valid[r];
    }
    const bool ok = r < end && a >= 0 && a < num_alleles && v != 0.0f;
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    const int rank = found + __popc(m & ((1u << lane) - 1u));
    if (ok && rank < kRows) {
      g->idx[rank] = r;
      g->allele[rank] = a;
      g->valid[rank] = v;
    }
    // the lane of the group's last row: the next search starts after it
    const unsigned end_lane = __ballot_sync(0xffffffffu, ok && rank == kRows - 1);
    if (end_lane) cursor = __shfl_sync(0xffffffffu, r + 1, __ffs(end_lane) - 1);
    found += __popc(m);
  }
  __syncwarp();
  if (lane == 0) {
    g->n = found < kRows ? found : kRows;
    g->more = found > kRows;
    g->cursor = cursor;
  }
  __syncwarp();
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
// (the shortcut); or the residual add of the last 64-channel block, read
// from x64 and written to the even / odd planes.
enum Epi { kRelu = 0, kReluAdd = 1, kLinear = 2, kReluAddPlanes = 3 };

// A's byte offset of k-step s (from the tile's first position); KPT k-steps
// per tap
template <int KIND, int CI, int A_LBO>
__host__ __device__ constexpr int a_offset(int s) {
  constexpr int KPT = CI >= 16 ? CI / 16 : 1;
  return KIND == kStem1 ? 2 * s * 16
       : KIND == kShort ? kOdd * 16 + 2 * s * A_LBO
       : KIND == kDown
           ? ((s / KPT) == 0 ? 0 : (s / KPT) == 1 ? kOdd : 1) * 16 + 2 * (s % KPT) * A_LBO
           : (s / KPT) * 16 + 2 * (s % KPT) * A_LBO;
}

// One thread: the group's slice J (slice unit_sub(J) of step unit_step(J))
// into its stage, completing on the stage's barrier
template <int J>
__device__ __forceinline__ void load_unit(uint8_t* stages, uint64_t* bars,
                                          const uint8_t* __restrict__ weights) {
  constexpr int I = exec_conv(unit_step(J));
  constexpr int OFF = conv_off(I) + unit_sub(J) * unit_bytes(I);
  bulk_load(stages + (J % kStages) * kStage, weights + OFF, unit_bytes(I), bars + J % kStages);
}

// One thread, once slice J's stage is free: the slice kStages on, of this
// group or (when another follows) of the next
template <int J>
__device__ __forceinline__ void refill(uint8_t* stages, uint64_t* bars,
                                       const uint8_t* __restrict__ weights, bool more) {
  constexpr int NEXT = J + kStages;
  if constexpr (NEXT < kUnits) {
    load_unit<NEXT>(stages, bars, weights);
  } else {
    if (more) load_unit<NEXT - kUnits>(stages, bars, weights);
  }
}

// Conv STEP of the run (conv exec_conv(STEP) of the fold), over the group's
// rows: outputs q = r * PQ + l (r < kRows, l < LO) to `out` (OUT_P
// positions per channel group) at q + OUT_OFF, from `in` (IN_P positions
// per group; stem conv 1: [pos][8]).  For each of its weight slices: waits
// for the slice, runs its k-steps on the warpgroup's tiles; then stores,
// publishes the outputs with one block barrier, and thread 0 refills each
// slice's stage once every warpgroup is done with it.  `group` numbers the
// block's groups (the barriers' phases); `more`: another group follows.
template <int STEP, int KIND, int IN_P, int OUT_P, int PQ, int LO, int OUT_OFF, int EPI>
__device__ __forceinline__ void conv(const uint8_t* in, uint8_t* out, const uint8_t* res,
                                     uint8_t* stages, uint64_t* bars,
                                     const uint8_t* __restrict__ weights, int group, bool more) {
  constexpr int I = exec_conv(STEP);
  constexpr int CO = conv_co(I);
  constexpr int K = conv_k(I);
  constexpr int U = conv_units(I);
  constexpr int J0 = units_before(STEP);
  constexpr int CI = KIND == kStem1 ? 8 : KIND == kShort ? K : K / 3;
  constexpr int KSTEPS = K / 16;
  constexpr int KPU = KSTEPS / U;              // k-steps a slice
  constexpr int TILES = tiles(PQ, LO);
  constexpr int TPW = TILES / kWarpgroups;
  constexpr int CHMAX = 128 / CO;              // 64 accumulators a thread at most
  constexpr int CH = TPW < CHMAX ? TPW : CHMAX;
  constexpr int A_LBO = KIND == kStem1 ? 16 : IN_P * 16;
  constexpr int OUT_LBO = OUT_P * 16;
  static_assert(TILES % kWarpgroups == 0 && TPW % CH == 0,
                "tiles split evenly over the warpgroups and their chunks");
  static_assert(U == 1 || CH == TPW, "a sliced conv holds all its tiles");
  static_assert(KIND == kStem1 || CI % 16 == 0, "whole k-steps per tap");
  static_assert(KSTEPS % U == 0 && unit_bytes(I) <= kStage, "slices fit a stage");

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const float* __restrict__ bias =
      reinterpret_cast<const float*>(weights + conv_off(I) + image_bytes(I));
  const uint32_t a0 = smem_addr(in) + wg * TPW * kTile * 16;
  // the phase of the group's slice j: its stage's use number, mod 2
  const int phase0 = group * (kUnits / kStages);

  // the warpgroup's tiles in chunks of at most CH, each chunk's products
  // issued back to back and waited for once per slice
#pragma unroll 1
  for (int t0 = 0; t0 < TPW; t0 += CH) {
    float acc[CH][CO / 2];
#pragma unroll
    for (int j = 0; j < CO / 8; ++j) {
      const float bj0 = __ldg(bias + 8 * j + 2 * qd);
      const float bj1 = __ldg(bias + 8 * j + 2 * qd + 1);
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        acc[t][4 * j] = bj0;
        acc[t][4 * j + 1] = bj1;
        acc[t][4 * j + 2] = bj0;
        acc[t][4 * j + 3] = bj1;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = J0 + u;
      mbar_wait(bars + j % kStages, (phase0 + j / kStages) & 1);
      // one descriptor each for A and B, stepped by immediates: an offset
      // in 16-byte units added to the start address field (shared memory
      // addresses stay below 2^18, so the field does not carry)
      const uint64_t bd0 = make_desc(smem_addr(stages + (j % kStages) * kStage), CO * 16, 128);
      const uint64_t ad0 = make_desc(a0 + t0 * kTile * 16, A_LBO, 128);
#pragma unroll
      for (int t = 0; t < CH; ++t) fence_operands(acc[t]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KPU; ++s) {
#pragma unroll
        for (int t = 0; t < CH; ++t) {
          wgmma<CO>(acc[t],
                    ad0 + ((t * kTile * 16 + a_offset<KIND, CI, A_LBO>(u * KPU + s)) >> 4),
                    bd0 + ((s * 2 * CO * 16) >> 4));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int t = 0; t < CH; ++t) fence_operands(acc[t]);
      if (u + 1 < U) {
        // every warpgroup is done with this slice's stage
        __syncthreads();
        if (tid == 0) {
          if (u == 0) refill<J0>(stages, bars, weights, more);
          if (u == 1) refill<J0 + (U > 2 ? 1 : 0)>(stages, bars, weights, more);
        }
      }
    }

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
          dst = (c & 1 ? kOdd : 0) + r * kPTail + (c >> 1);
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
                    : reinterpret_cast<const uint32_t*>(res + j * kPMidB * 16 + (p + 1) * 16 + 4 * qd);
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
  if (tid == 0) refill<J0 + U - 1>(stages, bars, weights, more);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int C>
__global__ void __launch_bounds__(kThreads, 1) read_conv_reduce_wide(
    const uint8_t* __restrict__ rows, int nb, const int32_t* __restrict__ row_allele,
    const float* __restrict__ row_valid, const uint8_t* __restrict__ weights,
    int num_alleles, float* __restrict__ out) {
  __shared__ Group grp;
  __shared__ int range_end;
  const int tid = threadIdx.x;
  // the block's rows: from the first run start at or after its nominal
  // first row to the first at or after the next block's
  if (tid < 32) {
    const int first = static_cast<int>(blockIdx.x) * kSpan;
    const int start = run_start(row_allele, nb, first);
    const int end = run_start(row_allele, nb, min(nb, first + kSpan));
    if (tid == 0) {
      grp.cursor = start;
      range_end = end;
    }
    __syncwarp();
    next_group(&grp, row_allele, row_valid, end, num_alleles);
  }
  __syncthreads();
  if (grp.n == 0) return;  // nothing to compute: padding, masked rows or no run

  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* r1 = smem;
  uint8_t* r2 = smem + kReg;
  uint8_t* r3 = smem + 2 * kReg;
  uint8_t* stages = smem + 3 * kReg;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + kStages * kStage);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + i, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_unit<0>(stages, bars, weights);
    load_unit<1>(stages, bars, weights);
  }

  // each thread's share of the frame: values i = tid + m * kThreads of
  // the [36][128] frame
  constexpr int kShare = kLOut * kCOut / kThreads;
  static_assert(kShare * kThreads == kLOut * kCOut, "the frame splits evenly");

  uint8_t* x64 = r3;
  uint8_t* y64 = r1;
  uint8_t* planes = r2;
  uint8_t* y128 = r1;
  uint8_t* x128 = r3;
#pragma unroll 1
  for (int group = 0;; ++group) {
    const int n = grp.n;
    const bool more = grp.more;

    // uint8 rows -> bf16 [pos][8] in R3: C channels, then zeros; positions
    // past the group's rows are zero
    for (int p = tid; p < kPIn; p += kThreads) {
      const int rs = p / kLIn;
      const int l = p - rs * kLIn;
      float v[8];
      if (rs < n) {
        const uint8_t* src = rows + (static_cast<size_t>(grp.idx[rs]) * kLIn + l) * C;
#pragma unroll
        for (int c = 0; c < 8; ++c) v[c] = c < C ? static_cast<float>(src[c]) : 0.0f;
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) v[c] = 0.0f;
      }
      uint4 w;
      w.x = bf16x2(v[0], v[1]);
      w.y = bf16x2(v[2], v[3]);
      w.z = bf16x2(v[4], v[5]);
      w.w = bf16x2(v[6], v[7]);
      *reinterpret_cast<uint4*>(r3 + p * 16) = w;
    }
    fence_proxy_async();
    __syncthreads();

    // stem: three valid k3 convs with ReLU, positions q = r * 150 + l
    conv<0, kStem1, 0, kPS, kLIn, 148, 0, kRelu>(r3, r1, nullptr, stages, bars, weights, group, more);
    conv<1, kUnit, kPS, kPS, kLIn, 146, 0, kRelu>(r1, r3, nullptr, stages, bars, weights, group, more);
    conv<2, kUnit, kPS, kPS, kLIn, 144, 0, kRelu>(r3, r1, nullptr, stages, bars, weights, group, more);

    // max-pool k3 s2: 64 x 144 per row (R1 and R2) -> x64 rows [halo, 71,
    // halo, 3 spare] in R3, 8 channels per thread and item
    for (int i = tid; i < 8 * kPMidB; i += kThreads) {
      const int cg = i / kPMidB;
      const int pos = i - cg * kPMidB;
      const int r = pos / kPMid;
      const int col = pos - r * kPMid;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < kRows && col >= 1 && col <= kLPool) {
        const uint4* s = reinterpret_cast<const uint4*>(r1 + cg * kPS * 16) + r * kLIn + 2 * (col - 1);
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
      *reinterpret_cast<uint4*>(x64 + cg * kPMidB * 16 + pos * 16) = v;
    }
    fence_proxy_async();
    __syncthreads();
    // y64's halo and spare columns (0, 72..75) and the planes' (even 0, 36,
    // 37; odd 36, 37), which the convs never write
    for (int i = tid; i < 8 * kRows * 10; i += kThreads) {
      const int cg = i / (kRows * 10);
      const int rem = i - cg * (kRows * 10);
      const int r = rem / 10;
      const int h = rem - r * 10;
      uint8_t* dst = h < 5 ? y64 + cg * kPMidB * 16 + (r * kPMid + (h == 0 ? 0 : kLPool + h)) * 16
                           : planes + cg * kPPl * 16 +
                                 ((h < 8 ? 0 : kOdd) + r * kPTail + (h == 5 ? 0 : h < 8 ? 30 + h : 28 + h)) * 16;
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }

    // 3 residual blocks at 64 channels: x += relu(conv(relu(conv(x)))); the
    // last add writes x as the even / odd planes
    conv<3, kUnit, kPMidB, kPMidB, kPMid, kLPool, 1, kRelu>(x64, y64, nullptr, stages, bars, weights, group, more);
    conv<4, kUnit, kPMidB, kPMidB, kPMid, kLPool, 1, kReluAdd>(y64, x64, nullptr, stages, bars, weights, group, more);
    conv<5, kUnit, kPMidB, kPMidB, kPMid, kLPool, 1, kRelu>(x64, y64, nullptr, stages, bars, weights, group, more);
    conv<6, kUnit, kPMidB, kPMidB, kPMid, kLPool, 1, kReluAdd>(y64, x64, nullptr, stages, bars, weights, group, more);
    conv<7, kUnit, kPMidB, kPMidB, kPMid, kLPool, 1, kRelu>(x64, y64, nullptr, stages, bars, weights, group, more);
    conv<8, kUnit, kPMidB, kPPl, kPMid, kLPool, 0, kReluAddPlanes>(y64, planes, x64, stages, bars,
                                                                    weights, group, more);

    // stride-2 residual block 64 -> 128: y = relu(conv_s2(x)), the shortcut
    // x' = conv1x1_s2(x), then x' += relu(conv(y)); first the halo columns
    // of y128 (R1) and x128 (R3)
    for (int i = tid; i < 16 * kRows * 2; i += kThreads) {
      const int cg = i / (kRows * 2);
      const int rem = i - cg * (kRows * 2);
      const int pos = (rem >> 1) * kPTail + (rem & 1) * (kPTail - 1);
      *reinterpret_cast<uint4*>(y128 + (cg * kPTailB + pos) * 16) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(x128 + (cg * kPTailB + pos) * 16) = make_uint4(0, 0, 0, 0);
    }
    conv<9, kDown, kPPl, kPTailB, kPTail, kLOut, 1, kRelu>(planes, y128, nullptr, stages, bars, weights,
                                                           group, more);
    conv<10, kShort, kPPl, kPTailB, kPTail, kLOut, 1, kLinear>(planes, x128, nullptr, stages, bars,
                                                               weights, group, more);
    conv<11, kUnit, kPTailB, kPTailB, kPTail, kLOut, 1, kReluAdd>(y128, x128, nullptr, stages, bars,
                                                                  weights, group, more);

    // 3 residual blocks at 128 channels, x in x128
    conv<12, kUnit, kPTailB, kPTailB, kPTail, kLOut, 1, kRelu>(x128, y128, nullptr, stages, bars, weights, group, more);
    conv<13, kUnit, kPTailB, kPTailB, kPTail, kLOut, 1, kReluAdd>(y128, x128, nullptr, stages, bars, weights, group, more);
    conv<14, kUnit, kPTailB, kPTailB, kPTail, kLOut, 1, kRelu>(x128, y128, nullptr, stages, bars, weights, group, more);
    conv<15, kUnit, kPTailB, kPTailB, kPTail, kLOut, 1, kReluAdd>(y128, x128, nullptr, stages, bars, weights, group, more);
    conv<16, kUnit, kPTailB, kPTailB, kPTail, kLOut, 1, kRelu>(x128, y128, nullptr, stages, bars, weights, group, more);
    conv<17, kUnit, kPTailB, kPTailB, kPTail, kLOut, 1, kReluAdd>(y128, x128, nullptr, stages, bars, weights, group, more);

    // the group's rows of each allele summed in row order, then added to
    // the allele's output
#pragma unroll 2
    for (int m = 0; m < kShare; ++m) {
      const int i = tid + m * kThreads;
      const int l = i / kCOut;
      const int c = i - l * kCOut;
      const uint8_t* x = x128 + ((c >> 3) * kPTailB + 1 + l) * 16 + (c & 7) * 2;
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (k < n) {
          sum += grp.valid[k] *
                 __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(x + k * kPTail * 16));
          if (k + 1 == n || grp.allele[k + 1] != grp.allele[k]) {
            atomicAdd(out + static_cast<size_t>(grp.allele[k]) * kLOut * kCOut + i, sum);
            sum = 0.0f;
          }
        }
      }
    }
    __syncthreads();     // every thread is done with x128 and the group's rows
    if (!more) break;
    if (tid < 32) next_group(&grp, row_allele, row_valid, range_end, num_alleles);
    __syncthreads();
  }
}

}  // namespace rcw2
