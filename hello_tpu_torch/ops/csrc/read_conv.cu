// Fused read convolver + per-allele reduction for NVIDIA Hopper (sm_90a),
// on the tensor cores, in three routes (one per precision class of the
// caller; the fold packs the weights for one):
//   kTF32x3 (highest, high): every product 3xTF32 on warp-level mma.sync,
//       fp32-class accuracy;
//   kTF32 (default): one TF32 mma.sync pass per product, XLA's DEFAULT on a
//       GPU;
//   kBF16 (bf16): a kernel of its own, read_conv_wgmma.cuh: warpgroup
//       wgmma products from bf16 shared-memory tiles, weights streamed by
//       bulk copies on mbarriers, activations rounded to bf16 where the
//       Pallas kernel's bf16 compute_dtype rounds them.
// This file holds the two TF32 routes, which share everything but the
// number of passes, and the C interface of all three.
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
// the three TF32 passes of kTF32x3 (3 x 389.8 GFLOP at 495 TFLOP/s),
// 0.79 ms for kTF32's one pass (0.39 ms for kBF16 at 989 TFLOP/s); 5.82 ms
// at the fp32 FMA peak.  mma.sync's rate is about half the tensor-core
// peak (chip_smoke.py's probe, ops/csrc/mma_probe.cu); wgmma is the way to
// the rest.
//
// Accuracy of kTF32x3: every product is 3xTF32.  Each operand x splits into
// big = tf32(x) and small = tf32(x - big), both rounded to nearest with
// ties away (cvt.rna's rounding), and a k-step accumulates
// small*big + big*small + big*big in fp32, small terms first; the dropped
// small*small term is ~2^-22 relative.  Weights are split once at fold time
// (ops/read_conv.py), activations in registers as their fragments load.
// The fp32 accumulation order differs from cuDNN's and the atomics' order
// varies between runs, so the kernel is held to rtol 1e-4 / atol 1e-3
// against the plain PyTorch version (read_conv_reduce_reference), the
// tolerance hello_tpu holds its Pallas kernel to (tests/test_pallas_ops.py).
// kTF32 keeps only big*big, each operand rounded as above (weights at fold
// time); the fold drops the small parts from its buffer.
//
// Design of the TF32 routes, and what it does about the SIMT kernel it
// replaces:
//   * Tensor cores, not FMA pipes.  Every conv, stem conv 1 included (its
//     K = 3C zero-padded to 24 at fold time), is an implicit GEMM
//     out^T [Co][positions] = W [Co][taps * Ci] x im2col(in) on
//     mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.  B is the im2col
//     view of a shared-memory activation buffer addressed in place: the
//     stride-2 conv and the 1x1 stride-2 shortcut are the same product with
//     another B address.  Weights are A, so their split costs nothing here.
//   * Loads per mma.  Per k-step a warp loads 2 m-tiles of A (two 16-byte
//     shared loads per lane each, big and small) and 6 n-tiles of B (two
//     4-byte loads per lane each) for 36 mma, where the SIMT kernel spent 9
//     loads on 12 FMAs.  The n-tile loop has no branch: tile counts are
//     rounded up to whole warp items and buffers sized so the extra tiles
//     read in bounds (a guard there splits the loop into one basic block
//     per tile, and one tile's loads and split can no longer overlap
//     another's mma).
//   * Idle lanes.  Each conv is cut into exactly 8 warp items, one per warp,
//     so warps do equal work between barriers; the waste is positions
//     rounded up to items, the per-row halo columns and stem conv 1's
//     padded K: 7% more mma than the rows' outputs need.
//   * Rows per block.  kRows = 5 rows are stacked along N: a layer's
//     positions are one stream r * P + l over the block's rows, each row
//     with its own halo columns, and the row strides make every conv's B
//     address linear in the stream index (32-channel rows 76 = 2 x 38, the
//     64-channel stride).  Weights are read once per 5 rows; 5 is the most
//     that shared memory holds, and it cuts every conv into whole items.
//   * Weights in shared memory.  Each conv's fragments are staged one tap at
//     a time with cp.async, double-buffered: while a tap computes, the next
//     (or the next conv's first) lands.  One barrier per tap publishes the
//     stage and orders a conv after the previous conv's stores: 54 barriers
//     per 5 rows, where the SIMT kernel had 18 per row.
//   * Bank conflicts.  Channel-major buffers [ci][position] with a leading
//     dimension = 8 (mod 32), so the 32 lanes of a B-fragment load hit 32
//     banks (2-way for the stride-2 reads and stem conv 1's position-major
//     input); A fragments are 512 contiguous bytes per warp load.  Halo
//     columns stay zero, so the inner loop has no bounds tests.
//   * Fused epilogues on the accumulators: bias (their initial value),
//     ReLU, residual add, the linear 1x1 shortcut; then fp32 atomicAdd of
//     row_valid * frame into out[row_allele] for each valid row.  Rows with
//     row_valid == 0 or row_allele outside [0, A) add nothing; a block whose
//     rows are all such (the wire's tail of padding rows) returns at once.
//   * Occupancy: 218,112 bytes of shared memory (activations 152,576, two
//     weight stages 65,536), one 256-thread block per SM; latency is hidden
//     by each warp's 12 independent accumulator tiles and by the cp.async
//     prefetch, not by more warps.
//
// What it still leaves: wgmma (warpgroup tiles from shared-memory
// descriptors, twice mma.sync's rate), TMA for the weight stages, and
// persistent blocks that overlap one block's epilogue and barriers with the
// next block's products; and the activation split, four integer and
// float ops per element on the way from shared memory to the mma.

#include <cuda_runtime.h>
#include <stdint.h>

#include "read_conv_wgmma.cuh"

namespace {

// kernel routes, as ops/read_conv.py ROUTE_IDS numbers them
enum Route { kTF32x3 = 0, kTF32 = 1, kBF16 = 2 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 5;             // read rows per block, stacked along N

constexpr int kLIn = 150;
constexpr int kLPool = 71;           // (144 - 3) / 2 + 1
constexpr int kLOut = 36;            // (71 + 2 - 3) / 2 + 1
constexpr int kCOut = 64;
constexpr int kP32 = 76;             // row stride, 32 channels: halo, 71, halo, 3 spare
constexpr int kP64 = 38;             // row stride, 64 channels: halo, 36, halo

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
// smallest n' >= n with n' = 8 (mod 32): bank-conflict-free B fragments
__host__ __device__ constexpr int ld8(int n) { return n + ((8 - n) % 32 + 32) % 32; }
// n8 tiles of positions a conv computes: its outputs are q = r * pq + l,
// l < lo, r < kRows, rounded up to whole warp items of wn tiles (the tiles
// past the outputs are computed and not stored, so the inner loop has no
// branch)
__host__ __device__ constexpr int ntiles(int pq, int lo, int wn) {
  return cdiv(cdiv((kRows - 1) * pq + lo, 8), wn) * wn;
}

constexpr int kWNStem = 12;          // n8 tiles per warp item: stem convs
constexpr int kWN = 6;               // the others
constexpr int kNT1 = ntiles(kLIn, 148, kWNStem);
constexpr int kNT2 = ntiles(kLIn, 146, kWNStem);
constexpr int kNT3 = ntiles(kLIn, 144, kWNStem);
constexpr int kNT32 = ntiles(kP32, kLPool, kWN);
constexpr int kNT64 = ntiles(kP64, kLOut, kWN);
// Leading dimensions: the last tile's reads (+ taps) stay inside a channel's
// row.  Positions past the block's rows hold stale values; only outputs that
// are never stored read them (an mma output column depends on its B column
// only).
constexpr int kLdS = ld8(imax(kNT2, kNT3) * 8 + 2);
constexpr int kLd32 = ld8(imax(kNT32 * 8 + 2, kNT64 * 16 + 1));
constexpr int kLd64 = ld8(kNT64 * 8 + 2);
// stem conv 1 reads in[q * C + kk] for kk < its padded K (24): below
// (q + 6) * C for C >= 6
constexpr int kIn0Pos = kNT1 * 8 + 6;
// region 1: input (position-major), stem 2's output, then x32;
// region 2: stem 1 and 3's outputs, then y32, then y64 | x64;
// then two weight stages of one tap each (the largest: 64 x 64 x 2 floats)
constexpr int kRegion1 = cdiv(imax(imax(kIn0Pos * 7, 16 * kLdS), 32 * kLd32), 4) * 4;
constexpr int kRegion2 = imax(imax(32 * kLdS, 32 * kLd32), 2 * 64 * kLd64);
constexpr int kStage = 2 * 64 * 64;
constexpr int kSmemBytes =
    (kRegion1 + kRegion2 + 2 * kStage) * static_cast<int>(sizeof(float));

// The 18 convs in the fold's order (stem 1-3, 6 x RB32, the stride-2 conv,
// its second conv, the 1x1 shortcut, 6 x RB64): K (stem conv 1's 3C
// zero-padded to a whole k-step) and Co.  Each takes frag_floats(i) 32-bit
// words of A fragments, then Co bias floats, in the flat buffer.
template <int R>
__host__ __device__ constexpr int conv_k(int i) {
  return i == 0 ? 24
       : i <= 2 ? 48 : i <= 9 ? 96 : i == 10 ? 192 : i == 11 ? 32 : 192;
}
__host__ __device__ constexpr int conv_co(int i) {
  return i <= 1 ? 16 : i <= 8 ? 32 : 64;
}
__host__ __device__ constexpr int conv_taps(int i) { return i == 0 || i == 11 ? 1 : 3; }
// A-fragment words of conv i: big and small TF32 parts, or the TF32 part
template <int R>
__host__ __device__ constexpr int frag_floats(int i) {
  return R == kTF32x3 ? 2 * conv_k<R>(i) * conv_co(i) : conv_k<R>(i) * conv_co(i);
}
template <int R>
__host__ __device__ constexpr int conv_off(int i) {
  return i == 0 ? 0 : conv_off<R>(i - 1) + frag_floats<R>(i - 1) + conv_co(i - 1);
}
// fragment words of one tap of conv i (the unit of staging)
template <int R>
__host__ __device__ constexpr int tap_floats(int i) {
  return i < 0 ? 0 : frag_floats<R>(i) / conv_taps(i);
}

enum Epilogue { kRelu = 0, kReluAdd = 1, kLinear = 2 };

// Geometry of one conv as an implicit GEMM out^T = W x im2col(in).
// B(kk, q) with kk = tap * CI + ci is in[IN_OFF + q * QS + tap * TS + ci * CS];
// output (co, q) goes to out[co * OUT_LD + q + OUT_OFF] when q = r * PQ + l
// with r < kRows, l < LO; NT n8 tiles of q cover those.
template <int CI_, int CO_, int TAPS_, int QS_, int TS_, int CS_, int IN_OFF_,
          int OUT_LD_, int OUT_OFF_, int PQ_, int LO_, int NT_>
struct Conv {
  static constexpr int CI = CI_, CO = CO_, TAPS = TAPS_, QS = QS_, TS = TS_,
                       CS = CS_, IN_OFF = IN_OFF_, OUT_LD = OUT_LD_,
                       OUT_OFF = OUT_OFF_, PQ = PQ_, LO = LO_, NT = NT_;
};

// stem conv 1 reads the position-major input: kk = tap * C + ci is one
// linear offset, so it is a single "tap" of K = 24 (weights zero-padded)
template <int C, int R>
using Stem1 = Conv<conv_k<R>(0), 16, 1, C, 0, 1, 0, kLdS, 0, kLIn, 148, kNT1>;
using Stem2 = Conv<16, 16, 3, 1, 1, kLdS, 0, kLdS, 0, kLIn, 146, kNT2>;
using Stem3 = Conv<16, 32, 3, 1, 1, kLdS, 0, kLdS, 0, kLIn, 144, kNT3>;
using RB32 = Conv<32, 32, 3, 1, 1, kLd32, 0, kLd32, 1, kP32, kLPool, kNT32>;
using Down = Conv<32, 64, 3, 2, 1, kLd32, 0, kLd64, 1, kP64, kLOut, kNT64>;
using Short = Conv<32, 64, 1, 2, 0, kLd32, 1, kLd64, 1, kP64, kLOut, kNT64>;
using RB64 = Conv<64, 64, 3, 1, 1, kLd64, 0, kLd64, 1, kP64, kLOut, kNT64>;

// fp32 -> TF32 bits, round to nearest with ties away from zero: what
// cvt.rna.tf32.f32 gives for finite inputs, in two integer ops (the cvt
// compiles to a longer sequence that also screens NaN)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy n floats (a multiple of 4, 16-byte aligned) global -> shared with
// cp.async, bypassing L1, as one commit group of the calling thread.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x * 4; i < n; i += kThreads * 4) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// One conv over shared memory on the tensor cores, out^T = W x im2col(in):
// A = W [Co][K] (m16 tiles of output channels), B = the im2col view of `in`
// (n8 tiles of positions).  The weights come from the fold as the route's A
// fragments ([K/8][Co/16][big, small][32 lanes][a0..a3] for kTF32x3, without
// small for kTF32; pack_conv in ops/read_conv.py), staged into shared memory one tap at a
// time: tap t computes from stage `cur` while cp.async fills the other with
// tap t + 1, or with the first tap of conv NEXT.  Activations are rounded
// (split for kTF32x3) as their B fragments load.  Every warp takes at most
// one item of WM m-tiles x WN n-tiles; all threads reach the per-tap
// barrier.
template <int R, class G, int I, int NEXT, int WM, int WN, int EPI>
__device__ __forceinline__ void mma_conv(const float* in, float* out,
                                         const float* __restrict__ weights,
                                         float* wstage, int& cur) {
  constexpr int KS = 8;                // K of one mma
  constexpr int MT = G::CO / 16;
  constexpr int CB = G::CI / KS;       // k-steps per tap
  constexpr int MI = MT / WM;
  constexpr int ITEMS = G::NT / WN * MI;
  constexpr int TAP = tap_floats<R>(I);
  // 16-byte fragment loads per m-tile and k-step (big and small: two)
  constexpr int AV = R == kTF32x3 ? 64 : 32;
  static_assert(G::CI % KS == 0 && MT % WM == 0 && G::NT % WN == 0 &&
                ITEMS <= kWarps, "conv tiling");
  static_assert(G::TAPS == conv_taps(I) && G::CO == conv_co(I) &&
                G::TAPS * G::CI == conv_k<R>(I) && TAP <= kStage, "conv layout");
  const float* w = weights + conv_off<R>(I);
  const float* bias = w + frag_floats<R>(I);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool busy = warp < ITEMS;
  const int mt0 = (warp % MI) * WM;
  const int nt0 = (warp / MI) * WN;

  float acc[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i) {
    const float lo = __ldg(bias + (mt0 + i) * 16 + g);
    const float hi = __ldg(bias + (mt0 + i) * 16 + g + 8);
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      acc[i][j][0] = lo;
      acc[i][j][1] = lo;
      acc[i][j][2] = hi;
      acc[i][j][3] = hi;
    }
  }
  const float* b_lane = in + G::IN_OFF + t * G::CS + (nt0 * 8 + g) * G::QS;

#pragma unroll 1
  for (int tap = 0; tap < G::TAPS; ++tap) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (tap + 1 < G::TAPS) {
      stage(wstage + (cur ^ 1) * kStage, w + (tap + 1) * TAP, TAP);
    } else if (NEXT >= 0) {
      stage(wstage + (cur ^ 1) * kStage, weights + conv_off<R>(imax(NEXT, 0)),
            tap_floats<R>(NEXT));
    }
    if (busy) {
      const float4* a_lane =
          reinterpret_cast<const float4*>(wstage + cur * kStage) + mt0 * AV + lane;
      const float* b_tap = b_lane + tap * G::TS;
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        uint32_t ab[WM][4], as[WM][4];
#pragma unroll
        for (int i = 0; i < WM; ++i) {
          const float4 vb = a_lane[(cb * MT + i) * AV];
          ab[i][0] = __float_as_uint(vb.x);
          ab[i][1] = __float_as_uint(vb.y);
          ab[i][2] = __float_as_uint(vb.z);
          ab[i][3] = __float_as_uint(vb.w);
          if constexpr (R == kTF32x3) {
            const float4 vs = a_lane[(cb * MT + i) * AV + 32];
            as[i][0] = __float_as_uint(vs.x);
            as[i][1] = __float_as_uint(vs.y);
            as[i][2] = __float_as_uint(vs.z);
            as[i][3] = __float_as_uint(vs.w);
          }
        }
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const float* bp = b_tap + cb * KS * G::CS + j * 8 * G::QS;
          const float x0 = bp[0];
          const float x1 = bp[4 * G::CS];
          if constexpr (R == kTF32) {
            const uint32_t big0 = tf32_rna(x0);
            const uint32_t big1 = tf32_rna(x1);
#pragma unroll
            for (int i = 0; i < WM; ++i) mma_tf32(acc[i][j], ab[i], big0, big1);
          } else {
            const uint32_t big0 = tf32_rna(x0);
            const uint32_t big1 = tf32_rna(x1);
            const uint32_t small0 = tf32_rna(x0 - __uint_as_float(big0));
            const uint32_t small1 = tf32_rna(x1 - __uint_as_float(big1));
#pragma unroll
            for (int i = 0; i < WM; ++i) {
              mma_tf32(acc[i][j], as[i], big0, big1);
              mma_tf32(acc[i][j], ab[i], small0, small1);
              mma_tf32(acc[i][j], ab[i], big0, big1);
            }
          }
        }
      }
    }
    cur ^= 1;
  }
  if (!busy) return;
  // accumulator (i, j, e): co = tile row g (+8), position q = 2t (+1)
#pragma unroll
  for (int i = 0; i < WM; ++i) {
#pragma unroll
    for (int j = 0; j < WN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = (mt0 + i) * 16 + g + (e >> 1) * 8;
        const int q = (nt0 + j) * 8 + 2 * t + (e & 1);
        const int r = q / G::PQ;
        const int l = q - r * G::PQ;
        if (r < kRows && l < G::LO) {
          float* o = out + co * G::OUT_LD + q + G::OUT_OFF;
          const float v = acc[i][j][e];
          if (EPI == kRelu) {
            *o = fmaxf(v, 0.0f);
          } else if (EPI == kReluAdd) {
            *o = *o + fmaxf(v, 0.0f);
          } else {
            *o = v;
          }
        }
      }
    }
  }
}

template <int C, int R>
__global__ void __launch_bounds__(kThreads, 1) read_conv_reduce_kernel(
    const uint8_t* __restrict__ rows, int nb,
    const int32_t* __restrict__ row_allele,
    const float* __restrict__ row_valid,
    const float* __restrict__ weights, int num_alleles,
    float* __restrict__ out) {
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

  extern __shared__ float smem[];
  float* reg1 = smem;
  float* reg2 = smem + kRegion1;
  float* wstage = reg2 + kRegion2;
  const int tid = threadIdx.x;
  int cur = 0;
  stage(wstage, weights, tap_floats<R>(0));

  // uint8 rows [kRows * 150][C] -> fp32, position-major, in region 1; rows
  // past nb and the tail that stem conv 1's padded K reads are zero (the
  // first conv's barrier publishes them)
  const int n_in = min(kRows, nb - r0) * kLIn * C;
  const uint8_t* src = rows + static_cast<size_t>(r0) * kLIn * C;
  for (int i = tid; i < kIn0Pos * C; i += kThreads) {
    reg1[i] = i < n_in ? static_cast<float>(src[i]) : 0.0f;
  }

  // stem: three valid k3 convs with ReLU, positions q = r * 150 + l; a
  // conv's first barrier orders it after the previous conv's stores
  mma_conv<R, Stem1<C, R>, 0, 1, 1, kWNStem, kRelu>(reg1, reg2, weights, wstage, cur);
  mma_conv<R, Stem2, 1, 2, 1, kWNStem, kRelu>(reg2, reg1, weights, wstage, cur);
  mma_conv<R, Stem3, 2, 3, 2, kWNStem, kRelu>(reg1, reg2, weights, wstage, cur);
  __syncthreads();

  // max-pool k3 s2: 32 x 144 per row -> x32 rows of [halo, 71, halo, 3 spare]
  float* x32 = reg1;
  float* y32 = reg2;
  for (int i = tid; i < 32 * kRows * kP32; i += kThreads) {
    const int c = i / (kRows * kP32);
    const int rem = i - c * (kRows * kP32);
    const int r = rem / kP32;
    const int col = rem - r * kP32;
    float v = 0.0f;
    if (col >= 1 && col <= kLPool) {
      const float* s = reg2 + c * kLdS + r * kLIn + 2 * (col - 1);
      v = fmaxf(fmaxf(s[0], s[1]), s[2]);
    }
    x32[c * kLd32 + rem] = v;
  }
  __syncthreads();

  // y32's halo and spare columns (cols 0, 72..75); the convs write only
  // data columns
  for (int i = tid; i < 32 * kRows * 5; i += kThreads) {
    const int c = i / (kRows * 5);
    const int rem = i - c * (kRows * 5);
    const int r = rem / 5;
    const int h = rem - r * 5;
    y32[c * kLd32 + r * kP32 + (h == 0 ? 0 : kLPool + h)] = 0.0f;
  }
  // 3 residual blocks at 32 channels: x += relu(conv(relu(conv(x))))
  mma_conv<R, RB32, 3, 4, 2, kWN, kRelu>(x32, y32, weights, wstage, cur);
  mma_conv<R, RB32, 4, 5, 2, kWN, kReluAdd>(y32, x32, weights, wstage, cur);
  mma_conv<R, RB32, 5, 6, 2, kWN, kRelu>(x32, y32, weights, wstage, cur);
  mma_conv<R, RB32, 6, 7, 2, kWN, kReluAdd>(y32, x32, weights, wstage, cur);
  mma_conv<R, RB32, 7, 8, 2, kWN, kRelu>(x32, y32, weights, wstage, cur);
  mma_conv<R, RB32, 8, 9, 2, kWN, kReluAdd>(y32, x32, weights, wstage, cur);
  __syncthreads();

  // stride-2 residual block 32 -> 64: y = relu(conv_s2(x)) and the
  // shortcut x' = conv1x1_s2(x) (with the halo columns of both), then
  // x' += relu(conv(y))
  float* y64 = reg2;
  float* x64 = reg2 + 64 * kLd64;
  for (int i = tid; i < 64 * kRows * 2; i += kThreads) {
    const int c = i / (kRows * 2);
    const int rem = i - c * (kRows * 2);
    const int col = (rem >> 1) * kP64 + (rem & 1) * (kP64 - 1);
    y64[c * kLd64 + col] = 0.0f;
    x64[c * kLd64 + col] = 0.0f;
  }
  mma_conv<R, Down, 9, 11, 2, kWN, kRelu>(x32, y64, weights, wstage, cur);
  mma_conv<R, Short, 11, 10, 2, kWN, kLinear>(x32, x64, weights, wstage, cur);
  mma_conv<R, RB64, 10, 12, 2, kWN, kReluAdd>(y64, x64, weights, wstage, cur);

  // 3 residual blocks at 64 channels, x in x64
  mma_conv<R, RB64, 12, 13, 2, kWN, kRelu>(x64, y64, weights, wstage, cur);
  mma_conv<R, RB64, 13, 14, 2, kWN, kReluAdd>(y64, x64, weights, wstage, cur);
  mma_conv<R, RB64, 14, 15, 2, kWN, kRelu>(x64, y64, weights, wstage, cur);
  mma_conv<R, RB64, 15, 16, 2, kWN, kReluAdd>(y64, x64, weights, wstage, cur);
  mma_conv<R, RB64, 16, 17, 2, kWN, kRelu>(x64, y64, weights, wstage, cur);
  mma_conv<R, RB64, 17, -1, 2, kWN, kReluAdd>(y64, x64, weights, wstage, cur);
  __syncthreads();

  // out[a, l, c] += valid * x[c, l] for each valid row
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (allele[r] < 0) continue;
    float* o = out + static_cast<size_t>(allele[r]) * kLOut * kCOut;
    const float* x = x64 + r * kP64 + 1;
    for (int i = tid; i < kLOut * kCOut; i += kThreads) {
      const int l = i / kCOut;
      const int c = i - l * kCOut;
      atomicAdd(o + i, valid[r] * x[c * kLd64 + l]);
    }
  }
}

template <int C, int R>
cudaError_t launch_tf32(const void* rows, int nb, const void* row_allele,
                   const void* row_valid, const void* weights,
                   int num_alleles, void* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      read_conv_reduce_kernel<C, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  read_conv_reduce_kernel<C, R><<<cdiv(nb, kRows), kThreads, kSmemBytes, stream>>>(
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
cudaError_t launch_route(int route, const void* rows, int nb,
                         const void* row_allele, const void* row_valid,
                         const void* weights, int num_alleles, void* out,
                         cudaStream_t s) {
  switch (route) {
    case kTF32x3:
      return launch_tf32<C, kTF32x3>(rows, nb, row_allele, row_valid, weights, num_alleles, out, s);
    case kTF32:
      return launch_tf32<C, kTF32>(rows, nb, row_allele, row_valid, weights, num_alleles, out, s);
    case kBF16:
      return launch_bf16<C>(rows, nb, row_allele, row_valid, weights, num_alleles, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int C>
const void* kernel_of(int route) {
  return route == kTF32x3 ? reinterpret_cast<const void*>(&read_conv_reduce_kernel<C, kTF32x3>)
       : route == kTF32 ? reinterpret_cast<const void*>(&read_conv_reduce_kernel<C, kTF32>)
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
  *rows_per_block = bf16 ? rcw::kRows : kRows;
  *smem_bytes = bf16 ? rcw::kSmemBytes : kSmemBytes;
  *threads = bf16 ? rcw::kThreads : kThreads;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, *threads, *smem_bytes));
}
