// The eval-mode bf16 conv of the port's layers on Hopper (sm_90a): a 1-D
// implicit-GEMM convolution on wgmma.mma_async m64nNk16, bf16 operands
// from shared memory, fp32 sums in registers.
//
// Replaces no TPU kernel: hello_tpu runs these convs (the compressors, the
// expert heads, the combiners, the meta-experts and the layer-route read
// convolvers) as XLA convolutions with a bf16 input and an fp32 preferred
// type (hello_tpu/nn/layers.py Conv1d.apply).  The port ran them through
// cuDNN as fp32 convs on bf16-valued operands with TF32 off (nn/layers.py
// conv1d_bf16, F3), on FFMA: 3% of the bf16 rate.  This kernel computes the
// same function on the tensor cores:
//
//   y[n][l][co] = bf16(sum over t < K, ci < Ci of
//                      x[n][l * stride - pad + t * dil][ci] * w[co][t][ci]
//                      + bias[co])
//
// x: bf16 [N][Lin][Ci] (NWC, read as it lies; taps outside [0, Lin) are
// zero), w: bf16 [Co][K * Ci] (tap-major, ops/conv_bf16.pack_weight),
// bias: fp32 [Co] or none, y: bf16 [N][Lout][Co].  Every product is exact,
// the sum is taken in fp32, the fp32 bias is added to the whole sum and the
// result is rounded to bf16 once (to nearest even): the sum is never
// rounded before the bias.
//
// What bounds it: operations for the large convs (the wide head's 512 ->
// 512 k3 convs hold 1,536 x 2 FLOPs per output value against 2 x 2 bytes in
// and out), bytes for the 1x1 convs over few channels.  For
// illumina_wide's batch (1,024 sites x 2 alleles) its convs need 0.30
// TFLOP: 0.30 ms at the H100 SXM's 989 TFLOP/s dense bf16 peak.
//
// Design: out[M = N * Lout][Co] = im2col(x)[M][K * Ci] x w^T, one block a
// BM x BN output tile (BM = 64 or 128 positions: one or two consumer
// warpgroups of 64 rows each; BN = 16 to 128 output channels: the N of the
// wgmma), both chosen by ops/conv_bf16.tile_for from Co and M.  K runs in
// blocks of kBK = 64 (four k-steps of 16) through a ring of kStages
// shared-memory stages, each [BM][64] bf16 of A and [BN][64] of B: one
// 128-byte row per output position and per output channel, K-major, in
// the 128-byte swizzle.  Eight neighbouring threads copy the eight 16-byte
// chunks of a row with cp.async: for A, 8 channels of one tap of the
// row's input position (Ci a multiple of 64: one tap's 128 contiguous
// bytes of x), for B 8 K values of w, so every 32-byte sector the copies
// fetch from L2 is used whole, and the swizzle spreads a row's chunks over
// every bank.  Where Ci is a multiple of 8 every copy is such a cp.async
// (zero-filled past the taps' ends, past M, Co and K); otherwise (Ci 5 to
// 7: the meta-expert's reference input, the layer-route read convolvers'
// first conv) the threads gather the values one by one.  Each thread
// copies the same 4 A rows at every K block, their positions' (n, l)
// computed once.  Loads run kStages - 1 blocks ahead of the products.
//
// The sum: the tensor cores sum each k-step's 16 products from zero into
// `part0` or `part1`, in turns, and each is then added to the fp32 sum
// `acc` by FADD, rounding to nearest, in k order, while the next k-step's
// products run.  Hopper's wgmma adds its products to its accumulator with
// a rounding biased toward zero: left to accumulate a whole K of up to
// 1,536, 61% of the bf16 values that came out other than the float64
// conv's rounding were too small in magnitude, twice as many values
// differed as from cuDNN's fp32 sums, and a layer-route read convolver's
// flips moved the called qualities further from the CPU's bf16 than
// cuDNN's did (chip_smoke's configs_path).  Promoted every K block of 64
// products, 55% and still too far; every k-step, 51%, as cuDNN's 50%.  The
// cost: three fragments of registers (BN at most 128).  The epilogue adds the bias
// to each fp32 sum, rounds it into a bf16 tile in the ring and stores the
// tile in 16-byte row chunks.  No split-K and no atomics: every output
// value is one thread's sum in one order, the same bits on every run and
// under graph replay.
//
// What it reaches (chip_smoke.py's conv_bf16 phase, illumina_wide's
// compressor and head convs at the cell's batch, an H100 SXM): 1.55 ms for
// their 0.30 TFLOP, 19% of the bound (1.05 ms, 28%, with the whole K
// summed by the tensor cores), where cuDNN's fp32 route took 11.6 ms.  The
// FADDs of the promotion take as long as the products they add (16 MACs
// an output value a k-step at about 2,100 MACs a clock an SM, against one
// FADD at 128 a clock), so the two fragments in turns overlap them.  What
// it leaves: the weights are read again by every 128-row tile from L2 (a
// 2-block cluster could multicast them), and a block's epilogue does not
// overlap the next tile's loads (a persistent block with a producer warp
// would).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_ptx.cuh"

namespace cbw {

using namespace wgx;

constexpr int kBK = 64;        // K of one stage: one 128-byte row of bf16 per
                               // output position and per output channel
constexpr int kStages = 4;     // the ring of stages
constexpr int kAhead = kStages - 1;  // K blocks loaded ahead of the products
static_assert(kBK == 64, "a K block is the four k-steps the main loop issues");

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int BM, int BN>
struct Tile {
  static constexpr int kThreads = 2 * BM;        // BM / 64 warpgroups
  static constexpr int kRows = kThreads / 8;     // rows the threads copy at once
  static constexpr int kABytes = BM * kBK * 2;
  static constexpr int kBBytes = BN * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // the ring, and room to start it on a 1024-byte boundary (the swizzle's)
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;
};

struct Conv {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const float* bias;
  __nv_bfloat16* y;
  int m;        // N * Lout output positions
  int lin, ci, lout, co;
  int stride, pad, dil;
  int kc;       // K * Ci
};

// D[64][N] = A[64][16] B[16][N] (+ D where acc != 0), bf16 operands from
// shared memory (both K-major), fp32 accumulators in the m64nNk16 fragment:
// d[4 j + 2 h + e] is row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane %
// 4) + e
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t a, uint64_t b, int acc) {
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
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t a, uint64_t b, int acc) {
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
      : "l"(a), "l"(b), "r"(acc));
}

// one thread: 16 bytes global -> shared, asynchronously; with `bytes` 0
// the 16 bytes are zeros and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of 16-byte chunk c (K values 8 c .. 8 c + 7) of row r in a
// stage's A or B image: rows of 128 bytes, the chunks of each row permuted
// by the 128-byte swizzle (chunk c at c ^ (r % 8)), which the wgmma
// descriptors undo; so the 8 chunks of a row, copied by 8 neighbouring
// threads, fill 8 different bank groups
__device__ __forceinline__ int swizzled(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// wgmma shared-memory matrix descriptor for a K-major operand in the
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO), LBO unused (1)
__device__ __forceinline__ uint64_t make_desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// The input value of output row m's tap-major K column k, as the A tile
// holds it: x[n][l * stride - pad + t * dil][k - t * Ci] with t = k / Ci,
// zero outside the input or past K (the gather of Ci % 8 != 0)
__device__ __forceinline__ uint16_t a_value(const Conv& p, const uint16_t* xrow, int pos0,
                                            bool mok, int k) {
  if (!mok || k >= p.kc) return 0;
  const int t = k / p.ci;
  const int pos = pos0 + t * p.dil;
  if (pos < 0 || pos >= p.lin) return 0;
  return __ldg(xrow + static_cast<size_t>(pos) * p.ci + (k - t * p.ci));
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return lo | (static_cast<uint32_t>(hi) << 16);
}

// What a thread copies of A: chunk c = tid % 8 of the rows tid / 8 + i
// kRows (i < 4), each row an output position m = n * Lout + l, whose
// first tap reads input position l * stride - pad of input row n
template <int BM, int BN>
struct ARows {
  static constexpr int kN = BM / Tile<BM, BN>::kRows;   // 4
  const __nv_bfloat16* xrow[kN];
  int pos0[kN];
  bool mok[kN];

  __device__ __forceinline__ ARows(const Conv& p, int m0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int m = m0 + threadIdx.x / 8 + i * Tile<BM, BN>::kRows;
      mok[i] = m < p.m;
      const int img = mok[i] ? m / p.lout : 0;
      pos0[i] = (mok[i] ? m - img * p.lout : 0) * p.stride - p.pad;
      xrow[i] = p.x + static_cast<size_t>(img) * p.lin * p.ci;
    }
  }
};

// K block kb of A and B into `stage` (1024-byte aligned): each thread its
// chunk c = tid % 8 of A's rows (ARows) and of B's rows tid / 8 + j kRows,
// one 16-byte cp.async each where Ci % 8 == 0 (zero-filled outside the
// input, past M, Co and K), gathered value by value otherwise
template <int BM, int BN>
__device__ __forceinline__ void load_block(const Conv& p, uint8_t* stage, int kb,
                                           const ARows<BM, BN>& a, int n0, bool vec) {
  using T = Tile<BM, BN>;
  uint8_t* sa = stage;
  uint8_t* sb = stage + T::kABytes;
  const int c = threadIdx.x % 8;
  const int r0 = threadIdx.x / 8;
  const int k = kb * kBK + 8 * c;
  if (vec) {
    const bool kok = k < p.kc;
    const int t = k / p.ci;
    const int kin = k - t * p.ci;
#pragma unroll
    for (int i = 0; i < ARows<BM, BN>::kN; ++i) {
      const int pos = a.pos0[i] + t * p.dil;
      const bool ok = a.mok[i] && kok && pos >= 0 && pos < p.lin;
      const __nv_bfloat16* src = ok ? a.xrow[i] + static_cast<size_t>(pos) * p.ci + kin : p.x;
      cp_async16(sa + swizzled(r0 + i * T::kRows, c), src, ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < cdiv(BN, T::kRows); ++j) {
      const int n = r0 + j * T::kRows;
      if (n < BN) {
        const bool ok = n0 + n < p.co && kok;
        const __nv_bfloat16* src = ok ? p.w + static_cast<size_t>(n0 + n) * p.kc + k : p.w;
        cp_async16(sb + swizzled(n, c), src, ok ? 16 : 0);
      }
    }
    return;
  }
  const uint16_t* w = reinterpret_cast<const uint16_t*>(p.w);
#pragma unroll
  for (int i = 0; i < ARows<BM, BN>::kN; ++i) {
    const uint16_t* xr = reinterpret_cast<const uint16_t*>(a.xrow[i]);
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = pack2(a_value(p, xr, a.pos0[i], a.mok[i], k + 2 * e),
                   a_value(p, xr, a.pos0[i], a.mok[i], k + 2 * e + 1));
    *reinterpret_cast<uint4*>(sa + swizzled(r0 + i * T::kRows, c)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
#pragma unroll 1
  for (int j = 0; j < cdiv(BN, T::kRows); ++j) {
    const int n = r0 + j * T::kRows;
    if (n >= BN) continue;
    const uint16_t* src = w + static_cast<size_t>(n0 + n) * p.kc;
    const bool nok = n0 + n < p.co;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = pack2(nok && k + 2 * e < p.kc ? __ldg(src + k + 2 * e) : 0,
                   nok && k + 2 * e + 1 < p.kc ? __ldg(src + k + 2 * e + 1) : 0);
    *reinterpret_cast<uint4*>(sb + swizzled(n, c)) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// one k-step's 16 products into `part`, which they overwrite, as a
// committed wgmma group
template <int BN>
__device__ __forceinline__ void issue_step(float (&part)[BN / 2], uint64_t a, uint64_t b) {
  fence_operands(part);
  wgmma_fence();
  wgmma<BN>(part, a, b, 0);
  wgmma_commit();
}

// once at most `kLeft` of the warpgroup's wgmma groups are in flight (so
// the group that wrote `part` is done), `part` added to the fp32 sum
template <int BN, int kLeft>
__device__ __forceinline__ void add_step(float (&acc)[BN / 2], float (&part)[BN / 2]) {
  wgmma_wait<kLeft>();
  fence_operands(part);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
}

template <int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::kThreads, 1) conv1d_bf16_kernel(Conv p, int vec) {
  using T = Tile<BM, BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the ring on a 1024-byte boundary: the swizzle's pattern repeats there
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const ARows<BM, BN> arows(p, m0);
  const int nkb = cdiv(p.kc, kBK);

#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < nkb) load_block<BM, BN>(p, smem + s * T::kStageBytes, s, arows, n0, vec);
    cp_async_commit();
  }

  // acc: the sum in fp32 (added to by FADD, rounding to nearest); part0,
  // part1: the 16 products of one k-step each, summed by the tensor cores,
  // in turns, so that one k-step's products run while the other's are added
  float acc[BN / 2], part0[BN / 2], part1[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part0[i] = part1[i] = 0.0f;

#pragma unroll 1
  for (int kb = 0; kb < nkb; ++kb) {
    // block kb has landed (every thread's copies), and every warpgroup is
    // done with block kb - 1, whose stage the copies below refill
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    if (kb + kAhead < nkb)
      load_block<BM, BN>(p, smem + ((kb + kAhead) % kStages) * T::kStageBytes, kb + kAhead,
                         arows, n0, vec);
    cp_async_commit();

    const uint8_t* stage = smem + (kb % kStages) * T::kStageBytes;
    // A: [BM][64] swizzled, this warpgroup's 64 rows; B: [BN][64]; k-step
    // s starts 32 s bytes into the rows (the descriptor's start field is
    // in 16-byte units and does not carry)
    const uint64_t ad = make_desc_sw128(smem_addr(stage) + wg * 64 * 128);
    const uint64_t bd = make_desc_sw128(smem_addr(stage + T::kABytes));
    // k-steps 0 to 3 (past K both operands are zeros), each into part0 or
    // part1 from zero, each added to acc in order once its products are in
    issue_step<BN>(part0, ad, bd);
    issue_step<BN>(part1, ad + 2, bd + 2);
    add_step<BN, 1>(acc, part0);
    issue_step<BN>(part0, ad + 4, bd + 4);
    add_step<BN, 1>(acc, part1);
    issue_step<BN>(part1, ad + 6, bd + 6);
    add_step<BN, 1>(acc, part0);
    add_step<BN, 0>(acc, part1);
  }

  // epilogue: the fp32 bias added to the fp32 sum, one rounding to bf16,
  // into a [BM][BN] tile in the ring (rows kPitch bytes apart, so the
  // fragment's stores hit every bank once), then out in 16-byte row chunks
  __syncthreads();  // every warpgroup is done with the ring
  constexpr int kPitch = BN * 2 + 16;
  static_assert(BM * kPitch <= kStages * T::kStageBytes, "the tile fits the ring");
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * q;
    const bool has = p.bias != nullptr && n0 + c < p.co;
    const float b0 = has ? __ldg(p.bias + n0 + c) : 0.0f;
    const float b1 = has ? __ldg(p.bias + n0 + c + 1) : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + warp * 16 + g + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(smem + r * kPitch + c * 2) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
    }
  }
  __syncthreads();
#pragma unroll 4
  for (int i = tid; i < BM * BN / 8; i += T::kThreads) {
    const int r = i / (BN / 8);
    const int c = 8 * (i % (BN / 8));
    if (m0 + r < p.m && n0 + c < p.co)
      *reinterpret_cast<uint4*>(p.y + static_cast<size_t>(m0 + r) * p.co + n0 + c) =
          *reinterpret_cast<const uint4*>(smem + r * kPitch + c * 2);
  }
}

template <int BM, int BN>
cudaError_t launch(const Conv& p, int vec, cudaStream_t stream) {
  using T = Tile<BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      conv1d_bf16_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(p.m, BM), cdiv(p.co, BN));
  conv1d_bf16_kernel<BM, BN><<<grid, T::kThreads, T::kSmemBytes, stream>>>(p, vec);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_bn(int bn, const Conv& p, int vec, cudaStream_t s) {
  switch (bn) {
    case 16: return launch<BM, 16>(p, vec, s);
    case 32: return launch<BM, 32>(p, vec, s);
    case 64: return launch<BM, 64>(p, vec, s);
    case 128: return launch<BM, 128>(p, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace cbw

// One conv (the layout above) on `stream`, in the tile bm x bn (bm 64 or
// 128, bn 16, 32, 64 or 128).  shape: n, lin, ci, lout, co, k, stride,
// pad, dil.  x, w: bf16, 16-byte aligned; bias: fp32 or null; y: bf16.
// Returns the cudaError_t of the shared-memory opt-in or of the launch (0
// on success).
extern "C" int conv1d_bf16_run(const void* x, const void* w, const void* bias, void* y,
                               const int* shape, int bm, int bn, void* stream) {
  cbw::Conv p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.m = shape[0] * shape[3];
  p.lin = shape[1];
  p.ci = shape[2];
  p.lout = shape[3];
  p.co = shape[4];
  p.kc = shape[5] * shape[2];
  p.stride = shape[6];
  p.pad = shape[7];
  p.dil = shape[8];
  if (p.m <= 0 || p.co % 8 != 0 || p.ci <= 0 || p.kc <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = p.ci % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 64) return static_cast<int>(cbw::launch_bn<64>(bn, p, vec, s));
  if (bm == 128) return static_cast<int>(cbw::launch_bn<128>(bn, p, vec, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
