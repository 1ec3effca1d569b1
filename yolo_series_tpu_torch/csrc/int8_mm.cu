// Tensor-core matmul C = A @ B^T for the quantized 1x1 convs (K4) and its
// bench template (K4b), for Hopper (sm_90a): wgmma on operands that TMA
// loads into an mbarrier ring, fed by one producer warp; persistent CTAs.
//
// Replaces two Pallas TPU kernels:
//  - yolo_series_tpu/ops/pallas_int8.py `_kernel` (through
//    `int8_matmul_dequant`): (M, K) int8 @ (K, N) int8 -> int32, then the
//    epilogue acc * scale[n] + bias[n] in fp32 (entry `int8_mm_dequant`);
//  - tools/bench_int8_pallas.py `_mm_kernel` (through `pallas_matmul`): the
//    same blocked product with no epilogue, int8 -> int32 (`int8_mm_raw`)
//    or bf16 -> fp32 (`bf16_mm_raw`).
//
// Layouts: A is (M, K) row-major (NHWC activations viewed as rows of
// channels), B is (N, K) row-major (the OIHW weight of a 1x1 conv): both
// K-major, which is what 8-bit wgmma reads, so neither is transposed. C is
// (M, N) row-major. N and the K bytes are multiples of 128 (the wrapper
// checks); M is free: TMA zero-fills the rows past M and they are not
// stored.
//
// Design. A tile is BM x BN outputs, (BM, BN) one of (128, 128), (128, 64)
// and (64, 64); the Python wrapper picks it per shape
// (`ops/int8_mm.pick_tile`): the largest that still gives the SMs work, so
// that the small-M convs (20 px: M = 3200) fill the card. Two consumer
// warpgroups split the tile along M (BM = 128: 64 rows each) or along N
// (BM = 64: BN / 2 columns each), and each issues wgmma m64nWNk32 (s8 ->
// s32) or m64nWNk16 (bf16 -> f32), four per 128-byte K step, accumulating
// in registers. One producer warp issues every load: per K step one TMA box
// of BM rows x 128 bytes of A and one of BN rows of B, 128-byte swizzled,
// into a ring of 3-6 stages (96 KB) with a full and an empty mbarrier
// each. CTAs are persistent, two an SM: CTA i takes tiles i, i + grid, ...,
// and the ring runs on across tiles, so the producer loads the next tile's
// operands while the consumers run this tile's epilogue, and one CTA's
// epilogue overlaps the other CTA's products. Tile t is (M tile t / (N /
// BN), N tile t % (N / BN)): the N tiles of one M tile run side by side and
// share A through L2, so A is read from device memory about once.
//
// Bound on this card: bytes. At the yolov7 shapes (K <= 2048, N <= 1024)
// a conv does 2 K operations per output and moves 4 bytes of fp32 output
// per output, plus K bytes of A per row: ~85 int8 operations per byte
// against the card's ~590 (1979 TOP/s over 3.35 TB/s). What the design
// does about it: each output is written once, straight from the
// accumulators with 16-byte streaming stores (a lane pair swaps one value
// pair first), while the ring keeps the next tile's loads in flight, and A
// is read once. The 20 px convs stay latency-bound: their 1-5 us of bytes
// are about what a launch and its first loads cost.
// setmaxnreg is not used: it moves registers between whole warpgroups, and
// with one producer warp and two CTAs an SM each thread already has the
// ~112 registers a consumer needs (64 accumulators at WN = 128).
//
// Rounding: the int32 sum is exact. The epilogue rounds as the plain
// version does, int -> fp32 (rn), times scale (rn), plus bias (rn), each on
// its own; the file is also built with -fmad=false. The bf16 form sums in
// fp32 in the tensor cores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kStepBytes = 128;            // K bytes a stage: one swizzled row
constexpr int kRingBytes = 96 * 1024;      // operand ring of a CTA
constexpr int kCtasPerSm = 2;

template <int BM, int BN>
struct Tile {
  static constexpr int kStageBytes = (BM + BN) * kStepBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;  // 3, 4 or 6
  static constexpr int kWN = BM == 128 ? BN : BN / 2;       // a warpgroup's columns
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

struct Params {
  CUtensorMap a;  // (M, K): boxes of BM rows x 128 bytes
  CUtensorMap b;  // (N, K): boxes of BN rows x 128 bytes
  const float* scale;
  const float* bias;
  void* out;
  int M, N, ktiles, n_tiles, tiles;
};

// ------------------------------------------------------------ PTX ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

// wait until the barrier's phase of this parity has completed; a lost
// arrival traps (a launch error) after ~2^28 polls instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map, int c0,
                                          int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand, 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (sbo); the K step within
// the swizzled row is an offset of the start address (32 bytes a step)
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// keep the compiler from moving accumulator reads or writes across wgmma
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N) += A (64 x 32 bytes, K-major) * B (N x 32 bytes, K-major)
__device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
      "}, %16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,"
      "%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,"
      "%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,"
      "%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,"
      "%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,"
      "%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,"
      "%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int WN>
__device__ __forceinline__ void wgmma(int (&d)[WN / 2], uint64_t da, uint64_t db) {
  if constexpr (WN == 32) {
    wgmma_s8_n32(d, da, db);
  } else if constexpr (WN == 64) {
    wgmma_s8_n64(d, da, db);
  } else {
    wgmma_s8_n128(d, da, db);
  }
}

template <int WN>
__device__ __forceinline__ void wgmma(float (&d)[WN / 2], uint64_t da, uint64_t db) {
  if constexpr (WN == 32) {
    wgmma_bf16_n32(d, da, db);
  } else if constexpr (WN == 64) {
    wgmma_bf16_n64(d, da, db);
  } else {
    wgmma_bf16_n128(d, da, db);
  }
}

// ---------------------------------------------------------- kernel ---

enum class Epi { kDequant, kRaw };

template <typename T, Epi kEpi, int BM, int BN>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
int8_mm_kernel(const __grid_constant__ Params p) {
  using Acc = typename std::conditional<std::is_same<T, int8_t>::value, int, float>::type;
  constexpr int S = Tile<BM, BN>::kStages;
  constexpr int kStage = Tile<BM, BN>::kStageBytes;
  constexpr int WN = Tile<BM, BN>::kWN;
  extern __shared__ uint8_t smem_raw[];
  // swizzled TMA boxes and wgmma operands want 1024-byte alignment
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * kStage);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: one lane issues every TMA load ----
    if (tid == kConsumers) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&p.a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&p.b))
                   : "memory");
      int s = 0, ph = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile / p.n_tiles) * BM;
        const int n0 = (tile % p.n_tiles) * BN;
        for (int kt = 0; kt < p.ktiles; ++kt) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], kStage);
          uint8_t* st = smem + s * kStage;
          const int k0 = kt * (kStepBytes / static_cast<int>(sizeof(T)));
          tma_load2(st, &p.a, k0, m0, &full[s]);
          tma_load2(st + BM * kStepBytes, &p.b, k0, n0, &full[s]);
          if (++s == S) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups: wgmma on the stages that have landed ----
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int a_row = BM == 128 ? wg * 64 : 0;  // this warpgroup's rows of the A box
    const int b_row = BM == 128 ? 0 : wg * WN;  // and of the B box (its columns)
    Acc acc[WN / 2];
    int s = 0, ph = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.n_tiles) * BM;
      const int n0 = (tile % p.n_tiles) * BN;
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) acc[i] = Acc(0);
      int rel = -1;  // the stage read by the step still in flight
      for (int kt = 0; kt < p.ktiles; ++kt) {
        mbar_wait(&full[s], ph);
        const uint8_t* a = smem + s * kStage + a_row * kStepBytes;
        const uint8_t* b = smem + s * kStage + (BM + b_row) * kStepBytes;
        fence_regs(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kStepBytes / 32; ++kk)
          wgmma<WN>(acc, desc_sw128(a + kk * 32), desc_sw128(b + kk * 32));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        fence_regs(acc);
        // keep this step's products in flight; the previous step's are done
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_regs(acc);
        if (rel >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[rel]);
        }
        rel = s;
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[rel]);

      // ---- epilogue: straight from the accumulators, 16-byte stores ----
      // layout (m64nWN): acc[4j + e] is row 16 warp + lane/4 + 8 (e/2) of
      // the warpgroup's 64, column 8j + 2 (lane % 4) + e % 2. For blocks j,
      // j + 1, lanes 2i and 2i + 1 swap one pair: the even lane then holds
      // columns 2q..2q+3 of block j, the odd lane 2q-2..2q+1 of block j + 1
      // (q = lane % 4), and each quad writes 64 contiguous bytes of a row
      const int row0 = m0 + a_row + warp * 16 + lane / 4;
      const bool in0 = row0 < p.M, in1 = row0 + 8 < p.M;
      const bool even = (lane & 1) == 0;
      const int q = lane % 4;
#pragma unroll
      for (int j = 0; j < WN / 8; j += 2) {
        float y[2][2][2];  // [block j, j + 1][row h][column e], fp32 or int32 bits
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float2 sc, bi;
          if constexpr (kEpi == Epi::kDequant) {
            const int col = n0 + b_row + (j + jj) * 8 + 2 * q;
            sc = *reinterpret_cast<const float2*>(p.scale + col);
            bi = *reinterpret_cast<const float2*>(p.bias + col);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const Acc v = acc[4 * (j + jj) + 2 * h + e];
              if constexpr (kEpi == Epi::kDequant) {
                y[jj][h][e] = __fadd_rn(__fmul_rn(__int2float_rn(v), e ? sc.y : sc.x),
                                        e ? bi.y : bi.x);
              } else if constexpr (std::is_same<Acc, int>::value) {
                y[jj][h][e] = __int_as_float(v);
              } else {
                y[jj][h][e] = v;
              }
            }
          }
        }
        const int col = n0 + b_row + (even ? j * 8 + 2 * q : (j + 1) * 8 + 2 * (q - 1));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float r0 = __shfl_xor_sync(0xffffffffu, even ? y[1][h][0] : y[0][h][0], 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, even ? y[1][h][1] : y[0][h][1], 1);
          const float4 v = even ? make_float4(y[0][h][0], y[0][h][1], r0, r1)
                                : make_float4(r0, r1, y[1][h][0], y[1][h][1]);
          // streaming store: the output is not read again by this kernel
          if (h == 0 ? in0 : in1)
            __stcs(reinterpret_cast<float4*>(static_cast<float*>(p.out) +
                                             static_cast<size_t>(row0 + 8 * h) * p.N + col),
                   v);
        }
      }
    }
  }
}

// ------------------------------------------------------------ host ---

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not the runtime: reached through
// the runtime's entry-point query, so the library links the runtime only
EncodeTiled encoder() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load();
  if (f == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                       12000, cudaEnableDefault, &q);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    f = reinterpret_cast<EncodeTiled>(ptr);
    fn.store(f);
  }
  return f;
}

// a (rows, cols) row-major matrix of `T`, loaded in boxes of box_rows rows
// x 128 bytes; rows past the end read as zeros
template <typename T>
bool encode_rows(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  EncodeTiled f = encoder();
  if (f == nullptr) return false;
  const CUtensorMapDataType dt = std::is_same<T, int8_t>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kStepBytes / sizeof(T)),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t ones[2] = {1, 1};
  return f(map, dt, 2, const_cast<void*>(base), dims, strides, box, ones,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the shared-memory opt-in, once per kernel and device (a host call, kept
// out of the launches a CUDA graph captures)
template <typename T, Epi kEpi, int BM, int BN>
int launch_tile(const Params& p, int ctas, void* stream) {
  auto kern = int8_mm_kernel<T, kEpi, BM, BN>;
  static std::atomic<unsigned> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(opted_in.load() & (1u << dev))) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile<BM, BN>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in.fetch_or(1u << dev);
  }
  kern<<<ctas, kThreads, Tile<BM, BN>::kSmem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, Epi kEpi>
int launch(const void* a, const void* b, const void* scale, const void* bias,
           void* out, int M, int N, int K, int bm, int bn, int ctas, void* stream) {
  const bool tile_ok = (bm == 128 && (bn == 128 || bn == 64)) || (bm == 64 && bn == 64);
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!tile_ok || !aligned || M < 1 || N < bn || N % bn != 0 || K < 1 || ctas < 1 ||
      (static_cast<long long>(K) * sizeof(T)) % kStepBytes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = static_cast<long long>((M + bm - 1) / bm) * (N / bn);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  std::memset(&p, 0, sizeof(p));
  if (!encode_rows<T>(&p.a, a, M, K, bm) || !encode_rows<T>(&p.b, b, N, K, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.M = M;
  p.N = N;
  p.ktiles = static_cast<int>(static_cast<long long>(K) * sizeof(T) / kStepBytes);
  p.n_tiles = N / bn;
  p.tiles = static_cast<int>(tiles);
  const int grid = ctas < p.tiles ? ctas : p.tiles;
  if (bn == 128) return launch_tile<T, kEpi, 128, 128>(p, grid, stream);
  if (bm == 128) return launch_tile<T, kEpi, 128, 64>(p, grid, stream);
  return launch_tile<T, kEpi, 64, 64>(p, grid, stream);
}

}  // namespace

// Every entry takes the tile (bm, bn: 128 x 128, 128 x 64 or 64 x 64) and
// the number of persistent CTAs (at most one a tile is launched), and
// returns cudaErrorInvalidValue on what the kernel does not take.

// K4: out (M, N) fp32 = (xq (M, K) int8 @ wq (N, K) int8 ^T) * scale[n] + bias[n]
extern "C" int int8_mm_dequant(const void* xq, const void* wq, const void* scale,
                               const void* bias, void* out, int M, int N, int K, int bm,
                               int bn, int ctas, void* stream) {
  return launch<int8_t, Epi::kDequant>(xq, wq, scale, bias, out, M, N, K, bm, bn, ctas,
                                       stream);
}

// K4b, int8: out (M, N) int32 = a (M, K) int8 @ b (N, K) int8 ^T
extern "C" int int8_mm_raw(const void* a, const void* b, void* out, int M, int N, int K,
                           int bm, int bn, int ctas, void* stream) {
  return launch<int8_t, Epi::kRaw>(a, b, nullptr, nullptr, out, M, N, K, bm, bn, ctas,
                                   stream);
}

// K4b, bf16: out (M, N) fp32 = a (M, K) bf16 @ b (N, K) bf16 ^T
extern "C" int bf16_mm_raw(const void* a, const void* b, void* out, int M, int N, int K,
                           int bm, int bn, int ctas, void* stream) {
  return launch<__nv_bfloat16, Epi::kRaw>(a, b, nullptr, nullptr, out, M, N, K, bm, bn,
                                          ctas, stream);
}
