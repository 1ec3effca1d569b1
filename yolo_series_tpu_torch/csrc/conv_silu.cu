// NHWC convolution + bias + SiLU, bf16 in/out, fp32 accumulation, for
// Hopper (sm_90a): implicit GEMM on wgmma, operands loaded by TMA into
// mbarrier rings by one producer warp, persistent CTAs.
//
// One kernel serves two Pallas TPU kernels of the serving path, as a chain
// of launches over whole images:
//   * yolo_series_tpu/ops/pallas_stem.py `_make_stem_call` (FusedStem): the
//     stem tail is 3 launches (k2/s1 pad (1,0), k3/s1, k3/s2). The first
//     reads its input at a row offset, past the 3 halo rows the producer
//     conv emits, and zero-pads around the real rows — the per-stage
//     re-zeroing the Pallas kernel does with `mask_rows`.
//   * yolo_series_tpu/ops/pallas_elan.py `_make_elan_call` (FusedELAN): an
//     ELAN span with a chain of n 3x3 convs is n + 2 launches (the two 1x1
//     convs of the span input as one launch with the weight [w5 | w4], the
//     n chained 3x3, the output 1x1): 6 for yolov7's spans (n = 4), 8 for
//     an E-ELAN span of yolov7-e6e (n = 6). Each writes into a channel
//     slice of one preallocated concat buffer (channel stride + offset), so
//     the concat costs nothing.
// Rounding follows the Pallas kernels: fp32 accumulate, + bias in fp32,
// SiLU in fp32, one round to bf16 at the store. With a residual (the
// output launch of the second span of an E-ELAN pair, whose Shortcut adds
// the first span's output), the epilogue adds the residual's bf16 value in
// fp32 after SiLU, before that one round: bf16(silu(acc + b) + r). The
// residual is its own template instantiation, so the launches without one
// run the code they ran before.
//
// GEMM view: M = output pixels, N = output channels, K = taps x channels.
// A tile is 128 MW GEMM rows x BN output channels (BN 128 with MW 1, or BN
// 64 with MW 1 or 2): two consumer warpgroups of 64 MW rows each issue MW
// wgmma m64nBNk16 a k-step against the same weights (fp32 accumulators in
// registers); one producer warp issues every load.
//   * A: per 64-channel block, ONE TMA box of the NHWC input covers all the
//     taps: a patch of (BH + ext) x P pixels, P = BW + ext, for an output
//     tile of BH x BW pixels of one image (ext = 2 for a 3x3 conv). GEMM row
//     m is patch pixel (m / P, m % P), so tap (dy, dx) is the patch read from
//     row dy * P + dx on: a window, not a new load. Rows with m % P >= BW
//     are padding and are not stored. The tensor map is encoded over the
//     LOGICAL rows and channels (base pointer at row x_row0 and channel
//     x_coff, dims (c, W, h, B) with the real strides), so out-of-range
//     coordinates read zeros: the conv's zero padding, and never the stem's
//     halo rows or the neighbouring concat channels. A 32-channel input
//     loads a 64-wide box whose upper half is out of range and zero-filled
//     (the 128-byte swizzle wants 64 bf16 a row).
//   * Stride 2 (the stem's last stage) uses four tensor maps, one per
//     (row, column) parity of the input, each a stride-2 view with the
//     doubled strides: a patch per parity, and tap (dy, dx) is a window of
//     the patch of parity ((dy - pad_t) mod 2, (dx - pad_l) mod 2).
//   * B: per tap, BN/64 box loads of the HWIO weight viewed as (CO, C,
//     taps), N-contiguous: wgmma reads it MN-major (trans-b).
//   * Two rings: input patches and per-tap weights (56 + 48 KB, or 86 + 24
//     KB with MW 2), so two CTAs fit on an SM. Persistent: each CTA walks
//     tiles i, i + grid, ...
//     with the rings running on across tiles, so the producer loads the
//     next tile during the epilogue, and one CTA's epilogue overlaps the
//     other CTA's products.
//   * Epilogue in registers: + bias, SiLU (fast exp and divide, well under
//     bf16's rounding), + the residual where there is one (4-byte loads of
//     the two columns a lane holds), packed to bf16x2, gathered across each lane quad
//     with shuffles into 8-column rows, written with 16-byte stores into
//     the output channel slice (y_coff, y_cstride); ragged pixels and
//     channels are masked.
// Tile choice per launch: BN drops to 64 where CO <= 64 or 128-wide tiles
// would leave SMs idle (the 20 px convs: 3200 pixels, 32 tiles of 128 rows,
// so their 3x3 chains run 128 tiles of 128 x 64 instead of 64 of 128 x 128).
// With BN = 64, MW = 2 where the grid keeps two tiles for every CTA: it
// halves the weight traffic a pixel, which bounds the 64-channel convs.
//
// Bound on this card: per conv, the larger of 2*M*N*K / 989 TFLOP/s and
// (input + weights + output bytes) / 3.35 TB/s; the 1x1 convs and the 64-
// channel 3x3 convs are bound by bytes, the 3x3 chains of the wider spans by
// operations. What still holds the 64-channel 3x3 convs back: every tile
// reloads the conv's weights from L2 (72 KB a 240-pixel tile for K2's
// second stage).
// Every stage still writes its output to device memory: the single-launch
// span (intermediates in shared memory) is later work.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cstring>

namespace {

constexpr int kBM = 128;          // GEMM rows a tile at MW = 1
constexpr int kBK = 64;           // input channels per K step (128 bytes)
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kBoxBytes = 64 * kBK * 2;    // one 64 x 64 weight box, 8 KB
constexpr int kMaxASlots = 4;
constexpr int kMaxTaps = 16;
constexpr int kCtasPerSm = 2;

struct Params {
  CUtensorMap xa[4];  // input by (row, column) parity; stride 1 uses xa[0]
  CUtensorMap w;      // weight (CO, C, taps)
  const __nv_bfloat16* bias;
  __nv_bfloat16* y;   // output channel slice: y + y_coff, pixel stride y_cstride
  const __nv_bfloat16* r;  // residual channel slice (r + r_coff), or null
  int oh, ow, y_cstride, r_cstride;
  int co, cblocks, n_tiles, tiles_w, tiles_h, tiles;
  int bh, bw;         // output tile: BH rows x BW columns of one image
  int pitch;          // P = BW + the taps' column extent: patch pixels a row
  int sy0, sx0;       // the taps' smallest row / column shift (parity view)
  int a_slot, a_slots, a_tx;  // patch slot bytes, slots, bytes of one patch
  int units;                  // patches per channel block (parities with taps)
  int unit_map[4], unit_steps[4];         // parity map, taps of each patch
  int step_tap[kMaxTaps], step_off[kMaxTaps];  // tap, its window's first row
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

__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, int c0,
                                          int c1, int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, int c0,
                                          int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. Byte offsets: lbo is
// the stride between 64-element atoms along MN (MN-major B), sbo between
// 8-row groups. wgmma, like TMA, applies the swizzle to the shared-memory
// address bits themselves, so a tap's window may start at any 128-byte row
// of a patch that TMA swizzled from a 1024-byte boundary, with a base
// offset of 0 (a base offset of (start >> 7) & 7 gives wrong products).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// keep the compiler from moving accumulator reads or writes across wgmma
template <int M, int R>
__device__ __forceinline__ void fence_regs(float (&d)[M][R]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[m][i])::"memory");
}

// d (64 x N, fp32) += A (64 x 16, K-major) * B (16 x N, MN-major)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) {
    wgmma_n64(d, da, db);
  } else {
    wgmma_n128(d, da, db);
  }
}

// v[k] for a k known only at run time, without spilling v to local memory
__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[4], int k) {
  return k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3];
}

__device__ __forceinline__ float silu(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}

// ---------------------------------------------------------- kernel ---

// Shared memory of a CTA (two fit on an SM): an input-patch ring and a
// per-tap weight ring. With MW = 2 each warpgroup computes 2 x 64 rows
// against the same weights (half the weight traffic a pixel), and the
// patches, twice as tall, take most of the room.
template <int BN, int MW>
struct Cfg {
  static constexpr int kARegion = (MW == 1 ? 56 : 86) * 1024;
  static constexpr int kBSlot = BN * kBK * 2;             // one tap's weights
  static constexpr int kBSlots = (MW == 1 ? 48 : 24) * 1024 / kBSlot;
  static constexpr int kBars = 2 * kMaxASlots + 2 * kBSlots;
  static constexpr int kSmem = kARegion + kBSlots * kBSlot + kBars * 8 + 1024;
};

// Persistent, two CTAs an SM: CTA i computes tiles i, i + grid, ... (the N
// tiles of one M tile are neighbours in that order: they share A in L2). The
// rings run on across tiles, so the producer loads the next tile while the
// consumers finish this one, and one CTA's epilogue overlaps the other's
// products.
template <int BN, int MW, bool RES>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
conv_silu_kernel(const __grid_constant__ Params p) {
  constexpr int SB = Cfg<BN, MW>::kBSlots;
  constexpr int kBSlot = Cfg<BN, MW>::kBSlot;
  extern __shared__ uint8_t smem_raw[];
  // swizzled TMA boxes and wgmma operands want 1024-byte alignment
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* b_ring = smem + Cfg<BN, MW>::kARegion;
  uint64_t* a_full = reinterpret_cast<uint64_t*>(b_ring + SB * kBSlot);
  uint64_t* a_empty = a_full + kMaxASlots;
  uint64_t* b_full = a_empty + kMaxASlots;
  uint64_t* b_empty = b_full + SB;

  const int tid = threadIdx.x;
  int ow0, oh0, img, n0;
  auto locate = [&](int tile) {
    n0 = (tile % p.n_tiles) * BN;
    int m_t = tile / p.n_tiles;
    ow0 = (m_t % p.tiles_w) * p.bw;
    m_t /= p.tiles_w;
    oh0 = (m_t % p.tiles_h) * p.bh;
    img = m_t / p.tiles_h;
  };

  if (tid == 0) {
    for (int s = 0; s < kMaxASlots; ++s) {
      mbar_init(&a_full[s], 1);
      mbar_init(&a_empty[s], kConsumers / 32);  // one arrive per consumer warp
    }
    for (int s = 0; s < SB; ++s) {
      mbar_init(&b_full[s], 1);
      mbar_init(&b_empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // K loop, the same in both roles: per 64-channel block, one input patch per
  // parity unit (one unit at stride 1), then each tap of that unit
  if (tid >= kConsumers) {
    // ---- producer warp: one lane issues every TMA load ----
    if (tid == kConsumers) {
      int as = 0, aph = 0, bs = 0, bph = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        locate(tile);
        for (int cb = 0; cb < p.cblocks; ++cb) {
          const int c0 = cb * kBK;
          for (int u = 0, j = 0; u < p.units; ++u) {
            mbar_wait(&a_empty[as], aph ^ 1);
            mbar_expect_tx(&a_full[as], p.a_tx);
            tma_load4(smem + as * p.a_slot, &p.xa[p.unit_map[u]], c0, ow0 + p.sx0,
                      oh0 + p.sy0, img, &a_full[as]);
            if (++as == p.a_slots) {
              as = 0;
              aph ^= 1;
            }
            for (int t = 0; t < p.unit_steps[u]; ++t, ++j) {
              mbar_wait(&b_empty[bs], bph ^ 1);
              mbar_expect_tx(&b_full[bs], BN / 64 * kBoxBytes);
#pragma unroll
              for (int q = 0; q < BN / 64; ++q)
                tma_load3(b_ring + bs * kBSlot + q * kBoxBytes, &p.w, n0 + q * 64, c0,
                          p.step_tap[j], &b_full[bs]);
              if (++bs == SB) {
                bs = 0;
                bph ^= 1;
              }
            }
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups: wgmma on the operands that have landed ----
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    float acc[MW][BN / 2];
    int as = 0, aph = 0, bs = 0, bph = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      locate(tile);
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mi][i] = 0.0f;
      int rel_b = -1, rel_a = -1;  // slots read by the step still in flight
      for (int cb = 0; cb < p.cblocks; ++cb) {
        for (int u = 0, j = 0; u < p.units; ++u) {
          mbar_wait(&a_full[as], aph);
          const uint8_t* a_rows = smem + as * p.a_slot + wg * MW * 64 * 128;
          for (int t = 0; t < p.unit_steps[u]; ++t, ++j) {
            mbar_wait(&b_full[bs], bph);
            // this tap's A: the patch rows from its window offset on
            const uint8_t* a = a_rows + p.step_off[j] * 128;
            const uint8_t* b = b_ring + bs * kBSlot;
            fence_regs(acc);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk) {
              const uint64_t db = desc_sw128(b + kk * 16 * 128, kBoxBytes, 1024);
#pragma unroll
              for (int mi = 0; mi < MW; ++mi)
                wgmma<BN>(acc[mi], desc_sw128(a + mi * 64 * 128 + kk * 32, 16, 1024), db);
            }
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            fence_regs(acc);
            // keep this step's products in flight; the previous step's are done
            asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
            fence_regs(acc);
            if (rel_b >= 0) {
              __syncwarp();
              if (lane == 0) {
                mbar_arrive(&b_empty[rel_b]);
                if (rel_a >= 0) mbar_arrive(&a_empty[rel_a]);
              }
            }
            rel_b = bs;
            rel_a = t == p.unit_steps[u] - 1 ? as : -1;
            if (++bs == SB) {
              bs = 0;
              bph ^= 1;
            }
          }
          if (++as == p.a_slots) {
            as = 0;
            aph ^= 1;
          }
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&b_empty[rel_b]);
        mbar_arrive(&a_empty[rel_a]);
      }

      // ---- epilogue: bias + SiLU (+ residual) in fp32, 16-byte rows to y ----
      // accumulator layout (m64nN): acc[mi][4j + e] is row 64 mi + 16 warp +
      // lane/4 + 8 (e/2) of the warpgroup's rows, column 8j + 2 (lane % 4) +
      // e % 2. GEMM row m is patch pixel (m / P, m % P): an output pixel of
      // the tile where m % P < BW, else padding. Thread row u = 2 mi + e/2.
      const int q = lane % 4;
      __nv_bfloat16* row_ptr[2 * MW];
      const __nv_bfloat16* res_ptr[2 * MW];  // read only with RES
#pragma unroll
      for (int u = 0; u < 2 * MW; ++u) {
        const int m = (wg * MW + u / 2) * 64 + warp * 16 + lane / 4 + 8 * (u % 2);
        const int r = m / p.pitch, c = m - r * p.pitch;
        const bool in = c < p.bw && r < p.bh && oh0 + r < p.oh && ow0 + c < p.ow;
        const size_t pix = static_cast<size_t>(img * p.oh + oh0 + r) * p.ow + ow0 + c;
        row_ptr[u] = in ? p.y + pix * p.y_cstride : nullptr;
        if constexpr (RES) res_ptr[u] = in ? p.r + pix * p.r_cstride : nullptr;
      }
      // four column blocks at a time: lane q of each quad gathers block j0 + q
      // (8 columns, 16 bytes) of its two rows from the quad's four lanes
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += 4) {
        uint32_t packed[2 * MW][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = n0 + (j0 + i) * 8 + 2 * q;
          float b0 = 0.0f, b1 = 0.0f;
          if (col < p.co) {
            const __nv_bfloat162 bb =
                *reinterpret_cast<const __nv_bfloat162*>(p.bias + col);
            b0 = __low2float(bb);
            b1 = __high2float(bb);
          }
#pragma unroll
          for (int u = 0; u < 2 * MW; ++u) {
            const float* a = &acc[u / 2][4 * (j0 + i) + 2 * (u % 2)];
            float v0 = silu(a[0] + b0), v1 = silu(a[1] + b1);
            if constexpr (RES) {
              if (res_ptr[u] != nullptr && col < p.co) {
                const __nv_bfloat162 rr =
                    *reinterpret_cast<const __nv_bfloat162*>(res_ptr[u] + col);
                v0 += __low2float(rr);
                v1 += __high2float(rr);
              }
            }
            const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
            packed[u][i] = *reinterpret_cast<const uint32_t*>(&o);
          }
        }
        const int col = n0 + (j0 + q) * 8;
#pragma unroll
        for (int u = 0; u < 2 * MW; ++u) {
          uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            // lane i sends its word of block j0 + (i + r) % 4; lane q takes lane
            // (q - r) % 4's, which is that lane's two columns of block j0 + q
            const uint32_t got = __shfl_sync(0xffffffffu, pick(packed[u], (q + r) & 3),
                                             (lane & ~3) | ((q - r) & 3));
            const int k = (q - r) & 3;
            out[0] = k == 0 ? got : out[0];
            out[1] = k == 1 ? got : out[1];
            out[2] = k == 2 ? got : out[2];
            out[3] = k == 3 ? got : out[3];
          }
          if (row_ptr[u] != nullptr && col < p.co)
            *reinterpret_cast<uint4*>(row_ptr[u] + col) =
                make_uint4(out[0], out[1], out[2], out[3]);
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

bool encode(CUtensorMap* map, int rank, const void* base, const cuuint64_t* dims,
            const cuuint64_t* strides_bytes, const cuuint32_t* box) {
  EncodeTiled f = encoder();
  if (f == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return f(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
           strides_bytes, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
           CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the shared-memory opt-in, once per kernel and device (a host call, kept
// out of the launches a CUDA graph captures)
template <int BN, int MW, bool RES>
cudaError_t opt_in(int dev) {
  static std::atomic<unsigned> done{0};
  if (done.load() & (1u << dev)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(conv_silu_kernel<BN, MW, RES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg<BN, MW>::kSmem);
  if (err == cudaSuccess) done.fetch_or(1u << dev);
  return err;
}

int sm_count(int dev) {
  static std::atomic<int> count[32];
  int n = count[dev].load();
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
    count[dev].store(n);
  }
  return n;
}

template <int BN, int MW, bool RES>
int launch_kernel(Params& p, int blocks, int dev, cudaStream_t stream) {
  cudaError_t err = opt_in<BN, MW, RES>(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_silu_kernel<BN, MW, RES><<<blocks, kThreads, Cfg<BN, MW>::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int MW>
int launch(Params& p, int blocks, int dev, cudaStream_t stream) {
  return p.r != nullptr ? launch_kernel<BN, MW, true>(p, blocks, dev, stream)
                        : launch_kernel<BN, MW, false>(p, blocks, dev, stream);
}

int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

// Output tile: BH x BW pixels of one image, computed as GEMM rows m = bh * P
// + bw over a patch of (BH + ext_y) x P input pixels (P = BW + ext_x): then
// tap (dy, dx) is the patch from row (shift_y - s0) P + (shift_x - s0) on,
// and the rows with bw >= BW are padding. The fewest tiles an image for
// `rows` GEMM rows a tile, with patch slots that fit twice in `region`.
struct Tiling {
  int bw = 0, bh = 0, slot = 0;
  long long tiles = 0;  // per image
};

Tiling tiling(int rows, int region, int OH, int OW, int ext_y, int ext_x) {
  Tiling best;
  for (int cw = OW < rows ? OW : rows; cw >= 1; --cw) {
    const int pitch = cw + ext_x;
    if (pitch > rows) continue;
    int ch = (rows / pitch) < OH ? (rows / pitch) : OH;
    if (ch + ext_y > 256) ch = 256 - ext_y;  // a TMA box is at most 256 a side
    const int slot = ((ext_y * pitch + ext_x + rows) * 128 + 1023) / 1024 * 1024;
    if (2 * slot > region) continue;
    const long long t = static_cast<long long>((OH + ch - 1) / ch) * ((OW + cw - 1) / cw);
    if (best.bw == 0 || t < best.tiles) {
      best.bw = cw;
      best.bh = ch;
      best.slot = slot;
      best.tiles = t;
    }
  }
  return best;
}

}  // namespace

// y[b, oh, ow, y_coff + n] = bf16(silu(sum x * w + bias) [+ r[b, oh, ow,
// r_coff + n]]) for the logical input x rows [x_row0, x_row0 + H) and
// channels [x_coff, x_coff + C) of a (B, x_rows, W, x_cstride) tensor; w is
// (KH, KW, C, CO), y (B, OH, OW, y_cstride), the residual r, where not null,
// (B, OH, OW, r_cstride). Writes the tile it launches, {GEMM rows, N}, to
// tile[0..1]. Returns cudaErrorInvalidValue on what the kernel does not take.
extern "C" int conv_silu_nhwc(const void* x, const void* w, const void* b, void* y,
                              int B, int H, int W, int C, int x_rows, int x_row0,
                              int x_cstride, int x_coff, int KH, int KW, int stride,
                              int pad_t, int pad_l, int OH, int OW, int CO,
                              int y_cstride, int y_coff, const void* r, int r_cstride,
                              int r_coff, void* stream, int* tile) {
  const bool ok =
      C % 32 == 0 && C > 0 && CO % 16 == 0 && CO > 0 && x_cstride % 8 == 0 &&
      x_coff % 8 == 0 && y_cstride % 8 == 0 && y_coff % 8 == 0 && B >= 1 && OH >= 1 &&
      OW >= 1 && (stride == 1 || stride == 2) && H >= stride && W >= stride &&
      KH >= 1 && KW >= 1 && KH * KW <= kMaxTaps && x_row0 >= 0 && x_row0 + H <= x_rows &&
      pad_t >= 0 && pad_l >= 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
      (reinterpret_cast<uintptr_t>(w) % 16) == 0 &&
      (reinterpret_cast<uintptr_t>(b) % 4) == 0 &&
      (reinterpret_cast<uintptr_t>(y) % 16) == 0 &&
      (r == nullptr || ((reinterpret_cast<uintptr_t>(r) % 16) == 0 && r_cstride % 8 == 0 &&
                        r_coff % 8 == 0 && r_coff >= 0 && r_coff + CO <= r_cstride));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);

  Params p;
  std::memset(&p, 0, sizeof(p));
  // tap (dy, dx) reads the input at stride * (o + shift) + parity: the shifts
  // span [s0, s0 + ext] in each direction
  p.sy0 = floor_div(-pad_t, stride);
  p.sx0 = floor_div(-pad_l, stride);
  const int ext_y = floor_div(KH - 1 - pad_t, stride) - p.sy0;
  const int ext_x = floor_div(KW - 1 - pad_l, stride) - p.sx0;
  // N tile 128, or 64 where CO <= 64 or 128-wide tiles leave SMs idle; with
  // N = 64, 256 rows a tile (MW = 2) where there are still two tiles for
  // every CTA slot
  Tiling t = tiling(kBM, Cfg<128, 1>::kARegion, OH, OW, ext_y, ext_x);
  if (t.bw == 0) return static_cast<int>(cudaErrorInvalidValue);
  int bn = CO > 64 ? 128 : 64, mw = 1;
  if (bn == 128 && B * t.tiles * ((CO + 127) / 128) < sm_count(dev)) bn = 64;
  if (bn == 64) {
    const Tiling t2 = tiling(2 * kBM, Cfg<64, 2>::kARegion, OH, OW, ext_y, ext_x);
    if (t2.bw > 0 &&
        B * t2.tiles * ((CO + 63) / 64) >= 2LL * kCtasPerSm * sm_count(dev)) {
      t = t2;
      mw = 2;
    }
  }
  p.bw = t.bw;
  p.bh = t.bh;
  p.pitch = t.bw + ext_x;
  p.a_slot = t.slot;
  const int region = mw == 1 ? Cfg<128, 1>::kARegion : Cfg<64, 2>::kARegion;
  p.a_slots = region / t.slot < kMaxASlots ? region / t.slot : kMaxASlots;
  p.a_tx = p.pitch * (t.bh + ext_y) * kBK * 2;
  p.tiles_w = (OW + t.bw - 1) / t.bw;
  p.tiles_h = (OH + t.bh - 1) / t.bh;
  p.n_tiles = (CO + bn - 1) / bn;
  const long long tiles = B * t.tiles * p.n_tiles;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = static_cast<int>(tiles);

  // one patch per input parity that has taps, its taps in order
  int steps = 0;
  for (int py = 0; py < stride; ++py) {
    for (int px = 0; px < stride; ++px) {
      const int first = steps;
      for (int dy = 0; dy < KH; ++dy) {
        for (int dx = 0; dx < KW; ++dx) {
          const int oy = dy - pad_t, ox = dx - pad_l;
          if (oy - floor_div(oy, stride) * stride != py ||
              ox - floor_div(ox, stride) * stride != px)
            continue;
          p.step_tap[steps] = dy * KW + dx;
          p.step_off[steps] = (floor_div(oy, stride) - p.sy0) * p.pitch +
                              floor_div(ox, stride) - p.sx0;
          ++steps;
        }
      }
      if (steps > first) {
        p.unit_map[p.units] = py * 2 + px;
        p.unit_steps[p.units] = steps - first;
        ++p.units;
      }
    }
  }
  p.bias = static_cast<const __nv_bfloat16*>(b);
  p.co = CO;
  p.cblocks = (C + kBK - 1) / kBK;

  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const cuuint64_t es = sizeof(__nv_bfloat16);
  const cuuint32_t abox[4] = {kBK, static_cast<cuuint32_t>(p.pitch),
                              static_cast<cuuint32_t>(t.bh + ext_y), 1};
  for (int py = 0; py < stride; ++py) {
    for (int px = 0; px < stride; ++px) {
      // stride-`stride` view of the pixels of parity (py, px) of the logical input
      const __nv_bfloat16* base =
          xb + (static_cast<size_t>(x_row0 + py) * W + px) * x_cstride + x_coff;
      const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                                  static_cast<cuuint64_t>((W - px + stride - 1) / stride),
                                  static_cast<cuuint64_t>((H - py + stride - 1) / stride),
                                  static_cast<cuuint64_t>(B)};
      const cuuint64_t strides[3] = {
          static_cast<cuuint64_t>(stride) * x_cstride * es,
          static_cast<cuuint64_t>(stride) * W * x_cstride * es,
          static_cast<cuuint64_t>(x_rows) * W * x_cstride * es};
      if (!encode(&p.xa[py * 2 + px], 4, base, dims, strides, abox))
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(CO), static_cast<cuuint64_t>(C),
                                static_cast<cuuint64_t>(KH * KW)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(CO) * es,
                                   static_cast<cuuint64_t>(C) * CO * es};
    const cuuint32_t box[3] = {64, kBK, 1};
    if (!encode(&p.w, 3, w, dims, strides, box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  p.y = static_cast<__nv_bfloat16*>(y) + y_coff;
  p.r = r == nullptr ? nullptr : static_cast<const __nv_bfloat16*>(r) + r_coff;
  p.oh = OH;
  p.ow = OW;
  p.y_cstride = y_cstride;
  p.r_cstride = r_cstride;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slots = kCtasPerSm * sm_count(dev);
  const int nb = p.tiles < slots ? p.tiles : slots;
  tile[0] = mw * kBM;
  tile[1] = bn;
  if (bn == 128) return launch<128, 1>(p, nb, dev, st);
  if (mw == 2) return launch<64, 2>(p, nb, dev, st);
  return launch<64, 1>(p, nb, dev, st);
}
