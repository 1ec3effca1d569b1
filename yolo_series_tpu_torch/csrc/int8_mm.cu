// Tensor-core matmul C = A @ B^T for the quantized 1x1 convs (K4) and its
// bench template (K4b).
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
// channels), B is (N, K) row-major (the OIHW weight of a 1x1 conv), which is
// (K, N) column-major: the `row.col` operand order of mma.sync, so neither
// operand is transposed. C is (M, N) row-major. M is guarded in the kernel
// (rows past M load as zeros and are not stored); N must be a multiple of
// 128 and K of 64 bytes, which the Python wrapper checks.
//
// Design (simple first version): a 128 x 128 output tile per block of 8
// warps (4 along M x 2 along N, 32 x 64 each), K staged through shared
// memory in 64-byte slices by cp.async in a 4-stage ring, operands loaded
// with ldmatrix and multiplied by mma.sync (m16n8k32 s8 or m16n8k16 bf16;
// both read a 16-row x 32-byte A tile and an 8-row x 32-byte B tile with
// the same register layout, so one kernel body serves both types). The
// output is written straight from the accumulators: each thread stores two
// adjacent columns, so every 32-byte sector is written whole.
//
// Bound on this card: at the yolov7 shapes (K, N <= 2048) the fp32 output
// dominates the traffic, ~85 int8 operations per byte against the card's
// ~590, so the product is bound by bytes; the design reads A once per
// output-tile column (the N tiles of one M tile are adjacent in launch
// order and share A through L2) and writes C once. wgmma and TMA are the
// next step (ROADMAP queue 2b).
//
// Rounding: the int32 sum is exact. The epilogue rounds as the plain
// version does, int -> fp32 (rn), times scale (rn), plus bias (rn), each on
// its own; the file is also built with -fmad=false.

#include <atomic>
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBKBytes = 64;                 // K slice per stage, in bytes
constexpr int kRowBytes = kBKBytes + 16;     // padded smem row: ldmatrix conflict-free
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kTileBytes = kBM * kRowBytes;  // one A or B stage
constexpr int kSmemBytes = kStages * 2 * kTileBytes;

static_assert(kBM == kBN, "one copy loop fills the A and B stages");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // src-size 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a (16 x 32 bytes, row) * b (32 bytes x 8, col)
__device__ __forceinline__ void mma(int (&c)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

enum class Epi { kDequant, kRaw };

template <typename T, Epi kEpi>
__global__ void __launch_bounds__(kThreads, 2)
int8_mm_kernel(const char* __restrict__ A, const char* __restrict__ B,
               const float* __restrict__ scale, const float* __restrict__ bias,
               void* __restrict__ out, int M, int N, int K) {
  using Acc = typename std::conditional<std::is_same<T, int8_t>::value, int, float>::type;
  extern __shared__ __align__(128) char smem[];

  const size_t row_bytes = static_cast<size_t>(K) * sizeof(T);
  const int ktiles = static_cast<int>(row_bytes / kBKBytes);
  const int n_tiles = N / kBN;
  // the N tiles of one M tile are neighbours in launch order: they share A in L2
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // 0..3: 32 rows each
  const int wn = warp & 1;   // 0..1: 64 columns each

  auto stage_a = [&](int s) { return smem + s * 2 * kTileBytes; };
  auto stage_b = [&](int s) { return smem + s * 2 * kTileBytes + kTileBytes; };

  // one 64-byte K slice of A (128 rows) and B (128 rows): 2 x 512 chunks of
  // 16 bytes, 2 + 2 per thread
  auto load = [&](int kt, int s) {
    char* sa = stage_a(s);
    char* sb = stage_b(s);
    const size_t k_off = static_cast<size_t>(kt) * kBKBytes;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 2;
      const int col = (c & 3) * 16;
      const int gm = m0 + row;
      const bool ok = gm < M;
      cp_async16(sa + row * kRowBytes + col,
                 A + static_cast<size_t>(ok ? gm : 0) * row_bytes + k_off + col, ok);
      cp_async16(sb + row * kRowBytes + col,
                 B + static_cast<size_t>(n0 + row) * row_bytes + k_off + col, true);
    }
  };

  Acc acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }

  // ldmatrix row addresses of this lane: A x4 = rows 0-7 / 8-15 x bytes
  // 0-15 / 16-31; B x4 = two 8-row column blocks x bytes 0-15 / 16-31
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt has landed; every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < ktiles) load(next, next % kStages);
    cp_async_commit();

    const char* sa = stage_a(kt % kStages);
    const char* sb = stage_b(kt % kStages);
#pragma unroll
    for (int ks = 0; ks < kBKBytes / 32; ++ks) {
      unsigned a[2][4];
      unsigned b[8][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], sa + (wm * 32 + i * 16 + a_row) * kRowBytes + ks * 32 + a_col);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned r[4];
        ldmatrix_x4(r, sb + (wn * 64 + j * 16 + b_row) * kRowBytes + ks * 32 + b_col);
        b[2 * j][0] = r[0];
        b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2];
        b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // accumulator layout: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g + 8
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 32 + i * 16 + g + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn * 64 + j * 8 + t * 2;
        const size_t o = static_cast<size_t>(row) * N + col;
        const Acc v0 = acc[i][j][2 * h];
        const Acc v1 = acc[i][j][2 * h + 1];
        if constexpr (kEpi == Epi::kDequant) {
          const float2 s = *reinterpret_cast<const float2*>(scale + col);
          const float2 bb = *reinterpret_cast<const float2*>(bias + col);
          float2 y;
          y.x = __fadd_rn(__fmul_rn(__int2float_rn(v0), s.x), bb.x);
          y.y = __fadd_rn(__fmul_rn(__int2float_rn(v1), s.y), bb.y);
          reinterpret_cast<float2*>(out)[o / 2] = y;
        } else if constexpr (std::is_same<Acc, int>::value) {
          reinterpret_cast<int2*>(out)[o / 2] = make_int2(v0, v1);
        } else {
          reinterpret_cast<float2*>(out)[o / 2] = make_float2(v0, v1);
        }
      }
    }
  }
}

template <typename T, Epi kEpi>
int launch(const void* a, const void* b, const void* scale, const void* bias,
           void* out, int M, int N, int K, void* stream) {
  if (M < 1 || N < kBN || K < 1 || N % kBN != 0 ||
      (static_cast<long long>(K) * sizeof(T)) % kBKBytes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = static_cast<long long>((M + kBM - 1) / kBM) * (N / kBN);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = int8_mm_kernel<T, kEpi>;
  // the shared-memory opt-in, once per device (a host call, kept out of
  // the launches a CUDA graph captures)
  static std::atomic<unsigned> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(opted_in.load() & (1u << dev))) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in.fetch_or(1u << dev);
  }
  kern<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(a), static_cast<const char*>(b),
      static_cast<const float*>(scale), static_cast<const float*>(bias), out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4: out (M, N) fp32 = (xq (M, K) int8 @ wq (N, K) int8 ^T) * scale[n] + bias[n]
extern "C" int int8_mm_dequant(const void* xq, const void* wq, const void* scale,
                               const void* bias, void* out, int M, int N, int K,
                               void* stream) {
  return launch<int8_t, Epi::kDequant>(xq, wq, scale, bias, out, M, N, K, stream);
}

// K4b, int8: out (M, N) int32 = a (M, K) int8 @ b (N, K) int8 ^T
extern "C" int int8_mm_raw(const void* a, const void* b, void* out, int M, int N,
                           int K, void* stream) {
  return launch<int8_t, Epi::kRaw>(a, b, nullptr, nullptr, out, M, N, K, stream);
}

// K4b, bf16: out (M, N) fp32 = a (M, K) bf16 @ b (N, K) bf16 ^T
extern "C" int bf16_mm_raw(const void* a, const void* b, void* out, int M, int N,
                           int K, void* stream) {
  return launch<__nv_bfloat16, Epi::kRaw>(a, b, nullptr, nullptr, out, M, N, K,
                                          stream);
}
