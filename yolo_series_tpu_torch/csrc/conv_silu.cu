// Direct NHWC convolution + bias + SiLU, bf16 in/out, fp32 accumulation.
//
// One kernel serves two Pallas TPU kernels of the serving path, as a chain
// of launches over whole images:
//   * yolo_series_tpu/ops/pallas_stem.py `_make_stem_call` (FusedStem): the
//     stem tail is 3 launches (k2/s1 pad (1,0), k3/s1, k3/s2). The first
//     reads its input at a row offset, past the 3 halo rows the producer
//     conv emits, and zero-pads around the real rows — the per-stage
//     re-zeroing the Pallas kernel does with `mask_rows`.
//   * yolo_series_tpu/ops/pallas_elan.py `_make_elan_call` (FusedELAN): an
//     ELAN span is 7 launches (two 1x1, four chained 3x3, the output 1x1).
//     Each writes into a channel slice of one preallocated concat buffer
//     (channel stride + offset), so the concat costs nothing.
// Rounding follows the Pallas kernels: fp32 accumulate, + bias in fp32,
// SiLU in fp32, one round to bf16 at the store.
//
// Design: implicit GEMM. M = output pixels (B*OH*OW), N = output channels,
// K = KH*KW*C. A CTA computes a 64x64 tile of (pixels x channels) with four
// warps, each 32x32 through 2x2 WMMA 16x16x16 bf16 fragments (tensor
// cores, mma.sync). The K loop walks the taps and, per tap, 32-channel
// slices: A rows are gathered with 16-byte loads (zero outside the image),
// B rows are weight rows (KH, KW, C, CO layout), both staged in shared
// memory.
//
// Bound on this card: the spans of the serving path do 2*M*N*K operations
// at a few hundred FLOP per byte moved, so tensor-core arithmetic bounds
// them (989 TFLOP/s bf16). This simple version keeps every intermediate in
// device memory and runs one stage per launch without a software
// pipeline; the single-launch fused design (intermediates in shared
// memory, TMA, wgmma) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int kThreads = 128;
constexpr int A_LD = BK + 8;   // bf16 elements; multiple of 8 for WMMA
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;   // fp32 elements; multiple of 4

struct ConvArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;   // (KH, KW, C, CO)
  const __nv_bfloat16* b;   // (CO,)
  __nv_bfloat16* y;
  int B, H, W, C;           // logical input: H rows of x starting at x_row0
  int x_rows, x_row0, x_cstride, x_coff;
  int KH, KW, stride, pad_t, pad_l;
  int OH, OW, CO, y_cstride, y_coff;
};

__global__ void __launch_bounds__(kThreads)
conv_silu_kernel(const ConvArgs a) {
  __shared__ __align__(128) __nv_bfloat16 sA[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 sB[BK * B_LD];
  __shared__ __align__(128) float sC[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / 2;   // 0..1: 32-row half of the tile
  const int warp_n = warp % 2;   // 0..1: 32-col half of the tile
  const long long M = static_cast<long long>(a.B) * a.OH * a.OW;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // A loader: thread -> (row, two 8-channel vectors at col 16*(tid%2))
  const int a_row = tid / 2;
  const int a_col = (tid % 2) * 16;
  const long long am = m0 + a_row;
  const bool a_in = am < M;
  int a_b = 0, a_oh = 0, a_ow = 0;
  if (a_in) {
    a_b = static_cast<int>(am / (static_cast<long long>(a.OH) * a.OW));
    const int rem = static_cast<int>(am % (static_cast<long long>(a.OH) * a.OW));
    a_oh = rem / a.OW;
    a_ow = rem % a.OW;
  }
  // B loader: thread -> (k row, two 8-channel vectors at col 16*(tid%4))
  const int b_row = tid / 4;
  const int b_col = (tid % 4) * 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int dy = 0; dy < a.KH; ++dy) {
    for (int dx = 0; dx < a.KW; ++dx) {
      const int ih = a_oh * a.stride - a.pad_t + dy;
      const int iw = a_ow * a.stride - a.pad_l + dx;
      const bool a_ok = a_in && ih >= 0 && ih < a.H && iw >= 0 && iw < a.W;
      const __nv_bfloat16* xrow = a.x;
      if (a_ok) {
        xrow = a.x + ((static_cast<size_t>(a_b) * a.x_rows + a.x_row0 + ih)
                          * a.W + iw) * a.x_cstride + a.x_coff;
      }
      const __nv_bfloat16* wtap =
          a.w + (static_cast<size_t>(dy) * a.KW + dx) * a.C * a.CO;
      for (int c0 = 0; c0 < a.C; c0 += BK) {
        uint4 va0 = zero, va1 = zero;
        if (a_ok) {
          const uint4* src = reinterpret_cast<const uint4*>(xrow + c0 + a_col);
          va0 = src[0];
          va1 = src[1];
        }
        uint4 vb0 = zero, vb1 = zero;
        const int n = n0 + b_col;
        const __nv_bfloat16* wrow =
            wtap + static_cast<size_t>(c0 + b_row) * a.CO + n;
        if (n + 8 <= a.CO) vb0 = reinterpret_cast<const uint4*>(wrow)[0];
        if (n + 16 <= a.CO) vb1 = reinterpret_cast<const uint4*>(wrow + 8)[0];

        *reinterpret_cast<uint4*>(&sA[a_row * A_LD + a_col]) = va0;
        *reinterpret_cast<uint4*>(&sA[a_row * A_LD + a_col + 8]) = va1;
        *reinterpret_cast<uint4*>(&sB[b_row * B_LD + b_col]) = vb0;
        *reinterpret_cast<uint4*>(&sB[b_row * B_LD + b_col + 8]) = vb1;
        __syncthreads();

#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(
                fa[i], &sA[(warp_m * 32 + i * 16) * A_LD + kk], A_LD);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(
                fb[j], &sB[kk * B_LD + warp_n * 32 + j * 16], B_LD);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          &sC[(warp_m * 32 + i * 16) * C_LD + warp_n * 32 + j * 16],
          acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  // epilogue: consecutive threads take consecutive channels of one pixel
  for (int idx = tid; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN;
    const int c = idx % BN;
    const long long m = m0 + r;
    const int co = n0 + c;
    if (m >= M || co >= a.CO) continue;
    float v = sC[r * C_LD + c] + __bfloat162float(a.b[co]);
    v = v / (1.0f + expf(-v));
    a.y[static_cast<size_t>(m) * a.y_cstride + a.y_coff + co] =
        __float2bfloat16(v);
  }
}

}  // namespace

extern "C" int conv_silu_nhwc(
    const void* x, const void* w, const void* b, void* y,
    int B, int H, int W, int C, int x_rows, int x_row0, int x_cstride,
    int x_coff, int KH, int KW, int stride, int pad_t, int pad_l, int OH,
    int OW, int CO, int y_cstride, int y_coff, void* stream) {
  if (C % BK != 0 || CO % 16 != 0 || x_cstride % 8 != 0 || x_coff % 8 != 0 ||
      B < 1 || OH < 1 || OW < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ConvArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.b = static_cast<const __nv_bfloat16*>(b);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.B = B; a.H = H; a.W = W; a.C = C;
  a.x_rows = x_rows; a.x_row0 = x_row0; a.x_cstride = x_cstride;
  a.x_coff = x_coff;
  a.KH = KH; a.KW = KW; a.stride = stride; a.pad_t = pad_t; a.pad_l = pad_l;
  a.OH = OH; a.OW = OW; a.CO = CO; a.y_cstride = y_cstride; a.y_coff = y_coff;
  const long long M = static_cast<long long>(B) * OH * OW;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((CO + BN - 1) / BN));
  conv_silu_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
