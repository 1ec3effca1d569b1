// Greedy-NMS keep-mask, one CTA per image.
//
// Replaces the Pallas TPU kernel yolo_series_tpu/ops/pallas_nms.py
// `_nms_kernel` (called through `nms_keep_mask_pallas`). That kernel builds
// the K x K suppression map and iterates the fixpoint
//   alive' = valid & !exists alive q < p with IoU(q, p) > thr
// a fixed 64 times. This kernel runs the exact sequential greedy scan
// instead, which is what the fixpoint converges to
// (yolo_series_tpu/ops/nms.py `nms_keep_mask_full`): for i in score order,
// if i is still alive, every p > i with IoU(i, p) > thr dies.
//
// Bound on this card: neither bytes (16 B per box in, 1 B out) nor
// arithmetic (at most K^2/2 IoUs) — the K sequential steps and the block
// barrier between them are the cost. The boxes, their areas and the alive
// flags live in shared memory (K <= 1024: 21 KB), so each step reads only
// shared memory; a dead i costs one barrier and no work.
//
// IoU is computed exactly as the plain version (`box_iou`):
// inter / (area1 + area2 - inter + 1e-7), each operation rounded on its
// own (no multiply-add contraction; the file is also built -fmad=false), so
// every threshold decision equals the plain version bit for bit even with
// the class offsets that put coordinates near 3.3e5.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 1024;
constexpr int kThreads = 256;

__device__ __forceinline__ float iou_rn(float4 a, float area_a, float4 b,
                                        float area_b) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, __fadd_rn(uni, 1e-7f));
}

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float4* __restrict__ boxes,
                const unsigned char* __restrict__ valid,
                unsigned char* __restrict__ keep, int K, float thr) {
  __shared__ float4 sbox[kMaxK];
  __shared__ float sarea[kMaxK];
  __shared__ unsigned char alive[kMaxK];

  const int b = blockIdx.x;
  const float4* bx = boxes + static_cast<size_t>(b) * K;
  for (int p = threadIdx.x; p < K; p += blockDim.x) {
    const float4 v = bx[p];
    sbox[p] = v;
    sarea[p] = __fmul_rn(__fsub_rn(v.z, v.x), __fsub_rn(v.w, v.y));
    alive[p] = valid[static_cast<size_t>(b) * K + p] != 0;
  }
  __syncthreads();

  for (int i = 0; i < K; ++i) {
    // alive[i] is final here: only steps q < i could clear it, and each
    // step ends in a barrier. The branch is uniform across the block.
    if (alive[i]) {
      const float4 bi = sbox[i];
      const float ai = sarea[i];
      for (int p = i + 1 + threadIdx.x; p < K; p += blockDim.x) {
        if (alive[p] && iou_rn(bi, ai, sbox[p], sarea[p]) > thr) {
          alive[p] = 0;
        }
      }
    }
    __syncthreads();
  }

  for (int p = threadIdx.x; p < K; p += blockDim.x) {
    keep[static_cast<size_t>(b) * K + p] = alive[p];
  }
}

}  // namespace

extern "C" int nms_keep_mask(const void* boxes, const void* valid, void* keep,
                             int B, int K, float thr, void* stream) {
  if (K < 1 || K > kMaxK || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  nms_keep_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes),
      static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(keep), K, thr);
  return static_cast<int>(cudaGetLastError());
}
