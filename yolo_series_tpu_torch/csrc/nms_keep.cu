// Greedy-NMS keep-mask: a suppression bitmask built in parallel by a
// cluster of CTAs, then scanned word by word by one warp (K1, K <= 1024);
// and for any larger K a mask kernel over all SMs into device memory, then
// a scan by one CTA an image (K1L, the entry point nms_keep_mask_large).
//
// Replaces the Pallas TPU kernel yolo_series_tpu/ops/pallas_nms.py
// `_nms_kernel` (called through `nms_keep_mask_pallas`). That kernel builds
// the K x K suppression map and iterates the fixpoint
//   alive' = valid & !exists alive q < p with IoU(q, p) > thr
// a fixed 64 times. This kernel computes the exact sequential greedy scan
// instead, which is what the fixpoint converges to
// (yolo_series_tpu/ops/nms.py `nms_keep_mask_full`): for i in score order,
// if i is still alive, every p > i with IoU(i, p) > thr dies.
//
// Design: one cluster of 8 CTAs per image (K <= 1024).
//  1. Every CTA loads the image's boxes, areas and valid bits into shared
//     memory and builds its rows i = rank, rank + 8, ... of the upper-
//     triangular bitmask: bit p of word j of row i is IoU(i, p) > thr for
//     p = 32 j + bit > i. A warp builds a row, two words a step, each with
//     a ballot, and writes it into CTA 0's shared memory (distributed shared
//     memory), where the whole mask lives: K x K / 32 words, 128 KB at K =
//     1024, opt-in dynamic shared memory. Then it counts the row in CTA 0's
//     counter of the row's 32-row block (a release at cluster scope).
//     Invalid rows, and everything past the last valid box, are skipped
//     (the serving path's valid boxes are a prefix).
//  2. Meanwhile one warp of CTA 0 (which builds no rows) scans, each block
//     as soon as its rows are counted (an acquire). Lane j holds word j of
//     `removed`, which starts as the invalid boxes. Per 32-box block w: each
//     lane loads its word of the block's 32 rows; lane w resolves the block
//     alone in registers (box 32 w + t, if not removed, ORs row word w);
//     then the block's kept bits go to every lane with one shuffle, and each
//     lane j > w ORs word j of the kept rows. No block barrier per box: 32
//     short dependent steps per block on one lane.
//
// Bound on this card: neither bytes (16 B a box in, 1 B out) nor arithmetic
// (the IoUs greedy needs are well under a million: nanoseconds at 67
// TFLOP/s). The cost is latency: the scan is a chain of K dependent steps,
// here K / 32 blocks of ~32 single-lane ALU steps plus one shuffle, 32
// shared-memory loads and one acquire, and it waits on the bitmask's
// K^2 / 2 IoUs, which are spread over 8 SMs an image (a warp skips the IoU
// where no lane's boxes overlap, and the threshold test needs no
// division). Rows are built in increasing order, so the scan runs behind
// the bitmask rather than after it.
//
// IoU is computed exactly as the plain version (`box_iou`):
// inter / (area1 + area2 - inter + 1e-7), each operation rounded on its
// own (no multiply-add contraction; the file is also built -fmad=false), so
// every threshold decision equals the plain version bit for bit even with
// the class offsets that put coordinates near 3.3e5.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 1024;
constexpr int kWords = kMaxK / 32;  // the row stride of the mask, in words
constexpr int kCluster = 8;  // CTAs an image
constexpr int kThreads = 1024;
constexpr unsigned kAll = 0xffffffffu;

// dynamic shared memory of the mask: 32 rows (4 KB) for each word of K
int mask_bytes(int K) { return (K + 31) / 32 * 32 * kWords * 4; }

// The threshold test RN(inter / d) > thr without the division: with mid
// the midpoint between thr and the next float up, RN(x) > thr exactly when
// x > mid, or x >= mid where mid itself rounds up. For d > 0 that is
// inter > mid * d (or >=), and mid * d is exact in double (25 x 24
// significant bits), so the test is the plain version's bit for bit.
struct Threshold {
  float thr;
  double mid;
  bool mid_up;  // mid rounds to the next float up
  bool exact;   // thr >= 0 and finite below the largest float
};

__device__ __forceinline__ Threshold make_threshold(float thr) {
  Threshold t;
  const float up = nextafterf(thr, INFINITY);
  t.thr = thr;
  t.mid = 0.5 * (static_cast<double>(thr) + static_cast<double>(up));
  t.mid_up = __double2float_rn(t.mid) != thr;
  t.exact = thr >= 0.0f && up < INFINITY;
  return t;
}

// does box a suppress box b (IoU(a, b) > thr), for a lane whose pair is
// `live`? Boxes that do not overlap have IoU 0 (or NaN, for degenerate
// boxes), which exceeds no threshold >= 0, so the warp computes the IoU
// only where some lane's boxes overlap.
__device__ __forceinline__ bool suppresses(bool live, float4 a, float area_a, float4 b,
                                           float area_b, const Threshold& t) {
  const float x0 = fmaxf(a.x, b.x), x1 = fminf(a.z, b.z);
  const float y0 = fmaxf(a.y, b.y), y1 = fminf(a.w, b.w);
  const bool need = live && ((x1 > x0 && y1 > y0) || t.thr < 0.0f);
  if (!__any_sync(kAll, need)) return false;
  const float w = fmaxf(__fsub_rn(x1, x0), 0.0f);
  const float h = fmaxf(__fsub_rn(y1, y0), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float d = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-7f);
  bool s;
  if (t.exact && d > 0.0f && d < INFINITY) {
    const double md = t.mid * static_cast<double>(d);
    const double x = static_cast<double>(inter);
    s = t.mid_up ? x >= md : x > md;
  } else {
    s = __fdiv_rn(inter, d) > t.thr;
  }
  return need && s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// CTA 0's counter `c` (a word of its shared memory) read with acquire
// semantics at cluster scope: the writes released before the counts it
// shows are visible after it
__device__ __forceinline__ uint32_t count_acquire(const uint32_t* c) {
  uint32_t v;
  asm volatile("ld.acquire.cluster.shared::cta.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(smem_u32(c))
               : "memory");
  return v;
}

// wait until it reaches `want`; a lost count traps (a launch error) after
// ~2^26 polls instead of hanging
__device__ __forceinline__ void wait_count(const uint32_t* c, uint32_t want) {
  for (uint32_t polls = 0; count_acquire(c) < want; ++polls)
    if (polls == (1u << 26)) __trap();
}

// one count, after this thread's writes: a release at cluster scope
__device__ __forceinline__ void count_release(uint32_t* remote) {
  asm volatile("red.release.cluster.add.u32 [%0], 1;\n" ::"l"(remote) : "memory");
}

// v[t] |= v[t + H] for t < H
template <int H>
__device__ __forceinline__ void or_halves(uint32_t (&v)[32]) {
#pragma unroll
  for (int t = 0; t < H; ++t) v[t] |= v[t + H];
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
nms_keep_kernel(const float4* __restrict__ boxes,
                const unsigned char* __restrict__ valid,
                unsigned char* __restrict__ keep, int K, float thr) {
  __shared__ float4 sbox[kMaxK];
  __shared__ float sarea[kMaxK];
  __shared__ uint32_t svalid[kWords];
  __shared__ uint32_t done[kWords];  // CTA 0's: rows written, per block
  extern __shared__ uint32_t mask[];  // row i at mask + kWords i; CTA 0's is read

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = kThreads / 32;
  const int nw = (K + 31) / 32;

  // CTA 0's counters are zero before any CTA counts a row: the cluster
  // barrier's arrive here, its wait before the first row
  if (rank == 0 && threadIdx.x < kWords) done[threadIdx.x] = 0;
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  const float4* bx = boxes + static_cast<size_t>(b) * K;
  for (int p = threadIdx.x; p < K; p += kThreads) {
    const float4 v = bx[p];
    sbox[p] = v;
    sarea[p] = __fmul_rn(__fsub_rn(v.z, v.x), __fsub_rn(v.w, v.y));
  }
  for (int w = warp; w < nw; w += nwarps) {
    const int p = 32 * w + lane;
    const bool v = p < K && valid[static_cast<size_t>(b) * K + p] != 0;
    const uint32_t word = __ballot_sync(kAll, v);
    if (lane == 0) svalid[w] = word;
  }
  __syncthreads();

  // boxes past the last valid one take no part: neither rows nor words
  int n_eff = 0;
  for (int w = nw - 1; w >= 0; --w) {
    if (svalid[w]) {
      n_eff = 32 * w + 32 - __clz(svalid[w]);
      break;
    }
  }
  const int nw_eff = (n_eff + 31) / 32;

  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

  // ---- 1. this CTA's rows of the bitmask, into CTA 0 ----
  // A warp a row, in increasing order: it keeps the row's box in registers,
  // builds two words a step (each a ballot; lane j keeps word j), writes
  // the row into CTA 0 with one 128-byte store, and counts it in CTA 0's
  // counter of its 32-row block (a release at cluster scope). Blocks finish
  // in order, so the scan (warp 0 of CTA 0, which builds no rows) runs
  // behind the bitmask rather than after it.
  if (rank != 0 || warp != 0) {
    const Threshold th = make_threshold(thr);
    uint32_t* dst = cluster.map_shared_rank(mask, 0);
    uint32_t* cnt = cluster.map_shared_rank(done, 0);
    const int step = rank == 0 ? nwarps - 1 : nwarps;
    for (int r = rank == 0 ? warp - 1 : warp; rank + kCluster * r < n_eff; r += step) {
      const int i = rank + kCluster * r;
      if (!((svalid[i / 32] >> (i % 32)) & 1u)) continue;  // never read
      const float4 bi = sbox[i];
      const float ai = sarea[i];
      // words left of the diagonal are never read
      uint32_t mine = 0;
      for (int j = i / 32; j < nw_eff; j += 2) {
        const int p0 = 32 * j + lane, p1 = p0 + 32;
        const int q0 = p0 < n_eff ? p0 : i, q1 = p1 < n_eff ? p1 : i;  // in range
        const bool s0 = suppresses(p0 > i && p0 < n_eff, bi, ai, sbox[q0], sarea[q0], th);
        const bool s1 = suppresses(p1 < n_eff, bi, ai, sbox[q1], sarea[q1], th);
        const uint32_t w0 = __ballot_sync(kAll, s0);
        const uint32_t w1 = __ballot_sync(kAll, s1);
        mine = lane == j ? w0 : lane == j + 1 ? w1 : mine;
      }
      if (lane >= i / 32 && lane < nw_eff) dst[kWords * i + lane] = mine;
      __syncwarp();
      if (lane == 0) count_release(cnt + i / 32);
    }
    return;
  }

  // ---- 2. the scan: one warp of CTA 0 ----
  // invalid boxes, and the bits past K, start removed
  uint32_t removed = lane < nw ? ~svalid[lane] : kAll;
  for (int w = 0; w < nw_eff; ++w) {
    // block w is ready when each of its valid rows is counted
    wait_count(&done[w], __popc(svalid[w]));
    // this lane's word of the block's rows: written where it is read below
    // (lane w: the diagonal word; lanes > w: right of it; kept rows only)
    uint32_t row[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) row[t] = mask[kWords * (32 * w + t) + lane];
    if (lane == w) {
#pragma unroll
      for (int t = 0; t < 32; ++t)
        if (!(removed & (1u << t))) removed |= row[t];
    }
    const uint32_t kept = ~__shfl_sync(kAll, removed, w);
    // OR of the kept rows' words, as a tree (depth 5, not a chain of 32);
    // every index is a constant, so the rows stay in registers
#pragma unroll
    for (int t = 0; t < 32; ++t) row[t] = (kept & (1u << t)) ? row[t] : 0u;
    or_halves<16>(row);
    or_halves<8>(row);
    or_halves<4>(row);
    or_halves<2>(row);
    or_halves<1>(row);
    if (lane > w) removed |= row[0];
  }
  // keep[p] = not removed: lane l writes boxes 4 l .. 4 l + 3 of each 128
  unsigned char* out = keep + static_cast<size_t>(b) * K;
  for (int w = 0; w < nw; w += 4) {
    const uint32_t word = __shfl_sync(kAll, removed, w + lane / 8);
    const int p = 32 * w + 4 * lane;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (p + e < K) out[p + e] = !((word >> (4 * (lane % 8) + e)) & 1u);
  }
}

// ---- K1L: the keep-mask for K > 1024 ----
//
// Counterpart of an XLA function, not of a Pallas kernel: the tiled
// `nms_keep_mask` of yolo_series_tpu/ops/nms.py, which `_nms_tail` takes
// above 1024 candidates (eval at K = 8192, detect at 4096). Same function
// as K1: exact sequential greedy, IoU and threshold test bit for bit as K1
// (`suppresses`).
//
// Design (simple first): two launches on the caller's stream.
//  1. nms_mask_kernel, grid (nw, nw, B) with nw = ceil(K / 64): block
//     (cb, rb) of image b computes rows 64 rb .. +64 against columns
//     64 cb .. +64, one row a thread, and writes word cb of each row: bit c
//     is IoU(i, 64 cb + c) > thr for 64 cb + c > i. Blocks below the
//     diagonal return at once (never read). The mask lives in a (B, K, nw)
//     uint64 workspace the caller allocates (torch's allocator, so a CUDA
//     graph can capture the launch).
//  2. nms_scan_kernel, one CTA an image: `removed` (nw words) in shared
//     memory starts as the invalid boxes. For each 64-box block w up to
//     the last valid box: one thread resolves the block alone from the
//     diagonal words of its rows (box 64 w + t, if not removed, ORs its
//     word w), then every thread j > w ORs word j of the block's kept rows
//     in parallel. The next block's diagonal words load during that OR.
//
// Bound on this card: the IoUs are K^2 / 2 an image at 13 fp32 operations
// (3.5 GFLOP at B = 8, K = 8192: ~0.05 ms at 67 TFLOP/s); the workspace is
// 67 MB there, of which the upper-triangular blocks (34 MB) are written
// once and read once by the scan (~0.02 ms at 3.35 TB/s). The
// scan is a chain of K / 64 dependent blocks, each two CTA barriers, a
// 64-step serial resolve and a round of loads: latency, not bytes.

constexpr int kTile = 64;  // rows and columns of a mask block; bits a word
constexpr int kScanThreads = 256;
// removed[] and the scan's static words within the 48 KB a launch may take
// without an opt-in
constexpr int kMaxWordsLarge = 6000;

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes, uint64_t* __restrict__ mask, int K,
                int nw, float thr) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  if (cb < rb) return;  // below the diagonal: never read
  __shared__ float4 sbox[kTile];
  __shared__ float sarea[kTile];
  const float4* bx = boxes + static_cast<size_t>(b) * K;
  const int t = threadIdx.x;
  const int p = cb * kTile + t;
  if (p < K) {
    const float4 v = bx[p];
    sbox[t] = v;
    sarea[t] = __fmul_rn(__fsub_rn(v.z, v.x), __fsub_rn(v.w, v.y));
  }
  const int i = rb * kTile + t;
  const float4 bi = i < K ? bx[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float ai = __fmul_rn(__fsub_rn(bi.z, bi.x), __fsub_rn(bi.w, bi.y));
  __syncthreads();
  const Threshold th = make_threshold(thr);
  const int ncol = min(kTile, K - cb * kTile);  // the same for every thread
  uint64_t word = 0;
  for (int c = 0; c < ncol; ++c)
    if (suppresses(i < K && cb * kTile + c > i, bi, ai, sbox[c], sarea[c], th))
      word |= 1ull << c;
  if (i < K) mask[(static_cast<size_t>(b) * K + i) * nw + cb] = word;
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const uint64_t* __restrict__ mask, const unsigned char* __restrict__ valid,
                unsigned char* __restrict__ keep, int K, int nw) {
  extern __shared__ uint64_t removed[];  // nw words
  __shared__ uint64_t diag[2][kTile];    // diagonal words of a block's rows
  __shared__ uint64_t kept_s;
  __shared__ int nw_eff;                 // words up to the last valid box
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const unsigned char* vb = valid + static_cast<size_t>(b) * K;
  const uint64_t* mb = mask + static_cast<size_t>(b) * K * nw;

  // removed = the invalid boxes (and the bits past K): a word a warp
  if (tid == 0) nw_eff = 0;
  __syncthreads();
  for (int j = warp; j < nw; j += kScanThreads / 32) {
    const int p0 = kTile * j + lane, p1 = p0 + 32;
    const uint32_t lo = __ballot_sync(kAll, p0 < K && vb[p0] != 0);
    const uint32_t hi = __ballot_sync(kAll, p1 < K && vb[p1] != 0);
    const uint64_t v = (static_cast<uint64_t>(hi) << 32) | lo;
    if (lane == 0) {
      removed[j] = ~v;
      if (v) atomicMax(&nw_eff, j + 1);
    }
  }
  __syncthreads();
  const int nwe = nw_eff;
  if (tid < kTile && nwe > 0) diag[0][tid] = tid < K ? mb[static_cast<size_t>(tid) * nw] : 0;
  __syncthreads();

  for (int w = 0; w < nwe; ++w) {
    if (tid == 0) {  // the block alone: each box not yet removed is kept
      uint64_t r = removed[w];
#pragma unroll
      for (int t = 0; t < kTile; ++t)
        if (!((r >> t) & 1ull)) r |= diag[w & 1][t];
      removed[w] = r;
      kept_s = ~r;
    }
    __syncthreads();
    const uint64_t kept = kept_s;
    if (tid < kTile && w + 1 < nwe) {  // the next block's diagonal words
      const int i = kTile * (w + 1) + tid;
      diag[(w + 1) & 1][tid] = i < K ? mb[static_cast<size_t>(i) * nw + w + 1] : 0;
    }
    // words past the last valid box stay removed: no need to OR them
    for (int j = w + 1 + tid; kept && j < nwe; j += kScanThreads) {
      const uint64_t* col = mb + static_cast<size_t>(kTile) * w * nw + j;
      uint64_t acc = 0;
#pragma unroll
      for (int t = 0; t < kTile; ++t)
        if ((kept >> t) & 1ull) acc |= col[static_cast<size_t>(t) * nw];
      removed[j] |= acc;
    }
    __syncthreads();
  }
  unsigned char* out = keep + static_cast<size_t>(b) * K;
  for (int p = tid; p < K; p += kScanThreads)
    out[p] = !((removed[p / kTile] >> (p % kTile)) & 1ull);
}

}  // namespace

extern "C" int nms_keep_mask(const void* boxes, const void* valid, void* keep,
                             int B, int K, float thr, void* stream) {
  if (K < 1 || K > kMaxK || B < 1 || B > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  // the shared-memory opt-in for the largest mask, once per device (a host
  // call, kept out of the launches a CUDA graph captures)
  static std::atomic<unsigned> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(opted_in.load() & (1u << dev))) {
    err = cudaFuncSetAttribute(nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               mask_bytes(kMaxK));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in.fetch_or(1u << dev);
  }
  nms_keep_kernel<<<B * kCluster, kThreads, mask_bytes(K),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(keep), K, thr);
  return static_cast<int>(cudaGetLastError());
}

// K1L: boxes (B, K, 4) fp32, valid (B, K) bool, keep (B, K) bool, mask a
// (B, K, ceil(K / 64)) uint64 workspace, all on the device; two launches on
// `stream`, no allocation, no synchronisation
extern "C" int nms_keep_mask_large(const void* boxes, const void* valid, void* keep,
                                   void* mask, int B, int K, float thr, void* stream) {
  const int nw = (K + kTile - 1) / kTile;
  if (K < 1 || nw > kMaxWordsLarge || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(nw, nw, B), kTile, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<uint64_t*>(mask), K, nw, thr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<B, kScanThreads, nw * sizeof(uint64_t), s>>>(
      static_cast<const uint64_t*>(mask), static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(keep), K, nw);
  return static_cast<int>(cudaGetLastError());
}
