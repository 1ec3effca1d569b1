// Greedy-NMS keep-mask: a suppression bitmask built in parallel by a
// cluster of CTAs, then scanned word by word by one warp (K1, K <= 1024);
// and for any larger K a mask kernel over the packed upper-triangular tiles
// in device memory, then a lookahead scan by a cluster of CTAs an image
// (K1L, the entry point nms_keep_mask_large).
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

#include <algorithm>
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
// Bound on this card: the IoUs of the upper triangle are K^2 / 2 an image
// at 13 fp32 operations (3.5 GFLOP at B = 8, K = 8192: ~0.05 ms at 67
// TFLOP/s), and the mask is 34 MB there, written once and read once
// (~0.02 ms at 3.35 TB/s): that is the design's floor. The scan is a chain
// of K / 64 dependent 64-box blocks an image: latency, not bytes. So the
// mask must run on every SM at the IoU rate, and each block's step of the
// chain must be short: no CTA barrier, no round trip to device memory.
//
// Layout: the mask of an image is its upper-triangular 64 x 64 tiles
// (rb, cb), cb >= rb, each 64 uint64 words (word t: row 64 rb + t, bit c:
// column 64 cb + c), 512 contiguous bytes, packed row block by row block
// (`tile_start`; `ops/nms_keep.large_tile_index` is the same order). The
// caller allocates it with torch (B * nw (nw + 1) / 2 * 512 bytes), so a
// CUDA-graph capture records it.
//
// Two launches on the caller's stream:
//  1. nms_mask_kernel, a linear grid over the tiles of each image, four
//     tiles a 256-thread CTA: the tile's 64 column boxes in shared memory,
//     one row a thread, each row's word stored coalesced into the packed
//     tile. Bit c is IoU(i, p) > thr for p = 64 cb + c > i, with row i and
//     column p valid. A thread first marks the columns whose box can
//     overlap its row's (four comparisons a pair, no arithmetic); then each
//     lane runs the exact test on its own marked pairs, one a step, so the
//     pairs that cannot pass cost no exact test and a step serves up to 32.
//     A tile none of whose rows, or none of whose columns, is valid is
//     skipped and never written: its rows are never kept and its columns
//     start removed, so the scan has no use for it and never reads it.
//  2. nms_scan_kernel, a cluster of kScanCluster CTAs an image, 8 warps a
//     CTA. Word j of `removed` belongs to CTA j % C, and within it to warp
//     (j / C) % 8, which keeps it in shared memory. The owner of word w
//     resolves block w from its diagonal tile and publishes kept_w into
//     every CTA of the cluster: an st.async into each CTA's shared memory
//     that completes that CTA's mbarrier of block w, on which its warps
//     wait asleep rather than polling. The resolve is 64 unrolled steps on
//     the diagonal tile's rows in registers. On kept_w, the owner of w + 1
//     first ORs tile (w, w + 1)'s kept rows into its word, resolves block
//     w + 1 and publishes it: one broadcast and one on-chip resolve a
//     block on the critical path. Every other word
//     j > w + 1 ORs tile (w, j) after that, off the critical path. Each
//     warp prefetches its tiles with cp.async into a ring of kRing blocks
//     in shared memory, ahead of the resolve: their addresses do not depend
//     on `kept`. A block's slot holds the tiles of the warp's first `mpre`
//     words at or after the block (as many as fit the shared memory: all
//     of them up to K = 32768); the words after those read their tiles
//     from device memory. The word on the critical path is always the
//     first, so it is always in the ring. K is limited by the 24 bytes of
//     shared memory each 64-box word takes in every CTA (kMaxKLarge).

constexpr int kTile = 64;  // rows and columns of a tile; bits a word
constexpr int kMaskThreads = 256;
constexpr int kMaskTiles = kMaskThreads / kTile;  // tiles a mask CTA
constexpr int kScanCluster = 8;                   // CTAs an image
constexpr int kScanWarps = 8;
constexpr int kScanThreads = 32 * kScanWarps;
constexpr int kRing = 4;  // blocks of tiles a scan warp has in flight
// the scan's dynamic shared memory opt-in, under the card's 227 KB a CTA
constexpr int kScanSmem = 220 * 1024;
// the largest K: vword, kept_s and bar of every word, rem of this CTA's,
// and a ring of one tile a block, within kScanSmem
constexpr int kMaxKLarge = 6000 * kTile;

// the first tile of row block rb in the packed order
__host__ __device__ __forceinline__ long long tile_start(int rb, int nw) {
  return static_cast<long long>(rb) * nw - static_cast<long long>(rb) * (rb - 1) / 2;
}

// the tile (rb, cb) at packed index idx: the last row block that starts at
// or before it (from the quadratic's root, then corrected by whole steps)
__device__ __forceinline__ void tile_at(long long idx, int nw, int& rb, int& cb) {
  const double a = 2.0 * nw + 1.0;
  int r = static_cast<int>(0.5 * (a - sqrt(a * a - 8.0 * static_cast<double>(idx))));
  r = max(0, min(r, nw - 1));
  while (r > 0 && tile_start(r, nw) > idx) --r;
  while (r + 1 < nw && tile_start(r + 1, nw) <= idx) ++r;
  rb = r;
  cb = r + static_cast<int>(idx - tile_start(r, nw));
}

__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float4* __restrict__ boxes, const unsigned char* __restrict__ valid,
                uint64_t* __restrict__ mask, int K, int nw, long long ntiles, float thr) {
  __shared__ float4 sbox[kMaskTiles][kTile];
  __shared__ float sarea[kMaskTiles][kTile];
  __shared__ uint32_t srow[kMaskTiles][2], scol[kMaskTiles][2];
  const int b = blockIdx.y;
  const int tl = threadIdx.x / kTile, t = threadIdx.x % kTile, lane = threadIdx.x % 32;
  const long long idx = static_cast<long long>(blockIdx.x) * kMaskTiles + tl;
  const bool in = idx < ntiles;  // the same for the tile's two warps
  int rb = 0, cb = 0;
  if (in) tile_at(idx, nw, rb, cb);
  const float4* bx = boxes + static_cast<size_t>(b) * K;
  const unsigned char* vb = valid + static_cast<size_t>(b) * K;
  const int i = rb * kTile + t, p = cb * kTile + t;
  const bool vi = in && i < K && vb[i] != 0;
  const bool vp = in && p < K && vb[p] != 0;
  float4 bi = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vi) bi = bx[i];
  const float ai = __fmul_rn(__fsub_rn(bi.z, bi.x), __fsub_rn(bi.w, bi.y));
  if (vp) {
    const float4 v = bx[p];
    sbox[tl][t] = v;
    sarea[tl][t] = __fmul_rn(__fsub_rn(v.z, v.x), __fsub_rn(v.w, v.y));
  }
  const uint32_t rw = __ballot_sync(kAll, vi), cw = __ballot_sync(kAll, vp);
  if (lane == 0) {
    srow[tl][t / 32] = rw;
    scol[tl][t / 32] = cw;
  }
  __syncthreads();
  const uint64_t rows = srow[tl][0] | static_cast<uint64_t>(srow[tl][1]) << 32;
  const uint64_t cols = scol[tl][0] | static_cast<uint64_t>(scol[tl][1]) << 32;
  if (!in || rows == 0 || cols == 0) return;  // skipped: the scan never reads it
  const Threshold th = make_threshold(thr);
  // the row's live columns: valid, and after the row on the diagonal tile
  uint64_t live = vi ? cols : 0ull;
  if (cb == rb) live &= t == kTile - 1 ? 0ull : ~0ull << (t + 1);
  // 1. the columns whose box can overlap the row's: four comparisons a
  //    pair, a filter that keeps every pair `suppresses` can count (a NaN
  //    coordinate compares false, so it is kept too); below a threshold of
  //    0 every live pair counts
  uint64_t cand = live;
  if (th.thr >= 0.0f) {
    uint32_t half[2] = {0u, 0u};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float4 v = sbox[tl][32 * h + c];
        if (!(bi.z <= v.x || v.z <= bi.x || bi.w <= v.y || v.w <= bi.y)) half[h] |= 1u << c;
      }
    }
    cand &= static_cast<uint64_t>(half[1]) << 32 | half[0];
  }
  // 2. the exact test (`suppresses`, the plain version's bit for bit) on
  //    the marked pairs: each lane takes its own next column, so a step
  //    tests up to 32 pairs and the warp takes as many steps as its
  //    busiest lane has marks
  uint64_t word = 0;
  while (__any_sync(kAll, cand != 0)) {
    const bool has = cand != 0;
    const int c = has ? __ffsll(static_cast<long long>(cand)) - 1 : 0;
    cand &= cand - 1;
    if (suppresses(has, bi, ai, sbox[tl][c], sarea[tl][c], th)) word |= 1ull << c;
  }
  mask[(static_cast<size_t>(b) * ntiles + idx) * kTile + t] = word;
}

// the scan's dynamic shared memory at nw words, with rings of mpre tiles a
// block (see nms_scan_kernel)
size_t scan_bytes(int nw, int mpre) {
  const int nq = (nw + kScanCluster - 1) / kScanCluster;
  return (static_cast<size_t>(kScanWarps) * kRing * mpre * kTile + 3 * nw + nq) * 8;
}

// the tiles a scan warp prefetches a block: all of its words (mmax) where
// they fit kScanSmem, else as many as do (0: K too large)
int scan_prefetch(int nw) {
  const int nq = (nw + kScanCluster - 1) / kScanCluster;
  const int mmax = (nq + kScanWarps - 1) / kScanWarps;
  const size_t fixed = scan_bytes(nw, 0);
  const size_t per = scan_bytes(nw, 1) - fixed;
  if (fixed >= static_cast<size_t>(kScanSmem)) return 0;
  return static_cast<int>(std::min<size_t>(mmax, (kScanSmem - fixed) / per));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// an mbarrier of this CTA's shared memory that completes once: one arrival
// (made here) and the 8 bytes of one st.async
__device__ __forceinline__ void init_once_barrier(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], 8;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// wait until that barrier completes (acquire at cluster scope: the 8 bytes
// are visible after it); a lost store traps (a launch error) after ~2^22
// tries instead of hanging
__device__ __forceinline__ void wait_once_barrier(const uint64_t* bar) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
    if (done) return;
    if (tries == (1u << 22)) __trap();
  }
}

// the shared::cluster address of `p` (this CTA's shared memory) in CTA rank
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// 8 bytes into another CTA's shared memory, completing its barrier there
__device__ __forceinline__ void store_remote(uint32_t dst, uint64_t v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u64 [%0], %1, [%2];\n"
               ::"r"(dst), "l"(v), "r"(bar)
               : "memory");
}

// OR of the tile's rows whose bit of `kept` is set: lane l holds rows 2 l
// and 2 l + 1 (the 16 bytes it copied in), masked before the warp's OR
__device__ __forceinline__ uint64_t or_kept(const uint64_t* tile, uint64_t kept, int lane) {
  const ulonglong2 v = reinterpret_cast<const ulonglong2*>(tile)[lane];
  const uint64_t x = (((kept >> (2 * lane)) & 1ull) ? v.x : 0ull) |
                     (((kept >> (2 * lane + 1)) & 1ull) ? v.y : 0ull);
  const uint32_t lo = __reduce_or_sync(kAll, static_cast<uint32_t>(x));
  const uint32_t hi = __reduce_or_sync(kAll, static_cast<uint32_t>(x >> 32));
  return static_cast<uint64_t>(hi) << 32 | lo;
}

// greedy within a block: each box not yet removed, in order, is kept and
// removes what its row of the diagonal tile marks (only boxes after it).
// Returns the block's removed word (kept = ~it). The 64 rows are loaded
// into registers first (independent loads), then 64 unrolled steps of two
// dependent ALU operations: no load in the chain. A `__ffsll` loop over
// the boxes left (a load a kept box), alone or below 16 boxes left, was
// slower on the eval candidates (tools/ab_torch_fused.py --k1l-variants).
__device__ __forceinline__ uint64_t resolve(uint64_t removed, const uint64_t* diag) {
  uint64_t row[kTile];
#pragma unroll
  for (int t = 0; t < kTile; t += 2) {
    const ulonglong2 v = reinterpret_cast<const ulonglong2*>(diag)[t / 2];
    row[t] = v.x;
    row[t + 1] = v.y;
  }
#pragma unroll
  for (int t = 0; t < kTile; ++t)
    if (!((removed >> t) & 1ull)) removed |= row[t];
  return removed;
}

__global__ void __cluster_dims__(kScanCluster, 1, 1) __launch_bounds__(kScanThreads, 1)
nms_scan_kernel(const uint64_t* __restrict__ mask, const unsigned char* __restrict__ valid,
                unsigned char* __restrict__ keep, int K, int nw, int mpre) {
  // ring[warp][kRing][mpre][64] (tiles a warp prefetched), vword[nw] (valid
  // bits of each word), kept_s[nw] (each block's kept bits, written by its
  // owner), rem[nq] (`removed` of this CTA's words), bar[nw] (an mbarrier
  // a block: kept_s[w] has arrived)
  extern __shared__ __align__(16) uint64_t scan_smem[];
  __shared__ int nwe_s;  // words up to the last valid box
  const int nq = (nw + kScanCluster - 1) / kScanCluster;
  uint64_t* ring = scan_smem;
  uint64_t* vword = ring + static_cast<size_t>(kScanWarps) * kRing * mpre * kTile;
  uint64_t* kept_s = vword + nw;
  uint64_t* rem = kept_s + nw;
  uint64_t* bar = rem + nq;

  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kScanCluster;
  const int tid = threadIdx.x, lane = tid % 32, g = tid / 32;
  const long long ntiles = static_cast<long long>(nw) * (nw + 1) / 2;
  const uint64_t* mb = mask + static_cast<size_t>(b) * ntiles * kTile;
  const unsigned char* vb = valid + static_cast<size_t>(b) * K;

  // every barrier of the cluster is set up before any CTA stores into it:
  // the cluster barrier's arrive here, its wait before the first publish
  for (int j = tid; j < nw; j += kScanThreads) init_once_barrier(bar + j);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  if (tid == 0) nwe_s = 0;
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // the valid bits of every word (each CTA its own copy), 32 a ballot
  uint32_t* vhalf = reinterpret_cast<uint32_t*>(vword);
  for (int p0 = 0; p0 < nw * kTile; p0 += kScanThreads) {
    if (p0 + 32 * g < nw * kTile) {  // the same for the whole warp
      const int p = p0 + tid;
      const uint32_t bits = __ballot_sync(kAll, p < K && vb[p] != 0);
      if (lane == 0) vhalf[p / 32] = bits;
    }
  }
  __syncthreads();
  for (int j = tid; j < nw; j += kScanThreads)
    if (vword[j]) atomicMax(&nwe_s, j + 1);
  // invalid boxes, and the bits past K, start removed
  for (int q = tid; q < nq && q * kScanCluster + r < nw; q += kScanThreads)
    rem[q] = ~vword[q * kScanCluster + r];
  __syncthreads();
  const int nwe = nwe_s;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

  // this warp's words: j(m) = (g + 8 m) C + r, increasing in m; `last` is
  // the largest below nwe (words past it stay removed)
  auto word_of = [&](int m) { return (g + kScanWarps * m) * kScanCluster + r; };
  int last = -1;
  for (int m = 0; word_of(m) < nwe; ++m) last = word_of(m);
  // the first m with word_of(m) >= v
  auto first = [&](int v) {
    const int need = v - r;
    if (need <= g * kScanCluster) return 0;
    return ((need + kScanCluster - 1) / kScanCluster - g + kScanWarps - 1) / kScanWarps;
  };
  uint64_t* my_ring = ring + static_cast<size_t>(g) * kRing * mpre * kTile;
  auto global_tile = [&](int v, int m) {
    return mb + (tile_start(v, nw) + (word_of(m) - v)) * kTile;
  };
  // block v's slot holds the tiles of this warp's words m = f .. f + mpre
  // - 1, f = first(v); later words read theirs from device memory
  auto slot = [&](int v, int i) {
    return my_ring + (static_cast<size_t>(v % kRing) * mpre + i) * kTile;
  };
  auto tile = [&](int v, int m, int f) -> const uint64_t* {
    return m - f < mpre ? slot(v, m - f) : global_tile(v, m);
  };
  // block v's slot, skipping the tiles the mask kernel skipped; one
  // cp.async group a block, empty or not
  auto prefetch = [&](int v) {
    if (v <= last && vword[v] != 0) {
      const int f = first(v);
      for (int m = f; m < f + mpre && word_of(m) <= last; ++m)
        if (vword[word_of(m)] != 0)
          cp_async16(slot(v, m - f) + 2 * lane, global_tile(v, m) + 2 * lane);
    }
    cp_async_commit();
  };
  // kept_w into every CTA of the cluster: lane d stores it into CTA d's
  // kept_s[w], completing CTA d's barrier of block w
  const uint32_t dst_kept = cluster_addr(kept_s, lane % kScanCluster);
  const uint32_t dst_bar = cluster_addr(bar, lane % kScanCluster);
  auto publish = [&](int w, uint64_t kept) {
    if (lane < kScanCluster) store_remote(dst_kept + 8 * w, kept, dst_bar + 8 * w);
  };

  if (last >= 0) {
    for (int v = 0; v < kRing; ++v) prefetch(v);
    if (r == 0 && g == 0) {  // block 0: word 0 is this warp's first
      cp_async_wait<kRing - 1>();
      __syncwarp();
      const uint64_t x = resolve(rem[0], tile(0, 0, 0));
      rem[0] = x;
      publish(0, ~x);
    }
    for (int w = 0; w < last; ++w) {
      // this warp's first word at or after w, and after w
      const int f = first(w), m0 = first(w + 1);
      cp_async_wait<kRing - 2>();  // blocks w and w + 1 are in
      __syncwarp();
      wait_once_barrier(bar + w);
      const uint64_t kw = kept_s[w];
      // word w + 1 first, if it is this warp's: its resolve is the next
      // step of the chain; then the others
      for (int m = m0; word_of(m) <= last; ++m) {
        const int j = word_of(m), q = g + kScanWarps * m;
        uint64_t x = rem[q];
        if (kw != 0 && vword[j] != 0) x |= or_kept(tile(w, m, f), kw, lane);
        if (j == w + 1) {  // m = m0 = first(w + 1): in the ring
          x = resolve(x, tile(w + 1, m, m));
          publish(j, ~x);
        }
        rem[q] = x;  // the same value from every lane
      }
      __syncwarp();  // slot w % kRing is read: refill it
      prefetch(w + kRing);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // every block's kept bits have landed here before the CTA may leave
  if (g == 0)
    for (int w = lane; w < nwe; w += 32) wait_once_barrier(bar + w);

  // keep[p] = not removed, for every word of this warp: lane l writes
  // boxes 2 l and 2 l + 1 of the word
  unsigned char* out = keep + static_cast<size_t>(b) * K;
  for (int m = 0; word_of(m) < nw; ++m) {
    const int j = word_of(m);
    const uint64_t x = rem[g + kScanWarps * m];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = kTile * j + 2 * lane + e;
      if (p < K) out[p] = !((x >> (2 * lane + e)) & 1ull);
    }
  }
  // no CTA leaves while another may still write into its shared memory
  cluster.sync();
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
// workspace of B * nw (nw + 1) / 2 packed 512-byte tiles (nw = ceil(K /
// 64)), all on the device; two launches on `stream`, no allocation, no
// synchronisation
extern "C" int nms_keep_mask_large(const void* boxes, const void* valid, void* keep,
                                   void* mask, int B, int K, float thr, void* stream) {
  if (K < 1 || K > kMaxKLarge || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (K + kTile - 1) / kTile;
  const int mpre = scan_prefetch(nw);
  if (mpre < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the scan's shared-memory opt-in, once per device (a host call, kept
  // out of the launches a CUDA graph captures)
  static std::atomic<unsigned> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(opted_in.load() & (1u << dev))) {
    err = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kScanSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in.fetch_or(1u << dev);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ntiles = static_cast<long long>(nw) * (nw + 1) / 2;
  nms_mask_kernel<<<dim3(static_cast<unsigned>((ntiles + kMaskTiles - 1) / kMaskTiles), B),
                    kMaskThreads, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const unsigned char*>(valid),
      static_cast<uint64_t*>(mask), K, nw, ntiles, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<B * kScanCluster, kScanThreads, scan_bytes(nw, mpre), s>>>(
      static_cast<const uint64_t*>(mask), static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(keep), K, nw, mpre);
  return static_cast<int>(cudaGetLastError());
}
