// Greedy peak extraction of score maps, every round on the card, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package runs these rounds as XLA
// operations inside a fori_loop (fastest_image_pattern_matching_tpu/ops/
// peaks.py::extract_peaks, and _extract_peaks_tiled for one large map),
// which XLA compiles into one program. The port's plain version
// (ops/peaks.py::extract_peaks_ref) issues about 27 PyTorch operators a
// round, each over the whole map, from a Python loop: for Test7's one
// 1798x1798 map and 105 rounds that is some 2,800 launches a match, and
// the host's launch path, not the card, set the stage's pace. This kernel
// runs all k rounds of a launch on the card.
//
// What it computes, for each of A score maps [Hs, Ws] f32, in k rounds:
//   (v, i) = the greatest value of the map, a NaN counting as greater than
//            any number, and among equal values the least flat index
//            i = y * Ws + x: torch.argmax's rule (and cv::minMaxLoc's);
//   vals[a, r] = v, locs[a, r] = (x, y);
//   x0 = (int)trunc(f32(x) - off_x), y0 likewise, in f32 arithmetic;
//   the map set to -1 over [x0, x0 + sw - 1] x [y0, y0 + sh - 1], clipped
//   to the map (empty when sw <= 0 or sh <= 0: then every later round
//   picks the same peak again, as the plain loop does).
// The order above is a strict total order on (value, index) pairs, so any
// reduction tree gives the same pick: the results are bit-equal to the
// plain loop's.
//
// Two forms, picked by the wrapper (ops/cuda/peaks_kernel.py::plan) from
// the map's size alone; they differ in cost, not in results.
//
// Small maps (Hs * Ws <= the wrapper's SMALL_MAX, 16384 values, 64 KB):
// one launch, one block of 256 threads per map (grid A). The block copies
// its map into shared memory and runs every round there: a block-wide
// reduction of (value, index), thread 0 writing the round's outputs, the
// rectangle filled in shared memory. The flagship's top layer (41 maps of
// 60x59, k = 8; 328 maps in a batch of 8) takes this form: one
// launch a sweep chunk, and at 14.2 KB a map 8 blocks fit an SM, so a
// batch's 328 blocks run in one wave.
//
// Large maps: a tile-max cache, the idea of _extract_peaks_tiled (and of
// the upstream tool's s_BlockMax). Tiles of TH x TW values, at least the
// rectangle's size, so a rectangle touches at most 2 x 2 tiles.
//   Launch 1, tile_stats_kernel, grid (tiles, A), 256 threads: each tile's
//   (max, least index at the max) into a scratch [A, tiles], and the map
//   copied into a working copy (the input stays as it is).
//   Launch 2, peaks_tiled_kernel, grid A, 1024 threads: the map's tile
//   cache in shared memory; each round reduces the cache to the pick, fills
//   the rectangle in the working copy in device memory (Test7's 13 MB map
//   stays in the 50 MB L2), then re-scans only the touched tiles, one
//   group of 32 / (tiles touched) warps per tile, and writes their new
//   (max, index) into the cache.
// Test7's 1798x1798 map with a 27x27 rectangle has 57 x 57 = 3,249 tiles
// of 32x32: a round reads 26 KB of cache from shared memory and at most
// 4,096 values of the map, in place of the plain loop's 27 passes over
// 3.2 M values.
//
// Bound: one read of the map, 12.9 MB for Test7, 3.9 us at 3.35 TB/s. The
// k rounds depend on each other, each a few block-wide barriers and, in the
// large form, a round trip to L2, so a launch takes k times a round's
// latency, some microseconds, far above that bound: the kernel is set by
// the chain of rounds, not by bytes, and a block per map is all the
// parallelism a round has. On one H100 at 700 W (chip_smoke.py phase 23):
// Test7's map 0.550 ms for its 105 rounds (5.2 us a round), against 32.9
// ms for the plain loop on the card; the flagship's 41 maps 0.014 ms for
// 8 rounds, a batch's 328 maps 0.019 ms. The wrapper's comment on
// SMALL_MAX gives the two forms' times around the switch.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kSmallThreads = 256;
constexpr int kStatsThreads = 256;
constexpr int kRoundThreads = 1024;
constexpr int kRoundWarps = kRoundThreads / 32;

__device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
}

// Whether (a, ia) comes before (b, ib): a NaN before any number, a greater
// number before a smaller one, and among equals (NaNs included) the least
// index.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = a != a;
  const bool nb = b != b;
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

__device__ __forceinline__ void take(float m, int f, float& v, int& i) {
  if (better(m, f, v, i)) {
    v = m;
    i = f;
  }
}

// Every lane ends with the warp's best pair.
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    take(ov, oi, v, i);
  }
}

// Every thread ends with the block's best pair, after one barrier. sv and
// si hold a pair per warp; the caller puts another barrier between this
// call and the next one, so that no warp writes them while another still
// reads them.
template <int kThreads>
__device__ __forceinline__ void block_best(float& v, int& i, float* sv,
                                           int* si) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  warp_best(v, i);
  if (lane == 0) {
    sv[threadIdx.x >> 5] = v;
    si[threadIdx.x >> 5] = i;
  }
  __syncthreads();
  v = neg_inf();
  i = INT_MAX;
  if (lane < kWarps) {
    v = sv[lane];
    i = si[lane];
  }
  warp_best(v, i);
}

// The suppression rectangle of the peak at flat index i, clipped to the
// map; inclusive bounds, empty when x0 > x1 or y0 > y1.
struct Rect {
  int x0, x1, y0, y1;
};

__device__ __forceinline__ Rect suppression(int x, int y, int Hs, int Ws,
                                            int sw, int sh, float off_x,
                                            float off_y) {
  const int rx = __float2int_rz(__fsub_rn(__int2float_rn(x), off_x));
  const int ry = __float2int_rz(__fsub_rn(__int2float_rn(y), off_y));
  return {max(rx, 0), min(rx + sw - 1, Ws - 1), max(ry, 0),
          min(ry + sh - 1, Hs - 1)};
}

// Thread 0 writes rounds r0 .. r1 - 1 of map a as the pick (v, x, y).
__device__ __forceinline__ void put(float* vals, int* locs, size_t a, int k,
                                    int r0, int r1, float v, int x, int y) {
  if (threadIdx.x != 0) return;
  for (int r = r0; r < r1; ++r) {
    const size_t o = a * k + r;
    vals[o] = v;
    locs[2 * o] = x;
    locs[2 * o + 1] = y;
  }
}

__global__ void __launch_bounds__(kSmallThreads)
    peaks_small_kernel(const float* __restrict__ scores, int Hs, int Ws,
                       int k, int sw, int sh, float off_x, float off_y,
                       float* __restrict__ vals, int* __restrict__ locs) {
  extern __shared__ float map[];
  __shared__ float sv[kSmallThreads / 32];
  __shared__ int si[kSmallThreads / 32];
  const int n = Hs * Ws;
  const size_t a = blockIdx.x;
  const float* src = scores + a * n;
  for (int e = threadIdx.x; e < n; e += kSmallThreads) map[e] = src[e];
  __syncthreads();
  for (int r = 0; r < k; ++r) {
    float v = neg_inf();
    int i = INT_MAX;
    for (int e = threadIdx.x; e < n; e += kSmallThreads)
      take(map[e], e, v, i);
    block_best<kSmallThreads>(v, i, sv, si);
    const int y = i / Ws;
    const int x = i - y * Ws;
    const Rect rc = suppression(x, y, Hs, Ws, sw, sh, off_x, off_y);
    if (rc.x0 > rc.x1 || rc.y0 > rc.y1) {
      // Nothing changes: every round left picks this peak again.
      put(vals, locs, a, k, r, k, v, x, y);
      return;
    }
    put(vals, locs, a, k, r, r + 1, v, x, y);
    const int rw = rc.x1 - rc.x0 + 1;
    for (int e = threadIdx.x; e < rw * (rc.y1 - rc.y0 + 1);
         e += kSmallThreads) {
      const int dy = e / rw;
      map[(rc.y0 + dy) * Ws + rc.x0 + e - dy * rw] = -1.0f;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kStatsThreads)
    tile_stats_kernel(const float* __restrict__ scores, int Hs, int Ws,
                      int TH, int TW, int nTx, int nT,
                      float* __restrict__ work, float* __restrict__ tile_max,
                      int* __restrict__ tile_idx) {
  __shared__ float sv[kStatsThreads / 32];
  __shared__ int si[kStatsThreads / 32];
  const int t = blockIdx.x;
  const size_t a = blockIdx.y;
  const int ty = t / nTx;
  const int r0 = ty * TH;
  const int c0 = (t - ty * nTx) * TW;
  const int cols = min(TW, Ws - c0);
  const int count = min(TH, Hs - r0) * cols;
  const size_t base = a * Hs * Ws;
  float v = neg_inf();
  int i = INT_MAX;
  for (int e = threadIdx.x; e < count; e += kStatsThreads) {
    const int dy = e / cols;
    const int f = (r0 + dy) * Ws + c0 + e - dy * cols;
    const float m = scores[base + f];
    work[base + f] = m;
    take(m, f, v, i);
  }
  block_best<kStatsThreads>(v, i, sv, si);
  if (threadIdx.x == 0) {
    tile_max[a * nT + t] = v;
    tile_idx[a * nT + t] = i;
  }
}

// `work` is written and read again by this kernel, so it is neither const
// nor __restrict__: its loads must not take the read-only path.
__global__ void __launch_bounds__(kRoundThreads)
    peaks_tiled_kernel(int Hs, int Ws, int k, int sw, int sh, float off_x,
                       float off_y, int TH, int TW, int nTx, int nT,
                       float* work, const float* __restrict__ tile_max,
                       const int* __restrict__ tile_idx,
                       float* __restrict__ vals, int* __restrict__ locs) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tmax = reinterpret_cast<float*>(smem);
  int* tidx = reinterpret_cast<int*>(tmax + nT);
  __shared__ float sv[kRoundWarps];
  __shared__ int si[kRoundWarps];
  __shared__ float pv[kRoundWarps];
  __shared__ int pi[kRoundWarps];
  const size_t a = blockIdx.x;
  float* map = work + a * Hs * Ws;
  for (int t = threadIdx.x; t < nT; t += kRoundThreads) {
    tmax[t] = tile_max[a * nT + t];
    tidx[t] = tile_idx[a * nT + t];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = 0; r < k; ++r) {
    float v = neg_inf();
    int i = INT_MAX;
    for (int t = threadIdx.x; t < nT; t += kRoundThreads)
      take(tmax[t], tidx[t], v, i);
    block_best<kRoundThreads>(v, i, sv, si);
    const int y = i / Ws;
    const int x = i - y * Ws;
    const Rect rc = suppression(x, y, Hs, Ws, sw, sh, off_x, off_y);
    if (rc.x0 > rc.x1 || rc.y0 > rc.y1) {
      put(vals, locs, a, k, r, k, v, x, y);
      return;
    }
    put(vals, locs, a, k, r, r + 1, v, x, y);
    const int rw = rc.x1 - rc.x0 + 1;
    for (int e = threadIdx.x; e < rw * (rc.y1 - rc.y0 + 1);
         e += kRoundThreads) {
      const int dy = e / rw;
      map[static_cast<size_t>(rc.y0 + dy) * Ws + rc.x0 + e - dy * rw] = -1.0f;
    }
    __syncthreads();
    // The touched tiles, 1, 2 or 4 of them (a tile is at least the
    // rectangle's size), each re-scanned by 32 / nt warps: warp w takes
    // tile w / wpt and every wpt-th of its rows, lane l every 32nd column.
    const int ty0 = rc.y0 / TH;
    const int tx0 = rc.x0 / TW;
    const int ntx = rc.x1 / TW - tx0 + 1;
    const int nt = (rc.y1 / TH - ty0 + 1) * ntx;
    const int wpt = kRoundWarps / nt;
    const int j = warp / wpt;
    const int ty = ty0 + j / ntx;
    const int tx = tx0 + j % ntx;
    const int c1 = min(tx * TW + TW, Ws);
    const int y1 = min(ty * TH + TH, Hs);
    float bv = neg_inf();
    int bi = INT_MAX;
    for (int yy = ty * TH + warp - j * wpt; yy < y1; yy += wpt)
      for (int xx = tx * TW + lane; xx < c1; xx += 32) {
        const int f = yy * Ws + xx;
        take(map[f], f, bv, bi);
      }
    warp_best(bv, bi);
    if (lane == 0) {
      pv[warp] = bv;
      pi[warp] = bi;
    }
    __syncthreads();
    if (threadIdx.x < nt) {
      const int jj = threadIdx.x;
      for (int w = jj * wpt + 1; w < (jj + 1) * wpt; ++w)
        take(pv[w], pi[w], pv[jj * wpt], pi[jj * wpt]);
      const int t = (ty0 + jj / ntx) * nTx + tx0 + jj % ntx;
      tmax[t] = pv[jj * wpt];
      tidx[t] = pi[jj * wpt];
    }
    __syncthreads();
  }
}

// Dynamic shared memory above 48 KB has to be asked for, once per kernel
// and device: `raised` keeps, per device, the most asked for so far, so
// that a launch inside a CUDA graph's capture makes no such call.
constexpr int kMaxDevices = 64;
size_t small_raised[kMaxDevices];
size_t tiled_raised[kMaxDevices];

template <typename Kernel>
int raise_smem(Kernel* kernel, size_t bytes, size_t* raised) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices && raised[dev] >= bytes) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess && dev < kMaxDevices) raised[dev] = bytes;
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// scores [A, Hs, Ws] f32, vals [A, k] f32, locs [A, k, 2] int32, all
// contiguous on the current device. TH == 0 takes the small form, one
// launch, and work, tile_max and tile_idx may be null. TH > 0 takes the
// tile-cache form with TH x TW tiles (TH >= sh, TW >= sw), two launches:
// work [A, Hs, Ws] f32 receives the working copy, tile_max [A, nT] f32 and
// tile_idx [A, nT] int32 the first launch's tile cache, nT =
// ceil(Hs / TH) * ceil(Ws / TW). Launches on `stream` and returns
// cudaGetLastError() (or the error of raising the shared-memory limit, or
// cudaErrorInvalidValue for tiles smaller than the rectangle).
int fipm_peaks(const float* scores, int A, int Hs, int Ws, int k, int sw,
               int sh, float off_x, float off_y, int TH, int TW, float* work,
               float* tile_max, int* tile_idx, float* vals, int* locs,
               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (TH == 0) {
    const size_t smem = static_cast<size_t>(Hs) * Ws * sizeof(float);
    const int e = raise_smem(peaks_small_kernel, smem, small_raised);
    if (e != 0) return e;
    peaks_small_kernel<<<A, kSmallThreads, smem, s>>>(
        scores, Hs, Ws, k, sw, sh, off_x, off_y, vals, locs);
    return static_cast<int>(cudaGetLastError());
  }
  if (TH < sh || TW < sw || TH < 1 || TW < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nTx = (Ws + TW - 1) / TW;
  const int nT = (Hs + TH - 1) / TH * nTx;
  tile_stats_kernel<<<dim3(nT, A), kStatsThreads, 0, s>>>(
      scores, Hs, Ws, TH, TW, nTx, nT, work, tile_max, tile_idx);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return static_cast<int>(e1);
  const size_t smem = static_cast<size_t>(nT) * (sizeof(float) + sizeof(int));
  const int e = raise_smem(peaks_tiled_kernel, smem, tiled_raised);
  if (e != 0) return e;
  peaks_tiled_kernel<<<A, kRoundThreads, smem, s>>>(
      Hs, Ws, k, sw, sh, off_x, off_y, TH, TW, nTx, nT, work, tile_max,
      tile_idx, vals, locs);
  return static_cast<int>(cudaGetLastError());
}

const char* fipm_peaks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
