// The 7x7 NCC score maps of a descent chunk's ROIs and each map's best, in
// one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package computes these maps with XLA
// operations (fastest_image_pattern_matching_tpu/models/template_matcher.py:
// 374-378: ccorr_shiftmm's matmul against the shifted templates, the window
// sums, the epilogue and an argmax), which XLA compiles into one program.
// The port's plain version (ops/ncc.py::descent_best_ref: ncc_score_map's
// shiftmm route, then roi_best) issues some 290 PyTorch operators a chunk
// from Python, about 115 kernel launches, and rebuilds a 49 x (h+6) x (w+6)
// f64 stack of shifted templates each time (159 MB at the flagship's level
// 0): the descent's chunks were bound by the host's launch path.
//
// What it computes, for each of B ROIs S [h+6, w+6] f32 and one template T
// [h, w] f32, both holding integers in [0, 255] (the descent's quantized
// warps; the route in models/template_matcher.py::descend_layer sends
// nothing else here), with Sc = S - 128, Tc = T - 128 and each shift
// (dy, dx) in [0, 7)^2:
//   corr = sum_{i<h, j<w} Sc[dy+i, dx+j] * Tc[i, j]
//   s1   = sum Sc[dy+i, dx+j],  s2 = sum Sc[dy+i, dx+j]^2  (same window)
// in integers (int8 x int8 -> int32 with __dp4a, int64 totals), each
// rounded to f32 once (__ll2float_rn): the exact sums the plain version's
// f64 matmul and f64 prefix sums round once. Then ops/ncc.py::_scores with
// its roundings spelled out (ncc_score below; -fmad=false besides), the
// first maximum in row-major order (NaN above any number, as torch.argmax),
// and ops/ncc.py::roi_best's outputs: value, (x, y), border flag, and the
// 3x3 patch around the maximum clamped inside the map. Integer sums do not
// depend on their order, so the results are bit-equal to the plain
// version's however the work is split.
//
// Design. Grid (bands, B), 256 threads. Block (band, b) takes template
// rows [i0, i0 + nr) of ROI b (nr <= 16, from the wrapper's plan) and
// stages, as words of four int8 values, those template rows and ROI rows
// [i0, i0 + nr + 6), zero-padded to whole words (two more words a ROI
// row). A shift dx = 4k + m reads a ROI word as a funnel shift of two
// staged words, so a (template row, word) item costs 21 shared loads, 35
// funnel shifts and 49 __dp4a into 49 int32 partials a thread.
// The window sums use row sums: each warp sums whole ROI rows for the 7
// column shifts (the last word masked to the template's width), and 98
// threads add them over the band's rows for each dy. The block adds its
// 147 band totals to the ROI's int64 scratch with atomics and takes a
// ticket; the band that finishes last computes the 49 scores, picks the
// best and writes the outputs. The flagship's level 0 (24 ROIs of 527x768,
// a 521x762 template) runs as 33 x 24 blocks.
//
// A stack of templates of one size (the glyphs of a plan group,
// models/batch.py::_match_group) runs as one launch too: the stack kernel
// reads ROI b's template index and that template's row of constants, then
// does the same block work (descent_score_block), so a descent chunk that
// holds the candidates of many glyphs is still one launch. A launch with
// one template takes descent_score_kernel, the same body with the template
// and the constants as before.
//
// Bound: bytes. The ROIs are read once (the template is small and stays in
// L2): 40.4 MB at the flagship's level 0, 12.1 us at 3.35 TB/s, against
// 0.93 G int8 multiply-adds, 0.47 us at 1979 TOPS. The design spends about
// 1.4x the ROI bytes (the bands' rows overlap by 6) and, at most, one
// shared load per __dp4a; chip_smoke.py phase 24 gives its time beside the
// bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kShifts = 7;                  // the map is kShifts x kShifts
constexpr int kMap = kShifts * kShifts;     // 49
constexpr int kSums = 3 * kMap;             // corr, s1, s2 of each shift
constexpr int kScratch = kSums + 1;         // and the ROI's ticket
constexpr int kMaxRows = 16;                // template rows a band at most
constexpr int kStagedRows = kMaxRows + kShifts - 1;

// The host-rounded f32 constants of ops/ncc.py::_scores.
struct Consts {
  float mean_c;    // f32(128 - f32(templ_mean))
  float area_c;    // f32(16384 * area)
  float inv_area;  // f32(inv_area)
  float norm;      // f32(templ_norm)
  float eps10;     // f32(10 * FLT_EPSILON)
  float tiny;      // f32(1e-30)
};

// Four consecutive values p[c0 .. c0 + 3], each v - 128 as an int8 byte,
// little-endian; columns at or beyond n give 0.
__device__ __forceinline__ unsigned pack4(const float* __restrict__ p,
                                          int c0, int n) {
  unsigned word = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int c = c0 + m;
    if (c < n)
      word |= (static_cast<unsigned>(__float2int_rn(p[c]) - 128) & 0xffu)
              << (8 * m);
  }
  return word;
}

// The seven words of a row whose byte j is Sc[row, dx + 4q + j], dx = 0..6,
// from the staged words a = q, b = q + 1, c = q + 2.
__device__ __forceinline__ void shifted(unsigned a, unsigned b, unsigned c,
                                        int (&s)[kShifts]) {
  s[0] = static_cast<int>(a);
  s[1] = static_cast<int>(__funnelshift_r(a, b, 8));
  s[2] = static_cast<int>(__funnelshift_r(a, b, 16));
  s[3] = static_cast<int>(__funnelshift_r(a, b, 24));
  s[4] = static_cast<int>(b);
  s[5] = static_cast<int>(__funnelshift_r(b, c, 8));
  s[6] = static_cast<int>(__funnelshift_r(b, c, 16));
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ops/ncc.py::_scores for one shift, each rounding where the plain version
// has it: rounding.fma(a, b, c) is f32(f64(a) * f64(b) + f64(c)) with both
// f64 steps rounded, every other step one f32 operation.
__device__ __forceinline__ float ncc_score(float corr, float s1, float s2,
                                           const Consts& k) {
  const float num = __double2float_rn(__dadd_rn(
      __dmul_rn(static_cast<double>(s1), static_cast<double>(k.mean_c)),
      static_cast<double>(corr)));
  const float wnd_sum2 =
      __fadd_rn(__fadd_rn(s2, __fmul_rn(256.0f, s1)), k.area_c);
  float diff2 = __double2float_rn(__dadd_rn(
      __dmul_rn(-static_cast<double>(__fmul_rn(s1, s1)),
                static_cast<double>(k.inv_area)),
      static_cast<double>(s2)));
  if (diff2 < 0.0f) diff2 = 0.0f;  // clamp_min: a NaN stays
  float cutoff = __fmul_rn(k.eps10, wnd_sum2);
  if (cutoff > 0.5f) cutoff = 0.5f;  // clamp_max: a NaN stays
  const float t =
      diff2 <= cutoff ? 0.0f : __fmul_rn(__fsqrt_rn(diff2), k.norm);
  const float num_abs = fabsf(num);
  const float safe_t = t < k.tiny ? k.tiny : t;
  if (num_abs < t) return __fdiv_rn(num, safe_t);
  if (num_abs < __fmul_rn(t, 1.125f))
    return num > 0.0f ? 1.0f : (num < 0.0f ? -1.0f : num);
  return 0.0f;
}

// Whether (a, ia) comes before (b, ib) in torch.argmax's order: a NaN
// before any number, a greater number before a smaller one, and among
// equals the least index.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = a != a;
  const bool nb = b != b;
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

// The work of block (band, b): ROI b against the template at `templ`,
// with the epilogue's constants k. Both kernels below are this body.
__device__ __forceinline__ void descent_score_block(
    const float* __restrict__ rois, const float* __restrict__ templ, int h,
    int w, int nq, int nr, const Consts& k, unsigned long long* scratch,
    float* __restrict__ v, int* __restrict__ xy,
    unsigned char* __restrict__ border, float* __restrict__ patch) {
  extern __shared__ unsigned staged[];
  __shared__ int warp_corr[kWarps][kMap];
  __shared__ int row_s1[kStagedRows * kShifts];
  __shared__ int row_s2[kStagedRows * kShifts];
  __shared__ float scores[kMap];
  __shared__ bool last;

  const int H = h + kShifts - 1;
  const int W = w + kShifts - 1;
  const int ws = nq + 2;  // words a staged ROI row
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * nr;
  const int rows = min(nr, h - i0);          // template rows of the band
  const int roi_rows = rows + kShifts - 1;   // ROI rows they touch
  unsigned* sroi = staged;
  unsigned* stpl = staged + roi_rows * ws;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* roi = rois + (static_cast<size_t>(b) * H + i0) * W;
  for (int e = tid; e < roi_rows * ws; e += kThreads) {
    const int r = e / ws;
    sroi[e] = pack4(roi + static_cast<size_t>(r) * W, 4 * (e - r * ws), W);
  }
  const float* tpl = templ + static_cast<size_t>(i0) * w;
  for (int e = tid; e < rows * nq; e += kThreads) {
    const int r = e / nq;
    stpl[e] = pack4(tpl + static_cast<size_t>(r) * w, 4 * (e - r * nq), w);
  }
  __syncthreads();

  // The correlation: item (template row il, word q). A thread's partials
  // stay in int32: it takes at most 28,672 / 256 items (the wrapper's
  // plan keeps nr * nq under SMEM_MAX / 8), each adding at most 4 * 128^2
  // a shift, and a warp's sums stay below 2^31 as well.
  int acc[kShifts][kShifts];
#pragma unroll
  for (int dy = 0; dy < kShifts; ++dy)
#pragma unroll
    for (int dx = 0; dx < kShifts; ++dx) acc[dy][dx] = 0;
  for (int e = tid; e < rows * nq; e += kThreads) {
    const int il = e / nq;
    const int q = e - il * nq;
    const int tw = static_cast<int>(stpl[e]);
    const unsigned* r = sroi + il * ws + q;
#pragma unroll
    for (int dy = 0; dy < kShifts; ++dy) {
      int s[kShifts];
      shifted(r[dy * ws], r[dy * ws + 1], r[dy * ws + 2], s);
#pragma unroll
      for (int dx = 0; dx < kShifts; ++dx)
        acc[dy][dx] = __dp4a(s[dx], tw, acc[dy][dx]);
    }
  }
#pragma unroll
  for (int dy = 0; dy < kShifts; ++dy)
#pragma unroll
    for (int dx = 0; dx < kShifts; ++dx) {
      const int x = warp_sum(acc[dy][dx]);
      if (lane == 0) warp_corr[warp][dy * kShifts + dx] = x;
    }

  // Row sums of Sc and Sc^2 over the template's width, for each column
  // shift, one warp a ROI row; the last word keeps only the bytes of
  // columns below w.
  const int tail = w - 4 * (nq - 1);
  const unsigned tail_mask =
      tail == 4 ? 0xffffffffu : (1u << (8 * tail)) - 1u;
  for (int r = warp; r < roi_rows; r += kWarps) {
    int r1[kShifts], r2[kShifts];
#pragma unroll
    for (int dx = 0; dx < kShifts; ++dx) r1[dx] = r2[dx] = 0;
    for (int q = lane; q < nq; q += 32) {
      const unsigned* p = sroi + r * ws + q;
      int s[kShifts];
      shifted(p[0], p[1], p[2], s);
      const int mask =
          static_cast<int>(q == nq - 1 ? tail_mask : 0xffffffffu);
#pragma unroll
      for (int dx = 0; dx < kShifts; ++dx) {
        const int m = s[dx] & mask;
        r1[dx] = __dp4a(m, 0x01010101, r1[dx]);
        r2[dx] = __dp4a(m, m, r2[dx]);
      }
    }
#pragma unroll
    for (int dx = 0; dx < kShifts; ++dx) {
      const int a = warp_sum(r1[dx]);
      const int c = warp_sum(r2[dx]);
      if (lane == 0) {
        row_s1[r * kShifts + dx] = a;
        row_s2[r * kShifts + dx] = c;
      }
    }
  }
  __syncthreads();

  // The band's totals, added to the ROI's scratch: corr from the warps'
  // partials; s1 and s2 of shift (dy, dx) from the rows dy .. dy + rows - 1.
  unsigned long long* sums = scratch + static_cast<size_t>(b) * kScratch;
  if (tid < kSums) {
    long long total = 0;
    if (tid < kMap) {
      for (int wp = 0; wp < kWarps; ++wp) total += warp_corr[wp][tid];
    } else {
      const int s = (tid - kMap) % kMap;
      const int* rs = tid < 2 * kMap ? row_s1 : row_s2;
      const int dy = s / kShifts;
      const int dx = s - dy * kShifts;
      for (int il = 0; il < rows; ++il)
        total += rs[(il + dy) * kShifts + dx];
    }
    atomicAdd(sums + tid, static_cast<unsigned long long>(total));
    __threadfence();
  }
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(sums + kSums, 1ull) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The last band of ROI b: the scores, the first maximum, the outputs.
  if (tid < kMap) {
    const long long* tot = reinterpret_cast<const long long*>(sums);
    scores[tid] = ncc_score(__ll2float_rn(__ldcg(tot + tid)),
                            __ll2float_rn(__ldcg(tot + kMap + tid)),
                            __ll2float_rn(__ldcg(tot + 2 * kMap + tid)), k);
  }
  __syncthreads();
  if (tid != 0) return;
  float best = scores[0];
  int bi = 0;
  for (int s = 1; s < kMap; ++s)
    if (better(scores[s], s, best, bi)) {
      best = scores[s];
      bi = s;
    }
  const int py = bi / kShifts;
  const int px = bi - py * kShifts;
  v[b] = best;
  xy[2 * b] = px;
  xy[2 * b + 1] = py;
  border[b] = px == 0 || px == kShifts - 1 || py == 0 || py == kShifts - 1;
  const int sy = min(max(py - 1, 0), kShifts - 3);
  const int sx = min(max(px - 1, 0), kShifts - 3);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      patch[9 * b + 3 * r + c] = scores[(sy + r) * kShifts + sx + c];
}

// One template [h, w] for every ROI, its constants by value.
__global__ void __launch_bounds__(kThreads, 2)
    descent_score_kernel(const float* __restrict__ rois,
                         const float* __restrict__ templ, int h, int w,
                         int nq, int nr, Consts k,
                         unsigned long long* scratch,
                         float* __restrict__ v, int* __restrict__ xy,
                         unsigned char* __restrict__ border,
                         float* __restrict__ patch) {
  descent_score_block(rois, templ, h, w, nq, nr, k, scratch, v, xy, border,
                      patch);
}

// A stack of templates [G, h, w]: ROI b takes template templ_index[b] and
// row templ_index[b] of the constants table [G, 6] (Consts' order).
__global__ void __launch_bounds__(kThreads, 2)
    descent_score_stack_kernel(const float* __restrict__ rois,
                               const float* __restrict__ templs,
                               const int* __restrict__ templ_index,
                               const float* __restrict__ consts, int h,
                               int w, int nq, int nr,
                               unsigned long long* scratch,
                               float* __restrict__ v, int* __restrict__ xy,
                               unsigned char* __restrict__ border,
                               float* __restrict__ patch) {
  const int t = templ_index[blockIdx.y];
  const float* c = consts + 6 * static_cast<size_t>(t);
  const Consts k{c[0], c[1], c[2], c[3], c[4], c[5]};
  descent_score_block(rois, templs + static_cast<size_t>(t) * h * w, h, w,
                      nq, nr, k, scratch, v, xy, border, patch);
}

// Dynamic shared memory above 48 KB has to be asked for, once per device
// and kernel: `raised` keeps, per kernel and device, the most asked for so
// far, so that a launch inside a CUDA graph's capture makes no such call.
constexpr int kMaxDevices = 64;
size_t raised[2][kMaxDevices];

template <typename Kernel>
int raise_smem(Kernel kernel, size_t (&done)[kMaxDevices], size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices && done[dev] >= bytes) return 0;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = bytes;
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// rois [B, h + 6, w + 6] f32 and templ [h, w] f32, integers in [0, 255];
// nr template rows a band (1 <= nr <= 16, from the wrapper's plan);
// scratch: B * 148 zeroed 64-bit words; v [B] f32, xy [B, 2] int32, border
// [B] bool, patch [B, 3, 3] f32; all contiguous on the current device. The
// six f32 constants are _scores' host-rounded ones (Consts); consts is then
// null. A stack of G templates: templ [G, h, w], templ_index [B] int32 (ROI
// b against template templ_index[b], each in [0, G)) and consts [G, 6] f32,
// row g template g's six constants; the six scalars are then unused.
// Launches on `stream` and returns cudaGetLastError() (or the error of
// raising the shared-memory limit, or cudaErrorInvalidValue for a plan it
// cannot run).
int fipm_descent_score(const float* rois, int B, const float* templ,
                       const int* templ_index, int h, int w, int nr,
                       const float* consts, float mean_c, float area_c,
                       float inv_area, float norm, float eps10, float tiny,
                       unsigned long long* scratch, float* v, int* xy,
                       unsigned char* border, float* patch, void* stream) {
  if (B < 1 || B > 65535 || h < 1 || w < 1 || nr < 1 || nr > kMaxRows ||
      (templ_index == nullptr) != (consts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nq = (w + 3) / 4;
  const int bands = (h + nr - 1) / nr;
  const size_t smem = sizeof(unsigned) *
      (static_cast<size_t>(min(nr, h) + kShifts - 1) * (nq + 2) +
       static_cast<size_t>(min(nr, h)) * nq);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (templ_index == nullptr) {
    const int e = raise_smem(descent_score_kernel, raised[0], smem);
    if (e != 0) return e;
    const Consts k{mean_c, area_c, inv_area, norm, eps10, tiny};
    descent_score_kernel<<<dim3(bands, B), kThreads, smem, s>>>(
        rois, templ, h, w, nq, nr, k, scratch, v, xy, border, patch);
  } else {
    const int e = raise_smem(descent_score_stack_kernel, raised[1], smem);
    if (e != 0) return e;
    descent_score_stack_kernel<<<dim3(bands, B), kThreads, smem, s>>>(
        rois, templ, templ_index, consts, h, w, nq, nr, scratch, v, xy,
        border, patch);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fipm_descent_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
