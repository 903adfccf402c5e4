// Valid-mode raw cross-correlation of a batch of canvases with one small
// template, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fastest_image_pattern_matching_tpu/ops/pallas/corr_kernel.py::
// ccorr_tiledband_pallas (body _corr_body, bands _build_bands). The TPU
// kernel turns the correlation into residue-grouped banded-Toeplitz matmuls
// because Mosaic cannot address rows at unaligned offsets; none of that
// carries over. Here every block stages a canvas window and the template in
// shared memory and every thread multiplies them directly.
//
//   out[b, y, x] = sum_{dy < h, dx < w} canv[b, y + dy, x + dx] * templ[dy, dx]
//
// canv [B, H, W] f32 (centred, S - 128), templ [h, w] f32 (centred), out
// [B, H-h+1, W-w+1] f32; 1 <= h <= 64, 2 <= w <= 129 (the TPU kernel's
// eligibility, corr_kernel.py:78-83).
//
// Rounding: each template row's partial sum is a chain of f32 FMAs in dx
// order, starting from 0; the h row sums are added in f64 in dy order and
// the total is rounded to f32 once. On integer inputs of magnitude <= 128
// (the centred u8 values) every row sum is an integer below
// 129 * 128^2 < 2^24, so the FMAs are exact, the f64 sum is exact, and the
// result equals the exact sum rounded once: bit-equal to the plain version
// (ops/ncc.py::ccorr_tiled_ref, an f64 convolution) whatever the launch
// order. On fractional inputs (unquantized warps) each row sum carries at
// most w roundings of 2^-24 relative to sum |S*T| over the row. The build
// passes -fmad=false and every FMA here is written out, so the compiler
// contracts nothing on its own.
//
// Design: a block computes 32 output rows x 128 output columns of one
// canvas (B is blockIdx.z). Each of its 8 warps owns 16 columns; lane l owns
// row l, and each thread keeps its 16 consecutive outputs in registers. The
// block stages the (32 + h - 1) x (128 + WP) canvas window (WP = w rounded
// up to 16, the template zero-padded to WP columns) with an odd row pitch,
// so the 32 lanes of a warp, one row each, hit 32 different banks. A
// thread slides a 32-value register window along dx: one shared load of
// the canvas and one broadcast load of the template feed 16 FMAs. Results
// go out through shared memory so that global stores coalesce. The window
// of the largest template (h = 64, w = 129) takes 140 KB of dynamic shared
// memory.
//
// Bound, at the many-target path's shape (Test7 top layer: one 1824x1824
// canvas, a 27x27 template, a 1798x1798 map): 1798^2 * 729 =
// 2,356,714,116 multiply-adds; 13.3 MB of canvas read and 12.9 MB of map
// written. On an H100 SXM (3.35 TB/s) the bytes take 7.8 us; int8 tensor
// cores (1,979 TOP/s) would take 2.4 us for the MACs, so the function is
// bound by memory. This kernel runs on the CUDA cores instead, where the
// MACs, padded to WP = 32 columns, set the floor: 2.8 G FMAs at 67 TFLOP/s
// f32 is about 0.08 ms, ten times the memory bound. Neighbouring blocks
// read each other's halo again (2.3x the canvas for h = 27), from the
// 50 MB L2.
// Tensor cores (mma.sync / wgmma int8) and TMA staging are the way to the
// memory bound, and a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kTY = 32;            // output rows per block, one per lane
constexpr int kRX = 16;            // consecutive outputs per thread along x
constexpr int kWarps = 8;
constexpr int kTX = kWarps * kRX;  // output columns per block
constexpr int kThreads = kWarps * 32;

__global__ void __launch_bounds__(kThreads, 2)
ccorr_valid_kernel(const float* __restrict__ canv, int H, int W,
                   const float* __restrict__ templ, int h, int w,
                   float* __restrict__ out, int Ho, int Wo, int WP,
                   int pitch) {
  extern __shared__ float smem[];
  const int WR = kTY + h - 1;      // window rows
  const int WC = kTX + WP;         // window columns read by the sliding loop
  float* win = smem;               // [WR][pitch]
  float* tsh = smem + WR * pitch;  // [h][WP], zero beyond w

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTX;
  const int y0 = blockIdx.y * kTY;
  const float* src = canv + static_cast<size_t>(b) * H * W;

  for (int r = warp; r < h; r += kWarps)
    for (int c = lane; c < WP; c += 32)
      tsh[r * WP + c] = c < w ? templ[r * w + c] : 0.0f;
  // Outside the canvas the window holds 0; only padded template columns
  // (weight 0) and outputs beyond Ho x Wo ever read it.
  for (int r = warp; r < WR; r += kWarps) {
    const int gy = y0 + r;
    for (int c = lane; c < WC; c += 32) {
      const int gx = x0 + c;
      win[r * pitch + c] = (gy < H && gx < W)
                               ? __ldg(src + static_cast<size_t>(gy) * W + gx)
                               : 0.0f;
    }
  }
  __syncthreads();

  const float* wrow = win + lane * pitch + warp * kRX;
  double acc[kRX];
#pragma unroll
  for (int i = 0; i < kRX; ++i) acc[i] = 0.0;

  for (int dy = 0; dy < h; ++dy) {
    const float* s = wrow + dy * pitch;
    const float* t = tsh + dy * WP;
    float part[kRX];
    float cur[2 * kRX];  // canvas values s[d0 .. d0 + 2*kRX)
#pragma unroll
    for (int i = 0; i < kRX; ++i) {
      part[i] = 0.0f;
      cur[i] = s[i];
    }
    for (int d0 = 0; d0 < WP; d0 += kRX) {
#pragma unroll
      for (int i = 0; i < kRX; ++i) cur[kRX + i] = s[d0 + kRX + i];
#pragma unroll
      for (int d = 0; d < kRX; ++d) {
        const float tv = t[d0 + d];
#pragma unroll
        for (int i = 0; i < kRX; ++i)
          part[i] = __fmaf_rn(cur[i + d], tv, part[i]);
      }
#pragma unroll
      for (int i = 0; i < kRX; ++i) cur[i] = cur[kRX + i];
    }
#pragma unroll
    for (int i = 0; i < kRX; ++i)
      acc[i] = __dadd_rn(acc[i], static_cast<double>(part[i]));
  }

  // Stage the 32 x 128 result tile (pitch kTX + 1, conflict-free for the
  // lane-per-row writes), then store it row by row.
  __syncthreads();
  float* tile = smem;
#pragma unroll
  for (int i = 0; i < kRX; ++i)
    tile[lane * (kTX + 1) + warp * kRX + i] = __double2float_rn(acc[i]);
  __syncthreads();
  for (int r = warp; r < kTY; r += kWarps) {
    const int y = y0 + r;
    if (y >= Ho) break;
    float* o = out + (static_cast<size_t>(b) * Ho + y) * Wo;
    for (int c = lane; c < kTX; c += 32) {
      const int x = x0 + c;
      if (x < Wo) o[x] = tile[r * (kTX + 1) + c];
    }
  }
}

}  // namespace

extern "C" {

// canv [B, H, W] f32, templ [h, w] f32, out [B, H-h+1, W-w+1] f32, all
// contiguous on the current device. Launches on `stream` and returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
int fipm_ccorr_valid(const float* canv, int B, int H, int W,
                     const float* templ, int h, int w, float* out,
                     void* stream) {
  const int Ho = H - h + 1;
  const int Wo = W - w + 1;
  const int WP = (w + kRX - 1) / kRX * kRX;
  const int pitch = kTX + WP + 1;  // odd: kTX + WP is a multiple of 16
  const size_t smem =
      (static_cast<size_t>(kTY + h - 1) * pitch + static_cast<size_t>(h) * WP) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ccorr_valid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Wo + kTX - 1) / kTX, (Ho + kTY - 1) / kTY, B);
  ccorr_valid_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      canv, H, W, templ, h, w, out, Ho, Wo, WP, pitch);
  return static_cast<int>(cudaGetLastError());
}

const char* fipm_ccorr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
