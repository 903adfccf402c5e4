// Batched bilinear affine warp for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fastest_image_pattern_matching_tpu/ops/pallas/warp_kernel.py::warp_affine_pallas
// (body _warp_kernel_body). The TPU needed one-hot selection matmuls
// because its vector unit has no gather; here every thread simply gathers
// its four taps.
//
// out[b, y, x] = bilinear sample of src [H, W] at inv_mats[b] @ (x, y, 1),
// with cv::warpAffine BORDER_CONSTANT semantics: each of the four taps is
// checked against the image bounds and replaced by `border` outside them,
// so pixels at the image edge blend partial taps with the border value.
// With `quantize` the result is rounded half to even, like torch.round.
//
// Design: one thread per output pixel, x fastest, so stores coalesce.
// Grid (ceil(Wo/32), ceil(Ho/8), B), block 32x8; each block reads its
// map's six coefficients. The arithmetic is spelled out with explicit
// intrinsics (__fmaf_rn, __fmul_rn, __fadd_rn) and the build passes
// -fmad=false, so the compiler contracts nothing on its own: floorf() of a
// coordinate contracted differently can differ near integers, and the
// blend would round differently. The fused multiply-adds sit exactly where
// the plain PyTorch version (ops/warp.py::warp_affine_batch) has them —
// which is also where XLA's CPU backend contracts the JAX reference:
//   fx = fma(a, x, b*y) + tx
//   out = fma(w11, v11, fma(w10, v10, fma(w00, v00, w01*v01)))
// The plain version evaluates each fma in f64, so the two agree bit for
// bit except where that f64 sum double-rounds (about 2^-29 of operations).
//
// Bound: memory and L2. Each output pixel reads four f32 taps (16 B, mostly
// cache hits, since neighbouring threads sample neighbouring source pixels)
// and writes 4 B. The largest source of the main path, the 4024x3036 level 0
// of the flagship, is 49 MB, just under the H100's 50 MB L2, so the
// descent's level-0 ROIs read it from L2 after the first touch. Staging
// source windows in shared memory (TMA) is left to a later change.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float tap(const float* __restrict__ src, int H,
                                     int W, int y, int x, float border) {
  return (x >= 0 && x < W && y >= 0 && y < H)
             ? __ldg(src + static_cast<size_t>(y) * W + x)
             : border;
}

__global__ void warp_affine_kernel(const float* __restrict__ src, int H, int W,
                                   const float* __restrict__ mats,
                                   float* __restrict__ out, int Ho, int Wo,
                                   float border, int quantize) {
  const int b = blockIdx.z;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= Wo || y >= Ho) return;
  const float* m = mats + 6 * b;
  const float a = m[0], bx = m[1], tx = m[2];
  const float c = m[3], d = m[4], ty = m[5];
  const float xf = static_cast<float>(x);
  const float yf = static_cast<float>(y);

  // fx = a*x + b*y + tx, fy = c*x + d*y + ty, in the plain version's form.
  const float fx = __fadd_rn(__fmaf_rn(a, xf, __fmul_rn(bx, yf)), tx);
  const float fy = __fadd_rn(__fmaf_rn(c, xf, __fmul_rn(d, yf)), ty);
  const float x0f = floorf(fx);
  const float y0f = floorf(fy);
  const float ax = __fsub_rn(fx, x0f);
  const float ay = __fsub_rn(fy, y0f);
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);

  const float v00 = tap(src, H, W, y0, x0, border);
  const float v01 = tap(src, H, W, y0, x0 + 1, border);
  const float v10 = tap(src, H, W, y0 + 1, x0, border);
  const float v11 = tap(src, H, W, y0 + 1, x0 + 1, border);

  // (1-ax)(1-ay) v00 + ax(1-ay) v01 + (1-ax) ay v10 + ax ay v11
  const float omx = __fsub_rn(1.0f, ax);
  const float omy = __fsub_rn(1.0f, ay);
  float acc = __fmul_rn(__fmul_rn(ax, omy), v01);
  acc = __fmaf_rn(__fmul_rn(omx, omy), v00, acc);
  acc = __fmaf_rn(__fmul_rn(omx, ay), v10, acc);
  acc = __fmaf_rn(__fmul_rn(ax, ay), v11, acc);
  if (quantize) acc = rintf(acc);
  out[(static_cast<size_t>(b) * Ho + y) * Wo + x] = acc;
}

}  // namespace

extern "C" {

// src [H, W] f32, mats [B, 2, 3] f32, out [B, Ho, Wo] f32, all contiguous on
// the current device. Launches on `stream` and returns cudaGetLastError().
int fipm_warp_affine(const float* src, int H, int W, const float* mats, int B,
                     float* out, int Ho, int Wo, float border, int quantize,
                     void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((Wo + 31) / 32, (Ho + 7) / 8, B);
  warp_affine_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      src, H, W, mats, out, Ho, Wo, border, quantize);
  return static_cast<int>(cudaGetLastError());
}

const char* fipm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
