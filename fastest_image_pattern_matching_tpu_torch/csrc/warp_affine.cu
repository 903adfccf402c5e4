// Batched bilinear affine warp for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fastest_image_pattern_matching_tpu/ops/pallas/warp_kernel.py::warp_affine_pallas
// (body _warp_kernel_body). The TPU needed one-hot selection matmuls
// because its vector unit has no gather; here the taps are gathered from a
// staged copy of the source in shared memory.
//
// out[b, y, x] = bilinear sample of src [H, W] at inv_mats[b] @ (x, y, 1),
// or, for a stack of sources [N, H, W] with a source index idx [B], of
// source idx[b] (frames of a batch share one launch; block z reads
// src + idx[z] * H * W, an offset taken in 64 bits),
// with cv::warpAffine BORDER_CONSTANT semantics: each of the four taps is
// replaced by `border` outside the image, so pixels at the image edge blend
// partial taps with the border value. With `quantize` the result is
// rounded half to even, like torch.round.
//
// Design. A block of 128 threads owns a 32x32 output tile of one map
// (grid (ceil(Wo/32), ceil(Ho/32), B)); each thread computes 4 consecutive
// outputs along x in each of 2 rows 16 apart, and stores each 4 as one
// float4 when the rows are 16-byte aligned (Wo % 4 == 0), else as scalars,
// masking the ragged edge.
//   - Footprint. The block maps its tile's four corners with the per-pixel
//     arithmetic below. That arithmetic is monotone in x and in y (every
//     step is a correctly rounded add, multiply or fma of one varying
//     term), so floor(fx) and floor(fy) of every pixel of the tile lie
//     between the corners' values: the taps of the whole tile fall in the
//     box [min, max + 1] of the corners' floors, with no margin needed.
//   - Staging. The box's columns widen to whole 16-byte chunks of the
//     source rows. When the box holds at most kStage pixels (a 32x32 tile
//     at any rotation needs at most 56x50 = 2800), the block copies it
//     into shared memory in row order with cp.async, 16 bytes a chunk
//     where the source rows are 16-byte aligned (W % 4 == 0) and the chunk
//     lies inside the image, else 4 bytes a pixel, writing `border` for
//     pixels outside the image. The tap loop then reads shared memory with
//     no bounds checks.
//   - Large footprints. A general affine map with a large scale (or a map
//     with non-finite or huge coordinates) gives a box beyond kStage. Such
//     a block reads its taps from global memory with the bounds checks of
//     the plain version; it computes the same values. Each such block adds
//     one to *global_blocks (when given), so a run can count them; the
//     main path's maps are rotations and never take this branch.
// The arithmetic is spelled out with explicit intrinsics (__fmaf_rn,
// __fmul_rn, __fadd_rn) and the build passes -fmad=false, so the compiler
// contracts nothing on its own: floorf() of a coordinate contracted
// differently can differ near integers, and the blend would round
// differently. The fused multiply-adds sit exactly where the plain PyTorch
// version (ops/warp.py::warp_affine_batch) has them — which is also where
// XLA's CPU backend contracts the JAX reference:
//   fx = fma(a, x, b*y) + tx
//   out = fma(w11, v11, fma(w10, v10, fma(w00, v00, w01*v01)))
// The plain version evaluates each fma in f64, so the two agree bit for
// bit except where that f64 sum double-rounds (about 2^-29 of operations).
//
// Bound: memory. The bytes the function must move are the outputs (4 B
// each, written once) and the distinct source pixels the maps touch; at the
// flagship's level-0 descent (24 maps of 527x768 from 3036x4024) that is
// 18.2 us at 3.35 TB/s. The staged block reads its box once (1.1x its
// output area near 0 and 90 deg, 2.2x near 45 deg, from L2: the 49 MB
// level-0 source fits the 50 MB L2; the level-0 sources of a batch of
// several frames do not, and their boxes come from HBM), so the taps no
// longer cost one 32-byte sector per lane when a warp's lanes sample 32
// different source rows (near 90 deg), and each thread's 8 outputs share
// one box computation. What is left above the bound is the staging of the box:
// near 45 deg half of it lies outside the rotated footprint, and every
// staged pixel costs an instruction and a shared-memory store (PERF.md
// has the times by angle).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;    // output tile is kTile^2
constexpr int kVec = 4;      // consecutive outputs per thread along x
constexpr int kRowsPer = 2;  // tile rows per thread, kTile / kRowsPer apart
constexpr int kThreads = kTile * kTile / (kVec * kRowsPer);  // 128
constexpr int kRowStep = kThreads / (kTile / kVec);          // 16
constexpr int kStage = 4096;                  // staged source pixels, 16 KB
// Corner coordinates beyond this magnitude take the global branch, so the
// integer arithmetic of the staged branch cannot overflow.
constexpr float kMaxCoord = 16777216.0f;

struct Map {
  float a, b, tx, c, d, ty;
};

// fx = a*x + b*y + tx, fy = c*x + d*y + ty, in the plain version's form.
__device__ __forceinline__ void coords(const Map& m, int x, int y, float& fx,
                                       float& fy) {
  const float xf = static_cast<float>(x);
  const float yf = static_cast<float>(y);
  fx = __fadd_rn(__fmaf_rn(m.a, xf, __fmul_rn(m.b, yf)), m.tx);
  fy = __fadd_rn(__fmaf_rn(m.c, xf, __fmul_rn(m.d, yf)), m.ty);
}

// (1-ax)(1-ay) v00 + ax(1-ay) v01 + (1-ax) ay v10 + ax ay v11
__device__ __forceinline__ float blend(float ax, float ay, float v00,
                                       float v01, float v10, float v11,
                                       int quantize) {
  const float omx = __fsub_rn(1.0f, ax);
  const float omy = __fsub_rn(1.0f, ay);
  float acc = __fmul_rn(__fmul_rn(ax, omy), v01);
  acc = __fmaf_rn(__fmul_rn(omx, omy), v00, acc);
  acc = __fmaf_rn(__fmul_rn(omx, ay), v10, acc);
  acc = __fmaf_rn(__fmul_rn(ax, ay), v11, acc);
  return quantize ? rintf(acc) : acc;
}

__device__ __forceinline__ float tap(const float* __restrict__ src, int H,
                                     int W, int y, int x, float border) {
  return (x >= 0 && x < W && y >= 0 && y < H)
             ? __ldg(src + static_cast<size_t>(y) * W + x)
             : border;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__global__ void __launch_bounds__(kThreads)
warp_affine_kernel(const float* __restrict__ srcs, int H, int W,
                   const int* __restrict__ src_idx,
                   const float* __restrict__ mats, float* __restrict__ out,
                   int Ho, int Wo, float border, int quantize, int vec_load,
                   int vec_store, int* __restrict__ global_blocks) {
  __shared__ __align__(16) float stage[kStage];
  const float* __restrict__ src =
      src_idx == nullptr
          ? srcs
          : srcs + static_cast<size_t>(src_idx[blockIdx.z]) * H * W;
  const int tid = threadIdx.x;
  const int tx0 = blockIdx.x * kTile;
  const int ty0 = blockIdx.y * kTile;
  const float* mp = mats + 6 * blockIdx.z;
  const Map m{mp[0], mp[1], mp[2], mp[3], mp[4], mp[5]};

  // The tap box of the tile, from its four corners: lane q & 3 of every
  // warp maps corner q, and two butterfly steps give each lane the box.
  // Every warp computes the same values, so the branch below is uniform
  // across the block.
  const int lane = tid & 31;
  float fx, fy;
  coords(m, (lane & 1) ? min(tx0 + kTile, Wo) - 1 : tx0,
         (lane & 2) ? min(ty0 + kTile, Ho) - 1 : ty0, fx, fy);
  // fminf/fmaxf drop a NaN operand, so finiteness travels on its own.
  int finite = isfinite(fx) && isfinite(fy);
  float xlo = fx, xhi = fx, ylo = fy, yhi = fy;
#pragma unroll
  for (int step = 1; step < 4; step <<= 1) {
    xlo = fminf(xlo, __shfl_xor_sync(0xffffffffu, xlo, step));
    xhi = fmaxf(xhi, __shfl_xor_sync(0xffffffffu, xhi, step));
    ylo = fminf(ylo, __shfl_xor_sync(0xffffffffu, ylo, step));
    yhi = fmaxf(yhi, __shfl_xor_sync(0xffffffffu, yhi, step));
    finite &= __shfl_xor_sync(0xffffffffu, finite, step);
  }
  xlo = floorf(xlo); xhi = floorf(xhi);
  ylo = floorf(ylo); yhi = floorf(yhi);
  // The box's columns widen to whole 16-byte chunks of the source rows:
  // [xlo & ~3, (xhi + 2 + 3) & ~3), at most xhi - xlo + 8 of them.
  const bool staged =
      finite && fabsf(xlo) <= kMaxCoord && fabsf(xhi) <= kMaxCoord &&
      fabsf(ylo) <= kMaxCoord && fabsf(yhi) <= kMaxCoord &&
      (xhi - xlo + 8.0f) * (yhi - ylo + 2.0f) <= static_cast<float>(kStage);
  const int sx0 = staged ? static_cast<int>(xlo) & ~3 : 0;
  const int sy0 = staged ? static_cast<int>(ylo) : 0;
  const int fw = staged ? ((static_cast<int>(xhi) + 5) & ~3) - sx0 : 0;
  const int fh = staged ? static_cast<int>(yhi) - sy0 + 2 : 0;

  if (staged) {
    // Chunk i of the box is (row i / cw, chunk i % cw); each thread steps
    // by kThreads, carrying its row and chunk with no division. A chunk
    // wholly inside the image is one 16-byte copy when the source rows are
    // 16-byte aligned, else four 4-byte copies or border values.
    const int cw = fw >> 2;
    const int dr = kThreads / cw;
    const int dc = kThreads - dr * cw;
    int r = tid / cw;
    int c = tid - r * cw;
    for (int i = tid; i < cw * fh; i += kThreads) {
      const int gy = sy0 + r;
      const int gx = sx0 + 4 * c;
      float* d = stage + 4 * i;
      if (gy >= 0 && gy < H) {
        const float* g = src + static_cast<size_t>(gy) * W + gx;
        if (vec_load && gx >= 0 && gx < W) {
          cp_async16(d, g);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (gx + j >= 0 && gx + j < W)
              cp_async4(d + j, g + j);
            else
              d[j] = border;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) d[j] = border;
      }
      r += dr;
      c += dc;
      if (c >= cw) {
        c -= cw;
        ++r;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  } else if (tid == 0 && global_blocks != nullptr) {
    atomicAdd(global_blocks, 1);
  }

  const int xb = tx0 + (tid % (kTile / kVec)) * kVec;
  if (xb >= Wo) return;
#pragma unroll
  for (int j = 0; j < kRowsPer; ++j) {
    const int y = ty0 + tid / (kTile / kVec) + j * kRowStep;
    if (y >= Ho) return;
    float v[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      coords(m, xb + i, y, fx, fy);
      const float x0f = floorf(fx);
      const float y0f = floorf(fy);
      const float ax = __fsub_rn(fx, x0f);
      const float ay = __fsub_rn(fy, y0f);
      const int x0 = static_cast<int>(x0f);
      const int y0 = static_cast<int>(y0f);
      if (staged) {
        const float* s = stage + (y0 - sy0) * fw + (x0 - sx0);
        v[i] = blend(ax, ay, s[0], s[1], s[fw], s[fw + 1], quantize);
      } else {
        v[i] = blend(ax, ay, tap(src, H, W, y0, x0, border),
                     tap(src, H, W, y0, x0 + 1, border),
                     tap(src, H, W, y0 + 1, x0, border),
                     tap(src, H, W, y0 + 1, x0 + 1, border), quantize);
      }
    }
    float* o = out + (static_cast<size_t>(blockIdx.z) * Ho + y) * Wo + xb;
    if (vec_store && xb + kVec <= Wo) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        if (xb + i < Wo) o[i] = v[i];
    }
  }
}

}  // namespace

extern "C" {

// src [H, W] f32 (src_idx null) or [N, H, W] f32 with src_idx [B] int32,
// every entry in [0, N); mats [B, 2, 3] f32, out [B, Ho, Wo] f32, all
// contiguous on the current device, out 16-byte aligned. global_blocks: a
// device int that counts the blocks that read their taps from global
// memory, or null. Launches on `stream` and returns cudaGetLastError().
int fipm_warp_affine(const float* src, int H, int W, const int* src_idx,
                     const float* mats, int B, float* out, int Ho, int Wo,
                     float border, int quantize, int* global_blocks,
                     void* stream) {
  const dim3 grid((Wo + kTile - 1) / kTile, (Ho + kTile - 1) / kTile, B);
  // Every source of a stack starts 16-byte aligned when the first does and
  // W % 4 == 0 (then H * W % 4 == 0).
  warp_affine_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, H, W, src_idx, mats, out, Ho, Wo, border, quantize,
      W % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 ? 1 : 0,
      Wo % kVec == 0 ? 1 : 0, global_blocks);
  return static_cast<int>(cudaGetLastError());
}

const char* fipm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
