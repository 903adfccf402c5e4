// Valid-mode raw cross-correlation of a batch of canvases with one small
// template, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fastest_image_pattern_matching_tpu/ops/pallas/corr_kernel.py::
// ccorr_tiledband_pallas (body _corr_body, bands _build_bands).
//
//   out[b, y, x] = sum_{dy < h, dx < w} canv[b, y + dy, x + dx] * templ[dy, dx]
//
// canv [B, H, W] f32 (centred, S - 128), templ [h, w] f32 (centred), out
// [B, H-h+1, W-w+1] f32; 1 <= h <= 64, 2 <= w <= 129 (the TPU kernel's
// eligibility, corr_kernel.py:78-83).
//
// A block owns 64 output rows x 128 output columns of one canvas (grid
// (ceil(Wo/128), ceil(Ho/64), B), 4 warps) and takes one of two paths,
// chosen per block with no host flag:
//
// int8 tensor-core path. On the main path the canvas and the template hold
// centred u8 values, integers in [-128, 127], so int8 x int8 -> int32 is
// exact: |sum| <= 64 * 129 * 128^2 < 2^31. The correlation is a
// banded-Toeplitz GEMM on the template side,
//   out[y, x0 + j] = sum_dy sum_k Sc[y + dy, x0 + k] * Band_dy[k, j],
//   Band_dy[k, j] = Tc[dy, k - j] for 0 <= k - j < w, else 0,
// run with mma.sync.m16n8k32 s8 (A from shared memory by ldmatrix). The dy
// shift is a row offset of the A tile in shared memory, so none of the
// TPU's residue grouping or sublane rotation carries over.
//   - Staging. The block loads its (64 + h - 1) x (32 * (3 + NC)) canvas
//     window once (float4 loads when rows are 16-byte aligned), converts it
//     to int8 with __float2int_rn and flags any value that is not an
//     integer in [-128, 127]; the template likewise, into zero-padded int8
//     rows. __syncthreads_or of the flags picks the path: wrong data can
//     never reach the int8 path.
//   - Tiling. Each warp owns 32 rows (2 m16 tiles) x 64 columns (8 n8
//     tiles). K runs over 32-column chunks of the window; an n8 tile at
//     column j0 needs the NC = floor((w + 30) / 32) + 1 chunks from
//     floor(j0 / 32) on (its taps span j0 .. j0 + w + 6), so one ldmatrix
//     of A feeds up to 4 * NC mmas of the warp. The band fragment of an n8
//     tile depends only on (dy, s = chunk - group, j0 mod 32, lane): the
//     4 NC + 2 distinct registers are built once per dy from the padded
//     template row (two 32-bit shared loads and a funnel shift each) and
//     serve every m and n tile of the warp.
//   - Epilogue. __int2float_rn of the int32 sum: the exact sum rounded
//     once, so bit-equal to ops/ncc.py::ccorr_tiled_ref (an f64 conv).
// The work is inflated from w to 32 * NC MACs per output and dy (64 / 27 =
// 2.4x for Test7's 27-wide template): the zero half of the band is the
// price of the tensor cores.
//
// f32 path (fractional canvases, from unquantized warps). The CUDA-core
// design this kernel had before its int8 path, on four 32 x 64 sub-tiles
// of the block: the sub-tile's window and the template in shared memory,
// lane l owns row l, each thread 16 consecutive outputs with a sliding
// register window; each template row's partial sum
// is a chain of f32 FMAs in dx order from 0, the h row sums are added in
// f64 in dy order and the total rounded to f32 once. On integer inputs that
// is exact as well; on fractional inputs each row sum carries at most w
// roundings of 2^-24 relative to sum |S*T| over the row. -fmad=false and
// explicit FMAs: the compiler contracts nothing on its own.
//
// Bound, at the many-target path's shape (Test7 top layer: one 1824x1824
// canvas, a 27x27 template, a 1798x1798 map): 13.3 MB of canvas read and
// 12.9 MB of map written, 7.8 us at 3.35 TB/s; the 2.36 G MACs take 2.4 us
// at the int8 tensor-core rate (1,979 TOP/s), so the function is bound by
// memory. The int8 path does 5.6 G MACs (the band inflation) on mma.sync,
// whose rate is below wgmma's peak, and reads each block's window (1.6x the
// canvas with the halos) from L2. What holds it above the bound: Test7's
// 435 blocks run as one wave (at most 128 registers a thread, 4 blocks an
// SM), so every block stages, then multiplies, then stores, and the three
// phases barely overlap; the staging keeps kBatch loads a thread in
// flight to cover the memory latency. A persistent kernel with a cp.async or
// TMA ring feeding wgmma is the way further. Each block's path is counted
// in path_blocks[0] (int8) or path_blocks[1] (f32) when given.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTY = 64;              // output rows per block
constexpr int kTN = 128;             // output columns per block
constexpr int kGroups = kTN / 32;    // 32-column groups per block
constexpr int kWarpRows = 32;        // 2 m16 tiles per warp
constexpr int kWarpCols = 64;        // 2 groups, 8 n8 tiles per warp
constexpr int kWarpGroups = kWarpCols / 32;
constexpr int kTplPad = 32;          // zero bytes before each template row
constexpr int kBatch = 8;            // staging loads in flight per thread
// f32 path sub-tile: one row per lane, kRX outputs per thread along x.
constexpr int kFY = 32;
constexpr int kRX = 16;
constexpr int kFX = kWarps * kRX;

__host__ __device__ constexpr int window_cols(int nc) {
  return 32 * (kGroups + nc - 1);
}
// Row pitch of the int8 window: a multiple of 16 bytes (ldmatrix rows are
// 16-byte aligned) with an odd multiple of 16, so the 8 rows of an
// ldmatrix phase fall in 8 different 16-byte bank groups.
__host__ __device__ constexpr int window_pitch(int nc) {
  return window_cols(nc) + 16;
}
__host__ __device__ constexpr int tpl_pitch(int nc) { return 32 * nc + 64; }

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 1 when v is not an integer in [-128, 127] (NaN and inf included).
__device__ __forceinline__ int not_int8(float v) {
  return !(v == rintf(v) && v >= -128.0f && v <= 127.0f);
}

__device__ __forceinline__ unsigned pack_int8(const float (&v)[4]) {
  unsigned word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    word |= (static_cast<unsigned>(__float2int_rn(v[j])) & 0xffu) << (8 * j);
  return word;
}

// canvas[gy, gx .. gx + 3], 0 outside the canvas. vec_load: the rows are
// 16-byte aligned (W % 4 == 0 and gx % 4 == 0), so the four are all in or
// all out.
__device__ __forceinline__ float4 load4(const float* __restrict__ src, int H,
                                        int W, int gy, int gx, int vec_load) {
  float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (gy >= H) return q;
  const float* p = src + static_cast<size_t>(gy) * W + gx;
  if (vec_load) {
    if (gx < W) q = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    if (gx < W) q.x = __ldg(p);
    if (gx + 1 < W) q.y = __ldg(p + 1);
    if (gx + 2 < W) q.z = __ldg(p + 2);
    if (gx + 3 < W) q.w = __ldg(p + 3);
  }
  return q;
}

// The f32 path over the block's 64 x 128 outputs, in 32 x 64 sub-tiles.
__device__ void f32_block(const float* __restrict__ src, int H, int W,
                          const float* __restrict__ templ, int h, int w,
                          float* __restrict__ out, int Ho, int Wo, int y0,
                          int x0, float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int WP = (w + kRX - 1) / kRX * kRX;  // template padded to WP
  const int pitch = kFX + WP + 1;            // odd: kFX + WP % 16 == 0
  const int WR = kFY + h - 1;
  const int WC = kFX + WP;
  float* tsh = smem;           // [h][WP], zero beyond w
  float* win = smem + h * WP;  // [WR][pitch]; then the result tile

  for (int r = warp; r < h; r += kWarps)
    for (int c = lane; c < WP; c += 32)
      tsh[r * WP + c] = c < w ? templ[r * w + c] : 0.0f;

  for (int sub = 0; sub < (kTY / kFY) * (kTN / kFX); ++sub) {
    const int sy0 = y0 + (sub / (kTN / kFX)) * kFY;
    const int sx0 = x0 + (sub % (kTN / kFX)) * kFX;
    if (sy0 >= Ho || sx0 >= Wo) continue;  // uniform across the block
    __syncthreads();
    // Outside the canvas the window holds 0; only padded template columns
    // (weight 0) and outputs beyond Ho x Wo ever read it. kBatch loads in
    // flight per thread, as in the int8 staging.
    for (int base = threadIdx.x; base < WR * WC; base += kBatch * kThreads) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads;
        const int r = i / WC;
        const int gy = sy0 + r;
        const int gx = sx0 + (i - r * WC);
        v[u] = (i < WR * WC && gy < H && gx < W)
                   ? __ldg(src + static_cast<size_t>(gy) * W + gx)
                   : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads;
        const int r = i / WC;
        if (i < WR * WC) win[r * pitch + (i - r * WC)] = v[u];
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

    // Stage the 32 x 64 result tile (pitch kFX + 1, conflict-free for the
    // lane-per-row writes), then store it row by row.
    __syncthreads();
    float* tile = win;
#pragma unroll
    for (int i = 0; i < kRX; ++i)
      tile[lane * (kFX + 1) + warp * kRX + i] = __double2float_rn(acc[i]);
    __syncthreads();
    for (int r = warp; r < kFY; r += kWarps) {
      const int y = sy0 + r;
      if (y >= Ho) break;
      float* o = out + static_cast<size_t>(y) * Wo;
      for (int c = lane; c < kFX; c += 32) {
        const int x = sx0 + c;
        if (x < Wo) o[x] = tile[r * (kFX + 1) + c];
      }
    }
  }
}

// At most 128 registers a thread, so that 4 blocks fit an SM: Test7's 435
// blocks then run in one wave.
template <int NC>
__global__ void __launch_bounds__(kThreads, 4)
ccorr_valid_kernel(const float* __restrict__ canv, int H, int W,
                   const float* __restrict__ templ, int h, int w,
                   float* __restrict__ out, int Ho, int Wo, int vec_load,
                   int* __restrict__ path_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int WC = window_cols(NC);
  constexpr int P = window_pitch(NC);
  constexpr int TPW = tpl_pitch(NC);
  constexpr int C4 = WC / 4;
  constexpr int T4 = TPW / 4;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTN;
  const int y0 = blockIdx.y * kTY;
  const float* src = canv + static_cast<size_t>(b) * H * W;
  float* dst = out + static_cast<size_t>(b) * Ho * Wo;
  const int WR = kTY + h - 1;
  unsigned char* win8 = smem;           // [WR][P] int8
  unsigned char* tpl8 = smem + WR * P;  // [h][TPW] int8, zero-padded

  // Stage the canvas window as int8; outside the canvas it holds 0. Each
  // thread starts kBatch loads before it converts any, so that enough
  // loads are in flight to cover the memory latency.
  int bad = 0;
  for (int base = tid; base < WR * C4; base += kBatch * kThreads) {
    float4 q[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads;
      const int r = i / C4;
      q[u] = i < WR * C4 ? load4(src, H, W, y0 + r, x0 + (i - r * C4) * 4,
                                 vec_load)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads;
      if (i >= WR * C4) break;
      const int r = i / C4;
      const float v[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) bad |= not_int8(v[j]);
      *reinterpret_cast<unsigned*>(win8 + r * P + (i - r * C4) * 4) =
          pack_int8(v);
    }
  }
  // The template: byte p of row dy holds Tc[dy, p - kTplPad], 0 outside.
  for (int i = tid; i < h * T4; i += kThreads) {
    const int r = i / T4;
    const int p = (i - r * T4) * 4 - kTplPad;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (p + j >= 0 && p + j < w) ? templ[r * w + p + j] : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) bad |= not_int8(v[j]);
    *reinterpret_cast<unsigned*>(tpl8 + r * TPW + p + kTplPad) = pack_int8(v);
  }
  const int fractional = __syncthreads_or(bad);
  if (tid == 0 && path_blocks != nullptr)
    atomicAdd(path_blocks + (fractional ? 1 : 0), 1);
  if (fractional) {
    f32_block(src, H, W, templ, h, w, dst, Ho, Wo, y0, x0,
              reinterpret_cast<float*>(smem));
    return;
  }

  const int g = lane >> 2;  // mma group: row of A and C, column of B
  const int t = lane & 3;   // thread in group
  const int wr0 = (warp / 2) * kWarpRows;
  const int wc0 = (warp % 2) * kWarpCols;
  // ldmatrix.x4: lanes 8q .. 8q + 7 address the rows of matrix q, which is
  // rows (q & 1) * 8 .. + 7 and bytes (q >> 1) * 16 .. + 15 of a 16 x 32
  // A tile: registers 0-3 are then the m16n8k32 A fragment.
  const unsigned a_base =
      static_cast<unsigned>(__cvta_generic_to_shared(win8)) +
      (wr0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + wc0 + (lane >> 4) * 16;
  const unsigned* tplw = reinterpret_cast<const unsigned*>(tpl8);

  int acc[2][4 * kWarpGroups][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < 4 * kWarpGroups; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0;

  for (int dy = 0; dy < h; ++dy) {
    // Band fragments. For the n8 tile at column 32 G + 8 u and the chunk
    // G + s, register 0 of lane (g, t) holds Tc[dy, f + 4t - g + i],
    // i = 0..3, with f = 32 s - 8 u; register 1 the same at f + 16.
    // bf[r] is that word for f = 8 r - 24.
    unsigned bf[4 * NC + 2];
    const unsigned* trow = tplw + dy * T4;
#pragma unroll
    for (int r = 0; r < 4 * NC + 2; ++r) {
      const int p = 8 * r - 24 + 4 * t - g + kTplPad;  // >= 1
      bf[r] = __funnelshift_r(trow[p >> 2], trow[(p >> 2) + 1], 8 * (p & 3));
    }
#pragma unroll
    for (int c = 0; c < kWarpGroups + NC - 1; ++c) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], a_base + (16 * mt + dy) * P + 32 * c);
#pragma unroll
      for (int s = 0; s < NC; ++s) {
        const int G = c - s;
        if (G < 0 || G >= kWarpGroups) continue;
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_s8(acc[mt][4 * G + u], a[mt], bf[4 * s - u + 3],
                   bf[4 * s - u + 5]);
      }
    }
  }

  // C fragment: lane (g, t) holds rows g and g + 8, columns 2t and 2t + 1.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int y = y0 + wr0 + 16 * mt + g + 8 * half;
      if (y >= Ho) continue;
      float* o = dst + static_cast<size_t>(y) * Wo;
#pragma unroll
      for (int n = 0; n < 4 * kWarpGroups; ++n) {
        const int x = x0 + wc0 + 8 * n + 2 * t;
        if (x < Wo) o[x] = __int2float_rn(acc[mt][n][2 * half]);
        if (x + 1 < Wo) o[x + 1] = __int2float_rn(acc[mt][n][2 * half + 1]);
      }
    }
  }
}

template <int NC>
int launch(const float* canv, int B, int H, int W, const float* templ, int h,
           int w, float* out, int vec_load, int* path_blocks,
           cudaStream_t stream) {
  const int Ho = H - h + 1;
  const int Wo = W - w + 1;
  const size_t int8_bytes =
      static_cast<size_t>(kTY + h - 1) * window_pitch(NC) +
      static_cast<size_t>(h) * tpl_pitch(NC);
  const int WP = (w + kRX - 1) / kRX * kRX;
  const size_t f32_bytes =
      (static_cast<size_t>(h) * WP +
       static_cast<size_t>(kFY + h - 1) * (kFX + WP + 1)) * sizeof(float);
  const size_t smem = int8_bytes > f32_bytes ? int8_bytes : f32_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ccorr_valid_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Wo + kTN - 1) / kTN, (Ho + kTY - 1) / kTY, B);
  ccorr_valid_kernel<NC><<<grid, kThreads, smem, stream>>>(
      canv, H, W, templ, h, w, out, Ho, Wo, vec_load, path_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// canv [B, H, W] f32, templ [h, w] f32, out [B, H-h+1, W-w+1] f32, all
// contiguous on the current device. path_blocks: two device ints that
// count the blocks of the int8 and the f32 path, or null. Launches on
// `stream` and returns cudaGetLastError() (or the error of raising the
// shared-memory limit).
int fipm_ccorr_valid(const float* canv, int B, int H, int W,
                     const float* templ, int h, int w, float* out,
                     int* path_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float4 staging loads need 16-byte aligned canvas rows.
  const int vec_load =
      W % 4 == 0 && reinterpret_cast<uintptr_t>(canv) % 16 == 0 ? 1 : 0;
  switch ((w + 30) / 32 + 1) {
    case 2: return launch<2>(canv, B, H, W, templ, h, w, out, vec_load,
                             path_blocks, s);
    case 3: return launch<3>(canv, B, H, W, templ, h, w, out, vec_load,
                             path_blocks, s);
    case 4: return launch<4>(canv, B, H, W, templ, h, w, out, vec_load,
                             path_blocks, s);
    case 5: return launch<5>(canv, B, H, W, templ, h, w, out, vec_load,
                             path_blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fipm_ccorr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
