// fipm_native — C++ runtime components for the TPU pattern-matching
// framework: BMP codec, threaded batch image loader, and host-side
// post-processing (greedy peak extraction + rotated-rect NMS oracle).
//
// The reference's runtime is C++ end to end; in the TPU build the compute
// path is XLA/Pallas and this library supplies the native runtime around
// it: zero-dependency image IO (the reference reads BMPs via OpenCV,
// MatchToolDlg.cpp:506-525), a prefetching data loader for corpus
// inspection (the reference's camera grabber thread analogue,
// src/CameraPreviewDialog.cpp:42-131), and exact host implementations of
// the sequential tails (GetNextMaxLoc, MatchToolDlg.cpp:1558-1582;
// FilterWithRotatedRect, :1498-1557) used for small candidate counts and
// as test oracles.
//
// Exposed as a plain C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// BMP codec (8-bit paletted, 24/32-bit BGR; uncompressed)
// ---------------------------------------------------------------------------

// Reads the BMP at `path`; on success fills *w/*h and returns a malloc'd
// grayscale buffer (row-major, top-down) the caller frees with
// fipm_free(). Returns nullptr on failure.
uint8_t* fipm_bmp_load_gray(const char* path, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  uint8_t header[54];
  if (fread(header, 1, 54, f) != 54 || header[0] != 'B' || header[1] != 'M') {
    fclose(f);
    return nullptr;
  }
  auto rd32 = [&](int off) {
    return (int32_t)(header[off] | header[off + 1] << 8 |
                     header[off + 2] << 16 | (uint32_t)header[off + 3] << 24);
  };
  auto rd16 = [&](int off) { return header[off] | header[off + 1] << 8; };
  int32_t data_off = rd32(10);
  int32_t hdr_size = rd32(14);
  int32_t width = rd32(18);
  int32_t height = rd32(22);
  int bpp = rd16(28);
  int32_t compression = rd32(30);
  if (width <= 0 || compression != 0 ||
      (bpp != 8 && bpp != 24 && bpp != 32)) {
    fclose(f);
    return nullptr;
  }
  bool bottom_up = height > 0;
  int32_t habs = height > 0 ? height : -height;

  // Palette for 8-bit (maps index -> gray via BT.601 on the RGBQUADs).
  std::vector<uint8_t> pal_gray(256, 0);
  if (bpp == 8) {
    int n_colors = rd32(46);
    if (n_colors <= 0 || n_colors > 256) n_colors = 256;
    if (fseek(f, 14 + hdr_size, SEEK_SET) != 0) { fclose(f); return nullptr; }
    std::vector<uint8_t> pal(4 * n_colors);
    if (fread(pal.data(), 1, pal.size(), f) != pal.size()) {
      fclose(f);
      return nullptr;
    }
    for (int i = 0; i < n_colors; i++) {
      double b = pal[4 * i], g = pal[4 * i + 1], r = pal[4 * i + 2];
      pal_gray[i] = (uint8_t)std::lround(0.299 * r + 0.587 * g + 0.114 * b);
    }
  }

  int bytes_pp = bpp / 8;
  size_t stride = ((size_t)width * bytes_pp + 3) & ~3u;
  std::vector<uint8_t> row(stride);
  uint8_t* out = (uint8_t*)malloc((size_t)width * habs);
  if (!out) { fclose(f); return nullptr; }
  if (fseek(f, data_off, SEEK_SET) != 0) { free(out); fclose(f); return nullptr; }
  for (int y = 0; y < habs; y++) {
    if (fread(row.data(), 1, stride, f) != stride) {
      free(out);
      fclose(f);
      return nullptr;
    }
    int oy = bottom_up ? habs - 1 - y : y;
    uint8_t* dst = out + (size_t)oy * width;
    if (bpp == 8) {
      for (int x = 0; x < width; x++) dst[x] = pal_gray[row[x]];
    } else {
      for (int x = 0; x < width; x++) {
        double b = row[x * bytes_pp], g = row[x * bytes_pp + 1],
               r = row[x * bytes_pp + 2];
        dst[x] = (uint8_t)std::lround(0.299 * r + 0.587 * g + 0.114 * b);
      }
    }
  }
  fclose(f);
  *w = width;
  *h = habs;
  return out;
}

// Writes `img` (row-major top-down grayscale) as an 8-bit paletted BMP.
int fipm_bmp_save_gray(const char* path, const uint8_t* img, int w, int h) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t stride = ((size_t)w + 3) & ~3u;
  uint32_t data_off = 54 + 256 * 4;
  uint32_t file_size = data_off + (uint32_t)(stride * h);
  uint8_t header[54] = {0};
  header[0] = 'B';
  header[1] = 'M';
  auto wr32 = [&](int off, uint32_t v) {
    header[off] = v & 0xff;
    header[off + 1] = (v >> 8) & 0xff;
    header[off + 2] = (v >> 16) & 0xff;
    header[off + 3] = (v >> 24) & 0xff;
  };
  auto wr16 = [&](int off, uint16_t v) {
    header[off] = v & 0xff;
    header[off + 1] = (v >> 8) & 0xff;
  };
  wr32(2, file_size);
  wr32(10, data_off);
  wr32(14, 40);
  wr32(18, (uint32_t)w);
  wr32(22, (uint32_t)h);
  wr16(26, 1);
  wr16(28, 8);
  wr32(34, (uint32_t)(stride * h));
  wr32(46, 256);
  fwrite(header, 1, 54, f);
  for (int i = 0; i < 256; i++) {
    uint8_t q[4] = {(uint8_t)i, (uint8_t)i, (uint8_t)i, 0};
    fwrite(q, 1, 4, f);
  }
  std::vector<uint8_t> row(stride, 0);
  for (int y = h - 1; y >= 0; y--) {  // bottom-up
    memcpy(row.data(), img + (size_t)y * w, w);
    fwrite(row.data(), 1, stride, f);
  }
  fclose(f);
  return 0;
}

void fipm_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// Host greedy peak extraction (GetNextMaxLoc oracle,
// MatchToolDlg.cpp:1558-1582)
// ---------------------------------------------------------------------------

// score: [hs*ws] f32 row-major (modified in place: suppression paints -1).
// Returns number of peaks written to out_x/out_y/out_v (up to k).
int fipm_extract_peaks(float* score, int hs, int ws, int k, int tw, int th,
                       double max_overlap, int* out_x, int* out_y,
                       float* out_v) {
  int n = 0;
  int sw = (int)(2 * tw * (1 - max_overlap));
  int sh = (int)(2 * th * (1 - max_overlap));
  for (int i = 0; i < k; i++) {
    int best = 0;
    float bv = score[0];
    for (int j = 1; j < hs * ws; j++)
      if (score[j] > bv) {
        bv = score[j];
        best = j;
      }
    int y = best / ws, x = best % ws;
    out_x[n] = x;
    out_y[n] = y;
    out_v[n] = bv;
    n++;
    int x0 = (int)(x - tw * (1 - max_overlap));
    int y0 = (int)(y - th * (1 - max_overlap));
    int xa = std::max(x0, 0), ya = std::max(y0, 0);
    int xb = std::min(x0 + sw - 1, ws - 1), yb = std::min(y0 + sh - 1, hs - 1);
    for (int yy = ya; yy <= yb; yy++)
      for (int xx = xa; xx <= xb; xx++) score[yy * ws + xx] = -1.0f;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Host rotated-rect NMS (FilterWithRotatedRect oracle,
// MatchToolDlg.cpp:1498-1557): Sutherland-Hodgman quad clip + greedy pass.
// ---------------------------------------------------------------------------

struct Pt {
  double x, y;
};

static double cross_edge(const Pt& a, const Pt& b, const Pt& p) {
  return (b.x - a.x) * (p.y - a.y) - (b.y - a.y) * (p.x - a.x);
}

static double quad_intersection_area(const Pt* qa, const Pt* qb) {
  std::vector<Pt> poly(qa, qa + 4), next;
  for (int e = 0; e < 4; e++) {
    const Pt& a = qb[e];
    const Pt& b = qb[(e + 1) % 4];
    next.clear();
    int n = (int)poly.size();
    for (int i = 0; i < n; i++) {
      const Pt& cur = poly[i];
      const Pt& nxt = poly[(i + 1) % n];
      double sc = cross_edge(a, b, cur), sn = cross_edge(a, b, nxt);
      if (sc >= 0) next.push_back(cur);
      if ((sc >= 0) != (sn >= 0)) {
        double t = sc / (sc - sn);
        next.push_back({cur.x + t * (nxt.x - cur.x),
                        cur.y + t * (nxt.y - cur.y)});
      }
    }
    poly = next;
    if (poly.empty()) return 0.0;
  }
  if (poly.size() < 3) return 0.0;
  double area = 0;
  for (size_t i = 0; i < poly.size(); i++) {
    const Pt& p = poly[i];
    const Pt& q = poly[(i + 1) % poly.size()];
    area += p.x * q.y - q.x * p.y;
  }
  return std::fabs(area) * 0.5;
}

// quads: [n][4][2] doubles (LT, RT, RB, LB), score-sorted desc; alive:
// in/out byte mask. templ_area = stop-layer rect area.
void fipm_filter_overlaps(const double* quads, int n, uint8_t* alive,
                          double templ_area, double max_overlap) {
  auto q = [&](int i) { return (const Pt*)(quads + (size_t)i * 8); };
  for (int i = 0; i < n - 1; i++) {
    if (!alive[i]) continue;
    for (int j = i + 1; j < n; j++) {
      if (!alive[j]) continue;
      double inter = quad_intersection_area(q(i), q(j));
      bool contain = inter >= templ_area * (1.0 - 1e-6);
      if (contain || inter / templ_area > max_overlap) alive[j] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// Threaded batch loader: N worker threads decode BMPs into a ring of
// preallocated slots; the consumer takes filled slots in submission order.
// ---------------------------------------------------------------------------

struct LoaderJob {
  std::string path;
  int index;
};

struct LoaderResult {
  std::vector<uint8_t> data;
  int w = 0, h = 0, index = -1, ok = 0;
};

struct Loader {
  std::vector<std::thread> workers;
  std::queue<LoaderJob> jobs;
  std::mutex mu;
  std::condition_variable cv_job, cv_res;
  std::vector<LoaderResult> results;
  std::atomic<int> next_emit{0};
  bool done = false;

  void work() {
    for (;;) {
      LoaderJob job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_job.wait(lk, [&] { return done || !jobs.empty(); });
        if (jobs.empty()) return;
        job = jobs.front();
        jobs.pop();
      }
      int w = 0, h = 0;
      uint8_t* buf = fipm_bmp_load_gray(job.path.c_str(), &w, &h);
      {
        std::lock_guard<std::mutex> lk(mu);
        LoaderResult& r = results[job.index];
        if (buf) {
          r.data.assign(buf, buf + (size_t)w * h);
          r.w = w;
          r.h = h;
          r.ok = 1;
          free(buf);
        }
        r.index = job.index;
      }
      cv_res.notify_all();
    }
  }
};

void* fipm_loader_create(const char** paths, int n, int n_threads) {
  Loader* L = new Loader();
  L->results.resize(n);
  for (int i = 0; i < n; i++) L->jobs.push({paths[i], i});
  int nt = std::max(1, std::min(n_threads, 16));
  for (int t = 0; t < nt; t++) L->workers.emplace_back([L] { L->work(); });
  L->cv_job.notify_all();
  return L;
}

// Blocks until item `index` is decoded; returns 1 on success and copies
// into out (caller allocates w*h after calling fipm_loader_shape).
int fipm_loader_shape(void* handle, int index, int* w, int* h) {
  Loader* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_res.wait(lk, [&] { return L->results[index].index == index; });
  if (!L->results[index].ok) return 0;
  *w = L->results[index].w;
  *h = L->results[index].h;
  return 1;
}

int fipm_loader_take(void* handle, int index, uint8_t* out) {
  Loader* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_res.wait(lk, [&] { return L->results[index].index == index; });
  LoaderResult& r = L->results[index];
  if (!r.ok) return 0;
  memcpy(out, r.data.data(), r.data.size());
  return 1;
}

void fipm_loader_destroy(void* handle) {
  Loader* L = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->done = true;
  }
  L->cv_job.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// --- decode loops: the port's own, beyond the JAX package's copy ---------
// The byte-serial inner loops of PNG and TIFF decode
// (utils/codecs/png.py, tiff.py). Inflate stays in Python's zlib, so this
// library needs no zlib. Each loop has a numpy / pure-Python twin beside
// its caller, which the tests hold it bit-equal to.

// PNG unfiltering (None, Sub, Up, Average, Paeth) of `rows` rows, each one
// filter-type byte and `row_bytes` bytes, `bpp` bytes per complete pixel
// (1 for sub-byte pixels), into `out` (rows * row_bytes). Returns 0, or
// the 1-based row of the first unknown filter type.
int64_t fipm_png_unfilter(const uint8_t* in, int64_t rows, int64_t row_bytes,
                          int bpp, uint8_t* out) {
  const int64_t lead = std::min<int64_t>(bpp, row_bytes);
  for (int64_t y = 0; y < rows; y++) {
    const uint8_t* src = in + y * (row_bytes + 1) + 1;
    uint8_t* cur = out + y * row_bytes;
    const uint8_t* up = y ? cur - row_bytes : nullptr;
    int ft = src[-1];
    if (ft > 4) return y + 1;
    // On the first row Up is None, Average halves the left byte and Paeth
    // is Sub; the first pixel's bytes have no left neighbour.
    if (!up && ft == 2) ft = 0;
    if (!up && ft == 4) ft = 1;
    if (ft == 0) {
      memcpy(cur, src, row_bytes);
      continue;
    }
    for (int64_t i = 0; i < lead; i++) {
      int b = up ? up[i] : 0;
      cur[i] = (uint8_t)(src[i] + (ft == 1 ? 0 : ft == 3 ? b >> 1 : b));
    }
    switch (ft) {
      case 1:
        for (int64_t i = bpp; i < row_bytes; i++)
          cur[i] = (uint8_t)(src[i] + cur[i - bpp]);
        break;
      case 2:
        for (int64_t i = bpp; i < row_bytes; i++)
          cur[i] = (uint8_t)(src[i] + up[i]);
        break;
      case 3:
        if (!up) {
          for (int64_t i = bpp; i < row_bytes; i++)
            cur[i] = (uint8_t)(src[i] + (cur[i - bpp] >> 1));
          break;
        }
        for (int64_t i = bpp; i < row_bytes; i++)
          cur[i] = (uint8_t)(src[i] + ((cur[i - bpp] + up[i]) >> 1));
        break;
      default:  // 4, Paeth: |p - a| = |b - c|, |p - b| = |a - c|, ...
        for (int64_t i = bpp; i < row_bytes; i++) {
          int a = cur[i - bpp], b = up[i], c = up[i - bpp];
          int pa = std::abs(b - c), pb = std::abs(a - c),
              pc = std::abs(a + b - 2 * c);
          // Branch-free select: noise defeats the branch predictor.
          int bc = pb <= pc ? b : c;
          int pred = ((pa <= pb) & (pa <= pc)) ? a : bc;
          cur[i] = (uint8_t)(src[i] + pred);
        }
    }
  }
  return 0;
}

// TIFF LZW (TIFF 6.0's MSB-first codes of 9 to 12 bits, the width growing
// one code early, as libtiff decodes) of `n` bytes into at most `cap`
// bytes of `out`. Stops at EOI, at the end of the input or when `out` is
// full. Returns the bytes written, or -1 for a code outside the table.
int64_t fipm_tiff_lzw_decode(const uint8_t* in, int64_t n, uint8_t* out,
                             int64_t cap) {
  std::vector<uint16_t> prefix(4096), length(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  for (int i = 0; i < 256; i++) {
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  int nbits = 9, free_ent = 258, old = -1;
  int64_t bitpos = 0, o = 0;
  const int64_t total = n * 8;
  while (o < cap && bitpos + nbits <= total) {
    // The code's bits lie in the three bytes from bitpos / 8 on.
    int64_t at = bitpos >> 3;
    uint32_t window = (uint32_t)in[at] << 16;
    if (at + 1 < n) window |= (uint32_t)in[at + 1] << 8;
    if (at + 2 < n) window |= in[at + 2];
    int code = (int)((window >> (24 - nbits - (bitpos & 7))) &
                     ((1u << nbits) - 1));
    bitpos += nbits;
    if (code == 256) {
      nbits = 9;
      free_ent = 258;
      old = -1;
      continue;
    }
    if (code == 257) break;
    if (old < 0) {
      if (code > 255) return -1;
      out[o++] = (uint8_t)code;
      old = code;
      continue;
    }
    if (code > free_ent || (code == free_ent && free_ent >= 4096))
      return -1;
    // The string of `code` (for code == free_ent: old's and old's first).
    int str = code < free_ent ? code : old;
    int64_t len = length[str] + (code == free_ent ? 1 : 0);
    uint8_t head = first[str];
    if (code == free_ent && o + len - 1 < cap) out[o + len - 1] = head;
    int64_t pos = length[str] - 1;
    for (int c = str; ; c = prefix[c], pos--) {
      if (o + pos < cap) out[o + pos] = suffix[c];
      if (pos == 0) break;
    }
    o = std::min(o + len, cap);
    if (free_ent < 4096) {
      prefix[free_ent] = (uint16_t)old;
      suffix[free_ent] = head;
      first[free_ent] = first[old];
      length[free_ent] = (uint16_t)(length[old] + 1);
      free_ent++;
      if (free_ent >= (1 << nbits) - 1 && nbits < 12) nbits++;
    }
    old = code;
  }
  return o;
}

// TIFF PackBits of `n` bytes into at most `cap` bytes of `out`. Stops at
// the end of the input, at a literal run the input cuts short, or when
// `out` is full. Returns the bytes written.
int64_t fipm_tiff_packbits_decode(const uint8_t* in, int64_t n, uint8_t* out,
                                  int64_t cap) {
  int64_t i = 0, o = 0;
  while (i < n && o < cap) {
    int c = (int8_t)in[i++];
    if (c >= 0) {
      if (i + c + 1 > n) break;
      int64_t k = std::min<int64_t>(c + 1, cap - o);
      memcpy(out + o, in + i, k);
      i += c + 1;
      o += k;
    } else if (c != -128) {
      if (i >= n) break;
      int64_t k = std::min<int64_t>(1 - c, cap - o);
      memset(out + o, in[i++], k);
      o += k;
    }
  }
  return o;
}

// Undoes TIFF's horizontal predictor (Predictor 2) in place on `rows` rows
// of `cols` pixels of `spp` samples, 8-bit (u8) or 16-bit (u16, native
// byte order) samples, each sample summed along its row modulo 2^bits.
void fipm_tiff_unpredict_u8(uint8_t* buf, int64_t rows, int64_t cols,
                            int spp) {
  for (int64_t y = 0; y < rows; y++) {
    uint8_t* row = buf + y * cols * spp;
    for (int64_t i = spp; i < cols * spp; i++)
      row[i] = (uint8_t)(row[i] + row[i - spp]);
  }
}

void fipm_tiff_unpredict_u16(uint16_t* buf, int64_t rows, int64_t cols,
                             int spp) {
  for (int64_t y = 0; y < rows; y++) {
    uint16_t* row = buf + y * cols * spp;
    for (int64_t i = spp; i < cols * spp; i++)
      row[i] = (uint16_t)(row[i] + row[i - spp]);
  }
}
// --- end of the decode loops -----------------------------------------------

}  // extern "C"
