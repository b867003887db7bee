// Host pixel conversions of the ingest path, in one library that links
// nothing external: the Pillow-exact bicubic resample + center-crop for
// 8-bit RGB frames, and the Y4M reader's YUV 4:2:0 -> RGB (at the end).
//
// Replaces the PIL call in the ingest vision preprocess (ops/resize.py
// resize_crop_u8) with the SAME fixed-point algorithm Pillow runs
// (libImaging/Resample.c, 8bpc path): double-precision coefficient windows
// normalized per output pixel, quantized to int32 at PRECISION_BITS = 22,
// int32 accumulation seeded with a half-ulp, uint8 clip between the
// horizontal and vertical passes. Exactness is pinned by
// tests/test_resize.py::test_native_resize_matches_pil_exactly (bit-equal
// output vs PIL over random and image-like inputs at many shapes).
//
// Why native: the preprocess runs per kept keyframe inside the ingest loop;
// PIL costs ~2.8 ms/frame on one core, ~35% of it pack/unpack overhead
// (PIL stores RGB as 4 bytes/pixel, so fromarray packs RGBX, resamples 4
// channels, asarray unpacks). This is 3-channel direct, coefficient tables
// are computed once per batch, and frames fan out over a small thread pool.
//
// Reference surface: foundation_models.py:48-114 (torchvision
// Resize(BICUBIC) -> CenterCrop on PIL images) — the crop offsets arrive
// from Python, which keeps torchvision's int-truncation of the long side.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;  // Pillow's 8bpc precision

inline uint8_t clip8(int in) {
  if (in >= (1 << PRECISION_BITS << 8)) return 255;
  if (in <= 0) return 0;
  return (uint8_t)(in >> PRECISION_BITS);
}

double bicubic_filter(double x) {
  // Pillow's bicubic: a = -0.5, support = 2.0
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

// Pillow precompute_coeffs for the full [0, inSize) box, int-quantized.
// Returns ksize; fills bounds (outSize pairs of xmin,xmax) and kk
// (outSize * ksize int coefficients).
int precompute_coeffs(int inSize, int outSize, std::vector<int>& bounds,
                      std::vector<int>& kk) {
  double scale = (double)inSize / outSize;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 2.0 * filterscale;
  int ksize = (int)ceil(support) * 2 + 1;
  std::vector<double> prekk((size_t)outSize * ksize, 0.0);
  bounds.assign((size_t)outSize * 2, 0);
  for (int xx = 0; xx < outSize; xx++) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > inSize) xmax = inSize;
    xmax -= xmin;
    double* k = &prekk[(size_t)xx * ksize];
    int x = 0;
    for (; x < xmax; x++) {
      double w = bicubic_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; x++)
      if (ww != 0.0) k[x] /= ww;
    bounds[(size_t)xx * 2 + 0] = xmin;
    bounds[(size_t)xx * 2 + 1] = xmax;
  }
  kk.resize(prekk.size());
  for (size_t i = 0; i < prekk.size(); i++) {
    double v = prekk[i];
    kk[i] = v < 0 ? (int)(-0.5 + v * (1 << PRECISION_BITS))
                  : (int)(0.5 + v * (1 << PRECISION_BITS));
  }
  return ksize;
}

struct Plan {
  int ih, iw, nh, nw, y0, x0, oh, ow;
  bool do_h, do_v;
  int ksize_h = 0, ksize_v = 0;
  std::vector<int> hb, hk, vb, vk;  // bounds + int coeffs per axis
};

void make_plan(Plan& p) {
  p.do_h = !(p.nw == p.iw && p.x0 == 0 && p.ow == p.iw);
  p.do_v = !(p.nh == p.ih && p.y0 == 0 && p.oh == p.ih);
  if (p.do_h) p.ksize_h = precompute_coeffs(p.iw, p.nw, p.hb, p.hk);
  if (p.do_v) p.ksize_v = precompute_coeffs(p.ih, p.nh, p.vb, p.vk);
}

// One frame through the plan. tmp must hold ih*ow*3 bytes.
void resample_one(const Plan& p, const uint8_t* in, uint8_t* tmp,
                  uint8_t* out) {
  const int half = 1 << (PRECISION_BITS - 1);
  const uint8_t* hsrc = in;
  int hsrc_w = p.iw;
  if (p.do_h) {
    // horizontal: (ih, iw, 3) -> (ih, ow, 3), output cols [x0, x0+ow)
    for (int yy = 0; yy < p.ih; yy++) {
      const uint8_t* row = in + (size_t)yy * p.iw * 3;
      uint8_t* orow = tmp + (size_t)yy * p.ow * 3;
      for (int xi = 0; xi < p.ow; xi++) {
        int xx = p.x0 + xi;
        int xmin = p.hb[(size_t)xx * 2 + 0];
        int xmax = p.hb[(size_t)xx * 2 + 1];
        const int* k = &p.hk[(size_t)xx * p.ksize_h];
        int s0 = half, s1 = half, s2 = half;
        const uint8_t* px = row + (size_t)xmin * 3;
        for (int x = 0; x < xmax; x++, px += 3) {
          s0 += px[0] * k[x];
          s1 += px[1] * k[x];
          s2 += px[2] * k[x];
        }
        orow[xi * 3 + 0] = clip8(s0);
        orow[xi * 3 + 1] = clip8(s1);
        orow[xi * 3 + 2] = clip8(s2);
      }
    }
    hsrc = tmp;
    hsrc_w = p.ow;
  } else if (!p.do_v) {
    // pure crop (or identity)
    for (int yi = 0; yi < p.oh; yi++)
      memcpy(out + (size_t)yi * p.ow * 3,
             in + ((size_t)(p.y0 + yi) * p.iw + p.x0) * 3, (size_t)p.ow * 3);
    return;
  }
  if (!p.do_v) {
    if (hsrc == tmp)
      memcpy(out, tmp + (size_t)p.y0 * p.ow * 3, (size_t)p.oh * p.ow * 3);
    return;
  }
  const uint8_t* vin = hsrc;
  int vin_w = hsrc_w;
  int vcol0 = p.do_h ? 0 : p.x0;  // when horizontal was skipped, crop cols here
  // vertical: rows [y0, y0+oh) of the nh-tall result
  for (int yi = 0; yi < p.oh; yi++) {
    int yy = p.y0 + yi;
    int ymin = p.vb[(size_t)yy * 2 + 0];
    int ymax = p.vb[(size_t)yy * 2 + 1];
    const int* k = &p.vk[(size_t)yy * p.ksize_v];
    uint8_t* orow = out + (size_t)yi * p.ow * 3;
    for (int xi = 0; xi < p.ow; xi++) {
      const uint8_t* col = vin + ((size_t)ymin * vin_w + vcol0 + xi) * 3;
      int s0 = half, s1 = half, s2 = half;
      const uint8_t* px = col;
      for (int y = 0; y < ymax; y++, px += (size_t)vin_w * 3) {
        s0 += px[0] * k[y];
        s1 += px[1] * k[y];
        s2 += px[2] * k[y];
      }
      orow[xi * 3 + 0] = clip8(s0);
      orow[xi * 3 + 1] = clip8(s1);
      orow[xi * 3 + 2] = clip8(s2);
    }
  }
}

}  // namespace

extern "C" {

// Batch resize+crop: in (n, ih, iw, 3) uint8 -> out (n, oh, ow, 3) uint8,
// where (nh, nw) are the FULL resized dims and (y0, x0) the crop origin —
// the caller (ops/resize.py) computes them with torchvision's truncation.
// n_threads <= 1 runs inline. Returns 0 on success.
int hmm_resize_bicubic_crop_batch(const uint8_t* in, int64_t n, int ih, int iw,
                                  int nh, int nw, int y0, int x0, int oh,
                                  int ow, uint8_t* out, int n_threads) {
  if (n <= 0) return 0;
  if (ih <= 0 || iw <= 0 || nh <= 0 || nw <= 0 || oh <= 0 || ow <= 0)
    return -1;
  if (y0 < 0 || x0 < 0 || y0 + oh > nh || x0 + ow > nw) return -2;
  Plan p{ih, iw, nh, nw, y0, x0, oh, ow, false, false};
  make_plan(p);
  const size_t in_sz = (size_t)ih * iw * 3, out_sz = (size_t)oh * ow * 3;
  const size_t tmp_sz = (size_t)ih * ow * 3;
  auto run = [&](int64_t lo, int64_t hi) {
    std::vector<uint8_t> tmp(p.do_h ? tmp_sz : 0);
    for (int64_t i = lo; i < hi; i++)
      resample_one(p, in + (size_t)i * in_sz, tmp.data(),
                   out + (size_t)i * out_sz);
  };
  int nt = n_threads;
  if (nt > n) nt = (int)n;
  if (nt <= 1) {
    run(0, n);
    return 0;
  }
  std::vector<std::thread> threads;
  int64_t per = (n + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t lo = (int64_t)t * per, hi = lo + per;
    if (lo >= n) break;
    if (hi > n) hi = n;
    threads.emplace_back(run, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"

// YUV 4:2:0 -> RGB for the Y4M reader (media/io.py Y4MReader.read_rgb),
// bit-equal to media/io._yuv420_to_rgb_np: float32 arithmetic in numpy's
// order, each constant the float32 rounding of numpy's Python float, round
// half to even, then the clip to 0..255. The library builds with
// -ffp-contract=off and without -ffast-math, so no product is fused into
// its sum and no sum is reassociated. Pinned by tests/test_torch_y4m_rgb.py.
namespace {

// numpy rounds a Python float to float32 before a float32 ufunc
const float kRV = (float)1.402, kGU = (float)0.344136, kGV = (float)0.714136;
const float kBU = (float)1.772, kYS = (float)(255.0 / 219.0), kCS = (float)(255.0 / 224.0);

// np.clip(np.round(x), 0, 255).astype(np.uint8). For |x| < 2^22 (every
// value here is within +-600), x + 2^23 in float32 rounds x to the nearest
// integer, ties to even, where x >= 0; a negative x gives a value <= 0, as
// its rounding does, and both clip to 0. The clamp is on ints, which the
// vectoriser takes without SSE4.1; a float compare would stay a branch.
inline uint8_t round_clip(float x) {
  int i = (int)(x + 8388608.f) - 8388608;
  i = i < 0 ? 0 : i;
  i = i > 255 ? 255 : i;
  return (uint8_t)i;
}

inline float luma(uint8_t y, bool limited) {
  float f = (float)y;
  return limited ? (f - 16.f) * kYS : f;
}

// One frame. A chroma row's four products are computed once, each stored
// twice side by side so that `row` (4 * w floats) lines up with the luma
// row, and used by both of its luma rows. Always inlined, so that each
// clone of the entry below vectorises it for its own instruction set.
template <bool limited>
__attribute__((always_inline)) inline void yuv420_frame(
    const uint8_t* y, const uint8_t* u, const uint8_t* v, int h, int w,
    float* row, uint8_t* out) {
  const int cw = w / 2;
  float* __restrict rv = row;
  float* __restrict gu = row + w;
  float* __restrict gv = row + 2 * w;
  float* __restrict bu = row + 3 * w;
  for (int cy = 0; cy < h / 2; cy++) {
    const uint8_t* __restrict ur = u + (size_t)cy * cw;
    const uint8_t* __restrict vr = v + (size_t)cy * cw;
    for (int c = 0; c < cw; c++) {
      float uf = (float)ur[c] - 128.f, vf = (float)vr[c] - 128.f;
      if (limited) {
        uf = uf * kCS;
        vf = vf * kCS;
      }
      rv[2 * c] = rv[2 * c + 1] = kRV * vf;
      gu[2 * c] = gu[2 * c + 1] = kGU * uf;
      gv[2 * c] = gv[2 * c + 1] = kGV * vf;
      bu[2 * c] = bu[2 * c + 1] = kBU * uf;
    }
    for (int dy = 0; dy < 2; dy++) {
      const uint8_t* __restrict yr = y + (size_t)(2 * cy + dy) * w;
      uint8_t* __restrict o = out + (size_t)(2 * cy + dy) * w * 3;
      for (int x = 0; x < w; x++) {
        float yf = luma(yr[x], limited);
        o[3 * x + 0] = round_clip(yf + rv[x]);
        o[3 * x + 1] = round_clip((yf - gu[x]) - gv[x]);
        o[3 * x + 2] = round_clip(yf + bu[x]);
      }
    }
  }
}

}  // namespace

// The byte shuffles of the interleaved RGB store vectorise with SSSE3's
// pshufb; baseline x86-64 (SSE2) leaves that loop scalar at about twice the
// time. One clone for each, picked when the library loads; the float
// arithmetic is the same in both.
#if defined(__x86_64__) && defined(__GNUC__)
#define HMM_CLONES __attribute__((target_clones("avx2", "sse4.1", "default")))
#else
#define HMM_CLONES
#endif

extern "C" {

// n frames of 4:2:0 planes -> out (n, h, w, 3) uint8. Frame i's Y plane
// (h, w) starts at y + i * y_stride, its U and V planes (h/2, w/2) at
// u + i * c_stride and v + i * c_stride: contiguous planes give strides of
// h*w and h*w/4, one buffer of whole Y4M frame payloads the payload size
// for both. limited != 0 expands studio swing first. Returns 0, or -1 for
// a size that is not positive and even.
HMM_CLONES int hmm_yuv420_to_rgb_batch(const uint8_t* y, const uint8_t* u,
                            const uint8_t* v, int64_t n, int h, int w,
                            int64_t y_stride, int64_t c_stride, int limited,
                            uint8_t* out) {
  if (h <= 0 || w <= 0 || h % 2 || w % 2) return -1;
  std::vector<float> row((size_t)4 * w);
  const size_t out_sz = (size_t)h * w * 3;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* yi = y + i * y_stride;
    const uint8_t* ui = u + i * c_stride;
    const uint8_t* vi = v + i * c_stride;
    uint8_t* oi = out + (size_t)i * out_sz;
    if (limited)
      yuv420_frame<true>(yi, ui, vi, h, w, row.data(), oi);
    else
      yuv420_frame<false>(yi, ui, vi, h, w, row.data(), oi);
  }
  return 0;
}

}  // extern "C"
