// PIL-compatible bilinear resize (8-bit, antialiased) — native fast path.
//
// Reimplements Pillow's two-pass fixed-point resampling with the triangle
// (BILINEAR) filter so resized frames are byte-identical to the Python
// preprocessing path (torchvision Resize on PIL images, reference
// lrce/dataset/e2e_dataset.py:60-62). The algorithm: per output pixel,
// support = filterscale (max(in/out, 1)); triangle weights normalized and
// quantized to 1<<PRECISION_BITS fixed point; horizontal pass then vertical
// pass with int32 accumulation and symmetric rounding.
//
// C ABI:
//   int resize_bilinear_u8(const unsigned char* src, int h, int w, int c,
//                          unsigned char* dst, int oh, int ow);

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;

inline unsigned char clip8(int in) {
  if (in >= (255 << PRECISION_BITS)) return 255;
  if (in <= 0) return 0;
  return (unsigned char)(in >> PRECISION_BITS);
}

inline double triangle(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

// Pillow precompute_coeffs for one axis.
int precompute(int in_size, int out_size, std::vector<int>& bounds,
               std::vector<std::vector<int>>& kk) {
  double scale = (double)in_size / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;  // bilinear support = 1.0
  int ksize = (int)std::ceil(support) * 2 + 1;

  bounds.resize(out_size * 2);
  kk.assign(out_size, {});
  std::vector<double> w(ksize);

  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      double v = triangle((x + xmin - center + 0.5) * ss);
      w[x] = v;
      ww += v;
    }
    kk[xx].resize(xmax);
    for (int x = 0; x < xmax; ++x) {
      double v = ww == 0.0 ? 0.0 : w[x] / ww;
      kk[xx][x] = (int)(v < 0 ? v * (1 << PRECISION_BITS) - 0.5
                              : v * (1 << PRECISION_BITS) + 0.5);
    }
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  return ksize;
}

}  // namespace

extern "C" {

int resize_bilinear_u8(const unsigned char* src, int h, int w, int c,
                       unsigned char* dst, int oh, int ow) {
  if (!src || !dst || h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0)
    return -1;

  std::vector<int> hb, vb;
  std::vector<std::vector<int>> hk, vk;
  precompute(w, ow, hb, hk);
  precompute(h, oh, vb, vk);

  // horizontal pass: (h, w, c) -> (h, ow, c)
  std::vector<unsigned char> tmp((size_t)h * ow * c);
  for (int yy = 0; yy < h; ++yy) {
    const unsigned char* row = src + (size_t)yy * w * c;
    unsigned char* orow = tmp.data() + (size_t)yy * ow * c;
    for (int xx = 0; xx < ow; ++xx) {
      int xmin = hb[xx * 2], xmax = hb[xx * 2 + 1];
      const std::vector<int>& k = hk[xx];
      for (int ch = 0; ch < c; ++ch) {
        int ss = 1 << (PRECISION_BITS - 1);
        for (int x = 0; x < xmax; ++x)
          ss += row[(size_t)(x + xmin) * c + ch] * k[x];
        orow[(size_t)xx * c + ch] = clip8(ss);
      }
    }
  }

  // vertical pass: (h, ow, c) -> (oh, ow, c)
  for (int yy = 0; yy < oh; ++yy) {
    int ymin = vb[yy * 2], ymax = vb[yy * 2 + 1];
    const std::vector<int>& k = vk[yy];
    unsigned char* orow = dst + (size_t)yy * ow * c;
    for (int xx = 0; xx < ow * c; ++xx) {
      int ss = 1 << (PRECISION_BITS - 1);
      for (int y = 0; y < ymax; ++y)
        ss += tmp[(size_t)(y + ymin) * ow * c + xx] * k[y];
      orow[xx] = clip8(ss);
    }
  }
  return 0;
}

}  // extern "C"
