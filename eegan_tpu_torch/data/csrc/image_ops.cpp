// Native host-side image ops for the data pipeline.
//
// The reference leans on torch's native DataLoader + torchvision transforms
// for its host pipeline (reference `train.py:269-278`); this is the
// equivalent native tier here: OpenMP-threaded uint8 HWC bilinear resize
// (triangle filter with support scaling on downscale, matching Pillow's
// BILINEAR behaviour), horizontal flip, crop, and fused
// resize+normalise-to-[-1,1] float32 conversion. Exposed with a plain C ABI
// for ctypes (no pybind11 in this image).
//
// The port's copy of native/image_ops.cpp (same code, so both packages give
// the same pixels). eegan_tpu_torch/data/native.py builds it at first use:
//   g++ -O3 -fopenmp -shared -fPIC image_ops.cpp -o <build>/libimage_ops-<hash>.so
// with <build> = build/eegan_tpu_torch/ at the repository root.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Tap {
  int lo;        // first source index
  int n;         // number of taps
  int coeff_off; // offset into the coefficient table
};

// Precompute triangle-filter taps for one axis (Pillow-style: filter
// support scales with the downscale factor; plain bilinear on upscale).
static void build_taps(int src, int dst, std::vector<Tap>& taps,
                       std::vector<float>& coeffs) {
  taps.resize(dst);
  coeffs.clear();
  const double scale = static_cast<double>(src) / dst;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;

  for (int i = 0; i < dst; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = static_cast<int>(std::floor(center - support));
    int hi = static_cast<int>(std::ceil(center + support));
    lo = std::max(lo, 0);
    hi = std::min(hi, src);
    const int off = static_cast<int>(coeffs.size());
    double total = 0.0;
    for (int j = lo; j < hi; ++j) {
      const double x = (j + 0.5 - center) / filterscale;
      const double w = (std::fabs(x) < 1.0) ? 1.0 - std::fabs(x) : 0.0;
      coeffs.push_back(static_cast<float>(w));
      total += w;
    }
    if (total > 0.0) {
      for (int j = off; j < static_cast<int>(coeffs.size()); ++j)
        coeffs[j] = static_cast<float>(coeffs[j] / total);
    } else if (hi > lo) {
      coeffs[off] = 1.0f;  // degenerate: nearest
    }
    taps[i] = {lo, hi - lo, off};
  }
}

static void resize_one(const uint8_t* src, int sh, int sw, int c,
                       float* dst, int dh, int dw) {
  if (sh == dh && sw == dw) {
    // scale == 1 makes the triangle filter an exact identity (the two
    // neighbour taps get weight 0); skip straight to the u8->f32 copy.
    const size_t n = static_cast<size_t>(sh) * sw * c;
    for (size_t i = 0; i < n; ++i) dst[i] = static_cast<float>(src[i]);
    return;
  }
  std::vector<Tap> xt, yt;
  std::vector<float> xc, yc;
  build_taps(sw, dw, xt, xc);
  build_taps(sh, dh, yt, yc);

  // horizontal pass into a temp (sh x dw x c)
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * c);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * c;
    float* trow = tmp.data() + static_cast<size_t>(y) * dw * c;
    for (int x = 0; x < dw; ++x) {
      const Tap& t = xt[x];
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.f;
        for (int k = 0; k < t.n; ++k)
          acc += xc[t.coeff_off + k] * row[(t.lo + k) * c + ch];
        trow[x * c + ch] = acc;
      }
    }
  }
  // vertical pass
  for (int y = 0; y < dh; ++y) {
    const Tap& t = yt[y];
    float* drow = dst + static_cast<size_t>(y) * dw * c;
    for (int x = 0; x < dw; ++x) {
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.f;
        for (int k = 0; k < t.n; ++k)
          acc += yc[t.coeff_off + k] *
                 tmp[static_cast<size_t>(t.lo + k) * dw * c + x * c + ch];
        drow[x * c + ch] = acc;
      }
    }
  }
}

}  // namespace

extern "C" {

// uint8 HWC -> float32 HWC resize (values stay in [0, 255]).
void resize_bilinear_u8_f32(const uint8_t* src, int sh, int sw, int c,
                            float* dst, int dh, int dw) {
  resize_one(src, sh, sw, c, dst, dh, dw);
}

// Batch: crop + optional hflip + K-scale pyramid, normalised to [-1, 1].
// src: B images, each (sh, sw, c) uint8, contiguous.
// crops: B x 4 ints (y, x, h, w). flips: B ints (0/1).
// For each k, out[k] is B x (sizes[k], sizes[k], c) float32.
void batch_pyramid(const uint8_t* src, int B, int sh, int sw, int c,
                   const int* crops, const int* flips,
                   const int* sizes, int K, float** outs) {
#pragma omp parallel for schedule(dynamic)
  for (int b = 0; b < B; ++b) {
    const uint8_t* img = src + static_cast<size_t>(b) * sh * sw * c;
    // crop + flip into a scratch buffer
    const int cy = crops[b * 4 + 0], cx = crops[b * 4 + 1];
    const int ch_ = crops[b * 4 + 2], cw = crops[b * 4 + 3];
    std::vector<uint8_t> crop(static_cast<size_t>(ch_) * cw * c);
    for (int y = 0; y < ch_; ++y) {
      const uint8_t* srow = img + (static_cast<size_t>(cy + y) * sw + cx) * c;
      uint8_t* drow = crop.data() + static_cast<size_t>(y) * cw * c;
      if (flips[b]) {
        for (int x = 0; x < cw; ++x)
          std::memcpy(drow + x * c, srow + (cw - 1 - x) * c, c);
      } else {
        std::memcpy(drow, srow, static_cast<size_t>(cw) * c);
      }
    }
    for (int k = 0; k < K; ++k) {
      const int s = sizes[k];
      float* out = outs[k] + static_cast<size_t>(b) * s * s * c;
      resize_one(crop.data(), ch_, cw, c, out, s, s);
      const size_t n = static_cast<size_t>(s) * s * c;
      for (size_t i = 0; i < n; ++i) out[i] = out[i] * (1.f / 127.5f) - 1.f;
    }
  }
}

// Variable-size batch pipeline over preloaded decoded images:
// per image i: shorter-side resize to `target` -> crop (y,x,base,base) ->
// optional hflip -> quantise to u8 -> per-branch resize -> [-1,1] float
// (out_u8 == 0, outs[k] is float32) or Pillow-rounded uint8 in [0, 255]
// (out_u8 == 1, outs[k] is uint8 — the 4x-smaller host->device transfer
// layout; normalisation then happens on-device inside the jitted step).
// srcs: B pointers to uint8 HWC images with dims[i*2]=h, dims[i*2+1]=w.
// crops: B x 3 ints (y, x, flip) in the resized coordinate frame.
// outs[k]: B x (sizes[k], sizes[k], c).
static void pyramid_varsize_impl(const uint8_t** srcs, const int* dims, int B,
                                 int c, int target, int base, const int* crops,
                                 const int* sizes, int K, void** outs,
                                 int out_u8) {
#pragma omp parallel for schedule(dynamic)
  for (int b = 0; b < B; ++b) {
    const int sh = dims[b * 2], sw = dims[b * 2 + 1];
    int oh, ow;
    if (sw <= sh) {
      ow = target;
      oh = std::max(1, static_cast<int>(std::lround(
                           static_cast<double>(target) * sh / sw)));
    } else {
      oh = target;
      ow = std::max(1, static_cast<int>(std::lround(
                           static_cast<double>(target) * sw / sh)));
    }
    // When the source is already at the augmentation frame (the preload
    // cache resizes there up front), the scale-1 resize is an exact
    // identity — crop straight from the uint8 source instead.
    const bool ident = (oh == sh && ow == sw);
    std::vector<float> resized;
    if (!ident) {
      resized.resize(static_cast<size_t>(oh) * ow * c);
      resize_one(srcs[b], sh, sw, c, resized.data(), oh, ow);
    }

    const int cy = crops[b * 3 + 0], cx = crops[b * 3 + 1];
    const int flip = crops[b * 3 + 2];
    std::vector<uint8_t> crop_u8(static_cast<size_t>(base) * base * c);
    std::vector<float> crop_f(static_cast<size_t>(base) * base * c);
    for (int y = 0; y < base; ++y) {
      for (int x = 0; x < base; ++x) {
        const int sx = flip ? (base - 1 - x) : x;
        const size_t off = (static_cast<size_t>(cy + y) * ow + cx + sx) * c;
        float* dstf = crop_f.data() + (static_cast<size_t>(y) * base + x) * c;
        uint8_t* dstu =
            crop_u8.data() + (static_cast<size_t>(y) * base + x) * c;
        for (int ch = 0; ch < c; ++ch) {
          const float v = ident ? static_cast<float>(srcs[b][off + ch])
                                : resized[off + ch];
          dstf[ch] = v;
          const float q = std::min(std::max(v, 0.f), 255.f);
          dstu[ch] = static_cast<uint8_t>(q);
        }
      }
    }
    std::vector<float> branch;
    for (int k = 0; k < K; ++k) {
      const int s = sizes[k];
      const size_t n = static_cast<size_t>(s) * s * c;
      const float* src_f;
      if (s == base) {
        src_f = crop_f.data();
      } else {
        branch.resize(n);
        resize_one(crop_u8.data(), base, base, c, branch.data(), s, s);
        src_f = branch.data();
      }
      if (out_u8) {
        uint8_t* out = static_cast<uint8_t*>(outs[k]) +
                       static_cast<size_t>(b) * n;
        for (size_t i = 0; i < n; ++i) {
          const float q = std::min(std::max(src_f[i], 0.f), 255.f);
          out[i] = static_cast<uint8_t>(std::lround(q));
        }
      } else {
        float* out = static_cast<float*>(outs[k]) + static_cast<size_t>(b) * n;
        for (size_t i = 0; i < n; ++i)
          out[i] = src_f[i] * (1.f / 127.5f) - 1.f;
      }
    }
  }
}

void batch_pyramid_varsize(const uint8_t** srcs, const int* dims, int B,
                           int c, int target, int base, const int* crops,
                           const int* sizes, int K, float** outs) {
  pyramid_varsize_impl(srcs, dims, B, c, target, base, crops, sizes, K,
                       reinterpret_cast<void**>(outs), /*out_u8=*/0);
}

void batch_pyramid_varsize_u8(const uint8_t** srcs, const int* dims, int B,
                              int c, int target, int base, const int* crops,
                              const int* sizes, int K, uint8_t** outs) {
  pyramid_varsize_impl(srcs, dims, B, c, target, base, crops, sizes, K,
                       reinterpret_cast<void**>(outs), /*out_u8=*/1);
}

}  // extern "C"
