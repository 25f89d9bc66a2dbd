// fastimage: threaded JPEG/PNG decode + PIL-compatible resize + crop +
// normalize, on the host.
//
// libjpeg / libpng decode (with optional DCT-domain downscale for JPEG), a
// separable triangle-filter resize that matches PIL's antialiased
// BILINEAR, centre crop, optional horizontal flip, then float32 normalised
// or uint8 NHWC output, over a small thread pool: one C call per batch.
// The arithmetic is the JAX package's decoder's (visreps_tpu/native/
// fastimage.cpp), so both packages give the same pixels bit for bit.
//
// Built as a plain shared library by g++ and loaded with ctypes from
// visreps_tpu_torch/native/__init__.py.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file to tightly packed RGB8. Returns true on success.
// When fast_dct is set, uses libjpeg's DCT-domain scaling to decode at
// the smallest 1/1..1/8 scale whose shorter side still covers `min_side`.
bool decode_jpeg(const char* path, int min_side, bool fast_dct,
                 std::vector<unsigned char>& pixels, int& width, int& height) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  if (fast_dct && min_side > 0) {
    int denom = 1;
    int shorter = std::min<int>(cinfo.image_width, cinfo.image_height);
    while (denom < 8 && shorter / (denom * 2) >= min_side) denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }

  jpeg_start_decompress(&cinfo);
  width = cinfo.output_width;
  height = cinfo.output_height;
  const int channels = cinfo.output_components;  // 3 for JCS_RGB
  pixels.resize(static_cast<size_t>(width) * height * 3);

  std::vector<unsigned char> row(static_cast<size_t>(width) * channels);
  unsigned char* rowp = row.data();
  for (int y = 0; y < height; ++y) {
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    unsigned char* dst = pixels.data() + static_cast<size_t>(y) * width * 3;
    if (channels == 3) {
      memcpy(dst, rowp, static_cast<size_t>(width) * 3);
    } else {  // grayscale fallback
      for (int x = 0; x < width; ++x) {
        dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = rowp[x * channels];
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Decode a PNG file to tightly packed RGB8 (palette/gray/alpha/16-bit
// inputs normalized via libpng transforms). NSD-Synthetic's 220 stimuli
// are PNGs.
bool decode_png_file(const char* path, std::vector<unsigned char>& pixels,
                     int& width, int& height) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char header[8];
  if (fread(header, 1, 8, f) != 8 || png_sig_cmp(header, 0, 8)) {
    fclose(f);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(f);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    fclose(f);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  const png_byte color = png_get_color_type(png, info);
  const png_byte depth = png_get_bit_depth(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  width = static_cast<int>(png_get_image_width(png, info));
  height = static_cast<int>(png_get_image_height(png, info));
  if (png_get_rowbytes(png, info) != static_cast<size_t>(width) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return false;
  }
  pixels.resize(static_cast<size_t>(width) * height * 3);
  std::vector<png_bytep> rows(height);
  for (int y = 0; y < height; ++y)
    rows[y] = pixels.data() + static_cast<size_t>(y) * width * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return true;
}

// Magic-byte format sniff + dispatch. PNG has no DCT-domain scaling, so
// it decodes full-size and relies on the resampler.
bool decode_image(const char* path, int min_side, bool fast_dct,
                  std::vector<unsigned char>& pixels, int& width, int& height) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[2] = {0, 0};
  size_t got = fread(magic, 1, 2, f);
  fclose(f);
  if (got == 2 && magic[0] == 0x89 && magic[1] == 0x50)
    return decode_png_file(path, pixels, width, height);
  return decode_jpeg(path, min_side, fast_dct, pixels, width, height);
}

// PIL-compatible separable resampling with the BILINEAR (triangle)
// filter: support scales with the downscale ratio (antialiasing), weights
// normalized per output pixel — matches PIL ImagingResample semantics.
struct WeightTable {
  std::vector<int> bounds;     // (out, 2): start index, count
  std::vector<float> weights;  // (out, max_taps)
  int max_taps = 0;
};

WeightTable build_weights(int in_size, int out_size) {
  WeightTable wt;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filter_scale = std::max(scale, 1.0);
  const double support = 1.0 * filter_scale;  // BILINEAR support = 1
  wt.max_taps = static_cast<int>(std::ceil(support) * 2 + 1);
  wt.bounds.resize(static_cast<size_t>(out_size) * 2);
  wt.weights.assign(static_cast<size_t>(out_size) * wt.max_taps, 0.0f);

  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    const int taps = xmax - xmin;

    double total = 0.0;
    std::vector<double> w(taps);
    for (int k = 0; k < taps; ++k) {
      double arg = (xmin + k - center + 0.5) / filter_scale;
      double v = std::abs(arg) < 1.0 ? 1.0 - std::abs(arg) : 0.0;  // triangle
      w[k] = v;
      total += v;
    }
    if (total == 0.0) total = 1.0;
    for (int k = 0; k < taps; ++k) {
      wt.weights[static_cast<size_t>(xx) * wt.max_taps + k] =
          static_cast<float>(w[k] / total);
    }
    wt.bounds[2 * xx] = xmin;
    wt.bounds[2 * xx + 1] = taps;
  }
  return wt;
}

// Horizontal then vertical resample, uint8 in → float32 out (0..255).
void resize_image(const unsigned char* src, int in_w, int in_h,
                  float* dst, int out_w, int out_h) {
  WeightTable wx = build_weights(in_w, out_w);
  WeightTable wy = build_weights(in_h, out_h);

  std::vector<float> tmp(static_cast<size_t>(in_h) * out_w * 3);
  for (int y = 0; y < in_h; ++y) {
    const unsigned char* srow = src + static_cast<size_t>(y) * in_w * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const int xmin = wx.bounds[2 * x];
      const int taps = wx.bounds[2 * x + 1];
      const float* w = &wx.weights[static_cast<size_t>(x) * wx.max_taps];
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int k = 0; k < taps; ++k) {
        const unsigned char* p = srow + static_cast<size_t>(xmin + k) * 3;
        acc0 += w[k] * p[0];
        acc1 += w[k] * p[1];
        acc2 += w[k] * p[2];
      }
      trow[3 * x] = acc0;
      trow[3 * x + 1] = acc1;
      trow[3 * x + 2] = acc2;
    }
  }
  for (int y = 0; y < out_h; ++y) {
    const int ymin = wy.bounds[2 * y];
    const int taps = wy.bounds[2 * y + 1];
    const float* w = &wy.weights[static_cast<size_t>(y) * wy.max_taps];
    float* drow = dst + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w * 3; ++x) {
      float acc = 0;
      for (int k = 0; k < taps; ++k) {
        acc += w[k] * tmp[static_cast<size_t>(ymin + k) * out_w * 3 + x];
      }
      drow[x] = acc;
    }
  }
}

// Shorter-side resize dims. Python round() is banker's rounding — use
// nearbyint (FE_TONEAREST) so resize dims and crop offsets match the
// PIL/torchvision pipeline.
void resize_dims(int w, int h, int resize_short, int& rw, int& rh) {
  if (w <= h) {
    rw = resize_short;
    rh = std::max(1, static_cast<int>(std::nearbyint(
             static_cast<double>(h) * resize_short / w)));
  } else {
    rh = resize_short;
    rw = std::max(1, static_cast<int>(std::nearbyint(
             static_cast<double>(w) * resize_short / h)));
  }
}

bool process_one(const char* path, int resize_short, int crop,
                 const float* mean, const float* stdv, bool hflip,
                 bool fast_dct, float* out) {
  std::vector<unsigned char> pixels;
  int w = 0, h = 0;
  if (!decode_image(path, resize_short, fast_dct, pixels, w, h) || w < 1 || h < 1) {
    memset(out, 0, static_cast<size_t>(crop) * crop * 3 * sizeof(float));
    return false;
  }

  int rw, rh;
  resize_dims(w, h, resize_short, rw, rh);
  const bool identity = (rw == w && rh == h);
  std::vector<float> resized;
  if (!identity) {
    // The triangle filter at scale 1 reduces to weights (1, 0): an
    // already-at-size image passes through the resampler bit-exactly,
    // so skipping it on the identity path changes nothing but time.
    resized.resize(static_cast<size_t>(rw) * rh * 3);
    resize_image(pixels.data(), w, h, resized.data(), rw, rh);
  }

  // center crop + normalize (+ optional horizontal flip)
  const int left = static_cast<int>(std::nearbyint((rw - crop) / 2.0));
  const int top = static_cast<int>(std::nearbyint((rh - crop) / 2.0));
  const float inv255 = 1.0f / 255.0f;
  for (int y = 0; y < crop; ++y) {
    const int sy = std::min(std::max(top + y, 0), rh - 1);
    float* drow = out + static_cast<size_t>(y) * crop * 3;
    const float* frow =
        identity ? nullptr : resized.data() + static_cast<size_t>(sy) * rw * 3;
    const unsigned char* urow =
        identity ? pixels.data() + static_cast<size_t>(sy) * rw * 3 : nullptr;
    for (int x = 0; x < crop; ++x) {
      const int sx0 = hflip ? (crop - 1 - x) : x;
      const int sx = std::min(std::max(left + sx0, 0), rw - 1);
      for (int c = 0; c < 3; ++c) {
        const float raw = identity
            ? static_cast<float>(urow[static_cast<size_t>(sx) * 3 + c])
            : frow[static_cast<size_t>(sx) * 3 + c];
        float v = std::min(std::max(raw, 0.0f), 255.0f) * inv255;
        drow[3 * x + c] = (v - mean[c]) / stdv[c];
      }
    }
  }
  return true;
}

// uint8 output variant: decode → resize → crop → round, with no float
// normalize pass and a 4x smaller output buffer: the uint8_transfer feed,
// normalised on the device.
bool process_one_u8(const char* path, int resize_short, int crop, bool hflip,
                    bool fast_dct, unsigned char* out) {
  std::vector<unsigned char> pixels;
  int w = 0, h = 0;
  if (!decode_image(path, resize_short, fast_dct, pixels, w, h) || w < 1 || h < 1) {
    memset(out, 0, static_cast<size_t>(crop) * crop * 3);
    return false;
  }

  int rw, rh;
  resize_dims(w, h, resize_short, rw, rh);
  const bool identity = (rw == w && rh == h);
  std::vector<float> resized;
  if (!identity) {
    resized.resize(static_cast<size_t>(rw) * rh * 3);
    resize_image(pixels.data(), w, h, resized.data(), rw, rh);
  }

  const int left = static_cast<int>(std::nearbyint((rw - crop) / 2.0));
  const int top = static_cast<int>(std::nearbyint((rh - crop) / 2.0));
  for (int y = 0; y < crop; ++y) {
    const int sy = std::min(std::max(top + y, 0), rh - 1);
    unsigned char* drow = out + static_cast<size_t>(y) * crop * 3;
    if (identity) {
      const unsigned char* srow = pixels.data() + static_cast<size_t>(sy) * rw * 3;
      if (!hflip && left >= 0 && left + crop <= rw) {
        memcpy(drow, srow + static_cast<size_t>(left) * 3,
               static_cast<size_t>(crop) * 3);
        continue;
      }
      for (int x = 0; x < crop; ++x) {
        const int sx0 = hflip ? (crop - 1 - x) : x;
        const int sx = std::min(std::max(left + sx0, 0), rw - 1);
        memcpy(drow + 3 * x, srow + static_cast<size_t>(sx) * 3, 3);
      }
      continue;
    }
    const float* srow = resized.data() + static_cast<size_t>(sy) * rw * 3;
    for (int x = 0; x < crop; ++x) {
      const int sx0 = hflip ? (crop - 1 - x) : x;
      const int sx = std::min(std::max(left + sx0, 0), rw - 1);
      const float* p = srow + static_cast<size_t>(sx) * 3;
      for (int c = 0; c < 3; ++c) {
        // nearbyint under FE_TONEAREST == np.rint (half to even).
        drow[3 * x + c] = static_cast<unsigned char>(
            std::nearbyint(std::min(std::max(p[c], 0.0f), 255.0f)));
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Decode a batch of JPEG/PNG files into a (n, crop, crop, 3) float32 NHWC buffer.
// hflip: optional per-image flip flags (len n) or nullptr.
// Returns the number of images that failed to decode (zero-filled).
int decode_resize_batch(const char** paths, int n, int resize_short, int crop,
                        const float* mean, const float* stdv,
                        const unsigned char* hflip, int fast_dct,
                        float* out, int n_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  const size_t stride = static_cast<size_t>(crop) * crop * 3;

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      if (!process_one(paths[i], resize_short, crop, mean, stdv,
                       hflip != nullptr && hflip[i] != 0, fast_dct != 0,
                       out + stride * i))
        failures.fetch_add(1);
    }
  };

  int threads = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failures.load();
}

// Decode a batch of JPEG/PNG files into a (n, crop, crop, 3) uint8 NHWC buffer
// (the uint8_transfer feed — normalization happens on device).
// Returns the number of images that failed to decode (zero-filled).
int decode_resize_batch_u8(const char** paths, int n, int resize_short,
                           int crop, const unsigned char* hflip, int fast_dct,
                           unsigned char* out, int n_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  const size_t stride = static_cast<size_t>(crop) * crop * 3;

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      if (!process_one_u8(paths[i], resize_short, crop,
                          hflip != nullptr && hflip[i] != 0, fast_dct != 0,
                          out + stride * i))
        failures.fetch_add(1);
    }
  };

  int threads = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failures.load();
}

}  // extern "C"
