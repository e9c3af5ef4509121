// Native image-pipeline core: JPEG/PNG decode + Pillow-exact convolution
// resampling, exposed as a tiny C ABI consumed via ctypes.
//
// This is the TPU-native equivalent of the native half of the reference's
// input pipeline: the reference leans on torch's C++ DataLoader workers and
// PIL's C decoders (trainers/vision_benchmark/evaluation/feature.py:74-96
// seeds those workers; Dassl's DatasetWrapper at mvlpt.py:661-720 composes
// decode + torchvision transforms). Here the Python DataLoader keeps the
// scheduling/determinism contract (data/loader.py) and delegates the two
// heavy per-image ops — entropy decode and filtered resampling — to this
// library; ctypes releases the GIL for the duration of each call, so the
// existing thread pool scales across cores.
//
// Resampling reimplements Pillow's public algorithm (separable convolution,
// 8-bit fixed point with PRECISION_BITS = 22, horizontal-then-vertical with
// a cropped intermediate) so the native backend is bit-identical with the
// PIL backend — asserted by tests/test_native_pipe.py. Anything the fast
// path does not cover bit-exactly (CMYK JPEG, palette/alpha/16-bit/
// interlaced PNG, other containers) returns MVLPT_UNSUPPORTED and the
// Python wrapper falls back to PIL for that image.
//
// Build: g++ -O3 -fPIC -shared -std=c++17 imagepipe.cpp -ljpeg -lpng
// (driven by mvlpt_tpu/native/__init__.py, cached by source hash).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <csetjmp>
#include <cstdio>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" {

enum {
  MVLPT_OK = 0,
  MVLPT_UNSUPPORTED = 1,  // valid image, but not on the bit-exact fast path
  MVLPT_CORRUPT = 2,      // decoder error
  MVLPT_BADARGS = 3,
};

enum { MVLPT_FMT_UNKNOWN = 0, MVLPT_FMT_JPEG = 1, MVLPT_FMT_PNG = 2 };

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

static void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

static void err_silent(j_common_ptr cinfo, int msg_level) {
  // keep libjpeg's warning count (msg_level -1 = corrupt-data warning)
  // without printing; decode checks num_warnings and reports CORRUPT so
  // truncated-but-recoverable files go to PIL, which raises loudly like
  // the python backend does
  if (msg_level < 0) cinfo->err->num_warnings++;
}
static void err_silent_msg(j_common_ptr) {}

static int jpeg_supported_space(J_COLOR_SPACE cs) {
  // Grayscale and YCbCr/RGB decode to RGB identically to PIL (same
  // libjpeg-turbo code path). CMYK/YCCK need PIL's own inversion logic.
  return cs == JCS_GRAYSCALE || cs == JCS_YCbCr || cs == JCS_RGB;
}

static int probe_jpeg(const uint8_t* data, int64_t len, int32_t* w,
                      int32_t* h) {
  jpeg_decompress_struct ci;
  ErrMgr err;
  ci.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = err_exit;
  err.pub.emit_message = err_silent;
  err.pub.output_message = err_silent_msg;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&ci);
    return MVLPT_CORRUPT;
  }
  jpeg_create_decompress(&ci);
  jpeg_mem_src(&ci, data, static_cast<unsigned long>(len));
  jpeg_read_header(&ci, TRUE);
  *w = static_cast<int32_t>(ci.image_width);
  *h = static_cast<int32_t>(ci.image_height);
  int rc = jpeg_supported_space(ci.jpeg_color_space) ? MVLPT_OK
                                                     : MVLPT_UNSUPPORTED;
  jpeg_destroy_decompress(&ci);
  return rc;
}

static int decode_jpeg(const uint8_t* data, int64_t len, uint8_t* out,
                       int32_t out_w, int32_t out_h) {
  jpeg_decompress_struct ci;
  ErrMgr err;
  ci.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = err_exit;
  err.pub.emit_message = err_silent;
  err.pub.output_message = err_silent_msg;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&ci);
    return MVLPT_CORRUPT;
  }
  jpeg_create_decompress(&ci);
  jpeg_mem_src(&ci, data, static_cast<unsigned long>(len));
  jpeg_read_header(&ci, TRUE);
  if (!jpeg_supported_space(ci.jpeg_color_space)) {
    jpeg_destroy_decompress(&ci);
    return MVLPT_UNSUPPORTED;
  }
  // PIL decodes with libjpeg defaults: JDCT_ISLOW + fancy upsampling, so
  // leaving the defaults in place is what makes the output bit-identical.
  ci.out_color_space = JCS_RGB;
  jpeg_start_decompress(&ci);
  if (static_cast<int32_t>(ci.output_width) != out_w ||
      static_cast<int32_t>(ci.output_height) != out_h ||
      ci.output_components != 3) {
    jpeg_abort_decompress(&ci);
    jpeg_destroy_decompress(&ci);
    return MVLPT_BADARGS;
  }
  const size_t stride = static_cast<size_t>(out_w) * 3;
  while (ci.output_scanline < ci.output_height) {
    JSAMPROW row = out + stride * ci.output_scanline;
    jpeg_read_scanlines(&ci, &row, 1);
  }
  jpeg_finish_decompress(&ci);
  bool corrupt = ci.err->num_warnings != 0;
  jpeg_destroy_decompress(&ci);
  return corrupt ? MVLPT_CORRUPT : MVLPT_OK;
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

static uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// Fast path: 8-bit gray / 8-bit RGB, non-interlaced, no tRNS.
// Everything else goes to PIL: convert("RGB") drops alpha rather than
// compositing (which the libpng transforms don't match), and PIL opens
// 1-bit PNGs as mode "1", which its resize() forces to NEAREST — so
// sub-8-bit depths are not bit-reproducible on this path either.
static int probe_png(const uint8_t* data, int64_t len, int32_t* w,
                     int32_t* h) {
  if (len < 33 || std::memcmp(data + 12, "IHDR", 4) != 0)
    return MVLPT_CORRUPT;
  *w = static_cast<int32_t>(be32(data + 16));
  *h = static_cast<int32_t>(be32(data + 20));
  int bit_depth = data[24], color_type = data[25], interlace = data[28];
  if (interlace != 0) return MVLPT_UNSUPPORTED;
  if (bit_depth != 8 || (color_type != 0 && color_type != 2))
    return MVLPT_UNSUPPORTED;  // palette / alpha / 16-bit / sub-byte
  // scan chunks for tRNS before IDAT
  int64_t pos = 8;
  while (pos + 8 <= len) {
    uint32_t clen = be32(data + pos);
    const uint8_t* ctype = data + pos + 4;
    if (std::memcmp(ctype, "IDAT", 4) == 0) break;
    if (std::memcmp(ctype, "tRNS", 4) == 0) return MVLPT_UNSUPPORTED;
    pos += 8 + static_cast<int64_t>(clen) + 4;
  }
  return MVLPT_OK;
}

struct PngReadState {
  const uint8_t* data;
  int64_t len;
  int64_t pos;
};

static void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + static_cast<int64_t>(n) > s->len)
    png_error(png, "read past end");
  std::memcpy(out, s->data + s->pos, n);
  s->pos += static_cast<int64_t>(n);
}

static void png_silent_warn(png_structp, png_const_charp) {}

static int decode_png(const uint8_t* data, int64_t len, uint8_t* out,
                      int32_t out_w, int32_t out_h) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, png_silent_warn);
  if (!png) return MVLPT_CORRUPT;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return MVLPT_CORRUPT;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return MVLPT_CORRUPT;
  }
  PngReadState state{data, len, 0};
  png_set_read_fn(png, &state, png_mem_read);
  png_read_info(png, info);
  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  if (static_cast<int32_t>(w) != out_w || static_cast<int32_t>(h) != out_h) {
    png_destroy_read_struct(&png, &info, nullptr);
    return MVLPT_BADARGS;
  }
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth == 8) {
    png_set_gray_to_rgb(png);
  } else if (color_type != PNG_COLOR_TYPE_RGB || bit_depth != 8) {
    png_destroy_read_struct(&png, &info, nullptr);
    return MVLPT_UNSUPPORTED;  // probe rejects these already
  }
  png_read_update_info(png, info);
  if (png_get_rowbytes(png, info) != static_cast<size_t>(out_w) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return MVLPT_UNSUPPORTED;
  }
  const size_t stride = static_cast<size_t>(out_w) * 3;
  for (png_uint_32 y = 0; y < h; y++)
    png_read_row(png, out + stride * y, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return MVLPT_OK;
}

// ---------------------------------------------------------------------------
// Probe / decode entry points
// ---------------------------------------------------------------------------

static int sniff(const uint8_t* data, int64_t len) {
  if (len >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF)
    return MVLPT_FMT_JPEG;
  static const uint8_t png_sig[8] = {0x89, 'P', 'N', 'G', 0x0D, 0x0A, 0x1A,
                                     0x0A};
  if (len >= 8 && std::memcmp(data, png_sig, 8) == 0) return MVLPT_FMT_PNG;
  return MVLPT_FMT_UNKNOWN;
}

// Returns MVLPT_OK when the fast path can decode this image bit-exactly;
// fills (w, h, fmt) whenever the header parses.
int mvlpt_probe(const uint8_t* data, int64_t len, int32_t* w, int32_t* h,
                int32_t* fmt) {
  *w = *h = 0;
  *fmt = sniff(data, len);
  switch (*fmt) {
    case MVLPT_FMT_JPEG:
      return probe_jpeg(data, len, w, h);
    case MVLPT_FMT_PNG:
      return probe_png(data, len, w, h);
    default:
      return MVLPT_UNSUPPORTED;
  }
}

// out must hold w*h*3 bytes (w, h from mvlpt_probe).
int mvlpt_decode(const uint8_t* data, int64_t len, uint8_t* out, int32_t w,
                 int32_t h) {
  switch (sniff(data, len)) {
    case MVLPT_FMT_JPEG:
      return decode_jpeg(data, len, out, w, h);
    case MVLPT_FMT_PNG:
      return decode_png(data, len, out, w, h);
    default:
      return MVLPT_UNSUPPORTED;
  }
}

// DCT-domain scaled decode (JPEG only): decodes at scale num/8 directly
// from the frequency coefficients — roughly (num/8)^2 the IDCT +
// upsampling work of a full decode. Output dims are what libjpeg computes
// (jpeg_calc_output_dimensions: ceil(dim * num / 8)); query them first
// with mvlpt_jpeg_scaled_dims. Used by the opt-in
// DATALOADER.NATIVE_FAST_JPEG path — NOT bit-identical to a full decode
// + resample, by construction.
int mvlpt_jpeg_scaled_dims(const uint8_t* data, int64_t len, int32_t num,
                           int32_t* w, int32_t* h) {
  if (num < 1 || num > 8) return MVLPT_BADARGS;
  jpeg_decompress_struct ci;
  ErrMgr err;
  ci.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = err_exit;
  err.pub.emit_message = err_silent;
  err.pub.output_message = err_silent_msg;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&ci);
    return MVLPT_CORRUPT;
  }
  jpeg_create_decompress(&ci);
  jpeg_mem_src(&ci, data, static_cast<unsigned long>(len));
  jpeg_read_header(&ci, TRUE);
  int rc = jpeg_supported_space(ci.jpeg_color_space) ? MVLPT_OK
                                                     : MVLPT_UNSUPPORTED;
  ci.scale_num = static_cast<unsigned>(num);
  ci.scale_denom = 8;
  jpeg_calc_output_dimensions(&ci);
  *w = static_cast<int32_t>(ci.output_width);
  *h = static_cast<int32_t>(ci.output_height);
  jpeg_destroy_decompress(&ci);
  return rc;
}

int mvlpt_decode_jpeg_scaled(const uint8_t* data, int64_t len, int32_t num,
                             uint8_t* out, int32_t out_w, int32_t out_h) {
  if (num < 1 || num > 8) return MVLPT_BADARGS;
  jpeg_decompress_struct ci;
  ErrMgr err;
  ci.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = err_exit;
  err.pub.emit_message = err_silent;
  err.pub.output_message = err_silent_msg;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&ci);
    return MVLPT_CORRUPT;
  }
  jpeg_create_decompress(&ci);
  jpeg_mem_src(&ci, data, static_cast<unsigned long>(len));
  jpeg_read_header(&ci, TRUE);
  if (!jpeg_supported_space(ci.jpeg_color_space)) {
    jpeg_destroy_decompress(&ci);
    return MVLPT_UNSUPPORTED;
  }
  ci.out_color_space = JCS_RGB;
  ci.scale_num = static_cast<unsigned>(num);
  ci.scale_denom = 8;
  jpeg_start_decompress(&ci);
  if (static_cast<int32_t>(ci.output_width) != out_w ||
      static_cast<int32_t>(ci.output_height) != out_h ||
      ci.output_components != 3) {
    jpeg_abort_decompress(&ci);
    jpeg_destroy_decompress(&ci);
    return MVLPT_BADARGS;
  }
  const size_t stride = static_cast<size_t>(out_w) * 3;
  while (ci.output_scanline < ci.output_height) {
    JSAMPROW row = out + stride * ci.output_scanline;
    jpeg_read_scanlines(&ci, &row, 1);
  }
  jpeg_finish_decompress(&ci);
  bool corrupt = ci.err->num_warnings != 0;
  jpeg_destroy_decompress(&ci);
  return corrupt ? MVLPT_CORRUPT : MVLPT_OK;
}

// ---------------------------------------------------------------------------
// Pillow-exact separable convolution resampling (8 bits per channel).
//
// The algorithm is Pillow's documented two-pass scheme: per output pixel a
// normalized filter window over input pixels, coefficients quantized to
// 22-bit fixed point, horizontal pass into an 8-bit intermediate restricted
// to the rows the vertical pass will read, then the vertical pass. Keeping
// the same quantization and the same 8-bit intermediate is what makes the
// result bit-identical with PIL.Image.resize(..., box=...).
// ---------------------------------------------------------------------------

static const int kPrecisionBits = 32 - 8 - 2;

static double filter_bicubic(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

static double filter_bilinear(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

static double filter_lanczos(double x) {
  auto sinc = [](double v) {
    if (v == 0.0) return 1.0;
    v *= M_PI;
    return std::sin(v) / v;
  };
  if (x < 0.0) x = -x;
  return x < 3.0 ? sinc(x) * sinc(x / 3.0) : 0.0;
}

struct Filter {
  double (*fn)(double);
  double support;
};

static bool pick_filter(int id, Filter* f) {
  switch (id) {
    case 0: *f = {filter_bilinear, 1.0}; return true;
    case 1: *f = {filter_bicubic, 2.0}; return true;
    case 2: *f = {filter_lanczos, 3.0}; return true;
    default: return false;
  }
}

static int precompute_coeffs(int in_size, double in0, double in1,
                             int out_size, const Filter& flt,
                             std::vector<int>& bounds,
                             std::vector<int32_t>& kk, int* ksize_out) {
  double scale = (in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = flt.support * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  std::vector<double> prekk(static_cast<size_t>(out_size) * ksize);
  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  for (int xx = 0; xx < out_size; xx++) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &prekk[static_cast<size_t>(xx) * ksize];
    int x = 0;
    for (; x < xmax; x++) {
      double w = flt.fn((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; x++)
      if (ww != 0.0) k[x] /= ww;
    for (; x < ksize; x++) k[x] = 0.0;
    bounds[static_cast<size_t>(xx) * 2 + 0] = xmin;
    bounds[static_cast<size_t>(xx) * 2 + 1] = xmax;
  }
  kk.resize(prekk.size());
  for (size_t i = 0; i < prekk.size(); i++) {
    double v = prekk[i] * (1 << kPrecisionBits);
    kk[i] = static_cast<int32_t>(v < 0 ? v - 0.5 : v + 0.5);
  }
  *ksize_out = ksize;
  return MVLPT_OK;
}

static inline uint8_t clip8(int in) {
  if (in >= (1 << (kPrecisionBits + 8))) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

static void resample_horizontal(uint8_t* out, int out_w, int out_h,
                                const uint8_t* in, int in_w, int row_offset,
                                int ksize, const std::vector<int>& bounds,
                                const std::vector<int32_t>& kk) {
  for (int yy = 0; yy < out_h; yy++) {
    const uint8_t* irow =
        in + static_cast<size_t>(yy + row_offset) * in_w * 3;
    uint8_t* orow = out + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w; xx++) {
      int xmin = bounds[static_cast<size_t>(xx) * 2 + 0];
      int xmax = bounds[static_cast<size_t>(xx) * 2 + 1];
      const int32_t* k = &kk[static_cast<size_t>(xx) * ksize];
      int s0 = 1 << (kPrecisionBits - 1);
      int s1 = s0, s2 = s0;
      const uint8_t* p = irow + static_cast<size_t>(xmin) * 3;
      for (int x = 0; x < xmax; x++) {
        s0 += p[0] * k[x];
        s1 += p[1] * k[x];
        s2 += p[2] * k[x];
        p += 3;
      }
      orow[xx * 3 + 0] = clip8(s0);
      orow[xx * 3 + 1] = clip8(s1);
      orow[xx * 3 + 2] = clip8(s2);
    }
  }
}

static void resample_vertical(uint8_t* out, int out_w, int out_h,
                              const uint8_t* in, int ksize,
                              const std::vector<int>& bounds,
                              const std::vector<int32_t>& kk) {
  for (int yy = 0; yy < out_h; yy++) {
    int ymin = bounds[static_cast<size_t>(yy) * 2 + 0];
    int ymax = bounds[static_cast<size_t>(yy) * 2 + 1];
    const int32_t* k = &kk[static_cast<size_t>(yy) * ksize];
    uint8_t* orow = out + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w * 3; xx++) {
      int ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; y++)
        ss += in[static_cast<size_t>(ymin + y) * out_w * 3 + xx] * k[y];
      orow[xx] = clip8(ss);
    }
  }
}

// in: (in_h, in_w, 3) uint8; out: (out_h, out_w, 3) uint8.
// Box (bx0, by0, bx1, by1) in input pixel coordinates, may be fractional —
// same contract as PIL.Image.resize(size, resample, box).
int mvlpt_resample(const uint8_t* in, int32_t in_w, int32_t in_h, double bx0,
                   double by0, double bx1, double by1, int32_t out_w,
                   int32_t out_h, int32_t filter_id, uint8_t* out) {
  Filter flt;
  if (!pick_filter(filter_id, &flt)) return MVLPT_BADARGS;
  if (out_w <= 0 || out_h <= 0 || in_w <= 0 || in_h <= 0)
    return MVLPT_BADARGS;
  if (bx0 < 0 || by0 < 0 || bx1 > in_w || by1 > in_h || bx1 <= bx0 ||
      by1 <= by0)
    return MVLPT_BADARGS;

  bool need_h = out_w != in_w || bx0 != 0.0 || bx1 != out_w;
  bool need_v = out_h != in_h || by0 != 0.0 || by1 != out_h;

  if (!need_h && !need_v) {
    std::memcpy(out, in, static_cast<size_t>(in_w) * in_h * 3);
    return MVLPT_OK;
  }

  // Each coefficient table only when its pass runs (as Pillow does) —
  // a single-axis resize in the hot loader path skips the other's
  // O(out * ksize) table build.
  std::vector<int> bounds_h, bounds_v;
  std::vector<int32_t> kk_h, kk_v;
  int ksize_h = 0, ksize_v = 0;
  if (need_h)
    precompute_coeffs(in_w, bx0, bx1, out_w, flt, bounds_h, kk_h, &ksize_h);
  if (need_v)
    precompute_coeffs(in_h, by0, by1, out_h, flt, bounds_v, kk_v, &ksize_v);

  if (need_h && need_v) {
    // Restrict the horizontal pass to the rows the vertical pass reads,
    // then rebase the vertical bounds onto the intermediate image.
    int ybox_first = bounds_v[0];
    int ybox_last = bounds_v[static_cast<size_t>(out_h) * 2 - 2] +
                    bounds_v[static_cast<size_t>(out_h) * 2 - 1];
    for (int i = 0; i < out_h; i++)
      bounds_v[static_cast<size_t>(i) * 2] -= ybox_first;
    int tmp_h = ybox_last - ybox_first;
    std::vector<uint8_t> tmp(static_cast<size_t>(out_w) * tmp_h * 3);
    resample_horizontal(tmp.data(), out_w, tmp_h, in, in_w, ybox_first,
                        ksize_h, bounds_h, kk_h);
    resample_vertical(out, out_w, out_h, tmp.data(), ksize_v, bounds_v,
                      kk_v);
  } else if (need_h) {
    resample_horizontal(out, out_w, out_h, in, in_w, 0, ksize_h, bounds_h,
                        kk_h);
  } else {
    // vertical only: input already has out_w columns
    resample_vertical(out, out_w, out_h, in, ksize_v, bounds_v, kk_v);
  }
  return MVLPT_OK;
}

int mvlpt_abi_version(void) { return 1; }

}  // extern "C"
