// Native image decode for the host input pipeline (counterpart of
// convnets_tpu/native/imgcodec.cpp, copied: the port imports and builds
// nothing of the JAX package).
//
// The reference decodes with torchvision/PIL inside 16 worker processes
// (reference mngrdata.py:158-163). On the host that feeds the card, every
// image of an ImageFolder split is decoded on the CPU in an epoch that does
// not hit the decode cache, so the per-image cost of decode is part of the
// step's host time. This translation unit is the native (C++) decode path:
// PNG via libpng, JPEG via libjpeg, decode fused with an optional bilinear
// resize straight into the caller's buffer: no intermediate Python objects,
// and the GIL released for the whole call (ctypes drops it around foreign
// calls), so decode threads run in parallel.
//
// C ABI (consumed by convnets_tpu_torch/native/__init__.py via ctypes):
//   cn_decode_file(path, out, out_h, out_w) -> 0 on success
//     out must hold out_h*out_w*3 bytes; when (out_h,out_w) differs from the
//     source size the image is resized with Pillow's BILINEAR semantics —
//     separable triangle filter whose support scales with the downscale
//     factor (antialiased shrink), plain bilinear for upscale.
//   cn_image_size(path, &h, &w) -> 0 on success (header-only probe)

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <cstdint>
#include <vector>

#include <png.h>
extern "C" {
#include <jpeglib.h>
}

namespace {

// ---------------------------------------------------------------- PNG ----

struct PngReadCtx {
  FILE* f = nullptr;
  png_structp png = nullptr;
  png_infop info = nullptr;
  ~PngReadCtx() {
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    if (f) fclose(f);
  }
};

// Decode a PNG to tightly-packed RGB8. Returns true on success.
bool decode_png(const char* path, std::vector<uint8_t>& rgb, int& h, int& w) {
  PngReadCtx c;
  c.f = fopen(path, "rb");
  if (!c.f) return false;
  uint8_t sig[8];
  if (fread(sig, 1, 8, c.f) != 8 || png_sig_cmp(sig, 0, 8)) return false;

  c.png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!c.png) return false;
  c.info = png_create_info_struct(c.png);
  if (!c.info) return false;
  if (setjmp(png_jmpbuf(c.png))) return false;  // libpng error trampoline

  png_init_io(c.png, c.f);
  png_set_sig_bytes(c.png, 8);
  png_read_info(c.png, c.info);

  // normalize every PNG color layout to 8-bit RGB
  png_byte color = png_get_color_type(c.png, c.info);
  png_byte depth = png_get_bit_depth(c.png, c.info);
  if (depth == 16) png_set_strip_16(c.png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(c.png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(c.png);
  if (png_get_valid(c.png, c.info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(c.png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(c.png);
  // drop alpha (ImageFolder convert("RGB") semantics: composite on black is
  // NOT what PIL does — PIL just drops the channel, so do the same)
  if (color & PNG_COLOR_MASK_ALPHA || png_get_valid(c.png, c.info, PNG_INFO_tRNS))
    png_set_strip_alpha(c.png);
  png_read_update_info(c.png, c.info);

  h = static_cast<int>(png_get_image_height(c.png, c.info));
  w = static_cast<int>(png_get_image_width(c.png, c.info));
  size_t rowbytes = png_get_rowbytes(c.png, c.info);
  if (rowbytes != static_cast<size_t>(w) * 3) return false;

  rgb.resize(static_cast<size_t>(h) * w * 3);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = rgb.data() + static_cast<size_t>(y) * w * 3;
  png_read_image(c.png, rows.data());
  return true;
}

// --------------------------------------------------------------- JPEG ----

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

bool decode_jpeg(const char* path, std::vector<uint8_t>& rgb, int& h, int& w) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  h = static_cast<int>(cinfo.output_height);
  w = static_cast<int>(cinfo.output_width);
  rgb.resize(static_cast<size_t>(h) * w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// ------------------------------------------------------------- resize ----

// PIL-compatible separable bilinear (triangle) resize. For downscale the
// filter support scales with the scale factor (antialiasing), exactly as
// Pillow's Resample.c does for Image.BILINEAR — a fixed 2×2-tap bilinear
// would alias badly when shrinking. Coefficient tables are precomputed per
// output index; intermediate rows stay in float (Pillow quantizes the
// horizontal pass to uint8, so outputs can differ by ~1 LSB).
struct ResizeCoeffs {
  std::vector<int> first;      // window start per output index
  std::vector<int> count;      // window length per output index
  std::vector<double> weights; // out_size × ksize, normalized
  int ksize = 0;
};

void compute_coeffs(int in_size, int out_size, ResizeCoeffs& c) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // triangle filter support
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.ksize = ksize;
  c.first.resize(out_size);
  c.count.resize(out_size);
  c.weights.assign(static_cast<size_t>(out_size) * ksize, 0.0);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &c.weights[static_cast<size_t>(i) * ksize];
    double total = 0.0;
    for (int j = 0; j < xmax; ++j) {
      double w = 1.0 - std::fabs((j + xmin - center + 0.5) / filterscale);
      if (w < 0) w = 0;
      k[j] = w;
      total += w;
    }
    if (total > 0)
      for (int j = 0; j < xmax; ++j) k[j] /= total;
    c.first[i] = xmin;
    c.count[i] = xmax;
  }
}

void resize_bilinear(const uint8_t* src, int sh, int sw,
                     uint8_t* dst, int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
    return;
  }
  ResizeCoeffs cx, cy;
  compute_coeffs(sw, dw, cx);
  compute_coeffs(sh, dh, cy);

  // horizontal pass: (sh, sw) -> (sh, dw), float intermediate
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
    float* out = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const double* k = &cx.weights[static_cast<size_t>(x) * cx.ksize];
      const int first = cx.first[x], count = cx.count[x];
      double acc0 = 0, acc1 = 0, acc2 = 0;
      for (int j = 0; j < count; ++j) {
        const uint8_t* p = row + static_cast<size_t>(first + j) * 3;
        acc0 += k[j] * p[0];
        acc1 += k[j] * p[1];
        acc2 += k[j] * p[2];
      }
      out[x * 3 + 0] = static_cast<float>(acc0);
      out[x * 3 + 1] = static_cast<float>(acc1);
      out[x * 3 + 2] = static_cast<float>(acc2);
    }
  }

  // vertical pass: (sh, dw) -> (dh, dw), round+clamp to uint8
  for (int y = 0; y < dh; ++y) {
    const double* k = &cy.weights[static_cast<size_t>(y) * cy.ksize];
    const int first = cy.first[y], count = cy.count[y];
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw * 3; ++x) {
      double acc = 0;
      for (int j = 0; j < count; ++j)
        acc += k[j] * tmp[static_cast<size_t>(first + j) * dw * 3 + x];
      int v = static_cast<int>(acc + 0.5);
      out[x] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

bool has_suffix(const char* s, const char* suf) {
  size_t ls = strlen(s), lf = strlen(suf);
  if (lf > ls) return false;
  for (size_t i = 0; i < lf; ++i) {
    char a = s[ls - lf + i], b = suf[i];
    if (a >= 'A' && a <= 'Z') a += 32;
    if (a != b) return false;
  }
  return true;
}

bool decode_any(const char* path, std::vector<uint8_t>& rgb, int& h, int& w) {
  if (has_suffix(path, ".png")) return decode_png(path, rgb, h, w);
  if (has_suffix(path, ".jpg") || has_suffix(path, ".jpeg"))
    return decode_jpeg(path, rgb, h, w);
  // unknown extension: sniff the signature
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t sig[2] = {0, 0};
  size_t got = fread(sig, 1, 2, f);
  fclose(f);
  if (got == 2 && sig[0] == 0x89 && sig[1] == 'P') return decode_png(path, rgb, h, w);
  if (got == 2 && sig[0] == 0xFF && sig[1] == 0xD8) return decode_jpeg(path, rgb, h, w);
  return false;
}

}  // namespace

extern "C" {

// Decode `path` into out[out_h*out_w*3] (RGB8), resizing if needed. 0 = ok.
int cn_decode_file(const char* path, uint8_t* out, int out_h, int out_w) {
  std::vector<uint8_t> rgb;
  int h = 0, w = 0;
  if (!decode_any(path, rgb, h, w)) return 1;
  if (h <= 0 || w <= 0) return 2;
  resize_bilinear(rgb.data(), h, w, out, out_h, out_w);
  return 0;
}

// Source dimensions from the file header only — NO pixel decode. The
// decode-at-native-size path calls this before cn_decode_file, so a full
// decode here would double the cold-epoch decode cost.
int cn_image_size(const char* path, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  uint8_t sig[8];
  const size_t got = fread(sig, 1, 8, f);

  if (got >= 8 && !png_sig_cmp(sig, 0, 8)) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                             nullptr, nullptr, nullptr);
    png_infop info = png ? png_create_info_struct(png) : nullptr;
    if (!png || !info || setjmp(png_jmpbuf(png))) {
      if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
      fclose(f);
      return 1;
    }
    png_init_io(png, f);
    png_set_sig_bytes(png, 8);
    png_read_info(png, info);
    *h = static_cast<int>(png_get_image_height(png, info));
    *w = static_cast<int>(png_get_image_width(png, info));
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return 0;
  }

  if (got >= 2 && sig[0] == 0xFF && sig[1] == 0xD8) {
    rewind(f);
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
      jpeg_destroy_decompress(&cinfo);
      fclose(f);
      return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    *h = static_cast<int>(cinfo.image_height);
    *w = static_cast<int>(cinfo.image_width);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 0;
  }

  fclose(f);
  return 1;
}

}  // extern "C"
