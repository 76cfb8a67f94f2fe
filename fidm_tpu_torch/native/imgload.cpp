// Native image decode + resize for the data path.
//
// The port's own copy of fidm_tpu/native/imgload.cpp (same C ABI). Replaces
// the PIL decode->convert->resize pipeline of the dataset loaders
// (Image.open.convert("RGB").resize(BILINEAR)) with a C++ implementation on libjpeg +
// libpng, with a Pillow-compatible resampler:
//
//  - JPEG: libjpeg decompress straight to RGB (or grayscale for masks).
//  - PNG: libpng with palette/gray/16-bit/alpha normalization to RGB8.
//  - Resize: Pillow's antialiased triangle-filter resampling in the same
//    fixed-point arithmetic (PRECISION_BITS=22, uint8 intermediate between
//    the horizontal and vertical passes), so outputs are bit-identical to
//    Image.resize(size, Image.BILINEAR) given identical decoded pixels.
//  - L conversion uses Pillow's ITU-R 601-2 integer coefficients
//    ((R*19595 + G*38470 + B*7471 + 0x8000) >> 16), applied before resize,
//    matching Image.convert("L").resize(...).
//
// A thread-pooled batch entry point fills a uint8 [N, size, size, C] buffer
// in parallel. All functions return 0 on success; the Python side falls back
// to PIL per item on failure.

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------------------
// Pillow-compatible resampling (triangle/bilinear filter, fixed point).
// ---------------------------------------------------------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;

// Decompression-bomb guard: a crafted header can declare enormous
// dimensions; under Linux overcommit the multi-GB malloc can "succeed" and
// the decoder then OOMs the process while writing rows. Cap at Pillow's
// default MAX_IMAGE_PIXELS (89,478,485) so anything we reject falls back to
// PIL, which applies its own bomb policy (warn <=2x, error beyond).
constexpr uint64_t kMaxPixels = 89478485ull;

static inline bool dims_ok(uint64_t w, uint64_t h) {
  return w > 0 && h > 0 && w * h <= kMaxPixels;
}

static inline uint8_t clip8(int in) {
  int v = in >> kPrecisionBits;
  if (v < 0) return 0;
  if (v > 255) return 255;
  return static_cast<uint8_t>(v);
}

static inline double triangle_filter(double x) {
  if (x < 0.0) x = -x;
  return (x < 1.0) ? 1.0 - x : 0.0;
}

// Per-output-pixel contribution window + normalized fixed-point weights.
struct Coeffs {
  std::vector<int> bounds_min;   // first source index per output pixel
  std::vector<int> bounds_size;  // window length per output pixel
  std::vector<int> kk;           // ksize weights per output pixel, fixed point
  int ksize = 0;
};

static Coeffs precompute_coeffs(int in_size, int out_size) {
  Coeffs c;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;  // bilinear filter support == 1
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.ksize = ksize;
  c.bounds_min.resize(out_size);
  c.bounds_size.resize(out_size);
  c.kk.assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> w(ksize);
  double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double wsum = 0.0;
    for (int x = 0; x < xmax; ++x) {
      double ww = triangle_filter((x + xmin - center + 0.5) * ss);
      w[x] = ww;
      wsum += ww;
    }
    for (int x = 0; x < xmax; ++x) {
      if (wsum != 0.0) w[x] /= wsum;
      c.kk[static_cast<size_t>(xx) * ksize + x] = static_cast<int>(
          std::round(w[x] * (1 << kPrecisionBits)));
    }
    c.bounds_min[xx] = xmin;
    c.bounds_size[xx] = xmax;
  }
  return c;
}

// Horizontal then vertical pass, uint8 intermediate — Pillow's exact order
// and arithmetic for 8-bit images.
static void resample_u8(const uint8_t* src, int in_h, int in_w, int channels,
                        int out_h, int out_w, uint8_t* dst) {
  Coeffs ch = precompute_coeffs(in_w, out_w);
  Coeffs cv = precompute_coeffs(in_h, out_h);
  std::vector<uint8_t> tmp(static_cast<size_t>(in_h) * out_w * channels);
  const int half = 1 << (kPrecisionBits - 1);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * in_w * channels;
    uint8_t* trow = tmp.data() + static_cast<size_t>(y) * out_w * channels;
    for (int xx = 0; xx < out_w; ++xx) {
      int xmin = ch.bounds_min[xx];
      int xsz = ch.bounds_size[xx];
      const int* k = &ch.kk[static_cast<size_t>(xx) * ch.ksize];
      for (int b = 0; b < channels; ++b) {
        int acc = half;
        for (int x = 0; x < xsz; ++x)
          acc += row[(xmin + x) * channels + b] * k[x];
        trow[xx * channels + b] = clip8(acc);
      }
    }
  }
  for (int yy = 0; yy < out_h; ++yy) {
    int ymin = cv.bounds_min[yy];
    int ysz = cv.bounds_size[yy];
    const int* k = &cv.kk[static_cast<size_t>(yy) * cv.ksize];
    uint8_t* drow = dst + static_cast<size_t>(yy) * out_w * channels;
    for (int xx = 0; xx < out_w; ++xx) {
      for (int b = 0; b < channels; ++b) {
        int acc = half;
        for (int y = 0; y < ysz; ++y)
          acc += tmp[(static_cast<size_t>(ymin + y) * out_w + xx) * channels +
                     b] *
                 k[y];
        drow[xx * channels + b] = clip8(acc);
      }
    }
  }
}

// Pillow convert("L"): ITU-R 601-2 integer luma.
static void rgb_to_l(const uint8_t* rgb, size_t npix, uint8_t* out) {
  for (size_t i = 0; i < npix; ++i) {
    const uint8_t* p = rgb + i * 3;
    out[i] = static_cast<uint8_t>(
        (p[0] * 19595u + p[1] * 38470u + p[2] * 7471u + 0x8000u) >> 16);
  }
}

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg) -> RGB8.
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Returns malloc'd RGB8 buffer (caller frees) or nullptr.
static uint8_t* decode_jpeg(FILE* f, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  // volatile: modified between setjmp and longjmp and read in the handler
  // (non-volatile would be indeterminate there — C11 7.13.2.1).
  uint8_t* volatile buf = nullptr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    free(buf);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  if (!dims_ok(cinfo.image_width, cinfo.image_height)) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;  // zero-dim or decompression bomb: PIL fallback decides
  }
  cinfo.out_color_space = JCS_RGB;  // libjpeg converts gray/YCbCr -> RGB
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;  // CMYK etc.: let PIL handle it
  }
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  size_t stride = static_cast<size_t>(*w) * 3;
  buf = static_cast<uint8_t*>(malloc(stride * *h));
  if (!buf) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = buf + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  // libjpeg "recovers" from truncated/corrupt streams by gray-filling and
  // only WARNING ("Premature end of JPEG file"); Pillow raises on those
  // files. Treat any warning as failure so the PIL fallback owns the
  // behavior — silent gray-filled training images are worse than an error.
  bool corrupt = jerr.mgr.num_warnings > 0;
  jpeg_destroy_decompress(&cinfo);
  if (corrupt) {
    free(buf);
    return nullptr;
  }
  return buf;
}

// ---------------------------------------------------------------------------
// PNG decode (libpng) -> RGB8.
// ---------------------------------------------------------------------------

static uint8_t* decode_png(FILE* f, int* w, int* h) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return nullptr;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return nullptr;
  }
  // volatile: modified between setjmp and longjmp and read in the handler.
  uint8_t* volatile buf = nullptr;
  std::vector<png_bytep>* volatile rowsp = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    free(buf);
    delete rowsp;
    return nullptr;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  if (!dims_ok(width, height)) {
    png_destroy_read_struct(&png, &info, nullptr);
    return nullptr;  // zero-dim or decompression bomb: PIL fallback decides
  }
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  // Normalize everything to 8-bit RGB, alpha dropped (Pillow convert("RGB")
  // discards alpha without compositing).
  if (depth == 16) {
    // Pillow opens 16-bit PNGs as mode "I"/"I;16" and convert("L"/"RGB")
    // CLAMPS values > 255 — not the same as stripping the high byte. Bail
    // out so the PIL fallback keeps behavior identical across hosts.
    png_destroy_read_struct(&png, &info, nullptr);
    return nullptr;
  }
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_set_interlace_handling(png);
  png_read_update_info(png, info);
  if (png_get_channels(png, info) != 3 || png_get_bit_depth(png, info) != 8) {
    png_destroy_read_struct(&png, &info, nullptr);
    return nullptr;
  }
  size_t stride = static_cast<size_t>(width) * 3;
  buf = static_cast<uint8_t*>(malloc(stride * height));
  if (!buf) {
    png_destroy_read_struct(&png, &info, nullptr);
    return nullptr;
  }
  rowsp = new std::vector<png_bytep>(height);
  for (png_uint_32 y = 0; y < height; ++y) (*rowsp)[y] = buf + stride * y;
  png_read_image(png, rowsp->data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  delete rowsp;
  *w = static_cast<int>(width);
  *h = static_cast<int>(height);
  return buf;
}

// Decode any supported file to RGB8 (malloc'd); sniffs the magic bytes.
static uint8_t* decode_file(const char* path, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  unsigned char magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);
  uint8_t* buf = nullptr;
  if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    buf = decode_png(f, w, h);
  } else if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    buf = decode_jpeg(f, w, h);
  }
  fclose(f);
  return buf;
}

// Full pipeline for one image: decode -> (optional L) -> resize -> out.
// mode 3 = RGB (out size*size*3), mode 1 = grayscale (out size*size).
static int load_one(const char* path, int size, int mode, uint8_t* out) {
  // a negative size would turn into a huge size_t in the resampler's
  // vector::resize and throw across the C ABI (process-terminating)
  if (size <= 0 || (mode != 1 && mode != 3)) return 2;
  int w = 0, h = 0;
  uint8_t* rgb = decode_file(path, &w, &h);
  if (!rgb) return 1;
  int channels = 3;
  uint8_t* src = rgb;
  std::vector<uint8_t> gray;
  if (mode == 1) {
    gray.resize(static_cast<size_t>(w) * h);
    rgb_to_l(rgb, static_cast<size_t>(w) * h, gray.data());
    src = gray.data();
    channels = 1;
  } else if (mode != 3) {
    free(rgb);
    return 2;
  }
  if (w == size && h == size) {
    memcpy(out, src, static_cast<size_t>(size) * size * channels);
  } else {
    resample_u8(src, h, w, channels, size, size, out);
  }
  free(rgb);
  return 0;
}

}  // namespace

extern "C" {

// Decode + resize one image. Returns 0 on success.
int fidm_load_image(const char* path, int size, int mode, uint8_t* out) {
  return load_one(path, size, mode, out);
}

// Batch: fills out[N, size, size, mode] from paths, ok[i]=1 per success.
// Returns the number of failures. nthreads<=0 uses the hardware count.
int fidm_load_batch(const char* const* paths, int n, int size, int mode,
                    uint8_t* out, uint8_t* ok, int nthreads) {
  if (n <= 0) return 0;
  if (size <= 0 || (mode != 1 && mode != 3)) {
    for (int i = 0; i < n; ++i) ok[i] = 0;
    return n;
  }
  size_t item = static_cast<size_t>(size) * size * mode;
  if (nthreads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    nthreads = hw ? static_cast<int>(hw) : 1;
  }
  if (nthreads > n) nthreads = n;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc = load_one(paths[i], size, mode, out + item * i);
      ok[i] = rc == 0 ? 1 : 0;
      if (rc != 0) failures.fetch_add(1);
    }
  };
  if (nthreads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return failures.load();
}

}  // extern "C"
