// renderloom_torch native image decoder: the port's copy of the JAX
// package's renderloom/native/decoder.cpp (host C++, not a device kernel).
//
// The HumanSloMo h5 stores frames as variable-length PNG/JPEG byte
// buffers (reference: HumanSloMo_Dataset/lib/gen_dataset_h5.py:54-74,
// decoded per-frame with PIL at
// Pose_Guided_Neural_Rendering/datasets/HSM_auto_dataset.py:127-128).
// An accelerator finishes a renderer G/D step in milliseconds, so
// single-threaded Python decode is the pipeline bottleneck.
// This C++ extension decodes a whole window/batch of buffers in parallel
// with libpng/libjpeg worker threads, writing straight into a caller-owned
// numpy array (no intermediate copies, no GIL).
//
// C ABI only — loaded from Python with ctypes (no pybind11 in the image).

#include <png.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
#include <jpeglib.h>
}

namespace {

constexpr int kOk = 0;
constexpr int kErrFormat = -1;   // unrecognised magic bytes
constexpr int kErrDecode = -2;   // decoder reported failure
constexpr int kErrShape = -3;    // decoded dims != expected dims

bool is_png(const uint8_t* buf, size_t len) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  return len >= 8 && std::memcmp(buf, sig, 8) == 0;
}

bool is_jpeg(const uint8_t* buf, size_t len) {
  return len >= 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF;
}

// ---------------------------------------------------------------- PNG ----

// libpng16's simplified API handles interlacing, palette, bit depth and
// gray->RGB expansion for us and is thread-safe per png_image.
int decode_png(const uint8_t* buf, size_t len, uint8_t* out, int height,
               int width) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, buf, len)) return kErrDecode;
  if ((int)image.width != width || (int)image.height != height) {
    png_image_free(&image);
    return kErrShape;
  }
  image.format = PNG_FORMAT_RGB;
  if (!png_image_finish_read(&image, nullptr, out, width * 3, nullptr)) {
    png_image_free(&image);
    return kErrDecode;
  }
  return kOk;
}

int png_dims(const uint8_t* buf, size_t len, int* w, int* h) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, buf, len)) return kErrDecode;
  *w = (int)image.width;
  *h = (int)image.height;
  png_image_free(&image);
  return kOk;
}

// --------------------------------------------------------------- JPEG ----

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void jpeg_silent(j_common_ptr, int) {}

int decode_jpeg(const uint8_t* buf, size_t len, uint8_t* out, int height,
                int width) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  jerr.mgr.emit_message = jpeg_silent;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return kErrDecode;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if ((int)cinfo.output_width != width || (int)cinfo.output_height != height ||
      cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return kErrShape;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + (size_t)cinfo.output_scanline * width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return kOk;
}

int jpeg_dims(const uint8_t* buf, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  jerr.mgr.emit_message = jpeg_silent;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return kErrDecode;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  *w = (int)cinfo.image_width;
  *h = (int)cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return kOk;
}

int decode_one(const uint8_t* buf, size_t len, uint8_t* out, int height,
               int width) {
  if (is_png(buf, len)) return decode_png(buf, len, out, height, width);
  if (is_jpeg(buf, len)) return decode_jpeg(buf, len, out, height, width);
  return kErrFormat;
}

}  // namespace

extern "C" {

// Peek width/height without a full decode. Returns kOk or an error code.
int rl_image_dims(const uint8_t* buf, size_t len, int* width, int* height) {
  if (is_png(buf, len)) return png_dims(buf, len, width, height);
  if (is_jpeg(buf, len)) return jpeg_dims(buf, len, width, height);
  return kErrFormat;
}

// Decode `n` PNG/JPEG buffers into a caller-owned (n, height, width, 3)
// uint8 RGB array, fanning the images out over `threads` workers.
// Every image must decode to exactly (height, width). Returns kOk, or the
// first failing image's error code packed as (index * 16 + |code|) negated
// (so callers can report which frame was bad).
int rl_decode_batch(const uint8_t** bufs, const size_t* lens, int n,
                    uint8_t* out, int height, int width, int threads) {
  if (n <= 0) return kOk;
  const size_t stride = (size_t)height * width * 3;
  if (threads < 1) threads = 1;
  if (threads > n) threads = n;

  std::atomic<int> next(0);
  std::atomic<int> failure(0);  // 0 = ok; else packed error
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failure.load(std::memory_order_relaxed)) return;
      int rc = decode_one(bufs[i], lens[i], out + stride * i, height, width);
      if (rc != kOk) failure.store(i * 16 + (-rc), std::memory_order_relaxed);
    }
  };

  if (threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  int f = failure.load();
  return f == 0 ? kOk : -f;
}

}  // extern "C"
