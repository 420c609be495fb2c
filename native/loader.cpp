// Native asynchronous stereo-frame loader.
//
// The reference loads images on the hot path with cv::imread per frame
// (main.cpp:160-162), stalling tracking on disk + PNG decode.  This library
// is the accelerator-side replacement: a C++ thread pool decodes left/right PNG
// (or JPEG) pairs to float32 grayscale ahead of the consumer into a bounded
// ring of buffers, so the Python/JAX side only ever memcpy's a ready frame.
//
// C ABI (ctypes-friendly, no C++ types across the boundary):
//   ssvo_decode_gray(path, out, H, W)          -- one-shot decode + resize-check
//   ssvo_loader_create(paths_l, paths_r, n, depth, H, W, workers)
//   ssvo_loader_next(handle, out_l, out_r)     -- blocking, in sequence order
//   ssvo_loader_destroy(handle)
//
// Build: make -C native   (produces native/libssvo_loader.so)

#include <png.h>
#include <jpeglib.h>

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// decoding
// ---------------------------------------------------------------------------

// Decode an 8-bit PNG to grayscale float32 [0,255], row-major (H, W).
// Returns 0 on success. Output must hold H*W floats; images smaller than
// (H, W) are zero-padded, larger ones are cropped.
int decode_png_gray(const char* path, float* out, int H, int W) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return 2;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 3;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  int channels = png_get_channels(png, info);
  std::vector<png_byte> row(png_get_rowbytes(png, info));

  std::memset(out, 0, sizeof(float) * H * W);
  const png_uint_32 copy_h = h < (png_uint_32)H ? h : (png_uint_32)H;
  const png_uint_32 copy_w = w < (png_uint_32)W ? w : (png_uint_32)W;
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    if (y >= copy_h) continue;
    float* dst = out + (size_t)y * W;
    if (channels == 1) {
      for (png_uint_32 x = 0; x < copy_w; ++x) dst[x] = (float)row[x];
    } else {  // RGB(A already stripped): BT.601 luma, same as cv::cvtColor
      for (png_uint_32 x = 0; x < copy_w; ++x) {
        const png_byte* p = row.data() + (size_t)x * channels;
        dst[x] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
      }
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

int decode_jpeg_gray(const char* path, float* out, int H, int W) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return 2;
  }
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  std::vector<unsigned char> row(cinfo.output_width);
  std::memset(out, 0, sizeof(float) * H * W);
  unsigned copy_w = cinfo.output_width < (unsigned)W ? cinfo.output_width : (unsigned)W;
  for (unsigned y = 0; y < cinfo.output_height; ++y) {
    unsigned char* rp = row.data();
    jpeg_read_scanlines(&cinfo, &rp, 1);
    if (y >= (unsigned)H) continue;
    float* dst = out + (size_t)y * W;
    for (unsigned x = 0; x < copy_w; ++x) dst[x] = (float)row[x];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  return 0;
}

int decode_gray(const char* path, float* out, int H, int W) {
  const char* dot = std::strrchr(path, '.');
  if (dot && (!std::strcmp(dot, ".jpg") || !std::strcmp(dot, ".jpeg"))) {
    return decode_jpeg_gray(path, out, H, W);
  }
  return decode_png_gray(path, out, H, W);
}

// ---------------------------------------------------------------------------
// prefetching loader
// ---------------------------------------------------------------------------

struct Frame {
  std::vector<float> left, right;
  int status = 0;
};

struct Loader {
  std::vector<std::string> left_paths, right_paths;
  int H = 0, W = 0, depth = 0;
  std::atomic<int> next_to_decode{0};
  int next_to_emit = 0;
  std::map<int, Frame> ready;          // decoded, waiting for in-order emit
  std::mutex mu;
  std::condition_variable cv_ready;    // consumer waits for next_to_emit
  std::condition_variable cv_space;    // workers wait for queue space
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    while (!stop.load()) {
      int idx = next_to_decode.fetch_add(1);
      if (idx >= (int)left_paths.size()) return;
      Frame f;
      f.left.resize((size_t)H * W);
      f.right.resize((size_t)H * W);
      f.status = decode_gray(left_paths[idx].c_str(), f.left.data(), H, W);
      if (f.status == 0)
        f.status = decode_gray(right_paths[idx].c_str(), f.right.data(), H, W);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() || (int)ready.size() < depth || idx < next_to_emit + depth;
      });
      if (stop.load()) return;
      ready.emplace(idx, std::move(f));
      cv_ready.notify_all();
    }
  }

  int next(float* out_l, float* out_r) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_to_emit >= (int)left_paths.size()) return -1;  // exhausted
    int want = next_to_emit;
    cv_ready.wait(lk, [&] { return stop.load() || ready.count(want); });
    if (stop.load()) return -2;
    Frame f = std::move(ready[want]);
    ready.erase(want);
    next_to_emit++;
    cv_space.notify_all();
    lk.unlock();
    std::memcpy(out_l, f.left.data(), sizeof(float) * H * W);
    std::memcpy(out_r, f.right.data(), sizeof(float) * H * W);
    return f.status;
  }
};

}  // namespace

extern "C" {

int ssvo_decode_gray(const char* path, float* out, int H, int W) {
  return decode_gray(path, out, H, W);
}

void* ssvo_loader_create(const char** left_paths, const char** right_paths,
                         int n, int depth, int H, int W, int workers) {
  auto* L = new Loader();
  L->left_paths.assign(left_paths, left_paths + n);
  L->right_paths.assign(right_paths, right_paths + n);
  L->H = H;
  L->W = W;
  L->depth = depth > 0 ? depth : 4;
  int nw = workers > 0 ? workers : 2;
  for (int i = 0; i < nw; ++i) L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Returns decode status (0 ok, >0 decode error, -1 sequence exhausted).
int ssvo_loader_next(void* handle, float* out_l, float* out_r) {
  return static_cast<Loader*>(handle)->next(out_l, out_r);
}

void ssvo_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_ready.notify_all();
  L->cv_space.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
