// Host image IO: libpng decoding and a prefetching sequence reader.
//
// This package's copy of the reference's imageio.cpp. The reference's C++
// examples read frames synchronously with cv::imread in the tracking loop
// (reference Examples/Monocular/mono_tum.cc:73-83). Here decoding runs in a
// pool of worker threads that stay ahead of the consumer, so the host never
// stalls the device on IO.
//
// Exposed (C ABI, consumed via ctypes in utils/imageio.py, which builds this
// file with g++ at first use):
//   png_read_gray8   - decode any PNG to 8-bit grayscale
//   png_read_u16     - decode a 16-bit grayscale PNG (TUM depth maps)
//   prefetch_create / prefetch_next / prefetch_destroy - ordered
//       multi-threaded prefetcher over a path list.
//
// utils/imageio.py holds a numpy decoder that gives the same bytes; what it
// copies from here is the colour-to-grey rule (png_set_rgb_to_gray_fixed
// with 29900 / 58700) and the order of libpng's transforms.

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  std::vector<uint8_t> bytes;  // gray8 or u16 (little-endian), row-major
  int w = 0, h = 0;
  int channels_bits = 8;
  bool ok = false;
};

bool read_png(const char* path, bool want16, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  int w = png_get_image_width(png, info);
  int h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);

  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (want16) {
    // normalize any input to single-channel 16-bit gray
    if (bit_depth < 16) png_set_expand_16(png);
    if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
        color == PNG_COLOR_TYPE_PALETTE)
      png_set_rgb_to_gray_fixed(png, 1, 29900, 58700);
    // libpng stores big-endian -> swap to host LE
    png_set_swap(png);
  } else {
    if (bit_depth == 16) png_set_strip_16(png);
    if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
        color == PNG_COLOR_TYPE_PALETTE)
      // ITU-R BT.601 luma, the same weighting cv::cvtColor uses
      png_set_rgb_to_gray_fixed(png, 1, 29900, 58700);
  }
  png_read_update_info(png, info);
  // The compaction below assumes exactly one gray channel at the requested
  // depth; refuse anything the transform chain did not normalize.
  if (png_get_channels(png, info) != 1 ||
      png_get_bit_depth(png, info) != (want16 ? 16 : 8)) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }

  size_t rowbytes = png_get_rowbytes(png, info);
  out->w = w;
  out->h = h;
  out->channels_bits = want16 ? 16 : 8;
  out->bytes.resize(rowbytes * h);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; y++) rows[y] = out->bytes.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  // if rowbytes > w * bytes_per_px (shouldn't happen after transforms for
  // gray), compact
  size_t bpp = want16 ? 2 : 1;
  if (rowbytes != static_cast<size_t>(w) * bpp) {
    std::vector<uint8_t> tight(static_cast<size_t>(w) * bpp * h);
    for (int y = 0; y < h; y++)
      std::memcpy(tight.data() + static_cast<size_t>(y) * w * bpp,
                  out->bytes.data() + static_cast<size_t>(y) * rowbytes,
                  w * bpp);
    out->bytes.swap(tight);
  }
  out->ok = true;
  return true;
}

struct Prefetcher {
  std::vector<std::string> paths;
  bool want16 = false;
  size_t ahead = 8;

  std::vector<Image> slots;        // one per frame index
  std::vector<uint8_t> ready;      // 0 = pending, 1 = done
  std::atomic<size_t> next_job{0};
  size_t next_out = 0;             // consumer cursor
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      if (stop.load()) return;
      size_t j = next_job.fetch_add(1);
      if (j >= paths.size()) return;
      // throttle: stay at most `ahead` frames in front of the consumer
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop.load() || j < next_out + ahead; });
        if (stop.load()) return;
      }
      Image im;
      read_png(paths[j].c_str(), want16, &im);
      {
        std::lock_guard<std::mutex> lk(mu);
        slots[j] = std::move(im);
        ready[j] = 1;
      }
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Decode to gray8. Returns 0 on success; fills w/h; writes at most max_bytes.
int png_read_gray8(const char* path, uint8_t* out, int* w, int* h,
                   long max_bytes) {
  Image im;
  if (!read_png(path, false, &im)) return -1;
  long need = static_cast<long>(im.w) * im.h;
  if (need > max_bytes) return -2;
  std::memcpy(out, im.bytes.data(), need);
  *w = im.w;
  *h = im.h;
  return 0;
}

// Decode a 16-bit PNG (depth). Returns 0 on success.
int png_read_u16(const char* path, uint16_t* out, int* w, int* h,
                 long max_elems) {
  Image im;
  if (!read_png(path, true, &im)) return -1;
  long need = static_cast<long>(im.w) * im.h;
  if (need > max_elems) return -2;
  std::memcpy(out, im.bytes.data(), need * 2);
  *w = im.w;
  *h = im.h;
  return 0;
}

// paths: n zero-terminated strings concatenated.
void* prefetch_create(const char* paths_concat, int n, int n_threads,
                      int want16, int ahead) {
  auto* p = new Prefetcher();
  const char* cur = paths_concat;
  for (int i = 0; i < n; i++) {
    p->paths.emplace_back(cur);
    cur += p->paths.back().size() + 1;
  }
  p->want16 = want16 != 0;
  p->ahead = ahead > 0 ? ahead : 8;
  p->slots.resize(n);
  p->ready.assign(n, 0);
  int nt = n_threads > 0 ? n_threads : 2;
  for (int t = 0; t < nt; t++)
    p->workers.emplace_back([p] { p->worker(); });
  return p;
}

// Blocks until frame `idx` is decoded; returns 0 ok, -1 decode error,
// -2 buffer too small.
int prefetch_next(void* handle, uint8_t* out, int* w, int* h,
                  long max_bytes) {
  auto* p = static_cast<Prefetcher*>(handle);
  size_t idx;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    idx = p->next_out;
    if (idx >= p->paths.size()) return -3;
    p->cv.wait(lk, [&] { return p->ready[idx] != 0; });
  }
  Image& im = p->slots[idx];
  int rc = 0;
  if (!im.ok) {
    rc = -1;
  } else {
    long bpp = p->want16 ? 2 : 1;
    long need = static_cast<long>(im.w) * im.h * bpp;
    if (need > max_bytes) {
      rc = -2;
    } else {
      std::memcpy(out, im.bytes.data(), need);
      *w = im.w;
      *h = im.h;
    }
  }
  {
    std::lock_guard<std::mutex> lk(p->mu);
    im.bytes.clear();
    im.bytes.shrink_to_fit();
    p->next_out = idx + 1;
  }
  p->cv.notify_all();
  return rc;
}

void prefetch_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
