// Native image decode + threaded prefetch pipeline.
//
// TPU-native equivalent of the reference's host-side IO layer
// (reference: n-lalanne/LDSO src/frontend/ImageRW_OpenCV.cc and the
// per-example ImageFolderReader in examples/run_dso_*.cc, which decode
// frames synchronously on the feed thread with OpenCV/libzip): here a
// pthread worker pool decodes PNG/JPEG frames AHEAD of the tracking
// loop into a bounded in-order buffer, so host decode overlaps device
// compute (the tracker never waits on libpng). Exposed to Python via a
// plain C ABI consumed with ctypes (ldso_tpu/native/__init__.py).
//
// Build: g++ -O3 -march=native -shared -fPIC loader.cc -lpng -ljpeg
//        -pthread -o libldso_native.so

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <csetjmp>
extern "C" {
#include <jpeglib.h>
}

namespace {

struct Gray {
  int w = 0, h = 0;
  std::vector<float> px;  // row-major, [0, 255]
  bool ok = false;
};

// ---------------------------------------------------------------------------
// PNG decode (libpng simplified API; color converted to luma by libpng)
// ---------------------------------------------------------------------------

Gray decode_png(const uint8_t* data, size_t size) {
  Gray g;
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, data, size)) return g;
  const bool sixteen = (image.format & PNG_FORMAT_FLAG_LINEAR) != 0 ||
                       PNG_IMAGE_SAMPLE_COMPONENT_SIZE(image.format) == 2;
  if (sixteen) {
    image.format = PNG_FORMAT_LINEAR_Y;  // 16-bit grayscale
    std::vector<uint16_t> buf(PNG_IMAGE_SIZE(image) / 2);
    if (!png_image_finish_read(&image, nullptr, buf.data(), 0, nullptr)) {
      png_image_free(&image);
      return g;
    }
    g.w = image.width;
    g.h = image.height;
    g.px.resize((size_t)g.w * g.h);
    for (size_t i = 0; i < g.px.size(); ++i) g.px[i] = buf[i] * (255.0f / 65535.0f);
  } else {
    image.format = PNG_FORMAT_GRAY;  // 8-bit; RGB composited to luma
    std::vector<uint8_t> buf(PNG_IMAGE_SIZE(image));
    if (!png_image_finish_read(&image, nullptr, buf.data(), 0, nullptr)) {
      png_image_free(&image);
      return g;
    }
    g.w = image.width;
    g.h = image.height;
    g.px.resize((size_t)g.w * g.h);
    for (size_t i = 0; i < g.px.size(); ++i) g.px[i] = (float)buf[i];
  }
  g.ok = true;
  return g;
}

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg, grayscale output)
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf env;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->env, 1);
}

Gray decode_jpeg(const uint8_t* data, size_t size) {
  Gray g;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.env)) {
    jpeg_destroy_decompress(&cinfo);
    return g;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), size);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  g.w = cinfo.output_width;
  g.h = cinfo.output_height;
  g.px.resize((size_t)g.w * g.h);
  std::vector<uint8_t> row(g.w);
  uint8_t* rp = row.data();
  for (int y = 0; y < g.h; ++y) {
    jpeg_read_scanlines(&cinfo, &rp, 1);
    float* out = g.px.data() + (size_t)y * g.w;
    for (int x = 0; x < g.w; ++x) out[x] = (float)row[x];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  g.ok = true;
  return g;
}

Gray decode_any(const uint8_t* data, size_t size) {
  static const uint8_t png_sig[4] = {0x89, 'P', 'N', 'G'};
  if (size > 4 && std::memcmp(data, png_sig, 4) == 0) return decode_png(data, size);
  if (size > 2 && data[0] == 0xFF && data[1] == 0xD8) return decode_jpeg(data, size);
  return Gray{};
}

Gray decode_file(const std::string& path) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return Gray{};
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(n > 0 ? (size_t)n : 0);
  size_t rd = buf.empty() ? 0 : std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  if (rd != buf.size()) return Gray{};
  return decode_any(buf.data(), buf.size());
}

// ---------------------------------------------------------------------------
// Prefetcher: worker pool decoding frames ahead of the consumer
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  int ahead;
  std::mutex mu;
  std::condition_variable cv_worker, cv_consumer;
  std::map<int, Gray> ready;
  int next_issue = 0;     // next frame index a worker will take
  int consumed = -1;      // highest index handed to the consumer
  bool stop = false;
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      int my;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_worker.wait(lk, [&] {
          return stop || (next_issue < (int)paths.size() &&
                          next_issue <= consumed + ahead);
        });
        if (stop || next_issue >= (int)paths.size()) return;
        my = next_issue++;
      }
      Gray g = decode_file(paths[my]);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.emplace(my, std::move(g));
      }
      cv_consumer.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Decode an in-memory PNG/JPEG to f32 grayscale [0,255].
// Returns 0 and sets *w/*h on success (out must hold out_cap floats,
// out_cap >= w*h); -1 decode failure; -2 buffer too small.
int ldso_decode_gray(const uint8_t* data, long size, float* out, long out_cap,
                     int* w, int* h) {
  Gray g = decode_any(data, (size_t)size);
  if (!g.ok) return -1;
  *w = g.w;
  *h = g.h;
  if ((long)g.px.size() > out_cap) return -2;
  std::memcpy(out, g.px.data(), g.px.size() * sizeof(float));
  return 0;
}

// Probe an image's dimensions without a full pixel copy.
int ldso_probe(const uint8_t* data, long size, int* w, int* h) {
  Gray g = decode_any(data, (size_t)size);
  if (!g.ok) return -1;
  *w = g.w;
  *h = g.h;
  return 0;
}

void* ldso_prefetcher_create(const char** paths, int n, int n_threads,
                             int ahead) {
  auto* pf = new Prefetcher();
  pf->paths.assign(paths, paths + n);
  pf->ahead = ahead > 0 ? ahead : 8;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    pf->workers.emplace_back(&Prefetcher::worker, pf);
  return pf;
}

// Blocking in-order fetch. idx must be non-decreasing across calls.
int ldso_prefetcher_get(void* h_pf, int idx, float* out, long out_cap,
                        int* w, int* h) {
  auto* pf = static_cast<Prefetcher*>(h_pf);
  Gray g;
  {
    std::unique_lock<std::mutex> lk(pf->mu);
    if (idx >= (int)pf->paths.size()) return -3;
    pf->consumed = idx > pf->consumed ? idx : pf->consumed;
    pf->cv_worker.notify_all();
    pf->cv_consumer.wait(lk, [&] { return pf->ready.count(idx) > 0; });
    g = std::move(pf->ready[idx]);
    // evict anything at or before idx — consumption is in-order
    pf->ready.erase(pf->ready.begin(), pf->ready.upper_bound(idx));
  }
  if (!g.ok) return -1;
  *w = g.w;
  *h = g.h;
  if ((long)g.px.size() > out_cap) return -2;
  std::memcpy(out, g.px.data(), g.px.size() * sizeof(float));
  return 0;
}

void ldso_prefetcher_destroy(void* h_pf) {
  auto* pf = static_cast<Prefetcher*>(h_pf);
  {
    std::lock_guard<std::mutex> lk(pf->mu);
    pf->stop = true;
  }
  pf->cv_worker.notify_all();
  for (auto& t : pf->workers) t.join();
  delete pf;
}

}  // extern "C"
