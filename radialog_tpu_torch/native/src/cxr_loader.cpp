// cxr_loader: multithreaded chest-X-ray decode + preprocess pipeline (the
// port's copy of radialog_tpu/native/src/cxr_loader.cpp; the arithmetic and
// the shuffle are the same, so both packages give the same crops and, with
// one worker thread, the same order for a seed).
//
// A pool of worker threads decodes JPEGs (libjpeg) and applies the
// preprocessing contract
//   min/max remap -> uint8 -> PIL-BILINEAR resize (adaptive triangle
//   filter, short side; see triangle_coeffs below) -> center crop
//   -> float32 [0,1] -> replicate to 3 channels (NHWC)
// (or, in the uint8 mode, the single-channel uint8 crop), and feeds
// fixed-shape batches through a bounded queue off the Python thread.
// Samples enter the queue as workers finish them, so with more than one
// thread the order within an epoch follows the shuffle only up to timing.
//
// C ABI (ctypes-consumed by radialog_tpu_torch/native/loader.py):
//   cxr_loader_create(paths, n, batch, resize, crop, threads, shuffle, seed,
//                     emit_u8)
//   cxr_loader_next(handle, out_images, out_indices) -> filled count
//   cxr_loader_next_u8(handle, out_u8, out_indices) -> filled count
//   cxr_loader_reset(handle, seed)   // new epoch (reshuffles)
//   cxr_loader_destroy(handle)
//   cxr_preprocess_file(path, resize, crop, out) -> 0 on success
//   cxr_preprocess_file_u8(path, resize, crop, out) -> 0 on success
#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <stdexcept>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Gray {
  int h = 0, w = 0;
  std::vector<uint8_t> px;
};

// libjpeg decode to 8-bit grayscale.
bool decode_jpeg_gray(const std::string& path, Gray* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jerr.error_exit = [](j_common_ptr c) { throw std::runtime_error("jpeg"); };
  bool ok = false;
  try {
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_GRAYSCALE;
    jpeg_start_decompress(&cinfo);
    out->h = cinfo.output_height;
    out->w = cinfo.output_width;
    out->px.resize(size_t(out->h) * out->w);
    while (cinfo.output_scanline < cinfo.output_height) {
      JSAMPROW row = out->px.data() + size_t(cinfo.output_scanline) * out->w;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    ok = true;
  } catch (...) {
    ok = false;
  }
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return ok;
}

// min/max remap in place (ReportDataset.py remap_to_uint8 contract).
void remap_minmax(Gray* g) {
  uint8_t lo = 255, hi = 0;
  for (uint8_t v : g->px) {
    lo = std::min(lo, v);
    hi = std::max(hi, v);
  }
  if (hi <= lo) return;
  const float scale = 255.0f / float(hi - lo);
  for (auto& v : g->px) v = uint8_t(float(v - lo) * scale + 0.5f);
}

// Separable triangle-filter resample, matching PIL's BILINEAR semantics:
// when downscaling, the filter support scales with the ratio (antialiasing),
// which plain 2-tap bilinear lacks. Coefficients per output position over
// [center - support, center + support), triangle weight, normalized.
struct ResampleCoeffs {
  std::vector<int> start;      // first input index per output pixel
  std::vector<int> count;      // taps per output pixel
  std::vector<float> weights;  // flattened, max_taps stride
  int max_taps = 0;
};

ResampleCoeffs triangle_coeffs(int in_size, int out_size) {
  ResampleCoeffs c;
  const double scale = double(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;  // bilinear support = 1
  c.max_taps = int(std::ceil(support)) * 2 + 1;
  c.start.resize(out_size);
  c.count.resize(out_size);
  c.weights.assign(size_t(out_size) * c.max_taps, 0.0f);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = std::max(int(center - support + 0.5), 0);
    int hi = std::min(int(center + support + 0.5), in_size);
    c.start[i] = lo;
    c.count[i] = hi - lo;
    double total = 0.0;
    for (int j = lo; j < hi; ++j) {
      double x = (j - center + 0.5) / filterscale;
      double w = x < 0 ? 1.0 + x : 1.0 - x;  // triangle
      if (w < 0) w = 0;
      c.weights[size_t(i) * c.max_taps + (j - lo)] = float(w);
      total += w;
    }
    if (total > 0)
      for (int t = 0; t < c.count[i]; ++t)
        c.weights[size_t(i) * c.max_taps + t] /= float(total);
  }
  return c;
}

// resize so the SHORT side == target (torchvision Resize(int) over PIL).
void resize_short(const Gray& in, int target, Gray* out) {
  int nh, nw;
  if (in.h <= in.w) {
    nh = target;
    nw = std::max(1, int(std::lround(double(in.w) * target / in.h)));
  } else {
    nw = target;
    nh = std::max(1, int(std::lround(double(in.h) * target / in.w)));
  }
  // horizontal pass (keep float intermediates, as PIL does)
  ResampleCoeffs cx = triangle_coeffs(in.w, nw);
  std::vector<float> tmp(size_t(in.h) * nw);
  for (int y = 0; y < in.h; ++y) {
    const uint8_t* row = in.px.data() + size_t(y) * in.w;
    for (int x = 0; x < nw; ++x) {
      const float* w = cx.weights.data() + size_t(x) * cx.max_taps;
      float acc = 0.0f;
      for (int t = 0; t < cx.count[x]; ++t) acc += row[cx.start[x] + t] * w[t];
      tmp[size_t(y) * nw + x] = acc;
    }
  }
  // vertical pass
  ResampleCoeffs cy = triangle_coeffs(in.h, nh);
  out->h = nh;
  out->w = nw;
  out->px.resize(size_t(nh) * nw);
  for (int y = 0; y < nh; ++y) {
    const float* w = cy.weights.data() + size_t(y) * cy.max_taps;
    for (int x = 0; x < nw; ++x) {
      float acc = 0.0f;
      for (int t = 0; t < cy.count[y]; ++t)
        acc += tmp[size_t(cy.start[y] + t) * nw + x] * w[t];
      out->px[size_t(y) * nw + x] =
          uint8_t(std::clamp(acc + 0.5f, 0.0f, 255.0f));
    }
  }
}

// center crop + [0,1] float + 3-channel replicate into out (crop,crop,3).
void crop_norm(const Gray& g, int crop, float* out) {
  const int top = std::max((g.h - crop) / 2, 0);
  const int left = std::max((g.w - crop) / 2, 0);
  for (int y = 0; y < crop; ++y) {
    const int sy = std::min(top + y, g.h - 1);
    for (int x = 0; x < crop; ++x) {
      const int sx = std::min(left + x, g.w - 1);
      const float v = g.px[size_t(sy) * g.w + sx] / 255.0f;
      float* o = out + (size_t(y) * crop + x) * 3;
      o[0] = v;
      o[1] = v;
      o[2] = v;
    }
  }
}

bool preprocess_file(const std::string& path, int resize, int crop, float* out) {
  Gray raw, small;
  if (!decode_jpeg_gray(path, &raw)) return false;
  remap_minmax(&raw);
  resize_short(raw, resize, &small);
  crop_norm(small, crop, out);
  return true;
}

// center crop, SINGLE-channel uint8 (the exact PIL intermediate — resize_short
// already rounded back to uint8 like PIL BILINEAR on mode-L images). The /255
// normalize + 3-channel replicate move to the device: u8/255 there is
// bit-identical to crop_norm's floats, and the host->device payload shrinks
// 12x (crop^2 u8 vs crop^2*3 f32).
void crop_u8(const Gray& g, int crop, uint8_t* out) {
  const int top = std::max((g.h - crop) / 2, 0);
  const int left = std::max((g.w - crop) / 2, 0);
  for (int y = 0; y < crop; ++y) {
    const int sy = std::min(top + y, g.h - 1);
    for (int x = 0; x < crop; ++x) {
      const int sx = std::min(left + x, g.w - 1);
      out[size_t(y) * crop + x] = g.px[size_t(sy) * g.w + sx];
    }
  }
}

bool preprocess_file_u8(const std::string& path, int resize, int crop,
                        uint8_t* out) {
  Gray raw, small;
  if (!decode_jpeg_gray(path, &raw)) return false;
  remap_minmax(&raw);
  resize_short(raw, resize, &small);
  crop_u8(small, crop, out);
  return true;
}

struct Sample {
  int index = -1;                // index into the path list; -1 = failed
  uint64_t gen = 0;              // epoch generation (stale results discarded)
  std::vector<float> img;        // emit_u8=false: (crop,crop,3) f32 [0,1]
  std::vector<uint8_t> img8;     // emit_u8=true:  (crop,crop) u8
};

class Loader {
 public:
  Loader(std::vector<std::string> paths, int batch, int resize, int crop,
         int threads, bool shuffle, uint64_t seed, bool emit_u8)
      : paths_(std::move(paths)), batch_(batch), resize_(resize), crop_(crop),
        shuffle_(shuffle), emit_u8_(emit_u8),
        queue_cap_(std::max(2 * batch, 16)) {
    order_.resize(paths_.size());
    for (size_t i = 0; i < order_.size(); ++i) order_[i] = int(i);
    reset(seed);
    const int n_threads = std::max(1, threads);
    for (int t = 0; t < n_threads; ++t)
      workers_.emplace_back([this] { work(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_space_.notify_all();
    cv_item_.notify_all();
    for (auto& t : workers_) t.join();
  }

  void reset(uint64_t seed) {
    std::lock_guard<std::mutex> lk(mu_);
    if (shuffle_) {
      std::mt19937_64 rng(seed);
      std::shuffle(order_.begin(), order_.end(), rng);
    }
    ++gen_;  // in-flight results from the previous epoch become stale
    next_task_ = 0;
    emitted_ = 0;
    while (!ready_.empty()) ready_.pop();
    cv_space_.notify_all();
  }

  // Fill up to batch_ samples. Returns count (0 = epoch exhausted;
  // -2 = loader constructed in the other emit mode).
  int next(float* out_images, int* out_indices) {
    if (emit_u8_) return -2;
    const size_t stride = size_t(crop_) * crop_ * 3;
    int filled = 0;
    std::unique_lock<std::mutex> lk(mu_);
    while (filled < batch_) {
      if (emitted_ >= order_.size() && ready_.empty()) break;
      cv_item_.wait(lk, [this] {
        return stop_ || !ready_.empty() ||
               (emitted_ >= order_.size() && ready_.empty());
      });
      if (stop_) break;
      if (ready_.empty()) break;
      Sample s = std::move(ready_.front());
      ready_.pop();
      cv_space_.notify_one();
      if (s.gen != gen_) continue;  // stale (pre-reset) result
      ++emitted_;
      if (s.index < 0) continue;  // decode failure: skip
      std::memcpy(out_images + size_t(filled) * stride, s.img.data(),
                  stride * sizeof(float));
      out_indices[filled] = s.index;
      ++filled;
    }
    return filled;
  }

  int next_u8(uint8_t* out_images, int* out_indices) {
    if (!emit_u8_) return -2;
    const size_t stride = size_t(crop_) * crop_;
    int filled = 0;
    std::unique_lock<std::mutex> lk(mu_);
    while (filled < batch_) {
      if (emitted_ >= order_.size() && ready_.empty()) break;
      cv_item_.wait(lk, [this] {
        return stop_ || !ready_.empty() ||
               (emitted_ >= order_.size() && ready_.empty());
      });
      if (stop_) break;
      if (ready_.empty()) break;
      Sample s = std::move(ready_.front());
      ready_.pop();
      cv_space_.notify_one();
      if (s.gen != gen_) continue;
      ++emitted_;
      if (s.index < 0) continue;
      std::memcpy(out_images + size_t(filled) * stride, s.img8.data(),
                  stride);
      out_indices[filled] = s.index;
      ++filled;
    }
    return filled;
  }

 private:
  void work() {
    const size_t stride = size_t(crop_) * crop_ * 3;
    for (;;) {
      size_t task;
      uint64_t my_gen;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [this] {
          return stop_ || (next_task_ < order_.size() &&
                           ready_.size() < size_t(queue_cap_));
        });
        if (stop_) return;
        if (next_task_ >= order_.size()) continue;
        task = next_task_++;
        my_gen = gen_;
      }
      Sample s;
      s.gen = my_gen;
      s.index = order_[task];
      if (emit_u8_) {
        s.img8.resize(size_t(crop_) * crop_);
        if (!preprocess_file_u8(paths_[s.index], resize_, crop_,
                                s.img8.data()))
          s.index = -1;
      } else {
        s.img.resize(stride);
        if (!preprocess_file(paths_[s.index], resize_, crop_, s.img.data()))
          s.index = -1;
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        ready_.push(std::move(s));
      }
      cv_item_.notify_one();
    }
  }

  std::vector<std::string> paths_;
  std::vector<int> order_;
  const int batch_, resize_, crop_;
  const bool shuffle_;
  const bool emit_u8_;
  const int queue_cap_;

  std::mutex mu_;
  std::condition_variable cv_item_, cv_space_;
  std::queue<Sample> ready_;
  uint64_t gen_ = 0;
  size_t next_task_ = 0;
  size_t emitted_ = 0;
  bool stop_ = false;
  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

void* cxr_loader_create(const char** paths, int n, int batch, int resize,
                        int crop, int threads, int shuffle, uint64_t seed,
                        int emit_u8) {
  std::vector<std::string> p(paths, paths + n);
  return new Loader(std::move(p), batch, resize, crop, threads, shuffle != 0,
                    seed, emit_u8 != 0);
}

int cxr_loader_next(void* h, float* out_images, int* out_indices) {
  return static_cast<Loader*>(h)->next(out_images, out_indices);
}

int cxr_loader_next_u8(void* h, unsigned char* out_images, int* out_indices) {
  return static_cast<Loader*>(h)->next_u8(out_images, out_indices);
}

int cxr_preprocess_file_u8(const char* path, int resize, int crop,
                           unsigned char* out) {
  return preprocess_file_u8(path, resize, crop, out) ? 0 : 1;
}

void cxr_loader_reset(void* h, uint64_t seed) {
  static_cast<Loader*>(h)->reset(seed);
}

void cxr_loader_destroy(void* h) { delete static_cast<Loader*>(h); }

int cxr_preprocess_file(const char* path, int resize, int crop, float* out) {
  return preprocess_file(path, resize, crop, out) ? 0 : 1;
}

}  // extern "C"
