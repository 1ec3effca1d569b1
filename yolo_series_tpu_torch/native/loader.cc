// Native data-loader core: multi-threaded JPEG/PNG decode + letterbox into a
// preallocated NHWC uint8 batch (the port's own copy of the JAX package's
// native/loader.cc; its C interface is the same).
//
// One C call assembles a whole inference or eval batch without per-image
// Python dispatch, with a std::thread pool decoding the images in
// parallel: the host-runtime counterpart of the reference's OpenCV decode
// in torch DataLoader workers (utils/datasets.py:133-210, :959-973).
//
// Letterbox math matches data/augment.py letterbox(auto=False,
// scaleup=scaleup): r = min(size/h, size/w) [capped at 1 when !scaleup],
// centered padding with round(dw +- 0.1) and 114-gray fill.
//
// Built by yolo_series_tpu_torch/data/native.py at first use (g++ -O3
// -shared -fPIC, linking opencv core/imgcodecs/imgproc) into build/native/
// and loaded with ctypes.

#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

#include <atomic>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Meta {
  float ratio;
  float dw, dh;
  int h0, w0;
  int ok;
};

void letterbox_one(const char* path, int img_size, bool scaleup,
                   unsigned char* out, Meta* meta) {
  cv::Mat img = cv::imread(path, cv::IMREAD_COLOR);  // BGR
  if (img.empty()) {
    meta->ok = 0;
    std::memset(out, 114, static_cast<size_t>(img_size) * img_size * 3);
    return;
  }
  const int h0 = img.rows, w0 = img.cols;
  double r = std::min(static_cast<double>(img_size) / h0,
                      static_cast<double>(img_size) / w0);
  if (!scaleup) r = std::min(r, 1.0);
  const int new_w = static_cast<int>(std::lround(w0 * r));
  const int new_h = static_cast<int>(std::lround(h0 * r));
  double dw = (img_size - new_w) / 2.0;
  double dh = (img_size - new_h) / 2.0;

  cv::Mat resized;
  if (new_w != w0 || new_h != h0) {
    cv::resize(img, resized, cv::Size(new_w, new_h), 0, 0, cv::INTER_LINEAR);
  } else {
    resized = img;
  }
  const int top = static_cast<int>(std::lround(dh - 0.1));
  const int bottom = static_cast<int>(std::lround(dh + 0.1));
  const int left = static_cast<int>(std::lround(dw - 0.1));
  const int right = static_cast<int>(std::lround(dw + 0.1));

  cv::Mat canvas(img_size, img_size, CV_8UC3, cv::Scalar(114, 114, 114));
  resized.copyTo(canvas(cv::Rect(left, top, new_w, new_h)));
  (void)bottom;
  (void)right;

  // BGR -> RGB while writing into the batch slot
  cv::Mat rgb;
  cv::cvtColor(canvas, rgb, cv::COLOR_BGR2RGB);
  std::memcpy(out, rgb.data, static_cast<size_t>(img_size) * img_size * 3);

  meta->ratio = static_cast<float>(r);
  meta->dw = static_cast<float>(dw);
  meta->dh = static_cast<float>(dh);
  meta->h0 = h0;
  meta->w0 = w0;
  meta->ok = 1;
}

}  // namespace

extern "C" {

// Decode + letterbox n images into out (n, img_size, img_size, 3) RGB uint8.
// metas: (n, 6) float32 rows [ratio, dw, dh, h0, w0, ok].
// Returns the number of successfully decoded images.
int ysl_load_letterbox_batch(const char** paths, int n, int img_size,
                             int scaleup, unsigned char* out, float* metas,
                             int n_threads) {
  if (n <= 0) return 0;
  if (n_threads <= 0) n_threads = 1;
  std::vector<Meta> mts(n);
  std::atomic<int> next{0};

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      letterbox_one(paths[i], img_size, scaleup != 0,
                    out + static_cast<size_t>(i) * img_size * img_size * 3,
                    &mts[i]);
    }
  };

  std::vector<std::thread> pool;
  const int nt = std::min(n_threads, n);
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();

  int ok = 0;
  for (int i = 0; i < n; ++i) {
    metas[i * 6 + 0] = mts[i].ratio;
    metas[i * 6 + 1] = mts[i].dw;
    metas[i * 6 + 2] = mts[i].dh;
    metas[i * 6 + 3] = static_cast<float>(mts[i].h0);
    metas[i * 6 + 4] = static_cast<float>(mts[i].w0);
    metas[i * 6 + 5] = static_cast<float>(mts[i].ok);
    ok += mts[i].ok;
  }
  return ok;
}

}  // extern "C"
