// yolodata: native host-side image loading runtime for yolo_v3_tpu_torch.
//
// The port's own copy of the JAX package's native/yolodata.cc, built by
// yolo_v3_tpu_torch/ops/_build.py (build_host) with g++ and the same flags.
// The reference's host input path is OpenCV decode/resize driven from Python
// worker processes (reference dataset.py:194-195, evaluate.py:216).  This is
// its native equivalent: a C++ thread-pool pipeline that decodes JPEGs
// (libjpeg), letterboxes with the same geometry as
// yolo_v3_tpu_torch.ops.boxes.letterbox_params (int-truncated resize dims,
// floor-div center pads, gray-128 fill, Keys a=-0.75 cubic sampling), and
// hands back ready-to-device float32 or uint8 NHWC buffers — no Python in the
// loop between file bytes and the batch tensor.
//
// Exposed as a minimal C API for ctypes (see
// yolo_v3_tpu_torch/data/native_loader.py and data/native_aug.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <csetjmp>
#include <unordered_map>

#include <jpeglib.h>

namespace {

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg) -> RGB uint8
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* rgb,
                 int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb->resize(size_t(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() + size_t(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------------
// Cubic resize (Keys a = -0.75, half-pixel centers, clamped borders) —
// the same convention as ops/letterbox.py's matmul resize and OpenCV's
// INTER_CUBIC kernel.
// ---------------------------------------------------------------------------

inline float keys(float t) {
  const float a = -0.75f;
  t = std::fabs(t);
  if (t <= 1.f) return ((a + 2.f) * t - (a + 3.f)) * t * t + 1.f;
  if (t < 2.f) return (((t - 5.f) * t + 8.f) * t - 4.f) * a;
  return 0.f;
}

struct Taps {
  int idx[4];
  float w[4];
};

std::vector<Taps> make_taps(int src, int dst) {
  std::vector<Taps> taps(dst);
  double scale = double(src) / dst;
  for (int i = 0; i < dst; ++i) {
    double s = (i + 0.5) * scale - 0.5;
    int base = int(std::floor(s));
    float sum = 0.f;
    for (int k = 0; k < 4; ++k) {
      int j = base - 1 + k;
      float wt = keys(float(s - j));
      taps[i].idx[k] = std::min(std::max(j, 0), src - 1);
      taps[i].w[k] = wt;
      sum += wt;
    }
    for (int k = 0; k < 4; ++k) taps[i].w[k] /= sum;
  }
  return taps;
}

// Letterbox uint8 RGB [h, w, 3].  fdst (float32 [out_h, out_w, 3] in [0,1])
// or udst (uint8 [out_h, out_w, 3], cv2 pixel semantics) — exactly one is
// non-null.  The uint8 form is the int8 serving path's native feed
// (models/quantized.py u8 entry): 4x less host->device transfer.
void letterbox(const uint8_t* src, int w, int h, float* fdst, uint8_t* udst,
               int out_w, int out_h) {
  double ratio = std::min(double(out_w) / w, double(out_h) / h);
  int rw = int(w * ratio), rh = int(h * ratio);
  int xp = (out_w - rw) / 2, yp = (out_h - rh) / 2;

  if (fdst) {
    std::fill(fdst, fdst + size_t(out_w) * out_h * 3, 128.f / 255.f);
  } else {
    std::fill(udst, udst + size_t(out_w) * out_h * 3, uint8_t(128));
  }

  std::vector<Taps> tx = make_taps(w, rw), ty = make_taps(h, rh);

  // horizontal pass: [h, rw, 3] floats
  std::vector<float> tmp(size_t(h) * rw * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* srow = src + size_t(y) * w * 3;
    float* trow = tmp.data() + size_t(y) * rw * 3;
    for (int x = 0; x < rw; ++x) {
      const Taps& t = tx[x];
      for (int c = 0; c < 3; ++c) {
        float v = 0.f;
        for (int k = 0; k < 4; ++k) v += t.w[k] * srow[t.idx[k] * 3 + c];
        trow[x * 3 + c] = v;
      }
    }
  }
  // vertical pass into the padded canvas
  for (int y = 0; y < rh; ++y) {
    const Taps& t = ty[y];
    size_t off = (size_t(y + yp) * out_w + xp) * 3;
    for (int x = 0; x < rw * 3; ++x) {
      float v = 0.f;
      for (int k = 0; k < 4; ++k)
        v += t.w[k] * tmp[size_t(t.idx[k]) * rw * 3 + x];
      if (fdst) {
        fdst[off + x] = std::min(std::max(v / 255.f, 0.f), 1.f);
      } else {
        udst[off + x] =
            uint8_t(std::min(std::max(int(v + 0.5f), 0), 255));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Darknet training augmentation: HSV jitter + per-side crop/pad + flip.
//
// Pixel semantics mirror the Python pipeline (yolo_v3_tpu_torch/data/transforms.py
// HSVAug / RandomJitterCrop / RandomHorizontalFlip, themselves mirroring
// reference transforms.py:77-125): RGB -> cv2-8u HSV, float jitter, clip,
// truncate, HSV -> RGB.  The RGB<->HSV conversions replicate OpenCV's 8-bit
// fixed-point kernels exactly (hsv_shift=12 division tables; H in [0,180)),
// so the native path is pixel-identical to the cv2 path
// (tests/test_torch_native.py).  Random PARAMETERS are drawn in Python from
// the per-sample Generator (data/native_aug.py) so the draw sequence — and
// therefore determinism/resume — is identical to the in-Python pipeline.
// ---------------------------------------------------------------------------

struct AugParams {
  float dhue = 0.f, dsat = 1.f, dexp = 1.f;  // H add (cv2 units), S/V scale
  int left = 0, right = 0, top = 0, bottom = 0;  // crop(+)/pad(-) per side
  int flip = 0;
  int hsv = 1;  // apply the HSV stage (0 = geometry only)
};

constexpr int kHsvShift = 12;

struct HsvTables {
  int sdiv[256];
  int hdiv[256];  // 180-range H
  HsvTables() {
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; ++i) {
      sdiv[i] = int(std::lrint((255 << kHsvShift) / double(i)));
      hdiv[i] = int(std::lrint((180 << kHsvShift) / (6.0 * i)));
    }
  }
};

const HsvTables& hsv_tables() {
  static const HsvTables t;
  return t;
}

// cv2 RGB2HSV 8u (H range 180): fixed-point with rounding shifts.
inline void rgb_to_hsv_u8(const uint8_t* p, uint8_t* out) {
  const HsvTables& tab = hsv_tables();
  int r = p[0], g = p[1], b = p[2];
  int v = std::max(r, std::max(g, b));
  int mn = std::min(r, std::min(g, b));
  int diff = v - mn;
  int s = (diff * tab.sdiv[v] + (1 << (kHsvShift - 1))) >> kHsvShift;
  int vr = v == r ? -1 : 0;
  int vg = v == g ? -1 : 0;
  int h = (vr & (g - b)) +
          (~vr & ((vg & (b - r + 2 * diff)) + (~vg & (r - g + 4 * diff))));
  h = (h * tab.hdiv[diff] + (1 << (kHsvShift - 1))) >> kHsvShift;
  h += h < 0 ? 180 : 0;
  out[0] = uint8_t(h);
  out[1] = uint8_t(s);
  out[2] = uint8_t(v);
}

// cv2 HSV2RGB 8u: float sector kernel, saturate_cast (round-to-nearest).
inline void hsv_to_rgb_u8(const uint8_t* p, uint8_t* out) {
  float h = p[0] * (6.f / 180.f);
  float s = p[1] * (1.f / 255.f);
  float v = p[2] * (1.f / 255.f);
  if (h < 0.f)
    do h += 6.f; while (h < 0.f);
  else if (h >= 6.f)
    do h -= 6.f; while (h >= 6.f);
  int sector = int(std::floor(h));
  h -= sector;
  if (unsigned(sector) >= 6u) { sector = 0; h = 0.f; }
  float tab[4] = {v, v * (1.f - s), v * (1.f - s * h),
                  v * (1.f - s * (1.f - h))};
  static const int sector_rgb[6][3] = {{0, 3, 1}, {2, 0, 1}, {1, 0, 3},
                                       {1, 2, 0}, {3, 1, 0}, {0, 1, 2}};
  // cv2 5.x truncates the final *255 (empirically bit-exact on 99.997% of
  // values; the rest are 1-ulp float op-order boundaries — see
  // tests/test_torch_native.py tolerance)
  out[0] = uint8_t(std::min(std::max(int(tab[sector_rgb[sector][0]] * 255.f), 0), 255));
  out[1] = uint8_t(std::min(std::max(int(tab[sector_rgb[sector][1]] * 255.f), 0), 255));
  out[2] = uint8_t(std::min(std::max(int(tab[sector_rgb[sector][2]] * 255.f), 0), 255));
}

// HSV jitter with the Python pipeline's float semantics: float32 ops on the
// cv2-8u HSV values, clip to [0, 255], truncate back to uint8 (numpy
// .astype(np.uint8) truncates).
void hsv_aug(std::vector<uint8_t>& rgb, float dhue, float dsat, float dexp) {
  uint8_t hsv[3];
  for (size_t i = 0; i < rgb.size(); i += 3) {
    rgb_to_hsv_u8(&rgb[i], hsv);
    float h = std::min(std::max(float(hsv[0]) + dhue, 0.f), 255.f);
    float s = std::min(std::max(float(hsv[1]) * dsat, 0.f), 255.f);
    float v = std::min(std::max(float(hsv[2]) * dexp, 0.f), 255.f);
    hsv[0] = uint8_t(h);
    hsv[1] = uint8_t(s);
    hsv[2] = uint8_t(v);
    hsv_to_rgb_u8(hsv, &rgb[i]);
  }
}

// Per-side crop(+)/pad(-) onto a gray-128 canvas, then optional horizontal
// flip.  Updates rgb/w/h in place.
void crop_pad_flip(std::vector<uint8_t>& rgb, int& w, int& h,
                   const AugParams& ap) {
  int nw = w - ap.left - ap.right;
  int nh = h - ap.top - ap.bottom;
  if ((ap.left | ap.right | ap.top | ap.bottom) && nw >= 1 && nh >= 1) {
    std::vector<uint8_t> canvas(size_t(nw) * nh * 3, uint8_t(128));
    int sx1 = std::max(ap.left, 0), dx1 = std::max(-ap.left, 0);
    int sy1 = std::max(ap.top, 0), dy1 = std::max(-ap.top, 0);
    int sx2 = std::min(w, w - ap.right);
    int sy2 = std::min(h, h - ap.bottom);
    if (sx2 > sx1 && sy2 > sy1) {
      size_t row_bytes = size_t(sx2 - sx1) * 3;
      for (int y = sy1; y < sy2; ++y) {
        std::memcpy(canvas.data() + (size_t(dy1 + y - sy1) * nw + dx1) * 3,
                    rgb.data() + (size_t(y) * w + sx1) * 3, row_bytes);
      }
    }
    rgb.swap(canvas);
    w = nw;
    h = nh;
  }
  if (ap.flip) {
    for (int y = 0; y < h; ++y) {
      uint8_t* row = rgb.data() + size_t(y) * w * 3;
      for (int x = 0; x < w / 2; ++x) {
        for (int c = 0; c < 3; ++c)
          std::swap(row[x * 3 + c], row[(w - 1 - x) * 3 + c]);
      }
    }
  }
}

void augment_rgb(std::vector<uint8_t>& rgb, int& w, int& h,
                 const AugParams& ap) {
  if (ap.hsv) hsv_aug(rgb, ap.dhue, ap.dsat, ap.dexp);
  crop_pad_flip(rgb, w, h, ap);
}

// ---------------------------------------------------------------------------
// Thread-pool loader
// ---------------------------------------------------------------------------

struct Job {
  int64_t tag;
  std::string path;
  int out_w, out_h;
  int fmt;       // 0 = float32 [0,1], 1 = uint8
  int kind = 0;  // 0 = letterbox, 1 = decode+hold, 2 = augment held image
  AugParams aug;
};

struct Result {
  int64_t tag;
  int status;  // 0 ok, <0 error
  int org_w, org_h;
  std::vector<float> pixels;       // [out_h, out_w, 3] when fmt == 0
  std::vector<uint8_t> pixels_u8;  // [out_h, out_w, 3] when fmt == 1
};

struct Held {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
};

struct Loader {
  std::vector<std::thread> workers;
  std::deque<Job> jobs;
  std::deque<Result> results;
  std::deque<Result> info_results;  // decode+hold completions (dims only)
  std::unordered_map<int64_t, Held> held;
  std::mutex mu;
  std::condition_variable cv_job, cv_res, cv_info;
  std::atomic<bool> stop{false};

  explicit Loader(int n_threads) {
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { run(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_job.notify_all();
    for (auto& t : workers) t.join();
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_job.wait(lk, [this] { return stop || !jobs.empty(); });
        if (stop && jobs.empty()) return;
        job = std::move(jobs.front());
        jobs.pop_front();
      }
      Result res;
      res.tag = job.tag;
      res.status = -1;
      res.org_w = res.org_h = 0;

      if (job.kind == 2) {
        // augment an image held by a prior decode+hold job
        Held img;
        {
          std::lock_guard<std::mutex> lk(mu);
          auto it = held.find(job.tag);
          if (it != held.end()) {
            img = std::move(it->second);
            held.erase(it);
          }
        }
        if (!img.rgb.empty()) {
          res.org_w = img.w;
          res.org_h = img.h;
          augment_rgb(img.rgb, img.w, img.h, job.aug);
          if (job.fmt == 1) {
            res.pixels_u8.resize(size_t(job.out_w) * job.out_h * 3);
            letterbox(img.rgb.data(), img.w, img.h, nullptr,
                      res.pixels_u8.data(), job.out_w, job.out_h);
          } else {
            res.pixels.resize(size_t(job.out_w) * job.out_h * 3);
            letterbox(img.rgb.data(), img.w, img.h, res.pixels.data(),
                      nullptr, job.out_w, job.out_h);
          }
          res.status = 0;
        } else {
          res.status = -4;  // no held image under this tag
        }
        {
          std::lock_guard<std::mutex> lk(mu);
          results.push_back(std::move(res));
        }
        cv_res.notify_all();
        continue;
      }

      FILE* f = fopen(job.path.c_str(), "rb");
      if (f) {
        fseek(f, 0, SEEK_END);
        long len = ftell(f);
        fseek(f, 0, SEEK_SET);
        std::vector<uint8_t> bytes(len);
        if (fread(bytes.data(), 1, len, f) == size_t(len)) {
          std::vector<uint8_t> rgb;
          int w = 0, h = 0;
          if (decode_jpeg(bytes.data(), bytes.size(), &rgb, &w, &h)) {
            res.org_w = w;
            res.org_h = h;
            if (job.kind == 1) {
              std::lock_guard<std::mutex> lk(mu);
              held[job.tag] = Held{std::move(rgb), w, h};
              res.status = 0;
            } else if (job.fmt == 1) {
              res.pixels_u8.resize(size_t(job.out_w) * job.out_h * 3);
              letterbox(rgb.data(), w, h, nullptr, res.pixels_u8.data(),
                        job.out_w, job.out_h);
              res.status = 0;
            } else {
              res.pixels.resize(size_t(job.out_w) * job.out_h * 3);
              letterbox(rgb.data(), w, h, res.pixels.data(), nullptr,
                        job.out_w, job.out_h);
              res.status = 0;
            }
          } else {
            res.status = -2;  // not a decodable jpeg
          }
        }
        fclose(f);
      }
      if (job.kind == 1) {
        {
          std::lock_guard<std::mutex> lk(mu);
          info_results.push_back(std::move(res));
        }
        cv_info.notify_all();
      } else {
        {
          std::lock_guard<std::mutex> lk(mu);
          results.push_back(std::move(res));
        }
        cv_res.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

void* yolodata_create(int n_threads) { return new Loader(n_threads); }

void yolodata_destroy(void* h) { delete static_cast<Loader*>(h); }

void yolodata_submit(void* h, int64_t tag, const char* path, int out_w,
                     int out_h) {
  Loader* ldr = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(ldr->mu);
    ldr->jobs.push_back(Job{tag, path, out_w, out_h, /*fmt=*/0});
  }
  ldr->cv_job.notify_one();
}

// fmt: 0 = float32 in [0,1], 1 = uint8 (read back with yolodata_next_u8)
void yolodata_submit_fmt(void* h, int64_t tag, const char* path, int out_w,
                         int out_h, int fmt) {
  Loader* ldr = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(ldr->mu);
    ldr->jobs.push_back(Job{tag, path, out_w, out_h, fmt});
  }
  ldr->cv_job.notify_one();
}

// Blocks for the next finished result.  Copies pixels into `out` (must hold
// out_w*out_h*3 floats).  Returns status (0 ok, <0 error); fills tag/org
// dims.
int yolodata_next(void* h, int64_t* tag, float* out, int out_capacity,
                  int* org_w, int* org_h) {
  Loader* ldr = static_cast<Loader*>(h);
  Result res;
  {
    std::unique_lock<std::mutex> lk(ldr->mu);
    ldr->cv_res.wait(lk, [ldr] { return !ldr->results.empty(); });
    res = std::move(ldr->results.front());
    ldr->results.pop_front();
  }
  *tag = res.tag;
  *org_w = res.org_w;
  *org_h = res.org_h;
  if (res.status == 0) {
    if (int(res.pixels.size()) > out_capacity) return -3;
    std::memcpy(out, res.pixels.data(), res.pixels.size() * sizeof(float));
  }
  return res.status;
}

// --- training augmentation path -------------------------------------------
// Two-phase flow so Python can draw augmentation parameters from the
// per-sample RNG once the original dims are known (the draw bounds depend
// on w/h — data/native_aug.py): submit_decode -> next_decoded (dims) ->
// submit_aug (params) -> next/next_u8 (augmented letterboxed pixels).

void yolodata_submit_decode(void* h, int64_t tag, const char* path) {
  Loader* ldr = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(ldr->mu);
    Job job;
    job.tag = tag;
    job.path = path;
    job.out_w = job.out_h = 0;
    job.fmt = 0;
    job.kind = 1;
    ldr->jobs.push_back(std::move(job));
  }
  ldr->cv_job.notify_one();
}

// Blocks for the next decode+hold completion; reports dims only (pixels
// stay held under the tag until the matching submit_aug).
int yolodata_next_decoded(void* h, int64_t* tag, int* org_w, int* org_h) {
  Loader* ldr = static_cast<Loader*>(h);
  Result res;
  {
    std::unique_lock<std::mutex> lk(ldr->mu);
    ldr->cv_info.wait(lk, [ldr] { return !ldr->info_results.empty(); });
    res = std::move(ldr->info_results.front());
    ldr->info_results.pop_front();
  }
  *tag = res.tag;
  *org_w = res.org_w;
  *org_h = res.org_h;
  return res.status;
}

void yolodata_submit_aug(void* h, int64_t tag, float dhue, float dsat,
                         float dexp, int left, int right, int top, int bottom,
                         int flip, int out_w, int out_h, int fmt) {
  Loader* ldr = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(ldr->mu);
    Job job;
    job.tag = tag;
    job.out_w = out_w;
    job.out_h = out_h;
    job.fmt = fmt;
    job.kind = 2;
    job.aug = AugParams{dhue, dsat, dexp, left, right, top, bottom, flip, 1};
    ldr->jobs.push_back(std::move(job));
  }
  ldr->cv_job.notify_one();
}

// Drop a held image whose augment was never submitted (error recovery).
void yolodata_drop_held(void* h, int64_t tag) {
  Loader* ldr = static_cast<Loader*>(h);
  std::lock_guard<std::mutex> lk(ldr->mu);
  ldr->held.erase(tag);
}

// Synchronous augment of a caller-provided RGB buffer (parity tests):
// HSV jitter -> crop/pad -> flip -> letterbox into fdst OR udst (one null).
int yolodata_augment_buffer(const uint8_t* rgb, int w, int h, float dhue,
                            float dsat, float dexp, int left, int right,
                            int top, int bottom, int flip, int do_hsv,
                            int out_w, int out_h, float* fdst, uint8_t* udst) {
  std::vector<uint8_t> img(rgb, rgb + size_t(w) * h * 3);
  AugParams ap{dhue, dsat, dexp, left, right, top, bottom, flip, do_hsv};
  augment_rgb(img, w, h, ap);
  letterbox(img.data(), w, h, fdst, udst, out_w, out_h);
  return 0;
}

// uint8 variant: pops results submitted with fmt=1.
int yolodata_next_u8(void* h, int64_t* tag, uint8_t* out, int out_capacity,
                     int* org_w, int* org_h) {
  Loader* ldr = static_cast<Loader*>(h);
  Result res;
  {
    std::unique_lock<std::mutex> lk(ldr->mu);
    ldr->cv_res.wait(lk, [ldr] { return !ldr->results.empty(); });
    res = std::move(ldr->results.front());
    ldr->results.pop_front();
  }
  *tag = res.tag;
  *org_w = res.org_w;
  *org_h = res.org_h;
  if (res.status == 0) {
    if (int(res.pixels_u8.size()) > out_capacity) return -3;
    std::memcpy(out, res.pixels_u8.data(), res.pixels_u8.size());
  }
  return res.status;
}

}  // extern "C"
