// Batched letterbox of uint8 HWC images for Hopper (sm_90a): every image of
// a batch, packed back to back in one byte buffer, resized with OpenCV's
// INTER_CUBIC and padded into one [B, dim, dim, 3] float32 tensor in [0, 1],
// in one launch.
//
// It replaces no TPU kernel: the JAX package letterboxes with two XLA
// matmuls an image (yolo_v3_tpu/ops/letterbox.py::letterbox_device), which
// the port ran as two fp32 GEMMs, their permute copies and about five more
// elementwise launches an image, after one blocking upload an image.  The
// kernel exists so that the host stages a whole batch as one upload and
// launches it once.
//
// What bounds it on the H100: bytes.  At the serving batch (32 images of
// about 640 x 480 to 416) it reads ~25 MB of uint8 once from HBM and writes
// ~66 MB of float32 once: ~27 us at 3.35 TB/s.  The arithmetic (16 taps an
// output value) is a few percent of the card's fp32 rate.
//
// The resize (as yolo_v3_tpu_torch/ops/letterbox.py::_cubic_weight_matrix):
// Keys cubic kernel a = -0.75, half-pixel centres (src = (dst + 0.5) * scale
// - 0.5), four taps from floor(src) - 1, weights normalised to sum 1, taps
// outside [0, n) clamped to the border with the weights of taps that land on
// one pixel summed.  The tap weights are computed here in double, as numpy
// computes them, and rounded to float.  The vertical pass comes first, then
// the horizontal one, as the plain version's two matmuls; each output value
// sums its 4 x 4 window of source bytes in float32 and is scaled by 1/255
// once, then clamped to [0, 1].
//
// The design:
// - A block is (image, band of BAND output rows); its threads walk each row
//   as dim * 3 consecutive floats, so every store of a warp is 128
//   contiguous bytes.  Rows and columns outside the resized rectangle take
//   the pad value.
// - The horizontal taps of the image's resized width are computed once a
//   block into shared memory (index and weight, 4 each a column); the
//   vertical taps once a row, by every thread (the same for all).
// - The vertical sums are kept in registers, not staged through a shared
//   row: no source width is too wide for shared memory, and the 4 x 4
//   window's bytes come from L1 (each source byte is read ~7 times at
//   640 -> 416, from L1 or L2, and once from HBM).
// - An image's geometry comes from its row of the descriptor table, int64
//   [B, 7]: byte offset into the packed buffer, w, h, resized w and h, x
//   and y pads.  Letterbox and plain resize (rw = rh = dim, no pad)
//   are the same kernel.  A row that does not fit the buffer or the output
//   (it cannot be checked on the host without a sync) makes the image's
//   output NaN instead of reading out of bounds.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int NT = 256;      // threads a block
constexpr int BAND = 8;      // output rows a block
constexpr int DESC = 7;      // int64 columns of the descriptor table
constexpr int MAX_SMEM = 227 * 1024;

struct Taps {
  int i[4];
  float w[4];
};

// The four taps of output index `dst` of a 1-D cubic resize src_len ->
// dst_len, clamped and merged as _cubic_weight_matrix merges them: a tap
// that lands on the pixel of an earlier tap adds its weight there and keeps
// weight 0 (and that pixel's index, so that every load stays in bounds).
__device__ Taps cubic_taps(int dst, int src_len, int dst_len) {
  const double a = -0.75;
  const double scale = (double)src_len / (double)dst_len;
  const double s = (dst + 0.5) * scale - 0.5;
  const double base = floor(s);
  double w[4], total = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double t = fabs(base - 1.0 + k - s);
    w[k] = t <= 1.0 ? (a + 2.0) * t * t * t - (a + 3.0) * t * t + 1.0
         : t < 2.0  ? a * t * t * t - 5.0 * a * t * t + 8.0 * a * t - 4.0 * a
                    : 0.0;
    total += w[k];
  }
  Taps out;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int tap = (int)base - 1 + k;
    out.i[k] = tap < 0 ? 0 : tap >= src_len ? src_len - 1 : tap;
    out.w[k] = 0.0f;
  }
  // clamped taps land on one pixel in runs; each run's weight goes to its
  // first tap (selected, not indexed, so that the arrays stay in registers)
  int run = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k > 0 && out.i[k] != out.i[k - 1]) run = k;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j == run) out.w[j] = (float)((double)out.w[j] + w[k] / total);
  }
  return out;
}

__global__ void __launch_bounds__(NT)
letterbox_kernel(const uint8_t* __restrict__ src, long long src_bytes,
                 const long long* __restrict__ desc, float* __restrict__ out, int dim,
                 float pad) {
  extern __shared__ int4 smem[];
  int4* cidx = smem;                                  // [rw] tap columns
  float4* cw = reinterpret_cast<float4*>(smem + dim);  // [rw] their weights

  const int b = blockIdx.y;
  const long long* d = desc + (long long)b * DESC;
  const long long off = d[0];
  const long long w = d[1], h = d[2], rw = d[3], rh = d[4], xp = d[5], yp = d[6];
  const bool valid = w > 0 && h > 0 && rw > 0 && rh > 0 && xp >= 0 && yp >= 0 &&
                     xp + rw <= dim && yp + rh <= dim && off >= 0 &&
                     off + w * h * 3 <= src_bytes;
  const int row_len = dim * 3;
  float* img_out = out + (long long)b * dim * row_len;
  const int r0 = blockIdx.x * BAND;
  const int r1 = r0 + BAND < dim ? r0 + BAND : dim;

  if (!valid) {
    for (int r = r0; r < r1; ++r)
      for (int j = threadIdx.x; j < row_len; j += NT)
        img_out[(long long)r * row_len + j] = __int_as_float(0x7fc00000);
    return;
  }

  for (int q = threadIdx.x; q < rw; q += NT) {
    const Taps t = cubic_taps(q, (int)w, (int)rw);
    cidx[q] = make_int4(t.i[0] * 3, t.i[1] * 3, t.i[2] * 3, t.i[3] * 3);
    cw[q] = make_float4(t.w[0], t.w[1], t.w[2], t.w[3]);
  }
  __syncthreads();

  const uint8_t* img = src + off;
  const long long src_row = w * 3;
  const int x0 = (int)xp, x1 = (int)(xp + rw);
  for (int r = r0; r < r1; ++r) {
    float* orow = img_out + (long long)r * row_len;
    const int i = r - (int)yp;
    if (i < 0 || i >= rh) {
      for (int j = threadIdx.x; j < row_len; j += NT) orow[j] = pad;
      continue;
    }
    const Taps ty = cubic_taps(i, (int)h, (int)rh);
    const uint8_t* s0 = img + ty.i[0] * src_row;
    const uint8_t* s1 = img + ty.i[1] * src_row;
    const uint8_t* s2 = img + ty.i[2] * src_row;
    const uint8_t* s3 = img + ty.i[3] * src_row;
    for (int j = threadIdx.x; j < row_len; j += NT) {
      const int ox = j / 3, c = j - 3 * ox;
      float v = pad;
      if (ox >= x0 && ox < x1) {
        const int4 ci = cidx[ox - x0];
        const float4 wx = cw[ox - x0];
        const int cols[4] = {ci.x + c, ci.y + c, ci.z + c, ci.w + c};
        const float wxs[4] = {wx.x, wx.y, wx.z, wx.w};
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int col = cols[k];
          float y = ty.w[0] * (float)__ldg(s0 + col);
          y += ty.w[1] * (float)__ldg(s1 + col);
          y += ty.w[2] * (float)__ldg(s2 + col);
          y += ty.w[3] * (float)__ldg(s3 + col);
          acc += wxs[k] * y;
        }
        v = fminf(fmaxf(acc * (1.0f / 255.0f), 0.0f), 1.0f);
      }
      orow[j] = v;
    }
  }
}

}  // namespace

extern "C" {

// Returns the launch's cudaError_t (0 on success).  src: the packed uint8
// images (src_bytes bytes); desc: int64 [batch, 7] (offset, w, h, rw, rh,
// xp, yp); out: float32 [batch, dim, dim, 3].  Device pointers to
// contiguous arrays.  dim * 32 bytes of column taps must fit a block's
// shared memory (dim <= 7264).  Runs on `stream`, does not synchronise.
int yolo_letterbox_u8(const void* src, long long src_bytes, const void* desc, void* out,
                      int batch, int dim, float pad, void* stream) {
  const int smem = dim * (int)(sizeof(int4) + sizeof(float4));
  if (batch < 1 || batch > 65535 || dim < 1 || smem > MAX_SMEM || src_bytes < 0)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        letterbox_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const uint8_t* s = static_cast<const uint8_t*>(src);
  const long long* d = static_cast<const long long*>(desc);
  float* o = static_cast<float*>(out);
  void* args[] = {&s, &src_bytes, &d, &o, &dim, &pad};
  const dim3 grid((dim + BAND - 1) / BAND, batch);
  return (int)cudaLaunchKernel(reinterpret_cast<const void*>(letterbox_kernel), grid,
                               dim3(NT), args, smem, static_cast<cudaStream_t>(stream));
}

const char* yolo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
