// int8 and bf16 convolutions on the padded-2D activation layout for Hopper
// (sm_90a):
//
//     out[r, n] = epi( sum_{tap, c} x2d[r + off(tap), c] * w[tap, c, n] )
//
// with off = 0 for the 1x1 and off = (dy-1)*wp + (dx-1) for the 9 taps of the
// 3x3/stride-1 SAME conv.  x2d is [R, C] int8 or bf16: a [B, H, W, C] tensor
// with one zero pixel of border on every side, (batch, row, col) flattened,
// wp = W+2.  Rows outside [0, R) read as 0.  Replaces the TPU Pallas kernels
// yolo_v3_tpu/ops/fused_conv.py::conv1x1_p2d (_conv1x1_kernel) and
// ::conv3x3_p2d (_conv3x3_kernel) in both their input modes (int8 with int32
// accumulation, bf16 with float32 accumulation); res_block_p2d is the two in
// a row.
//
// Epilogue (fused_conv.py::_epilogue), in float32 with every step rounded and
// no contraction (__fmul_rn / __fadd_rn), so that it matches the plain
// PyTorch version step for step (bit-equal for int8 input, whose
// accumulator is exact):
//     y = acc * scale + bias;  y = leaky(y);  y = y + residual * res_scale
//     y = 0 on border rows;    int8: clip(rint(y), -127, 127)  (half to even)
//                              bf16: round to nearest even
//
// What bounds it on the H100.  At YOLOv3-416, batch 8, the 1x1s are
// [R, C] @ [C, N] with R = 8*(H+2)^2 and N = C/2 (or 255 for a det): at
// C = 128 int8 does ~64 MACs per byte of x and out, below the card's ~590
// op/byte int8 balance point: bandwidth bound; bf16 halves the MACs per
// byte against a ~295 op/byte balance, so its 1x1s sit near it.  The 3x3s
// do 9x that per byte and are compute bound from 52^2 on in both dtypes.
// At 13^2 the grid is small (R = 1,800 rows for 132 SMs).
//
// What the design does about it.  One block computes a BM x 128 tile of out
// (BM = 128, or 64 where the grid would not cover the SMs twice, which
// splits N further at 13^2 and 26^2) as an implicit GEMM on tensor cores
// (mma.sync m16n8k32 s8 with int32 accumulate, or m16n8k16 bf16 with
// float32 accumulate).  The 3x3 needs no im2col: each K step stages the BM
// rows of x2d at the tap's row offset.  mma wants K contiguous in both
// operands, so the weight comes K-major ([N][taps*C], transposed once by
// the wrapper and cached).  Both operands then go through 16-byte cp.async
// into a 3-stage ring of shared tiles, 64 bytes of K per row and stage (64
// int8 or 32 bf16 channels): two stages of loads are in flight while the
// tensor cores work on the third, which hides the L2 round trip that bounds
// the small grids.  Shared rows are 80 bytes apart, so every fragment is one
// conflict-free 32-bit shared load: the two mma shapes read the same bytes
// of a 16-row x 32-byte A tile and of an 8-column x 32-byte B tile, so one
// templated kernel serves both dtypes.  One float32 accumulator over K =
// 9*512 holds the bf16 tolerance (no partial sums).  The residual add,
// border mask and rounding happen in registers; x2d is read once per tap,
// out written once.  wgmma and TMA are later work: in this layout each
// tap's A tile is a plain 2-D box of x2d at a row offset, which TMA with
// out-of-bounds zero fill can bring in for wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;     // threads per block: 8 warps, 4 (rows) x 2 (cols)
constexpr int BN = 128;     // output channels per block
constexpr int KB = 64;      // bytes of K per row and step: 64 int8 or 32 bf16 channels
constexpr int SROW = 80;    // shared row stride in bytes: 64 + 16, conflict-free fragments
constexpr int STAGES = 3;   // cp.async ring depth
constexpr float LEAKY = 0.1f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes global -> shared, of which the first `bytes` (0 or 16) are
// read and the rest zero-filled; lands after a later cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(pending));
}

// One 32-byte K slice of a 16 x 8 tile: int8 (k32, int32 accumulate) or
// bf16 (k16, float32 accumulate).  The fragments hold the same bytes.
__device__ __forceinline__ void mma(int (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The accumulator type of an input type.
template <typename T> struct Acc;
template <> struct Acc<int8_t> { using type = int; };
template <> struct Acc<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// The epilogue of one accumulator, in the plain version's order.
template <typename A, typename T>
__device__ __forceinline__ float epilogue(A acc, float scale, float bias, bool lk,
                                          const T* res, float res_scale) {
  float y = __fadd_rn(__fmul_rn(to_float(acc), scale), bias);
  if (lk) y = y > 0.f ? y : __fmul_rn(LEAKY, y);
  if (res) y = __fadd_rn(y, __fmul_rn(to_float(*res), res_scale));
  return y;
}

__device__ __forceinline__ int8_t requant(float y) {
  const int v = __float2int_rn(y);  // round half to even
  return (int8_t)(v > 127 ? 127 : (v < -127 ? -127 : v));
}

// Stage 16 bytes of a row (`n` valid of them, 0..16) into shared memory:
// cp.async when the run is 16-byte aligned and whole or empty, else byte
// by byte (int8 with C % 16 != 0, test shapes only; bf16 needs C % 8 == 0).
__device__ __forceinline__ void stage16(int8_t* dst, const int8_t* src, int n, bool vec) {
  if (vec) {
    cp_async16(dst, src, n >= 16 ? 16 : 0);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) dst[j] = j < n ? src[j] : (int8_t)0;
  }
}

// Grid: (ceil(R / BM), ceil(N / BN)), BM = 64 * MI; dynamic shared memory
// STAGES * (BM + BN) * SROW bytes.  wt is the weight K-major: [N][TAPS * C].
// Operands are addressed in bytes: a row of x2d is C * sizeof(T) bytes.
template <typename T, int TAPS, int MI>
__global__ void __launch_bounds__(NT) conv_p2d_kernel(
    const T* __restrict__ x_, const T* __restrict__ wt_,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const T* __restrict__ residual, float res_scale, void* __restrict__ out,
    int out_bf16, int R, int C, int N, int hp, int wp, int leaky) {
  constexpr int BM = 64 * MI;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As = smem;                            // [STAGES][BM][SROW]
  int8_t* Bs = smem + STAGES * BM * SROW;       // [STAGES][BN][SROW]
  const int8_t* x = reinterpret_cast<const int8_t*>(x_);
  const int8_t* wt = reinterpret_cast<const int8_t*>(wt_);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int cb = C * (int)sizeof(T);     // bytes per row of x2d and per tap of wt
  const int kpt = (cb + KB - 1) / KB;    // K steps per tap
  const int steps = TAPS * kpt;
  const int ktot = TAPS * cb;
  const bool vec = cb % 16 == 0;

  // Stage K step s into ring slot `slot`: BM rows of x2d at the tap's
  // offset and BN weight rows, 4 runs of 16 bytes each.
  auto load = [&](int s, int slot) {
    const int tap = s / kpt, k0 = (s % kpt) * KB;
    const int off = TAPS == 9 ? (tap / 3 - 1) * wp + tap % 3 - 1 : 0;
    int8_t* as = As + slot * BM * SROW;
    int8_t* bs = Bs + slot * BN * SROW;
    for (int i = tid; i < BM * 4; i += NT) {
      const int row = i / 4, k = k0 + 16 * (i % 4);
      const int r = m0 + row + off;
      const bool in = r >= 0 && r < R && k < cb;
      stage16(as + row * SROW + 16 * (i % 4), in ? x + (size_t)r * cb + k : x,
              in ? cb - k : 0, vec);
    }
    for (int i = tid; i < BN * 4; i += NT) {
      const int col = i / 4, k = k0 + 16 * (i % 4);
      const int n = n0 + col;
      const bool in = n < N && k < cb;
      stage16(bs + col * SROW + 16 * (i % 4),
              in ? wt + (size_t)n * ktot + (size_t)tap * cb + k : wt, in ? cb - k : 0, vec);
    }
  };

  using A = typename Acc<T>::type;
  A acc[MI][8][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();   // step s has landed (this thread's copies)
    __syncthreads();               // ... everyone's; slot (s-1) % STAGES is free
    if (s + STAGES - 1 < steps) load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    cp_async_commit();
    const int8_t* as = As + (s % STAGES) * BM * SROW;
    const int8_t* bs = Bs + (s % STAGES) * BN * SROW;
#pragma unroll
    for (int kk = 0; kk < KB; kk += 32) {
      unsigned afr[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int8_t* a = as + (wm * 16 * MI + mi * 16 + g) * SROW + kk + 4 * q;
        afr[mi][0] = *reinterpret_cast<const unsigned*>(a);
        afr[mi][1] = *reinterpret_cast<const unsigned*>(a + 8 * SROW);
        afr[mi][2] = *reinterpret_cast<const unsigned*>(a + 16);
        afr[mi][3] = *reinterpret_cast<const unsigned*>(a + 8 * SROW + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int8_t* b = bs + (wn * 64 + ni * 8 + g) * SROW + kk + 4 * q;
        const unsigned b0 = *reinterpret_cast<const unsigned*>(b);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(b + 16);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma(acc[mi][ni], afr[mi], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // ---- epilogue ------------------------------------------------------------
  const int plane = hp * wp;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * 16 * MI + mi * 16 + g + 8 * h;
      if (r >= R) continue;
      const int p = r % plane, prow = p / wp, pcol = p % wp;
      const bool valid = prow >= 1 && prow <= hp - 2 && pcol >= 1 && pcol <= wp - 2;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 64 + ni * 8 + 2 * q + e;
          if (n >= N) continue;
          const size_t o = (size_t)r * N + n;
          float y = epilogue(acc[mi][ni][2 * h + e], scale[n], bias[n], leaky != 0,
                             residual ? residual + o : nullptr, res_scale);
          if (!valid) y = 0.f;
          if (out_bf16)
            static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
          else
            static_cast<int8_t*>(out)[o] = requant(y);
        }
    }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, int TAPS>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           const void* residual, float res_scale, void* out, int out_bf16, int R,
           int C, int N, int hp, int wp, int leaky, void* stream) {
  if (R <= 0 || C <= 0 || N <= 0 || hp < 3 || wp < 3) return (int)cudaErrorInvalidValue;
  // 16-byte cp.async runs need 16-byte rows for any input but int8
  if (sizeof(T) > 1 && (C * (int)sizeof(T)) % 16) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int nb = ceil_div(N, BN);
  // 128-row tiles unless that leaves the grid short of two blocks per SM
  const bool small = (long)ceil_div(R, 128) * nb < 2L * sms;
  const dim3 grid(ceil_div(R, small ? 64 : 128), nb);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = small ? conv_p2d_kernel<T, TAPS, 1> : conv_p2d_kernel<T, TAPS, 2>;
  const int smem = STAGES * ((small ? 64 : 128) + BN) * SROW;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const T*>(residual), res_scale, out, out_bf16, R, C, N, hp, wp, leaky);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the launch's cudaError_t (0 on success).  x [R, C] int8 (the
// _i8 entry points) or bf16 (_bf16; C % 8 == 0), w the weight K-major:
// [N, taps*C] of x's dtype (row n holds tap-major, then channel); scale,
// bias [N] float32; residual [R, N] of x's dtype or null; out [R, N] int8,
// or bf16 when out_bf16.  All device pointers to contiguous arrays; the
// kernel runs on `stream` and does not synchronise.
#define YOLO_CONV_P2D(name, T, taps)                                                    \
  int name(const void* x, const void* w, const void* scale, const void* bias,           \
           const void* residual, float res_scale, void* out, int out_bf16, int R, int C, \
           int N, int hp, int wp, int leaky, void* stream) {                            \
    return launch<T, taps>(x, w, scale, bias, residual, res_scale, out, out_bf16, R, C,  \
                           N, hp, wp, leaky, stream);                                   \
  }

YOLO_CONV_P2D(yolo_conv1x1_p2d_i8, int8_t, 1)
YOLO_CONV_P2D(yolo_conv3x3_p2d_i8, int8_t, 9)
YOLO_CONV_P2D(yolo_conv1x1_p2d_bf16, __nv_bfloat16, 1)
YOLO_CONV_P2D(yolo_conv3x3_p2d_bf16, __nv_bfloat16, 9)

#undef YOLO_CONV_P2D

const char* yolo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
