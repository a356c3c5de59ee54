// Fused int8 entry of YOLOv3 for Hopper (sm_90a): stem .. stage 1's
// downsample in one kernel, in the 2x2 space-to-depth (s2d) domain:
//
//     stem    3x3 VALID                xb [B, 2h+2, 2w+2, 12] -> [2h, 2w, 128]
//     down0   3x3 stride 2, pad 1                             -> [h, w, 256]
//     res0_1  1x1                                             -> [h, w, 128]
//     res0_2  3x3 pad 1, + down0 * res_scale                  -> [h, w, 256]
//     down1   2x2 pad (1, 0)                                  -> [h, w, 128]
//
// every conv int8 in, int32 accumulation and the int8 epilogue
// clip(rint(leaky(acc * m + b) [+ residual * res_scale]), -127, 127), each
// float step rounded (__fmul_rn / __fadd_rn), as the plain version does.
// Replaces the TPU Pallas kernel yolo_v3_tpu/ops/entry_kernel.py::fused_entry
// (_entry_kernel, _conv_band, _phase2, _mask_rows, _epi).
//
// What bounds it on the H100.  Run as five convs, the entry moves the
// largest tensors of the network: at 416 and batch 8 the stem output alone
// is 8 x 208 x 208 x 128 int8 = 44 MB, written and read back, and ~90 MB of
// intermediates in all, against ~0.1 GMAC per image.  Kept on chip, only
// the 2.8 MB image and the 11 MB output move, and the kernel is bound by
// int8 tensor-core work (and its recompute of the tile halos).
//
// What the design does about it.  One block computes an 8x8 tile of the
// [h, w, 128] output.  It reads the 25x25 window of xb that tile needs and
// keeps every intermediate in shared memory: stem 23x23x128, down0 and
// res0_1 11x11, res0_2 9x9.  The TPU kernel held a 26-row band over the
// whole 208-px width; on this card one full-width stem row is 27 KB, so
// rows and columns are both tiled, and the halo is masked in rows and
// columns: every intermediate position outside the image is set to 0,
// which is that conv's zero padding.  Each conv is an implicit GEMM on int8
// tensor cores (mma.sync m16n8k32): A fragments are gathered straight from
// the shared tile at the tap's offset (per-lane pixel addresses, stride-2
// taps included, no polyphase copy), the 12 input channels of the stem are
// zero-padded to 32 in shared memory only.  The weights (768 KB in all,
// L2-resident since every block reads the same) come K-major ([cout][taps
// * cin], transposed once by the wrapper and cached) and are streamed by
// 16-byte cp.async through a 3-stage ring of shared tiles, 64 K per stage
// (the stem: 32, its 12-channel rows by word loads), so two stages of
// weight loads are in flight while the tensor cores work on the third.
// The cost is the recompute of halos: ~2x the stem and down0 work of an
// untiled chain.  wgmma, TMA and larger tiles are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;       // threads per block: 8 warps
constexpr int OT = 8;         // output tile: OT x OT positions of [h, w]
constexpr int XT = 2 * OT + 9;   // xb window (25)
constexpr int ST = 2 * OT + 7;   // stem tile (23)
constexpr int DT = OT + 3;       // down0 / res0_1 tile (11)
constexpr int RT = OT + 1;       // res0_2 tile (9)
constexpr int CIN = 12;          // xb channels
constexpr int XC = 32;           // xb channels padded in shared memory
constexpr int SKEW = 16;         // pixel stride = channels + 16 bytes
constexpr int NMAX = 256;
constexpr int STAGES = 3;        // weight ring depth
constexpr float LEAKY = 0.1f;

// shared regions (bytes); intermediates reuse the regions of dead ones
constexpr int STEM_BYTES = ST * ST * (128 + SKEW);   // stem, later res0_2
constexpr int D0_BYTES = DT * DT * (256 + SKEW);     // down0
constexpr int XB_BYTES = XT * XT * (XC + SKEW);      // xb, later res0_1
constexpr int R1_BYTES = DT * DT * (128 + SKEW);
constexpr int RES_BYTES = RT * RT * (256 + SKEW);
constexpr int S2_BYTES = XB_BYTES > R1_BYTES ? XB_BYTES : R1_BYTES;
constexpr int B_BYTES = NMAX * (64 + SKEW);           // one ring slot, the largest
constexpr int SMEM = STEM_BYTES + D0_BYTES + S2_BYTES + STAGES * B_BYTES;
static_assert(RES_BYTES <= STEM_BYTES, "res0_2 reuses the stem region");
static_assert(STEM_BYTES % 16 == 0 && D0_BYTES % 16 == 0 && S2_BYTES % 16 == 0,
              "16-byte aligned regions");

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

__device__ __forceinline__ int8_t requant(float y) {
  const int v = __float2int_rn(y);  // round half to even
  return (int8_t)(v > 127 ? 127 : (v < -127 ? -127 : v));
}

// One conv of the chain as an implicit GEMM over a tile in shared memory.
//
// Output position p = (i, j) of an OH x OW tile (local coordinates) reads
// source pixel (i*STRIDE + u, j*STRIDE + v) of the SW-wide source tile for tap
// (u, v).  The tile's origin is (gy0, gx0) in its image, whose extent is
// [0, vh) x [0, vw): positions outside it are written as 0 (the next conv's
// zero padding; for the last conv, not written).  KCIN input channels are
// used (the weight's), in K steps of BK over a source padded to a multiple
// of BK channels.  wt is the weight K-major, [N][KH*KW*KCIN].  The residual,
// if any, is the same-channel tile `res` at (i + 1, j + 1) with RW columns.
// dst is a shared tile (pixel stride N + SKEW) or, with gdst, the global
// output [.., vh, vw, N].  bst holds the STAGES weight slots.
template <int KH, int KW, int STRIDE, int N, int BK>
__device__ __forceinline__ void conv_tile(
    const int8_t* src, int SW, int SSTRIDE, int KCIN, int OH, int OW, int gy0, int gx0,
    int vh, int vw, const int8_t* __restrict__ wt, const float* __restrict__ m,
    const float* __restrict__ b, const int8_t* res, int RW, float res_scale, int8_t* dst,
    int8_t* __restrict__ gdst, int8_t* bst) {
  constexpr int NTILES = N / 64;
  constexpr int BROW = BK + SKEW;     // weight slot row stride: conflict-free fragments
  constexpr int SLOT = N * BROW;
  static_assert(STAGES * SLOT <= STAGES * B_BYTES, "weight ring");
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int M = OH * OW;
  const int mtiles = (M + 31) / 32;
  const int wtiles = mtiles * NTILES;
  const int kpt = (KCIN + BK - 1) / BK;
  const int steps = KH * KW * kpt;
  const int ktot = KH * KW * KCIN;
  const int DSTRIDE = N + SKEW;

  // Stage K step s (N weight rows of BK bytes) into ring slot `slot`:
  // cp.async for 16-byte rows, word loads for the stem's 12-channel taps.
  auto load = [&](int s, int slot) {
    const int tap = s / kpt, k0 = (s % kpt) * BK;
    int8_t* bs = bst + slot * SLOT;
    if (KCIN % 16 == 0) {
      for (int i = tid; i < N * (BK / 16); i += NT) {
        const int n = i / (BK / 16), j = i % (BK / 16), k = k0 + 16 * j;
        const bool in = k < KCIN;
        cp_async16(bs + n * BROW + 16 * j,
                   in ? wt + (size_t)n * ktot + tap * KCIN + k : wt, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < N * (BK / 4); i += NT) {
        const int n = i / (BK / 4), j = i % (BK / 4), k = k0 + 4 * j;
        *reinterpret_cast<unsigned*>(bs + n * BROW + 4 * j) =
            k < KCIN ? *reinterpret_cast<const unsigned*>(wt + (size_t)n * ktot + tap * KCIN + k)
                     : 0u;
      }
    }
  };

  for (int round = 0; round * 8 < wtiles; ++round) {
    const int wt_ = round * 8 + warp;
    const bool active = wt_ < wtiles;
    const int mt = wt_ / NTILES, nt = wt_ % NTILES;
    // source pixel of tap (0, 0) for this lane's 4 fragment rows
    int base[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int p = mt * 32 + mi * 16 + g + 8 * h;
        if (p >= M) p = M - 1;  // computed, never stored
        base[mi][h] = (p / OW) * STRIDE * SW + (p % OW) * STRIDE;
      }
    int acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
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
      cp_async_wait<STAGES - 2>();  // step s has landed (this thread's copies)
      __syncthreads();              // ... everyone's; slot (s-1) % STAGES is free
      if (s + STAGES - 1 < steps) load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
      cp_async_commit();
      if (active) {
        const int tap = s / kpt, k0 = (s % kpt) * BK;
        const int toff = (tap / KW) * SW + tap % KW;
        const int8_t* bs = bst + (s % STAGES) * SLOT;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 32) {
          unsigned afr[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int8_t* a0 = src + (base[mi][0] + toff) * SSTRIDE + k0 + kk + 4 * q;
            const int8_t* a1 = src + (base[mi][1] + toff) * SSTRIDE + k0 + kk + 4 * q;
            afr[mi][0] = *reinterpret_cast<const unsigned*>(a0);
            afr[mi][1] = *reinterpret_cast<const unsigned*>(a1);
            afr[mi][2] = *reinterpret_cast<const unsigned*>(a0 + 16);
            afr[mi][3] = *reinterpret_cast<const unsigned*>(a1 + 16);
          }
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const int8_t* bp = bs + (nt * 64 + ni * 8 + g) * BROW + kk + 4 * q;
            const unsigned b0 = *reinterpret_cast<const unsigned*>(bp);
            const unsigned b1 = *reinterpret_cast<const unsigned*>(bp + 16);
            mma_s8(acc[0][ni], afr[0], b0, b1);
            mma_s8(acc[1][ni], afr[1], b0, b1);
          }
        }
      }
    }
    cp_async_wait<0>();

    if (active) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = mt * 32 + mi * 16 + g + 8 * h;
          if (p >= M) continue;
          const int i = p / OW, j = p % OW;
          const int gy = gy0 + i, gx = gx0 + j;
          const bool inside = gy >= 0 && gy < vh && gx >= 0 && gx < vw;
          if (gdst && !inside) continue;
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = nt * 64 + ni * 8 + 2 * q + e;
              float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h + e]), m[n]),
                                  b[n]);
              y = y > 0.f ? y : __fmul_rn(LEAKY, y);
              if (res)
                y = __fadd_rn(y, __fmul_rn((float)res[((i + 1) * RW + j + 1) * DSTRIDE + n],
                                           res_scale));
              const int8_t v = inside ? requant(y) : (int8_t)0;
              if (gdst)
                gdst[((size_t)gy * vw + gx) * N + n] = v;
              else
                dst[p * DSTRIDE + n] = v;
            }
        }
    }
    // the next round restages the weights; the next conv reads dst
    __syncthreads();
  }
}

// Grid: (tiles of the [h, w] output, B).
__global__ void __launch_bounds__(NT) fused_entry_kernel(
    const int8_t* __restrict__ xb, const int8_t* __restrict__ w_stem,
    const float* __restrict__ m_stem, const float* __restrict__ b_stem,
    const int8_t* __restrict__ w_d0, const float* __restrict__ m_d0,
    const float* __restrict__ b_d0, const int8_t* __restrict__ w_r1,
    const float* __restrict__ m_r1, const float* __restrict__ b_r1,
    const int8_t* __restrict__ w_r2, const float* __restrict__ m_r2,
    const float* __restrict__ b_r2, const int8_t* __restrict__ w_d1,
    const float* __restrict__ m_d1, const float* __restrict__ b_d1,
    int8_t* __restrict__ out, float res_scale, int hb, int wb, int tiles_w) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* s_stem = smem;                  // stem, later res0_2
  int8_t* s_d0 = smem + STEM_BYTES;       // down0
  int8_t* s_x = s_d0 + D0_BYTES;          // xb window, later res0_1
  int8_t* bst = s_x + S2_BYTES;           // STAGES weight slots

  const int h = (hb - 2) / 2, w = (wb - 2) / 2;
  const int T = (blockIdx.x / tiles_w) * OT, U = (blockIdx.x % tiles_w) * OT;
  const int bimg = blockIdx.y;

  // xb window: global rows/cols [2T-5, 2T+20), 12 channels -> 32 (zeros)
  {
    const int8_t* img = xb + (size_t)bimg * hb * wb * CIN;
    const int y0 = 2 * T - 5, x0 = 2 * U - 5;
    for (int idx = threadIdx.x; idx < XT * XT * (XC / 4); idx += NT) {
      const int pix = idx / (XC / 4), wd = idx % (XC / 4);
      const int gy = y0 + pix / XT, gx = x0 + pix % XT;
      unsigned v = 0;
      if (wd < CIN / 4 && gy >= 0 && gy < hb && gx >= 0 && gx < wb)
        v = *reinterpret_cast<const unsigned*>(img + ((size_t)gy * wb + gx) * CIN + 4 * wd);
      *reinterpret_cast<unsigned*>(s_x + pix * (XC + SKEW) + 4 * wd) = v;
    }
  }
  __syncthreads();

  // stem: local (i, j) of the 23x23 tile at global (2T-5, 2U-5) reads xb (i+u, j+v)
  conv_tile<3, 3, 1, 128, 32>(s_x, XT, XC + SKEW, CIN, ST, ST, 2 * T - 5, 2 * U - 5, 2 * h,
                          2 * w, w_stem, m_stem, b_stem, nullptr, 0, 0.f, s_stem, nullptr,
                          bst);
  // down0: local (i, j) at global (T-2, U-2) reads stem (2i+u, 2j+v)
  conv_tile<3, 3, 2, 256, 64>(s_stem, ST, 128 + SKEW, 128, DT, DT, T - 2, U - 2, h, w, w_d0,
                          m_d0, b_d0, nullptr, 0, 0.f, s_d0, nullptr, bst);
  // res0_1: 1x1 on the same positions
  conv_tile<1, 1, 1, 128, 64>(s_d0, DT, 256 + SKEW, 256, DT, DT, T - 2, U - 2, h, w, w_r1,
                          m_r1, b_r1, nullptr, 0, 0.f, s_x, nullptr, bst);
  // res0_2: local (i, j) at global (T-1, U-1) reads res0_1 (i+u, j+v); the
  // residual is down0 at (i+1, j+1)
  conv_tile<3, 3, 1, 256, 64>(s_x, DT, 128 + SKEW, 128, RT, RT, T - 1, U - 1, h, w, w_r2,
                          m_r2, b_r2, s_d0, DT, res_scale, s_stem, nullptr, bst);
  // down1: output (i, j) at global (T, U) reads res0_2 (i+u, j+v), u, v in {0, 1}
  conv_tile<2, 2, 1, 128, 64>(s_stem, RT, 256 + SKEW, 256, OT, OT, T, U, h, w, w_d1, m_d1,
                          b_d1, nullptr, 0, 0.f, nullptr,
                          out + (size_t)bimg * h * w * 128, bst);
}

}  // namespace

extern "C" {

// Returns the launch's cudaError_t (0 on success).  xb [B, hb, wb, 12] int8;
// weights K-major int8, [cout][kh*kw*cin] (stem 128 x 108, down0 256 x 1152,
// res0_1 128 x 256, res0_2 256 x 1152, down1 128 x 1024); m, b [cout]
// float32; out [B, (hb-2)/2, (wb-2)/2, 128] int8.  Device pointers to
// contiguous arrays; runs on `stream`, does not synchronise.
int yolo_fused_entry_i8(const void* xb, const void* w_stem, const void* m_stem,
                        const void* b_stem, const void* w_d0, const void* m_d0,
                        const void* b_d0, const void* w_r1, const void* m_r1,
                        const void* b_r1, const void* w_r2, const void* m_r2,
                        const void* b_r2, const void* w_d1, const void* m_d1,
                        const void* b_d1, void* out, float res_scale, int B, int hb,
                        int wb, void* stream) {
  if (B <= 0 || B > 65535 || hb < 4 || wb < 4 || hb % 2 || wb % 2)
    return (int)cudaErrorInvalidValue;
  const int h = (hb - 2) / 2, w = (wb - 2) / 2;
  const int tiles_w = (w + OT - 1) / OT, tiles = ((h + OT - 1) / OT) * tiles_w;
  cudaError_t e = cudaFuncSetAttribute(fused_entry_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  fused_entry_kernel<<<dim3(tiles, B), NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xb), static_cast<const int8_t*>(w_stem),
      static_cast<const float*>(m_stem), static_cast<const float*>(b_stem),
      static_cast<const int8_t*>(w_d0), static_cast<const float*>(m_d0),
      static_cast<const float*>(b_d0), static_cast<const int8_t*>(w_r1),
      static_cast<const float*>(m_r1), static_cast<const float*>(b_r1),
      static_cast<const int8_t*>(w_r2), static_cast<const float*>(m_r2),
      static_cast<const float*>(b_r2), static_cast<const int8_t*>(w_d1),
      static_cast<const float*>(m_d1), static_cast<const float*>(b_d1),
      static_cast<int8_t*>(out), res_scale, hb, wb, tiles_w);
  return (int)cudaGetLastError();
}

const char* yolo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
