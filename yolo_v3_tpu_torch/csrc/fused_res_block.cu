// Fused Darknet residual block for Hopper (sm_90a):
//
//     out = y + round(leaky(conv3x3(mid) + b2)),   mid = round(leaky(y @ w1 + b1))
//
// with SAME padding, LeakyReLU(0.1), fp32 accumulation and round() = a cast to
// the storage type (float or bf16).  Replaces the TPU Pallas kernel
// yolo_v3_tpu/ops/pallas_kernels.py::fused_res_block (_res_block_kernel).
//
// Semantics kept from the reference (the XLA chain darknet._conv_bias_leaky):
//   * mid is rounded to the storage type after the leaky; conv2's result is
//     rounded after its leaky and only then added to y, in the storage type;
//   * the 3x3's zero padding applies to conv1's OUTPUT: mid is 0 (not
//     leaky(b1)) at every halo position outside the image, rows and columns;
//   * any H and W (13, 26, 52 at 416 and 19 at 608 are not tile multiples):
//     ragged tiles are masked here, with no channel padding in device memory.
//
// What bounds it on the H100.  Per output pixel the block does ~5C^2 MACs
// (C^2/2 for conv1, 9*C^2/2 for conv2) against 2C values of y/out traffic.
// At stage 4 (13x13, C=1024) that is ~2,500 MACs per byte moved: compute
// bound.  At stage 0 (208x208, C=64) it is ~160 MACs per bf16 byte, below
// the card's ~295 FLOP/byte balance point, and the activations are the
// largest of the network (5.5 MB per image in bf16): bandwidth bound unless
// mid never reaches device memory.
//
// What the design does about it.  One block owns an 8x8 output tile.  It
// computes mid for the whole 10x10 halo window and every mid channel once,
// keeps it in shared memory, and then runs conv2 over its share of the output
// channels from there.  mid never touches device memory, y is read once for
// conv1 (plus a 1-pixel halo) and once for the residual, and out is written
// once: the block's traffic is the 2 tensors the fused op must move.  Where
// the spatial grid is small against the card (stage 4 at batch 8), the output
// channels are split over several blocks of the same tile, which then
// recompute conv1 rather than leave SMs idle; the host picks the split that
// minimises waves x per-block work for the grid and occupancy it observes.
// For bf16 both convs run on tensor cores (mma.sync m16n8k16, fp32
// accumulate): conv1 as a [112 halo pixels x C] @ [C x Cmid] GEMM, conv2 as 9
// tap GEMMs whose A rows are gathered from the shifted halo window by
// ldmatrix row addresses, so the 3x3 needs no im2col copy; y and weight rows
// are staged with double-buffered cp.async, so one step's loads overlap the
// previous step's MMAs.  fp32 runs register-tiled FMA loops (4x4 outputs per
// thread): tensor cores would change fp32 results (TF32).  wgmma with a TMA
// halo window is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TH = 8;               // output tile rows
constexpr int TW = 8;               // output tile columns
constexpr int HWIN = TW + 2;        // halo window width
constexpr int HP = (TH + 2) * HWIN; // halo window pixels (100)
constexpr int NT = 256;             // threads per block
constexpr float LEAKY = 0.1f;

__device__ __forceinline__ float leaky(float x) { return x > 0.f ? x : LEAKY * x; }

// ---------------------------------------------------------------------------
// fp32: FMA loops
// ---------------------------------------------------------------------------

constexpr int MC = 64;              // mid channels per conv1 pass
constexpr int KC = 16;              // input channels per conv1 step
constexpr int CO = 64;              // output channels per conv2 pass
constexpr int KM = 8;               // mid channels per conv2 step
constexpr int P1_ROWS = (HP + 15) / 16;  // halo pixels per thread in conv1 (7)

// y, out: [B, H, W, C]; w1: [C, Cmid]; w2: [3, 3, Cmid, C] (HWIO); b1: [Cmid];
// b2: [C].  Grid: (tiles_h * tiles_w, output-channel splits, B).
__global__ void __launch_bounds__(NT) res_block_f32_kernel(
    const float* __restrict__ y, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ out,
    int H, int W, int C, int Cmid, int Mpad, int tiles_w, int co_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ms = Mpad + 4;  // mid row stride; the +4 skews rows across banks
  float* mid = reinterpret_cast<float*>(smem);
  float* stage = mid + HP * ms;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const size_t img = (size_t)b * H * W * C;

  // ---- conv1 on the halo window: mid[p][m] for every mid channel ---------
  {
    float* ys = stage;             // [HP][KC]
    float* ws = stage + HP * KC;   // [KC][MC]
    const int mg = tid % 16;       // mid channels mg*4 .. mg*4+3 of the pass
    const int pg = tid / 16;       // halo pixels pg + 16*j
    for (int m0 = 0; m0 < Mpad; m0 += MC) {
      float acc[P1_ROWS][4];
#pragma unroll
      for (int j = 0; j < P1_ROWS; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

      for (int k0 = 0; k0 < C; k0 += KC) {
        for (int i = tid; i < HP * KC; i += NT) {
          const int p = i / KC, k = i % KC;
          const int gy = ty0 - 1 + p / HWIN, gx = tx0 - 1 + p % HWIN;
          float v = 0.f;
          if (gy >= 0 && gy < H && gx >= 0 && gx < W && k0 + k < C)
            v = y[img + ((size_t)gy * W + gx) * C + k0 + k];
          ys[i] = v;
        }
        for (int i = tid; i < KC * MC; i += NT) {
          const int k = i / MC, m = i % MC;
          ws[i] = (k0 + k < C && m0 + m < Cmid) ? w1[(size_t)(k0 + k) * Cmid + m0 + m]
                                                : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < KC; ++k) {
          const float4 wv = *reinterpret_cast<const float4*>(ws + k * MC + mg * 4);
#pragma unroll
          for (int j = 0; j < P1_ROWS; ++j) {
            const int p = pg + 16 * j;
            const float a = p < HP ? ys[p * KC + k] : 0.f;
            acc[j][0] += a * wv.x;
            acc[j][1] += a * wv.y;
            acc[j][2] += a * wv.z;
            acc[j][3] += a * wv.w;
          }
        }
        __syncthreads();
      }

#pragma unroll
      for (int j = 0; j < P1_ROWS; ++j) {
        const int p = pg + 16 * j;
        if (p >= HP) continue;
        const int gy = ty0 - 1 + p / HWIN, gx = tx0 - 1 + p % HWIN;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = m0 + mg * 4 + c;
          float v = 0.f;  // the 3x3's zero padding, and the padded channels
          if (inside && m < Cmid) v = leaky(acc[j][c] + b1[m]);
          mid[p * ms + m] = v;
        }
      }
    }
  }
  __syncthreads();

  // ---- conv2 from shared mid, + b2, leaky, + y ----------------------------
  {
    float* ws = stage;             // [9][KM][CO]
    const int cg = tid % 16;       // output channels cg*4 .. cg*4+3 of the pass
    const int pg = tid / 16;       // output pixels: row pg/2, columns px0..px0+3
    const int py = pg / 2, px0 = (pg % 2) * 4;
    const int co_begin = blockIdx.y * co_per_block;
    const int co_end = min(C, co_begin + co_per_block);
    for (int c0 = co_begin; c0 < co_end; c0 += CO) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

      for (int k0 = 0; k0 < Mpad; k0 += KM) {
        for (int i = tid; i < 9 * KM * CO; i += NT) {
          const int t = i / (KM * CO), r = i % (KM * CO);
          const int k = r / CO, c = r % CO;
          ws[i] = (k0 + k < Cmid && c0 + c < co_end)
                      ? w2[((size_t)t * Cmid + k0 + k) * C + c0 + c] : 0.f;
        }
        __syncthreads();
#pragma unroll 1
        for (int t = 0; t < 9; ++t) {
          const float* mrow = mid + ((py + t / 3) * HWIN + px0 + t % 3) * ms + k0;
#pragma unroll
          for (int k = 0; k < KM; ++k) {
            const float4 wv =
                *reinterpret_cast<const float4*>(ws + (t * KM + k) * CO + cg * 4);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float a = mrow[j * ms + k];
              acc[j][0] += a * wv.x;
              acc[j][1] += a * wv.y;
              acc[j][2] += a * wv.z;
              acc[j][3] += a * wv.w;
            }
          }
        }
        __syncthreads();
      }

      const int gy = ty0 + py;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gx = tx0 + px0 + j;
        if (gy >= H || gx >= W) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int co = c0 + cg * 4 + c;
          if (co >= co_end) continue;
          const size_t o = img + ((size_t)gy * W + gx) * C + co;
          out[o] = y[o] + leaky(acc[j][c] + b2[co]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulate)
// ---------------------------------------------------------------------------

constexpr int SKEW = 8;   // bf16 row padding (16 bytes): ldmatrix rows hit distinct banks
constexpr int M1 = 112;   // halo pixels padded to 7 m16 tiles
constexpr int K1 = 32;    // input channels per conv1 step
constexpr int N1 = 128;   // mid channels per conv1 pass: 8 warps x 16
constexpr int K2 = 16;    // mid channels per conv2 step
constexpr int N2 = 128;   // output channels per conv2 pass: 4 warp columns x 32
constexpr int MGRAN = 32; // mid channels are padded (in shared memory only) to this

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage the first n (any int) of 8 bf16 from global `src` into shared `dst`,
// zero-filling the rest.  A 16-byte-aligned run goes through one cp.async
// (landed after the next cp_async_wait); otherwise element by element.
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src, int n, bool vec) {
  if (vec) {
    const int bytes = n >= 8 ? 16 : (n > 0 ? 2 * n : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = i < n ? src[i] : __float2bfloat16_rn(0.f);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` committed groups are still in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(pending));
}

// Shared staging: two buffers (double-buffered cp.async), each holding one
// conv1 step (y rows + w1 rows) or one conv2 step (w2 rows of 9 taps).
constexpr int STAGE1 = M1 * (K1 + SKEW) + K1 * (N1 + SKEW);
constexpr int STAGE2 = 9 * K2 * (N2 + SKEW);
constexpr int STAGE = STAGE1 > STAGE2 ? STAGE1 : STAGE2;

// Same operands and grid as res_block_f32_kernel; Mpad = Cmid rounded up to
// MGRAN, co_per_block a multiple of N2.  Global loads of step s+1 are in
// flight (cp.async) while the tensor cores work on step s.
__global__ void __launch_bounds__(NT) res_block_bf16_kernel(
    const bf16* __restrict__ y, const bf16* __restrict__ w1,
    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
    const bf16* __restrict__ b2, bf16* __restrict__ out,
    int H, int W, int C, int Cmid, int Mpad, int tiles_w, int co_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ms = Mpad + SKEW;
  bf16* mid = reinterpret_cast<bf16*>(smem);   // [HP][ms]
  bf16* stage = mid + HP * ms;                 // [2][STAGE]; HP * ms is a multiple of 8

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;                // mma fragment row, column pair
  const int lrow = lane % 16, lcol = (lane / 16) * 8;  // this lane's ldmatrix row, column
  const int b = blockIdx.z;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const size_t img = (size_t)b * H * W * C;
  const bool c_vec = C % 8 == 0, m_vec = Cmid % 8 == 0;

  // ---- conv1: mid[112 x Mpad] = y_halo[112 x C] @ w1[C x Mpad] ------------
  {
    constexpr int YS = K1 + SKEW, WS = N1 + SKEW;
    // step buffer: ys [M1][YS] (y halo rows), then ws [K1][WS] (w1 rows)
    auto load = [&](int n0, int k0, bf16* ys) {
      bf16* ws = ys + M1 * YS;
      for (int i = tid; i < M1 * (K1 / 8); i += NT) {
        const int p = i / (K1 / 8), kk = (i % (K1 / 8)) * 8;
        const int gy = ty0 - 1 + p / HWIN, gx = tx0 - 1 + p % HWIN;
        const bool in = p < HP && gy >= 0 && gy < H && gx >= 0 && gx < W;
        const bf16* src = in ? y + img + ((size_t)gy * W + gx) * C + k0 + kk : y;
        stage8(ys + p * YS + kk, src, in ? C - k0 - kk : 0, c_vec);
      }
      for (int i = tid; i < K1 * (N1 / 8); i += NT) {
        const int k = i / (N1 / 8), nn = (i % (N1 / 8)) * 8;
        const bool in = k0 + k < C;
        const bf16* src = in ? w1 + (size_t)(k0 + k) * Cmid + n0 + nn : w1;
        stage8(ws + k * WS + nn, src, in ? Cmid - n0 - nn : 0, m_vec);
      }
      cp_async_commit();
    };
    for (int n0 = 0; n0 < Mpad; n0 += N1) {
      const int wn = n0 + warp * 16;        // this warp's 16 mid channels
      const bool active = wn < Mpad;
      float acc[7][2][4] = {};
      load(n0, 0, stage);
      for (int k0 = 0, s = 0; k0 < C; k0 += K1, ++s) {
        const bf16* ys = stage + (s & 1) * STAGE;
        const bf16* ws = ys + M1 * YS;
        if (k0 + K1 < C) {
          load(n0, k0 + K1, stage + ((s + 1) & 1) * STAGE);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (active) {
#pragma unroll
          for (int kk = 0; kk < K1; kk += 16) {
            unsigned bfr[4];
            ldsm_x4_trans(bfr, ws + (kk + lrow) * WS + warp * 16 + lcol);
#pragma unroll
            for (int mi = 0; mi < 7; ++mi) {
              unsigned afr[4];
              ldsm_x4(afr, ys + (mi * 16 + lrow) * YS + kk + lcol);
              mma(acc[mi][0], afr, bfr[0], bfr[1]);
              mma(acc[mi][1], afr, bfr[2], bfr[3]);
            }
          }
        }
        __syncthreads();
      }
      if (active) {
#pragma unroll
        for (int mi = 0; mi < 7; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = mi * 16 + g + 8 * h;
            if (p >= HP) continue;
            const int gy = ty0 - 1 + p / HWIN, gx = tx0 - 1 + p % HWIN;
            const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
            for (int nj = 0; nj < 2; ++nj) {
              const int n = wn + nj * 8 + 2 * q;
              // 0 outside the image (the 3x3's zero padding) and in padded channels
              const float v0 = inside && n < Cmid
                                   ? leaky(acc[mi][nj][2 * h] + __bfloat162float(b1[n])) : 0.f;
              const float v1 = inside && n + 1 < Cmid
                                   ? leaky(acc[mi][nj][2 * h + 1] + __bfloat162float(b1[n + 1]))
                                   : 0.f;
              *reinterpret_cast<__nv_bfloat162*>(mid + p * ms + n) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
      }
    }
  }
  __syncthreads();

  // ---- conv2: 9 tap GEMMs [64 x Mpad] @ [Mpad x N2] from shared mid --------
  {
    constexpr int WS = N2 + SKEW;
    // step buffer: ws [9][K2][WS] (w2 rows of all 9 taps)
    auto load = [&](int c0, int co_end, int k0, bf16* ws) {
      for (int i = tid; i < 9 * K2 * (N2 / 8); i += NT) {
        const int t = i / (K2 * (N2 / 8)), r = i % (K2 * (N2 / 8));
        const int k = r / (N2 / 8), nn = (r % (N2 / 8)) * 8;
        const bool in = k0 + k < Cmid;
        const bf16* src = in ? w2 + ((size_t)t * Cmid + k0 + k) * C + c0 + nn : w2;
        stage8(ws + (t * K2 + k) * WS + nn, src, in ? co_end - c0 - nn : 0, c_vec);
      }
      cp_async_commit();
    };
    const int wm = warp / 4, wn = warp % 4;    // warp tile: 32 pixels x 32 channels
    int hrow[2];                               // halo row of this lane's A rows, tap (0,0)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int p = wm * 32 + mi * 16 + lrow;
      hrow[mi] = (p / TW) * HWIN + p % TW;
    }
    const int co_begin = blockIdx.y * co_per_block;
    const int co_end = min(C, co_begin + co_per_block);
    for (int c0 = co_begin; c0 < co_end; c0 += N2) {
      const bool active = c0 + wn * 32 < co_end;
      float acc[2][4][4] = {};
      load(c0, co_end, 0, stage);
      for (int k0 = 0, s = 0; k0 < Mpad; k0 += K2, ++s) {
        const bf16* ws = stage + (s & 1) * STAGE;
        if (k0 + K2 < Mpad) {
          load(c0, co_end, k0 + K2, stage + ((s + 1) & 1) * STAGE);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (active) {
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            const int toff = (t / 3) * HWIN + t % 3;
            unsigned bfr[2][4];
            ldsm_x4_trans(bfr[0], ws + (t * K2 + lrow) * WS + wn * 32 + lcol);
            ldsm_x4_trans(bfr[1], ws + (t * K2 + lrow) * WS + wn * 32 + 16 + lcol);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              unsigned afr[4];
              ldsm_x4(afr, mid + (hrow[mi] + toff) * ms + k0 + lcol);
              mma(acc[mi][0], afr, bfr[0][0], bfr[0][1]);
              mma(acc[mi][1], afr, bfr[0][2], bfr[0][3]);
              mma(acc[mi][2], afr, bfr[1][0], bfr[1][1]);
              mma(acc[mi][3], afr, bfr[1][2], bfr[1][3]);
            }
          }
        }
        __syncthreads();
      }
      if (active) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = wm * 32 + mi * 16 + g + 8 * h;
            const int gy = ty0 + p / TW, gx = tx0 + p % TW;
            if (gy >= H || gx >= W) continue;
            const size_t row = img + ((size_t)gy * W + gx) * C;
#pragma unroll
            for (int nj = 0; nj < 4; ++nj)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int co = c0 + wn * 32 + nj * 8 + 2 * q + e;
                if (co >= co_end) continue;
                const bf16 r = __float2bfloat16_rn(
                    leaky(acc[mi][nj][2 * h + e] + __bfloat162float(b2[co])));
                out[row + co] = __float2bfloat16_rn(__bfloat162float(y[row + co]) +
                                                    __bfloat162float(r));
              }
          }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, typename Kernel>
int launch(Kernel kernel, const void* y, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, int B, int H, int W, int C,
           int Cmid, int Mpad, size_t smem, int co_chunk, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cmid <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;

  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;

  // Split each tile's output channels over `s` blocks, each of which
  // recomputes conv1: pick the s that minimises (waves of blocks on the SMs)
  // x (one block's MACs).  Small grids (13x13, 26x26 at batch 8) split;
  // grids that already fill the card do not.
  const int tiles_w = ceil_div(W, TW), tiles = ceil_div(H, TH) * tiles_w;
  const int chunks = ceil_div(C, co_chunk);
  const double conv1 = (double)HP * C * Mpad, conv2_chunk = 64.0 * 9 * Mpad * co_chunk;
  int co_per_block = chunks * co_chunk;
  double best = -1;
  for (int s = 1; s <= chunks; ++s) {
    const int per_block = ceil_div(chunks, s);
    const long blocks = (long)tiles * B * ceil_div(chunks, per_block);
    const double cost = (double)((blocks + (long)sms * per_sm - 1) / ((long)sms * per_sm)) *
                        (conv1 + conv2_chunk * per_block);
    if (best < 0 || cost < best) {
      best = cost;
      co_per_block = per_block * co_chunk;
    }
  }
  const dim3 grid(tiles, ceil_div(C, co_per_block), B);

  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out),
      H, W, C, Cmid, Mpad, tiles_w, co_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the launch's cudaError_t (0 on success).  All pointers are
// device pointers to contiguous arrays; the kernel runs on `stream` and does
// not synchronise.
int yolo_fused_res_block_f32(const void* y, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out, int B,
                             int H, int W, int C, int Cmid, void* stream) {
  const int Mpad = ceil_div(Cmid, MC) * MC;
  const int p1 = HP * KC + KC * MC, p2 = 9 * KM * CO;
  const size_t smem = ((size_t)HP * (Mpad + 4) + (p1 > p2 ? p1 : p2)) * sizeof(float);
  return launch<float>(res_block_f32_kernel, y, w1, b1, w2, b2, out, B, H, W, C,
                       Cmid, Mpad, smem, CO, stream);
}

int yolo_fused_res_block_bf16(const void* y, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* out, int B,
                              int H, int W, int C, int Cmid, void* stream) {
  const int Mpad = ceil_div(Cmid, MGRAN) * MGRAN;
  const size_t smem = ((size_t)HP * (Mpad + SKEW) + 2 * STAGE) * sizeof(bf16);
  return launch<bf16>(res_block_bf16_kernel, y, w1, b1, w2, b2, out, B, H, W, C,
                      Cmid, Mpad, smem, N2, stream);
}

const char* yolo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
