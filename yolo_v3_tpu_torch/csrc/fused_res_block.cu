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
// In fp32 the card is compute-bound at every shape: one YOLOv3-416 forward at
// batch 8 does 326 GFLOP in its 23 blocks, 1.98 ms of tensor-core work at
// 495 TFLOP/s when each product is taken as 3 TF32 products (below), against
// 0.32 ms to move y, out and the weights once at 3.35 TB/s.
//
// What the design does about it.  One block owns an 8x8 output tile.  mid is
// computed for the whole 10x10 halo window, kept in shared memory, and conv2
// runs over the block's share of the output channels from there.  mid never
// touches device memory, y is read once for conv1 (plus a 1-pixel halo) and
// once for the residual, and out is written once: the block's traffic is the
// 2 tensors the fused op must move.  Both convs run on tensor cores: conv1 as
// a [112 halo pixels x C] @ [C x Cmid] GEMM, conv2 as 9 tap GEMMs whose A
// rows are gathered from the shifted halo window by address, so the 3x3
// needs no im2col copy.
//
// bf16 (mma.sync m16n8k16, fp32 accumulate): y and weight rows are staged
// with double-buffered cp.async.  Where the spatial grid is small against the
// card (stage 4 at batch 8), the output channels are split over several
// blocks of the same tile, which recompute conv1 rather than leave SMs idle;
// the host picks the split that minimises waves x per-block work.
//
// fp32 (mma.sync m16n8k8 TF32, 3xTF32): one TF32 product keeps 10 mantissa
// bits and would miss fp32's results by ~5e-4 at K = 4608, so every operand
// x is split as hi = tf32(x), lo = tf32(x - hi), and each product is taken as
// lo*hi + hi*lo + hi*hi (the lo*lo term is below fp32's rounding).  The
// tensor cores' own fp32 accumulation truncates, so each pipeline step sums
// into a fresh partial and the partials are added in plain fp32.  The
// weights arrive split, K-major and interleaved from the host, so one
// 16-byte shared load is a B fragment's hi and lo.  y is split in registers;
// mid is split once per 32-channel chunk into a buffer laid out the same
// way, so conv2's A fragments are plain 16-byte loads.  Weights stream
// through cp.async rings (conv1 and conv2 share one region).  Where the grid
// is small, the output channels are split over a thread-block cluster of up
// to 8 blocks of the same tile, and conv1 is split with them: block j
// computes only its slice of mid channels, and conv2 reads the other slices
// from the peers' shared memory (distributed shared memory), a chunk at a
// time, loaded into registers one chunk ahead.  conv1 is done once per tile,
// and each block's mid shrinks by the cluster size.  What bounds it now is
// the mma.sync issue and the shared-memory traffic of its fragments, not the
// card's bytes (PERF.md).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

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

// y, out: [B, H, W, C]; w1: [C, Cmid]; w2: [3, 3, Cmid, C] (HWIO); b1: [Cmid];
// b2: [C].  Grid: (tiles_h * tiles_w, output-channel splits, B).  Mpad =
// Cmid rounded up to MGRAN, co_per_block a multiple of N2.  Global loads of
// step s+1 are in flight (cp.async) while the tensor cores work on step s.
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
// fp32: 3xTF32 on tensor cores (mma.sync m16n8k8), conv1 shared in a cluster
// ---------------------------------------------------------------------------

constexpr int FK1 = 32;           // input channels per conv1 step
constexpr int FN1 = 64;           // mid channels per conv1 pass: 8 n8 tiles per warp
constexpr int FK2 = 32;           // mid channels per conv2 step (one tap of one chunk)
constexpr int FMGRAN = 32;        // mid channels are padded to this (weights, shared memory)
constexpr int FNS1 = 2;           // depth of conv1's cp.async ring
constexpr int FNS2 = 2;           // depth of conv2's cp.async ring
// Row strides (floats).  y rows are read 4 bytes a lane: 20 = 4 mod 32 puts
// 8 rows x 4 columns on 32 banks.  Split rows (weights, and the current mid
// chunk) hold hi and lo interleaved, 2K values, read 16 bytes a lane, a
// quarter warp (2 rows) at a time: 16 mod 32.
constexpr int FYS = FK1 + 4;
constexpr int FB1S = 2 * FK1 + 16;
constexpr int FB2S = 2 * FK2 + 16;
constexpr int FAS = 2 * FK2 + 16;
constexpr int FMSKEW = 4;         // mid row padding
constexpr int FSTAGE1 = HP * FYS + FN1 * FB1S;  // a conv1 step: y rows, w1 rows
constexpr int FCHUNK = HP * FAS;  // the current mid chunk, split
// conv2 runs in one of two shapes, chosen on the host by C: NI = 2 n8 tiles
// per warp (a 32 x 16 warp tile, 64 channels a pass, 2 blocks per SM) or
// NI = 4 (32 x 32, 128 channels a pass, 1 block per SM with the registers
// that allows: fewer shared loads and barriers per MMA).
// channels per conv2 pass, and a conv2 step (w2 rows)
__host__ __device__ constexpr int f32_n2(int NI) { return 32 * NI; }
__host__ __device__ constexpr int f32_stage2(int NI) { return f32_n2(NI) * FB2S; }
// conv1's ring, then conv2's ring and chunk, in one region after mid
__host__ __device__ constexpr int f32_region(int NI) {
  return FNS1 * FSTAGE1 > FNS2 * f32_stage2(NI) + FCHUNK ? FNS1 * FSTAGE1
                                                           : FNS2 * f32_stage2(NI) + FCHUNK;
}
constexpr int FGROUPS = HP * (FK2 / 8);               // 8-channel groups of a chunk
constexpr int FPRE = (FGROUPS + NT - 1) / NT;         // ... per thread
constexpr int MAX_CLUSTER = 8;    // the portable cluster size

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo within ~2^-22 |x|, both TF32 (ops/fused_res_block.py::split_tf32
// makes the weights' parts the same way).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a @ b in 3xTF32: the two cross terms first, the large term last.
// b: hi(k = q), lo(k = q), hi(k = q + 4), lo(k = q + 4), one 16-byte load.
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], const float4& b) {
  const unsigned bh0 = __float_as_uint(b.x), bl0 = __float_as_uint(b.y);
  const unsigned bh1 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// The tensor cores add into their fp32 accumulator without rounding to
// nearest, which over K = 4608 drifts ~30x past an fp32 sum.  So each ring
// step's products go into a fresh partial sum, and the partials are added
// in plain fp32.
template <int N>
__device__ __forceinline__ void add_partials(float (&acc)[N][4], float (&part)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[i][e] += part[i][e];
      part[i][e] = 0.f;
    }
}

// Split 8 consecutive mid channels (lo4: channels 0-3, hi4: 4-7) and store
// them interleaved as an A fragment wants them: for column q < 4, hi(q),
// lo(q), hi(q + 4), lo(q + 4).
__device__ __forceinline__ void store_split8(float* dst, const float4& lo4, const float4& hi4) {
  const float a[4] = {lo4.x, lo4.y, lo4.z, lo4.w}, b[4] = {hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned h0, l0, h1, l1;
    split_tf32(a[q], h0, l0);
    split_tf32(b[q], h1, l1);
    *reinterpret_cast<float4*>(dst + 4 * q) = make_float4(
        __uint_as_float(h0), __uint_as_float(l0), __uint_as_float(h1), __uint_as_float(l1));
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

// Stage the first n (any int) of 4 floats from global `src` into shared
// `dst`, zero-filling the rest: one cp.async where the run is 16-byte
// aligned, else element by element.
__device__ __forceinline__ void stage4(float* dst, const float* src, int n, bool vec) {
  if (vec) {
    cp_async16(dst, src, n >= 4 ? 16 : (n > 0 ? 4 * n : 0));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i] = i < n ? src[i] : 0.f;
  }
}

// Run `steps` steps through an NS-slot ring of SLOT floats: load(s, slot)
// issues step s's cp.async copies, compute(s, slot) consumes them.  Loads
// run NS - 1 steps ahead; one barrier per step.  Returns with the ring idle.
template <int NS, int SLOT, typename Load, typename Compute>
__device__ __forceinline__ void ring_pipeline(int steps, float* ring, Load load,
                                              Compute compute) {
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < steps) load(s, ring + s * SLOT);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<NS - 2>();  // step s has landed
    __syncthreads();          // ... for every thread; slot (s - 1) is free
    const int next = s + NS - 1;
    if (next < steps) load(next, ring + (next % NS) * SLOT);
    cp_async_commit();
    compute(s, ring + (s % NS) * SLOT);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// y, out: [B, H, W, C]; b1: [Cmid]; b2: [C].  The weights come split into
// TF32 hi and lo parts, zero-padded, K-major and interleaved in groups of 8
// K (ops/fused_res_block.py::tf32_weights): w1s [Mpad][2 * Cp] (Cp = C
// rounded up to FK1), w2s [C][9][2 * Mpad] (Mpad = Cmid rounded up to
// FMGRAN).  Grid: (tiles_h * tiles_w, cs, B) in clusters of (1, cs, 1), the
// cs blocks of one tile.  Block rank j computes mid channels
// [j*MS, (j+1)*MS) of the tile's halo window and output channels
// [j*co_per_block, (j+1)*co_per_block); MS is a multiple of FK2.
template <int NI>
__global__ void __launch_bounds__(NT, NI == 2 ? 2 : 1) res_block_f32_kernel(
    const float* __restrict__ y, const float* __restrict__ w1s,
    const float* __restrict__ b1, const float* __restrict__ w2s,
    const float* __restrict__ b2, float* __restrict__ out, int H, int W, int C,
    int Cmid, int Mpad, int Cp, int MS, int tiles_w, int co_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ms = MS + FMSKEW;
  float* mid = reinterpret_cast<float*>(smem);  // [HP][ms]: this block's mid channels
  constexpr int FN2 = f32_n2(NI), FSTAGE2 = f32_stage2(NI);
  float* ring = mid + HP * ms;                  // conv1: [FNS1][FSTAGE1]; conv2: [FNS2][FSTAGE2]
  float* chunk = ring + FNS2 * FSTAGE2;         // conv2: [HP][FAS], the current chunk split

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;         // mma fragment row, column
  const int b = blockIdx.z;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const size_t img = (size_t)b * H * W * C;
  const int rank = (int)cluster.block_rank();
  const int m_lo = rank * MS;                   // this block's first mid channel
  const int nm = max(0, min(MS, Mpad - m_lo));  // ... and how many it holds

  // ---- conv1: mid[100 x nm] = y_halo[100 x C] @ w1[C x (m_lo .. m_lo + nm)] --
  // Warp w < 7 owns m16 tile w (the 7 cover the 100 halo pixels) and all
  // FN1 mid channels of the pass, so each y value is split once per warp.
  {
    const bool c_vec = C % 4 == 0;
    const int r0 = warp * 16 + g, r1 = r0 + 8;  // this lane's halo pixels
    for (int n0 = 0; n0 < nm; n0 += FN1) {
      float acc[FN1 / 8][4] = {}, part[FN1 / 8][4] = {};
      auto load = [&](int s, float* st) {  // st: y [HP][FYS], w1 [FN1][FB1S]
        const int k0 = s * FK1;
        float* ws = st + HP * FYS;
        for (int i = tid; i < HP * (FK1 / 4); i += NT) {
          const int p = i / (FK1 / 4), kk = (i % (FK1 / 4)) * 4;
          const int gy = ty0 - 1 + p / HWIN, gx = tx0 - 1 + p % HWIN;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
          const float* src = in ? y + img + ((size_t)gy * W + gx) * C + k0 + kk : y;
          stage4(st + p * FYS + kk, src, in ? C - k0 - kk : 0, c_vec);
        }
        for (int i = tid; i < FN1 * (FK1 / 2); i += NT) {
          const int r = i / (FK1 / 2), kk = (i % (FK1 / 2)) * 4;
          const bool in = n0 + r < nm;
          const size_t off = in ? (size_t)(m_lo + n0 + r) * 2 * Cp + 2 * k0 + kk : 0;
          cp_async16(ws + r * FB1S + kk, w1s + off, in ? 16 : 0);
        }
      };
      auto compute = [&](int, const float* st) {
        if (warp >= 7) return;
        const float* ws = st + HP * FYS + g * FB1S + 4 * q;
#pragma unroll
        for (int kk = 0; kk < FK1; kk += 8) {
          const float* x0 = st + r0 * FYS + kk + q;
          const float* x1 = st + r1 * FYS + kk + q;
          unsigned ah[4], al[4];
          split_tf32(r0 < HP ? x0[0] : 0.f, ah[0], al[0]);
          split_tf32(r1 < HP ? x1[0] : 0.f, ah[1], al[1]);
          split_tf32(r0 < HP ? x0[4] : 0.f, ah[2], al[2]);
          split_tf32(r1 < HP ? x1[4] : 0.f, ah[3], al[3]);
#pragma unroll
          for (int ni = 0; ni < FN1 / 8; ++ni)
            if (n0 + ni * 8 < nm)
              mma3(part[ni], ah, al,
                   *reinterpret_cast<const float4*>(ws + ni * 8 * FB1S + 2 * kk));
        }
        add_partials(acc, part);
      };
      ring_pipeline<FNS1, FSTAGE1>((C + FK1 - 1) / FK1, ring, load, compute);
      if (warp < 7) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = h ? r1 : r0;
          if (p >= HP) continue;
          const int gy = ty0 - 1 + p / HWIN, gx = tx0 - 1 + p % HWIN;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int ni = 0; ni < FN1 / 8; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = n0 + ni * 8 + 2 * q + e;  // local mid channel
              const int m = m_lo + n;
              // 0 outside the image (the 3x3's zero padding) and in padded channels
              if (n < nm)
                mid[p * ms + n] = inside && m < Cmid ? leaky(acc[ni][2 * h + e] + b1[m]) : 0.f;
            }
        }
      }
    }
  }
  cluster.sync();  // every block's mid slice is complete and visible to its peers

  // ---- conv2: 9 tap GEMMs [64 x Mpad] @ [Mpad x co] over the cluster's mid --
  // Warp tile: 32 pixels x 8*NI output channels.  Step s is tap s % 9 of mid
  // chunk s / 9 (FK2 channels).  Before a chunk's first tap it is split once
  // into `chunk`, from this block's mid or, for a chunk a peer holds, from
  // registers loaded one chunk ahead out of the peer's shared memory
  // (distributed shared memory, generic loads).
  {
    const int wm = warp / 4, wn = warp % 4;     // warp row, warp column
    int hrow[2];  // halo row of this lane's A row g, tap (0,0); row g + 8 is HWIN further
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int p = wm * 32 + mi * 16 + g;
      hrow[mi] = (p / TW) * HWIN + p % TW;
    }
    const int per_rank = MS / FK2;  // mid chunks held by each block
    const int nchunks = Mpad / FK2;
    const int co_begin = blockIdx.y * co_per_block;
    const int co_end = min(C, co_begin + co_per_block);
    float4 pre[FPRE][2];  // this thread's 8-channel groups of the next chunk
    auto gather = [&](const float* src) {  // src: the chunk's first channel, row stride ms
#pragma unroll
      for (int j = 0; j < FPRE; ++j) {
        const int i = tid + j * NT;
        if (i < FGROUPS) {
          const float* at = src + (i / (FK2 / 8)) * ms + (i % (FK2 / 8)) * 8;
          pre[j][0] = *reinterpret_cast<const float4*>(at);
          pre[j][1] = *reinterpret_cast<const float4*>(at + 4);
        }
      }
    };
    auto fetch = [&](int kc) {  // issue the loads of chunk kc if a peer holds it
      const int owner = kc / per_rank;
      if (owner != rank)
        gather(cluster.map_shared_rank(mid, owner) + (kc % per_rank) * FK2);
    };
    for (int c0 = co_begin; c0 < co_end; c0 += FN2) {
      const bool active = c0 + wn * 8 * NI < co_end;
      float acc[2 * NI][4] = {}, part[2 * NI][4] = {};  // [mi * NI + ni]
      auto load = [&](int s, float* st) {  // st: w2 [FN2][FB2S]
        const int kc = s / 9, t = s % 9;
        const int koff = t * 2 * Mpad + 2 * kc * FK2;
#pragma unroll
        for (int j = 0; j < FN2 * (FK2 / 2) / NT; ++j) {
          const int i = tid + j * NT;
          const int r = i / (FK2 / 2), kk = (i % (FK2 / 2)) * 4;
          const bool in = c0 + r < co_end;
          cp_async16(st + r * FB2S + kk, in ? w2s + (c0 + r) * 18 * Mpad + koff + kk : w2s,
                     in ? 16 : 0);
        }
      };
      auto compute = [&](int s, const float* st) {
        const int kc = s / 9, t = s % 9;
        if (t == 0) {  // every warp is past the last chunk's taps
          if (kc / per_rank == rank) gather(mid + (kc % per_rank) * FK2);
#pragma unroll
          for (int j = 0; j < FPRE; ++j) {
            const int i = tid + j * NT;
            if (i < FGROUPS)
              store_split8(chunk + (i / (FK2 / 8)) * FAS + (i % (FK2 / 8)) * 16,
                           pre[j][0], pre[j][1]);
          }
          __syncthreads();
          if (kc + 1 < nchunks) fetch(kc + 1);
        }
        if (!active) return;
        const float* ws = st + (wn * 8 * NI + g) * FB2S + 4 * q;
        const float* as = chunk + ((t / 3) * HWIN + t % 3) * FAS + 4 * q;
#pragma unroll
        for (int kk = 0; kk < FK2; kk += 8) {
          float4 bv[NI];
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            bv[ni] = *reinterpret_cast<const float4*>(ws + ni * 8 * FB2S + 2 * kk);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const float* x = as + hrow[mi] * FAS + 2 * kk;
            const float4 v0 = *reinterpret_cast<const float4*>(x);             // row g
            const float4 v1 = *reinterpret_cast<const float4*>(x + HWIN * FAS);  // row g + 8
            const unsigned ah[4] = {__float_as_uint(v0.x), __float_as_uint(v1.x),
                                    __float_as_uint(v0.z), __float_as_uint(v1.z)};
            const unsigned al[4] = {__float_as_uint(v0.y), __float_as_uint(v1.y),
                                    __float_as_uint(v0.w), __float_as_uint(v1.w)};
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) mma3(part[mi * NI + ni], ah, al, bv[ni]);
          }
        }
        add_partials(acc, part);
      };
      fetch(0);
      ring_pipeline<FNS2, FSTAGE2>(nchunks * 9, ring, load, compute);
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
            for (int ni = 0; ni < NI; ++ni)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int co = c0 + wn * 8 * NI + ni * 8 + 2 * q + e;
                if (co < co_end)
                  out[row + co] =
                      y[row + co] + leaky(acc[mi * NI + ni][2 * h + e] + b2[co]);
              }
          }
      }
    }
  }
  cluster.sync();  // no block exits while a peer may still read its mid
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

// The fp32 launch.  conv2's warp tile is 32 x 32 (NI = 4) where C >= 512
// (26x26 and 13x13 at 416): measured on an H100 at batch 8, it beats the
// 32 x 16 tile there, and loses where C is small (C = 64 at 208x208 would
// leave half of its 128 channels idle).  Each tile's output channels (and,
// with them, its mid channels) are split over a cluster of cs blocks: pick
// the cs that minimises (waves of clusters on the card) x (one block's
// MACs), conv1's share HP*C*MS plus conv2 on co_per_block channels.  Small
// grids (13x13, 26x26 at batch 8) cluster; grids that already fill the
// card do not.  Plans are cached by shape: the occupancy queries cost host
// time.
struct F32Plan {
  int dev, B, H, W, C, Cmid;
  int ni, cs, ms_chunk, co_per_block;
  size_t smem;
};

cudaLaunchConfig_t cluster_config(dim3 grid, size_t smem, void* stream,
                                  cudaLaunchAttribute (&attr)[1]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int NI>
int f32_split(int B, int H, int W, int C, int Cmid, F32Plan* best) {
  int max_smem = 0;
  cudaError_t e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                         best->dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(res_block_f32_kernel<NI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (e != cudaSuccess) return (int)e;
  const int Mpad = ceil_div(Cmid, FMGRAN) * FMGRAN;
  const int tiles = ceil_div(H, TH) * ceil_div(W, TW);
  const int chunks = ceil_div(C, f32_n2(NI)), kchunks = Mpad / FK2;
  double best_cost = -1;
  for (int s = 1; s <= MAX_CLUSTER && s <= chunks && s <= kchunks; ++s) {
    const int per_block = ceil_div(chunks, s);
    if (ceil_div(chunks, per_block) != s) continue;  // the same split as a smaller s
    const int ms_chunk = ceil_div(kchunks, s) * FK2;
    const size_t smem =
        ((size_t)HP * (ms_chunk + FMSKEW) + f32_region(NI)) * sizeof(float);
    if (smem > (size_t)max_smem) continue;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(dim3(tiles, s, B), smem, nullptr, attr);
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, res_block_f32_kernel<NI>, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) continue;
    const double waves = (double)(((long)tiles * B + clusters - 1) / clusters);
    const double cost = waves * ((double)HP * C * ms_chunk +
                                 64.0 * 9 * Mpad * per_block * f32_n2(NI));
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best->ni = NI;
      best->cs = s;
      best->ms_chunk = ms_chunk;
      best->co_per_block = per_block * f32_n2(NI);
      best->smem = smem;
    }
  }
  // Cmid too wide for the shared memory of MAX_CLUSTER blocks
  return best_cost < 0 ? (int)cudaErrorInvalidConfiguration : 0;
}

std::mutex plan_mutex;
F32Plan plans[64];
int n_plans = 0;

int f32_plan(int B, int H, int W, int C, int Cmid, F32Plan* out) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cmid <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(plan_mutex);
  for (int i = 0; i < n_plans; ++i) {
    const F32Plan& p = plans[i];
    if (p.dev == dev && p.B == B && p.H == H && p.W == W && p.C == C && p.Cmid == Cmid) {
      *out = p;
      return 0;
    }
  }
  F32Plan plan = {dev, B, H, W, C, Cmid, 0, 0, 0, 0, 0};
  const int rc = C >= 512 ? f32_split<4>(B, H, W, C, Cmid, &plan)
                          : f32_split<2>(B, H, W, C, Cmid, &plan);
  if (rc != 0) return rc;
  if (n_plans < (int)(sizeof(plans) / sizeof(plans[0]))) plans[n_plans++] = plan;
  *out = plan;
  return 0;
}

}  // namespace

extern "C" {

// Each returns the launch's cudaError_t (0 on success).  All pointers are
// device pointers to contiguous arrays; the kernel runs on `stream` and does
// not synchronise.  The f32 weights are the split, padded, K-major operands
// described at res_block_f32_kernel; a refused cluster launch returns its
// error (there is no other path).
int yolo_fused_res_block_f32(const void* y, const void* w1s, const void* b1,
                             const void* w2s, const void* b2, void* out, int B,
                             int H, int W, int C, int Cmid, void* stream) {
  F32Plan plan;
  const int e = f32_plan(B, H, W, C, Cmid, &plan);
  if (e != 0) return e;
  const int Mpad = ceil_div(Cmid, FMGRAN) * FMGRAN, Cp = ceil_div(C, FK1) * FK1;
  const int tiles_w = ceil_div(W, TW);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(dim3(ceil_div(H, TH) * tiles_w, plan.cs, B),
                                                plan.smem, stream, attr);
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, plan.ni == 4 ? res_block_f32_kernel<4> : res_block_f32_kernel<2>,
      static_cast<const float*>(y), static_cast<const float*>(w1s),
      static_cast<const float*>(b1), static_cast<const float*>(w2s),
      static_cast<const float*>(b2), static_cast<float*>(out), H, W, C, Cmid, Mpad, Cp,
      plan.ms_chunk, tiles_w, plan.co_per_block);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

int yolo_fused_res_block_bf16(const void* y, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* out, int B,
                              int H, int W, int C, int Cmid, void* stream) {
  const int Mpad = ceil_div(Cmid, MGRAN) * MGRAN;
  const size_t smem = ((size_t)HP * (Mpad + SKEW) + 2 * STAGE) * sizeof(bf16);
  return launch<bf16>(res_block_bf16_kernel, y, w1, b1, w2, b2, out, B, H, W, C,
                      Cmid, Mpad, smem, N2, stream);
}

// The cluster size the f32 launch picks for this shape on the current
// device (1: no split), or minus its cudaError_t.
int yolo_fused_res_block_f32_cluster(int B, int H, int W, int C, int Cmid) {
  F32Plan plan;
  const int e = f32_plan(B, H, W, C, Cmid, &plan);
  return e != 0 ? -e : plan.cs;
}

const char* yolo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
