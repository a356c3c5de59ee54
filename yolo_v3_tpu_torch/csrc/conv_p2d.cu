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
// a row.  One kernel per input mode: int8 on mma.sync, bf16 on wgmma fed by
// TMA.
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
// int8 (mma.sync m16n8k32 s8, int32 accumulate).  One block computes a
// BM x 128 tile of out (BM = 128, or 64 where the grid would not cover the
// SMs twice) as an implicit GEMM.  The 3x3 needs no im2col: each K step
// stages the BM rows of x2d at the tap's row offset.  mma wants K contiguous
// in both operands, so the weight comes K-major ([N][taps*C], transposed
// once by the wrapper and cached).  Both operands go through 16-byte
// cp.async into a 3-stage ring of shared tiles, 64 channels per row and
// stage; shared rows are 80 bytes apart, so every fragment is one
// conflict-free 32-bit shared load.
//
// bf16 (wgmma m64nNk16, float32 accumulate).  Each tap's A tile is a plain
// 2-D box of x2d at a constant row offset, so TMA stages it straight into
// shared memory for wgmma: boxes of 64 channels (128 bytes, 128-byte
// swizzle) at coordinates (k0, row), rows outside [0, R) (negative ones
// too) and channels >= C read as zeros by TMA's out-of-bounds fill.  The
// three taps of one kernel row of the 3x3 read the same rows shifted by
// one, so one box of BM + 2 rows serves all three (a wgmma descriptor may
// start at any row of the swizzled box): a ring slot holds that box and
// the three taps' B boxes, a third of the A traffic of one box per tap.  B
// is a box of the K-major weight seen as [N][taps][C] (a 3-D map, so that
// the channel tail and the rows n >= N zero-fill; a 2-D map over
// [N][taps*C] would read the next tap's channels where C % 64 != 0).  One
// producer warp issues every load through a ring of mbarrier-guarded slots;
// one or two consumer warpgroups run 4 wgmma k16 per tap and slot with both
// operands in shared memory and one float32 accumulator over the whole K
// (it holds the bf16 tolerance at K = 4608).  The grid is persistent: each
// block walks tiles, so the producer loads the next tile while the
// consumers run this one's epilogue.  The epilogue works in registers from
// the accumulator layout and stages each warp's 16 rows x 64 channels
// through shared memory, so that the global stores are 16 bytes wide and
// coalesced (element stores where a row of out is not a multiple of 16
// bytes: the dets' N = 255).  The tile is 128 x 128 (one block an SM) or
// 64 x 64 (two), picked per shape on the host by a cost model fitted on the
// H100 (plan_bf16, mirrored by ops/fused_conv.py::plan_bf16).  What bounds
// it now: per tile, the fill of the ring and the epilogue, which the
// tensor cores wait through where a tile has few K slots (the 1x1s, the
// 52^2 3x3), and the rate at which TMA brings A and B into the SM (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr float LEAKY = 0.1f;

__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

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

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// int8: mma.sync m16n8k32, cp.async ring
// ---------------------------------------------------------------------------

constexpr int NT = 256;     // threads per block: 8 warps, 4 (rows) x 2 (cols)
constexpr int BN = 128;     // output channels per block
constexpr int KB = 64;      // K per row and step: 64 int8 channels
constexpr int SROW = 80;    // shared row stride in bytes: 64 + 16, conflict-free fragments
constexpr int STAGES = 3;   // cp.async ring depth

// One 32-channel K slice of a 16 x 8 tile, int32 accumulate.
__device__ __forceinline__ void mma(int (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage 16 bytes of a row (`n` valid of them, 0..16) into shared memory:
// cp.async when the run is 16-byte aligned and whole or empty, else byte
// by byte (C % 16 != 0, test shapes only).
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
template <int TAPS, int MI>
__global__ void __launch_bounds__(NT) conv_p2d_i8_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const int8_t* __restrict__ residual, float res_scale, void* __restrict__ out,
    int out_bf16, int R, int C, int N, int hp, int wp, int leaky) {
  constexpr int BM = 64 * MI;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As = smem;                            // [STAGES][BM][SROW]
  int8_t* Bs = smem + STAGES * BM * SROW;       // [STAGES][BN][SROW]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int cb = C;                      // bytes per row of x2d and per tap of wt
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

  int acc[MI][8][4];
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
            static_cast<bf16*>(out)[o] = __float2bfloat16_rn(y);
          else
            static_cast<int8_t*>(out)[o] = requant(y);
        }
    }
}

template <int TAPS>
int launch_i8(const void* x, const void* w, const void* scale, const void* bias,
              const void* residual, float res_scale, void* out, int out_bf16, int R, int C,
              int N, int hp, int wp, int leaky, void* stream) {
  if (R <= 0 || C <= 0 || N <= 0 || hp < 3 || wp < 3) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int nb = ceil_div(N, BN);
  // 128-row tiles unless that leaves the grid short of two blocks per SM
  const bool small = (long)ceil_div(R, 128) * nb < 2L * sms;
  const dim3 grid(ceil_div(R, small ? 64 : 128), nb);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = small ? conv_p2d_i8_kernel<TAPS, 1> : conv_p2d_i8_kernel<TAPS, 2>;
  const int smem = STAGES * ((small ? 64 : 128) + BN) * SROW;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const int8_t*>(residual), res_scale, out, out_bf16, R, C, N, hp, wp, leaky);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma m64nNk16 fed by TMA from a producer warp, persistent grid
// ---------------------------------------------------------------------------

constexpr int BK = 64;         // channels per K slot: one 128-byte row of a staged operand
constexpr int EPI_LD = 144;    // bytes per row of a warp's epilogue staging (128 + 16)

// The tile shapes, chosen per launch by plan_bf16: consumer warpgroups
// (BM = 64 * wgs rows), BN output channels, blocks per SM (the kernel's
// occupancy bound; the ring is sized to fit that many).  Mirrored by
// ops/fused_conv.py::BF16_TILES.
struct Tiles { int wgs, bn, bps; };
constexpr Tiles TILES[] = {{2, 128, 1}, {1, 64, 2}};
constexpr int N_TILES = sizeof(TILES) / sizeof(TILES[0]);

// A ring slot holds K slot k of `tps` taps: the 3x3 takes the three taps of
// one kernel row (dy) per slot, whose A rows are the same x2d rows shifted
// by one, so one box of BM + 2 rows serves all three (BM + 8 rows are kept,
// so that B stays 1024-byte aligned); then one B box of BN rows per tap.
__host__ __device__ constexpr int taps_per_slot(int taps) { return taps == 9 ? 3 : 1; }
__host__ __device__ constexpr int a_rows(int taps, int wgs) {
  return 64 * wgs + (taps == 9 ? 8 : 0);
}
__host__ __device__ constexpr int slot_bytes(int taps, int wgs, int bn) {
  return (a_rows(taps, wgs) + taps_per_slot(taps) * bn) * BK * 2;
}
// Shared memory a block may take when bps blocks share an SM (228 KB, less
// 1 KB the system keeps per block; at most 227 KB for one block).
__host__ __device__ constexpr int smem_budget(int bps) {
  return bps == 1 ? 232448 : 233472 / bps - 1024;
}
// + 1024: the ring's alignment (the 128-byte swizzle is a function of the
// shared-memory address); each consumer warp's 16-row epilogue staging;
// two mbarriers a slot (at most 8 slots)
__host__ __device__ constexpr int fixed_smem(int wgs) { return 1024 + 4 * wgs * 16 * EPI_LD + 128; }
__host__ __device__ constexpr int ring_slots(int taps, int wgs, int bn, int bps) {
  return (smem_budget(bps) - fixed_smem(wgs)) / slot_bytes(taps, wgs, bn) < 8
             ? (smem_budget(bps) - fixed_smem(wgs)) / slot_bytes(taps, wgs, bn)
             : 8;
}
__host__ __device__ constexpr int smem_bytes(int taps, int wgs, int bn, int bps) {
  return fixed_smem(wgs) + ring_slots(taps, wgs, bn, bps) * slot_bytes(taps, wgs, bn);
}

// The cost model behind the choice, in SM clocks: each slot of a tile takes
// the larger of its tensor-core time (BM * BN * 64 * tps MACs at 2,048 a
// clock) and the time to bring its bytes into the SM (at 64 bytes a clock);
// the persistent grid gives each SM ceil(grid / sms) blocks of ceil(tiles /
// grid) tiles each, which share its tensor cores; each tile's epilogue
// (3/16 clock an output) overlaps the other blocks of its SM.  The two
// constants were fitted to the tile shapes' times at the 13 head and up
// convs of YOLOv3-416 at batch 8 on an H100 (PERF.md), where the model
// picks the fastest shape at each; the cheapest wins, the first on a tie.
constexpr long long L2_BYTES_PER_CLOCK = 64;
constexpr long long EPI_CLOCKS_X16 = 3;

long long tiles_cost(Tiles t, int R, int C, int N, int taps, int sms) {
  const int bm = 64 * t.wgs, tps = taps_per_slot(taps);
  const long long tiles = (long long)ceil_div(R, bm) * ceil_div(N, t.bn);
  const long long steps = (long long)(taps / tps) * ceil_div(C, BK);
  const long long grid = tiles < (long long)sms * t.bps ? tiles : (long long)sms * t.bps;
  const long long mma = (long long)bm * t.bn * BK * tps / 2048;
  const long long load = slot_bytes(taps, t.wgs, t.bn) / L2_BYTES_PER_CLOCK;
  const long long per_block = (tiles + grid - 1) / grid;
  return (grid + sms - 1) / sms * per_block * steps * (mma > load ? mma : load) +
         per_block * bm * t.bn * EPI_CLOCKS_X16 / 16;
}

int plan_bf16(int R, int C, int N, int taps, int sms) {
  int best = 0;
  for (int v = 1; v < N_TILES; ++v)
    if (tiles_cost(TILES[v], R, C, N, taps, sms) < tiles_cost(TILES[best], R, C, N, taps, sms))
      best = v;
  return best;
}

// x_map: x2d [R][C], boxes of BK channels x (BM + tps - 1) rows; w_map: the
// K-major weight as [N][taps][C], boxes of BK channels x 1 tap x BN; both
// 128-byte swizzled, out-of-bounds elements zero.  Grid: min(tiles, sms *
// bps) blocks of 128 * wgs + 32 threads; block b takes tiles b, b + grid,
// ... (tile t: rows m0 = (t % m_tiles) * BM, channels n0 = (t / m_tiles) *
// BN).  A tile's K runs over (kernel row dy, channel slot k0): the 1x1 has
// one tap, the 3x3 three rows of three taps.
//
// Warp 4 * wgs is the producer: one thread issues every TMA load, through
// the ring's slots with a `full` barrier (its bytes in) and an `empty`
// barrier (the consumer warps out) each.  Warps 0 .. 4 * wgs - 1 are the
// consumer warpgroups; warpgroup wg owns rows [64 wg, 64 wg + 64) of the
// tile.
template <int TAPS, int WGS, int BNV, int BPS>
__global__ void __launch_bounds__(128 * WGS + 32, BPS) conv_p2d_bf16_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const bf16* __restrict__ residual, float res_scale, void* __restrict__ out, int out_bf16,
    int R, int C, int N, int hp, int wp, int leaky) {
  constexpr int BM = 64 * WGS, TPS = taps_per_slot(TAPS);
  constexpr int NS = ring_slots(TAPS, WGS, BNV, BPS), SLOT = slot_bytes(TAPS, WGS, BNV);
  constexpr int A_BYTES = a_rows(TAPS, WGS) * BK * 2, B_BYTES = BNV * BK * 2;
  static_assert(NS >= 2, "the ring must hold two slots");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* staging = ring + NS * SLOT;            // [4 * wgs warps][16][EPI_LD]
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 4 * WGS * 16 * EPI_LD);
  uint64_t* empty = full + NS;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * WGS);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  // the warp index as a warp-uniform value (a shuffle), so that the compiler
  // sees the wgmma path below as convergent: wgmma in a path it thinks
  // divergent is serialized (each waits for the one before)
  const int lane = threadIdx.x % 32, warp = __shfl_sync(0xffffffff, threadIdx.x / 32, 0);
  const int m_tiles = ceil_div(R, BM);
  const int tiles = m_tiles * ceil_div(N, BNV);
  const int kpt = ceil_div(C, BK);  // K slots per tap
  const int steps = TAPS / TPS * kpt;

  if (warp == 4 * WGS) {
    // ---- producer ----------------------------------------------------------
    if (lane == 0) {
      tma_prefetch_map(&x_map);
      tma_prefetch_map(&w_map);
      int slot = 0, phase = 0, it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % m_tiles) * BM, n0 = (t / m_tiles) * BNV;
        for (int s = 0; s < steps; ++s, ++it) {
          const int dy = s / kpt, k0 = (s % kpt) * BK;
          if (it >= NS) mbar_wait(&empty[slot], phase ^ 1);
          unsigned char* st = ring + slot * SLOT;
          mbar_expect_tx(&full[slot], (BM + TPS - 1) * BK * 2 + TPS * B_BYTES);
          // the 3x3's row dy starts one pixel left of the tap (dy, 1)
          tma_load_2d(st, &x_map, &full[slot], k0, TAPS == 9 ? m0 + (dy - 1) * wp - 1 : m0);
#pragma unroll
          for (int j = 0; j < TPS; ++j)
            tma_load_3d(st + A_BYTES + j * B_BYTES, &w_map, &full[slot], k0, dy * TPS + j, n0);
          if (++slot == NS) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers -------------------------------------------------------------
  const int wg = warp / 4, wq = warp % 4;          // warpgroup, its warp
  const int g = lane / 4, q = lane % 4;            // accumulator row, column pair
  const int es = out_bf16 ? 2 : 1;                 // bytes per output element
  const bool vec = (N * es) % 16 == 0;             // 16-byte rows of out
  const int plane = hp * wp;
  unsigned char* stage = staging + warp * 16 * EPI_LD;
  int slot = 0, phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % m_tiles) * BM, n0 = (t / m_tiles) * BNV;
    float acc[BNV / 2];
#pragma unroll
    for (int i = 0; i < BNV / 2; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int s = 0; s < steps; ++s) {
      mbar_wait(&full[slot], phase);
      const unsigned char* st = ring + slot * SLOT;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < TPS; ++j) {
        // tap (dy, j): A rows shifted by j inside the box
        const uint64_t da = wgmma_desc(st + (wg * 64 + j) * BK * 2);
        const uint64_t db = wgmma_desc(st + A_BYTES + j * B_BYTES);
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) wgmma_ss<BNV>(acc, da + 2 * k, db + 2 * k);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous slot's group: hand its slot back
      if (s > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = slot;
      if (++slot == NS) {
        slot = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // ---- epilogue: this warp's 16 rows, 64 channels at a time --------------
    const int row0 = m0 + wg * 64 + wq * 16;
    bool keep[2];  // a row of out that is inside [0, R) and not a border pixel
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + g + 8 * h, p = r % plane, prow = p / wp, pcol = p % wp;
      keep[h] = r < R && prow >= 1 && prow <= hp - 2 && pcol >= 1 && pcol <= wp - 2;
    }
#pragma unroll
    for (int cc = 0; cc < BNV / 64; ++cc) {
      const int nc = n0 + cc * 64;  // the chunk's first channel
      if (nc >= N) break;           // uniform in the warp
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + g + 8 * h, c = 8 * i + 2 * q;
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = nc + c + e;
            y[e] = keep[h] && n < N
                       ? epilogue(acc[4 * (8 * cc + i) + 2 * h + e], __ldg(scale + n),
                                  __ldg(bias + n), leaky != 0,
                                  residual ? residual + (size_t)r * N + n : nullptr, res_scale)
                       : 0.f;
          }
          unsigned char* at = stage + (g + 8 * h) * EPI_LD + c * es;
          if (out_bf16)
            *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(y[0], y[1]);
          else
            *reinterpret_cast<char2*>(at) = make_char2(requant(y[0]), requant(y[1]));
        }
      __syncwarp();
      unsigned char* dst = static_cast<unsigned char*>(out) + ((size_t)row0 * N + nc) * es;
      if (vec) {  // 16-byte runs: 64 channels are 4 * es of them
        const int runs = 4 * es;
        for (int i = lane; i < 16 * runs; i += 32) {
          const int row = i / runs, k = i % runs;
          if (row0 + row < R && nc + k * 16 / es < N)
            *reinterpret_cast<int4*>(dst + (size_t)row * N * es + k * 16) =
                *reinterpret_cast<const int4*>(stage + row * EPI_LD + k * 16);
        }
      } else {    // one element at a time, consecutive lanes on consecutive channels
        for (int i = lane; i < 16 * 64; i += 32) {
          const int row = i / 64, c = i % 64;
          if (row0 + row >= R || nc + c >= N) continue;
          unsigned char* o = dst + ((size_t)row * N + c) * es;
          const unsigned char* sv = stage + row * EPI_LD + c * es;
          if (out_bf16)
            *reinterpret_cast<bf16*>(o) = *reinterpret_cast<const bf16*>(sv);
          else
            *o = *sv;
        }
      }
      __syncwarp();
    }
  }
}

// Tensor maps are encoded on the host (cuTensorMapEncodeTiled).  A map holds
// only an address and a geometry, so one encoded for the same arguments is
// the same map whatever the memory holds now: the last few are kept and
// reused (a model's weights and the activations that the caching allocator
// hands out again).
struct MapEntry {
  const void* base;
  int rank;
  cuuint64_t dims[3], strides[2];
  cuuint32_t box[3];
  CUtensorMap map;
};
std::mutex map_mutex;
MapEntry maps[64];
int n_maps = 0, next_map = 0;

int cached_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
               const cuuint64_t* strides, const cuuint32_t* box) {
  std::lock_guard<std::mutex> lock(map_mutex);
  for (int i = 0; i < n_maps; ++i) {
    const MapEntry& m = maps[i];
    bool same = m.base == base && m.rank == rank;
    for (int d = 0; same && d < rank; ++d)
      same = m.dims[d] == dims[d] && m.box[d] == box[d] &&
             (d == rank - 1 || m.strides[d] == strides[d]);
    if (same) {
      *map = m.map;
      return 0;
    }
  }
  const int e = tensor_map(map, base, rank, dims, strides, box);
  if (e != 0) return e;
  MapEntry& m = maps[next_map];
  m.base = base;
  m.rank = rank;
  for (int d = 0; d < rank; ++d) {
    m.dims[d] = dims[d];
    m.box[d] = box[d];
    if (d < rank - 1) m.strides[d] = strides[d];
  }
  m.map = *map;
  next_map = (next_map + 1) % 64;
  if (n_maps < 64) ++n_maps;
  return 0;
}

// The kernel of (TAPS, TILES[v]).
template <int TAPS>
const void* bf16_kernel(int v) {
  static_assert(N_TILES == 2, "one kernel per tile shape");
  constexpr Tiles a = TILES[0], b = TILES[1];
  return v == 0 ? reinterpret_cast<const void*>(conv_p2d_bf16_kernel<TAPS, a.wgs, a.bn, a.bps>)
                : reinterpret_cast<const void*>(conv_p2d_bf16_kernel<TAPS, b.wgs, b.bn, b.bps>);
}

// Let the kernel of (TAPS, TILES[v]) take its shared memory (above 48 KB
// only after this call, once per device).
template <int TAPS>
int allow_smem(int v) {
  const Tiles t = TILES[v];
  return (int)cudaFuncSetAttribute(bf16_kernel<TAPS>(v),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes(TAPS, t.wgs, t.bn, t.bps));
}

// The tile shape of each (device, shape), planned once.
struct Bf16Plan { int dev, R, C, N, taps, variant; };
std::mutex plan_mutex;
Bf16Plan plans[64];
int n_plans = 0;

template <int TAPS>
int get_variant(int dev, int sms, int R, int C, int N, int* variant) {
  std::lock_guard<std::mutex> lock(plan_mutex);
  for (int i = 0; i < n_plans; ++i) {
    const Bf16Plan& p = plans[i];
    if (p.dev == dev && p.R == R && p.C == C && p.N == N && p.taps == TAPS) {
      *variant = p.variant;
      return 0;
    }
  }
  *variant = plan_bf16(R, C, N, TAPS, sms);
  const int e = allow_smem<TAPS>(*variant);
  if (e == 0 && n_plans < (int)(sizeof(plans) / sizeof(plans[0])))
    plans[n_plans++] = {dev, R, C, N, TAPS, *variant};
  return e;
}

// variant: an index of TILES, or -1 for the planner's choice.
template <int TAPS>
int launch_bf16(int variant, const void* x, const void* w, const void* scale, const void* bias,
                const void* residual, float res_scale, void* out, int out_bf16, int R, int C,
                int N, int hp, int wp, int leaky, void* stream) {
  if (R <= 0 || C <= 0 || N <= 0 || hp < 3 || wp < 3 || variant < -1 || variant >= N_TILES)
    return (int)cudaErrorInvalidValue;
  if (C % 8) return (int)cudaErrorInvalidValue;  // TMA: 16-byte rows of x2d and of wt
  int dev = 0, sms = 0, e = (int)cudaGetDevice(&dev);
  if (e == 0) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == 0) e = variant < 0 ? get_variant<TAPS>(dev, sms, R, C, N, &variant)
                              : allow_smem<TAPS>(variant);
  if (e != 0) return e;
  const Tiles t = TILES[variant];
  const cuuint64_t row = (cuuint64_t)C * 2;
  const cuuint64_t x_dims[2] = {(cuuint64_t)C, (cuuint64_t)R}, x_strides[1] = {row};
  const cuuint64_t w_dims[3] = {(cuuint64_t)C, (cuuint64_t)TAPS, (cuuint64_t)N};
  const cuuint64_t w_strides[2] = {row, row * TAPS};
  const cuuint32_t x_box[2] = {BK, (cuuint32_t)(64 * t.wgs + taps_per_slot(TAPS) - 1)};
  const cuuint32_t w_box[3] = {BK, 1, (cuuint32_t)t.bn};
  CUtensorMap x_map, w_map;
  if ((e = cached_map(&x_map, x, 2, x_dims, x_strides, x_box)) != 0 ||
      (e = cached_map(&w_map, w, 3, w_dims, w_strides, w_box)) != 0)
    return e;
  const long long tiles = (long long)ceil_div(R, 64 * t.wgs) * ceil_div(N, t.bn);
  const long long grid = tiles < (long long)sms * t.bps ? tiles : (long long)sms * t.bps;
  void* args[] = {&x_map, &w_map, &scale, &bias, &residual, &res_scale, &out, &out_bf16,
                  &R, &C, &N, &hp, &wp, &leaky};
  return (int)cudaLaunchKernel(bf16_kernel<TAPS>(variant), dim3((unsigned)grid),
                               dim3(128 * t.wgs + 32), args,
                               smem_bytes(TAPS, t.wgs, t.bn, t.bps),
                               static_cast<cudaStream_t>(stream));
}

int launch_bf16(int taps, int variant, const void* x, const void* w, const void* scale,
                const void* bias, const void* residual, float res_scale, void* out,
                int out_bf16, int R, int C, int N, int hp, int wp, int leaky, void* stream) {
  if (taps == 9)
    return launch_bf16<9>(variant, x, w, scale, bias, residual, res_scale, out, out_bf16, R, C,
                          N, hp, wp, leaky, stream);
  if (taps == 1)
    return launch_bf16<1>(variant, x, w, scale, bias, residual, res_scale, out, out_bf16, R, C,
                          N, hp, wp, leaky, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each returns the launch's cudaError_t (0 on success).  x [R, C] int8 (the
// _i8 entry points) or bf16 (_bf16; C % 8 == 0), w the weight K-major:
// [N, taps*C] of x's dtype (row n holds tap-major, then channel); scale,
// bias [N] float32; residual [R, N] of x's dtype or null; out [R, N] int8,
// or bf16 when out_bf16.  All device pointers to contiguous arrays, x and w
// 16-byte aligned; the kernel runs on `stream` and does not synchronise.
int yolo_conv1x1_p2d_i8(const void* x, const void* w, const void* scale, const void* bias,
                        const void* residual, float res_scale, void* out, int out_bf16, int R,
                        int C, int N, int hp, int wp, int leaky, void* stream) {
  return launch_i8<1>(x, w, scale, bias, residual, res_scale, out, out_bf16, R, C, N, hp, wp,
                      leaky, stream);
}

int yolo_conv3x3_p2d_i8(const void* x, const void* w, const void* scale, const void* bias,
                        const void* residual, float res_scale, void* out, int out_bf16, int R,
                        int C, int N, int hp, int wp, int leaky, void* stream) {
  return launch_i8<9>(x, w, scale, bias, residual, res_scale, out, out_bf16, R, C, N, hp, wp,
                      leaky, stream);
}

int yolo_conv1x1_p2d_bf16(const void* x, const void* w, const void* scale, const void* bias,
                          const void* residual, float res_scale, void* out, int out_bf16, int R,
                          int C, int N, int hp, int wp, int leaky, void* stream) {
  return launch_bf16(1, -1, x, w, scale, bias, residual, res_scale, out, out_bf16, R, C, N, hp,
                     wp, leaky, stream);
}

int yolo_conv3x3_p2d_bf16(const void* x, const void* w, const void* scale, const void* bias,
                          const void* residual, float res_scale, void* out, int out_bf16, int R,
                          int C, int N, int hp, int wp, int leaky, void* stream) {
  return launch_bf16(9, -1, x, w, scale, bias, residual, res_scale, out, out_bf16, R, C, N, hp,
                     wp, leaky, stream);
}

// The bf16 kernel with the tile shape TILES[variant] forced (taps 1 or 9,
// the other arguments as above), so that every shape can be held to the
// plain version whatever the planner picks.
int yolo_conv_p2d_bf16_tiles(int taps, int variant, const void* x, const void* w,
                             const void* scale, const void* bias, const void* residual,
                             float res_scale, void* out, int out_bf16, int R, int C, int N,
                             int hp, int wp, int leaky, void* stream) {
  if (variant < 0) return (int)cudaErrorInvalidValue;
  return launch_bf16(taps, variant, x, w, scale, bias, residual, res_scale,
                     out, out_bf16, R, C, N, hp, wp, leaky, stream);
}

// The index of TILES that the bf16 launch picks for this shape on the
// current device, or minus its cudaError_t.
int yolo_conv_p2d_bf16_plan(int R, int C, int N, int taps) {
  int dev = 0, sms = 0, variant = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e == 0) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == 0 && taps != 1 && taps != 9) e = (int)cudaErrorInvalidValue;
  if (e == 0) e = taps == 9 ? get_variant<9>(dev, sms, R, C, N, &variant)
                            : get_variant<1>(dev, sms, R, C, N, &variant);
  return e != 0 ? -e : variant;
}

const char* yolo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
