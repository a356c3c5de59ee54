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
// a row.  One kernel, wgmma fed by TMA, templated on its input type (I8In,
// Bf16In below).
//
// Epilogue (fused_conv.py::_epilogue), in float32 with every step rounded and
// no contraction (__fmul_rn / __fadd_rn), so that it matches the plain
// PyTorch version step for step (bit-equal for int8 input, whose
// accumulator is exact):
//     y = acc * scale + bias;  y = act(y);  y = y + residual * res_scale
//     y = 0 on border rows;    int8: clip(rint(y), -127, 127)  (half to even)
//                              bf16: round to nearest even
// act is an activation code: 0 none, 1 leaky(0.1), 2 Mish (bf16 input only;
// its own instantiation of the kernel, MISH, so that the leaky kernels are
// the code they were).  Mish is x * tanh(softplus(x)) computed as
// x * (n^2 + 2n) / (n^2 + 2n + 2), n = e^x, and x above 20 (darknet's
// threshold), with the fast exponential and division: within a bf16 rounding
// of the plain version, not bit-equal to it.
//
// What bounds it on the H100.  At YOLOv3-416, batch 8, the 1x1s are
// [R, C] @ [C, N] with R = 8*(H+2)^2 and N = C/2 (or 255 for a det): at
// C = 128 int8 does ~64 MACs per byte of x and out, below the card's ~590
// op/byte int8 balance point: bandwidth bound; bf16 halves the MACs per
// byte against a ~295 op/byte balance, so its 1x1s sit near it.  The 3x3s
// do 9x that per byte and are compute bound from 52^2 on in both dtypes.
// At 13^2 the grid is small (R = 1,800 rows for 132 SMs).
//
// The kernel.  Each tap's A tile is a plain 2-D box of x2d at a constant
// row offset, so TMA stages it straight into shared memory for wgmma: boxes
// of one 128-byte row of channels (64 bf16 or 128 int8; 128-byte swizzle)
// at coordinates (k0, row), rows outside [0, R) (negative ones too) and
// channels >= C read as zeros by TMA's out-of-bounds fill.  The three taps
// of one kernel row of the 3x3 read the same rows shifted by one, so one
// box of BM + 2 rows serves all three (a wgmma descriptor may start at any
// row of the swizzled box): a ring slot holds that box and the three taps'
// B boxes, a third of the A traffic of one box per tap.  B is a box of the
// K-major weight seen as [N][taps][C] (a 3-D map, so that the channel tail
// and the rows n >= N zero-fill; a 2-D map over [N][taps*C] would read the
// next tap's channels where C is not a multiple of the slot).  One producer
// warp issues every load through a ring of mbarrier-guarded slots; one or
// two consumer warpgroups run 4 wgmmas of 32 bytes of K (k16 bf16, k32
// int8) per tap and slot with both operands in shared memory and one
// accumulator over the whole K (float32 for bf16, which holds the bf16
// tolerance at K = 4608; int32 for int8, exact).  The grid is persistent:
// each block walks tiles, so the producer loads the next tile while the
// consumers run this one's epilogue.  The epilogue works in registers from
// the accumulator layout, 64 channels at a time: each thread first loads
// the multipliers, biases and residuals of its 16 channels and 2 rows
// together (one round trip, not one per output), then stages each warp's
// 16 rows x 64 channels through shared memory, so that the global stores
// are 16 bytes wide and coalesced (element stores where a row of out is
// not a multiple of 16 bytes: the dets' N = 255).  The tile is 128 x 128
// (one block an SM) or 64 x 64 (two), picked per shape and input type on
// the host by a cost model fitted on the H100 (plan, mirrored by
// ops/fused_conv.py::plan_tiles).
//
// The two input types share all of this; they differ in the wgmma
// (m64nNk16.f32.bf16.bf16 / m64nNk32.s32.s8.s8), the accumulator, the
// channels per slot and the tensor maps' element type.  A slot holds the
// same bytes in both, so an int8 tile runs half the slots of a bf16 one,
// each twice the MACs at twice the tensor cores' rate.  TMA needs 16-byte
// rows: C % 8 == 0 for bf16 and C % 16 == 0 for int8 (the wrapper zero-pads
// int8 channels to 16 otherwise, which no model shape needs).  What bounds
// it now: per tile, the fill of the ring and the epilogue, which the
// tensor cores wait through where a tile has few K slots (the 1x1s, the
// 52^2 3x3, all the more in int8), and the rate at which TMA brings A and
// B into the SM (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <type_traits>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr float LEAKY = 0.1f;
constexpr float MISH_THRESHOLD = 20.f;
constexpr int ACT_MISH = 2;  // the activation code of Mish (ACT_LEAKY = 1, none 0)

__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// Mish in the plain version's order (ops/activations.py::mish).
__device__ __forceinline__ float mish(float x) {
  if (x > MISH_THRESHOLD) return x;
  const float n = __expf(x), t = __fmul_rn(n, __fadd_rn(n, 2.f));
  return __fdividef(__fmul_rn(x, t), __fadd_rn(t, 2.f));
}

// The epilogue of one accumulator, in the plain version's order: leaky where
// lk, Mish in the MISH kernel.
template <bool MISH, typename A>
__device__ __forceinline__ float epilogue(A acc, float scale, float bias, bool lk, bool has_res,
                                          float res, float res_scale) {
  float y = __fadd_rn(__fmul_rn(to_float(acc), scale), bias);
  if (MISH)
    y = mish(y);
  else if (lk)
    y = y > 0.f ? y : __fmul_rn(LEAKY, y);
  if (has_res) y = __fadd_rn(y, __fmul_rn(res, res_scale));
  return y;
}

__device__ __forceinline__ int8_t requant(float y) {
  const int v = __float2int_rn(y);  // round half to even
  return (int8_t)(v > 127 ? 127 : (v < -127 ? -127 : v));
}

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

constexpr int ROW = 128;       // bytes per row of a staged operand: one 128-byte swizzle row
constexpr int EPI_LD = 144;    // bytes per row of a warp's epilogue staging (128 + 16)

// ---------------------------------------------------------------------------
// The input types
// ---------------------------------------------------------------------------

// What differs between the kernel's two input types: the element of x2d,
// the weight and the residual; the wgmma accumulator (wgmma_ss picks the
// instruction by it); the channels of a K slot (one 128-byte row); the
// tensor maps' element type; and the planner's rates: tensor-core MACs a
// clock an SM (the card's dense peak, 989 bf16 and 1,979 int8 TOPS at 132
// SMs and 1.83 GHz), bytes into an SM a clock and 16 x the epilogue's
// clocks an output (fitted, PERF.md).  Mirrored by
// ops/fused_conv.py::PLAN_RATES.
struct Bf16In {
  typedef bf16 T;
  typedef float Acc;
  static constexpr int BK = ROW / 2;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr long long MACS_PER_CLOCK = 2048, L2_BYTES_PER_CLOCK = 64, EPI_CLOCKS_X16 = 3;
};
struct I8In {
  typedef int8_t T;
  typedef int Acc;
  static constexpr int BK = ROW;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr long long MACS_PER_CLOCK = 4096, L2_BYTES_PER_CLOCK = 64, EPI_CLOCKS_X16 = 3;
};

// ---------------------------------------------------------------------------
// Tiles, ring and planner
// ---------------------------------------------------------------------------

// The tile shapes, chosen per launch by plan: consumer warpgroups (BM = 64
// * wgs rows), BN output channels, blocks per SM (the kernel's occupancy
// bound; the ring is sized to fit that many).  Mirrored by
// ops/fused_conv.py::P2D_TILES.
struct Tiles { int wgs, bn, bps; };
constexpr Tiles TILES[] = {{2, 128, 1}, {1, 64, 2}};
constexpr int N_TILES = sizeof(TILES) / sizeof(TILES[0]);

// A ring slot holds K slot k of `tps` taps: the 3x3 takes the three taps of
// one kernel row (dy) per slot, whose A rows are the same x2d rows shifted
// by one, so one box of BM + 2 rows serves all three (BM + 8 rows are kept,
// so that B stays 1024-byte aligned); then one B box of BN rows per tap.
// The same bytes in both input types.
__host__ __device__ constexpr int taps_per_slot(int taps) { return taps == 9 ? 3 : 1; }
__host__ __device__ constexpr int a_rows(int taps, int wgs) {
  return 64 * wgs + (taps == 9 ? 8 : 0);
}
__host__ __device__ constexpr int slot_bytes(int taps, int wgs, int bn) {
  return (a_rows(taps, wgs) + taps_per_slot(taps) * bn) * ROW;
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
// the larger of its tensor-core time (BM * BN * BK * tps MACs at
// MACS_PER_CLOCK) and the time to bring its bytes into the SM (at
// L2_BYTES_PER_CLOCK); the persistent grid gives each SM ceil(grid / sms)
// blocks of ceil(tiles / grid) tiles each, which share its tensor cores;
// each tile's epilogue (EPI_CLOCKS_X16 / 16 clock an output) overlaps the
// other blocks of its SM.  The rates were fitted per input type to the
// tile shapes' times at the convs of YOLOv3-416 at batch 8 on an H100
// (PERF.md), where the model picks the fastest shape at each; the cheapest
// wins, the first on a tie.
template <typename In>
long long tiles_cost(Tiles t, int R, int C, int N, int taps, int sms) {
  const int bm = 64 * t.wgs, tps = taps_per_slot(taps);
  const long long tiles = (long long)ceil_div(R, bm) * ceil_div(N, t.bn);
  const long long steps = (long long)(taps / tps) * ceil_div(C, In::BK);
  const long long grid = tiles < (long long)sms * t.bps ? tiles : (long long)sms * t.bps;
  const long long mma = (long long)bm * t.bn * In::BK * tps / In::MACS_PER_CLOCK;
  const long long load = slot_bytes(taps, t.wgs, t.bn) / In::L2_BYTES_PER_CLOCK;
  const long long per_block = (tiles + grid - 1) / grid;
  return (grid + sms - 1) / sms * per_block * steps * (mma > load ? mma : load) +
         per_block * bm * t.bn * In::EPI_CLOCKS_X16 / 16;
}

template <typename In>
int plan(int R, int C, int N, int taps, int sms) {
  int best = 0;
  for (int v = 1; v < N_TILES; ++v)
    if (tiles_cost<In>(TILES[v], R, C, N, taps, sms) <
        tiles_cost<In>(TILES[best], R, C, N, taps, sms))
      best = v;
  return best;
}

// ---------------------------------------------------------------------------
// The kernel: wgmma fed by TMA from a producer warp, persistent grid
// ---------------------------------------------------------------------------

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
template <typename In, int TAPS, int WGS, int BNV, int BPS, bool MISH>
__global__ void __launch_bounds__(128 * WGS + 32, BPS) conv_p2d_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const typename In::T* __restrict__ residual, float res_scale, void* __restrict__ out,
    int out_bf16, int R, int C, int N, int hp, int wp, int leaky) {
  constexpr int BM = 64 * WGS, TPS = taps_per_slot(TAPS), BK = In::BK;
  constexpr int NS = ring_slots(TAPS, WGS, BNV, BPS), SLOT = slot_bytes(TAPS, WGS, BNV);
  constexpr int A_BYTES = a_rows(TAPS, WGS) * ROW, B_BYTES = BNV * ROW;
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
          mbar_expect_tx(&full[slot], (BM + TPS - 1) * ROW + TPS * B_BYTES);
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
    typename In::Acc acc[BNV / 2];
#pragma unroll
    for (int i = 0; i < BNV / 2; ++i) acc[i] = 0;
    int prev = 0;
    for (int s = 0; s < steps; ++s) {
      mbar_wait(&full[slot], phase);
      const unsigned char* st = ring + slot * SLOT;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < TPS; ++j) {
        // tap (dy, j): A rows shifted by j inside the box
        const uint64_t da = wgmma_desc(st + (wg * 64 + j) * ROW);
        const uint64_t db = wgmma_desc(st + A_BYTES + j * B_BYTES);
#pragma unroll
        for (int k = 0; k < ROW / 32; ++k) wgmma_ss<BNV>(acc, da + 2 * k, db + 2 * k);
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
      // this thread's 16 channels of the chunk (8 i + 2 q + e): their
      // multipliers, biases and residuals, all loaded ahead of the math
      float sc[16], bi[16], rv[2][16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = nc + 8 * (j / 2) + 2 * q + j % 2, nn = n < N ? n : N - 1;
        sc[j] = __ldg(scale + nn);
        bi[j] = __ldg(bias + nn);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          rv[h][j] = residual && keep[h] && n < N
                         ? to_float(residual[(size_t)(row0 + g + 8 * h) * N + n])
                         : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 8 * i + 2 * q;
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = nc + c + e;
            y[e] = keep[h] && n < N
                       ? epilogue<MISH>(acc[4 * (8 * cc + i) + 2 * h + e], sc[2 * i + e],
                                        bi[2 * i + e], leaky != 0, residual != nullptr,
                                        rv[h][2 * i + e], res_scale)
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

// ---------------------------------------------------------------------------
// Host: tensor maps, plans, launch
// ---------------------------------------------------------------------------

// Tensor maps are encoded on the host (cuTensorMapEncodeTiled).  A map holds
// only an address, an element type and a geometry, so one encoded for the
// same arguments is the same map whatever the memory holds now: the last
// few are kept and reused (a model's weights and the activations that the
// caching allocator hands out again).
struct MapEntry {
  const void* base;
  CUtensorMapDataType type;
  int rank;
  cuuint64_t dims[3], strides[2];
  cuuint32_t box[3];
  CUtensorMap map;
};
std::mutex map_mutex;
MapEntry maps[64];
int n_maps = 0, next_map = 0;

int cached_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
               const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  std::lock_guard<std::mutex> lock(map_mutex);
  for (int i = 0; i < n_maps; ++i) {
    const MapEntry& m = maps[i];
    bool same = m.base == base && m.type == type && m.rank == rank;
    for (int d = 0; same && d < rank; ++d)
      same = m.dims[d] == dims[d] && m.box[d] == box[d] &&
             (d == rank - 1 || m.strides[d] == strides[d]);
    if (same) {
      *map = m.map;
      return 0;
    }
  }
  const int e = tensor_map(map, type, base, rank, dims, strides, box);
  if (e != 0) return e;
  MapEntry& m = maps[next_map];
  m.base = base;
  m.type = type;
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

// The kernel of (In, TAPS, TILES[v], MISH); Mish only for bf16 input (null
// for int8).
template <typename In, int TAPS, bool MISH>
const void* kernel_of(int v) {
  static_assert(N_TILES == 2, "one kernel per tile shape");
  constexpr Tiles a = TILES[0], b = TILES[1];
  if constexpr (MISH && !std::is_same<In, Bf16In>::value) {
    return nullptr;
  } else {
    return v == 0
               ? reinterpret_cast<const void*>(conv_p2d_kernel<In, TAPS, a.wgs, a.bn, a.bps, MISH>)
               : reinterpret_cast<const void*>(conv_p2d_kernel<In, TAPS, b.wgs, b.bn, b.bps, MISH>);
  }
}

template <typename In, int TAPS>
const void* kernel_of(int v, int act) {
  return act == ACT_MISH ? kernel_of<In, TAPS, true>(v) : kernel_of<In, TAPS, false>(v);
}

// Let the kernel of (In, TAPS, TILES[v], act) take its shared memory (above
// 48 KB only after this call, once per device).
template <typename In, int TAPS>
int allow_smem(int v, int act) {
  const Tiles t = TILES[v];
  const void* fn = kernel_of<In, TAPS>(v, act);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes(TAPS, t.wgs, t.bn, t.bps));
}

// The tile shape of each (device, input type, shape, Mish or not), planned
// once.
struct Plan { int dev, is_i8, R, C, N, taps, mish, variant; };
std::mutex plan_mutex;
Plan plans[64];
int n_plans = 0;

template <typename In, int TAPS>
int get_variant(int dev, int sms, int R, int C, int N, int act, int* variant) {
  const int is_i8 = std::is_same<In, I8In>::value, mish = act == ACT_MISH;
  std::lock_guard<std::mutex> lock(plan_mutex);
  for (int i = 0; i < n_plans; ++i) {
    const Plan& p = plans[i];
    if (p.dev == dev && p.is_i8 == is_i8 && p.R == R && p.C == C && p.N == N && p.taps == TAPS &&
        p.mish == mish) {
      *variant = p.variant;
      return 0;
    }
  }
  *variant = plan<In>(R, C, N, TAPS, sms);
  const int e = allow_smem<In, TAPS>(*variant, act);
  if (e == 0 && n_plans < (int)(sizeof(plans) / sizeof(plans[0])))
    plans[n_plans++] = {dev, is_i8, R, C, N, TAPS, mish, *variant};
  return e;
}

// variant: an index of TILES, or -1 for the planner's choice.
template <typename In, int TAPS>
int launch_taps(int variant, const void* x, const void* w, const void* scale, const void* bias,
                const void* residual, float res_scale, void* out, int out_bf16, int R, int C,
                int N, int hp, int wp, int leaky, void* stream) {
  if (R <= 0 || C <= 0 || N <= 0 || hp < 3 || wp < 3 || variant < -1 || variant >= N_TILES ||
      leaky < 0 || leaky > ACT_MISH)
    return (int)cudaErrorInvalidValue;
  const int row = C * (int)sizeof(typename In::T);
  if (row % 16) return (int)cudaErrorInvalidValue;  // TMA: 16-byte rows of x2d and of wt
  int dev = 0, sms = 0, e = (int)cudaGetDevice(&dev);
  if (e == 0) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == 0) e = variant < 0 ? get_variant<In, TAPS>(dev, sms, R, C, N, leaky, &variant)
                              : allow_smem<In, TAPS>(variant, leaky);
  if (e != 0) return e;
  const Tiles t = TILES[variant];
  const cuuint64_t x_dims[2] = {(cuuint64_t)C, (cuuint64_t)R}, x_strides[1] = {(cuuint64_t)row};
  const cuuint64_t w_dims[3] = {(cuuint64_t)C, (cuuint64_t)TAPS, (cuuint64_t)N};
  const cuuint64_t w_strides[2] = {(cuuint64_t)row, (cuuint64_t)row * TAPS};
  const cuuint32_t x_box[2] = {In::BK, (cuuint32_t)(64 * t.wgs + taps_per_slot(TAPS) - 1)};
  const cuuint32_t w_box[3] = {In::BK, 1, (cuuint32_t)t.bn};
  CUtensorMap x_map, w_map;
  if ((e = cached_map(&x_map, In::MAP, x, 2, x_dims, x_strides, x_box)) != 0 ||
      (e = cached_map(&w_map, In::MAP, w, 3, w_dims, w_strides, w_box)) != 0)
    return e;
  const long long tiles = (long long)ceil_div(R, 64 * t.wgs) * ceil_div(N, t.bn);
  const long long grid = tiles < (long long)sms * t.bps ? tiles : (long long)sms * t.bps;
  void* args[] = {&x_map, &w_map, &scale, &bias, &residual, &res_scale, &out, &out_bf16,
                  &R, &C, &N, &hp, &wp, &leaky};
  return (int)cudaLaunchKernel(kernel_of<In, TAPS>(variant, leaky), dim3((unsigned)grid),
                               dim3(128 * t.wgs + 32), args,
                               smem_bytes(TAPS, t.wgs, t.bn, t.bps),
                               static_cast<cudaStream_t>(stream));
}

template <typename In>
int launch(int taps, int variant, const void* x, const void* w, const void* scale,
           const void* bias, const void* residual, float res_scale, void* out, int out_bf16,
           int R, int C, int N, int hp, int wp, int leaky, void* stream) {
  if (taps == 9)
    return launch_taps<In, 9>(variant, x, w, scale, bias, residual, res_scale, out, out_bf16,
                              R, C, N, hp, wp, leaky, stream);
  if (taps == 1)
    return launch_taps<In, 1>(variant, x, w, scale, bias, residual, res_scale, out, out_bf16,
                              R, C, N, hp, wp, leaky, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each returns the launch's cudaError_t (0 on success).  x [R, C] int8 (the
// _i8 entry points; C % 16 == 0) or bf16 (_bf16; C % 8 == 0), w the weight
// K-major: [N, taps*C] of x's dtype (row n holds tap-major, then channel);
// scale, bias [N] float32; residual [R, N] of x's dtype or null; out [R, N]
// int8, or bf16 when out_bf16; leaky the activation code (0 none, 1 leaky,
// 2 Mish: bf16 input only).  All device pointers to contiguous arrays, x
// and w 16-byte aligned; the kernel runs on `stream` and does not
// synchronise.
int yolo_conv1x1_p2d_i8(const void* x, const void* w, const void* scale, const void* bias,
                        const void* residual, float res_scale, void* out, int out_bf16, int R,
                        int C, int N, int hp, int wp, int leaky, void* stream) {
  return launch<I8In>(1, -1, x, w, scale, bias, residual, res_scale, out, out_bf16, R, C, N, hp,
                      wp, leaky, stream);
}

int yolo_conv3x3_p2d_i8(const void* x, const void* w, const void* scale, const void* bias,
                        const void* residual, float res_scale, void* out, int out_bf16, int R,
                        int C, int N, int hp, int wp, int leaky, void* stream) {
  return launch<I8In>(9, -1, x, w, scale, bias, residual, res_scale, out, out_bf16, R, C, N, hp,
                      wp, leaky, stream);
}

int yolo_conv1x1_p2d_bf16(const void* x, const void* w, const void* scale, const void* bias,
                          const void* residual, float res_scale, void* out, int out_bf16, int R,
                          int C, int N, int hp, int wp, int leaky, void* stream) {
  return launch<Bf16In>(1, -1, x, w, scale, bias, residual, res_scale, out, out_bf16, R, C, N,
                        hp, wp, leaky, stream);
}

int yolo_conv3x3_p2d_bf16(const void* x, const void* w, const void* scale, const void* bias,
                          const void* residual, float res_scale, void* out, int out_bf16, int R,
                          int C, int N, int hp, int wp, int leaky, void* stream) {
  return launch<Bf16In>(9, -1, x, w, scale, bias, residual, res_scale, out, out_bf16, R, C, N,
                        hp, wp, leaky, stream);
}

// The kernel with the tile shape TILES[variant] forced (is_i8: 1 for int8
// input, 0 for bf16; taps 1 or 9; the other arguments as above), so that
// every shape can be held to the plain version whatever the planner picks.
int yolo_conv_p2d_tiles(int is_i8, int taps, int variant, const void* x, const void* w,
                        const void* scale, const void* bias, const void* residual,
                        float res_scale, void* out, int out_bf16, int R, int C, int N, int hp,
                        int wp, int leaky, void* stream) {
  if (variant < 0) return (int)cudaErrorInvalidValue;
  return is_i8 ? launch<I8In>(taps, variant, x, w, scale, bias, residual, res_scale, out,
                              out_bf16, R, C, N, hp, wp, leaky, stream)
               : launch<Bf16In>(taps, variant, x, w, scale, bias, residual, res_scale, out,
                                out_bf16, R, C, N, hp, wp, leaky, stream);
}

// The index of TILES that the launch picks for this input type (is_i8 as
// above) and shape on the current device, or minus its cudaError_t.
int yolo_conv_p2d_plan(int is_i8, int R, int C, int N, int taps) {
  int dev = 0, sms = 0, variant = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e == 0) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == 0 && taps != 1 && taps != 9) e = (int)cudaErrorInvalidValue;
  if (e == 0) {
    if (is_i8)
      e = taps == 9 ? get_variant<I8In, 9>(dev, sms, R, C, N, 1, &variant)
                    : get_variant<I8In, 1>(dev, sms, R, C, N, 1, &variant);
    else
      e = taps == 9 ? get_variant<Bf16In, 9>(dev, sms, R, C, N, 1, &variant)
                    : get_variant<Bf16In, 1>(dev, sms, R, C, N, 1, &variant);
  }
  return e != 0 ? -e : variant;
}

const char* yolo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
