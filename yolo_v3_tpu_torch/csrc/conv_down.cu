// The bf16 stem and stride-2 downsample convolutions of the folded forward
// for Hopper (sm_90a), with the bias, the activation and one rounding to
// bf16 in the epilogue:
//
//     out[b, oy, ox, n] = bf16(act(bias[n] + sum_{dy, dx, c}
//                         x[b, s oy - ph + dy, s ox - 1 + dx, c] * w[n, dy, dx, c]))
//
// x is NHWC bf16 [B, H, W, C], out NHWC bf16 [B, Ho, Wo, N]; rows and columns
// outside the input read as zeros (ph = 1: the SAME 3x3 conv; ph = 0: a
// stripe of rows that already carries its halo, which pads W only).  The
// stem is the stride-1 conv of the 3-channel image; every other launch is a
// 3x3/stride-2 down (C a multiple of 8, W even).  act is an activation code:
// 0 none, 1 leaky(0.1), 2 Mish (its own instantiation, MISH).  The sum is
// float32, the bias added and the activation applied in float32, the result
// rounded to bf16 once: the reference's _conv_bias_leaky
// (yolo_v3_tpu/models/darknet.py), whose JAX forward leaves the conv to
// XLA; there is no Pallas kernel for these convs.  It replaces the folded
// forward's chunked TF32 cuDNN convs and their float32 passes (the input
// slices' casts, the partial sums, the bias, the activation, the cast
// back), which ops/conv_down.py keeps as the plain version.
//
// The tensor cores truncate their float32 accumulation, and the rounding
// points that this moves grow with the length of the chain (ROADMAP fact 1:
// one TF32 conv over down4's 4608 products moves 0.38% of its bf16 outputs,
// chains of 576 at most 0.063%).  So the wgmma accumulator is added into a
// second float32 sum, with the CUDA cores' rounding, and zeroed every
// PROMOTE = 9 K slots of 64 products a pixel (the plain version's chunks of
// 64 channels x 9 taps): at down4's K = 4608 one accumulator moved 0.26% of
// the outputs, the promotions 0.053% (PERF.md).
//
// What bounds it on the H100.  At YOLOv3-416, batch 32, the downs do 51
// GFLOP each and move 33-530 MB: down0 (32 -> 64 at 208^2) is bound by its
// bytes, down1 sits near the balance point, down2-4 by the tensor cores.
// The stem (3 -> 32) does 10 GFLOP and writes 354 MB: bound by its store.
// Measured, the downs run at 25-45% of that bound, held by the 32 KB a ring
// slot brings from L2 for 1 M MACs (PERF.md).
//
// The downs.  An implicit GEMM, M = output pixels, N = Cout, K = 9 C, on
// m64nNk16 bf16 wgmma with both operands in shared memory, fed by TMA from a
// producer warp through a ring of mbarrier-guarded slots (conv_p2d.cu's
// scheme).  x is seen as pairs of pixels, a 4-D tensor map over [B, H, W/2,
// 2C]: the output column ox of a stride-2 conv reads input columns 2 ox - 1,
// 2 ox and 2 ox + 1, and the last two are pair ox, whose 2C channels lie
// side by side.  So for kernel row dy a tile's K runs over the 2C channels
// of pair ox (taps dx = 1 and 2) and then over the second C channels of
// pair ox - 1 (tap dx = 0), 64 channels a slot, each slot one TMA box per
// output row of the tile (Wt pixel pairs of 128 bytes, 128-byte swizzled)
// at input row 2 oy - ph + dy.  TMA's zero fill is the padding: row -1, row
// H, pair -1, and the channels past 2C (C = 32: the tap dx = 0 slot is half
// zeros).  The weight is K-major in the same order, [N][3 dy][dx = 1, 2, 0
// x C], read as a 3-D map [N][3][3C] in boxes of 64 x BN.  A tile is Ht
// output rows x Wt columns of one image (Wt a power of two from 8 to 64,
// so each box keeps the swizzle's 1024-byte groups); the grid is
// persistent.  The tile shape (consumer warpgroups, BN, blocks an SM) and
// Wt are planned per shape by plan (mirrored by ops/conv_down.py).
//
// The stem.  A 3-channel pixel is 6 bytes and K = 27, which no wgmma
// operand layout takes from x as it lies: a tile is 64 pixels of one output
// row, the threads load its 3 input row segments (x seen as [B][H][3W]) as
// 4-byte words a tile ahead and stage them in shared memory, build the
// 128-byte-swizzled A tile from them (K zero-padded to 32), the weight
// [N][32] is staged once a block, and the same wgmma and epilogue follow.
//
// The epilogue works in registers from the accumulator layout, 64 channels
// at a time (32 for the stem), and stages each warp's 16 pixels through
// shared memory so that every store is 16 bytes wide.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr float LEAKY = 0.1f;
constexpr float MISH_THRESHOLD = 20.f;
constexpr int ACT_LEAKY = 1, ACT_MISH = 2;  // activation codes (0: none)

constexpr int ROW = 128;      // bytes per row of a staged operand: one 128-byte swizzle row
constexpr int BK = 64;        // channels per K slot (one row)
constexpr int EPI_LD = 144;   // bytes per row of a warp's epilogue staging (128 + 16)
constexpr int PROMOTE = 9;    // K slots between promotions of the accumulator (above)
constexpr int STEM_C = 3;     // the stem's input channels ...
constexpr int STEM_K = 32;    // ... and its 27 products a pixel, zero-padded to two k16 steps
// the stem's input rows: 3 of 3 (64 + 2) values, staged as 100 words a row
// (200 values from a 4-byte boundary), 3 loads a thread
constexpr int STEM_WORDS = 100, STEM_LOADS = 3;

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Mish in the plain version's order (ops/activations.py::mish), with the
// fast exponential and division, as conv_p2d.cu and fused_res_block.cu.
__device__ __forceinline__ float mish(float x) {
  if (x > MISH_THRESHOLD) return x;
  const float n = __expf(x), t = __fmul_rn(n, __fadd_rn(n, 2.f));
  return __fdividef(__fmul_rn(x, t), __fadd_rn(t, 2.f));
}

template <bool MISH>
__device__ __forceinline__ float activate(float y, bool leaky) {
  if (MISH) return mish(y);
  return leaky && !(y > 0.f) ? __fmul_rn(LEAKY, y) : y;
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// Tiles and shared memory
// ---------------------------------------------------------------------------

// The downs' tile shapes, chosen per launch by plan: consumer warpgroups
// (BM = 64 * wgs pixels), BN output channels, blocks per SM.  The stem's one
// shape.  TILES is mirrored by ops/conv_down.py::DOWN_TILES.
struct Tiles { int wgs, bn, bps; };
constexpr Tiles TILES[] = {{2, 128, 1}, {2, 64, 1}, {1, 64, 2}};
constexpr int N_TILES = sizeof(TILES) / sizeof(TILES[0]);
constexpr Tiles STEM = {1, 32, 4};  // one warpgroup
constexpr int MIN_WT_SHIFT = 3, MAX_WT_SHIFT = 6;  // tile widths 8 .. 64 pixels

__host__ __device__ constexpr int slot_bytes(int wgs, int bn) { return (64 * wgs + bn) * ROW; }
// Shared memory a block may take when bps blocks share an SM (228 KB, less
// 1 KB the system keeps per block; at most 227 KB for one block).
__host__ __device__ constexpr int smem_budget(int bps) {
  return bps == 1 ? 232448 : 233472 / bps - 1024;
}
// + 1024: the alignment of the ring (the swizzle follows the address); each
// consumer warp's 16-row epilogue staging; two mbarriers a slot (at most 8)
__host__ __device__ constexpr int fixed_smem(int wgs) { return 1024 + 4 * wgs * 16 * EPI_LD + 128; }
__host__ __device__ constexpr int ring_slots(int wgs, int bn, int bps) {
  return (smem_budget(bps) - fixed_smem(wgs)) / slot_bytes(wgs, bn) < 8
             ? (smem_budget(bps) - fixed_smem(wgs)) / slot_bytes(wgs, bn)
             : 8;
}
__host__ __device__ constexpr int smem_bytes(int wgs, int bn, int bps) {
  return fixed_smem(wgs) + ring_slots(wgs, bn, bps) * slot_bytes(wgs, bn);
}
// the stem: alignment, one A tile, the weight, the epilogue staging, the
// input rows
__host__ __device__ constexpr int stem_smem() {
  return 1024 + (64 + STEM.bn) * ROW + 4 * 16 * EPI_LD + 3 * STEM_WORDS * 4;
}

// What a launch computes and how its tiles cut the output.
struct Geo {
  int B, H, W, C, N;   // x [B, H, W, C], the weight's N output channels
  int Ho, Wo, ph;      // out [B, Ho, Wo, N]; rows of zero padding above and below
  int wt_shift, ht;    // the downs' tile: Ht = ht rows x Wt = 2^wt_shift columns
  int th, tw;          // tiles an image down and across
  int act;            // activation code
};

// ---------------------------------------------------------------------------
// Epilogue
// ---------------------------------------------------------------------------

// This warp's 16 rows of a tile (row0 ..): bias, activation, one rounding,
// 16-byte stores.  acc is the float32 sum in the wgmma layout (thread t
// holds d[4i + 2h + e] = row (t % 32) / 4 + 8h of the warp, column 8i + 2 (t
// % 4) + e); pix(r) is the output pixel of tile row r, or -1 outside out.
template <int BNV, bool MISH, typename Pix>
__device__ __forceinline__ void store_tile(const float (&acc)[BNV / 2],
                                           const float* __restrict__ bias, bool leaky,
                                           bf16* __restrict__ out, int N, int n0, int row0,
                                           const Pix& pix, unsigned char* stage, int lane) {
  constexpr int CH = BNV < 64 ? BNV : 64, RUNS = CH * 2 / 16;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int cc = 0; cc < BNV / CH; ++cc) {
    const int nc = n0 + cc * CH;
    if (nc >= N) break;  // uniform in the warp
    float bi[CH / 4];
#pragma unroll
    for (int j = 0; j < CH / 4; ++j) {
      const int n = nc + 8 * (j / 2) + 2 * q + j % 2;
      bi[j] = __ldg(bias + (n < N ? n : N - 1));
    }
#pragma unroll
    for (int i = 0; i < CH / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = 4 * (cc * CH / 8 + i) + 2 * h;
        const float y0 = activate<MISH>(__fadd_rn(acc[a], bi[2 * i]), leaky);
        const float y1 = activate<MISH>(__fadd_rn(acc[a + 1], bi[2 * i + 1]), leaky);
        *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8 * h) * EPI_LD + (8 * i + 2 * q) * 2) =
            __floats2bfloat162_rn(y0, y1);
      }
    __syncwarp();
    for (int i = lane; i < 16 * RUNS; i += 32) {
      const int row = i / RUNS, k = i % RUNS;
      const long long p = pix(row0 + row);
      if (p >= 0 && nc + 8 * k < N)
        *reinterpret_cast<int4*>(out + p * N + nc + 8 * k) =
            *reinterpret_cast<const int4*>(stage + row * EPI_LD + k * 16);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// The downs: wgmma fed by TMA from a producer warp, persistent grid
// ---------------------------------------------------------------------------

// Warp 4 * WGS is the producer: one thread issues every TMA load through
// the ring's slots, each with a `full` barrier (its bytes in) and an `empty`
// one (the consumer warps out).  Warpgroup wg owns tile rows [64 wg, 64 wg +
// 64).  Tile t: pixels (t % m_tiles) -> image b, rows oy0 .., columns ox0
// ..; channels n0 = (t / m_tiles) * BN.
template <int WGS, int BNV, int BPS, bool MISH>
__device__ __forceinline__ void down_tiles(const CUtensorMap* x_map, const CUtensorMap* w_map,
                                           const float* __restrict__ bias,
                                           bf16* __restrict__ out, const Geo& g,
                                           unsigned char* ring) {
  constexpr int BM = 64 * WGS, NS = ring_slots(WGS, BNV, BPS), SLOT = slot_bytes(WGS, BNV);
  constexpr int A_BYTES = BM * ROW;
  static_assert(NS >= 2, "the ring must hold two slots");
  unsigned char* staging = ring + NS * SLOT;  // [4 * WGS warps][16][EPI_LD]
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
  // sees the wgmma path as convergent (else it serializes every wgmma)
  const int lane = threadIdx.x % 32, warp = __shfl_sync(0xffffffff, threadIdx.x / 32, 0);
  const int wt = 1 << g.wt_shift, per_image = g.th * g.tw, m_tiles = g.B * per_image;
  const int tiles = m_tiles * ceil_div(g.N, BNV);
  const int pairs = ceil_div(2 * g.C, BK);       // slots of taps dx = 1, 2 (pair ox)
  const int kpd = pairs + ceil_div(g.C, BK);     // + slots of tap dx = 0 (pair ox - 1)
  const int steps = 3 * kpd;
  auto origin = [&](int t, int& b, int& oy0, int& ox0, int& n0) {
    const int mt = t % m_tiles, r = mt % per_image;
    b = mt / per_image;
    oy0 = r / g.tw * g.ht;
    ox0 = (r % g.tw) << g.wt_shift;
    n0 = t / m_tiles * BNV;
  };

  if (warp == 4 * WGS) {
    // ---- producer ------------------------------------------------------------
    if (lane == 0) {
      tma_prefetch_map(x_map);
      tma_prefetch_map(w_map);
      int slot = 0, phase = 0, it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int b, oy0, ox0, n0;
        origin(t, b, oy0, ox0, n0);
        for (int s = 0; s < steps; ++s, ++it) {
          const int dy = s / kpd, j = s % kpd;
          const bool left = j >= pairs;  // tap dx = 0: the second pixel of pair ox - 1
          const int xc = left ? g.C + (j - pairs) * BK : j * BK;
          const int wk = left ? 2 * g.C + (j - pairs) * BK : j * BK;
          if (it >= NS) mbar_wait(&empty[slot], phase ^ 1);
          unsigned char* st = ring + slot * SLOT;
          mbar_expect_tx(&full[slot], SLOT);
          for (int hr = 0; hr < g.ht; ++hr)
            tma_load_4d(st + hr * wt * ROW, x_map, &full[slot], xc, ox0 - (left ? 1 : 0),
                        2 * (oy0 + hr) - g.ph + dy, b);
          tma_load_3d(st + A_BYTES, w_map, &full[slot], wk, dy, n0);
          if (++slot == NS) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers -----------------------------------------------------------------
  const int wg = warp / 4, wq = warp % 4;
  const bool leaky = g.act == ACT_LEAKY;
  unsigned char* stage = staging + warp * 16 * EPI_LD;
  int slot = 0, phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int b, oy0, ox0, n0;
    origin(t, b, oy0, ox0, n0);
    float acc[BNV / 2], sum[BNV / 2];
#pragma unroll
    for (int i = 0; i < BNV / 2; ++i) acc[i] = sum[i] = 0.f;
    int prev = 0, run = 0;
    for (int s = 0; s < steps; ++s) {
      mbar_wait(&full[slot], phase);
      const unsigned char* st = ring + slot * SLOT;
      wgmma_fence();
      const uint64_t da = wgmma_desc(st + wg * 64 * ROW), db = wgmma_desc(st + A_BYTES);
#pragma unroll
      for (int k = 0; k < ROW / 32; ++k) wgmma_ss<BNV>(acc, da + 2 * k, db + 2 * k);
      wgmma_commit();
      wgmma_wait<1>();  // the previous slot's group: hand its slot back
      if (s > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = slot;
      if (++slot == NS) {
        slot = 0;
        phase ^= 1;
      }
      if (++run == PROMOTE || s == steps - 1) {  // promote: sum += acc, acc = 0
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int i = 0; i < BNV / 2; ++i) {
          sum[i] = __fadd_rn(sum[i], acc[i]);
          acc[i] = 0.f;
        }
        run = 0;
      }
    }
    // the last step promoted; this wait only shows ptxas that nothing is in
    // flight on every path to the next tile's writes of acc
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);
    const int mask = wt - 1;
    auto pix = [&](int r) -> long long {
      const int oy = oy0 + (r >> g.wt_shift), ox = ox0 + (r & mask);
      return oy < g.Ho && ox < g.Wo ? ((long long)b * g.Ho + oy) * g.Wo + ox : -1;
    };
    store_tile<BNV, MISH>(sum, bias, leaky, out, g.N, n0, wg * 64 + wq * 16, pix, stage, lane);
  }
}

// ---------------------------------------------------------------------------
// The stem: the input rows staged in shared memory, A built from them
// ---------------------------------------------------------------------------

// One warpgroup a block.  A tile: 64 output pixels of one output row, (b,
// oy, ox0 ..); channels n0.  Its input is 3 rows x 3 (64 + 2) values (x seen
// as [B][H][3W]): the threads load them as 4-byte words (zero outside) into
// registers a tile ahead, so that the loads fly during the tile before, and
// store them into shared memory; each thread then writes half the K of one
// pixel's A row (K = (3 dy + dx) * 3 + c: the 9 values of row dy from pixel
// ox0 + r - 1 on, zeros from 27) into the swizzled A tile.
template <int BNV, bool MISH>
__device__ __forceinline__ void stem_tiles(const bf16* __restrict__ x, const bf16* __restrict__ w,
                                           const float* __restrict__ bias,
                                           bf16* __restrict__ out, const Geo& g,
                                           unsigned char* base) {
  unsigned char* a_tile = base;                          // [64][ROW], 128-byte swizzled
  unsigned char* b_tile = a_tile + 64 * ROW;             // [BNV][ROW]
  unsigned char* staging = b_tile + BNV * ROW;           // [4 warps][16][EPI_LD]
  uint32_t* rows = reinterpret_cast<uint32_t*>(staging + 4 * 16 * EPI_LD);  // [3][STEM_WORDS]
  const int lane = threadIdx.x % 32, warp = __shfl_sync(0xffffffff, threadIdx.x / 32, 0);
  const int r = threadIdx.x % 64, half = threadIdx.x / 64;
  const int tw = ceil_div(g.Wo, 64), tiles = g.B * g.Ho * tw * ceil_div(g.N, BNV);
  const int row_words = 3 * g.W / 2;
  const bool leaky = g.act == ACT_LEAKY;
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(x);
  unsigned char* stage = staging + warp * 16 * EPI_LD;
  // a block walks a contiguous run of tiles (ox0 fastest, then oy, b, n0),
  // stepping the coordinates rather than dividing the tile index
  struct At { int ox0, oy, b, n0; };
  auto step = [&](At a) {
    if ((a.ox0 += 64) >= g.Wo) {
      a.ox0 = 0;
      if (++a.oy == g.Ho) {
        a.oy = 0;
        if (++a.b == g.B) {
          a.b = 0;
          a.n0 += BNV;
        }
      }
    }
    return a;
  };
  const int per_block = ceil_div(tiles, gridDim.x), t0 = blockIdx.x * per_block;
  const int t1 = t0 + per_block < tiles ? t0 + per_block : tiles;
  At at;
  {
    const int mt = t0 % (g.B * g.Ho * tw), row = mt / tw;
    at = {mt % tw * 64, row % g.Ho, row / g.Ho, t0 / (g.B * g.Ho * tw) * BNV};
  }
  // this thread's input words of a tile: row dy, words from element 3 ox0 - 4
  // (4-byte aligned: 3 ox0 is a multiple of 192), so value 3 (ox0 + r - 1 +
  // dx) + c of the row is element 3 r + 3 dx + c + 1 of the words
  int w_dy[STEM_LOADS], w_col[STEM_LOADS];
#pragma unroll
  for (int i = 0; i < STEM_LOADS; ++i) {
    w_dy[i] = (threadIdx.x + 128 * i) / STEM_WORDS;
    w_col[i] = (threadIdx.x + 128 * i) % STEM_WORDS;
  }
  auto fetch = [&](bool live, At a, uint32_t (&v)[STEM_LOADS]) {
#pragma unroll
    for (int i = 0; i < STEM_LOADS; ++i) {
      const int e = 3 * a.ox0 / 2 - 2 + w_col[i], iy = a.oy - g.ph + w_dy[i];
      v[i] = live && w_dy[i] < 3 && iy >= 0 && iy < g.H && e >= 0 && e < row_words
                 ? __ldg(xw + ((size_t)a.b * g.H + iy) * row_words + e)
                 : 0u;
    }
  };
  uint32_t next[STEM_LOADS];
  fetch(t0 < t1, at, next);
  int loaded = -1;
  for (int t = t0; t < t1; ++t, at = step(at)) {
    const int b = at.b, oy = at.oy, ox0 = at.ox0, n0 = at.n0;
    if (n0 != loaded) {  // the weight rows n0 .. n0 + BNV, K-major, swizzled
      __syncthreads();
      for (int i = threadIdx.x; i < BNV * STEM_K / 8; i += blockDim.x) {
        const int n = i / (STEM_K / 8), j = i % (STEM_K / 8);
        int4 v = make_int4(0, 0, 0, 0);
        if (n0 + n < g.N) v = *reinterpret_cast<const int4*>(w + (size_t)(n0 + n) * STEM_K + 8 * j);
        *reinterpret_cast<int4*>(b_tile + n * ROW + ((j ^ (n & 7)) << 4)) = v;
      }
      fence_proxy_async();
      __syncthreads();
      loaded = n0;
    }
#pragma unroll
    for (int i = 0; i < STEM_LOADS; ++i)
      if (w_dy[i] < 3) rows[threadIdx.x + 128 * i] = next[i];
    named_barrier_sync(1, 128);  // the rows stored; the last tile's wgmma has read A
    fetch(t + 1 < t1, step(at), next);
    {
      const unsigned short* src = reinterpret_cast<const unsigned short*>(rows) + 3 * r + 1;
      uint32_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int k = 16 * half + e;  // warp-uniform half: a branch per warp
        if (k < 9 * STEM_C)
          v[e / 2] |= (uint32_t)src[k / 9 * 2 * STEM_WORDS + k % 9] << (16 * (e % 2));
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
        *reinterpret_cast<uint4*>(a_tile + r * ROW + (((2 * half + c) ^ (r & 7)) << 4)) =
            make_uint4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    }
    fence_proxy_async();
    named_barrier_sync(1, 128);  // A written; the rows read
    float acc[BNV / 2];
#pragma unroll
    for (int i = 0; i < BNV / 2; ++i) acc[i] = 0.f;
    wgmma_fence();
    const uint64_t da = wgmma_desc(a_tile), db = wgmma_desc(b_tile);
#pragma unroll
    for (int k = 0; k < STEM_K / 16; ++k) wgmma_ss<BNV>(acc, da + 2 * k, db + 2 * k);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    auto pix = [&](int row) -> long long {
      return ox0 + row < g.Wo ? ((long long)b * g.Ho + oy) * g.Wo + ox0 + row : -1LL;
    };
    store_tile<BNV, MISH>(acc, bias, leaky, out, g.N, n0, warp * 16, pix, stage, lane);
  }
}

// One kernel for the stem (IS_STEM: one warpgroup, x and w through
// pointers) and the downs (through the tensor maps).
template <bool IS_STEM, int WGS, int BNV, int BPS, bool MISH>
__global__ void __launch_bounds__(IS_STEM ? 128 * WGS : 128 * WGS + 32, BPS)
    conv_down_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap w_map, const bf16* __restrict__ x,
                          const bf16* __restrict__ w, const float* __restrict__ bias,
                          bf16* __restrict__ out, const Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  if constexpr (IS_STEM)
    stem_tiles<BNV, MISH>(x, w, bias, out, g, base);
  else
    down_tiles<WGS, BNV, BPS, MISH>(&x_map, &w_map, bias, out, g, base);
}

// ---------------------------------------------------------------------------
// Host: plans, tensor maps, launch
// ---------------------------------------------------------------------------

// The tile width (as a shift) of a BM-pixel tile over an Ho x Wo output:
// the power of two from 8 to 64 (at most BM) whose tiles cover it with the
// fewest pixels; the widest on a tie.
int tile_width(int bm, int Ho, int Wo) {
  int best = MIN_WT_SHIFT;
  long long best_area = -1;
  for (int s = MIN_WT_SHIFT; s <= MAX_WT_SHIFT && (1 << s) <= bm; ++s) {
    const int wt = 1 << s, ht = bm / wt;
    const long long area = (long long)ceil_div(Ho, ht) * ht * ceil_div(Wo, wt) * wt;
    if (best_area < 0 || area <= best_area) {
      best_area = area;
      best = s;
    }
  }
  return best;
}

// The planner's cost of a down with TILES[v], in SM clocks (conv_p2d.cu's
// model and rates): per slot the larger of its tensor-core time (BM * BN *
// 64 MACs at 2048 a clock) and the time to bring its bytes into the SM (64
// a clock); the persistent grid gives each SM ceil(grid / sms) blocks of
// ceil(tiles / grid) tiles; each tile's epilogue takes 3/16 clock an output.
long long tiles_cost(int v, int B, int Ho, int Wo, int C, int N, int sms) {
  const Tiles t = TILES[v];
  const int bm = 64 * t.wgs, wt = 1 << tile_width(bm, Ho, Wo), ht = bm / wt;
  const long long tiles =
      (long long)B * ceil_div(Ho, ht) * ceil_div(Wo, wt) * ceil_div(N, t.bn);
  const long long steps = 3LL * (ceil_div(2 * C, BK) + ceil_div(C, BK));
  const long long grid = tiles < (long long)sms * t.bps ? tiles : (long long)sms * t.bps;
  const long long mma = (long long)bm * t.bn * BK / 2048, load = slot_bytes(t.wgs, t.bn) / 64;
  const long long per_block = (tiles + grid - 1) / grid;
  return (grid + sms - 1) / sms * per_block * steps * (mma > load ? mma : load) +
         per_block * bm * t.bn * 3 / 16;
}

int plan(int B, int Ho, int Wo, int C, int N, int sms) {
  int best = 0;
  for (int v = 1; v < N_TILES; ++v)
    if (tiles_cost(v, B, Ho, Wo, C, N, sms) < tiles_cost(best, B, Ho, Wo, C, N, sms)) best = v;
  return best;
}

template <bool S, int WGS, int BNV, int BPS>
const void* kernel_fn(bool mish) {
  return mish ? reinterpret_cast<const void*>(conv_down_bf16_kernel<S, WGS, BNV, BPS, true>)
              : reinterpret_cast<const void*>(conv_down_bf16_kernel<S, WGS, BNV, BPS, false>);
}

// variant -1: the stem; else an index of TILES
const void* kernel_of(int variant, bool mish) {
  static_assert(N_TILES == 3, "one kernel per tile shape");
  constexpr Tiles a = TILES[0], b = TILES[1], c = TILES[2];
  switch (variant) {
    case -1: return kernel_fn<true, STEM.wgs, STEM.bn, STEM.bps>(mish);
    case 0: return kernel_fn<false, a.wgs, a.bn, a.bps>(mish);
    case 1: return kernel_fn<false, b.wgs, b.bn, b.bps>(mish);
    default: return kernel_fn<false, c.wgs, c.bn, c.bps>(mish);
  }
}

// Let a down kernel take its shared memory (above 48 KB only after this
// call), once per device and kernel.
std::mutex smem_mutex;
struct Allowed { int dev; const void* fn; };
Allowed allowed[64];
int n_allowed = 0;

int allow_smem(int dev, const void* fn, int bytes) {
  std::lock_guard<std::mutex> lock(smem_mutex);
  for (int i = 0; i < n_allowed; ++i)
    if (allowed[i].dev == dev && allowed[i].fn == fn) return 0;
  const int e = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == 0 && n_allowed < 64) allowed[n_allowed++] = {dev, fn};
  return e;
}

// The output geometry: the stem (C = 3) at stride 1, a down at stride 2;
// false for operands the kernel does not take.
bool geometry(int B, int H, int W, int C, int N, int ph, int* Ho, int* Wo) {
  if (B <= 0 || H <= 0 || W <= 0 || N <= 0 || N % 8 || ph < 0 || ph > 1) return false;
  if (C == STEM_C) {
    if (W % 2) return false;  // 4-byte words of [B][H][3W]
    *Ho = H + 2 * ph - 2;
    *Wo = W;
  } else {
    if (C <= 0 || C % 8 || W % 2) return false;  // TMA: 16-byte rows; pixel pairs
    *Ho = (H + 2 * ph - 3) / 2 + 1;
    *Wo = W / 2;
  }
  return *Ho > 0 && *Wo > 0 && (long long)B * *Ho * *Wo < (1LL << 31);
}

// variant / wt_shift: an index of TILES and a tile width, or -1 for the
// planner's; ignored for the stem.
int launch(int variant, int wt_shift, const void* x, const void* w,
           const void* bias, void* out, int B, int H, int W, int C, int N, int ph, int act,
           void* stream) {
  int Ho = 0, Wo = 0;
  if (!geometry(B, H, W, C, N, ph, &Ho, &Wo) || act < 0 || act > ACT_MISH ||
      variant < -1 || variant >= N_TILES)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, e = (int)cudaGetDevice(&dev);
  if (e == 0) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != 0) return e;
  Geo g = {B, H, W, C, N, Ho, Wo, ph, 0, 0, 0, 0, act};
  CUtensorMap x_map, w_map;
  std::memset(&x_map, 0, sizeof(x_map));
  std::memset(&w_map, 0, sizeof(w_map));
  const bool mish = act == ACT_MISH;
  void* args[] = {&x_map, &w_map, &x, &w, &bias, &out, &g};
  if (C == STEM_C) {  // a persistent grid of one-warpgroup blocks
    const long long tiles = (long long)B * Ho * ceil_div(Wo, 64) * ceil_div(N, STEM.bn);
    const long long cap = (long long)sms * STEM.bps;
    return (int)cudaLaunchKernel(kernel_of(-1, mish), dim3((unsigned)(tiles < cap ? tiles : cap)),
                                 dim3(128), args, stem_smem(), static_cast<cudaStream_t>(stream));
  }
  if (variant < 0) variant = plan(B, Ho, Wo, C, N, sms);
  const Tiles t = TILES[variant];
  const int bm = 64 * t.wgs;
  if (wt_shift < 0) wt_shift = tile_width(bm, Ho, Wo);
  if (wt_shift < MIN_WT_SHIFT || wt_shift > MAX_WT_SHIFT || (1 << wt_shift) > bm)
    return (int)cudaErrorInvalidValue;
  g.wt_shift = wt_shift;
  g.ht = bm >> wt_shift;
  g.th = ceil_div(Ho, g.ht);
  g.tw = ceil_div(Wo, 1 << wt_shift);
  // x as pixel pairs [B][H][W/2][2C]; the weight [N][3][3C]
  const cuuint64_t x_dims[4] = {(cuuint64_t)(2 * C), (cuuint64_t)(W / 2), (cuuint64_t)H,
                                (cuuint64_t)B};
  const cuuint64_t x_strides[3] = {(cuuint64_t)4 * C, (cuuint64_t)2 * C * W,
                                   (cuuint64_t)2 * C * W * H};
  const cuuint32_t x_box[4] = {BK, (cuuint32_t)(1 << wt_shift), 1, 1};
  const cuuint64_t w_dims[3] = {(cuuint64_t)(3 * C), 3, (cuuint64_t)N};
  const cuuint64_t w_strides[2] = {(cuuint64_t)6 * C, (cuuint64_t)18 * C};
  const cuuint32_t w_box[3] = {BK, 1, (cuuint32_t)t.bn};
  const void* fn = kernel_of(variant, mish);
  const int smem = smem_bytes(t.wgs, t.bn, t.bps);
  if ((e = tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 4, x_dims, x_strides,
                      x_box)) != 0 ||
      (e = tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, 3, w_dims, w_strides,
                      w_box)) != 0 ||
      (e = allow_smem(dev, fn, smem)) != 0)
    return e;
  const long long tiles = (long long)B * g.th * g.tw * ceil_div(N, t.bn);
  const long long cap = (long long)sms * t.bps;
  return (int)cudaLaunchKernel(fn, dim3((unsigned)(tiles < cap ? tiles : cap)),
                               dim3(128 * t.wgs + 32), args, smem,
                               static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Each returns the launch's cudaError_t (0 on success).  x NHWC bf16 [B, H,
// W, C] (C = 3: the stem, stride 1; else a down, stride 2, C % 8 == 0, W
// even, x 16-byte aligned); w the K-major weight: the stem's [N][32] (K =
// (3 dy + dx) * 3 + c, zeros from 27), a down's [N][3 dy][dx = 1, 2, 0][C];
// bias [N] float32; out NHWC bf16 [B, Ho, Wo, N], N % 8 == 0; ph the rows of
// zero padding above and below (1, or 0 for a stripe that carries its
// halo); act the activation code (0 none, 1 leaky, 2 Mish).  All device
// pointers to contiguous arrays; the kernel runs on `stream` and does not
// synchronise.
int yolo_conv_down_bf16(const void* x, const void* w, const void* bias, void* out, int B, int H,
                        int W, int C, int N, int ph, int act, void* stream) {
  return launch(-1, -1, x, w, bias, out, B, H, W, C, N, ph, act, stream);
}

// A down with the tile shape TILES[variant] and the tile width 2^wt_shift
// forced, so that every shape can be held to the plain version whatever the
// planner picks (the other arguments as above).
int yolo_conv_down_tiles(int variant, int wt_shift, const void* x, const void* w,
                         const void* bias, void* out, int B, int H, int W, int C, int N, int ph,
                         int act, void* stream) {
  if (variant < 0 || wt_shift < 0) return (int)cudaErrorInvalidValue;
  return launch(variant, wt_shift, x, w, bias, out, B, H, W, C, N, ph, act, stream);
}

// The planner's choice for a down on the current device, as 16 * (an index
// of TILES) + the tile width's shift, or minus a cudaError_t.
int yolo_conv_down_plan(int B, int H, int W, int C, int N, int ph) {
  int Ho = 0, Wo = 0, dev = 0, sms = 0;
  if (C == STEM_C || !geometry(B, H, W, C, N, ph, &Ho, &Wo)) return -(int)cudaErrorInvalidValue;
  int e = (int)cudaGetDevice(&dev);
  if (e == 0) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != 0) return -e;
  const int v = plan(B, Ho, Wo, C, N, sms);
  return 16 * v + tile_width(64 * TILES[v].wgs, Ho, Wo);
}

const char* yolo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
