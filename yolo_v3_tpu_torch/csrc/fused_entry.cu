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
// What bounds it on the H100.  Kept on chip, the chain moves only the 2.8 MB
// image and the 11 MB output at 416 and batch 8, against 8.75 GMAC an image:
// 140 Gop, 0.071 ms of int8 tensor-core work at 1,979 TOP/s.  Its weights
// (752 KB for the five convs) do not fit in shared memory, so every block
// that computes a piece of the chain reads all of them from L2 again; the
// fewer pieces, the less L2 traffic.
//
// What the design does about it.
// - Row streaming.  A work item is (image, band of HB output rows, strip of
//   WS = 26 output columns).  The block walks down its band S = 2 output rows
//   a step, and each intermediate lives in a ring of image rows in shared
//   memory that holds only what the next conv still needs: the four stem
//   planes and down0 S + 1 rows, res0_1 S + 2, res0_2 S + 1.  Only the 4
//   halo columns of a strip and the first rows of a band are computed twice.
// - Every conv a flat implicit GEMM that wgmma reads from shared memory.  A
//   ring stores its rows P1 = WS + 4 pixels wide, one pixel one 128-byte row
//   of 128 int8 channels (256 channels: two planes), with the 128-byte
//   swizzle that TMA would write (16-byte chunk j of the row at address a
//   stored at chunk j ^ ((a >> 7) & 7)).  A step's S * P1 = 60 positions of
//   a conv are one 64-row wgmma tile, and each tap of a stride-1 conv is the
//   same tile at a constant row offset (a descriptor may start at any row
//   of a swizzled buffer).  Positions whose taps run off the row into the
//   next one are computed and never used; positions outside the image are
//   written as 0, the next conv's zero padding.  The rows that a ring
//   carries into the next step are copied to its head at the start of each
//   step (descriptors cannot wrap around a ring).
// - down0's stride 2.  The stem writes its output as four polyphase planes
//   (row parity x column parity, TPU kernel's _phase2), so each of down0's 9
//   taps is a stride-1 read of one plane at a constant offset.
// - The stem's 12 channels a tap.  Its 9 taps are gathered from xb (global
//   memory, L2-resident) into one im2col row of 108 -> 128 bytes, a single
//   K slot, and the stem runs as a 1x1 over it.
// - Weights by TMA.  One producer warp streams every conv's K-major weight
//   (a 3-D [N][taps][C] map) through a ring of 16 KB slots (128 output
//   channels x 128 bytes of K), guarded by mbarriers; two consumer
//   warpgroups run wgmma m64nNk32.s32.s8.s8, each on half of the output
//   channels, while the next slots load.  N = 256 convs take two slots a K
//   slice.
// - No multicast.  Clusters of 2 blocks on neighbouring strips that load
//   each weight slot once for both (.multicast::cluster) measured no faster
//   on the H100: the weight stream is not what bounds the kernel (without
//   its loads it is ~6% faster; PERF.md), so every block loads its own.
// - The epilogue keeps every conv's (m, b) pairs in shared memory, loads
//   them and the residuals of 4 groups of 8 channels before their math, has
//   no branches, and stores 16 bytes a lane to global memory after a
//   transpose within each quad of lanes.
// - Persistent grid: min(work items, SMs) blocks walk the work items; the
//   band height HB is picked by a planner (plan_band, mirrored by
//   ops/entry_kernel.py::plan_entry) so that the items fill the card in as
//   few steps as it can.
// - Registers: two consumer warpgroups and a producer warpgroup (one warp of
//   it loads), which gives its registers to the consumers (setmaxnreg).
//
// What bounds it now (PERF.md).  At 416 and batch 8 a block walks 15 steps
// of ~40 K clocks, against ~13 K of tensor-core work a step: each conv's
// epilogue, the stem's im2col loads and the slot handshakes run while the
// tensor cores wait, at one block an SM (the rings take the shared memory).

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "sm90.cuh"

namespace {

constexpr float LEAKY = 0.1f;
constexpr int ROW = 128;            // bytes a pixel: 128 int8 channels, one swizzle row
constexpr int P1 = 30;              // pixels a ring row: a strip and its 4 halo columns
constexpr int WS = P1 - 4;          // output columns a strip
constexpr int S = 2;                // output rows a step
constexpr int TILE = 64;            // wgmma rows: a step's S * P1 positions, and 4 unused
constexpr int POS = S * P1;
static_assert(POS <= TILE, "a step's positions must fit one wgmma tile");
constexpr int NS = 6;               // weight ring slots
constexpr int SLOT = 128 * ROW;     // one slot: 128 output channels x 128 bytes of K
constexpr int NCW = 8;              // consumer warps: two warpgroups
constexpr int NT = 32 * NCW + 128;  // and a producer warpgroup (one warp of it loads)
// setmaxnreg: a quarter of the SM holds 2 consumer warps and 1 producer warp
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int CIN = 12;             // xb channels

// shared memory, from a 1024-byte-aligned base
constexpr int PLANE = (S + 1) * P1 * ROW;     // a stem plane, a channel plane of down0, res0_2
constexpr int R1_BYTES = (S + 2) * P1 * ROW;  // res0_1
constexpr int OFF_COL = NS * SLOT;            // the stem's im2col: two tiles
constexpr int OFF_PLANES = OFF_COL + 2 * TILE * ROW;
constexpr int OFF_D0 = OFF_PLANES + 4 * PLANE;
constexpr int OFF_R1 = OFF_D0 + 2 * PLANE;
constexpr int OFF_R2 = OFF_R1 + R1_BYTES;
constexpr int OFF_GUARD = OFF_R2 + 2 * PLANE + 512;  // a row that takes discarded stores
constexpr int OFF_MB = OFF_R2 + 2 * PLANE + 1024;    // + tiles that read past res0_2
constexpr int MB_CH = 896;                          // (m, b) of the 5 convs' channels
constexpr int OFF_BAR = OFF_MB + MB_CH * 8;
constexpr int SMEM = 1024 + OFF_BAR + 2 * NS * 8;
// each conv's first channel in the (m, b) table
__host__ __device__ constexpr int mb_base(int c) {
  return c == 0 ? 0 : c == 1 ? 128 : c == 2 ? 384 : c == 3 ? 512 : 768;
}
static_assert(SMEM <= 232448, "shared memory of one block");

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ int8_t requant(float y) {
  const int v = __float2int_rn(y);  // round half to even
  return (int8_t)(v > 127 ? 127 : (v < -127 ? -127 : v));
}

// leaky(acc * m + b), each step rounded; max(y, 0.1 y) is the leaky's value
// for every y (the plain version's where(y > 0, y, 0.1 y)), signed zeros too
__device__ __forceinline__ float epi(int acc, float m, float b) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), m), b);
  return fmaxf(y, __fmul_rn(LEAKY, y));
}

// The byte offset of channel c (< 128) of the pixel row at offset `row`
// (128-byte aligned), in the 128-byte swizzle.
__device__ __forceinline__ unsigned swz(unsigned row, int c) {
  return row + ((((c >> 4) ^ (row >> 7)) & 7) << 4) + (c & 15);
}

// Shared memory by byte offset from the 1024-byte-aligned base `sm` (so an
// offset's low bits are the address bits the swizzle reads), as plain
// accesses the compiler may schedule; the barriers and proxy fences order
// them against wgmma.
__device__ __forceinline__ void st_u16(unsigned char* sm, unsigned off, unsigned short v) {
  *reinterpret_cast<unsigned short*>(sm + off) = v;
}
__device__ __forceinline__ unsigned short ld_u16(const unsigned char* sm, unsigned off) {
  return *reinterpret_cast<const unsigned short*>(sm + off);
}
__device__ __forceinline__ uint4 ld_v4(const unsigned char* sm, unsigned off) {
  return *reinterpret_cast<const uint4*>(sm + off);
}
__device__ __forceinline__ float4 ld_f4(const unsigned char* sm, unsigned off) {
  return *reinterpret_cast<const float4*>(sm + off);
}
__device__ __forceinline__ void st_v4(unsigned char* sm, unsigned off, uint4 v) {
  *reinterpret_cast<uint4*>(sm + off) = v;
}

// The 256 consumer threads' barrier (the producer warpgroup is not in it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * NCW) : "memory");
}

// ---------------------------------------------------------------------------
// Planner (mirrored by ops/entry_kernel.py::plan_entry)
// ---------------------------------------------------------------------------

// Steps of a band of `rows` output rows: the walk starts 3 rows above the
// band, so that every ring holds what the band's first row needs.
__host__ __device__ constexpr int band_steps(int rows) { return ceil_div(rows + 4, S); }

// The band height: the least (waves of work items over the sms resident
// blocks) x (steps a band), then the least total steps.
int plan_band(int B, int h, int w, int sms) {
  const int strips = ceil_div(w, WS);
  int best = h;
  long long best_cost = -1, best_work = -1;
  for (int hb = 1; hb <= h; ++hb) {
    const long long units = (long long)B * ceil_div(h, hb) * strips;
    const long long steps = band_steps(hb);
    const long long cost = (units + sms - 1) / sms * steps, work = units * steps;
    if (best_cost < 0 || cost < best_cost || (cost == best_cost && work < best_work)) {
      best = hb;
      best_cost = cost;
      best_work = work;
    }
  }
  return best;
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

struct Convs {
  const float* m[5];
  const float* b[5];
};

// The weight slots of one step, in the order the producer loads them and the
// consumers read them: per conv, per K slice (tap, then 128-channel plane of
// K), per 128 output channels.  stem 1, down0 9 x 2, res0_1 2, res0_2 9 x 2,
// down1 8.
__host__ __device__ constexpr int conv_taps(int c) {
  return c == 1 || c == 3 ? 9 : c == 4 ? 4 : 1;
}
__host__ __device__ constexpr int conv_kplanes(int c) { return c == 2 || c == 4 ? 2 : 1; }
__host__ __device__ constexpr int conv_halves(int c) { return c == 1 || c == 3 ? 2 : 1; }

// The B operand of warpgroup wg for the K slice whose first slot is the
// it-th loaded: NH = 128, its own slot of the slice's two; NH = 64, its half
// of the slice's one slot.
template <int NH>
__device__ __forceinline__ const unsigned char* slice_b(const unsigned char* slots, int it,
                                                        int wg) {
  return NH == 128 ? slots + ((it + wg) % NS) * SLOT : slots + (it % NS) * SLOT + wg * 64 * ROW;
}

// Hand n slots from the it-th back to the producer (one arrive a warp).
__device__ __forceinline__ void release(uint64_t* empty, int it, int n, int lane) {
  if (lane != 0) return;
  for (int i = 0; i < n; ++i) mbar_arrive(&empty[(it + i) % NS]);
}

// One conv over a step's tile: `slices` K slices, each 4 wgmmas of 32 bytes
// of K, A at a_of(slice), B this warpgroup's NH output channels of the
// slice's slot(s).  Each slice's slots go back to the producer once the
// next slice's wgmmas are issued and this one's are done.
template <int NH, class AOf>
__device__ __forceinline__ void conv_mma(int (&acc)[NH / 2], int slices, AOf a_of, int wg,
                                         int lane, const unsigned char* slots, uint64_t* full,
                                         uint64_t* empty, int& it) {
  constexpr int HV = NH == 128 ? 2 : 1;  // slots a slice
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) acc[i] = 0;
  fence_regs(acc);  // the zeros before the first wgmma_fence
  int prev = 0;
  for (int s = 0; s < slices; ++s) {
    const int mine = NH == 128 ? it + wg : it;
    mbar_wait(&full[mine % NS], (mine / NS) & 1);
    const uint64_t da = wgmma_desc(a_of(s));
    const uint64_t db = wgmma_desc(slice_b<NH>(slots, it, wg));
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < ROW / 32; ++k) wgmma_ss<NH>(acc, da + 2 * k, db + 2 * k);
    wgmma_commit();
    wgmma_wait<1>();
    if (s > 0) release(empty, prev, HV, lane);
    prev = it;
    it += HV;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release(empty, prev, HV, lane);
}

// Where a tile position lies: f = 16 wq + g + 8h of the 64 rows; its row of
// the step (f / P1) and ring column j = f % P1 (global column c0 - 3 + j).
struct Pos {
  int frow[2], j[2];
  bool used[2];  // f < S * P1
};

// The epilogue of one conv into a ring: this warpgroup's NH channels from
// n0 at tile position f -> ring row p0 + f of channel plane (c >> 7) (planes
// `plane_bytes` apart from `ring`), 0 where !inside; rows past the step's
// positions go to a row of the guard region that nothing reads.  (m, b) of
// channel c at mb + 8c.  RES (res0_2): plus the same channel of the ring
// `res` at row f (down0, one ring row above) x res_scale.  Branch-free, and
// 4 groups of 8 channels at a time with their loads first, so that the
// groups' chains overlap.
template <int NH, bool RES>
__device__ __forceinline__ void epi_ring(unsigned char* sm, const int (&acc)[NH / 2], int n0,
                                         unsigned mb, unsigned ring, int plane_bytes, int p0,
                                         const Pos& pos, const bool (&inside)[2], unsigned res,
                                         float res_scale, int wq, int g, int q) {
  const int r = 16 * wq + g;
  const unsigned plane = (n0 >> 7) * plane_bytes;  // NH channels lie in one plane
  unsigned dst[2], src[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dst[h] = pos.used[h] ? ring + plane + (p0 + r + 8 * h) * ROW : OFF_GUARD;
    src[h] = res + plane + (r + 8 * h) * ROW;
  }
#pragma unroll
  for (int i0 = 0; i0 < NH / 8; i0 += 4) {
    float4 v[4];
    unsigned short rv[4][2];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = n0 + 8 * (i0 + k) + 2 * q;
      v[k] = ld_f4(sm, mb + 8 * c);  // m[c], b[c], m[c + 1], b[c + 1]
#pragma unroll
      for (int h = 0; h < 2; ++h) rv[k][h] = RES ? ld_u16(sm, swz(src[h], c & 127)) : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k, c = n0 + 8 * i + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float y0 = epi(acc[4 * i + 2 * h], v[k].x, v[k].y);
        float y1 = epi(acc[4 * i + 2 * h + 1], v[k].z, v[k].w);
        if (RES) {
          y0 = __fadd_rn(y0, __fmul_rn((float)(int8_t)(rv[k][h] & 0xff), res_scale));
          y1 = __fadd_rn(y1, __fmul_rn((float)(int8_t)(rv[k][h] >> 8), res_scale));
        }
        const unsigned o = (uint8_t)requant(y0) | ((unsigned)(uint8_t)requant(y1) << 8);
        st_u16(sm, swz(dst[h], c & 127), (unsigned short)(inside[h] ? o : 0u));
      }
    }
  }
}

// down1's epilogue: this warpgroup's 64 channels from n0, to out rows that
// `store` marks, 16 bytes a lane: lane q of each quad ends up with the 16
// channels n0 + 16 q .. + 15 of its two rows.
__device__ __forceinline__ void epi_out(const unsigned char* sm, const int (&acc)[32], int n0,
                                        unsigned mb,
                                        int8_t* const (&dst)[2], const bool (&store)[2], int lane,
                                        int q) {
  float sc[16], bi[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 v = ld_f4(sm, mb + 8 * (n0 + 8 * i + 2 * q));
    sc[2 * i] = v.x;
    bi[2 * i] = v.y;
    sc[2 * i + 1] = v.z;
    bi[2 * i + 1] = v.w;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // P[k]: this lane's 4 bytes of chunk k (channels 16k + 2q, +1, 16k + 8 + 2q, +1)
    unsigned P[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned word = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = 2 * k + t / 2, e = t % 2;
        const float y = epi(acc[4 * i + 2 * h + e], sc[2 * i + e], bi[2 * i + e]);
        word |= (unsigned)(uint8_t)requant(y) << (8 * t);
      }
      P[k] = word;
    }
    // X[l]: lane l's P[q], fetched in 4 rounds (round r reads lane q + r)
    unsigned X[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int send = (q - r) & 3;
      const unsigned v = send == 0 ? P[0] : send == 1 ? P[1] : send == 2 ? P[2] : P[3];
      const unsigned got = __shfl_sync(0xffffffff, v, (lane & ~3) | ((q + r) & 3));
      const int from = (q + r) & 3;
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (l == from) X[l] = got;
    }
    if (store[h]) {
      const uint4 v = make_uint4((X[0] & 0xffffu) | (X[1] << 16), (X[2] & 0xffffu) | (X[3] << 16),
                                 (X[0] >> 16) | (X[1] & 0xffff0000u),
                                 (X[2] >> 16) | (X[3] & 0xffff0000u));
      *reinterpret_cast<uint4*>(dst[h] + n0 + 16 * q) = v;
    }
  }
}

// Grid: min(work items, SMs) blocks; each walks items blockIdx.x,
// + gridDim.x, ...  Item u: image, band of hb output rows, strip.  Warps
// 0-7: two consumer warpgroups; warps 8-11: the producer warpgroup, whose
// warp 8 issues every load.
__global__ void __launch_bounds__(NT, 1) fused_entry_kernel(
    const __grid_constant__ CUtensorMap map0, const __grid_constant__ CUtensorMap map1,
    const __grid_constant__ CUtensorMap map2, const __grid_constant__ CUtensorMap map3,
    const __grid_constant__ CUtensorMap map4, const int8_t* __restrict__ xb, Convs cv,
    int8_t* __restrict__ out, float res_scale, int B, int h, int w, int hb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* slots = base;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + OFF_BAR);
  uint64_t* empty = full + NS;
  const unsigned col = OFF_COL, planes = OFF_PLANES, d0 = OFF_D0, r1 = OFF_R1, r2 = OFF_R2;
  const unsigned mb = OFF_MB;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NCW);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = __shfl_sync(0xffffffff, threadIdx.x / 32, 0);
  const int strips = ceil_div(w, WS), bands = ceil_div(h, hb);
  const int units = B * bands * strips;

  if (warp >= NCW) {
    // ---- producer ------------------------------------------------------------
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == NCW && lane == 0) {
      tma_prefetch_map(&map0);
      tma_prefetch_map(&map1);
      tma_prefetch_map(&map2);
      tma_prefetch_map(&map3);
      tma_prefetch_map(&map4);
      int slot = 0, phase = 0;
      bool refill = false;  // the ring went round once: wait for the slot's release
      // conv `map`'s K slices (tap, then 128-channel plane of K), a slot per
      // 128 output channels
      auto load_conv = [&](const CUtensorMap* map, int taps, int kplanes, int halves) {
        for (int tap = 0; tap < taps; ++tap)
          for (int kp = 0; kp < kplanes; ++kp)
            for (int hv = 0; hv < halves; ++hv) {
              if (refill) mbar_wait(&empty[slot], phase ^ 1);
              mbar_expect_tx(&full[slot], SLOT);
              tma_load_3d(slots + slot * SLOT, map, &full[slot], kp * 128, tap, hv * 128);
              if (++slot == NS) {
                slot = 0;
                phase ^= 1;
                refill = true;
              }
            }
      };
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int band = (u / strips) % bands;
        const int steps = band_steps(min(hb, h - band * hb));
        for (int t = 0; t < steps; ++t) {
          load_conv(&map0, conv_taps(0), conv_kplanes(0), conv_halves(0));
          load_conv(&map1, conv_taps(1), conv_kplanes(1), conv_halves(1));
          load_conv(&map2, conv_taps(2), conv_kplanes(2), conv_halves(2));
          load_conv(&map3, conv_taps(3), conv_kplanes(3), conv_halves(3));
          load_conv(&map4, conv_taps(4), conv_kplanes(4), conv_halves(4));
        }
      }
    }
    __syncwarp();
  } else {
    // ---- consumers -----------------------------------------------------------
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x, wg = warp / 4, wq = warp % 4;
    for (int i = tid; i < MB_CH; i += 32 * NCW) {  // (m, b) pairs; the first carry syncs
      const int c = i < 128 ? 0 : i < 384 ? 1 : i < 512 ? 2 : i < 768 ? 3 : 4;
      *reinterpret_cast<float2*>(base + mb + 8 * i) =
          make_float2(__ldg(cv.m[c] + i - mb_base(c)), __ldg(cv.b[c] + i - mb_base(c)));
    }
    const int g = lane / 4, q = lane % 4;
    const int hx = 2 * h + 2, wx = 2 * w + 2;
    Pos pos;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int f = 16 * wq + g + 8 * hh;
      pos.frow[hh] = f / P1;
      pos.j[hh] = f % P1;
      pos.used[hh] = f < POS;
    }
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int strip = u % strips, band = (u / strips) % bands, img = u / (strips * bands);
      const int c0 = strip * WS, r0 = band * hb, rows = min(hb, h - r0);
      const int steps = band_steps(rows);
      const int8_t* xi = xb + (size_t)img * hx * wx * CIN;
      // The stem's im2col of planes 2 round and 2 round + 1: this thread's 4
      // chunks of 16 bytes (words of the 108-byte row, tap row wi / 9, then
      // zeros), loaded from xb (L2) into registers, then stored swizzled.
      auto col_load = [&](int round, int qs, uint4 (&cw)[4]) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = tid + 32 * NCW * k, f = (i / 8) % TILE, ch = i % 8;
          const int p = 2 * round + i / (TILE * 8);
          const int y = 2 * (qs + f / P1) + (p >> 1), x = 2 * (c0 - 3 + f % P1) + (p & 1);
          unsigned wv[4] = {0u, 0u, 0u, 0u};
          if (f < POS && y >= 0 && y < 2 * h && x >= 0 && x < 2 * w) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int wi = 4 * ch + kk;
              if (wi < 27)
                wv[kk] = __ldg(reinterpret_cast<const unsigned*>(
                    xi + ((size_t)(y + wi / 9) * wx + x) * CIN + 4 * (wi % 9)));
            }
          }
          cw[k] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
        }
      };
      auto col_store = [&](const uint4 (&cw)[4]) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = tid + 32 * NCW * k;
          const unsigned dst = col + ((i / (TILE * 8)) * TILE + (i / 8) % TILE) * ROW;
          st_v4(base, dst + (((i % 8) ^ (dst >> 7)) & 7) * 16, cw[k]);
        }
      };
      for (int t = 0; t < steps; ++t) {
        const int q0 = r0 - 3 + t * S;  // planes, down0, res0_1: rows [q0, q0 + S)

        // ---- the stem's im2col of round 0, loaded ahead of the carry
        uint4 cw[4];
        col_load(0, q0, cw);

        // ---- carry: ring rows still needed go to the head of their ring
        constexpr int CARRY = 10 * P1 * 8;  // 16-byte chunks of 300 rows
#pragma unroll 2
        for (int k = 0; k < ceil_div(CARRY, 32 * NCW); ++k) {
          const int i = tid + 32 * NCW * k;
          if (i >= CARRY) break;
          const int r = i / 8, ch = i % 8, bufi = r / P1;
          const unsigned buf = bufi < 4   ? planes + bufi * PLANE
                               : bufi < 6 ? d0 + (bufi - 4) * PLANE
                               : bufi < 8 ? r1 + (bufi - 6) * P1 * ROW
                                          : r2 + (bufi - 8) * PLANE;
          const unsigned dst = buf + (r % P1) * ROW, src = dst + POS * ROW;
          st_v4(base, dst + ((ch ^ (dst >> 7)) & 7) * 16,
                ld_v4(base, src + ((ch ^ (src >> 7)) & 7) * 16));
        }
        col_store(cw);
        fence_proxy_async();
        consumers_sync();

        // ---- stem: two rounds of two planes (py, px) = (p >> 1, p & 1)
        for (int round = 0; round < 2; ++round) {
          if (round == 1) {
            col_store(cw);
            fence_proxy_async();
            consumers_sync();
          }
          int acc[2][32];
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0;
          fence_regs(acc[0]);
          fence_regs(acc[1]);
          mbar_wait(&full[it % NS], (it / NS) & 1);
          const uint64_t db = wgmma_desc(slice_b<64>(slots, it, wg));
          const uint64_t da0 = wgmma_desc(base + OFF_COL);
          const uint64_t da1 = wgmma_desc(base + OFF_COL + TILE * ROW);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < ROW / 32; ++k) {
            wgmma_ss<64>(acc[0], da0 + 2 * k, db + 2 * k);
            wgmma_ss<64>(acc[1], da1 + 2 * k, db + 2 * k);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc[0]);
          fence_regs(acc[1]);
          if (round == 1) {
            release(empty, it, 1, lane);
            ++it;
          }
#pragma unroll
          for (int tt = 0; tt < 2; ++tt) {
            const int p = 2 * round + tt;
            bool inside[2];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int y = 2 * (q0 + pos.frow[hh]) + (p >> 1);
              const int x = 2 * (c0 - 3 + pos.j[hh]) + (p & 1);
              inside[hh] = y >= 0 && y < 2 * h && x >= 0 && x < 2 * w;
            }
            epi_ring<64, false>(base, acc[tt], 64 * wg, mb + 8 * mb_base(0), planes + p * PLANE,
                                PLANE, P1, pos, inside, 0u, 0.f, wq, g, q);
          }
          if (round == 0) col_load(1, q0, cw);
          fence_proxy_async();
          consumers_sync();
        }

        // inside the image at h resolution: rows from row0 (+ f / P1)
        auto inside_at = [&](int row0, bool (&in)[2]) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int y = row0 + pos.frow[hh], x = c0 - 3 + pos.j[hh];
            in[hh] = y >= 0 && y < h && x >= 0 && x < w;
          }
        };
        bool in_q[2], in_r2[2];
        inside_at(q0, in_q);
        inside_at(q0 - 1, in_r2);

        {  // ---- down0: tap (u, v) reads plane ((u + 1) & 1, (v + 1) & 1) at
           // offset (u == 0 ? -1 : 0, v == 0 ? -1 : 0) rows / columns
          int acc[64];
          conv_mma<128>(acc, 9, [&](int tap) {
            const int u = tap / 3, v = tap % 3;
            const int p = 2 * ((u + 1) & 1) + ((v + 1) & 1);
            const int off = P1 - (u == 0 ? P1 : 0) - (v == 0 ? 1 : 0);
            return base + OFF_PLANES + p * PLANE + off * ROW;
          }, wg, lane, slots, full, empty, it);
          epi_ring<128, false>(base, acc, 128 * wg, mb + 8 * mb_base(1), d0, PLANE, P1, pos,
                               in_q, 0u, 0.f, wq, g, q);
        }
        fence_proxy_async();
        consumers_sync();
        {  // ---- res0_1: down0's rows, one ring row down (res0_1 carries 2)
          int acc[32];
          conv_mma<64>(acc, 2, [&](int kp) {
            return base + OFF_D0 + kp * PLANE + P1 * ROW;
          }, wg, lane, slots, full, empty, it);
          epi_ring<64, false>(base, acc, 64 * wg, mb + 8 * mb_base(2), r1, R1_BYTES, 2 * P1,
                              pos, in_q, 0u, 0.f, wq, g, q);
        }
        fence_proxy_async();
        consumers_sync();
        {  // ---- res0_2: rows [q0 - 1, q0 + S - 1); tap (u, v) at r1 offset
           // (u - 1) rows, (v - 1) columns; residual down0 one ring row up
          int acc[64];
          conv_mma<128>(acc, 9, [&](int tap) {
            return base + OFF_R1 + ((tap / 3) * P1 + tap % 3 - 1) * ROW;
          }, wg, lane, slots, full, empty, it);
          epi_ring<128, true>(base, acc, 128 * wg, mb + 8 * mb_base(3), r2, PLANE, P1, pos,
                              in_r2, d0, res_scale, wq, g, q);
        }
        fence_proxy_async();
        consumers_sync();
        {  // ---- down1: out rows [q0 - 1, q0 + S - 1); tap (u, v) reads res0_2
           // at offset u rows, v - 1 columns, both channel planes
          int acc[32];
          conv_mma<64>(acc, 8, [&](int s) {
            const int tap = s / 2, kp = s % 2;
            return base + OFF_R2 + kp * PLANE + ((tap / 2) * P1 + tap % 2 - 1) * ROW;
          }, wg, lane, slots, full, empty, it);
          int8_t* dst[2];
          bool store[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int y = q0 - 1 + pos.frow[hh], j = pos.j[hh], x = c0 - 3 + j;
            store[hh] = pos.used[hh] && y >= r0 && y < r0 + rows && j >= 3 && j < 3 + WS && x < w;
            dst[hh] = out + (((size_t)img * h + (store[hh] ? y : 0)) * w + (store[hh] ? x : 0))
                                * 128;
          }
          epi_out(base, acc, 64 * wg, mb + 8 * mb_base(4), dst, store, lane, q);
        }
        consumers_sync();  // the next step's carry overwrites rows read above
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// Let the kernel take its shared memory (above 48 KB only after this call),
// once per device: the attribute holds for the device current when it is set.
std::mutex smem_mutex;
bool smem_allowed[64];

int allow_smem(int dev) {
  std::lock_guard<std::mutex> lock(smem_mutex);
  if (dev < 64 && smem_allowed[dev]) return 0;
  const cudaError_t e = cudaFuncSetAttribute(fused_entry_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e == cudaSuccess && dev < 64) smem_allowed[dev] = true;
  return (int)e;
}

// hb: the band height, or 0 for the planner's.
int launch(const void* xb, const void* const* w, const void* const* m, const void* const* b,
           void* out, float res_scale, int B, int hbx, int wbx, int hb, void* stream) {
  if (B <= 0 || hbx < 4 || wbx < 4 || hbx % 2 || wbx % 2) return (int)cudaErrorInvalidValue;
  int h = (hbx - 2) / 2, wd = (wbx - 2) / 2;
  if (hb < 0 || hb > h) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, e = (int)cudaGetDevice(&dev);
  if (e == 0) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == 0) e = allow_smem(dev);
  if (e != 0) return e;
  if (hb == 0) hb = plan_band(B, h, wd, sms);

  // the K-major weights as [N][taps][C] (stem: C = 108 zero-padded to 128),
  // boxes of 128 bytes of K x 1 tap x 128 output channels
  static const int C[5] = {128, 128, 256, 128, 256}, N[5] = {128, 256, 128, 256, 128};
  CUtensorMap maps[5];
  for (int c = 0; c < 5; ++c) {
    const cuuint64_t dims[3] = {(cuuint64_t)C[c], (cuuint64_t)conv_taps(c), (cuuint64_t)N[c]};
    const cuuint64_t strides[2] = {(cuuint64_t)C[c], (cuuint64_t)C[c] * conv_taps(c)};
    const cuuint32_t box[3] = {128, 1, 128};
    if ((e = tensor_map(&maps[c], CU_TENSOR_MAP_DATA_TYPE_UINT8, w[c], 3, dims, strides, box)) != 0)
      return e;
  }
  const long long units = (long long)B * ceil_div(h, hb) * ceil_div(wd, WS);
  const int blocks = (int)(units < sms ? units : sms);
  Convs cv;
  for (int c = 0; c < 5; ++c) {
    cv.m[c] = static_cast<const float*>(m[c]);
    cv.b[c] = static_cast<const float*>(b[c]);
  }
  const int8_t* x = static_cast<const int8_t*>(xb);
  int8_t* o = static_cast<int8_t*>(out);
  void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3], &maps[4], &x, &cv, &o, &res_scale,
                  &B, &h, &wd, &hb};
  return (int)cudaLaunchKernel(reinterpret_cast<const void*>(fused_entry_kernel), dim3(blocks),
                               dim3(NT), args, SMEM, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Returns the launch's cudaError_t (0 on success).  xb [B, hb, wb, 12] int8;
// weights K-major int8, [cout][kh*kw*cin] (stem 128 x 128: its 108 columns
// and 20 zeros; down0 256 x 1152, res0_1 128 x 256, res0_2 256 x 1152, down1
// 128 x 1024), 16-byte aligned; m, b [cout] float32; out [B, (hb-2)/2,
// (wb-2)/2, 128] int8.  Device pointers to contiguous arrays.  Runs on
// `stream`, does not synchronise.
int yolo_fused_entry_i8(const void* xb, const void* w_stem, const void* m_stem,
                        const void* b_stem, const void* w_d0, const void* m_d0,
                        const void* b_d0, const void* w_r1, const void* m_r1,
                        const void* b_r1, const void* w_r2, const void* m_r2,
                        const void* b_r2, const void* w_d1, const void* m_d1,
                        const void* b_d1, void* out, float res_scale, int B, int hb,
                        int wb, void* stream) {
  const void* w[5] = {w_stem, w_d0, w_r1, w_r2, w_d1};
  const void* m[5] = {m_stem, m_d0, m_r1, m_r2, m_d1};
  const void* b[5] = {b_stem, b_d0, b_r1, b_r2, b_d1};
  return launch(xb, w, m, b, out, res_scale, B, hb, wb, 0, stream);
}

// yolo_fused_entry_i8 with bands of `band` rows (1 .. (hb-2)/2) forced over
// the planner's, so that every geometry can be held to the plain version
// and timed.
int yolo_fused_entry_band(int band, const void* xb, const void* w_stem, const void* m_stem,
                          const void* b_stem, const void* w_d0, const void* m_d0,
                          const void* b_d0, const void* w_r1, const void* m_r1,
                          const void* b_r1, const void* w_r2, const void* m_r2,
                          const void* b_r2, const void* w_d1, const void* m_d1,
                          const void* b_d1, void* out, float res_scale, int B, int hb,
                          int wb, void* stream) {
  if (band <= 0) return (int)cudaErrorInvalidValue;
  const void* w[5] = {w_stem, w_d0, w_r1, w_r2, w_d1};
  const void* m[5] = {m_stem, m_d0, m_r1, m_r2, m_d1};
  const void* b[5] = {b_stem, b_d0, b_r1, b_r2, b_d1};
  return launch(xb, w, m, b, out, res_scale, B, hb, wb, band, stream);
}

// The geometry the launch picks for xb [B, hb, wb, 12] on the current device:
// geo = {strip columns, rows a step, band rows, shared bytes a block}.
// Returns 0 or a cudaError_t.
int yolo_fused_entry_plan(int B, int hb, int wb, int* geo) {
  if (B <= 0 || hb < 4 || wb < 4 || hb % 2 || wb % 2) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, e = (int)cudaGetDevice(&dev);
  if (e == 0) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != 0) return e;
  const int h = (hb - 2) / 2, w = (wb - 2) / 2;
  geo[0] = WS;
  geo[1] = S;
  geo[2] = plan_band(B, h, w, sms);
  geo[3] = SMEM;
  return 0;
}

const char* yolo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
