// Fused Darknet residual block for Hopper (sm_90a):
//
//     out = y + round(leaky(conv3x3(mid) + b2)),   mid = round(leaky(y @ w1 + b1))
//
// with SAME padding, LeakyReLU(0.1), fp32 accumulation and round() = a cast to
// the storage type (float or bf16).  Replaces the TPU Pallas kernel
// yolo_v3_tpu/ops/pallas_kernels.py::fused_res_block (_res_block_kernel).
// The bf16 kernel also takes Mish in place of leaky on both convs (its Act
// template argument; YOLOv4's CSPDarknet53 blocks, where Cmid may equal C):
// mish(x) = x * (n^2 + 2n) / (n^2 + 2n + 2), n = e^x, and x above 20
// (darknet's threshold), in fp32 on the accumulator with the fast exponential
// and division (ops/activations.py::mish is its plain version).
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
// What the design does about it.  One block owns a tile of 64 output pixels
// (8x8; fp32 may take a raster run instead, below).  mid is computed for the
// tile's whole halo (the 10x10 window), kept in shared memory, and conv2
// runs over the block's share of the output channels from there.  mid never
// touches device memory, y is read once for conv1 (plus a 1-pixel halo) and
// once for the residual, and out is written once: the block's traffic is the
// 2 tensors the fused op must move.  Both convs run on tensor cores: conv1 as
// a [halo pixels x C] @ [C x Cmid] GEMM, conv2 as 9 tap GEMMs whose A
// rows are gathered from the shifted halo window by address, so the 3x3
// needs no im2col copy.
//
// bf16 (wgmma, fp32 accumulate): one producer warp issues every load by TMA
// (the y halo window as one 4-D box whose out-of-image pixels read as zeros;
// w1 and w2 as 2-D boxes of the host's K-major copies), into rings of
// 128-byte-swizzled slots with an mbarrier pair each, while two consumer
// warpgroups run wgmma m64nNk16: conv1 with both operands in shared memory
// (the 100 halo rows padded to 2 x m64), conv2 with A in registers, gathered
// by ldmatrix from the shifted halo rows of mid (a shared-memory descriptor
// cannot express that shift; each warp's wgmma A fragment is the m16n8k16
// one) and double-buffered so that the next step's gather overlaps the
// running product.  conv2 gives each warpgroup V = 32, 64 or 128 output
// channels by C, so C = 64 keeps both busy.  Where the grid is small the
// tile's channels are split like fp32's below, conv1 sliced over a cluster
// of up to 8 blocks; each block copies its peers' mid slices into its own
// shared memory once (distributed shared memory), and at 13x13 the cluster
// is repeated over more blocks of the same tile, each recomputing the
// cluster's conv1, where SMs would otherwise idle.  ptxas serializes every
// wgmma of a kernel (each waits for the one before) when it thinks one sits
// on a divergent path, so the warp index that selects the paths is taken
// as a warp-uniform value.  What bounds it now (PERF.md): the wgmma loops'
// issue rate, about half the card's bf16 peak, and per-block latencies
// (TMA, barriers, the epilogue) where blocks are short (208x208, 104x104).
//
// fp32 (wgmma m64nNk8 .tf32, 3xTF32): one TF32 product keeps 10 mantissa
// bits and would miss fp32's results by ~5e-4 at K = 4608, so every operand
// x is split as hi = tf32(x), lo = tf32(x - hi), and each product is taken as
// lo*hi + hi*lo + hi*hi (the lo*lo term is below fp32's rounding): three
// wgmma per k8.  The weights arrive from the host as separate hi and lo
// planes, K-major and zero-padded, and TMA stages a step's 32 K of both (32
// fp32 are one 128-byte swizzled row, as 64 bf16 are).  TF32 wgmma takes no
// transpose, so A comes from registers: y (conv1) and mid's shifted rows
// (conv2) are loaded as fp32 and split there (cvt.rna.tf32.f32, which the
// host's split_tf32 mirrors).  The tensor cores' own fp32 accumulation
// truncates, so the products go into partial sums of 32 K (FKPART steps),
// in two banks that alternate, and each partial is added into the total in
// plain fp32 while the other bank's products run.  One thread of the block
// issues every TMA load through one ring, a few steps ahead; the two
// warpgroups multiply (no producer warp: a ninth warp would cap every
// thread at 168 registers, too few for a total, two banks and two split A
// fragments).  A tile is 64 output pixels: an 8x8 square, or 64 pixels in
// raster order (flat) where the image is at most 31 wide, so that 13x13 and
// 26x26 do not spend a third of conv2 on padding (3 and 11 tiles an image,
// where 8x8 takes 4 and 16); a flat tile's conv1 covers the raster run of mid
// rows one image row above and below it, and its taps read 0 where they
// would wrap past the left or right edge.  Where the grid is small, the
// output channels are split over a cluster of up to 8 blocks of the same
// tile, conv1 with them (block j computes mid channels [j*MS, (j+1)*MS)),
// and conv2 copies each 32-channel chunk of mid from the block that holds it
// (distributed shared memory) one chunk ahead; clusters repeat where SMs
// would idle, as bf16's do.  It runs at ~22% of its bound (PERF.md); what
// holds it there is not measured yet.  The candidates: each block streams
// its channels' hi and lo weight planes from L2 for only 64 pixels, and
// shared memory serves B's hi plane twice a k8, not the card's bytes.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TH = 8;               // output tile rows
constexpr int TW = 8;               // output tile columns
constexpr int HWIN = TW + 2;        // halo window width
constexpr int HP = (TH + 2) * HWIN; // halo window pixels (100)
constexpr float LEAKY = 0.1f;

__device__ __forceinline__ float leaky(float x) { return x > 0.f ? x : LEAKY * x; }

// The bf16 kernel's activations (its Act template argument); ACT is the
// host's activation code (1 leaky, 2 Mish).
struct ActLeaky {
  static constexpr int ACT = 1;
  static __device__ __forceinline__ float f(float x) { return leaky(x); }
};
struct ActMish {
  static constexpr int ACT = 2;
  static __device__ __forceinline__ float f(float x) {
    if (x > 20.f) return x;
    const float n = __expf(x), t = n * (n + 2.f);
    return __fdividef(x * t, t + 2.f);
  }
};

// ---------------------------------------------------------------------------
// Shared
// ---------------------------------------------------------------------------

// Split barrier over the thread-block cluster: arrive (release this block's
// shared-memory reads and writes), later wait for every block to arrive.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

constexpr int MAX_CLUSTER = 8;    // the portable cluster size

// ---------------------------------------------------------------------------
// bf16: wgmma (fp32 accumulate), conv1 shared in a cluster
// ---------------------------------------------------------------------------

constexpr int SKEW = 8;      // mid row padding (16 bytes): ldmatrix rows hit distinct banks
constexpr int BK = 64;       // K per pipeline step: one 128-byte row of a staged operand
constexpr int BM1 = 128;     // conv1 rows: the 100 halo pixels padded to 2 x m64
constexpr int BN1 = 128;     // mid channels per conv1 pass
constexpr int BMGRAN = 16;   // mid channels are padded to this (weights, shared memory)
constexpr int BNS1 = 3;      // depth of conv1's TMA ring
constexpr int BNS2 = 3;      // depth of conv2's TMA ring
constexpr int BNT = 288;     // threads: 2 consumer warpgroups and conv2's producer warp
constexpr int BSTAGE1 = (BM1 + BN1) * BK;  // a conv1 step: y rows, then w1 rows
// conv2: one warpgroup per V output channels, 2V channels a pass (V, the
// kernel's template argument, is chosen on the host: 32 at C = 64, so that
// both warpgroups have work; 64 or 128 above).
__host__ __device__ constexpr int bf16_stage2(int V) { return 2 * V * BK; }
__host__ __device__ constexpr int bf16_region(int V) {
  return BNS1 * BSTAGE1 > BNS2 * bf16_stage2(V) ? BNS1 * BSTAGE1 : BNS2 * bf16_stage2(V);
}
// mid [HP][Mpad + SKEW], then the ring, 1024-byte aligned (the 128-byte
// swizzle is a function of the shared-memory address)
__host__ __device__ constexpr size_t bf16_mid_bytes(int Mpad) {
  return ((size_t)HP * (Mpad + SKEW) * 2 + 1023) / 1024 * 1024;
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// y, out: [B, H, W, C] (C % 8 == 0); b1: [Cmid]; b2: [C].  The weights come
// K-major and zero-padded from the host (ops/fused_res_block.py::
// bf16_weights): w1k [Mpad][Cp] (row m = w1[:, m]; Mpad = Cmid rounded up to
// BMGRAN, Cp = C rounded up to BK), w2k [C][K2p] (row co, column t * Mpad + m
// = w2[t / 3, t % 3, m, co]; K2p = 9 * Mpad rounded up to BK).  All three
// arrive as TMA descriptors (y_map: boxes of BK channels x the 10 x 10 halo
// window, out-of-image pixels read as zeros; w1_map: BK x BN1; w2_map: BK x
// 2V), 128-byte swizzled.  Grid: (tiles_h * tiles_w, cs, B) in clusters of
// (1, cs, 1), the cs blocks of one tile.  Block rank j computes mid channels
// [j*MS, (j+1)*MS) of the tile's halo window, copies the others from its
// peers, and computes output channels [j*co_per_block, (j+1)*co_per_block).
//
// Warp 8 is the producer: one thread issues every TMA load, conv1's ring then
// conv2's, each slot with a `full` barrier (its bytes in) and an `empty`
// barrier (the 8 consumer warps out).  Warps 0-7 are two consumer
// warpgroups.
template <int V, class Act>
__global__ void __launch_bounds__(BNT, V == 128 ? 1 : 2) res_block_bf16_kernel(
    const __grid_constant__ CUtensorMap y_map, const __grid_constant__ CUtensorMap w1_map,
    const __grid_constant__ CUtensorMap w2_map, const bf16* __restrict__ y,
    const bf16* __restrict__ b1, const bf16* __restrict__ b2, bf16* __restrict__ out, int H,
    int W, int C, int Cmid, int Mpad, int Cp, int K2p, int MS, int tiles_w, int co_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int ms = Mpad + SKEW;
  bf16* mid = reinterpret_cast<bf16*>(smem);                       // [HP][ms]
  bf16* ring = reinterpret_cast<bf16*>(smem + bf16_mid_bytes(Mpad));
  uint64_t* full1 = reinterpret_cast<uint64_t*>(ring + bf16_region(V));
  uint64_t* empty1 = full1 + BNS1;
  uint64_t* full2 = empty1 + BNS1;
  uint64_t* empty2 = full2 + BNS2;
  float* b1f = reinterpret_cast<float*>(empty2 + BNS2);  // [Mpad]: b1, 0 past Cmid
  float* b2f = b1f + Mpad;                                // [C]
  for (int i = threadIdx.x; i < Mpad + C; i += BNT)
    b1f[i] = i < Cmid ? __bfloat162float(b1[i])
                      : i >= Mpad ? __bfloat162float(b2[i - Mpad]) : 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < BNS1; ++i) {
      mbar_init(&full1[i], 1);
      mbar_init(&empty1[i], 8);
    }
    for (int i = 0; i < BNS2; ++i) {
      mbar_init(&full2[i], 1);
      mbar_init(&empty2[i], 8);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  // the warp index as a warp-uniform value (a shuffle), so that the compiler
  // sees the wgmma paths below as convergent: wgmma in a path it thinks
  // divergent is serialized (each waits for the one before)
  const int tid = threadIdx.x, lane = tid % 32, warp = __shfl_sync(0xffffffff, tid / 32, 0);
  const int wg = warp / 4, wq = warp % 4;               // warpgroup, its warp
  const int g = lane / 4, q = lane % 4;                 // accumulator row, column pair
  const int b = blockIdx.z;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int rank = (int)cluster.block_rank(), cs = (int)cluster.num_blocks();
  const int m_lo = rank * MS;                   // this block's first mid channel
  const int nm = max(0, min(MS, Mpad - m_lo));  // ... and how many it computes
  const int steps1 = Cp / BK, steps2 = K2p / BK;
  const int co_begin = blockIdx.y * co_per_block;
  const int co_end = min(C, co_begin + co_per_block);
  const int passes2 = (co_end - co_begin + 2 * V - 1) / (2 * V);

  // conv2's TMA load of iteration `it` (pass it / steps2, step it % steps2)
  auto load2 = [&](int it) {
    const int slot = it % BNS2;
    if (it >= BNS2) mbar_wait(&empty2[slot], (it / BNS2 - 1) & 1);
    mbar_expect_tx(&full2[slot], bf16_stage2(V) * (int)sizeof(bf16));
    tma_load_2d(ring + slot * bf16_stage2(V), &w2_map, &full2[slot], (it % steps2) * BK,
                co_begin + (it / steps2) * 2 * V);
  };

  // ---- conv1: mid[100 x nm] = y_halo[100 x C] @ w1[C x (m_lo .. m_lo + nm)] --
  // wgmma with both operands in shared memory.  Warpgroup wg takes halo rows
  // [64*wg, 64*wg + 64) of the 128 (rows past the 100 hold stale data and
  // their sums are dropped), BN1 mid channels a pass (wgmma n128; n64 or n32
  // where no more are left).
  if (warp == 8) {
    if (lane == 0) {
      int it = 0;
      for (int n0 = 0; n0 < nm; n0 += BN1)
        for (int s = 0; s < steps1; ++s, ++it) {
          const int slot = it % BNS1;
          if (it >= BNS1) mbar_wait(&empty1[slot], (it / BNS1 - 1) & 1);
          bf16* st = ring + slot * BSTAGE1;
          mbar_expect_tx(&full1[slot], (HP + BN1) * BK * (int)sizeof(bf16));
          tma_load_4d(st, &y_map, &full1[slot], s * BK, tx0 - 1, ty0 - 1, b);
          tma_load_2d(st + BM1 * BK, &w1_map, &full1[slot], s * BK, m_lo + n0);
        }
      // conv2's first loads go out once conv1 is done with the ring
      for (int j = max(0, it - BNS1); j < it; ++j)
        mbar_wait(&empty1[j % BNS1], (j / BNS1) & 1);
      for (int it2 = 0; it2 < BNS2 && it2 < passes2 * steps2; ++it2) load2(it2);
    }
    __syncwarp();
  } else {
    int it = 0;
    for (int n0 = 0; n0 < nm; n0 += BN1) {
      const int width = nm - n0 > 64 ? 128 : nm - n0 > 32 ? 64 : 32;  // uniform
      float acc[BN1 / 2];
#pragma unroll
      for (int i = 0; i < BN1 / 2; ++i) acc[i] = 0.f;
      for (int s = 0; s < steps1; ++s, ++it) {
        const int slot = it % BNS1;
        mbar_wait(&full1[slot], (it / BNS1) & 1);
        const bf16* st = ring + slot * BSTAGE1;
        const uint64_t da = wgmma_desc(st + wg * 64 * BK), db = wgmma_desc(st + BM1 * BK);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          if (width == 128)
            wgmma_ss_n128(acc, da + 2 * j, db + 2 * j);
          else if (width == 64)
            wgmma_ss_n64(*reinterpret_cast<float(*)[32]>(acc), da + 2 * j, db + 2 * j);
          else
            wgmma_ss_n32(*reinterpret_cast<float(*)[16]>(acc), da + 2 * j, db + 2 * j);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's group: free its slot
        if (s > 0 && lane == 0) mbar_arrive(&empty1[(it - 1) % BNS1]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty1[(it - 1) % BNS1]);
#pragma unroll
      for (int i = 0; i < BN1 / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = wg * 64 + wq * 16 + g + 8 * h;
          const int n = n0 + i * 8 + 2 * q;  // local mid channel (nm % 16 == 0)
          if (p >= HP || n >= nm || i * 8 >= width) continue;
          const int gy = ty0 - 1 + p / HWIN, gx = tx0 - 1 + p % HWIN;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
          const int m = m_lo + n;
          // 0 outside the image (the 3x3's zero padding) and in padded channels
          const float v0 =
              inside && m < Cmid ? Act::f(acc[4 * i + 2 * h] + b1f[m]) : 0.f;
          const float v1 = inside && m + 1 < Cmid
                               ? Act::f(acc[4 * i + 2 * h + 1] + b1f[m + 1])
                               : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(mid + p * ms + m) = __floats2bfloat162_rn(v0, v1);
        }
    }
  }

  // ---- the cluster's mid: copy the peers' slices (distributed shared memory)
  if (cs > 1)
    cluster.sync();  // every block's slice is complete and visible to its peers
  else
    __syncthreads();
  for (int r = 1; r < cs; ++r) {
    const int src = (rank + r) % cs, lo = src * MS, n = min(MS, Mpad - lo);
    if (n <= 0) continue;
    const bf16* peer = cluster.map_shared_rank(mid, src);
    for (int i = tid; i < HP * (n / 8); i += BNT) {
      const int at = (i / (n / 8)) * ms + lo + (i % (n / 8)) * 8;
      *reinterpret_cast<int4*>(mid + at) = *reinterpret_cast<const int4*>(peer + at);
    }
  }
  if (cs > 1) cluster_arrive();  // done reading the peers; waited for before exit
  __syncthreads();

  // ---- conv2: [64 x 9*Mpad] @ [9*Mpad x co] from the halo window -----------
  // Step s is K [s*BK, (s+1)*BK) of the tap-major K = t * Mpad + m; each k16
  // lies in one tap, whose A rows are the halo rows shifted by the tap,
  // gathered by ldmatrix into registers (a shared-memory descriptor cannot
  // express the shift).  Warpgroup wg owns channels [c0 + wg*V, c0 +
  // (wg+1)*V) of a pass, its warp wq pixels [16*wq, 16*wq + 16).  A step is
  // one wgmma group of 4 k16.  The A registers are double-buffered: while
  // step s multiplies, step s - 1's group is waited for (its slot handed
  // back) and step s + 1's A is gathered into the other buffer.
  if (warp == 8) {
    if (lane == 0)
      for (int it = BNS2; it < passes2 * steps2; ++it) load2(it);
  } else {
    const int K2 = 9 * Mpad;
    const size_t img = (size_t)b * H * W * C;
    const int lrow = lane % 16, lcol = (lane / 16) * 8;  // ldmatrix: row, column
    const int px = wq * 16 + lrow;
    const int hrow = (px / TW) * HWIN + px % TW;  // halo row of this lane's A row, tap (0,0)
    unsigned a0[BK / 16][4] = {}, a1[BK / 16][4] = {};
    // step s's A fragments into `a` (K past 9 * Mpad, w2k's zero padding,
    // takes any finite mid: the last k16's)
    auto gather = [&](int s, unsigned (&a)[BK / 16][4]) {
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const int k = min(s * BK + j * 16, K2 - 16);
        const int t = k / Mpad, m = k - t * Mpad;
        ldsm_x4(a[j], mid + (hrow + (t / 3) * HWIN + t % 3) * ms + m + lcol);
      }
    };
    int it = 0;  // ring iteration of step 0 of this pass
    for (int c0 = co_begin; c0 < co_end; c0 += 2 * V, it += steps2) {
      const bool active = c0 + wg * V < co_end;   // uniform in the warpgroup
      float acc[V / 2];
#pragma unroll
      for (int i = 0; i < V / 2; ++i) acc[i] = 0.f;
      // the residual y of this thread's outputs, loaded while the pass runs
      __nv_bfloat162 yres[V / 8][2];
#pragma unroll
      for (int i = 0; i < V / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = wq * 16 + g + 8 * h;
          const int gy = ty0 + p / TW, gx = tx0 + p % TW;
          const int co = c0 + wg * V + i * 8 + 2 * q;
          if (active && gy < H && gx < W && co < co_end)
            yres[i][h] = *reinterpret_cast<const __nv_bfloat162*>(
                y + img + ((size_t)gy * W + gx) * C + co);
        }
      // step s: multiply `cur` (gathered), then gather step s + 1 into `next`
      auto step = [&](int s, unsigned (&cur)[BK / 16][4], unsigned (&next)[BK / 16][4]) {
        if (active) {
          const uint64_t db =
              wgmma_desc(ring + (it + s) % BNS2 * bf16_stage2(V) + wg * V * BK);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < BK / 16; ++j) wgmma_rs<V>(acc, cur[j], db + 2 * j);
          wgmma_commit();
          wgmma_wait<1>();  // step s - 1's group: its A buffer (`next`) and slot are free
#pragma unroll
          for (int j = 0; j < BK / 16; ++j) fence_regs(next[j]);
        }
        if (s > 0 && lane == 0) mbar_arrive(&empty2[(it + s - 1) % BNS2]);
        if (s + 1 < steps2) {
          mbar_wait(&full2[(it + s + 1) % BNS2], (it + s + 1) / BNS2 & 1);
          if (active) gather(s + 1, next);
        }
      };
      mbar_wait(&full2[it % BNS2], it / BNS2 & 1);
      if (active) gather(0, a0);
      for (int s = 0; s < steps2; s += 2) {
        step(s, a0, a1);
        if (s + 1 < steps2) step(s + 1, a1, a0);
      }
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        fence_regs(a0[j]);
        fence_regs(a1[j]);
      }
      if (lane == 0) mbar_arrive(&empty2[(it + steps2 - 1) % BNS2]);
      if (!active) continue;
#pragma unroll
      for (int i = 0; i < V / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = wq * 16 + g + 8 * h;
          const int gy = ty0 + p / TW, gx = tx0 + p % TW;
          const int co = c0 + wg * V + i * 8 + 2 * q;  // co_end is even
          if (gy >= H || gx >= W || co >= co_end) continue;
          const size_t at = img + ((size_t)gy * W + gx) * C + co;
          // conv2's result rounds to bf16, then adds to y in bf16
          const __nv_bfloat162 r = __floats2bfloat162_rn(Act::f(acc[4 * i + 2 * h] + b2f[co]),
                                                         Act::f(acc[4 * i + 2 * h + 1] + b2f[co + 1]));
          const __nv_bfloat162 yv = yres[i][h];
          *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(
              __low2float(yv) + __low2float(r), __high2float(yv) + __high2float(r));
        }
    }
  }
  if (cs > 1) cluster_wait();  // no block exits while a peer may still read its mid
}

// ---------------------------------------------------------------------------
// fp32: 3xTF32 on wgmma (m64nNk8 .tf32), conv1 shared in a cluster
// ---------------------------------------------------------------------------

constexpr int FBK = 32;          // K per step: 32 fp32, one 128-byte row of a staged operand
constexpr int FBM1 = 128;        // conv1 rows: the tile's mid rows padded to 2 x m64
constexpr int FMGRAN = 32;       // mid channels are padded to this (one chunk of conv2's K)
// Threads: 2 warpgroups, one of whose threads also issues the TMA loads.  A
// producer warp would put a third warp on one of the SM's four register
// files and cap every thread at 168 registers; with 8 warps a thread may
// hold 255, enough for a total and two partial banks of N / 2 floats and
// two split A fragments without spills.
constexpr int FNT = 256;
constexpr int FCS = FBK + 4;     // row stride (floats) of a copied mid chunk
constexpr int FMSKEW = 4;        // mid row padding (floats)
constexpr int FKPART = 1;        // steps a partial sum spans (K = 32 per partial)
constexpr int TP = TH * TW;      // output pixels of a tile (one m64)
// A flat tile (64 pixels in raster order) reads mid rows [p0 - W - 1, p0 + 64 + W]:
// 64 + 2W + 2 of them, which must fit conv1's FBM1.
constexpr int FLAT_MAX_W = (FBM1 - TP - 2) / 2;

// A ring slot (bytes): conv1's y rows and w1's hi and lo planes (N rows
// each), or conv2's w2 hi and lo planes (2N rows each: both warpgroups).
__host__ __device__ constexpr int f32_stage(int N) {
  return (FBM1 + 2 * N) > 4 * N ? (FBM1 + 2 * N) * 128 : 4 * N * 128;
}
// The TMA ring (conv1's steps, then conv2's): loads run FLOOK steps ahead of
// the step being multiplied, so that the slot a load reuses was released
// FNS - FLOOK - 1 steps before and its `empty` wait rarely blocks.  Short
// steps (N = 32: 208x208) take a deeper ring to cover TMA's latency.
constexpr int FLOOK_SLACK = 2;
__host__ __device__ constexpr int f32_slots(int N) { return N == 32 ? 6 : 4; }
// + 1024: the ring's alignment; the barriers; the two copied chunks of a
// cluster's mid (cs > 1); this block's mid slice
__host__ __device__ constexpr size_t f32_smem(int N, int ms_chunk, int cs, int mrows) {
  return 1024 + (size_t)f32_slots(N) * f32_stage(N) + 2 * f32_slots(N) * sizeof(uint64_t) +
         (cs > 1 ? 2 * (size_t)mrows * FCS * sizeof(float) : 0) +
         (size_t)mrows * (ms_chunk + FMSKEW) * sizeof(float);
}

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

// d[64 x N] (+)= A[64 x 8] @ B[8 x N] in TF32: A in registers (this warp's 16
// rows as the m16n8k8 TF32 fragment: rows g, g + 8, columns q, q + 4), B
// K-major in shared memory (db; TF32 takes no transpose).  scale_d = 0
// overwrites d.  d's thread layout is the bf16 forms' (sm90.cuh).
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], const unsigned (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const unsigned (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const unsigned (&a)[4], uint64_t db,
                                           int scale_d) {
  if constexpr (N == 32) wgmma_tf32_n32(d, a, db, scale_d);
  else wgmma_tf32_n64(d, a, db, scale_d);
}

// One step's A (K = FBK: 4 k8), split: x = hi + lo.
struct F32Frag {
  unsigned hi[FBK / 8][4], lo[FBK / 8][4];
};

__device__ __forceinline__ void fence_frag(F32Frag& f) {
#pragma unroll
  for (int j = 0; j < FBK / 8; ++j) {
    fence_regs(f.hi[j]);
    fence_regs(f.lo[j]);
  }
}

template <int N>
__device__ __forceinline__ void add_bank(float (&tot)[N / 2], const float (&part)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) tot[i] += part[i];
}

// tot += A @ B over `steps` steps of K = FBK (ring iterations it0 .., NS
// slots), each product as lo*hi + hi*lo + hi*hi (3xTF32; lo*lo is below
// fp32's rounding).  gather(s, frag) loads and splits step s's A into
// registers; B's hi and lo planes sit at byte offsets b_hi and b_lo of the
// step's ring slot.  pre(s) runs on every thread before step s's gather;
// issue(it) on every thread once step it0 + s - 1's slot is released (the
// loading thread issues ring iteration it + NS - FLOOK_SLACK there).
//
// The tensor cores add into their fp32 accumulator without rounding to
// nearest, which over K = 4608 drifts ~30x past an fp32 sum.  So products go
// into partial sums of kpart steps, in two banks that take the steps in turn
// (the first wgmma of a fresh partial has scale-d = 0), and each partial is
// added into tot in plain fp32 once its group is done, while the other
// bank's products run.  A is double-buffered the same way: step s + 1's
// gather runs while step s multiplies.
template <int N, int NS, class Pre, class Gather, class Issue>
__device__ __forceinline__ void f32_gemm(float (&tot)[N / 2], int steps, int it0, int kpart,
                                         bool active, const unsigned char* ring, int b_hi,
                                         int b_lo, uint64_t* full, uint64_t* empty, int lane,
                                         Pre& pre, Gather& gather, Issue& issue) {
  float p0[N / 2], p1[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) p0[i] = p1[i] = 0.f;
  F32Frag f0, f1;
  // step u closes its bank's partial: its kpart-th use, or the bank's last
  auto closes = [&](int u) { return (u / 2) % kpart == kpart - 1 || u + 2 >= steps; };
  auto step = [&](int s, float (&P)[N / 2], float (&Q)[N / 2], F32Frag& cur, F32Frag& next) {
    if (active) {
      const unsigned char* st = ring + (it0 + s) % NS * f32_stage(N);
      const uint64_t dh = wgmma_desc(st + b_hi), dl = wgmma_desc(st + b_lo);
      const int keep = (s / 2) % kpart != 0;  // 0: the step opens a partial
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < FBK / 8; ++j) {
        wgmma_tf32<N>(P, cur.lo[j], dh + 2 * j, j == 0 ? keep : 1);
        wgmma_tf32<N>(P, cur.hi[j], dl + 2 * j, 1);
        wgmma_tf32<N>(P, cur.hi[j], dh + 2 * j, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // step s - 1's group: its bank, its A (`next`) and its slot are free
      fence_regs(Q);
      fence_frag(next);
      if (s > 0 && closes(s - 1)) add_bank<N>(tot, Q);
    }
    if (s > 0 && lane == 0) mbar_arrive(&empty[(it0 + s - 1) % NS]);
    issue(it0 + s);
    if (s + 1 < steps) {
      pre(s + 1);
      mbar_wait(&full[(it0 + s + 1) % NS], (it0 + s + 1) / NS & 1);
      if (active) gather(s + 1, next);
    }
  };
  pre(0);
  mbar_wait(&full[it0 % NS], it0 / NS & 1);
  if (active) gather(0, f0);
  for (int s = 0; s < steps; s += 2) {
    step(s, p0, p1, f0, f1);
    if (s + 1 < steps) step(s + 1, p1, p0, f1, f0);
  }
  wgmma_wait<0>();  // every thread, so that none leaves with a group it cannot see retired
  if (active) {
    fence_regs(p0);
    fence_regs(p1);
    fence_frag(f0);
    fence_frag(f1);
    if ((steps - 1) % 2 == 0)
      add_bank<N>(tot, p0);
    else
      add_bank<N>(tot, p1);
  }
  if (lane == 0) mbar_arrive(&empty[(it0 + steps - 1) % NS]);
}

// y, out: [B, H, W, C] (C % 4 == 0); b1: [Cmid]; b2: [C].  The weights come
// split into TF32 hi and lo planes, K-major and zero-padded, from the host
// (ops/fused_res_block.py::tf32_weights): w1p [2][Mpad][Cp] (plane, mid
// channel m, input channel k; Mpad = Cmid rounded up to FMGRAN, Cp = C
// rounded up to FBK) and w2p [2][C][9 * Mpad] (output channel, then K
// chunk-major: column (kc * 9 + t) * FBK + j holds w2[t / 3, t % 3, kc * FBK +
// j, co]).  All three arrive as TMA descriptors, 128-byte swizzled: y_map
// boxes of FBK channels x the tile's mid rows (flat: [B][H*W][C], 128
// pixels from q0 = p0 - W - 1; 8x8: [B][H][W][C], the 10 x 10 halo window;
// out-of-image pixels read as zeros), w1_map FBK x N x 2 planes, w2_map FBK x
// 2N x 2 planes.
//
// Grid: (tiles, splits, B) in clusters of (1, cs, 1).  A tile is 64 output
// pixels, an 8x8 square (mid rows: the 10 x 10 window, row stride 10) or,
// where the image is narrow (flat), 64 pixels in raster order (mid rows: the
// raster run from one row above to one row below, row stride W; a tap that
// would wrap past the left or right edge reads 0).  Block rank j of a
// cluster computes mid channels [j*MS, (j+1)*MS) of the tile's mid rows, and
// blockIdx.y picks output channels [y*co_per_block, (y+1)*co_per_block).
//
// Thread 0 also loads: it issues every TMA load through one ring (conv1's
// steps, then conv2's), FNS - FLOOK_SLACK steps ahead of the step being
// multiplied, each slot with a `full` barrier (its bytes in) and an `empty`
// barrier (the 8 warps out).  The two warpgroups multiply.
template <int N>
__global__ void __launch_bounds__(FNT, 1) res_block_f32_kernel(
    const __grid_constant__ CUtensorMap y_map, const __grid_constant__ CUtensorMap w1_map,
    const __grid_constant__ CUtensorMap w2_map, const float* __restrict__ y,
    const float* __restrict__ b1, const float* __restrict__ b2, float* __restrict__ out, int H,
    int W, int C, int Cmid, int Mpad, int Cp, int MS, int flat, int tiles_w, int mrows,
    int co_per_block, int kpart) {
  constexpr int FNS = f32_slots(N), FLOOK = FNS - FLOOK_SLACK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + FNS * f32_stage(N));
  uint64_t* empty = full + FNS;
  const int rank = (int)cluster.block_rank(), cs = (int)cluster.num_blocks();
  float* cbuf = reinterpret_cast<float*>(empty + FNS);  // [2][mrows][FCS]: copied chunks
  float* mid = cbuf + (cs > 1 ? 2 * mrows * FCS : 0);   // [mrows][ms]: this block's slice
  const int ms = MS + FMSKEW;
  if (threadIdx.x == 0) {
    for (int i = 0; i < FNS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  // the warp index as a warp-uniform value (a shuffle), so that the compiler
  // sees the wgmma paths below as convergent (see the bf16 kernel)
  const int tid = threadIdx.x, lane = tid % 32, warp = __shfl_sync(0xffffffff, tid / 32, 0);
  const int wg = warp / 4, wq = warp % 4;  // warpgroup, its warp
  const int g = lane / 4, q = lane % 4;    // accumulator row, column pair
  const int b = blockIdx.z;
  const int p0 = blockIdx.x * TP;                       // flat: the tile's first pixel
  const int q0 = p0 - W - 1;                            // flat: its first mid row's pixel
  const int ty0 = (blockIdx.x / tiles_w) * TH;          // 8x8: the tile's corner
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int m_lo = rank * MS;                   // this block's first mid channel
  const int nm = max(0, min(MS, Mpad - m_lo));  // ... and how many it computes
  const int steps1 = Cp / FBK, n1 = (nm + N - 1) / N * steps1;
  const int nchunks = Mpad / FBK, steps2 = 9 * nchunks;
  const int co_begin = blockIdx.y * co_per_block;
  const int co_end = min(C, co_begin + co_per_block);
  const int n_all = n1 + (co_end - co_begin + 2 * N - 1) / (2 * N) * steps2;

  // thread 0's TMA load of ring iteration `it` (conv1 pass it / steps1, or
  // conv2 pass (it - n1) / steps2), once the slot's last step is released
  auto load = [&](int it) {
    if (it >= n_all) return;
    const int slot = it % FNS;
    if (it >= FNS) mbar_wait(&empty[slot], (it / FNS - 1) & 1);
    unsigned char* st = ring + slot * f32_stage(N);
    if (it < n1) {
      const int s = it % steps1, n0 = it / steps1 * N;
      mbar_expect_tx(&full[slot],
                     ((flat ? FBM1 : HP) + 2 * N) * FBK * (int)sizeof(float));
      if (flat)
        tma_load_3d(st, &y_map, &full[slot], s * FBK, q0, b);
      else
        tma_load_4d(st, &y_map, &full[slot], s * FBK, tx0 - 1, ty0 - 1, b);
      tma_load_3d(st + FBM1 * 128, &w1_map, &full[slot], s * FBK, m_lo + n0, 0);
    } else {
      const int s = (it - n1) % steps2, c0 = co_begin + (it - n1) / steps2 * 2 * N;
      mbar_expect_tx(&full[slot], 4 * N * FBK * (int)sizeof(float));
      tma_load_3d(st, &w2_map, &full[slot], s * FBK, c0, 0);
    }
  };
  // every thread, once ring iteration it - 1 is released: thread 0 loads
  // iteration it + FLOOK
  auto issue = [&](int it) {
    if (tid == 0) load(it + FLOOK);
    __syncwarp();
  };
  if (tid == 0) {
    tma_prefetch_map(&y_map);
    tma_prefetch_map(&w1_map);
    tma_prefetch_map(&w2_map);
    for (int it = 0; it < FLOOK; ++it) load(it);
  }
  __syncwarp();
  const int r0 = wg * 64 + wq * 16 + g;  // conv1: this lane's mid rows r0, r0 + 8
  auto no_pre = [](int) {};

  // ---- conv1: mid[mrows x nm] = y[mrows x C] @ w1[C x (m_lo .. m_lo + nm)] --
  // Warpgroup wg takes mid rows [64*wg, 64*wg + 64) of the 128 (rows past
  // mrows hold stale or unused pixels; their sums are dropped), N mid
  // channels a pass.  A is read from the staged y rows (row r's 16-byte chunk
  // c sits at chunk c ^ (r % 8): the TMA swizzle) and split in registers.
  for (int n0 = 0, it = 0; n0 < nm; n0 += N, it += steps1) {
    float tot[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) tot[i] = 0.f;
    auto gather1 = [&](int s, F32Frag& f) {
      const float* yr = reinterpret_cast<const float*>(ring + (it + s) % FNS * f32_stage(N));
#pragma unroll
      for (int j = 0; j < FBK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = (((2 * j + c) ^ g) << 2) + q;
          split_tf32(yr[r0 * FBK + col], f.hi[j][2 * c], f.lo[j][2 * c]);
          split_tf32(yr[(r0 + 8) * FBK + col], f.hi[j][2 * c + 1], f.lo[j][2 * c + 1]);
        }
    };
    f32_gemm<N, FNS>(tot, steps1, it, kpart, true, ring, FBM1 * 128, (FBM1 + N) * 128, full,
                     empty, lane, no_pre, gather1, issue);
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = r0 + 8 * h;
        const int n = n0 + i * 8 + 2 * q;  // local mid channel (nm % 32 == 0)
        if (p >= mrows || n >= nm) continue;
        bool inside;
        if (flat) {
          inside = (unsigned)(q0 + p) < (unsigned)(H * W);
        } else {
          const int gy = ty0 - 1 + p / HWIN, gx = tx0 - 1 + p % HWIN;
          inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        }
        const int m = m_lo + n;
        // 0 outside the image (the 3x3's zero padding) and in padded channels
        const float v0 = inside && m < Cmid ? leaky(tot[4 * i + 2 * h] + b1[m]) : 0.f;
        const float v1 = inside && m + 1 < Cmid ? leaky(tot[4 * i + 2 * h + 1] + b1[m + 1]) : 0.f;
        *reinterpret_cast<float2*>(mid + p * ms + n) = make_float2(v0, v1);
      }
  }
  cluster_arrive();  // this block's mid slice is complete (release)
  cluster_wait();    // ... and every peer's (acquire)

  // ---- conv2: 9 tap GEMMs [64 x 9*Mpad] @ [9*Mpad x co] over the cluster's mid
  // Step s is tap s % 9 of mid chunk s / 9 (FBK channels), K chunk-major as
  // w2p lays it out.  Warpgroup wg owns channels [c0 + wg*N, c0 + (wg+1)*N)
  // of a pass, its warp wq output pixels [16*wq, 16*wq + 16).  A rows are the
  // mid rows shifted by the tap, loaded by address (a descriptor cannot
  // express the shift) and split in registers.  In a cluster every chunk is
  // first copied into one of two local buffers (from the peer that holds it:
  // distributed shared memory), one chunk ahead, between block barriers.
  const int rs = flat ? W : HWIN;  // mid row stride (pixels) of one image row
  int arow[2];                     // mid rows of this lane's A rows at tap (0, 0)
  bool left[2], right[2];          // flat: the pixel is at the left / right edge
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = wq * 16 + g + 8 * h;
    if (flat) {
      const int x = (p0 + i) % W;
      arow[h] = i;
      left[h] = x == 0;
      right[h] = x == W - 1;
    } else {
      arow[h] = (i / TW) * HWIN + i % TW;
      left[h] = right[h] = false;
    }
  }
  const int per_rank = MS / FBK;  // mid chunks held by each block
  auto copy_chunk = [&](int kc) {
    const float* src = cluster.map_shared_rank(mid, kc / per_rank) + (kc % per_rank) * FBK;
    float* dst = cbuf + (kc & 1) * mrows * FCS;
    const int n = mrows * (FBK / 4);
    float4 v[4];  // FBM1 * (FBK / 4) / 256 = 4 a thread: all loads, then all stores
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + u * 256;
      if (i < n) v[u] = *reinterpret_cast<const float4*>(src + (i / 8) * ms + (i % 8) * 4);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + u * 256;
      if (i < n) *reinterpret_cast<float4*>(dst + (i / 8) * FCS + (i % 8) * 4) = v[u];
    }
  };
  // before chunk kc's first gather: every consumer is past chunk kc - 1 and
  // chunk kc is in; then chunk kc + 1 goes into the other buffer
  auto pre2 = [&](int s) {
    if (cs == 1 || s % 9 != 0) return;
    const int kc = s / 9;
    if (kc == 0) {
      __syncthreads();
      copy_chunk(0);
    }
    __syncthreads();
    if (kc + 1 < nchunks) copy_chunk(kc + 1);
  };
  const size_t img = (size_t)b * H * W * C;
  // the image offset of output pixel pi of the tile, or -1 past the image
  auto pixel = [&](int pi) {
    if (flat) return p0 + pi < H * W ? p0 + pi : -1;
    const int gy = ty0 + pi / TW, gx = tx0 + pi % TW;
    return gy < H && gx < W ? gy * W + gx : -1;
  };
  const int pix[2] = {pixel(wq * 16 + g), pixel(wq * 16 + g + 8)};
  for (int c0 = co_begin, it = n1; c0 < co_end; c0 += 2 * N, it += steps2) {
    const bool active = c0 + wg * N < co_end;  // uniform in the warpgroup
    float tot[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) tot[i] = 0.f;
    // the residual y of this thread's outputs, loaded while the pass runs
    float2 yres[N / 8][2];
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = c0 + wg * N + i * 8 + 2 * q;  // co_end is even
        yres[i][h] = active && pix[h] >= 0 && co < co_end
                         ? *reinterpret_cast<const float2*>(y + img + (size_t)pix[h] * C + co)
                         : make_float2(0.f, 0.f);
      }
    auto gather2 = [&](int s, F32Frag& f) {
      const int kc = s / 9, t = s - 9 * kc, dx = t % 3;
      const float* src = cs > 1 ? cbuf + (kc & 1) * mrows * FCS : mid + kc * FBK;
      const int stride = cs > 1 ? FCS : ms;
      const int shift = (t / 3) * rs + dx;
      const bool z0 = dx == 0 ? left[0] : dx == 2 && right[0];
      const bool z1 = dx == 0 ? left[1] : dx == 2 && right[1];
      const float* x0 = src + (arow[0] + shift) * stride + q;
      const float* x1 = src + (arow[1] + shift) * stride + q;
#pragma unroll
      for (int j = 0; j < FBK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 4 * c;
          split_tf32(z0 ? 0.f : x0[col], f.hi[j][2 * c], f.lo[j][2 * c]);
          split_tf32(z1 ? 0.f : x1[col], f.hi[j][2 * c + 1], f.lo[j][2 * c + 1]);
        }
    };
    f32_gemm<N, FNS>(tot, steps2, it, kpart, active, ring, wg * N * 128, (2 * N + wg * N) * 128,
                     full, empty, lane, pre2, gather2, issue);
    if (!active) continue;
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = c0 + wg * N + i * 8 + 2 * q;
        if (pix[h] < 0 || co >= co_end) continue;
        *reinterpret_cast<float2*>(out + img + (size_t)pix[h] * C + co) =
            make_float2(yres[i][h].x + leaky(tot[4 * i + 2 * h] + b2[co]),
                        yres[i][h].y + leaky(tot[4 * i + 2 * h + 1] + b2[co + 1]));
      }
  }
  cluster_arrive();  // done reading the peers' mid
  cluster_wait();    // no block exits while a peer may still read its mid
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Each tile's output channels are split over `splits` blocks, and its mid
// channels (conv1) over clusters of cs of them (cs divides splits; where cs <
// splits the cluster is repeated, each copy recomputing its conv1, where SMs
// would otherwise idle): the planner picks the pair that minimises (waves of
// clusters on the card, from cudaOccupancyMaxActiveClusters) x (one block's
// MACs: conv1's share ROWS1*C*MS plus conv2 on co_per_block channels).
// Small grids (13x13, 26x26 at batch 8) split; grids that already fill the
// card do not.  fp32 also picks the tile geometry: where W <= FLAT_MAX_W a
// tile may be 64 pixels in raster order (flat) rather than an 8x8 square, so
// that 13x13 takes 3 tiles of 64 rows an image (88% of the rows real)
// instead of 4 (66%) and 26x26 11 instead of 16; the planner counts tiles of
// each geometry and keeps flat where its waves x MACs are lower.  The variant
// (the kernel's template argument) is picked by C:
//   fp32: N channels per warpgroup: 32 where C = 64 (both warpgroups busy),
//     64 above (a total and two partial banks of N / 2 floats, two split A
//     fragments and the residual fit a thread's 255 registers; 128 would
//     not);
//   bf16: V channels per warpgroup: 32 where C = 64 (both warpgroups busy),
//     64 where C = 128, 128 above (measured on an H100 at batch 8: 64 lost
//     to 128 at 13x13, 26x26 and 52x52, and 128 or 32 to 64 at 104x104).
// Plans are cached by (device, dtype, shape): the occupancy queries and
// cudaFuncSetAttribute cost host time, and run once per shape.
struct Plan {
  int dev, bf16, act, B, H, W, C, Cmid;  // act: 1 leaky, 2 Mish (bf16 only)
  int variant, splits, cs, ms_chunk, co_per_block;  // variant: the kernel's template argument
  int flat, tiles, mrows;  // geometry: raster tiles (1) or 8x8 (0); tiles an image; mid rows
  size_t smem;
};

template <int N>
struct F32Kernel {
  static constexpr int VARIANT = N, N2 = 2 * N, MGRAN = FMGRAN, MSG = FBK, THREADS = FNT;
  static constexpr int ROWS1 = FBM1;  // conv1 rows a tile computes
  static constexpr bool REPLICATE = true, FLAT = true;
  static const void* fn() { return reinterpret_cast<const void*>(res_block_f32_kernel<N>); }
  static size_t smem(int, int, int ms_chunk, int cs, int mrows) {
    return f32_smem(N, ms_chunk, cs, mrows);
  }
};

template <int V, class Act>
struct Bf16Kernel {
  static constexpr int VARIANT = V, N2 = 2 * V, MGRAN = BMGRAN, MSG = BMGRAN, THREADS = BNT;
  static constexpr int ROWS1 = HP;
  static constexpr bool REPLICATE = true, FLAT = false;
  static const void* fn() { return reinterpret_cast<const void*>(res_block_bf16_kernel<V, Act>); }
  // + 1024: the ring's alignment; then the barriers and the biases in fp32
  static size_t smem(int C, int Mpad, int, int, int) {
    return bf16_mid_bytes(Mpad) + 1024 + (size_t)bf16_region(V) * sizeof(bf16) +
           2 * (BNS1 + BNS2) * sizeof(uint64_t) + (size_t)(Mpad + C) * sizeof(float);
  }
};

cudaLaunchConfig_t cluster_config(dim3 grid, int cs, int threads, size_t smem, void* stream,
                                  cudaLaunchAttribute (&attr)[1]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <class K>
int split(Plan* best) {
  int max_smem = 0;
  cudaError_t e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                         best->dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(K::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (e != cudaSuccess) return (int)e;
  const int B = best->B, H = best->H, W = best->W, C = best->C;
  const int Mpad = ceil_div(best->Cmid, K::MGRAN) * K::MGRAN;
  const int chunks = ceil_div(C, K::N2), kchunks = Mpad / K::MSG;
  double best_cost = -1;
  for (int flat = 0; flat <= (K::FLAT && W <= FLAT_MAX_W ? 1 : 0); ++flat) {
    const int tiles = flat ? ceil_div(H * W, TH * TW) : ceil_div(H, TH) * ceil_div(W, TW);
    const int mrows = flat ? TH * TW + 2 * W + 2 : HP;
    for (int s = 1; s <= MAX_CLUSTER && s <= chunks; ++s) {
      const int per_block = ceil_div(chunks, s);
      if (ceil_div(chunks, per_block) != s) continue;  // the same split as a smaller s
      for (int cs = K::REPLICATE ? 1 : s; cs <= s && cs <= kchunks; ++cs) {
        if (s % cs != 0) continue;
        const int ms_chunk = ceil_div(kchunks, cs) * K::MSG;
        const size_t smem = K::smem(C, Mpad, ms_chunk, cs, mrows);
        if (smem > (size_t)max_smem) continue;
        cudaLaunchAttribute attr[1];
        const cudaLaunchConfig_t cfg =
            cluster_config(dim3(tiles, s, B), cs, K::THREADS, smem, nullptr, attr);
        int clusters = 0;
        e = cudaOccupancyMaxActiveClusters(&clusters, K::fn(), &cfg);
        if (e != cudaSuccess) return (int)e;
        if (clusters < 1) continue;
        const long all = (long)tiles * B * (s / cs);
        const double waves = (double)((all + clusters - 1) / clusters);
        const double cost = waves * ((double)K::ROWS1 * C * ms_chunk +
                                     64.0 * 9 * Mpad * per_block * K::N2);
        if (best_cost < 0 || cost < best_cost) {
          best_cost = cost;
          best->variant = K::VARIANT;
          best->splits = s;
          best->cs = cs;
          best->ms_chunk = ms_chunk;
          best->co_per_block = per_block * K::N2;
          best->flat = flat;
          best->tiles = tiles;
          best->mrows = mrows;
          best->smem = smem;
        }
      }
    }
  }
  // Cmid too wide for the shared memory of MAX_CLUSTER blocks
  return best_cost < 0 ? (int)cudaErrorInvalidConfiguration : 0;
}

std::mutex plan_mutex;
Plan plans[64];
int n_plans = 0;

template <class Act>
int split_bf16(int C, Plan* plan) {
  return C < 128 ? split<Bf16Kernel<32, Act>>(plan)
         : C < 256 ? split<Bf16Kernel<64, Act>>(plan) : split<Bf16Kernel<128, Act>>(plan);
}

int get_plan(int bf16, int act, int B, int H, int W, int C, int Cmid, Plan* out) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cmid <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (act != ActLeaky::ACT && (act != ActMish::ACT || !bf16)) return (int)cudaErrorInvalidValue;
  if (C % (bf16 ? 8 : 4) != 0) return (int)cudaErrorInvalidValue;  // 16-byte rows of y
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(plan_mutex);
  for (int i = 0; i < n_plans; ++i) {
    const Plan& p = plans[i];
    if (p.dev == dev && p.bf16 == bf16 && p.act == act && p.B == B && p.H == H && p.W == W &&
        p.C == C && p.Cmid == Cmid) {
      *out = p;
      return 0;
    }
  }
  Plan plan = {dev, bf16, act, B, H, W, C, Cmid, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  int rc;
  if (!bf16)
    rc = C <= 64 ? split<F32Kernel<32>>(&plan) : split<F32Kernel<64>>(&plan);
  else
    rc = act == ActMish::ACT ? split_bf16<ActMish>(C, &plan) : split_bf16<ActLeaky>(C, &plan);
  if (rc != 0) return rc;
  if (n_plans < (int)(sizeof(plans) / sizeof(plans[0]))) plans[n_plans++] = plan;
  *out = plan;
  return 0;
}

template <class Act>
cudaError_t launch_bf16(const cudaLaunchConfig_t& cfg, int variant, const CUtensorMap& y_map,
                        const CUtensorMap& w1_map, const CUtensorMap& w2_map, const bf16* y,
                        const bf16* b1, const bf16* b2, bf16* out, int H, int W, int C, int Cmid,
                        int Mpad, int Cp, int K2p, int ms_chunk, int tiles_w, int co_per_block) {
  const auto kernel = variant == 128 ? res_block_bf16_kernel<128, Act>
                      : variant == 64 ? res_block_bf16_kernel<64, Act>
                                      : res_block_bf16_kernel<32, Act>;
  return cudaLaunchKernelEx(&cfg, kernel, y_map, w1_map, w2_map, y, b1, b2, out, H, W, C, Cmid,
                            Mpad, Cp, K2p, ms_chunk, tiles_w, co_per_block);
}

}  // namespace

extern "C" {

// Each returns the launch's cudaError_t (0 on success).  All pointers are
// device pointers to contiguous arrays; the kernel runs on `stream` and does
// not synchronise.  The weights are the host layouts described at each
// kernel (f32: hi and lo planes, padded, K-major; bf16: padded, K-major); a
// refused cluster launch returns its error (there is no other path).
// yolo_fused_res_block_f32_kpart takes the steps of K = 32 a partial sum
// spans (yolo_fused_res_block_f32: FKPART).
int yolo_fused_res_block_f32_kpart(const void* y, const void* w1p, const void* b1,
                                   const void* w2p, const void* b2, void* out, int B, int H,
                                   int W, int C, int Cmid, int kpart, void* stream) {
  if (kpart < 1) return (int)cudaErrorInvalidValue;
  Plan plan;
  int e = get_plan(0, ActLeaky::ACT, B, H, W, C, Cmid, &plan);
  if (e != 0) return e;
  const int N = plan.variant, Mpad = ceil_div(Cmid, FMGRAN) * FMGRAN;
  const int Cp = ceil_div(C, FBK) * FBK, K2 = 9 * Mpad;
  // y: flat [B][H*W][C], FBK channels x 128 pixels; 8x8 [B][H][W][C], FBK
  // channels x the 10 x 10 window.  w1p [2][Mpad][Cp]: FBK x N x 2; w2p
  // [2][C][K2]: FBK x 2N x 2.
  const cuuint64_t row = (cuuint64_t)C * sizeof(float);
  const cuuint64_t y_dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t y_strides[3] = {row, row * W, row * W * H};
  const cuuint32_t y_box[4] = {FBK, HWIN, TH + 2, 1};
  const cuuint64_t flat_dims[3] = {(cuuint64_t)C, (cuuint64_t)H * W, (cuuint64_t)B};
  const cuuint64_t flat_strides[2] = {row, row * W * H};
  const cuuint32_t flat_box[3] = {FBK, FBM1, 1};
  const cuuint64_t w1_dims[3] = {(cuuint64_t)Cp, (cuuint64_t)Mpad, 2};
  const cuuint64_t w1_strides[2] = {Cp * 4ull, Cp * 4ull * Mpad};
  const cuuint64_t w2_dims[3] = {(cuuint64_t)K2, (cuuint64_t)C, 2};
  const cuuint64_t w2_strides[2] = {K2 * 4ull, K2 * 4ull * C};
  const cuuint32_t w1_box[3] = {FBK, (cuuint32_t)N, 2}, w2_box[3] = {FBK, (cuuint32_t)(2 * N), 2};
  CUtensorMap y_map, w1_map, w2_map;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if ((e = plan.flat ? tensor_map(&y_map, f32, y, 3, flat_dims, flat_strides, flat_box)
                     : tensor_map(&y_map, f32, y, 4, y_dims, y_strides, y_box)) != 0 ||
      (e = tensor_map(&w1_map, f32, w1p, 3, w1_dims, w1_strides, w1_box)) != 0 ||
      (e = tensor_map(&w2_map, f32, w2p, 3, w2_dims, w2_strides, w2_box)) != 0)
    return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(dim3(plan.tiles, plan.splits, B), plan.cs, FNT,
                                                plan.smem, stream, attr);
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, N == 32 ? res_block_f32_kernel<32> : res_block_f32_kernel<64>, y_map, w1_map,
      w2_map, static_cast<const float*>(y), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<float*>(out), H, W, C, Cmid, Mpad, Cp,
      plan.ms_chunk, plan.flat, ceil_div(W, TW), plan.mrows, plan.co_per_block, kpart);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

int yolo_fused_res_block_f32(const void* y, const void* w1p, const void* b1, const void* w2p,
                             const void* b2, void* out, int B, int H, int W, int C, int Cmid,
                             void* stream) {
  return yolo_fused_res_block_f32_kpart(y, w1p, b1, w2p, b2, out, B, H, W, C, Cmid, FKPART,
                                        stream);
}

// act: 1 leaky, 2 Mish.
int yolo_fused_res_block_bf16(const void* y, const void* w1k, const void* b1, const void* w2k,
                              const void* b2, void* out, int B, int H, int W, int C, int Cmid,
                              int act, void* stream) {
  Plan plan;
  int e = get_plan(1, act, B, H, W, C, Cmid, &plan);
  if (e != 0) return e;
  const int Mpad = ceil_div(Cmid, BMGRAN) * BMGRAN, Cp = ceil_div(C, BK) * BK;
  const int K2p = ceil_div(9 * Mpad, BK) * BK, tiles_w = ceil_div(W, TW);
  // y [B][H][W][C]: BK channels of the 10 x 10 halo window; w1k [Mpad][Cp]:
  // BK x BN1; w2k [C][K2p]: BK x 2V
  const size_t row = (size_t)C * sizeof(bf16);
  const cuuint64_t y_dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t y_strides[3] = {row, row * W, row * W * H};
  const cuuint32_t y_box[4] = {BK, HWIN, TH + 2, 1};
  const cuuint64_t w1_dims[2] = {(cuuint64_t)Cp, (cuuint64_t)Mpad}, w1_strides[1] = {Cp * 2ull};
  const cuuint64_t w2_dims[2] = {(cuuint64_t)K2p, (cuuint64_t)C}, w2_strides[1] = {K2p * 2ull};
  const cuuint32_t w1_box[2] = {BK, BN1}, w2_box[2] = {BK, (cuuint32_t)(2 * plan.variant)};
  CUtensorMap y_map, w1_map, w2_map;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if ((e = tensor_map(&y_map, bf, y, 4, y_dims, y_strides, y_box)) != 0 ||
      (e = tensor_map(&w1_map, bf, w1k, 2, w1_dims, w1_strides, w1_box)) != 0 ||
      (e = tensor_map(&w2_map, bf, w2k, 2, w2_dims, w2_strides, w2_box)) != 0)
    return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3(ceil_div(H, TH) * tiles_w, plan.splits, B), plan.cs, BNT, plan.smem, stream, attr);
  const auto launch = act == ActMish::ACT ? launch_bf16<ActMish> : launch_bf16<ActLeaky>;
  const cudaError_t le = launch(
      cfg, plan.variant, y_map, w1_map, w2_map, static_cast<const bf16*>(y),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(b2), static_cast<bf16*>(out), H,
      W, C, Cmid, Mpad, Cp, K2p, plan.ms_chunk, tiles_w, plan.co_per_block);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}


// The launch plan of this dtype and activation (act as above; fp32: 1) for
// this shape on the current device, as 9 ints: variant (N or V channels a warpgroup), splits, cluster size, flat
// (1: raster tiles; 0: 8x8), tiles an image, mid rows a tile, mid channels a
// block, output channels a block, shared bytes; returns 0 or the
// cudaError_t.
int yolo_fused_res_block_plan(int bf16, int act, int B, int H, int W, int C, int Cmid,
                              int* out) {
  Plan plan;
  const int e = get_plan(bf16, act, B, H, W, C, Cmid, &plan);
  if (e != 0) return e;
  const int v[9] = {plan.variant, plan.splits, plan.cs, plan.flat, plan.tiles,
                    plan.mrows, plan.ms_chunk, plan.co_per_block, (int)plan.smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}


const char* yolo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
