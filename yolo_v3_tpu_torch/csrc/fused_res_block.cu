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
constexpr int NT = 256;             // threads per block
constexpr float LEAKY = 0.1f;

__device__ __forceinline__ float leaky(float x) { return x > 0.f ? x : LEAKY * x; }

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
template <int V>
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
              inside && m < Cmid ? leaky(acc[4 * i + 2 * h] + b1f[m]) : 0.f;
          const float v1 = inside && m + 1 < Cmid
                               ? leaky(acc[4 * i + 2 * h + 1] + b1f[m + 1])
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
          const __nv_bfloat162 r = __floats2bfloat162_rn(leaky(acc[4 * i + 2 * h] + b2f[co]),
                                                         leaky(acc[4 * i + 2 * h + 1] + b2f[co + 1]));
          const __nv_bfloat162 yv = yres[i][h];
          *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(
              __low2float(yv) + __low2float(r), __high2float(yv) + __high2float(r));
        }
    }
  }
  if (cs > 1) cluster_wait();  // no block exits while a peer may still read its mid
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

// Each tile's output channels are split over `splits` blocks, and its mid
// channels (conv1) over clusters of cs of them (fp32: cs = splits; bf16 may
// repeat a cluster, each recomputing its conv1, where SMs would otherwise
// idle): the planner picks the pair that minimises (waves of clusters on the
// card, from cudaOccupancyMaxActiveClusters) x (one block's MACs: conv1's
// share HP*C*MS plus conv2 on co_per_block channels).  Small grids (13x13,
// 26x26 at batch 8) split; grids that already fill the card do not.  The
// variant (the kernel's template argument) is picked by C:
//   fp32: conv2's warp tile is 32 x 32 (NI = 4) where C >= 512 (26x26 and
//     13x13 at 416): measured on an H100 at batch 8, it beats the 32 x 16
//     tile there, and loses where C is small (C = 64 at 208x208 would leave
//     half of its 128 channels idle);
//   bf16: V channels per warpgroup: 32 where C = 64 (both warpgroups busy),
//     64 where C = 128, 128 above (measured on an H100 at batch 8: 64 lost
//     to 128 at 13x13, 26x26 and 52x52, and 128 or 32 to 64 at 104x104).
// Plans are cached by (device, dtype, shape): the occupancy queries and
// cudaFuncSetAttribute cost host time, and run once per shape.
struct Plan {
  int dev, bf16, B, H, W, C, Cmid;
  int variant, splits, cs, ms_chunk, co_per_block;  // variant: the kernel's template argument
  size_t smem;
};

template <int NI>
struct F32Kernel {
  static constexpr int VARIANT = NI, N2 = f32_n2(NI), MGRAN = FMGRAN, MSG = FK2, THREADS = NT;
  static constexpr bool REPLICATE = false;
  static const void* fn() { return reinterpret_cast<const void*>(res_block_f32_kernel<NI>); }
  static size_t smem(int, int, int ms_chunk) {
    return ((size_t)HP * (ms_chunk + FMSKEW) + f32_region(NI)) * sizeof(float);
  }
};

template <int V>
struct Bf16Kernel {
  static constexpr int VARIANT = V, N2 = 2 * V, MGRAN = BMGRAN, MSG = BMGRAN, THREADS = BNT;
  static constexpr bool REPLICATE = true;
  static const void* fn() { return reinterpret_cast<const void*>(res_block_bf16_kernel<V>); }
  // + 1024: the ring's alignment; then the barriers and the biases in fp32
  static size_t smem(int C, int Mpad, int) {
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
  const int B = best->B, C = best->C;
  const int Mpad = ceil_div(best->Cmid, K::MGRAN) * K::MGRAN;
  const int tiles = ceil_div(best->H, TH) * ceil_div(best->W, TW);
  const int chunks = ceil_div(C, K::N2), kchunks = Mpad / K::MSG;
  double best_cost = -1;
  for (int s = 1; s <= MAX_CLUSTER && s <= chunks; ++s) {
    const int per_block = ceil_div(chunks, s);
    if (ceil_div(chunks, per_block) != s) continue;  // the same split as a smaller s
    for (int cs = K::REPLICATE ? 1 : s; cs <= s && cs <= kchunks; ++cs) {
      if (s % cs != 0) continue;
      const int ms_chunk = ceil_div(kchunks, cs) * K::MSG;
      const size_t smem = K::smem(C, Mpad, ms_chunk);
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
      const double cost = waves * ((double)HP * C * ms_chunk +
                                   64.0 * 9 * Mpad * per_block * K::N2);
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        best->variant = K::VARIANT;
        best->splits = s;
        best->cs = cs;
        best->ms_chunk = ms_chunk;
        best->co_per_block = per_block * K::N2;
        best->smem = smem;
      }
    }
  }
  // Cmid too wide for the shared memory of MAX_CLUSTER blocks
  return best_cost < 0 ? (int)cudaErrorInvalidConfiguration : 0;
}

std::mutex plan_mutex;
Plan plans[64];
int n_plans = 0;

int get_plan(int bf16, int B, int H, int W, int C, int Cmid, Plan* out) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cmid <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (bf16 && C % 8 != 0) return (int)cudaErrorInvalidValue;  // 16-byte rows of y
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(plan_mutex);
  for (int i = 0; i < n_plans; ++i) {
    const Plan& p = plans[i];
    if (p.dev == dev && p.bf16 == bf16 && p.B == B && p.H == H && p.W == W && p.C == C &&
        p.Cmid == Cmid) {
      *out = p;
      return 0;
    }
  }
  Plan plan = {dev, bf16, B, H, W, C, Cmid, 0, 0, 0, 0, 0, 0};
  int rc;
  if (!bf16)
    rc = C >= 512 ? split<F32Kernel<4>>(&plan) : split<F32Kernel<2>>(&plan);
  else
    rc = C < 128 ? split<Bf16Kernel<32>>(&plan)
         : C < 256 ? split<Bf16Kernel<64>>(&plan) : split<Bf16Kernel<128>>(&plan);
  if (rc != 0) return rc;
  if (n_plans < (int)(sizeof(plans) / sizeof(plans[0]))) plans[n_plans++] = plan;
  *out = plan;
  return 0;
}

}  // namespace

extern "C" {

// Each returns the launch's cudaError_t (0 on success).  All pointers are
// device pointers to contiguous arrays; the kernel runs on `stream` and does
// not synchronise.  The weights are the host layouts described at each
// kernel (f32: split, padded, K-major; bf16: padded, K-major); a refused
// cluster launch returns its error (there is no other path).
int yolo_fused_res_block_f32(const void* y, const void* w1s, const void* b1,
                             const void* w2s, const void* b2, void* out, int B,
                             int H, int W, int C, int Cmid, void* stream) {
  Plan plan;
  const int e = get_plan(0, B, H, W, C, Cmid, &plan);
  if (e != 0) return e;
  const int Mpad = ceil_div(Cmid, FMGRAN) * FMGRAN, Cp = ceil_div(C, FK1) * FK1;
  const int tiles_w = ceil_div(W, TW);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3(ceil_div(H, TH) * tiles_w, plan.splits, B), plan.cs, NT, plan.smem, stream, attr);
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, plan.variant == 4 ? res_block_f32_kernel<4> : res_block_f32_kernel<2>,
      static_cast<const float*>(y), static_cast<const float*>(w1s),
      static_cast<const float*>(b1), static_cast<const float*>(w2s),
      static_cast<const float*>(b2), static_cast<float*>(out), H, W, C, Cmid, Mpad, Cp,
      plan.ms_chunk, tiles_w, plan.co_per_block);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

int yolo_fused_res_block_bf16(const void* y, const void* w1k, const void* b1,
                              const void* w2k, const void* b2, void* out, int B,
                              int H, int W, int C, int Cmid, void* stream) {
  Plan plan;
  int e = get_plan(1, B, H, W, C, Cmid, &plan);
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
  const auto kernel = plan.variant == 128 ? res_block_bf16_kernel<128>
                      : plan.variant == 64 ? res_block_bf16_kernel<64>
                                           : res_block_bf16_kernel<32>;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, kernel, y_map, w1_map, w2_map, static_cast<const bf16*>(y),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(b2), static_cast<bf16*>(out), H,
      W, C, Cmid, Mpad, Cp, K2p,
      plan.ms_chunk, tiles_w, plan.co_per_block);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

// The cluster size the launch of this dtype (bf16: 1, fp32: 0) picks for
// this shape on the current device (1: no split), or minus its cudaError_t.
int yolo_fused_res_block_cluster(int bf16, int B, int H, int W, int C, int Cmid) {
  Plan plan;
  const int e = get_plan(bf16, B, H, W, C, Cmid, &plan);
  return e != 0 ? -e : plan.cs;
}

const char* yolo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
