// The resample design-space variants: out = the trilinear resample of a
// (X, Y, 128) field at v + u(v), ux and uy clamped to ±K, +1 outside, as a
// sum over the (2K+2)^2 integer x/y shifts of the +1-padded field P:
//   out = (1 - w0 - w1) + sum_{cy, cx} tent(uy - (cy - K)) tent(ux - (cx - K))
//                                      (w0 P(x+cx, y+cy, z0) + w1 P(.., z0+1))
// summed acc0 first, then cy outer and cx inner.
//
// Replaces three TPU kernels of experiments/resample_variants.py:
// - run_variant (B3, line 197): one grid step per (x row, y block), each
//   DMAing its (n, n, yb, 128) window of stacked y-shifted copies; bodies
//   _kernel_v6 (+ static00 / nogather), _noslice, _twolevel, _chunk,
//   _unroll, _passthrough, _onepair;
// - run_vmemfull (B4, line 280): the whole stack resident, x walked
//   fastest; inner fori / chunk / unroll;
// - run_v7 (B5, line 348): as B4 with the 2n tent values computed once per
//   voxel; structure chunk / unroll.
// The stacked copies are the TPU's way around a dynamic sublane offset; here
// no stack is built: each CTA stages the padded rows it needs in shared
// memory with cp.async and writes the +1 fill for rows outside the volume.
// The clamp, which the TPU wrappers apply to the warp before the call, is
// applied as the warp is read (clipping is exact: the same value).
//
// Design. A CTA computes XC x rows by YB y rows by 128 z lanes, one thread
// per z lane (512 threads, 4 y rows at a time), so warp reads and output
// writes coalesce; the channel-last warp is read as three strided floats
// (12 B apart), which the warp's 384 contiguous bytes serve from L1. The CTA
// stages its padded rows TY y rows at a time: kN x rows of TY + kN - 1 y
// rows of 128 floats. Loop structure and body are template parameters:
//   loop  kPairLoop (v6: a runtime pair loop), kTwoLevel (cy static, cx at
//         runtime), kChunk (cy at runtime, cx static), kUnroll (both static);
//   body  kFull, and the TIMING-ONLY bodies of B3: kStatic00 (rows fixed at
//         shift (0, 0)), kNoSlice (the same value, its two z reads hoisted
//         out of the loop), kNoGather (no z gather), kPassthrough
//         (P(x, y, z) + ux), kOnePair (one pair).
// - B3 (XC = 1, per-step windows), tile_kernel: a CTA owns one x row and 64
//   y rows and stages its window of the 6 padded x rows 8 y rows at a time
//   (6 x 13 x 128 floats, 39 KB) into two buffers, the next tile's cp.async
//   in flight while the current tile's sums run; 78 KB, so two CTAs (32
//   warps) share an SM, and 128^3 is 256 CTAs, one wave. The geometry is
//   compile-time, so the staged strides are constants, and the pair loop
//   reads each pair's row and shifts from a table in constant memory
//   (resample_z.cuh's Pair): one LDC a pair and one LEA an address, not
//   t / kN. yb only gates the shapes. A Y that is not a multiple
//   of 8 (yb = Y) goes to window_kernel, the runtime geometry: one CTA per
//   (x row, y block of yb), staging yb rows (or gcd(yb, 64)) at a time.
// - B4 (ring_kernel): the TPU grid of Y/yb x-walking steps would be 2 CTAs
//   at 128^3 on 132 SMs, so the (y tile, x row) steps, tiles of kRingTY = 8
//   y rows and x fastest, are split into equal ranges, one a CTA, one wave
//   of CTAs on the current device (occupancy.cuh). A CTA (512 threads, two
//   voxels a thread a step) walks its range's x rows through a ring of
//   kN + 1 staged x rows (7 x 13 x 128 floats = 46,592 B: four CTAs, 64
//   warps, share an SM for fori, two for chunk and unroll), the next row's
//   cp.async in flight while the current row's sums run (one commit group
//   per step, as csrc/dma_probe.cu), and restarts the ring where its range
//   enters a new tile. Each padded row is staged once per range. The
//   geometry is compile-time: the pair loop (fori, resample_z.cuh's
//   pair_sum) reads pair t's row and shifts from kRingPairs (one table per
//   start slot) and addresses its two loads with one IMAD each; chunk and
//   unroll index their static pairs. A thread loads its next voxel's warp
//   before the sum. Tiles of 8 rows time faster than 4 or 16, and fori at
//   64 warps faster than at 48 or 16 (experiments/resample_variants_sweep.py).
//   A Y that is not a multiple of 8 goes to window_kernel.
// - B5 (ring_kernel<L, true>): B4's ring, the tents computed once a voxel.
//   Its chunk loop sums a thread's kVox voxels of a step together (rows r
//   and r + 4): one runtime cy loop, 6 static cx, each voxel with its own
//   acc, tents and z setup in its own order; the (cy, cx) row's offset is
//   computed once for both, and the two accumulator chains (4 LDS a pair
//   step) are independent. A thread loads the next x row's warps of both
//   voxels before the sum. Its unroll takes one voxel at a time through
//   the same loop, cy static. On the H100 at 128^3
//   (experiments/resample_variants_sweep.py, device us): the chunk one
//   voxel at a time takes 43.7 against 40.6-42.4 (532 against 422.5 SASS
//   a voxel); the unroll with two voxels together spills 104 B under the
//   64 registers of two CTAs an SM (41.8-42.1 against 39.9-40.0).
//   A Y that is not a multiple of 8 goes to window_kernel (XC = 8 x rows a
//   CTA over TY = gcd(yb, 16) y rows, a ring of kN + 1 staged x rows); the
//   2n tent values stay in registers (static indices only).
//
// What bounds it on the H100: shared-memory reads. Each voxel makes 36
// pairs x 2 z reads, 72 x 4 B = 288 B of shared-memory traffic, 604 MB at
// 128^3 against the card's ~30 TB/s of shared bandwidth (~20 us), where
// the golden gather (csrc/resample.cu) makes 8 reads from L2. The variants
// measure what the enumeration's loop structures cost on this card.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "cp_async.cuh"
#include "occupancy.cuh"
#include "resample_z.cuh"

namespace {

using namespace lsf_cp;
using namespace lsf_rz;

enum Loop { kPairLoop = 0, kTwoLevel = 1, kChunk = 2, kUnroll = 3 };
enum Body {
  kFull = 0, kStatic00 = 1, kNoSlice = 2, kNoGather = 3, kPassthrough = 4, kOnePair = 5,
};

constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;  // bytes of dynamic shared memory a block may use

struct Params {
  const float* field;  // (nx, ny, 128)
  const float* warp;   // (nx, ny, 128, 3), unclamped
  float* out;          // (nx, ny, 128)
  int nx, ny;
  int yb;     // y rows per CTA
  int ty;     // y rows staged at a time; divides yb
  int xc;     // x rows per CTA
  int slots;  // staged x rows: kN, or kN + 1 for a ring (xc > 1)
};

// B3's compile-time geometry (tile_kernel): a CTA owns one x row and
// kCtaRows y rows, and stages its window of the kN padded x rows kTileRows y
// rows at a time into two buffers.
constexpr int kTileRows = 8;
constexpr int kCtaRows = 64;
constexpr int kTileStage = kTileRows + kN - 1;        // padded y rows of a slot
constexpr int kTileFloats = kN * kTileStage * kLane;  // one tile: kN slots
constexpr int kTileSmem = 2 * kTileFloats * (int)sizeof(float);  // 79,872 B: two CTAs an SM

// Pair t's staged row in a tile: slot cx, row cy (resample_z.cuh).
__constant__ PairTable<1> kTilePairs = pair_table<1>(kN, kTileStage);

// The ring of B4 and B5 (ring_kernel<L, kTentsOnce>): tiles of kRingTY y
// rows, kN + 1 slots of kRingRows padded y rows, kRingCtas<L> CTAs an SM
// (the launch bounds cap the registers to match: 32 for fori, 64 for the
// static loops, which run faster with the registers than with the warps).
constexpr int kRingTY = 8;
constexpr int kRingRows = kRingTY + kN - 1;
constexpr int kRingSlots = kN + 1;
constexpr int kRingSlotF = kRingRows * kLane;
constexpr int kRingSmem = kRingSlots * kRingSlotF * (int)sizeof(float);  // 46,592 B
template <int L>
constexpr int kRingCtas = L == kPairLoop ? 4 : 2;
// B5's loops that sum a thread's voxels of a step together (the others take
// one voxel at a time).
template <int L>
constexpr bool kRingPaired = L == kChunk;

// Pair t's staged row from start slot s0: slot (s0 + cx) mod kRingSlots,
// row cy.
__constant__ PairTable<kRingSlots> kRingPairs = pair_table<kRingSlots>(kRingSlots, kRingRows);

// Stage padded x row px, padded y rows [y0, y0 + rows), into `slot`: a
// cp.async per 16 bytes inside the volume, a store of the +1 fill outside.
__device__ __forceinline__ void stage_row(const Params& p, float* slot, int px, int y0,
                                          int rows) {
  constexpr int kQuads = kLane / 4;
  const int fx = px - kK;
  for (int c = threadIdx.x; c < rows * kQuads; c += blockDim.x) {
    const int ry = c / kQuads, q = c - ry * kQuads;
    const int fy = y0 + ry - kK;
    float* dst = slot + ry * kLane + 4 * q;
    if (fx >= 0 && fx < p.nx && fy >= 0 && fy < p.ny) {
      cp_async16(dst, p.field + ((int64_t)fx * p.ny + fy) * kLane + 4 * q);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    }
  }
}

// One output voxel from the staged rows: slot (slot0 + cx) mod slots holds x
// shift cx, row r + cy of a slot holds y shift cy. kTile (B3's tiles, slot0
// 0, kN slots of kTileStage rows): the pair loop reads its pairs from
// kTilePairs, not t / kN.
template <int L, int B, bool kTentsOnce, bool kTile = false>
__device__ __forceinline__ float voxel(const float* smem, int slot0, int slots, int rps,
                                       int r, int z, float ux, float uy, const ZSetup& zs) {
  auto row = [&](int cy, int cx) -> const float* {
    int sl = slot0 + cx;
    if (sl >= slots) sl -= slots;
    return smem + (sl * rps + r + cy) * kLane;
  };
  auto gathered = [&](int cy, int cx) -> float {
    const float* rw = row(cy, cx);
    return zmix(zs, rw[zs.z0c], rw[zs.z1c]);
  };
  if (B == kPassthrough) return __fadd_rn(row(0, 0)[z], ux);
  float acc = acc0(zs);
  if (B == kOnePair) return add_pair(acc, __fmul_rn(tent(uy), tent(ux)), gathered(0, 0));

  float g00 = 0.0f;
  if (B == kNoSlice) g00 = gathered(0, 0);
  auto pair_g = [&](int cy, int cx) -> float {
    if (B == kFull) return gathered(cy, cx);
    if (B == kNoGather) {
      const float v = row(cy, cx)[z];
      return zmix(zs, v, v);
    }
    if (B == kStatic00) return gathered(0, 0);
    return g00;  // kNoSlice
  };

  float tx[kN], ty[kN];
  if (kTentsOnce) {
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      tx[c] = tent_at(ux, c);
      ty[c] = tent_at(uy, c);
    }
  }

  if (L == kPairLoop && kTile) {
    // Pair t reads row0[pr.row kLane + z0c, z1c or z], row0 the voxel's row
    // in slot 0; its tents take cx - K and cy - K from the table (exact).
    const float* row0 = smem + r * kLane;
    const float* q0 = row0 + zs.z0c;
    const float* q1 = row0 + zs.z1c;
    const float* qz = row0 + z;
#pragma unroll 1
    for (int t = 0; t < kN * kN; ++t) {
      const Pair& pr = kTilePairs.p[0][t];
      const int o = pr.row * kLane;
      float g;
      if (B == kFull) {
        g = zmix(zs, q0[o], q1[o]);
      } else if (B == kNoGather) {
        const float v = qz[o];
        g = zmix(zs, v, v);
      } else {
        g = pair_g(0, 0);  // static00, noslice: rows fixed at shift (0, 0)
      }
      const float w = __fmul_rn(tent(__fsub_rn(uy, pr.fy)), tent(__fsub_rn(ux, pr.fx)));
      acc = add_pair(acc, w, g);
    }
  } else if (L == kPairLoop) {
#pragma unroll 1
    for (int t = 0; t < kN * kN; ++t) {
      const int cy = t / kN, cx = t - cy * kN;
      acc = add_pair(acc, __fmul_rn(tent_at(uy, cy), tent_at(ux, cx)), pair_g(cy, cx));
    }
  } else if (L == kTwoLevel) {
#pragma unroll
    for (int cy = 0; cy < kN; ++cy) {
      const float wy = tent_at(uy, cy);
#pragma unroll 1
      for (int cx = 0; cx < kN; ++cx) {
        acc = add_pair(acc, __fmul_rn(wy, tent_at(ux, cx)), pair_g(cy, cx));
      }
    }
  } else if (L == kChunk) {
#pragma unroll 1
    for (int cy = 0; cy < kN; ++cy) {
      const float wy = tent_at(uy, cy);
#pragma unroll
      for (int cx = 0; cx < kN; ++cx) {
        const float wx = kTentsOnce ? tx[cx] : tent_at(ux, cx);
        acc = add_pair(acc, __fmul_rn(wy, wx), pair_g(cy, cx));
      }
    }
  } else {  // kUnroll
#pragma unroll
    for (int cy = 0; cy < kN; ++cy) {
#pragma unroll
      for (int cx = 0; cx < kN; ++cx) {
        const float wy = kTentsOnce ? ty[cy] : tent_at(uy, cy);
        const float wx = kTentsOnce ? tx[cx] : tent_at(ux, cx);
        acc = add_pair(acc, __fmul_rn(wy, wx), pair_g(cy, cx));
      }
    }
  }
  return acc;
}

// B5 on the ring, body full, tents once: the kVox voxels of rows r, r +
// kRowStep, ... of a step (their raw warps u) summed together, cy outer (a
// runtime loop for kChunk, static for kUnroll) and cx inner. Voxel k's row
// lies k kRowStep rows past voxel 0's, so a (cy, cx) row's offset serves
// all of them; each keeps its own acc, tents and z setup, and sums its
// pairs in the order of voxel(). The loads take 32-bit shared addresses,
// one IMAD or LEA each: with C++ indexing of the generic pointer the chunk
// runs 557.5 SASS a voxel against 422.5, 48.5-48.7 device us against
// 40.6-42.4 at 128^3 on the H100 (experiments/resample_variants_sweep.py,
// v7_generic; the unroll, whose offsets then fold into its loads, 39.2-39.4
// against 39.9-40.0).
template <int L, int kVox, int kRowStep>
__device__ __forceinline__ void voxels_together(const float* smem, int slot0, int r, int z,
                                                const float3 (&u)[kVox], float (&out)[kVox]) {
  ZSetup zs[kVox];
  float acc[kVox], uy[kVox], tx[kVox][kN];
#pragma unroll
  for (int k = 0; k < kVox; ++k) {
    zs[k] = z_setup(u[k].z, z);
    acc[k] = acc0(zs[k]);
    uy[k] = clamp_k(u[k].y);
    const float ux = clamp_k(u[k].x);
#pragma unroll
    for (int c = 0; c < kN; ++c) tx[k][c] = tent_at(ux, c);
  }
  int slot_off[kN];  // floats from slot 0 to x shift cx's slot
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    const int sl = slot0 + c;
    slot_off[c] = (sl >= kRingSlots ? sl - kRingSlots : sl) * kRingSlotF;
  }
  unsigned a0[kVox], a1[kVox];  // voxel k's z0c and z1c in its row of slot 0
#pragma unroll
  for (int k = 0; k < kVox; ++k) {
    const float* row = smem + (r + k * kRowStep) * kLane;
    a0[k] = (unsigned)__cvta_generic_to_shared(row + zs[k].z0c);
    a1[k] = (unsigned)__cvta_generic_to_shared(row + zs[k].z1c);
  }
  auto sum_cy = [&](int cy) {
    float wy[kVox];
#pragma unroll
    for (int k = 0; k < kVox; ++k) wy[k] = tent_at(uy[k], cy);
#pragma unroll
    for (int cx = 0; cx < kN; ++cx) {
      const unsigned o = (unsigned)(cy * kLane + slot_off[cx]) * (unsigned)sizeof(float);
#pragma unroll
      for (int k = 0; k < kVox; ++k) {
        acc[k] = add_pair(acc[k], __fmul_rn(wy[k], tx[k][cx]),
                          zmix(zs[k], ld_shared(a0[k] + o), ld_shared(a1[k] + o)));
      }
    }
  };
  if constexpr (L == kChunk) {
#pragma unroll 1
    for (int cy = 0; cy < kN; ++cy) sum_cy(cy);
  } else {
#pragma unroll
    for (int cy = 0; cy < kN; ++cy) sum_cy(cy);
  }
#pragma unroll
  for (int k = 0; k < kVox; ++k) out[k] = acc[k];
}

template <int L, int B, bool kTentsOnce>
__global__ void __launch_bounds__(kThreads) window_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int x0 = blockIdx.x * p.xc;
  const int xn = min(p.xc, p.nx - x0);
  const int rps = p.ty + kN - 1;  // staged y rows per slot
  const int z = threadIdx.x % kLane;
  const int r_first = threadIdx.x / kLane, r_step = blockDim.x / kLane;
  for (int t0 = 0; t0 < p.yb; t0 += p.ty) {
    const int y0 = blockIdx.y * p.yb + t0;
    for (int c = 0; c < kN; ++c) stage_row(p, smem + c * rps * kLane, x0 + c, y0, rps);
    cp_async_commit();
    for (int xi = 0; xi < xn; ++xi) {
      if (xi + 1 < xn) {  // the ring's next row, into the slot row xi - 1 used
        const int sl = (xi + kN) % p.slots;
        stage_row(p, smem + sl * rps * kLane, x0 + xi + kN, y0, rps);
      }
      cp_async_commit();  // possibly empty: one group per step
      cp_async_wait<1>();  // every group but this step's has landed
      __syncthreads();
      const int slot0 = xi % p.slots;
      for (int r = r_first; r < p.ty; r += r_step) {
        const int64_t v = ((int64_t)(x0 + xi) * p.ny + y0 + r) * kLane + z;
        const float ux = clamp_k(__ldg(p.warp + 3 * v));
        const float uy = clamp_k(__ldg(p.warp + 3 * v + 1));
        const ZSetup zs = z_setup(__ldg(p.warp + 3 * v + 2), z);
        p.out[v] = voxel<L, B, kTentsOnce>(smem, slot0, p.slots, rps, r, z, ux, uy, zs);
      }
      __syncthreads();  // slot xi is refilled at the next step
    }
  }
}

template <int L, int B>
__global__ void __launch_bounds__(kThreads, 2) tile_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int x = blockIdx.x;
  const int y_begin = blockIdx.y * kCtaRows;
  const int tiles = min(kCtaRows, p.ny - y_begin) / kTileRows;
  const int z = threadIdx.x % kLane, r_first = threadIdx.x / kLane;
  auto stage_tile = [&](int k) {
    float* buf = smem + (k & 1) * kTileFloats;
    for (int c = 0; c < kN; ++c) {
      stage_row(p, buf + c * kTileStage * kLane, x + c, y_begin + k * kTileRows, kTileStage);
    }
  };
  // A thread's voxels, in order: rows r_first, r_first + 4 of each tile. It
  // loads the next one's warp before it sums the current one, so that no
  // warp waits for memory after the tile's barrier.
  constexpr int kRowStep = kThreads / kLane;
  auto voxel_at = [&](int k, int r) {
    return ((int64_t)x * p.ny + y_begin + k * kTileRows + r) * kLane + z;
  };
  auto warp_at = [&](int64_t w) {
    return make_float3(__ldg(p.warp + 3 * w), __ldg(p.warp + 3 * w + 1), __ldg(p.warp + 3 * w + 2));
  };
  int64_t v = voxel_at(0, r_first);
  float3 u = warp_at(v);
  stage_tile(0);
  cp_async_commit();
  for (int k = 0; k < tiles; ++k) {
    if (k + 1 < tiles) stage_tile(k + 1);  // into the buffer tile k - 1 used
    cp_async_commit();    // possibly empty: one group per tile
    cp_async_wait<1>();  // every group but this tile's has landed
    __syncthreads();
    const float* buf = smem + (k & 1) * kTileFloats;
    for (int r = r_first; r < kTileRows; r += kRowStep) {
      const bool tile_end = r + kRowStep >= kTileRows;
      const int64_t v_next = tile_end ? voxel_at(k + 1, r_first) : v + kRowStep * kLane;
      const float3 u_next = !tile_end || k + 1 < tiles ? warp_at(v_next) : u;
      const ZSetup zs = z_setup(u.z, z);
      p.out[v] = voxel<L, B, false, true>(buf, 0, kN, kTileStage, r, z, clamp_k(u.x),
                                          clamp_k(u.y), zs);
      u = u_next;
      v = v_next;
    }
    __syncthreads();  // the buffer is refilled at the next tile
  }
}

// B4 (kTentsOnce false: loop fori, chunk or unroll) and B5 (true: chunk or
// unroll), body full. The grid splits the (y tile, x row) steps, x fastest,
// into equal ranges, one a CTA.
template <int L, bool kTentsOnce>
__global__ void __launch_bounds__(kThreads, kRingCtas<L>) ring_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kRowStep = kThreads / kLane;  // y rows a thread's voxels step by
  constexpr int kVox = kRingTY / kRowStep;    // voxels a thread a step
  constexpr int kVoxStep = kRowStep * kLane;  // floats from one of them to the next
  constexpr bool kPaired = kTentsOnce && kRingPaired<L>;
  const int z = threadIdx.x % kLane, r_first = threadIdx.x / kLane;
  // 32-bit step counters (the entry's shape rule): fori fits its 32
  // registers without spilling.
  const int steps = p.nx * (p.ny / kRingTY);
  const int end = (int)((int64_t)(blockIdx.x + 1) * steps / gridDim.x);
  const int64_t row_step = (int64_t)p.ny * kLane;  // voxels from one x row to the next
  auto warp_at = [&](int64_t w) {
    return make_float3(__ldg(p.warp + 3 * w), __ldg(p.warp + 3 * w + 1), __ldg(p.warp + 3 * w + 2));
  };
  for (int f = (int)((int64_t)blockIdx.x * steps / gridDim.x); f < end;) {
    const int y0 = f / p.nx * kRingTY, x0 = f % p.nx;
    const int xn = min(p.nx - x0, end - f);
    f += xn;
    // A thread's voxels, in order: rows r_first, r_first + kRowStep, ... of
    // each x row.
    int64_t v = ((int64_t)x0 * p.ny + y0 + r_first) * kLane + z;
    float3 u = warp_at(v);
    float3 us[kVox];  // kPaired: the warps of the thread's voxels of the step
    if constexpr (kPaired) {
      us[0] = u;
#pragma unroll
      for (int k = 1; k < kVox; ++k) us[k] = warp_at(v + k * kVoxStep);
    }
    for (int c = 0; c < kN; ++c) stage_row(p, smem + c * kRingSlotF, x0 + c, y0, kRingRows);
    cp_async_commit();
    for (int xi = 0, slot0 = 0; xi < xn; ++xi, slot0 = slot0 + 1 == kRingSlots ? 0 : slot0 + 1) {
      if (xi + 1 < xn) {  // the ring's next row, into the slot row xi - 1 used
        const int next = slot0 + kN >= kRingSlots ? slot0 + kN - kRingSlots : slot0 + kN;
        stage_row(p, smem + next * kRingSlotF, x0 + xi + kN, y0, kRingRows);
      }
      cp_async_commit();    // possibly empty: one group per step
      cp_async_wait<1>();  // every group but this step's has landed
      __syncthreads();
      if constexpr (kPaired) {  // the next x row's warps first, then the sums
        float3 next[kVox];
        float out[kVox];
#pragma unroll
        for (int k = 0; k < kVox; ++k) {
          next[k] = xi + 1 < xn ? warp_at(v + row_step + k * kVoxStep) : us[k];
        }
        voxels_together<L, kVox, kRowStep>(smem, slot0, r_first, z, us, out);
#pragma unroll
        for (int k = 0; k < kVox; ++k) {
          p.out[v + k * kVoxStep] = out[k];
          us[k] = next[k];
        }
        v += row_step;
      } else {
#pragma unroll 1
        for (int k = 0; k < kVox; ++k) {
          const int r = r_first + k * kRowStep;
          const bool last = k + 1 == kVox;
          const int64_t v_next = last ? v + row_step - (kVox - 1) * kRowStep * kLane
                                      : v + kRowStep * kLane;
          const float3 u_next = !last || xi + 1 < xn ? warp_at(v_next) : u;
          const ZSetup zs = z_setup(u.z, z);
          const float ux = clamp_k(u.x), uy = clamp_k(u.y);
          if constexpr (kTentsOnce) {  // B5, one voxel at a time
            const float3 uk[1] = {u};
            float out[1];
            voxels_together<L, 1, kRowStep>(smem, slot0, r, z, uk, out);
            p.out[v] = out[0];
          } else if constexpr (L == kPairLoop) {  // a staged row is kLane floats
            const float* row0 = smem + r * kLane;
            p.out[v] = pair_sum<kLane * (int)sizeof(float), true>(
                acc0(zs), kRingPairs.p[slot0], (unsigned)__cvta_generic_to_shared(row0 + zs.z0c),
                (unsigned)__cvta_generic_to_shared(row0 + zs.z1c), ux, uy, zs);
          } else {
            p.out[v] = voxel<L, kFull, false>(smem, slot0, kRingSlots, kRingRows, r, z, ux, uy, zs);
          }
          u = u_next;
          v = v_next;
        }
      }
      __syncthreads();  // slot xi is refilled at the next step (or the next range's start)
    }
  }
}

template <int L, bool kTentsOnce>
int launch_ring(const Params& p, cudaStream_t stream) {
  static lsf_occ::WaveCache cache;
  const int wave =
      lsf_occ::wave((const void*)ring_kernel<L, kTentsOnce>, kThreads, kRingSmem, cache);
  if (wave < 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const int64_t steps = (int64_t)p.nx * (p.ny / kRingTY);
  ring_kernel<L, kTentsOnce>
      <<<(unsigned)std::min<int64_t>(wave, steps), kThreads, kRingSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int L, int B>
int launch_tiled(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute((const void*)tile_kernel<L, B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.nx, (p.ny + kCtaRows - 1) / kCtaRows);
  tile_kernel<L, B><<<grid, kThreads, kTileSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int L, int B, bool kTentsOnce>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = p.slots * (p.ty + kN - 1) * kLane * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute((const void*)window_kernel<L, B, kTentsOnce>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.nx + p.xc - 1) / p.xc, p.ny / p.yb);
  window_kernel<L, B, kTentsOnce><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int L_, int B_>
struct Variant {
  static constexpr int L = L_, B = B_;
};

// launch(Variant<L, B>{}) for the loop and body codes of a window or tile
// launch without B5's tents.
template <class F>
int with_variant(int loop, int body, F&& launch) {
  switch (body) {
    case kPassthrough: return launch(Variant<kPairLoop, kPassthrough>{});
    case kOnePair: return launch(Variant<kPairLoop, kOnePair>{});
    case kStatic00:
      return loop == kPairLoop ? launch(Variant<kPairLoop, kStatic00>{})
                               : (int)cudaErrorInvalidValue;
    case kNoSlice:
      return loop == kPairLoop ? launch(Variant<kPairLoop, kNoSlice>{})
                               : (int)cudaErrorInvalidValue;
    case kNoGather:
      return loop == kPairLoop ? launch(Variant<kPairLoop, kNoGather>{})
                               : (int)cudaErrorInvalidValue;
    case kFull:
      switch (loop) {
        case kPairLoop: return launch(Variant<kPairLoop, kFull>{});
        case kTwoLevel: return launch(Variant<kTwoLevel, kFull>{});
        case kChunk: return launch(Variant<kChunk, kFull>{});
        case kUnroll: return launch(Variant<kUnroll, kFull>{});
      }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// loop: 0 pair loop, 1 two-level, 2 chunk, 3 unroll; body: 0 full,
// 1 static00, 2 noslice, 3 nogather, 4 passthrough, 5 onepair (loop ignored
// for 4 and 5); tents_once: B5's tent registers (chunk and unroll only).
// Shape rules (else cudaErrorInvalidValue): nz 128, yb divides ny, ty
// divides yb, the staged rows fit shared memory, field 16-byte aligned.
extern "C" int lsf_resample_variant(const float* field, const float* warp, float* out,
                                    int nx, int ny, int nz, int loop, int body,
                                    int tents_once, int yb, int ty, int xc,
                                    void* stream) {
  const int slots = xc > 1 ? kN + 1 : kN;
  if (nz != kLane || nx < 1 || yb < 1 || ty < 1 || xc < 1 || ny % yb != 0 ||
      yb % ty != 0 || slots * (ty + kN - 1) * kLane * (int)sizeof(float) > kMaxSmem ||
      (uintptr_t)field % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{field, warp, out, nx, ny, yb, ty, xc, slots};
  const cudaStream_t s = (cudaStream_t)stream;
  if (tents_once) {
    if (body != kFull) return (int)cudaErrorInvalidValue;
    if (loop == kChunk) return launch<kChunk, kFull, true>(p, s);
    if (loop == kUnroll) return launch<kUnroll, kFull, true>(p, s);
    return (int)cudaErrorInvalidValue;
  }
  return with_variant(loop, body, [&](auto v) {
    return launch<decltype(v)::L, decltype(v)::B, false>(p, s);
  });
}

// B3 on its compile-time geometry (tile_kernel): loop and body as above.
// Shape rules (else cudaErrorInvalidValue): nz 128, nx >= 1, ny a positive
// multiple of kTileRows (8), field 16-byte aligned.
extern "C" int lsf_resample_variant_tiled(const float* field, const float* warp, float* out,
                                          int nx, int ny, int nz, int loop, int body,
                                          void* stream) {
  if (nz != kLane || nx < 1 || ny < kTileRows || ny % kTileRows != 0 ||
      (ny + kCtaRows - 1) / kCtaRows > 65535 || (uintptr_t)field % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{field, warp, out, nx, ny, kCtaRows, kTileRows, 1, kN};
  const cudaStream_t s = (cudaStream_t)stream;
  return with_variant(loop, body, [&](auto v) {
    return launch_tiled<decltype(v)::L, decltype(v)::B>(p, s);
  });
}

// B4 and B5 on the compile-time ring (ring_kernel): body 0 (full); B4
// (tents_once 0) loop 0 (fori), 2 (chunk) or 3 (unroll), B5 (tents_once 1)
// loop 2 or 3. Shape rules (else cudaErrorInvalidValue): nz 128, nx >= 1,
// ny a positive multiple of kRingTY (8), nx ny / 8 < 2^31, field 16-byte
// aligned.
extern "C" int lsf_resample_variant_ring(const float* field, const float* warp, float* out,
                                         int nx, int ny, int nz, int loop, int body,
                                         int tents_once, void* stream) {
  if (nz != kLane || nx < 1 || ny < kRingTY || ny % kRingTY != 0 || body != kFull ||
      (int64_t)nx * (ny / kRingTY) > INT32_MAX || (uintptr_t)field % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{field, warp, out, nx, ny, kRingTY, kRingTY, 1, kRingSlots};
  const cudaStream_t s = (cudaStream_t)stream;
  if (tents_once) {
    if (loop == kChunk) return launch_ring<kChunk, true>(p, s);
    if (loop == kUnroll) return launch_ring<kUnroll, true>(p, s);
    return (int)cudaErrorInvalidValue;
  }
  switch (loop) {
    case kPairLoop: return launch_ring<kPairLoop, false>(p, s);
    case kChunk: return launch_ring<kChunk, false>(p, s);
    case kUnroll: return launch_ring<kUnroll, false>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* lsf_resample_variants_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
