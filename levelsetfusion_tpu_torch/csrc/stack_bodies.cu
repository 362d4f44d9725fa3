// The cost-bisection bodies of the shift-enumeration resample, read from a
// stack that is already materialised: stacked[cy, px, y, z], N = 2K + 2 = 6
// planes, px the x row of the +1-padded field (XP >= X + N - 1 rows), with a
// channel-last warp (X, Y, 128, 3); the output is (X, Y, 128). With
// z0 = z + floor(uz), z0c and z1c = z0 and z0 + 1 clipped to [0, 128), and
// R = stacked[cy, x + cx, y], each body sums over the 36 pairs
// t = 6 cy + cx, cy outer:
//
//   nothing   acc + 1                      (B9)
//   slice     acc + R[z]                   (B9)
//   slice0    acc + stacked[0, x, y, z]    (B9)
//   gather    acc + stacked[0, x, y, z0c]  (B9)
//   full      acc + (0.5 R[z0c] + 0.25 R[z1c])          (B9; B8 level 0)
//   zsetup    full with w0, w1 = 1 - frac(uz), frac(uz), each 0 where its z
//             index is outside                           (B8 level 1)
//   tents     acc + tent(uy - (cy - K)) tent(ux - (cx - K)) (w0 R[z0c] + w1 R[z1c])
//                                                        (B8 level 2)
//   acc0      tents, summed from acc0 = 1 - w0 - w1 (the +1 fill) (level 3)
//   clampin   acc0 with ux, uy clamped to ±K                (level 4)
//   v8        clampin, the 12 tent values computed once into a table (B7)
//   v8c       the 36 weight products once into a table, summed from 0, the
//             fill added after the loop                   (B7)
//
// Replaces three TPU kernels, each a grid of (Y / yb, X) steps over the whole
// (N, XP, yb, 128) block resident in VMEM:
// - experiments/loop_cost.py::run (B9, line 79; _make_kernel(body, loop)):
//   the first five bodies under a runtime pair loop (fori) or a static
//   unroll of the 36 pairs;
// - experiments/bisect_kernel.py::run (B8, line 196; _make_kernel(level)):
//   levels 0-4, fori;
// - experiments/bisect_kernel.py::run_v8 (B7, line 163; _kernel_v8,
//   _kernel_v8c), fori.
// On a stack made from a field (the padded field's y-shifted copies), levels
// 4, v8 and v8c are the golden resample on the clamped warp. B8 and B9 time
// them on a random stack, whose planes are independent: the kernel reads
// plane cy at row y, never plane 0 at row y + cy.
//
// Design: a ring of staged x rows, as csrc/resample_variants.cu's B4, with
// the stack's rows staged instead of the field's. Both kernels share one
// frame: the grid splits the (y tile, x row) steps, x fastest, into equal
// ranges, one a CTA, one wave of CTAs on the current device (occupancy.cuh).
// A CTA walks its range's x rows through a ring of N + 1 slots, each holding
// the N planes' TY rows of one padded x row, staged with cp.async, the next
// row in flight while the current row's sums run (one commit group per
// step); it restarts the ring where its range enters a new tile, and a
// thread loads its next x row's warp before the step's barrier. A range
// stages each of its rows once, so at 128^3 the staged stack is 68.0 MB
// against the 52.3 MB the function uses (B9's first frame, 8-x-row CTAs,
// staged 13 rows for 8 outputs, 81.8 MB, in 1.94 waves).
//
// B9 (loop_kernel<body, loop, TY, V>, loops fori and static): tiles of
// kLoopTY = 4 y rows, V = 2 voxels a thread (rows r and r + 2 of the tile:
// 256 threads), the 86 KB ring: two CTAs (16 warps) an SM, 128 registers a
// thread. A thread's two voxels lie one plane row apart in every slot, so
// each pair's row offset serves both, and each voxel keeps its own
// accumulator chain in t order (the sum stays exact). Each voxel's loads
// take 32-bit shared addresses, a0 and a1 (z0c's and z1c's, or z's) in slot
// 0, so that pair t's two loads are ld_shared(a + off):
// - fori, a runtime loop of 36 trips, one pair a trip for both voxels:
//   pair t's off is kRingPairs' row for the step's start slot (one LDC a
//   trip, not t / N and the ring's wrap), 4 LDS a trip;
// - static, the 36 pairs unrolled: pair (cy, cx)'s loads take the register
//   a + slot_b[cx] (slot cx's offset for the step, 12 such registers a
//   voxel) and the immediate cy TY 512 B, so each of the 72 loads a voxel is
//   a register plus an immediate.
// slice0 and gather read row (0, 0) every pair, at an address fixed for the
// step; nothing reads no row, and only gather and full read the warp (uz).
// kLoopTY divides the entry's Y rule, so every Y it takes has whole tiles.
// The arithmetic is resample_z.cuh's, in the float steps of the JAX bodies,
// so each body equals its plain torch version bit for bit. On the H100 at 128^3 (experiments/loop_cost_sweep.py, device us,
// full fori / static): this design 66.2 / 39.9 (403 / 245.5 SASS a voxel,
// 56 / 86 registers); one voxel a thread (32 warps an SM) 66.6-66.7 / 43.7;
// 2-row tiles (five CTAs, 20 warps) 64.8 / 40.5; two rows in flight (an
// 8-slot ring) 69.2-69.4 / 40.9-41.0. B9's first frame took 91.4-91.7 /
// 61.3-61.4 us of CUDA-event time against this design's 71.1 / 43.5-44.0.
//
// B8's levels and B7 (table_kernel, loop frame) run on the same frame, one
// voxel a thread. The pair loop stays one runtime step a pair in t order: it
// reads pair t's ring row (and its shifts, or v8's cy, cx) from a table in
// constant memory (resample_z.cuh's Pair), not t / N and the ring's wrap, so
// an address is a multiply-add from the voxel's z0c or z1c row, and it
// issues pair t + 1's loads before pair t's sum (v8, v8c). The levels run
// resample_z.cuh's pair_sum, levels 2-4 computing each pair's tents in the
// loop, from the shifts; their tiles are kLevelTY = 4 y rows (512 threads,
// the 86 KB ring: two CTAs, 32 warps an SM), which times faster than 2 or 1
// (40 warps), and the loop loads pair t's values in the step that sums it,
// which times faster than loading them a step ahead
// (experiments/stack_bodies_sweep.py).
//
// v8 and v8c keep the TPU's VMEM scratch planes as a table in shared memory
// after the ring, laid out [entry][thread], so that a warp's read of an
// entry is one conflict-free wavefront. v8's 12 tent values take 24 KB
// beside the 86 KB ring (TY = 4: two CTAs, 32 warps an SM). v8c's 36
// products (and a copy of the first) take 148 B a voxel, which with the
// ring's 168 B leaves room for at most ~23 warps an SM; its tiles are 1 y
// row (128 threads, 40 KB: five CTAs, 20 warps), which times faster than
// TY = 4 or 2 (16 warps) and than a table in local memory kept in L1
// (experiments/stack_bodies_sweep.py).
//
// What bounds it on the H100: bytes. At 128^3 the function reads the 52 MB
// of stack rows it uses and the 25 MB warp once and writes 8 MB, 86 MB or
// 25.6 us at 3.35 TB/s; even the arithmetic this design spends (145 to 513
// float operations per voxel, 5-16 us at 67 TFLOP/s) is below that. B9's
// own floor is the shared-memory pipe: full makes 72 four-byte loads a voxel
// at scattered z0c and z1c, and on the script's warp (loop_cost.inputs,
// 1.5 N(0, 1)) a warp's load takes 1.444 wavefronts on average
// (loop_cost.shared_wavefronts: 55.6% of loads one, 44.4% two), so 65,536
// warps x 72 x 1.444 = 6.81M wavefronts, 51.6k cycles an SM at one a cycle:
// 26.1 us at 1.98 GHz (29.4 at 1.755), about the byte bound. The frame alone
// (body nothing: the ring's 68.0 MB in, 8.4 MB out) takes 23.2-24.9 us;
// static takes 39.9, 1.5x the shared pipe's floor, adding 16.7 to the frame
// alone. Fori's trip is 22 SASS for two voxels, the LDC, address IMADs,
// LDS, FMUL and FADDs in one dependent chain, and fori adds 41.3 us over the
// frame: at 1.98 GHz about 146 cycles for each 8 voxel-pairs a warp
// scheduler sums (its 4 warps' trips), and the same with 8 warps of one
// voxel, so neither ILP nor warps hide the chain.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "cp_async.cuh"
#include "occupancy.cuh"
#include "resample_z.cuh"

namespace {

using namespace lsf_cp;
using namespace lsf_rz;

enum Loop { kFori = 0, kStatic = 1, kFrame = 2 };
enum Body {
  kNothing = 0, kSlice = 1, kSlice0 = 2, kGather = 3, kFull = 4,
  kZSetup = 5, kTents = 6, kAcc0 = 7, kClampIn = 8, kV8 = 9, kV8c = 10,
};

constexpr int kYRule = 4;  // the entry's Y must be a multiple (every tile divides it)
constexpr int kSlots = kN + 1;
constexpr int kPairs = kN * kN;

struct Params {
  const float* stack;  // (kN, xp, ny, 128)
  const float* warp;   // (nx, ny, 128, 3)
  float* out;          // (nx, ny, 128)
  int xp, nx, ny;
};

// Stage padded x row px, y rows [y0, y0 + TY) of every plane, into `slot`
// (plane c at rows [c TY, (c + 1) TY)): a cp.async per 16 bytes, spread over
// the CTA's kThreadsS threads.
template <int TY, int kThreadsS = TY * kLane>
__device__ __forceinline__ void stage(const Params& p, float* slot, int px, int y0) {
  constexpr int kPerPlane = TY * kLane / 4;
  for (int q = threadIdx.x; q < kN * kPerPlane; q += kThreadsS) {
    const int c = q / kPerPlane, e = q - c * kPerPlane;
    cp_async16(slot + c * TY * kLane + 4 * e,
               p.stack + (((int64_t)c * p.xp + px) * p.ny + y0) * kLane + 4 * e);
  }
}

// The z setup of the timing bodies and level 0: the gathered indices from
// uz, constant weights.
__device__ __forceinline__ ZSetup z_setup_const(float uz, int z) {
  const int z0 = z + (int)floorf(uz);
  ZSetup s;
  s.z0c = min(max(z0, 0), kLane - 1);
  s.z1c = min(max(z0 + 1, 0), kLane - 1);
  s.w0 = 0.5f;
  s.w1 = 0.25f;
  return s;
}

// table_kernel: the weight table's entries (v8 and v8c only), the tile's y
// rows, and the CTA's shared bytes (the ring, then the table) and threads.
template <int B>
constexpr int kEntries = B == kV8 ? 2 * kN : B == kV8c ? kPairs + 1 : 0;  // v8c: wt[36] = wt[0]
constexpr int kLevelTY = 4;
constexpr int kV8TY = 4;
constexpr int kV8cTY = 1;
template <int B, int TY>
struct TableGeom {
  static constexpr int kThreadsT = TY * kLane;
  static constexpr int kSlotF = kN * TY * kLane;
  static constexpr int kRingF = kSlots * kSlotF;
  static constexpr int kSmemB = (kRingF + kEntries<B> * kThreadsT) * (int)sizeof(float);
  // CTAs an SM holds: 228 KB of shared memory, 1 KB reserved a CTA, and
  // 2048 threads (the launch bounds cap the registers to match).
  static constexpr int kCtasPerSm = std::min(233472 / (kSmemB + 1024), 2048 / kThreadsT);
};

// Pair t's ring row from start slot s0: slot (s0 + cx) mod kSlots, plane cy,
// in units of a plane's TY rows (resample_z.cuh).
__constant__ PairTable<kSlots> kRingPairs = pair_table<kSlots>(kSlots, kN);

// One voxel of a level (B8, kFull to kClampIn), v8 or v8c at the warp u.
// `rows` is the voxel's row (row r of plane 0) in slot 0 of the ring, `tab`
// its column of the weight table (entry e at tab[e * TY 128]); slot
// (slot0 + cx) mod kSlots holds padded x row x + cx.
template <int B, int TY>
__device__ __forceinline__ float table_voxel(const float* rows, float* tab, int slot0, int z,
                                             float3 u) {
  constexpr int kUnit = TY * kLane;        // floats of a plane's rows in a slot
  constexpr int kTabStride = TY * kLane;  // floats between two entries of a thread
  const ZSetup zs = B >= kZSetup ? z_setup(u.z, z) : z_setup_const(u.z, z);
  const float ux = B >= kClampIn ? clamp_k(u.x) : u.x, uy = B >= kClampIn ? clamp_k(u.y) : u.y;
  if constexpr (B >= kV8) {
    float tx[kN], ty[kN];
#pragma unroll
    for (int c = 0; c < kN; ++c) tx[c] = tent_at(ux, c), ty[c] = tent_at(uy, c);
    if constexpr (B == kV8) {  // ty[0..N) then tx[0..N)
#pragma unroll
      for (int c = 0; c < kN; ++c) tab[c * kTabStride] = ty[c], tab[(kN + c) * kTabStride] = tx[c];
    } else {  // wt[t] = ty[cy] tx[cx], and wt[36] = wt[0] for the loop's last prefetch
#pragma unroll
      for (int t = 0; t <= kPairs; ++t) {
        tab[t * kTabStride] = __fmul_rn(ty[t % kPairs / kN], tx[t % kN]);
      }
    }
  }
  const float* q0 = rows + zs.z0c;
  const float* q1 = rows + zs.z1c;
  const Pair* pairs = kRingPairs.p[slot0];
  if constexpr (B < kV8) {
    // The levels: resample_z.cuh's pair loop, levels 2-4 computing each
    // pair's tents from its shifts, levels 0 and 1 summing unweighted.
    return pair_sum<kUnit * (int)sizeof(float), (B >= kTents)>(
        B >= kAcc0 ? acc0(zs) : 0.0f, pairs, (unsigned)__cvta_generic_to_shared(q0),
        (unsigned)__cvta_generic_to_shared(q1), ux, uy, zs);
  }
  // v8's weight is ty[cy] tx[cx], v8c's wt[t]; pair t's rows come from the
  // table of pairs.
  auto weight = [&](int t) {
    return B == kV8 ? __fmul_rn(tab[pairs[t].cy * kTabStride], tab[(kN + pairs[t].cx) * kTabStride])
                    : tab[t * kTabStride];
  };
  float acc = B == kV8 ? acc0(zs) : 0.0f;  // v8c adds the fill after the loop
  // Pair t + 1's loads are issued before pair t's sum (the table's pair 36
  // is a copy of pair 0, as is v8c's wt[36]).
  float w = weight(0), r0 = q0[pairs[0].row * kUnit], r1 = q1[pairs[0].row * kUnit];
#pragma unroll 1
  for (int t = 0; t < kPairs; ++t) {
    const float wn = weight(t + 1);
    const float r0n = q0[pairs[t + 1].row * kUnit], r1n = q1[pairs[t + 1].row * kUnit];
    acc = add_pair(acc, w, zmix(zs, r0, r1));
    w = wn, r0 = r0n, r1 = r1n;
  }
  return B == kV8c ? __fadd_rn(acc, acc0(zs)) : acc;
}

// The grid splits the (y tile, x row) steps, x fastest, into equal ranges,
// one a CTA, one wave on the current device. A CTA walks its range's x rows
// of TY y rows, one voxel of each a thread, through the ring, restarting the
// ring where the range enters a new tile; its table follows the ring in
// shared memory. A thread loads the next x
// row's warp before it sums the current row, so that no warp waits for
// memory after the step's barrier.
template <int B, int TY>
__global__ void __launch_bounds__(TableGeom<B, TY>::kThreadsT, TableGeom<B, TY>::kCtasPerSm)
    table_kernel(Params p) {
  using G = TableGeom<B, TY>;
  extern __shared__ __align__(16) float smem[];
  const int z = threadIdx.x % kLane, r = threadIdx.x / kLane;
  float* const tab = smem + G::kRingF + threadIdx.x;
  const int64_t steps = (int64_t)p.nx * (p.ny / TY);
  const int64_t end = (blockIdx.x + 1) * steps / gridDim.x;
  const int64_t row_step = (int64_t)p.ny * kLane;  // voxels from one x row to the next
  auto warp_at = [&](int64_t w) {
    return make_float3(__ldg(p.warp + 3 * w), __ldg(p.warp + 3 * w + 1), __ldg(p.warp + 3 * w + 2));
  };
  for (int64_t f = blockIdx.x * steps / gridDim.x; f < end;) {
    const int y0 = (int)(f / p.nx) * TY, x0 = (int)(f % p.nx);
    const int xn = (int)min((int64_t)(p.nx - x0), end - f);
    f += xn;
    int64_t v = ((int64_t)x0 * p.ny + y0 + r) * kLane + z;
    float3 u = warp_at(v);
    for (int c = 0; c < kN; ++c) stage<TY>(p, smem + c * G::kSlotF, x0 + c, y0);
    cp_async_commit();
    for (int xi = 0, slot0 = 0; xi < xn; ++xi, slot0 = slot0 + 1 == kSlots ? 0 : slot0 + 1) {
      if (xi + 1 < xn) {  // the ring's next row, into the slot row xi - 1 used
        const int next = slot0 + kN >= kSlots ? slot0 + kN - kSlots : slot0 + kN;
        stage<TY>(p, smem + next * G::kSlotF, x0 + xi + kN, y0);
      }
      cp_async_commit();    // possibly empty: one group per step
      cp_async_wait<1>();  // every group but this step's has landed
      __syncthreads();
      const float3 u_next = xi + 1 < xn ? warp_at(v + row_step) : u;
      p.out[v] = table_voxel<B, TY>(smem + r * kLane, tab, slot0, z, u);
      u = u_next;
      v += row_step;
      __syncthreads();  // slot xi is refilled at the next step (or the next range's start)
    }
  }
}

template <int B, int TY>
int launch_table(const Params& p, cudaStream_t stream) {
  using G = TableGeom<B, TY>;
  static lsf_occ::WaveCache cache;
  if (p.ny % TY != 0) return (int)cudaErrorInvalidValue;
  const int wave = lsf_occ::wave((const void*)table_kernel<B, TY>, G::kThreadsT, G::kSmemB, cache);
  if (wave < 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const int64_t steps = (int64_t)p.nx * (p.ny / TY);
  table_kernel<B, TY><<<(unsigned)std::min<int64_t>(wave, steps), G::kThreadsT, G::kSmemB,
                        stream>>>(p);
  return (int)cudaGetLastError();
}

// B9's tiles (loop_kernel): kLoopTY y rows, kLoopV voxels a thread (rows r,
// r + kLoopTY / kLoopV, ...); kLoopAhead x rows are in flight while a step
// sums, in a ring of kN + kLoopAhead slots.
constexpr int kLoopTY = 4;
constexpr int kLoopV = 2;
constexpr int kLoopAhead = 1;
constexpr int kLoopSlots = kN + kLoopAhead;
static_assert(kYRule % kLoopTY == 0 && kLoopTY % kLoopV == 0,
              "the tile must divide every Y the entry takes, a thread's voxels the tile");
template <int TY, int V>
struct LoopGeom {
  static constexpr int kThreadsL = TY * kLane / V;
  static constexpr int kSlotF = kN * TY * kLane;
  static constexpr int kSmemB = kLoopSlots * kSlotF * (int)sizeof(float);
  // CTAs an SM holds: 228 KB of shared memory, 1 KB reserved a CTA, and
  // 2048 threads (the launch bounds cap the registers to match).
  static constexpr int kCtasPerSm = std::min(233472 / (kSmemB + 1024), 2048 / kThreadsL);
};

// The float at byte a + kOff of this CTA's shared memory window: kOff is an
// immediate of the load.
template <unsigned kOff>
__device__ __forceinline__ float ld_shared_at(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1+%2];" : "=f"(v) : "r"(a), "n"(kOff));
  return v;
}

// f(std::integral_constant<int, t>) for t = T, T + 1, ..., kPairs - 1: the
// static pairs, each with its t a compile-time constant.
template <int T, class F>
__device__ __forceinline__ void each_pair(F&& f) {
  if constexpr (T < kPairs) {
    f(std::integral_constant<int, T>{});
    each_pair<T + 1>(f);
  }
}

// B9's V voxels of a thread at one x row: voxel k lies k TY / V rows past
// row0 (the shared address of the thread's row r of plane 0 in slot 0), at
// z with uz[k]; slot (slot0 + cx) mod kLoopSlots holds padded x row x + cx.
// Each voxel sums its 36 pairs in t order (cy outer) into its own
// accumulator; pair t's loads of all V voxels take one offset from their
// slot-0 addresses.
template <int B, int L, int TY, int V>
__device__ __forceinline__ void loop_voxels(unsigned row0, int slot0, int z,
                                            const float (&uz)[V], float (&out)[V]) {
  static_assert(B <= kFull, "loop_kernel runs B9's bodies");
  constexpr unsigned kUnitB = TY * kLane * sizeof(float);  // a plane's TY rows in a slot
  constexpr unsigned kSlotB = kN * kUnitB;
  constexpr unsigned kVoxB = TY / V * kLane * sizeof(float);
  constexpr bool kPairRows = B == kSlice || B == kFull;  // pair t's row, else row (0, 0)'s
  ZSetup zs[V];
  unsigned a0[V], a1[V];
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const unsigned row = row0 + k * kVoxB + (kPairRows ? 0u : (unsigned)slot0 * kSlotB);
    if constexpr (B >= kGather) {
      zs[k] = z_setup_const(uz[k], z);
      a0[k] = row + zs[k].z0c * (unsigned)sizeof(float);
      a1[k] = row + zs[k].z1c * (unsigned)sizeof(float);
    } else {
      a0[k] = a1[k] = row + z * (unsigned)sizeof(float);
    }
    acc[k] = 0.0f;
  }
  // Pair t's value for voxel k: `load(a)` reads the float at a plus the
  // pair's offset.
  auto add = [&](int k, auto load) {
    if constexpr (B == kNothing) {
      acc[k] = __fadd_rn(acc[k], 1.0f);
    } else if constexpr (B == kFull) {
      acc[k] = __fadd_rn(acc[k], zmix(zs[k], load(a0[k]), load(a1[k])));
    } else {
      acc[k] = __fadd_rn(acc[k], load(a0[k]));
    }
  };
  if constexpr (L == kFori) {
    static_assert(kLoopSlots == kSlots, "B9's ring reads table_kernel's kRingPairs");
    const Pair* pairs = kRingPairs.p[slot0];
#pragma unroll 1
    for (int t = 0; t < kPairs; ++t) {
      const unsigned off = kPairRows ? (unsigned)pairs[t].row * kUnitB : 0u;
#pragma unroll
      for (int k = 0; k < V; ++k) add(k, [&](unsigned a) { return ld_shared(a + off); });
    }
  } else {
    unsigned slot_b[kN];  // bytes from slot 0 to x shift cx's slot
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      const int sl = slot0 + c;
      slot_b[c] = (unsigned)(sl >= kLoopSlots ? sl - kLoopSlots : sl) * kSlotB;
    }
    // Pair (cy, cx) loads from register a + slot_b[cx] at the immediate cy
    // kUnitB (slice0, gather: from a itself).
    each_pair<0>([&](auto t) {
      constexpr int cy = decltype(t)::value / kN, cx = decltype(t)::value % kN;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        add(k, [&](unsigned a) {
          return kPairRows ? ld_shared_at<cy * kUnitB>(a + slot_b[cx]) : ld_shared_at<0>(a);
        });
      }
    });
  }
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = acc[k];
}

// B9 on the frame of table_kernel: equal ranges of (y tile, x row) steps,
// one wave; a thread sums V voxels of each x row and loads their next x
// row's uz before the sums (gather and full; the other bodies read no warp).
template <int B, int L, int TY, int V>
__global__ void __launch_bounds__(LoopGeom<TY, V>::kThreadsL, LoopGeom<TY, V>::kCtasPerSm)
    loop_kernel(Params p) {
  using G = LoopGeom<TY, V>;
  constexpr int kVoxStep = TY / V * kLane;  // voxels from one of a thread's voxels to the next
  extern __shared__ __align__(16) float smem[];
  const int z = threadIdx.x % kLane, r = threadIdx.x / kLane;
  const unsigned row0 = (unsigned)__cvta_generic_to_shared(smem + r * kLane);
  const int64_t steps = (int64_t)p.nx * (p.ny / TY);
  const int64_t end = (blockIdx.x + 1) * steps / gridDim.x;
  const int64_t row_step = (int64_t)p.ny * kLane;  // voxels from one x row to the next
  auto uz_at = [&](int64_t w) { return B >= kGather ? __ldg(p.warp + 3 * w + 2) : 0.0f; };
  for (int64_t f = blockIdx.x * steps / gridDim.x; f < end;) {
    const int y0 = (int)(f / p.nx) * TY, x0 = (int)(f % p.nx);
    const int xn = (int)min((int64_t)(p.nx - x0), end - f);
    f += xn;
    int64_t v = ((int64_t)x0 * p.ny + y0 + r) * kLane + z;
    float uz[V];
#pragma unroll
    for (int k = 0; k < V; ++k) uz[k] = uz_at(v + k * kVoxStep);
    // Rows x0 .. x0 + xn + kN - 2: the first kN in one group, the next
    // kLoopAhead - 1 a group each, then one a step (possibly empty groups).
    for (int c = 0; c < kN; ++c) stage<TY, G::kThreadsL>(p, smem + c * G::kSlotF, x0 + c, y0);
    cp_async_commit();
    for (int d = 1; d < kLoopAhead; ++d) {
      if (d < xn) stage<TY, G::kThreadsL>(p, smem + (kN - 1 + d) * G::kSlotF, x0 + kN - 1 + d, y0);
      cp_async_commit();
    }
    for (int xi = 0, slot0 = 0; xi < xn; ++xi, slot0 = slot0 + 1 == kLoopSlots ? 0 : slot0 + 1) {
      if (xi + kLoopAhead < xn) {  // row x0 + xi + kLoopSlots - 1, into the slot row xi - 1 used
        const int next = slot0 == 0 ? kLoopSlots - 1 : slot0 - 1;
        stage<TY, G::kThreadsL>(p, smem + next * G::kSlotF, x0 + xi + kLoopSlots - 1, y0);
      }
      cp_async_commit();
      cp_async_wait<kLoopAhead>();  // every group but the kLoopAhead newest has landed
      __syncthreads();
      float uz_next[V], out[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        uz_next[k] = xi + 1 < xn ? uz_at(v + row_step + k * kVoxStep) : uz[k];
      }
      loop_voxels<B, L, TY, V>(row0, slot0, z, uz, out);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        p.out[v + k * kVoxStep] = out[k];
        uz[k] = uz_next[k];
      }
      v += row_step;
      __syncthreads();  // slot xi is refilled at the next step (or the next range's start)
    }
  }
}

template <int B, int L>
int launch_loop_kernel(const Params& p, cudaStream_t stream) {
  using G = LoopGeom<kLoopTY, kLoopV>;
  static lsf_occ::WaveCache waves;
  const int wave = lsf_occ::wave((const void*)loop_kernel<B, L, kLoopTY, kLoopV>, G::kThreadsL,
                                 G::kSmemB, waves);
  if (wave < 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const int64_t steps = (int64_t)p.nx * (p.ny / kLoopTY);
  loop_kernel<B, L, kLoopTY, kLoopV><<<(unsigned)std::min<int64_t>(wave, steps), G::kThreadsL,
                                       G::kSmemB, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int B>
int launch_loop(const Params& p, int loop, cudaStream_t stream) {
  if (loop == kFori) return launch_loop_kernel<B, kFori>(p, stream);
  if (loop == kStatic) return launch_loop_kernel<B, kStatic>(p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// body: 0 nothing, 1 slice, 2 slice0, 3 gather, 4 full, 5 zsetup, 6 tents,
// 7 acc0, 8 clampin, 9 v8, 10 v8c; loop: 0 fori and 1 static (loop_kernel,
// bodies 0-4: B9), 2 frame (table_kernel, bodies 4-10: B8's levels 0-4, B7).
// Shape rules (else cudaErrorInvalidValue): n = 6 planes, nz 128, nx >= 1,
// xp >= nx + 5, ny a multiple of 4 (kYRule), stack 16-byte aligned.
extern "C" int lsf_stack_body(const float* stack, const float* warp, float* out, int n,
                              int xp, int nx, int ny, int nz, int body, int loop,
                              void* stream) {
  if (n != kN || nz != kLane || nx < 1 || xp < nx + kN - 1 || ny < kYRule || ny % kYRule != 0 ||
      (uintptr_t)stack % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{stack, warp, out, xp, nx, ny};
  const cudaStream_t s = (cudaStream_t)stream;
  if (loop == kFrame) {
    switch (body) {
      case kFull: return launch_table<kFull, kLevelTY>(p, s);
      case kZSetup: return launch_table<kZSetup, kLevelTY>(p, s);
      case kTents: return launch_table<kTents, kLevelTY>(p, s);
      case kAcc0: return launch_table<kAcc0, kLevelTY>(p, s);
      case kClampIn: return launch_table<kClampIn, kLevelTY>(p, s);
      case kV8: return launch_table<kV8, kV8TY>(p, s);
      case kV8c: return launch_table<kV8c, kV8cTY>(p, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (body) {
    case kNothing: return launch_loop<kNothing>(p, loop, s);
    case kSlice: return launch_loop<kSlice>(p, loop, s);
    case kSlice0: return launch_loop<kSlice0>(p, loop, s);
    case kGather: return launch_loop<kGather>(p, loop, s);
    case kFull: return launch_loop<kFull>(p, loop, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* lsf_stack_bodies_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
