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
// the stack's rows staged instead of the field's. B9 (stack_kernel, loops
// fori and static): a CTA computes XC = 8 x rows by TY = 4 y rows by 128 z
// lanes, 512 threads, one voxel of each x row per thread, so warp reads and
// output writes coalesce. It keeps a ring of N + 1 slots, each holding the N
// planes' TY rows of one padded x row, staged with cp.async, the next row in
// flight while the current row's sums run (one commit group per step). TY
// and XC are compile-time constants, so the ring's strides fold into the
// address arithmetic. A slot is 6 x 4 x 512 B and the ring 86 KB, so two
// CTAs (32 warps) share an SM; 128^3 is 512 CTAs. The TPU's yb only gates
// the shapes (Y must also be a multiple of TY). The arithmetic is
// resample_z.cuh's, in the float steps of the JAX bodies, so each body
// equals its plain torch version bit for bit.
//
// B8's levels and B7 (table_kernel, loop frame) run on another frame: the
// grid splits the (tile, x row) steps into equal ranges, one wave of CTAs on
// the current device (occupancy.cuh), a CTA walking its range through the
// ring and loading its next x row's warp before the step's barrier. The pair
// loop stays one runtime step a pair in t order: it reads pair t's ring row
// (and its shifts, or v8's cy, cx) from a table in constant memory
// (resample_z.cuh's Pair), not t / N and the ring's wrap, so an address is
// a multiply-add from the voxel's z0c or z1c row, and it issues pair t + 1's
// loads before pair t's sum (v8, v8c). The levels run resample_z.cuh's pair_sum,
// levels 2-4 computing each pair's tents in the loop, from the shifts; their
// tiles are kLevelTY = 4 y rows (512 threads, the 86 KB ring: two CTAs, 32
// warps an SM), which times faster than 2 or 1 (40 warps), and the loop
// loads pair t's values in the step that sums it, which times faster than
// loading them a step ahead (experiments/stack_bodies_sweep.py).
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
// ~26 us at 3.35 TB/s; even the arithmetic this design spends (145 to 513
// float operations per voxel, 5-16 us at 67 TFLOP/s) is below that. The ring reads each staged
// row from L2 or memory once per chunk of x rows (13 rows for 8 outputs),
// and the pairs' 72 z reads per voxel come from shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

constexpr int kTY = 4;  // y rows per CTA, one per 128 threads
constexpr int kXC = 8;  // x rows per CTA
constexpr int kThreads = kTY * kLane;
constexpr int kSlots = kN + 1;
constexpr int kPairs = kN * kN;
constexpr int kSlotFloats = kN * kTY * kLane;  // one padded x row of every plane
constexpr int kSmem = kSlots * kSlotFloats * (int)sizeof(float);

struct Params {
  const float* stack;  // (kN, xp, ny, 128)
  const float* warp;   // (nx, ny, 128, 3)
  float* out;          // (nx, ny, 128)
  int xp, nx, ny;
};

// Stage padded x row px, y rows [y0, y0 + TY) of every plane, into `slot`
// (plane c at rows [c TY, (c + 1) TY)): a cp.async per 16 bytes.
template <int TY = kTY>
__device__ __forceinline__ void stage(const Params& p, float* slot, int px, int y0) {
  constexpr int kPerPlane = TY * kLane / 4;
  for (int q = threadIdx.x; q < kN * kPerPlane; q += TY * kLane) {
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

// One output voxel of B9's bodies (B <= kFull): slot (slot0 + cx) mod
// kSlots holds padded x row x + cx, and row r of plane cy in a slot is
// stacked[cy, x + cx, y0 + r].
template <int B, int L>
__device__ __forceinline__ float voxel(const float* smem, int slot0, int r, int z,
                                       const float* u) {
  static_assert(B <= kFull, "stack_kernel runs B9's bodies");
  auto row = [&](int cy, int cx) -> const float* {
    int sl = slot0 + cx;
    if (sl >= kSlots) sl -= kSlots;
    return smem + sl * kSlotFloats + (cy * kTY + r) * kLane;
  };
  const ZSetup zs = z_setup_const(__ldg(u + 2), z);
  auto step = [&](int t, float acc) -> float {
    const int cy = t / kN, cx = t - cy * kN;
    if constexpr (B == kNothing) return __fadd_rn(acc, 1.0f);
    if constexpr (B == kSlice) return __fadd_rn(acc, row(cy, cx)[z]);
    if constexpr (B == kSlice0) return __fadd_rn(acc, row(0, 0)[z]);
    if constexpr (B == kGather) return __fadd_rn(acc, row(0, 0)[zs.z0c]);
    const float* rw = row(cy, cx);
    return __fadd_rn(acc, zmix(zs, rw[zs.z0c], rw[zs.z1c]));
  };
  float acc = 0.0f;
  if constexpr (L == kFori) {
#pragma unroll 1
    for (int t = 0; t < kPairs; ++t) acc = step(t, acc);
  } else {
#pragma unroll
    for (int t = 0; t < kPairs; ++t) acc = step(t, acc);
  }
  return acc;
}

template <int B, int L>
__global__ void __launch_bounds__(kThreads, 2) stack_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int x0 = blockIdx.x * kXC;
  const int xn = min(kXC, p.nx - x0);
  const int y0 = blockIdx.y * kTY;
  const int z = threadIdx.x % kLane, r = threadIdx.x / kLane;
  for (int c = 0; c < kN; ++c) stage(p, smem + c * kSlotFloats, x0 + c, y0);
  cp_async_commit();
  for (int xi = 0; xi < xn; ++xi) {
    if (xi + 1 < xn) {  // the ring's next row, into the slot row xi - 1 used
      stage(p, smem + ((xi + kN) % kSlots) * kSlotFloats, x0 + xi + kN, y0);
    }
    cp_async_commit();    // possibly empty: one group per step
    cp_async_wait<1>();  // every group but this step's has landed
    __syncthreads();
    const int64_t v = ((int64_t)(x0 + xi) * p.ny + y0 + r) * kLane + z;
    p.out[v] = voxel<B, L>(smem, xi % kSlots, r, z, p.warp + 3 * v);
    __syncthreads();  // slot xi is refilled at the next step
  }
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
// of TY y rows, one voxel of each a thread, through the ring as
// stack_kernel does, restarting the ring where the range enters a new tile;
// its table follows the ring in shared memory. A thread loads the next x
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

template <int B, int L>
int launch(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute((const void*)stack_kernel<B, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.nx + kXC - 1) / kXC, p.ny / kTY);
  stack_kernel<B, L><<<grid, kThreads, kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int B>
int launch_loop(const Params& p, int loop, cudaStream_t stream) {
  if (loop == kFori) return launch<B, kFori>(p, stream);
  if (loop == kStatic) return launch<B, kStatic>(p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// body: 0 nothing, 1 slice, 2 slice0, 3 gather, 4 full, 5 zsetup, 6 tents,
// 7 acc0, 8 clampin, 9 v8, 10 v8c; loop: 0 fori and 1 static (stack_kernel,
// bodies 0-4: B9), 2 frame (table_kernel, bodies 4-10: B8's levels 0-4, B7).
// Shape rules (else cudaErrorInvalidValue): n = 6 planes, nz 128, nx >= 1,
// xp >= nx + 5, ny a multiple of 4 (TY), stack 16-byte aligned.
extern "C" int lsf_stack_body(const float* stack, const float* warp, float* out, int n,
                              int xp, int nx, int ny, int nz, int body, int loop,
                              void* stream) {
  if (n != kN || nz != kLane || nx < 1 || xp < nx + kN - 1 || ny < kTY || ny % kTY != 0 ||
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
