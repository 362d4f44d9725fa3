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
//   v8        clampin, the 12 tent values computed once into scratch (B7)
//   v8c       the 36 weight products once into scratch, summed from 0, the
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
// Design: the ring of csrc/resample_variants.cu (B4) with the stack's rows
// staged instead of the field's. A CTA computes XC = 8 x rows by TY = 4 y
// rows by 128 z lanes, 512 threads, one voxel of each x row per thread, so
// warp reads and output writes coalesce. It keeps a ring of N + 1 slots, each
// holding the N planes' TY rows of one padded x row, staged with cp.async,
// the next row in flight while the current row's sums run (one commit group
// per step). TY and XC are compile-time constants, so the ring's strides fold
// into the address arithmetic. A slot is 6 x 4 x 512 B and the ring 86 KB, so
// two CTAs (32 warps) share an SM; 128^3 is 512 CTAs. The TPU's yb only gates
// the shapes (Y must also be a multiple of TY). v8's and v8c's scratch is a
// per-thread array indexed by the runtime pair, which nvcc places in local
// memory: the counterpart of the TPU's VMEM scratch planes. The arithmetic is
// resample_z.cuh's, in the float steps of the JAX bodies, so each body
// equals its plain torch version bit for bit.
//
// What bounds it on the H100: bytes. At 128^3 the function reads the 52 MB
// of stack rows it uses and the 25 MB warp once and writes 8 MB, 86 MB or
// ~26 us at 3.35 TB/s; even the arithmetic this design spends (145 to 513
// float operations per voxel, 5-16 us at 67 TFLOP/s) is below that. The ring reads each staged
// row from L2 or memory once per chunk of XC x rows (13 rows for 8 outputs),
// and the pairs' 72 z reads per voxel come from shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "resample_z.cuh"

namespace {

using namespace lsf_cp;
using namespace lsf_rz;

enum Loop { kFori = 0, kStatic = 1 };
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
__device__ __forceinline__ void stage(const Params& p, float* slot, int px, int y0) {
  constexpr int kPerPlane = kTY * kLane / 4;
  for (int q = threadIdx.x; q < kN * kPerPlane; q += kThreads) {
    const int c = q / kPerPlane, e = q - c * kPerPlane;
    cp_async16(slot + c * kTY * kLane + 4 * e,
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

// One output voxel: slot (slot0 + cx) mod kSlots holds padded x row x + cx,
// and row r of plane cy in a slot is stacked[cy, x + cx, y0 + r].
template <int B, int L>
__device__ __forceinline__ float voxel(const float* smem, int slot0, int r, int z,
                                       const float* u) {
  auto row = [&](int cy, int cx) -> const float* {
    int sl = slot0 + cx;
    if (sl >= kSlots) sl -= kSlots;
    return smem + sl * kSlotFloats + (cy * kTY + r) * kLane;
  };
  const ZSetup zs = B >= kZSetup ? z_setup(__ldg(u + 2), z) : z_setup_const(__ldg(u + 2), z);
  float ux = 0.0f, uy = 0.0f;
  if constexpr (B >= kTents) {
    ux = __ldg(u), uy = __ldg(u + 1);
    if constexpr (B >= kClampIn) ux = clamp_k(ux), uy = clamp_k(uy);
  }
  float tx[kN], ty_[kN], wt[kPairs];  // scratch of v8 and v8c
  if constexpr (B == kV8 || B == kV8c) {
#pragma unroll
    for (int c = 0; c < kN; ++c) tx[c] = tent_at(ux, c), ty_[c] = tent_at(uy, c);
  }
  if constexpr (B == kV8c) {
#pragma unroll
    for (int t = 0; t < kPairs; ++t) wt[t] = __fmul_rn(ty_[t / kN], tx[t % kN]);
  }
  auto step = [&](int t, float acc) -> float {
    const int cy = t / kN, cx = t - cy * kN;
    if constexpr (B == kNothing) return __fadd_rn(acc, 1.0f);
    if constexpr (B == kSlice) return __fadd_rn(acc, row(cy, cx)[z]);
    if constexpr (B == kSlice0) return __fadd_rn(acc, row(0, 0)[z]);
    if constexpr (B == kGather) return __fadd_rn(acc, row(0, 0)[zs.z0c]);
    const float* rw = row(cy, cx);
    const float g = zmix(zs, rw[zs.z0c], rw[zs.z1c]);
    if constexpr (B == kFull || B == kZSetup) return __fadd_rn(acc, g);
    if constexpr (B == kV8) return add_pair(acc, __fmul_rn(ty_[cy], tx[cx]), g);
    if constexpr (B == kV8c) return add_pair(acc, wt[t], g);
    return add_pair(acc, __fmul_rn(tent_at(uy, cy), tent_at(ux, cx)), g);
  };
  float acc = (B >= kAcc0 && B != kV8c) ? acc0(zs) : 0.0f;
  if constexpr (L == kFori) {
#pragma unroll 1
    for (int t = 0; t < kPairs; ++t) acc = step(t, acc);
  } else {
#pragma unroll
    for (int t = 0; t < kPairs; ++t) acc = step(t, acc);
  }
  if constexpr (B == kV8c) acc = __fadd_rn(acc, acc0(zs));
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
  if constexpr (B <= kFull) {
    if (loop == kStatic) return launch<B, kStatic>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// body: 0 nothing, 1 slice, 2 slice0, 3 gather, 4 full, 5 zsetup, 6 tents,
// 7 acc0, 8 clampin, 9 v8, 10 v8c; loop: 0 fori, 1 static (bodies 0-4 only).
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
  switch (body) {
    case kNothing: return launch_loop<kNothing>(p, loop, s);
    case kSlice: return launch_loop<kSlice>(p, loop, s);
    case kSlice0: return launch_loop<kSlice0>(p, loop, s);
    case kGather: return launch_loop<kGather>(p, loop, s);
    case kFull: return launch_loop<kFull>(p, loop, s);
    case kZSetup: return launch_loop<kZSetup>(p, loop, s);
    case kTents: return launch_loop<kTents>(p, loop, s);
    case kAcc0: return launch_loop<kAcc0>(p, loop, s);
    case kClampIn: return launch_loop<kClampIn>(p, loop, s);
    case kV8: return launch_loop<kV8>(p, loop, s);
    case kV8c: return launch_loop<kV8c>(p, loop, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* lsf_stack_bodies_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
