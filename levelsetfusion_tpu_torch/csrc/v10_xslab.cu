// The x-slab resample with an active-shift range: the clamped (±K)
// shift-enumeration resample of csrc/resample_variants.cu, summed only over
// the shifts that can carry weight somewhere in the slab.
//
// Replaces the TPU kernel experiments/v10_xslab.py::run_v10 (line 88, body
// _kernel_v10): a grid step per (xb-row slab, y block of yb) over an x-chunk
// window of stacked y-shifted copies; it clamps the raw warp itself, keeps
// the 2n tent planes in VMEM scratch, reduces min/max of the clamped ux and
// uy over the slab, and runs its pair loop only over the active range
// [floor(min u) + K, floor(max u) + K + 1] per axis. On v5e the design was
// shelved on register spills (KERNEL_NOTES.md).
//
// What bounds it on the H100: bytes, 20 B a voxel (the interleaved warp and
// the output; the 8 MB field of 128^3 stays in L2), 12.5 us at 128^3. What
// held the first port back (778.5 us at xb 8) was its grid: one CTA per
// slab, 64, 32 and 16 CTAs at xb 4, 8 and 16 (yb 64) on 132 SMs, each
// gathering its 72 rows a voxel from L2. Now the grid no longer follows the
// slabs. Two launches on the call's stream:
// - bounds_kernel: a CTA per (x plane, y block) reduces floor(clamp(ux)) and
//   floor(clamp(uy)) to min and max as integers (floor is monotone, so the
//   min of the floors is the floor of the min) and writes one row of 4 ints
//   into a scratch the wrapper allocates per call: no atomics, nothing to
//   zero, no state shared between calls.
// - compute_kernel: a CTA owns kRows y rows of one y block, one z lane a
//   thread, and walks a chunk of x planes; the chunks make one wave of CTAs
//   on the current device (occupancy.cuh) whatever xb is. Each plane it
//   reaches arrives in a shared-memory ring of kSlots planes of kRows + 5
//   padded rows (cp.async, the +1 fill outside the volume), one plane ahead.
//   Each warp folds the xb bounds rows of every slab it enters. Each voxel
//   computes its 2n tent values in registers and sums a static 6 x 6 unroll
//   from the ring, pairs outside the active range skipped by uniform
//   predicates (a runtime cx would index the tent array dynamically and
//   push it to local memory). A skipped pair's weight is exactly 0, so the
//   sum equals the full enumeration's. Strides are constants: Z is 128.
// The TPU's x chunk only places its DMA window; it gates shapes in the
// wrapper and changes nothing here.
//
// Measured at 128^3, yb 64 (NVIDIA H100 80GB HBM3, 700.00 W): 81.0-82.7 us
// a call on the random warp at xb 4, 8 and 16 (the first port: 778.5 at xb
// 8), 40.5-41.8 us on the smooth one; at xb 8 the bounds pass takes 6.2-6.4
// us of it and the compute pass 72.6 (random) and 30.5 (smooth), by
// torch.profiler. grid_sample takes 49.3-49.5 us for the same values.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "cp_async.cuh"
#include "occupancy.cuh"
#include "resample_z.cuh"

namespace {

using namespace lsf_cp;
using namespace lsf_rz;

constexpr int kBoundsThreads = 256;
constexpr int kRows = 8;  // y rows of a compute CTA, kLane threads each
constexpr int kThreads = kRows * kLane;
constexpr int kStageRows = kRows + kN - 1;  // rows y0 - K .. y0 + kRows + K of a plane
constexpr int kSlots = kN + 1;              // the kN planes a step reads, one in flight
constexpr int kCols = 4;  // ints of a bounds row: min, max of floor ux; min, max of floor uy

// Min (even k) or max (odd k) of v[k] over the CTA, into warp 0's v.
__device__ __forceinline__ void block_min_max(int v[kCols], int* smem) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    v[k] = k % 2 ? __reduce_max_sync(0xffffffffu, v[k]) : __reduce_min_sync(0xffffffffu, v[k]);
    if (lane == 0) smem[k * 32 + w] = v[k];
  }
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int e = lane < warps ? smem[k * 32 + lane] : (k % 2 ? INT_MIN : INT_MAX);
      v[k] = k % 2 ? __reduce_max_sync(0xffffffffu, e) : __reduce_min_sync(0xffffffffu, e);
    }
  }
}

// Grid (nx, ny / yb): the row of plane blockIdx.x, y block blockIdx.y.
__global__ void __launch_bounds__(kBoundsThreads)
    bounds_kernel(const float* __restrict__ warp, int* __restrict__ partial, int ny, int yb) {
  __shared__ int smem[kCols * 32];
  const int64_t v0 = ((int64_t)blockIdx.x * ny + (int64_t)blockIdx.y * yb) * kLane;
  const float* w = warp + 3 * v0;
  int v[kCols] = {INT_MAX, INT_MIN, INT_MAX, INT_MIN};
#pragma unroll 4
  for (int e = threadIdx.x; e < yb * kLane; e += kBoundsThreads) {
    const int fx = (int)floorf(clamp_k(__ldg(w + 3 * e)));
    const int fy = (int)floorf(clamp_k(__ldg(w + 3 * e + 1)));
    v[0] = min(v[0], fx), v[1] = max(v[1], fx), v[2] = min(v[2], fy), v[3] = max(v[3], fy);
  }
  block_min_max(v, smem);
  if (threadIdx.x == 0) {
    int* row = partial + ((int64_t)blockIdx.x * gridDim.y + blockIdx.y) * kCols;
#pragma unroll
    for (int k = 0; k < kCols; ++k) row[k] = v[k];
  }
}

// Stage field plane fx, rows y0 - K .. y0 + kRows + K, into `slot`: a
// cp.async per 16 bytes inside the volume, the +1 fill outside.
__device__ __forceinline__ void stage_plane(float* slot, const float* __restrict__ field,
                                            int fx, int y0, int nx, int ny) {
  constexpr int kQuads = kLane / 4;
  for (int c = threadIdx.x; c < kStageRows * kQuads; c += kThreads) {
    const int r = c / kQuads, q = c % kQuads, fy = y0 - kK + r;
    float* dst = slot + r * kLane + 4 * q;
    if ((unsigned)fx < (unsigned)nx && (unsigned)fy < (unsigned)ny) {
      cp_async16(dst, field + ((int64_t)fx * ny + fy) * kLane + 4 * q);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    }
  }
}

// Grid (ceil(yb / kRows), ny / yb, x chunks): rows [blockIdx.x kRows, +
// kRows) of y block blockIdx.y, planes [blockIdx.z chunk, + chunk).
__global__ void __launch_bounds__(kThreads)
    compute_kernel(const float* __restrict__ field, const float* __restrict__ warp,
                   const int* __restrict__ partial, float* __restrict__ out, int nx, int ny,
                   int xb, int yb, int chunk) {
  // Step i (plane x = x_begin + i) reads planes x - K .. x + K + 1 from slots
  // (i + cx) % kSlots and fills slot (i + kN) % kSlots with plane x + K + 2.
  __shared__ __align__(16) float ring[kSlots][kStageRows * kLane];
  const int z = threadIdx.x % kLane, lane = threadIdx.x % 32, r = threadIdx.x / kLane;
  const int row = blockIdx.x * kRows + r;  // within the y block
  const int y0 = blockIdx.y * yb + blockIdx.x * kRows, y = y0 + r;
  const int x_begin = blockIdx.z * chunk, x_end = min(x_begin + chunk, nx);
  for (int c = 0; c < kN; ++c) stage_plane(ring[c], field, x_begin - kK + c, y0, nx, ny);
  cp_async_commit();
  int x0 = x_begin - x_begin % xb;  // the first plane of the next slab to fold
  int next = x_begin;               // the plane at which the held bounds run out
  int lo_x = 0, hi_x = 0, lo_y = 0, hi_y = 0;
  for (int x = x_begin, i = 0; x < x_end; ++x, ++i) {
    if (x + 1 < x_end) stage_plane(ring[(i + kN) % kSlots], field, x + kK + 2, y0, nx, ny);
    cp_async_commit();  // possibly empty: one group a step
    cp_async_wait<1>();  // every group but this step's has landed
    __syncthreads();
    if (x == next) {  // a new slab: each warp folds its xb bounds rows
      int b[kCols] = {INT_MAX, INT_MIN, INT_MAX, INT_MIN};
      for (int j = lane; j < xb; j += 32) {
        const int* p = partial + ((int64_t)(x0 + j) * gridDim.y + blockIdx.y) * kCols;
        b[0] = min(b[0], __ldg(p)), b[1] = max(b[1], __ldg(p + 1));
        b[2] = min(b[2], __ldg(p + 2)), b[3] = max(b[3], __ldg(p + 3));
      }
      lo_x = __reduce_min_sync(0xffffffffu, b[0]) + kK;
      hi_x = __reduce_max_sync(0xffffffffu, b[1]) + kK + 1;
      lo_y = __reduce_min_sync(0xffffffffu, b[2]) + kK;
      hi_y = __reduce_max_sync(0xffffffffu, b[3]) + kK + 1;
      x0 += xb;
      next = x0;
    }
    if (row < yb) {  // the tile's rows end at the y block's
      const int64_t v = (x * (int64_t)ny + y) * kLane + z;
      const float ux = clamp_k(__ldg(warp + 3 * v)), uy = clamp_k(__ldg(warp + 3 * v + 1));
      const ZSetup zs = z_setup(__ldg(warp + 3 * v + 2), z);
      float tx[kN], ty[kN];
#pragma unroll
      for (int c = 0; c < kN; ++c) tx[c] = tent_at(ux, c), ty[c] = tent_at(uy, c);
      const int s0 = i % kSlots;
      float acc = acc0(zs);
#pragma unroll
      for (int cy = 0; cy < kN; ++cy) {
        if (cy < lo_y || cy > hi_y) continue;
#pragma unroll
        for (int cx = 0; cx < kN; ++cx) {
          if (cx < lo_x || cx > hi_x) continue;
          const int slot = s0 + cx >= kSlots ? s0 + cx - kSlots : s0 + cx;
          const float* rw = ring[slot] + (r + cy) * kLane;
          acc = add_pair(acc, __fmul_rn(ty[cy], tx[cx]), zmix(zs, rw[zs.z0c], rw[zs.z1c]));
        }
      }
      out[v] = acc;
    }
    __syncthreads();  // the slot read at cx = 0 is refilled at the next step
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

bool shape_ok(int nx, int ny, int nz, int xb, int yb) {
  return nz == kLane && nx >= 1 && xb >= 1 && yb >= 1 && nx % xb == 0 && ny % yb == 0 &&
         ny / yb <= 65535;
}

// The compute pass's grid: x chunks for about one wave of CTAs on the
// current device over the y tiles; {0, 0, 0} if the runtime refused a call.
dim3 compute_grid(int nx, int ny, int yb, int* chunk) {
  static lsf_occ::WaveCache cache;
  const int wave = lsf_occ::wave((const void*)compute_kernel, kThreads, 0, cache);
  if (wave < 0) return dim3(0, 0, 0);
  const int64_t tiles = ceil_div(yb, kRows), y_blocks = ny / yb;
  const int64_t c = std::max(ceil_div(nx * tiles * y_blocks, wave), ceil_div(nx, 65535));
  *chunk = (int)c;
  return dim3((unsigned)tiles, (unsigned)y_blocks, (unsigned)ceil_div(nx, c));
}

}  // namespace

// CTAs of pass 0 (bounds) or 1 (compute) on the current device for this
// shape; 0 if the shape is refused, -1 if the CUDA runtime refused a call.
extern "C" int64_t lsf_v10_ctas(int nx, int ny, int nz, int xb, int yb, int pass) {
  if (!shape_ok(nx, ny, nz, xb, yb)) return 0;
  if (pass == 0) return (int64_t)nx * (ny / yb);
  int chunk = 0;
  const dim3 g = compute_grid(nx, ny, yb, &chunk);
  return g.x == 0 ? -1 : (int64_t)g.x * g.y * g.z;
}

// Ints of the `partial` scratch a call needs; 0 if the shape is refused.
extern "C" int64_t lsf_v10_partials_len(int nx, int ny, int nz, int xb, int yb) {
  return shape_ok(nx, ny, nz, xb, yb) ? (int64_t)nx * (ny / yb) * kCols : 0;
}

// Shape rules (else cudaErrorInvalidValue): nz 128, xb divides nx, yb
// divides ny, field 16-byte aligned. `partial` holds lsf_v10_partials_len
// ints of scratch.
extern "C" int lsf_v10_xslab(const float* field, const float* warp, float* out, int* partial,
                             int nx, int ny, int nz, int xb, int yb, void* stream) {
  if (!shape_ok(nx, ny, nz, xb, yb) || !field || !warp || !out || !partial ||
      (uintptr_t)field % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int chunk = 0;
  const dim3 grid = compute_grid(nx, ny, yb, &chunk);
  if (grid.x == 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const cudaStream_t s = (cudaStream_t)stream;
  bounds_kernel<<<dim3(nx, ny / yb), kBoundsThreads, 0, s>>>(warp, partial, ny, yb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compute_kernel<<<grid, kThreads, 0, s>>>(field, warp, partial, out, nx, ny, xb, yb, chunk);
  return (int)cudaGetLastError();
}

extern "C" const char* lsf_v10_xslab_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
