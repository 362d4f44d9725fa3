// The x-slab resample with an active-shift range: the clamped (±K)
// shift-enumeration resample of csrc/resample_variants.cu, summed only over
// the shifts that can carry weight somewhere in the block.
//
// Replaces the TPU kernel experiments/v10_xslab.py::run_v10 (line 88, body
// _kernel_v10): a grid step per (xb-row slab, y block) over an x-chunk
// window of stacked y-shifted copies; it clamps the raw warp itself, keeps
// the 2n tent planes in VMEM scratch, reduces min/max of the clamped ux and
// uy over the slab, and runs its pair loop only over the active range
// [floor(min u) + K, floor(max u) + K + 1] per axis. On v5e the design was
// shelved on register spills (KERNEL_NOTES.md).
//
// Hopper design: one CTA per (xb, yb) slab, 512 threads, one z lane each.
// Pass 1 reads the slab's clamped ux and uy and reduces min and max with
// warp shuffles, then across warps through shared memory; the bounds are
// block-uniform. Pass 2 computes each voxel: its 2n tent values in
// registers, then a static 6 x 6 unroll whose pairs outside the active range
// are skipped by block-uniform predicates (a runtime cx would index the tent
// array dynamically and push it to local memory). A skipped pair's weight is
// exactly 0, so the sum equals the full enumeration's. The window of stacked
// copies (xb + 5) x (yb + 5) x 128 floats, 459 KB at xb 8 and yb 64, does
// not fit shared memory: rows are read through the read-only path from L2
// (the 8 MB field of 128^3 stays there), with the +1 fill by a bounds check.
// The TPU's x chunk only places its DMA window; it gates shapes in the
// wrapper and changes nothing here.
//
// What bounds it on the H100: the grid. 128^3 with yb 64 gives 64, 32 and 16
// CTAs for xb 4, 8 and 16 on 132 SMs, each walking xb * yb * 128 voxels with
// up to 72 L1/L2 reads apiece; on smooth warps the active range cuts the
// pairs to as few as 4.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "resample_z.cuh"

namespace {

using namespace lsf_rz;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
    v10_kernel(const float* __restrict__ field, const float* __restrict__ warp,
               float* __restrict__ out, int nx, int ny, int xb, int yb) {
  __shared__ float part[4][kWarps];
  __shared__ int bounds[4];  // lo_x, hi_x, lo_y, hi_y
  const int x0 = blockIdx.x * xb, y0 = blockIdx.y * yb;
  const int per_x = yb * kLane, count = xb * per_x;
  auto voxel_index = [&](int e) -> int64_t {
    const int xi = e / per_x;
    return ((int64_t)(x0 + xi) * ny + y0) * kLane + (e - xi * per_x);
  };

  float mnx = INFINITY, mxx = -INFINITY, mny = INFINITY, mxy = -INFINITY;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int64_t v = voxel_index(e);
    const float ux = clamp_k(__ldg(warp + 3 * v)), uy = clamp_k(__ldg(warp + 3 * v + 1));
    mnx = fminf(mnx, ux), mxx = fmaxf(mxx, ux);
    mny = fminf(mny, uy), mxy = fmaxf(mxy, uy);
  }
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  mnx = warp_min(mnx), mxx = warp_max(mxx), mny = warp_min(mny), mxy = warp_max(mxy);
  if (lane == 0) part[0][w] = mnx, part[1][w] = mxx, part[2][w] = mny, part[3][w] = mxy;
  __syncthreads();
  if (w == 0) {
    const bool live = lane < kWarps;
    mnx = warp_min(live ? part[0][lane] : INFINITY);
    mxx = warp_max(live ? part[1][lane] : -INFINITY);
    mny = warp_min(live ? part[2][lane] : INFINITY);
    mxy = warp_max(live ? part[3][lane] : -INFINITY);
    if (lane == 0) {
      bounds[0] = (int)floorf(mnx) + kK, bounds[1] = (int)floorf(mxx) + kK + 1;
      bounds[2] = (int)floorf(mny) + kK, bounds[3] = (int)floorf(mxy) + kK + 1;
    }
  }
  __syncthreads();
  const int lo_x = bounds[0], hi_x = bounds[1], lo_y = bounds[2], hi_y = bounds[3];

  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int64_t v = voxel_index(e);
    const int z = e % kLane, y = y0 + (e / kLane) % yb, x = x0 + e / per_x;
    const float ux = clamp_k(__ldg(warp + 3 * v)), uy = clamp_k(__ldg(warp + 3 * v + 1));
    const ZSetup zs = z_setup(__ldg(warp + 3 * v + 2), z);
    float tx[kN], ty[kN];
#pragma unroll
    for (int c = 0; c < kN; ++c) tx[c] = tent_at(ux, c), ty[c] = tent_at(uy, c);
    float acc = acc0(zs);
#pragma unroll
    for (int cy = 0; cy < kN; ++cy) {
      if (cy < lo_y || cy > hi_y) continue;
      const int fy = y + cy - kK;
#pragma unroll
      for (int cx = 0; cx < kN; ++cx) {
        if (cx < lo_x || cx > hi_x) continue;
        const int fx = x + cx - kK;
        float r0 = 1.0f, r1 = 1.0f;
        if (fx >= 0 && fx < nx && fy >= 0 && fy < ny) {
          const float* rw = field + ((int64_t)fx * ny + fy) * kLane;
          r0 = __ldg(rw + zs.z0c), r1 = __ldg(rw + zs.z1c);
        }
        acc = add_pair(acc, __fmul_rn(ty[cy], tx[cx]), zmix(zs, r0, r1));
      }
    }
    out[v] = acc;
  }
}

}  // namespace

// Shape rules (else cudaErrorInvalidValue): nz 128, xb divides nx, yb
// divides ny.
extern "C" int lsf_v10_xslab(const float* field, const float* warp, float* out, int nx,
                             int ny, int nz, int xb, int yb, void* stream) {
  if (nz != kLane || xb < 1 || yb < 1 || nx % xb != 0 || ny % yb != 0 || nx < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(nx / xb, ny / yb);
  v10_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(field, warp, out, nx, ny, xb, yb);
  return (int)cudaGetLastError();
}

extern "C" const char* lsf_v10_xslab_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
