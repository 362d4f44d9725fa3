// Trilinear warp resample out(v) = live(v + u(v)), +1 outside the volume.
//
// Replaces the TPU kernel levelsetfusion_tpu/ops/pallas/resample.py::
// warp_field_pallas_prepared (bodies _resample3d_kernel/_resample3d_body and
// _resample3d_kernel_mz/_resample3d_body_mz). The TPU has no hardware
// gather, so that kernel enumerates (2K+2)^2 integer x/y shifts over stacked
// y-shifted copies of the field, is exact only for |u| <= K per axis and
// needs z % 128 == 0 and y % 8 == 0. None of that carries over: the H100
// gathers, so this kernel computes the golden
// levelsetfusion_tpu/ops/interpolation.py::warp_field directly, exactly,
// for any displacement and any shape.
//
// What bounds it on the H100: bytes. Per voxel it reads 3 warp components
// and writes 1 value (16 B of streaming traffic) and makes 8 corner reads of
// the live field. A 128^3 live field is 8 MB and stays in the 50 MB L2, so
// the corner reads are L2 hits and the streaming traffic sets the floor:
// 32 MB per call at 128^3. Measured 38 us per call at 128^3 (NVIDIA H100
// 80GB HBM3, 700 W power limit), which is 0.84 TB/s of that traffic against
// the card's 3.35 TB/s peak; closing that gap is later work.
//
// Design: one thread per output voxel, z fastest, so that the warp reads
// and the output write coalesce; corner reads go through the read-only
// path (__ldg). The float steps are the golden op's: pos = float(i) + u,
// floor, frac = pos - floor, weights multiplied left to right over the
// axes, corners summed in itertools.product order. The _rn intrinsics keep
// nvcc from contracting them into FMAs, so the result matches the plain
// torch version bit for bit in practice. Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void warp_field_cm_kernel(const float* __restrict__ live,
                                     const float* __restrict__ warp_cm,
                                     float* __restrict__ out,
                                     int nx, int ny, int nz) {
  const int64_t n = (int64_t)nx * ny * nz;
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  // 64-bit integer division is a long software sequence on the GPU, so
  // volumes under 2^32 voxels (the uniform branch) divide in 32 bits.
  int64_t x, y, z;
  if (n <= 0xffffffffLL) {
    const uint32_t u = (uint32_t)v, t = u / (uint32_t)nz;
    z = u - t * (uint32_t)nz;
    y = t % (uint32_t)ny;
    x = t / (uint32_t)ny;
  } else {
    const int64_t t = v / nz;
    z = v - t * nz;
    y = t % ny;
    x = t / ny;
  }

  const float pos[3] = {__fadd_rn((float)x, warp_cm[v]),
                        __fadd_rn((float)y, warp_cm[n + v]),
                        __fadd_rn((float)z, warp_cm[2 * n + v])};
  const int64_t ext[3] = {nx, ny, nz};
  int64_t base[3];
  float w1[3], w0[3];
  for (int a = 0; a < 3; ++a) {
    const float f = floorf(pos[a]);
    base[a] = (int64_t)f;
    w1[a] = __fsub_rn(pos[a], f);
    w0[a] = __fsub_rn(1.0f, w1[a]);
  }

  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int cx = (c >> 2) & 1, cy = (c >> 1) & 1, cz = c & 1;
    const int64_t ix = base[0] + cx, iy = base[1] + cy, iz = base[2] + cz;
    const float weight = __fmul_rn(__fmul_rn(cx ? w1[0] : w0[0], cy ? w1[1] : w0[1]),
                                   cz ? w1[2] : w0[2]);
    const bool inb = ix >= 0 && ix < ext[0] && iy >= 0 && iy < ext[1] &&
                     iz >= 0 && iz < ext[2];
    const float value = inb ? __ldg(live + (ix * ny + iy) * nz + iz) : 1.0f;
    const float contrib = __fmul_rn(weight, value);
    acc = c == 0 ? contrib : __fadd_rn(acc, contrib);
  }
  out[v] = acc;
}

}  // namespace

extern "C" int lsf_warp_field_cm(const float* live, const float* warp_cm,
                                 float* out, int nx, int ny, int nz,
                                 void* stream) {
  const int64_t n = (int64_t)nx * ny * nz;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  warp_field_cm_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      live, warp_cm, out, nx, ny, nz);
  return (int)cudaGetLastError();
}

extern "C" const char* lsf_resample_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
