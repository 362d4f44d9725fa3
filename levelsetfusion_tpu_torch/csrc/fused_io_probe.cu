// Probe of the fused gradient kernel's I/O plan with a stand-in body: read
// warped, canonical and the three warp components (each edge-padded by H = 5
// along x), write three warp components, with one of three bodies between:
//   copy:  out_k = u_k
//   arith: out_k = u_k + 0.1 (w - c)
//   rolls: out_k = u_k + 0.1 (box27(w) - c), where box27 is the 3 x 3 x 3
//          box sum: along x over the edge-padded field (so the volume's
//          end rows are replicated), along y and z periodic.
//
// Replaces the TPU kernel experiments/fused_io_probe.py::make -> run (line
// 71, body kern), which stages an (xb + 2H)-row window of each padded input
// in VMEM per grid step, rolls it within the window (x) or around the whole
// plane (y, z) and writes an xb-row output block. Only the +-1 row of the x
// window reaches the interior, so the window's wrap never shows; this kernel
// computes the same values and keeps the sum order of the TPU body (x, then
// y, then z, each as (a + roll(+1)) + roll(-1)). The _rn intrinsics keep
// nvcc from contracting u + 0.1 (w - c) into an FMA, so the result matches
// the plain torch version bit for bit.
//
// What bounds it on the H100: bytes. The plan moves 5 padded inputs and 3
// outputs, 70.4 MB at 128^3, 21 us at the 3.35 TB/s peak; it is the
// streaming floor of the fused kernel's passes. The box body reads 27 values
// per voxel, all but one from L1/L2. Measured per call at 128^3 over 20
// launches on the same inputs: copy 19.1 us, arith 24.0 us (2.93 TB/s of
// the plan's bytes), rolls 30.4 us (2.31 TB/s), the same at xb 16 and 32;
// the plain rolls body 153.9 us (NVIDIA H100 80GB HBM3, 700 W power limit).
//
// Design: one thread per output voxel, z fastest, so reads and writes
// coalesce. Each block lies inside one x-slab of xb rows (grid.y = X / xb),
// which keeps the TPU script's xb rows comparable; on this card the slab
// shapes only the grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kH = 5;  // x padding on each side

enum Body { kCopy = 0, kArith = 1, kRolls = 2 };

template <int kBody>
__global__ void __launch_bounds__(kThreads)
    fused_io_probe_kernel(const float* __restrict__ we, const float* __restrict__ ce,
                          const float* __restrict__ ue, float* __restrict__ out,
                          int nx, int ny, int nz, int xb) {
  const int plane = ny * nz;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;  // voxel in the slab
  if (v >= xb * plane) return;
  const int xi = v / plane, p = v - xi * plane;
  const int x = blockIdx.y * xb + xi;
  const int64_t vol = (int64_t)nx * plane;
  const int64_t padded = (int64_t)(nx + 2 * kH) * plane;
  const int64_t at = (int64_t)(x + kH) * plane + p;  // (x, y, z) in padded arrays
  float d = 0.0f;
  if (kBody == kArith) {
    d = __fsub_rn(we[at], ce[at]);
  } else if (kBody == kRolls) {
    const int y = p / nz, z = p - y * nz;
    const int ys[3] = {y, y == 0 ? ny - 1 : y - 1, y == ny - 1 ? 0 : y + 1};
    const int zs[3] = {z, z == 0 ? nz - 1 : z - 1, z == nz - 1 ? 0 : z + 1};
    const float* row = we + (int64_t)(x + kH) * plane;
    float acc_z = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc_y = 0.0f;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int o = ys[b] * nz + zs[c];
        const float acc_x = __fadd_rn(__fadd_rn(row[o], row[o - plane]), row[o + plane]);
        acc_y = b == 0 ? acc_x : __fadd_rn(acc_y, acc_x);
      }
      acc_z = c == 0 ? acc_y : __fadd_rn(acc_z, acc_y);
    }
    d = __fsub_rn(acc_z, ce[at]);
  }
  const int64_t o = (int64_t)x * plane + p;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float u = ue[k * padded + at];
    out[k * vol + o] = kBody == kCopy ? u : __fadd_rn(u, __fmul_rn(0.1f, d));
  }
}

}  // namespace

// we, ce: (X + 2H, Y, Z); ue: (3, X + 2H, Y, Z); out: (3, X, Y, Z). body 0/1/2
// = copy/arith/rolls; X a multiple of xb (else cudaErrorInvalidValue).
extern "C" int lsf_fused_io_probe(const float* we, const float* ce, const float* ue,
                                  float* out, int nx, int ny, int nz, int xb, int body,
                                  void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || xb < 1 || nx % xb != 0 || body < 0 || body > 2 ||
      (int64_t)xb * ny * nz > INT32_MAX - kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)(((int64_t)xb * ny * nz + kThreads - 1) / kThreads),
                  (unsigned)(nx / xb));
  const cudaStream_t s = (cudaStream_t)stream;
  switch (body) {
    case kCopy:
      fused_io_probe_kernel<kCopy><<<grid, kThreads, 0, s>>>(we, ce, ue, out, nx, ny, nz, xb);
      break;
    case kArith:
      fused_io_probe_kernel<kArith><<<grid, kThreads, 0, s>>>(we, ce, ue, out, nx, ny, nz, xb);
      break;
    default:
      fused_io_probe_kernel<kRolls><<<grid, kThreads, 0, s>>>(we, ce, ue, out, nx, ny, nz, xb);
      break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* lsf_fused_io_probe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
