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
// and writes 1 value, 16 B of streaming traffic, and reads the live field
// (4 B) through 8 corner gathers. A 128^3 live field is 8 MB and stays in
// the 50 MB L2, so HBM carries 20 B a voxel, 42 MB at 128^3: 12.5 us at
// 3.35 TB/s. The corner gathers cost instructions and L1/L2 requests, not
// HBM bytes: without them the kernel takes 10.0-10.2 us at 128^3, with them
// 13.6-14.0 us on the converged config3 warp and 17.4-17.6 us on a uniform
// +-2 random one, whose corners scatter over 16 rows a warp
// (experiments/resample_sweep.py, device time).
//
// Design. A CTA owns a tile of kRows y rows by kLanes z lanes (one warp a
// row) and walks a chunk of x planes: a thread's (y, z) is fixed and each x
// step adds a plane stride, so no voxel divides (the first port spent three
// 32-bit divisions a voxel). The chunk length makes the grid one wave of CTAs
// on the current device (occupancy.cuh), at least kMinXChunk planes. Per
// voxel:
// - The warp streams are read evict-first (__ldcs) and the output stored so
//   (__stcs); the corner gathers go through __ldg and L1.
// - One in-volume test: when 0 <= base <= ext - 2 in x and y, the eight
//   corners are loads at constant offsets from one pointer {0, 1, nz, nz+1,
//   P, P+1, P+nz, P+nz+1} (P = ny nz), each z corner selecting +1 where it
//   falls outside; otherwise each corner is tested and reads +1 outside. Both
//   paths sum the same products in the same order.
// - Offsets are 32-bit when the volume has fewer than 2^31 voxels, else
//   64-bit (a second instantiation); the first port's were all 64-bit.
// Neighbouring lanes take neighbouring z, so a warp's gathers of one corner
// span one or two 128-byte lines on a smooth warp. A layout of 4 z a lane
// with 16-byte stream loads measured slower on both warps: its lanes' gathers
// lie 16 bytes apart, and passing the streams through shared memory to
// restore the lane order cost L1 room (PERF.md).
// The float steps are the golden op's: pos = float(i) + u, floor, frac =
// pos - floor, weights multiplied x, y, z left to right, corners summed in
// itertools.product order. The _rn intrinsics keep nvcc from contracting
// them into FMAs, so the result equals the plain torch version bit for bit.
//
// A haloed block (the sharded solvers). The live field may hold more x
// rows than the warp: output row i samples live(x_start + i + ux, y + uy,
// z + uz), +1 outside the field's fx rows. This is the golden gather of
// levelsetfusion_tpu/parallel/sharded.py on a block with its live halo, not
// the TPU kernel's x_start over a +-K clamp window. With x_start = 0 and
// fx = nx it is the whole-volume call above, float for float.
//
// Measured at 128^3 (NVIDIA H100 80GB HBM3, 700.00 W): 18.6-18.7 us a call
// by CUDA events on bench's +-2 random warp (the first port: 31.8-32.5),
// 14.4-14.6 us an iteration inside the config3 solve (torch.profiler;
// 29.5-29.7), 32 registers, no spills; grid_sample takes 46.4-46.5 us for
// the same values.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstdlib>

#include "occupancy.cuh"

namespace {

constexpr int kLanes = 32;  // z lanes of a CTA: one warp along z
constexpr int kRows = 8;    // y rows of a CTA
constexpr int kThreads = kLanes * kRows;
constexpr int kMinXChunk = 2;
constexpr int64_t kMaxGridYZ = 65535;  // gridDim.y and gridDim.z

// The warp components are read once and the output written once.
template <typename T>
__device__ __forceinline__ T load_stream(const T* p) {
  return __ldcs(p);
}

template <typename T>
__device__ __forceinline__ void store_stream(T* p, T v) {
  __stcs(p, v);
}

// live at (px, py, pz), trilinear, +1 outside. Off is the offset type.
template <typename Off>
__device__ __forceinline__ float sample(const float* __restrict__ live, float px, float py,
                                        float pz, int nx, int ny, int nz, Off plane) {
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  const float x1 = __fsub_rn(px, fx), y1 = __fsub_rn(py, fy), z1 = __fsub_rn(pz, fz);
  const float x0 = __fsub_rn(1.0f, x1), y0 = __fsub_rn(1.0f, y1), z0 = __fsub_rn(1.0f, z1);
  const float w00 = __fmul_rn(x0, y0), w01 = __fmul_rn(x0, y1);
  const float w10 = __fmul_rn(x1, y0), w11 = __fmul_rn(x1, y1);
  const float w[8] = {__fmul_rn(w00, z0), __fmul_rn(w00, z1), __fmul_rn(w01, z0),
                      __fmul_rn(w01, z1), __fmul_rn(w10, z0), __fmul_rn(w10, z1),
                      __fmul_rn(w11, z0), __fmul_rn(w11, z1)};
  // Saturating conversions: a base past int's range is outside either way.
  const int bx = __float2int_rz(fx), by = __float2int_rz(fy), bz = __float2int_rz(fz);
  float r[8];
  // x and y inside: the corners lie at constant offsets from one pointer,
  // and each z corner reads +1 where it falls outside. Every warp meets the
  // z faces (z is the lane axis), so z takes selects, not the branch.
  const bool interior = (unsigned)bx < (unsigned)(nx - 1) && (unsigned)by < (unsigned)(ny - 1);
  if (interior) {
    const bool in0 = (unsigned)bz < (unsigned)nz, in1 = (unsigned)bz + 1u < (unsigned)nz;
    const float* p = live + ((Off)bx * plane + (Off)by * (Off)nz) + min(max(bz, -1), nz);
    r[0] = in0 ? __ldg(p) : 1.0f;
    r[1] = in1 ? __ldg(p + 1) : 1.0f;
    r[2] = in0 ? __ldg(p + nz) : 1.0f;
    r[3] = in1 ? __ldg(p + nz + 1) : 1.0f;
    p += plane;
    r[4] = in0 ? __ldg(p) : 1.0f;
    r[5] = in1 ? __ldg(p + 1) : 1.0f;
    r[6] = in0 ? __ldg(p + nz) : 1.0f;
    r[7] = in1 ? __ldg(p + nz + 1) : 1.0f;
  } else {
    // Unsigned: base + 1 wraps instead of overflowing, and a negative index
    // compares as out of range.
    const unsigned ix[2] = {(unsigned)bx, (unsigned)bx + 1u};
    const unsigned iy[2] = {(unsigned)by, (unsigned)by + 1u};
    const unsigned iz[2] = {(unsigned)bz, (unsigned)bz + 1u};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const unsigned cx = ix[c >> 2], cy = iy[(c >> 1) & 1], cz = iz[c & 1];
      const bool inb = cx < (unsigned)nx && cy < (unsigned)ny && cz < (unsigned)nz;
      r[c] = inb ? __ldg(live + ((Off)cx * plane + (Off)cy * (Off)nz + (Off)cz)) : 1.0f;
    }
  }
  float acc = __fmul_rn(w[0], r[0]);
#pragma unroll
  for (int c = 1; c < 8; ++c) acc = __fadd_rn(acc, __fmul_rn(w[c], r[c]));
  return acc;
}

// Grid: (z tiles, y tiles (a loop past kMaxGridYZ), x chunks of `chunk`
// planes); a warp holds kLanes neighbouring z of one y row.
template <typename Off>
__global__ void __launch_bounds__(kThreads)
    warp_field_cm_kernel(const float* __restrict__ live, const float* __restrict__ ux,
                         const float* __restrict__ uy, const float* __restrict__ uz,
                         float* __restrict__ out, int nx, int ny, int nz, int fx,
                         int x_start, int tiles_y, int chunk,
                         const unsigned char* __restrict__ active) {
  // A solve whose done flag is set (active reads 0) skips the call: the
  // frozen iterations of a captured chunk cost one launch and one load.
  if (active != nullptr && *active == 0) return;
  const int z = blockIdx.x * kLanes + threadIdx.x;
  if (z >= nz) return;
  const int x_begin = blockIdx.z * chunk, x_end = min(x_begin + chunk, nx);
  const Off plane = (Off)ny * (Off)nz;
  const float fz = (float)z;
  for (int tile = blockIdx.y; tile < tiles_y; tile += gridDim.y) {
    const int y = tile * kRows + threadIdx.y;
    if (y >= ny) break;
    const float fy = (float)y;
    Off v = (Off)x_begin * plane + (Off)y * (Off)nz + (Off)z;
    for (int x = x_begin; x < x_end; ++x, v += plane) {
      store_stream(out + v,
                   sample<Off>(live, __fadd_rn((float)(x + x_start), load_stream(ux + v)),
                               __fadd_rn(fy, load_stream(uy + v)),
                               __fadd_rn(fz, load_stream(uz + v)), fx, ny, nz, plane));
    }
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename Off>
int launch(const float* live, const float* warp_cm, float* out, int nx, int ny, int nz, int fx,
           int x_start, const unsigned char* active, cudaStream_t stream) {
  static lsf_occ::WaveCache cache;
  const auto kernel = warp_field_cm_kernel<Off>;
  const int wave = lsf_occ::wave((const void*)kernel, kThreads, 0, cache);
  if (wave < 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const int64_t n = (int64_t)nx * ny * nz;
  const int64_t tiles_z = ceil_div(nz, kLanes), tiles_y = ceil_div(ny, kRows);
  // x chunks for about one wave of CTAs over the (y, z) tiles.
  int64_t chunk = std::max<int64_t>(kMinXChunk, ceil_div(nx * tiles_z * tiles_y, wave));
  chunk = std::max(chunk, ceil_div(nx, kMaxGridYZ));
  const dim3 grid((unsigned)tiles_z, (unsigned)std::min(tiles_y, kMaxGridYZ),
                  (unsigned)ceil_div(nx, chunk));
  kernel<<<grid, dim3(kLanes, kRows), 0, stream>>>(live, warp_cm, warp_cm + n, warp_cm + 2 * n,
                                                    out, nx, ny, nz, fx, x_start, (int)tiles_y,
                                                    (int)chunk, active);
  return (int)cudaGetLastError();
}

}  // namespace

// live (fx, ny, nz), warp_cm (3, nx, ny, nz), out (nx, ny, nz): float32
// device pointers; output row i samples live row x_start + i + ux
// (|x_start| + nx below 2^24, so that x_start + i is exact in float). active:
// null, or a device byte that, when 0, makes the call leave out unwritten.
// Returns a cudaError_t.
extern "C" int lsf_warp_field_cm(const float* live, const float* warp_cm, float* out, int nx,
                                 int ny, int nz, int fx, int x_start,
                                 const unsigned char* active, void* stream) {
  constexpr int kExact = 1 << 24;
  if (nx < 1 || ny < 1 || nz < 1 || fx < 1 || !live || !warp_cm || !out ||
      std::abs((int64_t)x_start) + nx >= kExact)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int64_t)std::max(nx, fx) * ny * nz < ((int64_t)1 << 31)
             ? launch<uint32_t>(live, warp_cm, out, nx, ny, nz, fx, x_start, active, s)
             : launch<uint64_t>(live, warp_cm, out, nx, ny, nz, fx, x_start, active, s);
}

extern "C" const char* lsf_resample_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
