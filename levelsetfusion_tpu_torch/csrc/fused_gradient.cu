// One solver step after the resample: energy-term gradients, optional Sobolev
// filter, warp update, and the step's energies and update statistics.
//
// Replaces the TPU kernel levelsetfusion_tpu/ops/pallas/fused_gradient.py::
// fused_gradient_update (lowerings _fused_kernel, _fused_kernel_tiled,
// _fused_kernel_reuse, _fused_kernel_tiled_reuse over the shared math of
// _make_derivs, _assemble_terms, _conv_x_staged and _conv_lane).
//
//   g     = w_data (Phi_w - Phi_c) grad Phi_w              (band-union masked)
//         + w_smooth (-lap u)                                   Tikhonov, or
//         + w_smooth (-(1+gamma) lap u - grad div u)            Killing
//         + w_ls (|grad Phi_w| - 1)/(|grad Phi_w| + 1e-5) H(Phi_w) grad Phi_w
//   g     = Sobolev(g)            separable, zero-padded
//   u'    = u - rate g
//   stats = [E_data, E_smooth, E_ls, sum|du|, max|du|, max|u'_x|, max|u'_y|,
//            max|u'_z|]          (the order of FusedStats in the TPU module)
//
// The edge conventions are the golden ones (levelsetfusion_tpu/ops/
// derivatives.py): np.gradient one-sided edges, replicated-edge Laplacian,
// and the Hessian rows and grad(div u) as np.gradient of np.gradient. They
// apply at the faces of the volume only, never at the edge of a tile.
//
// The x window (the sharded solvers' haloed blocks; the TPU kernel's
// x_offset, x_global, x_lo and x_len): input row q is global row x_offset +
// q of a volume of x_global rows, and the call updates input rows [x_lo,
// x_lo + x_len) only: u' has x_len rows, and the energies and statistics
// sum over them. The x face rules fire at global rows 0 and x_global - 1,
// the Sobolev x pass zero-pads beyond them, and input rows beyond them are
// never read, so a block's ghost values there cannot change the result.
// terms_kernel computes g on rows [x_lo - R, x_lo + x_len + R) inside the
// volume (R the filter's radius) and reads the inputs 2 rows beyond that.
// x_offset = x_lo = 0, x_len = x_global = X is the whole-volume call.
//
// The y window (the 2D-mesh solvers' blocks; y_offset, y_global, y_lo,
// y_len) is the same along the columns: input column c is global column
// y_offset + c of y_global, u' has y_len columns, the y face rules fire at
// the global columns only, the y pass zero-pads beyond them, and
// terms_kernel computes g on columns [y_lo - R, y_lo + y_len + R) inside
// the volume. conv_local_x (the Schur solvers' block-local filter): the x
// pass reads g as zero outside the window's rows, so terms_kernel computes
// g on the window's rows only and the input needs 2 halo rows, not 2 + R.
//
// What bounds it on the H100: the function reads Phi_w, Phi_c and u (5
// volumes) and writes u' (3): 67 MB at 128^3, 20 us at 3.35 TB/s. The TPU
// design does it all in one pass over haloed windows; here the only volume
// between the two kernels is g (3 volumes), and nothing else (grad Phi_w,
// div u, the filter's intermediates) reaches device memory. What bounds the
// kernels themselves is instructions and their latency, not bytes: the
// stencils, the Hessian rows, grad div and the three filter passes, with
// 16-24 warps an SM. Without their staging copies the kernels keep 93% (terms)
// and 95% (update) of their time, without their stores 92% and 99%; more
// planes in flight or fewer, longer CTAs make them slower
// (experiments/fused_gradient_sweep.py; PERF.md).
//
//   terms_kernel: a CTA owns kTY x kTZ (y, z) columns and walks a chunk of
//     x. A 6-slot cp.async ring holds the planes a-3 .. a+2 of Phi_w, u0, u1
//     and u2 with a halo of 2 in y and 4 in z (rows start on 16 bytes, so
//     they arrive in 16-byte copies when Z is a multiple of 4). Step a
//     computes grad Phi_w and div u of plane a, on the tile with a halo of 1,
//     into a 4-slot ring, and the terms of plane a - 2: the Jacobian and the
//     Laplacian from the input ring, the Hessian rows d_j(d_i Phi_w) and
//     grad(div u) from the derivative ring. The two halves read only what
//     earlier steps wrote, so a step needs one barrier. A warp holds 4 y rows
//     of 8 z; a warp whose voxels all lie inside the faces takes the
//     stencils without the edge selects. Phi_c is read a plane ahead into a
//     register. Writes g and one row of energy partials per CTA.
//   sobolev_update_kernel<R>: a CTA owns kSY x kSZ columns and walks a chunk
//     of x, a thread two neighbouring z of one row. Each plane of g arrives
//     with a halo of R in y and R rounded up to 4 in z, zeros outside the
//     volume (a 3-slot cp.async ring, two planes in flight). Step q filters
//     plane q + 1 along z (4 outputs an item) into one of two shared
//     buffers and plane q along y from the other, so again one barrier a
//     step; the x filter is 2R + 1 running sums in registers, to which each
//     plane adds its tap. Then u' = u - rate g (u read a plane ahead) and
//     the update statistics in registers. R = 0 (no filter) reads g
//     directly.
//   The last CTA of the second kernel to finish (an atomic ticket after a
//   __threadfence) folds both kernels' partial rows into stats[8] in double
//   and resets the ticket: no third launch. Calls in flight at once must
//   hold distinct tickets; calls on one stream run in order, so the wrapper
//   keeps one ticket per stream.
// The filter runs z, y, x where the reference runs x, y, z: the same sums
// in another order. Each kernel's x chunks fill one wave of CTAs (the
// occupancy the CUDA runtime reports for the current device), at least
// kMinXChunk planes each. A
// thread's staging offsets within a plane are computed once per CTA in 32
// bits, a plane's base once per plane in 64; the entry point refuses planes
// of 2^31 voxels or more. The learning rate is read from device memory, so
// an adaptive rate never synchronises with the host.
//
// Measured at 128^3, config3's energy with the 7-tap filter, NVIDIA H100
// 80GB HBM3, 700.00 W (torch.profiler): terms_kernel 66.2-66.6 us (80
// registers), sobolev_update_kernel<3> 42.4 us (121 registers), no spills;
// one call 112.6-113.0 us by CUDA events, 750.8-752.2 us at 256^3. The first
// port's seven streaming passes took 409.0 us at 128^3.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "cp_async.cuh"
#include "occupancy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 15;
constexpr int kMaxRadius = kMaxTaps / 2;
// |Phi| < 1 - 1e-5, with the bound rounded to f32 as the reference compares.
constexpr float kBand = 0.99999f;
constexpr float kLsEps = 1e-5f;
constexpr int kMinXChunk = 16;
constexpr int kTermCols = 3;    // doubles per terms_kernel partial row
constexpr int kUpdateCols = 5;  // doubles per sobolev_update_kernel partial row

// terms_kernel: one voxel per thread per plane; a warp holds 4 y rows of 8
// z, so few warps touch a face of the volume.
constexpr int kTY = 8, kTZ = 32, kWarpY = 4, kWarpZ = 8;
static_assert(kTY * kTZ == kThreads && kWarpY * kWarpZ == 32, "one voxel per thread");
// Input tile: halo 2 in y; in z, 4 on each side so that rows start on 16
// bytes (z0 - 4 .. z0 + 35). Rows of 40 floats lie 8 banks apart, so a
// warp's 4 x 8 reads hit 32 banks; the derivative tile (halo 1) keeps the
// same row length.
constexpr int kIY = kTY + 4, kIZ0 = 4, kIZ = kTZ + 2 * kIZ0;
constexpr int kDY = kTY + 2, kDW = kTZ + 2, kDZ = kIZ;
constexpr int kIPlane = kIY * kIZ, kDPlane = kDY * kDZ;
static_assert(kIZ % 32 == 8, "rows 8 banks apart");
constexpr int kAhead = 1;             // input planes in flight during a step
constexpr int kInSlots = 5 + kAhead;  // input planes a-3 .. a+1 in use at step a
constexpr int kDerivSlots = 4;        // derivative planes a-3 .. a
constexpr int kInPerThread = (kIPlane + kThreads - 1) / kThreads;  // 4-byte copies
static_assert(kIPlane / 4 <= kThreads, "one 16-byte copy per thread and field");
constexpr int kDPerThread = (kDY * kDW + kThreads - 1) / kThreads;
constexpr int kTermsSmem =
    (kInSlots * 4 * kIPlane + kDerivSlots * 4 * kDPlane) * (int)sizeof(float);

// sobolev_update_kernel: kVec neighbouring z of one y row per thread (the
// y pass reads them as one float2).
constexpr int kVec = 2;
constexpr int kSZ = 32, kLanesZ = kSZ / kVec, kSY = kThreads / kLanesZ;

struct Dims {
  int nx, ny, nz, plane;
  int64_t n;
  // The x window: input row q is global row q + x_off of x_global; input
  // rows [q_lo, q_hi) lie inside the volume, and [w_lo, w_lo + w_len) are
  // the rows this call updates.
  int x_off, x_global, q_lo, q_hi, w_lo, w_len;
  // The y window, the same along the columns: [p_lo, p_hi) inside the
  // volume, [w_ylo, w_ylo + w_ylen) updated.
  int y_off, y_global, p_lo, p_hi, w_ylo, w_ylen;
  // The rows the filter's x pass reads g from ([q_lo, q_hi), or the
  // window's under conv_local_x); the output's plane, w_ylen * nz, and its
  // n_out = w_len * out_plane voxels.
  int c_lo, c_hi, out_plane;
  int64_t n_out;
};

struct TermParams {
  float w_data, w_smooth, w_ls, gamma;
  int killing, band_union;
};

// Taps stored reversed (w[t] = taps[n-1-t]); every loop over them is
// unrolled, so they are indexed statically and stay in the parameter space.
struct Taps {
  float w[kMaxTaps];
};

// A kernel's grid: tiles of the (y, z) columns [y_begin, y_end) x [0, nz)
// times chunks of the x rows [x_begin, x_end).
struct Plan {
  int tiles_z, tiles_yz, xchunk, blocks, x_begin, x_end, y_begin, y_end;
};

struct Tile {
  int x0, x1, y0, z0;
};

// The call's arguments: the input's extents and both windows.
struct Args {
  int nx, ny, nz, ntaps, x_off, x_global, x_lo, x_len, y_off, y_global, y_lo, y_len,
      conv_local_x;
};

Dims dims(const Args& a) {
  Dims d{a.nx, a.ny, a.nz, a.ny * a.nz, (int64_t)a.nx * a.ny * a.nz};
  d.x_off = a.x_off;
  d.x_global = a.x_global;
  d.q_lo = std::max(0, -a.x_off);
  d.q_hi = std::min(a.nx, a.x_global - a.x_off);
  d.w_lo = a.x_lo;
  d.w_len = a.x_len;
  d.y_off = a.y_off;
  d.y_global = a.y_global;
  d.p_lo = std::max(0, -a.y_off);
  d.p_hi = std::min(a.ny, a.y_global - a.y_off);
  d.w_ylo = a.y_lo;
  d.w_ylen = a.y_len;
  d.c_lo = a.conv_local_x ? a.x_lo : d.q_lo;
  d.c_hi = a.conv_local_x ? a.x_lo + a.x_len : d.q_hi;
  d.out_plane = a.y_len * a.nz;
  d.n_out = (int64_t)a.x_len * d.out_plane;
  return d;
}

// As many chunks of the rows [x_begin, x_end) as fill one wave of `wave`
// CTAs, each of at least kMinXChunk planes, over the columns [y_begin,
// y_end).
Plan plan(const Dims& d, int x_begin, int x_end, int y_begin, int y_end, int ty, int tz,
          int wave) {
  Plan p;
  const int rows = x_end - x_begin;
  p.x_begin = x_begin;
  p.x_end = x_end;
  p.y_begin = y_begin;
  p.y_end = y_end;
  p.tiles_z = (d.nz + tz - 1) / tz;
  p.tiles_yz = p.tiles_z * ((y_end - y_begin + ty - 1) / ty);
  int chunks = wave / p.tiles_yz;
  const int most = (rows + kMinXChunk - 1) / kMinXChunk;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  p.xchunk = (rows + chunks - 1) / chunks;
  p.blocks = p.tiles_yz * ((rows + p.xchunk - 1) / p.xchunk);
  return p;
}

// terms_kernel's grid: g on the window's rows and columns with the filter's
// radius around them (along x none under conv_local_x), inside the volume.
Plan terms_plan(const Dims& d, int radius, int wave) {
  return plan(d, std::max(d.w_lo - radius, d.c_lo), std::min(d.w_lo + d.w_len + radius, d.c_hi),
              std::max(d.w_ylo - radius, d.p_lo),
              std::min(d.w_ylo + d.w_ylen + radius, d.p_hi), kTY, kTZ, wave);
}

// sobolev_update_kernel's grid: the window.
Plan update_plan(const Dims& d, int wave) {
  return plan(d, d.w_lo, d.w_lo + d.w_len, d.w_ylo, d.w_ylo + d.w_ylen, kSY, kSZ, wave);
}

__device__ __forceinline__ Tile tile_of(const Plan& p, int ty, int tz) {
  const int t = blockIdx.x % p.tiles_yz, c = blockIdx.x / p.tiles_yz;
  Tile r;
  r.y0 = p.y_begin + (t / p.tiles_z) * ty;
  r.z0 = (t % p.tiles_z) * tz;
  r.x0 = p.x_begin + c * p.xchunk;
  r.x1 = min(r.x0 + p.xchunk, p.x_end);
  return r;
}

// A compile-time choice between the stencils with the volume's edge rules
// and those of the interior (where the two give the same floats).
template <bool B>
struct Edge {
  static constexpr bool value = B;
};

// np.gradient at coordinate i of extent n from the values at i-1, i, i+1
// (a value outside the volume is never used). Selects, not branches: with
// branches nvcc moves the shared-memory reads of the three values into them
// and reads them one after another.
template <bool kEdge>
__device__ __forceinline__ float dnp3(float m, float c, float p, int i, int n) {
  if (!kEdge) return (p - m) * 0.5f;
  const bool lo = i == 0, hi = i == n - 1;
  const float d = ((hi ? c : p) - (lo ? c : m)) * (lo || hi ? 1.0f : 0.5f);
  return n < 2 ? 0.0f : d;
}

// 1-(-2)-1 second difference, replicated edges.
template <bool kEdge>
__device__ __forceinline__ float d2rep3(float m, float c, float p, int i, int n) {
  const float pp = !kEdge || i < n - 1 ? p : c;
  const float mm = !kEdge || i > 0 ? m : c;
  return (pp - 2.0f * c) + mm;
}

// Whether i is at least one away from both ends of [0, n).
__device__ __forceinline__ bool inner(int i, int n) { return i >= 1 && i <= n - 2; }

// Max that propagates NaN, like the reference's reductions.
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// Reduces K values over the block; the result is valid on thread 0.
template <int K, bool kMax>
__device__ void block_reduce(double (&vals)[K]) {
  __shared__ double sh[K][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double x = vals[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const double y = __shfl_down_sync(0xffffffffu, x, o);
      x = kMax ? nanmax(x, y) : x + y;
    }
    if (lane == 0) sh[k][warp] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      double x = sh[k][0];
      for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
        x = kMax ? nanmax(x, sh[k][w]) : x + sh[k][w];
      vals[k] = x;
    }
  }
  __syncthreads();
}

// Three CTAs per SM: the registers of the body are capped at 85 (uncapped
// it takes 98 and two CTAs per SM, and runs slower; PERF.md).
__global__ void __launch_bounds__(kThreads, 3)
    terms_kernel(const float* __restrict__ w, const float* __restrict__ cn,
                 const float* __restrict__ u, float* __restrict__ g,
                 double* __restrict__ partial, Dims d, TermParams p, Plan pl,
                 const unsigned char* __restrict__ active) {
  if (active != nullptr && *active == 0) return;  // a frozen iteration of the solve
  extern __shared__ float smem[];
  float* const in = smem;                           // [slot][Phi_w, u0, u1, u2][kIPlane]
  float* const dv = smem + kInSlots * 4 * kIPlane;  // [slot][gw0, gw1, gw2, div][kDPlane]
  const int tid = threadIdx.x;
  const Tile tl = tile_of(pl, kTY, kTZ);
  const bool need_u = p.w_smooth != 0.0f;
  const bool need_div = need_u && p.killing;

  // This thread's staging copies: shared index and in-plane offset in the
  // volume (-1 outside it: those slots are never read). Where z is a
  // multiple of 4, a row is 10 copies of 16 bytes, each inside the volume or
  // outside it; else 40 of 4.
  const bool vec = d.nz % 4 == 0;
  const int per_row = vec ? kIZ / 4 : kIZ, width = vec ? 4 : 1;
  int in_sm[kInPerThread], in_off[kInPerThread];
#pragma unroll
  for (int k = 0; k < kInPerThread; ++k) {
    const int i = tid + k * kThreads, iy = i / per_row, iz = i % per_row * width;
    const int y = tl.y0 - 2 + iy, z = tl.z0 - kIZ0 + iz;
    in_sm[k] = iy * kIZ + iz;
    in_off[k] = (iy < kIY && y >= d.p_lo && y < d.p_hi && z >= 0 && z < d.nz) ? y * d.nz + z
                                                                            : -1;
  }
  // Its derivative positions: shared index, global column and z (column -1
  // outside the volume), and whether its warp's positions are all inside the
  // faces.
  int d_sm[kDPerThread], d_y[kDPerThread], d_z[kDPerThread];
  bool d_inner[kDPerThread];
#pragma unroll
  for (int k = 0; k < kDPerThread; ++k) {
    const int i = tid + k * kThreads, dy = i / kDW, dz = i % kDW;
    d_sm[k] = dy * kDZ + dz;
    const int y = tl.y0 - 1 + dy;
    d_y[k] = y + d.y_off;
    d_z[k] = tl.z0 - 1 + dz;
    if (i >= kDY * kDW || y < d.p_lo || y >= d.p_hi || d_z[k] < 0 || d_z[k] >= d.nz)
      d_y[k] = -1;
    d_inner[k] = __all_sync(0xffffffffu, d_y[k] >= 0 && inner(d_y[k], d.y_global) &&
                                             inner(d_z[k], d.nz));
  }
  // Its voxel (gy: its global column), and whether its warp's voxels are all
  // inside the faces.
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = warp / (kTZ / kWarpZ) * kWarpY + lane / kWarpZ;
  const int tz = warp % (kTZ / kWarpZ) * kWarpZ + lane % kWarpZ;
  const int vy = tl.y0 + ty, vz = tl.z0 + tz, gy = vy + d.y_off;
  const bool v_ok = vy < pl.y_end && vz < d.nz;
  const bool v_inner =
      __all_sync(0xffffffffu, v_ok && inner(gy, d.y_global) && inner(vz, d.nz));
  // Whether its column is the window's (the energies').
  const bool y_counted = vy >= d.w_ylo && vy < d.w_ylo + d.w_ylen;
  const int ii = (ty + 2) * kIZ + tz + kIZ0, di = (ty + 1) * kDZ + tz + 1;
  const int v_off = vy * d.nz + vz;

  const auto in_slot = [&](int q) { return in + (q + kInSlots) % kInSlots * 4 * kIPlane; };
  const auto dv_slot = [&](int q) { return dv + (q + kDerivSlots) % kDerivSlots * 4 * kDPlane; };
  const auto load = [&](int q) {
    if (q < d.q_lo || q >= d.q_hi) return;
    float* s = in_slot(q);
    const int64_t base = (int64_t)q * d.plane;
    const auto copy = [&](float* dst, const float* src) {
      if (vec)
        lsf_cp::cp_async16(dst, src);
      else
        lsf_cp::cp_async4_zfill(dst, src, true);
    };
#pragma unroll
    for (int k = 0; k < kInPerThread; ++k) {
      if (in_off[k] < 0) continue;
      const int64_t v = base + in_off[k];
      copy(s + in_sm[k], w + v);
      if (need_u) {
#pragma unroll
        for (int c = 0; c < 3; ++c) copy(s + (1 + c) * kIPlane + in_sm[k], u + c * d.n + v);
      }
    }
  };

  // grad Phi_w and div u of plane a at derivative position k.
  const auto derivs = [&](auto edge, int a, int k) {
    constexpr bool E = decltype(edge)::value;
    const float *m = in_slot(a - 1), *c = in_slot(a), *pp = in_slot(a + 1);
    float* out = dv_slot(a) + d_sm[k];
    const int j = d_sm[k] + kIZ + kIZ0 - 1, y = d_y[k], z = d_z[k];  // its input index
    const int ga = a + d.x_off;
    out[0] = dnp3<E>(m[j], c[j], pp[j], ga, d.x_global);
    out[kDPlane] = dnp3<E>(c[j - kIZ], c[j], c[j + kIZ], y, d.y_global);
    out[2 * kDPlane] = dnp3<E>(c[j - 1], c[j], c[j + 1], z, d.nz);
    if (need_div) {
      const int j0 = kIPlane + j, j1 = 2 * kIPlane + j, j2 = 3 * kIPlane + j;
      float s = dnp3<E>(m[j0], c[j0], pp[j0], ga, d.x_global);
      s = s + dnp3<E>(c[j1 - kIZ], c[j1], c[j1 + kIZ], y, d.y_global);
      s = s + dnp3<E>(c[j2 - 1], c[j2], c[j2 + 1], z, d.nz);
      out[3 * kDPlane] = s;
    }
  };

  double e[3] = {0.0, 0.0, 0.0};  // data, smoothing, level set (unweighted)
  // The terms of this thread's voxel in plane x.
  const auto terms = [&](auto edge, int x, float cv) {
    constexpr bool E = decltype(edge)::value;
    const float *m = in_slot(x - 1), *c = in_slot(x), *pp = in_slot(x + 1);
    const float *gm = dv_slot(x - 1), *gc = dv_slot(x), *gp = dv_slot(x + 1);
    const float wv = c[ii];
    const bool band = fabsf(cv) < kBand || fabsf(wv) < kBand;
    // Global row, and whether the voxel is the window's (the energies'):
    const int gx = x + d.x_off;
    const bool counted = y_counted && x >= d.w_lo && x < d.w_lo + d.w_len;
    float diff = wv - cv;
    if (p.band_union && !band) diff = 0.0f;
    float grad[3], total[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      grad[k] = gc[k * kDPlane + di];
      total[k] = p.w_data * (diff * grad[k]);
    }
    if (counted) e[0] += (double)(diff * diff);

    if (need_u) {
      float jac[3][3];  // jac[i][a] = d_a u_i
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int f = (1 + i) * kIPlane + ii;
        jac[i][0] = dnp3<E>(m[f], c[f], pp[f], gx, d.x_global);
        jac[i][1] = dnp3<E>(c[f - kIZ], c[f], c[f + kIZ], gy, d.y_global);
        jac[i][2] = dnp3<E>(c[f - 1], c[f], c[f + 1], vz, d.nz);
      }
      float sq = 0.0f, cross = 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          sq += jac[i][j] * jac[i][j];
          cross += jac[i][j] * jac[j][i];
        }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int f = (1 + k) * kIPlane + ii;
        float lap = d2rep3<E>(m[f], c[f], pp[f], gx, d.x_global);
        lap = lap + d2rep3<E>(c[f - kIZ], c[f], c[f + kIZ], gy, d.y_global);
        lap = lap + d2rep3<E>(c[f - 1], c[f], c[f + 1], vz, d.nz);
        float gs = -lap;
        if (p.killing) {
          const int q = 3 * kDPlane + di;
          const float gd = k == 0   ? dnp3<E>(gm[q], gc[q], gp[q], gx, d.x_global)
                           : k == 1 ? dnp3<E>(gc[q - kDZ], gc[q], gc[q + kDZ], gy, d.y_global)
                                    : dnp3<E>(gc[q - 1], gc[q], gc[q + 1], vz, d.nz);
          gs = -(1.0f + p.gamma) * lap - gd;
        }
        total[k] = total[k] + p.w_smooth * gs;
      }
      // 1/2 |J + J^T|^2 = |J|^2 + sum_ij J_ij J_ji
      if (counted) e[1] += p.killing ? (double)((1.0f + p.gamma) * sq + cross) : (double)sq;
    }

    if (p.w_ls != 0.0f) {
      const float norm = sqrtf(grad[0] * grad[0] + grad[1] * grad[1] + grad[2] * grad[2]);
      float scale = (norm - 1.0f) / (norm + kLsEps);
      float el = (norm - 1.0f) * (norm - 1.0f);
      if (p.band_union && !band) {
        scale = 0.0f;
        el = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        // Row i of the Hessian dotted with grad Phi_w.
        const int q = i * kDPlane + di;
        float hg = 0.0f;
        hg += dnp3<E>(gm[q], gc[q], gp[q], gx, d.x_global) * grad[0];
        hg += dnp3<E>(gc[q - kDZ], gc[q], gc[q + kDZ], gy, d.y_global) * grad[1];
        hg += dnp3<E>(gc[q - 1], gc[q], gc[q + 1], vz, d.nz) * grad[2];
        total[i] = total[i] + p.w_ls * (scale * hg);
      }
      if (counted) e[2] += (double)el;
    }
    const int64_t v = (int64_t)x * d.plane + v_off;
#pragma unroll
    for (int k = 0; k < 3; ++k) g[k * d.n + v] = total[k];
  };

  for (int q = tl.x0 - 2; q < tl.x0 + kAhead; ++q) {
    load(q);
    lsf_cp::cp_async_commit();
  }
  // Phi_c of this thread's voxel one plane ahead.
  float cv_next = v_ok ? __ldg(cn + (int64_t)tl.x0 * d.plane + v_off) : 0.0f;
  // Step a: the derivatives of plane a and the terms of plane a - 2, which
  // read only what earlier steps wrote, so one barrier a step. A warp whose
  // positions all lie inside the faces takes the stencils without edge rules.
  for (int a = tl.x0 - 1; a <= tl.x1 + 1; ++a) {
    lsf_cp::cp_async_wait<kAhead - 1>();  // plane a + 1 has landed
    __syncthreads();  // for every thread, and every read of the slots reused below is done
    if (a + 1 + kAhead <= tl.x1 + 1) load(a + 1 + kAhead);
    lsf_cp::cp_async_commit();
    if (a <= tl.x1 && a >= d.q_lo && a < d.q_hi) {
      const bool a_inner = inner(a + d.x_off, d.x_global);
#pragma unroll
      for (int k = 0; k < kDPerThread; ++k) {
        if (d_y[k] < 0) continue;
        if (a_inner && d_inner[k])
          derivs(Edge<false>(), a, k);
        else
          derivs(Edge<true>(), a, k);
      }
    }
    const int x = a - 2;
    const float cv = cv_next;
    if (x >= tl.x0 && x + 1 < tl.x1 && v_ok)
      cv_next = __ldg(cn + (int64_t)(x + 1) * d.plane + v_off);
    if (x >= tl.x0 && v_ok) {
      if (v_inner && inner(x + d.x_off, d.x_global))
        terms(Edge<false>(), x, cv);
      else
        terms(Edge<true>(), x, cv);
    }
  }
  block_reduce<3, false>(e);
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) partial[(int64_t)blockIdx.x * kTermCols + k] = e[k];
  }
}

// The last CTA's fold of every partial row into stats[8].
__device__ void fold_partials(const double* partial, int term_rows, int update_rows,
                              float* stats, float w_data, float w_smooth, float w_ls) {
  double sum[4] = {0.0, 0.0, 0.0, 0.0};
  double mx[4] = {0.0, 0.0, 0.0, 0.0};
  for (int b = threadIdx.x; b < term_rows; b += blockDim.x) {
#pragma unroll
    for (int k = 0; k < 3; ++k) sum[k] += __ldcg(partial + (int64_t)b * kTermCols + k);
  }
  const double* rows = partial + (int64_t)term_rows * kTermCols;
  for (int b = threadIdx.x; b < update_rows; b += blockDim.x) {
    const double* row = rows + (int64_t)b * kUpdateCols;
    sum[3] += __ldcg(row);
#pragma unroll
    for (int k = 0; k < 4; ++k) mx[k] = nanmax(mx[k], __ldcg(row + 1 + k));
  }
  block_reduce<4, false>(sum);
  block_reduce<4, true>(mx);
  if (threadIdx.x == 0) {
    stats[0] = (float)((double)w_data * 0.5 * sum[0]);
    stats[1] = (float)((double)w_smooth * 0.5 * sum[1]);
    stats[2] = (float)((double)w_ls * 0.5 * sum[2]);
    stats[3] = (float)sum[3];
#pragma unroll
    for (int k = 0; k < 4; ++k) stats[4 + k] = (float)mx[k];
  }
}

constexpr int kGSlots = 3;  // input planes q+1 .. q+3 of step q, two in flight

// The z halo of the update kernel's input tile: R rounded up to 4, so that
// its rows start on 16 bytes.
template <int R>
__host__ __device__ constexpr int halo4() {
  return (R + 3) / 4 * 4;
}

template <int R>
constexpr int update_smem_bytes() {
  return R == 0 ? 0
                : (kGSlots * 3 * (kSY + 2 * R) * (kSZ + 2 * halo4<R>()) +
                   2 * 3 * (kSY + 2 * R) * kSZ) *
                      (int)sizeof(float);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    sobolev_update_kernel(const float* __restrict__ g, const float* __restrict__ u,
                          const float* __restrict__ rate, float* __restrict__ new_u,
                          double* __restrict__ partial, int term_rows,
                          unsigned* __restrict__ ticket, float* __restrict__ stats,
                          Dims d, Plan pl, Taps taps, float w_data, float w_smooth,
                          float w_ls, const unsigned char* __restrict__ active) {
  // Every CTA of both kernels returns, so the ticket stays 0.
  if (active != nullptr && *active == 0) return;
  constexpr int K = 2 * R + 1, H = halo4<R>();
  constexpr int IY = kSY + 2 * R, IZ = kSZ + 2 * H, IPlane = IY * IZ;
  constexpr int InPerThread = (IPlane + kThreads - 1) / kThreads;  // 4-byte copies
  extern __shared__ float smem[];
  float* const in = smem;  // [kGSlots][3][IY][IZ]: g, halo R in y and H in z
  float* const mid = in + kGSlots * 3 * IPlane;  // [2][3][IY][kSZ]: filtered along z
  const int tid = threadIdx.x, ty = tid / kLanesZ, tz = tid % kLanesZ * kVec;
  const Tile tl = tile_of(pl, kSY, kSZ);
  const int y = tl.y0 + ty, z = tl.z0 + tz;
  const bool y_ok = y < pl.y_end;  // a column of the window
  const float neg_rate = -__ldg(rate);
  double sum[1] = {0.0};
  float mx[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // max|du|, max|u'_0..2|

  // u at this thread's voxels of plane x (0 outside the window).
  const auto read_u = [&](int x, float (&uv)[3][kVec]) {
    const int64_t v0 = (int64_t)x * d.plane + y * d.nz + z;
#pragma unroll
    for (int e = 0; e < kVec; ++e)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        uv[k][e] = y_ok && z + e < d.nz ? u[k * d.n + v0 + e] : 0.0f;
  };
  // u' (its row x - w_lo, column y - w_ylo) and the statistics at this
  // thread's voxels of plane x.
  const auto update = [&](int x, const float (&gf)[3][kVec], const float (&uv)[3][kVec]) {
    if (!y_ok) return;
    const int64_t v0 = (int64_t)(x - d.w_lo) * d.out_plane + (y - d.w_ylo) * d.nz + z;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (z + e >= d.nz) break;
      float upd[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        upd[k] = neg_rate * gf[k][e];
        const float nu = uv[k][e] + upd[k];
        new_u[k * d.n_out + v0 + e] = nu;
        mx[1 + k] = nanmax(mx[1 + k], fabsf(nu));
      }
      const float ul = sqrtf(upd[0] * upd[0] + upd[1] * upd[1] + upd[2] * upd[2]);
      sum[0] += (double)ul;
      mx[0] = nanmax(mx[0], ul);
    }
  };

  if constexpr (R == 0) {
    for (int x = tl.x0; x < tl.x1; ++x) {
      float gf[3][kVec] = {}, uv[3][kVec];
      const int64_t v0 = (int64_t)x * d.plane + y * d.nz + z;
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (y_ok && z + e < d.nz) {
#pragma unroll
          for (int k = 0; k < 3; ++k) gf[k][e] = g[k * d.n + v0 + e];
        }
      read_u(x, uv);
      update(x, gf, uv);
    }
  } else {
    // Staging copies: shared index (-1: none) and in-plane offset (-1:
    // outside the volume, zero-filled; a column inside it lies in the
    // input). Where z is a multiple of 4 a row is IZ / 4 copies of 16 bytes,
    // each inside the volume or outside it; else IZ of 4.
    const bool vec = d.nz % 4 == 0;
    const int per_row = vec ? IZ / 4 : IZ, width = vec ? 4 : 1;
    int in_sm[InPerThread], in_off[InPerThread];
#pragma unroll
    for (int k = 0; k < InPerThread; ++k) {
      const int i = tid + k * kThreads, iy = i / per_row, iz = i % per_row * width;
      const int gy = tl.y0 - R + iy, gz = tl.z0 - H + iz;
      in_sm[k] = iy < IY ? iy * IZ + iz : -1;
      in_off[k] = gy >= d.p_lo && gy < d.p_hi && gz >= 0 && gz < d.nz ? gy * d.nz + gz : -1;
    }
    const int q0 = tl.x0 - R, q1 = tl.x1 + R;  // the input planes [q0, q1)
    // The planes the x pass reads (the others add 0): inside the volume, or
    // under conv_local_x the window's.
    const auto inside = [&](int q) { return q >= d.c_lo && q < d.c_hi; };
    const auto g_slot = [&](int q) { return in + (q - q0) % kGSlots * 3 * IPlane; };
    const auto load = [&](int q) {
      if (q >= q1 || !inside(q)) return;
      float* s = g_slot(q);
      const int64_t base = (int64_t)q * d.plane;
#pragma unroll
      for (int k = 0; k < InPerThread; ++k) {
        if (in_sm[k] < 0) continue;
        const bool ok = in_off[k] >= 0;
        const int64_t src = base + (ok ? in_off[k] : 0);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (vec)
            lsf_cp::cp_async16_zfill(s + c * IPlane + in_sm[k], g + c * d.n + src, ok);
          else
            lsf_cp::cp_async4_zfill(s + c * IPlane + in_sm[k], g + c * d.n + src, ok);
        }
      }
    };
    // Plane q along z, into mid slot (q - q0) & 1: an item is 4 outputs of
    // one row of one component, from 16-byte reads.
    const auto conv_z = [&](int q) {
      if (q >= q1 || !inside(q)) return;
      constexpr int kQuads = kSZ / 4, kReads = (2 * H + 4) / 4;
      const float* s = g_slot(q);
      float* m = mid + ((q - q0) & 1) * 3 * IY * kSZ;
      for (int it = tid; it < 3 * IY * kQuads; it += kThreads) {
        const int c = it / (IY * kQuads), rest = it - c * (IY * kQuads);
        const int iy = rest / kQuads, oz = rest % kQuads * 4;
        const float4* row = reinterpret_cast<const float4*>(s + c * IPlane + iy * IZ + oz);
        float v[4 * kReads];  // input columns oz .. oz + 4 kReads - 1
#pragma unroll
        for (int h = 0; h < kReads; ++h) {
          const float4 p4 = row[h];
          v[4 * h] = p4.x;
          v[4 * h + 1] = p4.y;
          v[4 * h + 2] = p4.z;
          v[4 * h + 3] = p4.w;
        }
        float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int t = 0; t < K; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] = o[e] + taps.w[t] * v[H - R + t + e];
        *reinterpret_cast<float4*>(m + (c * IY + iy) * kSZ + oz) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    };

    // acc[c][e][j]: the x filter's partial sum of plane x = q - R + j, to
    // which plane q adds its tap 2R - j; planes outside the volume add 0.
    float acc[3][kVec][K] = {};
    float uv[3][kVec];
    read_u(tl.x0, uv);
    for (int q = q0; q < q0 + kGSlots; ++q) {
      load(q);
      lsf_cp::cp_async_commit();
    }
    lsf_cp::cp_async_wait<kGSlots - 1>();
    __syncthreads();
    conv_z(q0);
    // Step q: plane q + 1 along z and plane q along y, which read only what
    // earlier steps wrote, so one barrier a step.
    for (int q = q0; q < q1; ++q) {
      lsf_cp::cp_async_wait<kGSlots - 2>();  // plane q + 1 has landed
      __syncthreads();  // for every thread, and plane q's slots are free
      load(q + kGSlots);
      lsf_cp::cp_async_commit();
      conv_z(q + 1);
      float f[3][kVec] = {};  // plane q filtered along z and y
      if (inside(q)) {
        const float* m = mid + ((q - q0) & 1) * 3 * IY * kSZ;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
#pragma unroll
          for (int t = 0; t < K; ++t) {
            const float2 m2 = *reinterpret_cast<const float2*>(m + (c * IY + ty + t) * kSZ + tz);
            f[c][0] = f[c][0] + taps.w[t] * m2.x;
            f[c][1] = f[c][1] + taps.w[t] * m2.y;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
#pragma unroll
          for (int j = 0; j < K; ++j) acc[c][e][j] = acc[c][e][j] + taps.w[2 * R - j] * f[c][e];
      const int x = q - R;
      if (x >= tl.x0) {
        float gf[3][kVec];
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int e = 0; e < kVec; ++e) gf[c][e] = acc[c][e][0];
        update(x, gf, uv);
        if (x + 1 < tl.x1) read_u(x + 1, uv);  // a plane ahead
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
#pragma unroll
          for (int j = 0; j + 1 < K; ++j) acc[c][e][j] = acc[c][e][j + 1];
          acc[c][e][K - 1] = 0.0f;
        }
    }
  }

  // A max of floats is a float, so the maxes are taken in float.
  double mxd[4] = {mx[0], mx[1], mx[2], mx[3]};
  block_reduce<1, false>(sum);
  block_reduce<4, true>(mxd);
  __shared__ bool last;
  if (tid == 0) {
    double* row = partial + (int64_t)term_rows * kTermCols + (int64_t)blockIdx.x * kUpdateCols;
    row[0] = sum[0];
#pragma unroll
    for (int k = 0; k < 4; ++k) row[1 + k] = mxd[k];
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  fold_partials(partial, term_rows, (int)gridDim.x, stats, w_data, w_smooth, w_ls);
  if (tid == 0) *ticket = 0u;
}

// Each kernel's CTAs in one wave, with its shared memory opt-in, once per
// device (occupancy.cuh).
int terms_wave() {
  static lsf_occ::WaveCache cache;
  return lsf_occ::wave((const void*)terms_kernel, kThreads, kTermsSmem, cache);
}

template <int R>
int update_wave() {
  static lsf_occ::WaveCache cache;
  return lsf_occ::wave((const void*)sobolev_update_kernel<R>, kThreads,
                       update_smem_bytes<R>(), cache);
}

int update_wave(int radius) {
  static_assert(kMaxRadius == 7, "one case per radius");
  switch (radius) {
    case 0: return update_wave<0>();
    case 1: return update_wave<1>();
    case 2: return update_wave<2>();
    case 3: return update_wave<3>();
    case 4: return update_wave<4>();
    case 5: return update_wave<5>();
    case 6: return update_wave<6>();
    default: return update_wave<7>();
  }
}

template <int R>
cudaError_t launch_update(const float* g, const float* u, const float* rate, float* new_u,
                          double* partial, int term_rows, unsigned* ticket, float* stats,
                          const Dims& d, const Plan& pl, const Taps& taps, float w_data,
                          float w_smooth, float w_ls, const unsigned char* active,
                          cudaStream_t s) {
  sobolev_update_kernel<R><<<pl.blocks, kThreads, update_smem_bytes<R>(), s>>>(
      g, u, rate, new_u, partial, term_rows, ticket, stats, d, pl, taps, w_data, w_smooth,
      w_ls, active);
  return cudaGetLastError();
}

// One axis's window lies inside the input of n slices and the volume, and
// the input holds every slice inside the volume within h of it.
bool window_ok(int n, int h, int off, int global, int lo, int len) {
  const int64_t l = lo, hi = (int64_t)lo + len;
  return global >= 1 && len >= 1 && l >= 0 && hi <= n && l + off >= 0 && hi + off <= global &&
         std::max<int64_t>(l - h, -(int64_t)off) >= 0 &&
         std::min<int64_t>(hi + h, (int64_t)global - off) <= n;
}

// The shape, the taps and both windows, with the halos 2 + R (x: 2 under
// conv_local_x).
bool args_ok(const Args& a) {
  if (!(a.nx >= 1 && a.ny >= 1 && a.nz >= 1 && (int64_t)a.ny * a.nz <= INT32_MAX &&
        a.ntaps >= 0 && a.ntaps <= kMaxTaps && (a.ntaps == 0 || a.ntaps % 2 == 1)))
    return false;
  const int h = 2 + a.ntaps / 2;
  return window_ok(a.nx, a.conv_local_x ? 2 : h, a.x_off, a.x_global, a.x_lo, a.x_len) &&
         window_ok(a.ny, h, a.y_off, a.y_global, a.y_lo, a.y_len);
}

}  // namespace

// Doubles the caller must provide in `partial` for a volume of this shape,
// tap count and windows (0 for arguments the kernels refuse, -1 if the CUDA
// runtime could not be asked for the grid).
extern "C" int64_t lsf_fused_partials_len(int nx, int ny, int nz, int ntaps, int x_offset,
                                          int x_global, int x_lo, int x_len, int y_offset,
                                          int y_global, int y_lo, int y_len, int conv_local_x) {
  const Args a{nx, ny, nz, ntaps, x_offset, x_global, x_lo, x_len, y_offset, y_global, y_lo,
               y_len, conv_local_x != 0};
  if (!args_ok(a)) return 0;
  const int tw = terms_wave(), uw = update_wave(ntaps / 2);
  if (tw < 0 || uw < 0) return -1;
  const Dims d = dims(a);
  return (int64_t)terms_plan(d, ntaps / 2, tw).blocks * kTermCols +
         (int64_t)update_plan(d, uw).blocks * kUpdateCols;
}

// All pointers are device pointers except `taps` (host, ntaps floats).
// warped, canonical (nx, ny, nz) and warp_cm (3, nx, ny, nz) are the input
// block; new_warp is (3, x_len, y_len, nz), the windows' voxels (see the
// windows above: offsets and lo 0, len and global the input's extents for
// the whole volume). Scratch: g 3n floats, partial lsf_fused_partials_len
// doubles, ticket one unsigned that is 0 before the call and is 0 again
// after it (the kernels reset it), not shared with a call that may run at
// the same time. active: null, or a device byte that, when 0, makes both
// kernels return at once (new_warp and stats unwritten). The launch is
// capture-safe once this shape's occupancy is cached (a call before the
// capture): the taps go by value in a struct, nothing is allocated. Returns
// a cudaError_t.
extern "C" int lsf_fused_gradient_update(
    const float* warped, const float* canonical, const float* warp_cm,
    const float* rate, float* new_warp, float* stats, float* g, double* partial,
    unsigned* ticket, const unsigned char* active, int nx, int ny, int nz, int x_offset,
    int x_global, int x_lo, int x_len, int y_offset, int y_global, int y_lo, int y_len,
    int conv_local_x, float w_data, float w_smooth, float w_ls, int killing, float gamma,
    int band_union, const float* taps, int ntaps, void* stream_ptr) {
  const Args a{nx, ny, nz, ntaps, x_offset, x_global, x_lo, x_len, y_offset, y_global, y_lo,
               y_len, conv_local_x != 0};
  if (!args_ok(a) || !warped || !canonical || !warp_cm || !rate || !new_warp || !stats ||
      !g || !partial || !ticket || (ntaps && !taps))
    return (int)cudaErrorInvalidValue;
  const int tw = terms_wave(), uw = update_wave(ntaps / 2);
  if (tw < 0 || uw < 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const cudaStream_t s = (cudaStream_t)stream_ptr;
  const Dims d = dims(a);
  const TermParams p{w_data, w_smooth, w_ls, gamma, killing, band_union};
  const Plan tp = terms_plan(d, ntaps / 2, tw), up = update_plan(d, uw);
  terms_kernel<<<tp.blocks, kThreads, kTermsSmem, s>>>(warped, canonical, warp_cm, g, partial,
                                                      d, p, tp, active);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  Taps t = {};
  for (int i = 0; i < ntaps; ++i) t.w[i] = taps[ntaps - 1 - i];
  const auto args = [&](auto launch) {
    return launch(g, warp_cm, rate, new_warp, partial, tp.blocks, ticket, stats, d, up, t,
                  w_data, w_smooth, w_ls, active, s);
  };
  switch (ntaps / 2) {
    case 0: err = args(launch_update<0>); break;
    case 1: err = args(launch_update<1>); break;
    case 2: err = args(launch_update<2>); break;
    case 3: err = args(launch_update<3>); break;
    case 4: err = args(launch_update<4>); break;
    case 5: err = args(launch_update<5>); break;
    case 6: err = args(launch_update<6>); break;
    default: err = args(launch_update<7>); break;
  }
  return (int)err;
}

extern "C" const char* lsf_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
