// One 2D solver iteration in one launch: the resample of the live field at
// v + u(v), the energy-term gradients, the optional Sobolev filter, the
// update u' = u - rate g where the solve's flag is set, and the iteration's
// energies and update statistics.
//
// Replaces no TPU kernel. The JAX package's 2D step (levelsetfusion_tpu/
// models/single_level.py, the unfused step) is plain jnp that XLA fuses. The
// port ran it as B1 on an (X, 1, Z) view of the field (csrc/resample.cu) and
// then ~95 small PyTorch kernels (ops/gradient.py::energy_gradient, the
// update, the stats); B2 (csrc/fused_gradient.cu) takes 3D only, since its
// zero-padded Sobolev pass along a y of 1 would scale g by the centre tap.
// This kernel does all of it, so a 2D iteration is one launch plus the solve
// loop's scalar bookkeeping.
//
//   warped = live(v + u), bilinear, +1 outside the volume (B1's 2D view)
//   g      = w_data (Phi_w - Phi_c) grad Phi_w            (band-union masked)
//          + w_smooth (-lap u)                                 Tikhonov, or
//          + w_smooth (-(1+gamma) lap u - grad div u)          Killing
//          + w_ls (|grad Phi_w| - 1)/(|grad Phi_w| + 1e-5) H(Phi_w) grad Phi_w
//   g      = Sobolev(g)        x then z, zero-padded at the volume's faces
//   u'     = u - rate g        written only where the flag is set
//   stats  = [E_data, E_smooth, E_ls, sum|du|, max|du|, max|u'_x|, max|u'_z|]
//
// Each voxel's arithmetic is the plain version's, float step for float step
// and in its order (the _rn intrinsics keep nvcc from contracting into FMAs):
// the warped field equals B1's on the (X, 1, Z) view bit for bit, g and u'
// equal the PyTorch ops' bit for bit but for the level-set term's H grad Phi
// (an einsum there). The sums (the energies, sum|du|) are taken in double in
// another order.
//
// What bounds it on the H100: latency, not bytes. config1's 96 x 48 grid
// moves 6 fields of 4,608 floats, 110 KB: 0.033 us at 3.35 TB/s; its
// ~150 f32 operations a voxel take 0.01 us at 67 TFLOP/s. What a call costs
// is its chain of dependent steps: the loads of the warp and of the live
// field's corners, four or five passes over the grid with a barrier between
// each, a block reduction and the fold across CTAs. So the grid is cut into
// tiles of kTileX x kTileZ outputs, one CTA of kThreads threads each, about
// one voxel a thread a pass, on as many SMs as there are tiles (36 at
// 96 x 48). A CTA stages its tile with a halo of 2 + R (the Hessian's and
// grad div's 2, the filter's radius R) in shared memory and recomputes it:
// the warp, the warped field and the canonical field on the tile plus
// 2 + R, the warped field's gradient on R + 1, g on R, the filter's x pass
// on the tile's rows; every stencil reads its neighbours there. The edge
// rules fire at the volume's faces only. Each CTA writes one row of partial
// sums, and the last to finish (an atomic ticket after a __threadfence)
// folds them in a fixed order and resets the ticket; a grid of one tile
// writes its stats at once. Measured (PERF.md, H100, in a CUDA graph): one
// CTA holding all of 96 x 48 took 14.0 us a call; 16 x 16 tiles 6.8 us,
// 8 x 16 tiles of 256 threads 6.1 us, 8 x 8 6.4 us, 16 x 32 8.0 us. The flag
// is read first: a frozen iteration returns at once, writing nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "occupancy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 15;
// Staged fields: u_x, u_z, the warped field, its gradient (then the filter's
// x pass), the canonical field (then g_x), g_z.
constexpr int kFields = 7;
constexpr int kTileX = 8, kTileZ = 16;  // a CTA's outputs
constexpr int kMaxHalo = 2 + kMaxTaps / 2;
constexpr int kMaxSmem =
    (kTileX + 2 * kMaxHalo) * (kTileZ + 2 * kMaxHalo) * kFields * (int)sizeof(float);
// |Phi| < 1 - 1e-5, with the bound rounded to f32 as the reference compares.
constexpr float kBand = 0.99999f;
constexpr float kLsEps = 1e-5f;
// A CTA's partial row: the data, smoothing (Tikhonov: sum |J|^2; Killing:
// sum |J + J^T|^2 and sum |J|^2) and level-set sums, sum |du|, max |du|,
// max |u'_x|, max |u'_z|.
constexpr int kSums = 5, kMaxes = 3, kPartialCols = kSums + kMaxes;

struct Params {
  int nx, nz;
  int tile_x, tile_z, tiles_z;
  int radius;  // the filter's: ntaps / 2
  int ntaps;
  float taps[kMaxTaps];  // reversed: output i sums taps[t] f[i - R + t], t < ntaps
  float w_data, w_smooth, w_ls;
  float killing_k;  // -(1 + gamma), rounded once as the reference's scalar
  float gamma;
  int killing, band_union;
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// The bilinear sample of live (nx, nz) at (px, pz), +1 outside: B1's
// trilinear sum on the (X, 1, Z) view, whose y = 1 corners carry weight 0
// and read +1, so that each pair of them adds +0 (which turns a -0 into +0).
__device__ __forceinline__ float sample(const float* __restrict__ live, float px, float pz,
                                        int nx, int nz) {
  const float fx = floorf(px), fz = floorf(pz);
  const float x1 = sub(px, fx), z1 = sub(pz, fz);
  const float x0 = sub(1.0f, x1), z0 = sub(1.0f, z1);
  const unsigned bx = (unsigned)__float2int_rz(fx), bz = (unsigned)__float2int_rz(fz);
  const unsigned ix[2] = {bx, bx + 1u}, iz[2] = {bz, bz + 1u};
  float r[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const unsigned cx = ix[c >> 1], cz = iz[c & 1];
    r[c] = cx < (unsigned)nx && cz < (unsigned)nz ? __ldg(live + (cx * (unsigned)nz + cz))
                                                  : 1.0f;
  }
  float acc = mul(mul(x0, z0), r[0]);
  acc = add(acc, mul(mul(x0, z1), r[1]));
  acc = add(acc, 0.0f);
  acc = add(acc, mul(mul(x1, z0), r[2]));
  acc = add(acc, mul(mul(x1, z1), r[3]));
  return add(acc, 0.0f);
}

// np.gradient along one axis at global position pos of n: central inside,
// one-sided at the faces, 0 for n < 2. at(d) is the value at pos + d.
template <typename F>
__device__ __forceinline__ float np_diff(int pos, int n, F at) {
  if (n < 2) return 0.0f;
  if (pos == 0) return sub(at(1), at(0));
  if (pos == n - 1) return sub(at(0), at(-1));
  return mul(sub(at(1), at(-1)), 0.5f);
}

// The 1-(-2)-1 stencil with replicated edges along one axis.
__device__ __forceinline__ float second_diff(const float* f, int i, int step, int pos, int n) {
  const float c = f[i];
  const float p = pos + 1 < n ? f[i + step] : c;
  const float m = pos > 0 ? f[i - step] : c;
  return add(sub(p, mul(2.0f, c)), m);
}

// The staged box of a CTA: global rows [x0, x1), columns [z0, z1).
struct Box {
  int x0, x1, z0, z1;
  __device__ Box grow(int h, int nx, int nz) const {
    return {max(x0 - h, 0), min(x1 + h, nx), max(z0 - h, 0), min(z1 + h, nz)};
  }
};

// Calls f(x, z, i) for every voxel (x, z) of box b, i its index in the
// staged arrays of box s (rows of s.z1 - s.z0).
template <typename F>
__device__ __forceinline__ void for_voxels(const Box& b, const Box& s, F f) {
  const int w = b.z1 - b.z0, n = (b.x1 - b.x0) * w, sw = s.z1 - s.z0;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int x = b.x0 + k / w, z = b.z0 + k % w;
    f(x, z, (x - s.x0) * sw + (z - s.z0));
  }
}

// Reduces K values over the block; the result is valid on thread 0.
template <int K, bool kMax>
__device__ void block_reduce(double (&vals)[K]) {
  __shared__ double sh[K][kThreads / 32];
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
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // Every value reduced is >= 0 or NaN, so 0 is the max's identity too.
      double x = lane < kThreads / 32 ? sh[k][lane] : 0.0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const double y = __shfl_down_sync(0xffffffffu, x, o);
        x = kMax ? nanmax(x, y) : x + y;
      }
      vals[k] = x;
    }
  }
  __syncthreads();
}

// stats[7] from the block's (or every block's) sums and maxes, on thread 0.
__device__ void write_stats(const double (&sum)[kSums], const double (&mx)[kMaxes],
                            const Params& p, float* stats) {
  const double smooth = p.killing ? 0.5 * sum[1] + (double)p.gamma * sum[2] : sum[1];
  stats[0] = (float)((double)p.w_data * 0.5 * sum[0]);
  stats[1] = p.w_smooth != 0.0f ? (float)((double)p.w_smooth * 0.5 * smooth) : 0.0f;
  stats[2] = p.w_ls != 0.0f ? (float)((double)p.w_ls * 0.5 * sum[3]) : 0.0f;
  stats[3] = (float)sum[4];
#pragma unroll
  for (int k = 0; k < kMaxes; ++k) stats[4 + k] = (float)mx[k];
}

__global__ void __launch_bounds__(kThreads, 1)
    step2d_kernel(const float* __restrict__ live, const float* __restrict__ canonical,
                  const float* __restrict__ u, const float* __restrict__ rate,
                  float* __restrict__ new_u, float* __restrict__ stats,
                  double* __restrict__ partial, unsigned* __restrict__ ticket,
                  const unsigned char* __restrict__ active, Params p) {
  // A solve whose done flag is set (active reads 0) skips the call: the
  // frozen iterations of a captured chunk cost one launch and one load.
  if (active != nullptr && *active == 0) return;
  const int nx = p.nx, nz = p.nz, R = p.radius;
  const int n = nx * nz;
  const int tx = blockIdx.x / p.tiles_z, tz = blockIdx.x % p.tiles_z;
  const Box out{tx * p.tile_x, min((tx + 1) * p.tile_x, nx), tz * p.tile_z,
                min((tz + 1) * p.tile_z, nz)};
  const Box staged = out.grow(R + 2, nx, nz);
  const int sw = staged.z1 - staged.z0, sn = (staged.x1 - staged.x0) * sw;
  extern __shared__ float smem[];
  float* const U0 = smem;
  float* const U1 = U0 + sn;
  float* const W = U1 + sn;
  float* const G0 = W + sn;  // d_x warped, then the filter's x pass of g_x
  float* const G1 = G0 + sn;  // d_z warped, then the filter's x pass of g_z
  float* const T0 = G1 + sn;  // the canonical field, then g before the filter
  float* const T1 = T0 + sn;  // g before the filter

  // The warp, the warped field and the canonical field on the staged box.
  for_voxels(staged, staged, [&](int x, int z, int i) {
    const int v = x * nz + z;
    const float a = __ldg(u + v), b = __ldg(u + n + v);
    T0[i] = __ldg(canonical + v);
    U0[i] = a;
    U1[i] = b;
    W[i] = sample(live, add((float)x, a), add((float)z, b), nx, nz);
  });
  __syncthreads();
  // The warped field's gradient where g or the Hessian reads it.
  for_voxels(out.grow(R + 1, nx, nz), staged, [&](int x, int z, int i) {
    G0[i] = np_diff(x, nx, [&](int d) { return W[i + d * sw]; });
    G1[i] = np_diff(z, nz, [&](int d) { return W[i + d]; });
  });
  __syncthreads();

  const float neg_rate = -__ldg(rate);
  double sum[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
  double mx[kMaxes] = {0.0, 0.0, 0.0};
  // u' = u - rate g at voxel i of the tile, and its statistics.
  const auto update = [&](int x, int z, int i, float g0, float g1) {
    const float d0 = mul(neg_rate, g0), d1 = mul(neg_rate, g1);
    const float a = add(U0[i], d0), b = add(U1[i], d1);
    const int v = x * nz + z;
    new_u[v] = a;
    new_u[n + v] = b;
    const float len = __fsqrt_rn(add(mul(d0, d0), mul(d1, d1)));
    sum[4] += (double)len;
    mx[0] = nanmax(mx[0], (double)len);
    mx[1] = nanmax(mx[1], (double)fabsf(a));
    mx[2] = nanmax(mx[2], (double)fabsf(b));
  };

  // g on the tile and the filter's reach (the tile alone without the
  // filter, which then updates at once); the energies on the tile.
  for_voxels(out.grow(R, nx, nz), staged, [&](int x, int z, int i) {
    const bool counted = x >= out.x0 && x < out.x1 && z >= out.z0 && z < out.z1;
    const float w = W[i], c = T0[i];
    const bool masked = p.band_union && !(fabsf(c) < kBand || fabsf(w) < kBand);
    const float diff = masked ? 0.0f : sub(w, c);
    const float gx = G0[i], gz = G1[i];
    float t0 = mul(p.w_data, mul(diff, gx)), t1 = mul(p.w_data, mul(diff, gz));
    if (counted) sum[0] += (double)mul(diff, diff);
    if (p.w_smooth != 0.0f) {
      const float l0 = add(second_diff(U0, i, sw, x, nx), second_diff(U0, i, 1, z, nz));
      const float l1 = add(second_diff(U1, i, sw, x, nx), second_diff(U1, i, 1, z, nz));
      float s0 = -l0, s1 = -l1;
      if (p.killing) {
        // div u at the voxel j = (xx, zz), and grad div u by np.gradient of it.
        const auto div = [&](int j, int xx, int zz) {
          return add(np_diff(xx, nx, [&](int d) { return U0[j + d * sw]; }),
                     np_diff(zz, nz, [&](int d) { return U1[j + d]; }));
        };
        const float gd0 = np_diff(x, nx, [&](int d) { return div(i + d * sw, x + d, z); });
        const float gd1 = np_diff(z, nz, [&](int d) { return div(i + d, x, z + d); });
        s0 = sub(mul(p.killing_k, l0), gd0);
        s1 = sub(mul(p.killing_k, l1), gd1);
      }
      t0 = add(t0, mul(p.w_smooth, s0));
      t1 = add(t1, mul(p.w_smooth, s1));
      if (counted) {
        // J[c][d] = d_d u_c
        const float j00 = np_diff(x, nx, [&](int d) { return U0[i + d * sw]; });
        const float j01 = np_diff(z, nz, [&](int d) { return U0[i + d]; });
        const float j10 = np_diff(x, nx, [&](int d) { return U1[i + d * sw]; });
        const float j11 = np_diff(z, nz, [&](int d) { return U1[i + d]; });
        const double jj = (double)mul(j00, j00) + (double)mul(j01, j01) +
                          (double)mul(j10, j10) + (double)mul(j11, j11);
        if (p.killing) {
          const float s00 = add(j00, j00), s01 = add(j01, j10), s11 = add(j11, j11);
          sum[1] += (double)mul(s00, s00) + 2.0 * (double)mul(s01, s01) + (double)mul(s11, s11);
          sum[2] += jj;
        } else {
          sum[1] += jj;
        }
      }
    }
    if (p.w_ls != 0.0f) {
      const float norm = __fsqrt_rn(add(mul(gx, gx), mul(gz, gz)));
      // H[a][b] = d_b (d_a warped); the einsum H grad.
      const float h00 = np_diff(x, nx, [&](int d) { return G0[i + d * sw]; });
      const float h01 = np_diff(z, nz, [&](int d) { return G0[i + d]; });
      const float h10 = np_diff(x, nx, [&](int d) { return G1[i + d * sw]; });
      const float h11 = np_diff(z, nz, [&](int d) { return G1[i + d]; });
      const float hg0 = add(mul(h00, gx), mul(h01, gz)), hg1 = add(mul(h10, gx), mul(h11, gz));
      const float scale = masked ? 0.0f : __fdiv_rn(sub(norm, 1.0f), add(norm, kLsEps));
      t0 = add(t0, mul(p.w_ls, mul(scale, hg0)));
      t1 = add(t1, mul(p.w_ls, mul(scale, hg1)));
      if (counted && !masked) {
        const float e = sub(norm, 1.0f);
        sum[3] += (double)mul(e, e);
      }
    }
    if (p.ntaps == 0) {
      update(x, z, i, t0, t1);
    } else {
      T0[i] = t0;
      T1[i] = t1;
    }
  });

  if (p.ntaps != 0) {
    const int K = p.ntaps;
    __syncthreads();
    // The x pass on the tile's rows and the z pass's reach, into G.
    const Box reach = out.grow(R, nx, nz);
    for_voxels(Box{out.x0, out.x1, reach.z0, reach.z1}, staged, [&](int x, int z, int i) {
      float a = 0.0f, b = 0.0f;
#pragma unroll
      for (int t = 0; t < kMaxTaps; ++t) {
        if (t == K) break;
        const int xx = x - R + t;
        const bool in = xx >= 0 && xx < nx;
        const int j = i + (t - R) * sw;
        a = add(a, mul(p.taps[t], in ? T0[j] : 0.0f));
        b = add(b, mul(p.taps[t], in ? T1[j] : 0.0f));
      }
      G0[i] = a;
      G1[i] = b;
    });
    __syncthreads();
    // The z pass and the update on the tile.
    for_voxels(out, staged, [&](int x, int z, int i) {
      float a = 0.0f, b = 0.0f;
#pragma unroll
      for (int t = 0; t < kMaxTaps; ++t) {
        if (t == K) break;
        const int zz = z - R + t;
        const bool in = zz >= 0 && zz < nz;
        const int j = i + t - R;
        a = add(a, mul(p.taps[t], in ? G0[j] : 0.0f));
        b = add(b, mul(p.taps[t], in ? G1[j] : 0.0f));
      }
      update(x, z, i, a, b);
    });
  }

  block_reduce<kSums, false>(sum);
  block_reduce<kMaxes, true>(mx);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) write_stats(sum, mx, p, stats);
    return;
  }
  __shared__ bool last;
  if (threadIdx.x == 0) {
    double* row = partial + (int64_t)blockIdx.x * kPartialCols;
#pragma unroll
    for (int k = 0; k < kSums; ++k) row[k] = sum[k];
#pragma unroll
    for (int k = 0; k < kMaxes; ++k) row[kSums + k] = mx[k];
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The last CTA folds every row, in an order fixed by the block's shape.
#pragma unroll
  for (int k = 0; k < kSums; ++k) sum[k] = 0.0;
#pragma unroll
  for (int k = 0; k < kMaxes; ++k) mx[k] = 0.0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    const double* row = partial + (int64_t)b * kPartialCols;
#pragma unroll
    for (int k = 0; k < kSums; ++k) sum[k] += __ldcg(row + k);
#pragma unroll
    for (int k = 0; k < kMaxes; ++k) mx[k] = nanmax(mx[k], __ldcg(row + kSums + k));
  }
  block_reduce<kSums, false>(sum);
  block_reduce<kMaxes, true>(mx);
  if (threadIdx.x == 0) {
    write_stats(sum, mx, p, stats);
    *ticket = 0u;
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

struct Plan {
  int tile_x, tile_z, tiles_x, tiles_z;
  int smem;  // bytes of staged fields of a whole tile
};

// Tiles of kTileX x kTileZ outputs (the last ones ragged), each staged with
// its halo; tiles_x 0 for arguments the kernel refuses.
Plan plan(int nx, int nz, int ntaps) {
  if (nx < 1 || nz < 1 || (int64_t)nx * nz >= ((int64_t)1 << 31) || ntaps < 0 ||
      ntaps > kMaxTaps || (ntaps != 0 && ntaps % 2 == 0))
    return {0, 0, 0, 0, 0};
  const int tx = std::min(nx, kTileX), tz = std::min(nz, kTileZ), h = 2 + ntaps / 2;
  const int staged = std::min(nx, tx + 2 * h) * std::min(nz, tz + 2 * h);
  return {tx, tz, (int)ceil_div(nx, tx), (int)ceil_div(nz, tz),
          staged * kFields * (int)sizeof(float)};
}

}  // namespace

// CTAs (tiles) of a call on an (nx, nz) grid with ntaps Sobolev taps: at 1
// the call needs no partial rows and no ticket; 0 for arguments the kernel
// refuses.
extern "C" int lsf_step2d_tiles(int nx, int nz, int ntaps) {
  const Plan pl = plan(nx, nz, ntaps);
  return pl.tiles_x * pl.tiles_z;
}

// All pointers are device pointers except `taps` (host, ntaps floats).
// live, canonical (nx, nz) and warp_cm (2, nx, nz) in; new_warp (2, nx, nz),
// apart from warp_cm, and stats[7] out; rate one float. Where the call takes
// more than one tile (lsf_step2d_tiles): partial 8 doubles a tile, and
// ticket one unsigned that is 0 before the call and 0 again after it, not
// shared with a call that may run at the same time. active: null, or a
// device byte that, when 0, makes the call return at once, new_warp and stats
// unwritten. killing_k is -(1 + gamma). Launches on `stream`, allocates
// nothing, reads nothing back to the host; capture-safe once a call on this
// device has set the kernel's shared memory opt-in. Returns a cudaError_t.
extern "C" int lsf_step2d(const float* live, const float* canonical, const float* warp_cm,
                          const float* rate, float* new_warp, float* stats, double* partial,
                          unsigned* ticket, const unsigned char* active, int nx, int nz,
                          float w_data, float w_smooth, float w_ls, int killing,
                          float killing_k, float gamma, int band_union, const float* taps,
                          int ntaps, void* stream) {
  const Plan pl = plan(nx, nz, ntaps);
  const int tiles = pl.tiles_x * pl.tiles_z;
  if (tiles < 1 || !live || !canonical || !warp_cm || !rate || !new_warp || !stats ||
      (tiles > 1 && (!partial || !ticket)) || (ntaps && !taps))
    return (int)cudaErrorInvalidValue;
  static lsf_occ::WaveCache cache;
  if (lsf_occ::wave((const void*)step2d_kernel, kThreads, kMaxSmem, cache) < 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  Params p = {};
  p.nx = nx;
  p.nz = nz;
  p.tile_x = pl.tile_x;
  p.tile_z = pl.tile_z;
  p.tiles_z = pl.tiles_z;
  p.radius = ntaps / 2;
  p.ntaps = ntaps;
  for (int i = 0; i < ntaps; ++i) p.taps[i] = taps[ntaps - 1 - i];
  p.w_data = w_data;
  p.w_smooth = w_smooth;
  p.w_ls = w_ls;
  p.killing_k = killing_k;
  p.gamma = gamma;
  p.killing = killing != 0;
  p.band_union = band_union != 0;
  step2d_kernel<<<tiles, kThreads, pl.smem, (cudaStream_t)stream>>>(
      live, canonical, warp_cm, rate, new_warp, stats, partial, ticket, active, p);
  return (int)cudaGetLastError();
}

extern "C" const char* lsf_step2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
