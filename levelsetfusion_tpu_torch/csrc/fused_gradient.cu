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
//   g     = Sobolev(g)            separable, zero-padded, axes 0, 1, 2
//   u'    = u - rate g
//   stats = [E_data, E_smooth, E_ls, sum|du|, max|du|, max|u'_x|, max|u'_y|,
//            max|u'_z|]          (the order of FusedStats in the TPU module)
//
// The edge conventions are the golden ones (levelsetfusion_tpu/ops/
// derivatives.py): np.gradient one-sided edges, replicated-edge Laplacian,
// and the Hessian rows and grad(div u) as np.gradient of np.gradient.
//
// What bounds it on the H100: bytes. Every term is a short stencil with a
// few flops per value read. The TPU design (whole volumes resident in VMEM,
// rolls with wrap slack, scalar prefetch, SMEM accumulators carried across
// sequential grid steps) does not carry over: Hopper blocks run in no order,
// so the reductions go through per-block partials and a final pass.
//
// Design, first cut: 7 passes with the Sobolev filter (5 without), each one
// thread per voxel (the update pass strides over the volume with at most
// kUpdateBlocks blocks) with z fastest, so that every stencil read along z
// and every write coalesces; reads along x and y hit L1/L2.
//   1. derivs:   grad Phi_w (3 volumes) and div u (1 volume, Killing only).
//   2. terms:    g (3 volumes), reading pass 1's buffers for the Hessian rows
//                d_j(d_i Phi_w) and for grad(div u), so the composed
//                one-sided edge forms come out of plain np.gradient reads;
//                per-block partial energies.
//   3-5. Sobolev: three 1D zero-padded convolutions, axes 0, 1, 2.
//   6. update:   u' = u - rate g, per-block sum|du|, max|du|, max|u'_c|.
//   7. finalize: one block reduces the partials into stats[8].
// Sums of partials are taken in double. The learning rate is read from
// device memory, so an adaptive rate never synchronises with the host.
// Fusing passes is later work: at 128^3 one call takes 413 us, of which the
// three Sobolev passes take 200 us and the terms pass 125 us (NVIDIA H100
// 80GB HBM3, 700 W power limit; torch.profiler).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads per block in every pass
constexpr int kPartials = 8;    // doubles per block in the partials buffer
// The update pass runs at most this many blocks, each striding over the
// volume, so the final pass folds few of its partials. (The terms pass keeps
// one thread per voxel: striding there raised its registers from 80 to 167
// and made it 2.8x slower, 145 -> 401 us at 128^3 on an NVIDIA H100 80GB
// HBM3 at its 700 W power limit.)
constexpr int64_t kUpdateBlocks = 1024;
constexpr int kFinalizeThreads = 1024;
constexpr int kMaxTaps = 15;
// |Phi| < 1 - 1e-5, with the bound rounded to f32 as the reference compares.
constexpr float kBand = 0.99999f;
constexpr float kLsEps = 1e-5f;

struct Dims {
  int nx, ny, nz;
  int64_t n;
};

struct TermParams {
  float w_data, w_smooth, w_ls, gamma;
  int killing, band_union;
};

// Taps stored reversed (w[t] = taps[n-1-t]) so that the unrolled
// convolution loop indexes them statically: a dynamic index into a kernel
// parameter makes every thread copy the struct to local memory (295 us per
// pass at 128^3 that way, 71 us indexed statically; NVIDIA H100 80GB HBM3,
// 700 W power limit).
struct Taps {
  float w[kMaxTaps];
  int n;
};

// (x, y, z) of voxel v. 64-bit integer division is a long software sequence
// on the GPU, so volumes under 2^32 voxels (the uniform branch) divide in
// 32 bits.
__device__ __forceinline__ void coords(int64_t v, const Dims& d, int c[3]) {
  if (d.n <= 0xffffffffLL) {
    const uint32_t u = (uint32_t)v, t = u / (uint32_t)d.nz;
    c[2] = (int)(u - t * (uint32_t)d.nz);
    c[1] = (int)(t % (uint32_t)d.ny);
    c[0] = (int)(t / (uint32_t)d.ny);
  } else {
    const int64_t t = v / d.nz;
    c[2] = (int)(v - t * d.nz);
    c[1] = (int)(t % d.ny);
    c[0] = (int)(t / d.ny);
  }
}

__device__ __forceinline__ int extent(const Dims& d, int a) {
  return a == 0 ? d.nx : (a == 1 ? d.ny : d.nz);
}

__device__ __forceinline__ int64_t stride(const Dims& d, int a) {
  return a == 0 ? (int64_t)d.ny * d.nz : (a == 1 ? (int64_t)d.nz : 1);
}

// np.gradient of f along one axis at voxel v (coordinate i of extent n).
__device__ __forceinline__ float dnp(const float* __restrict__ f, int64_t v,
                                     int64_t s, int i, int n) {
  if (n < 2) return 0.0f;
  if (i == 0) return f[v + s] - f[v];
  if (i == n - 1) return f[v] - f[v - s];
  return (f[v + s] - f[v - s]) * 0.5f;
}

// 1-(-2)-1 second difference along one axis, replicated edges.
__device__ __forceinline__ float d2rep(const float* __restrict__ f, int64_t v,
                                       int64_t s, int i, int n) {
  const float c = f[v];
  const float p = i < n - 1 ? f[v + s] : c;
  const float m = i > 0 ? f[v - s] : c;
  return (p - 2.0f * c) + m;
}

// Max that propagates NaN, like the reference's reductions.
__device__ __forceinline__ double nanmax(double a, double b) {
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

// Pass 1: grad Phi_w and (when div != nullptr) div u.
__global__ void derivs_kernel(const float* __restrict__ w,
                              const float* __restrict__ u,
                              float* __restrict__ gw, float* __restrict__ div,
                              Dims d) {
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= d.n) return;
  int c[3];
  coords(v, d, c);
#pragma unroll
  for (int a = 0; a < 3; ++a)
    gw[a * d.n + v] = dnp(w, v, stride(d, a), c[a], extent(d, a));
  if (div != nullptr) {
    float s = dnp(u, v, stride(d, 0), c[0], d.nx);
    s = s + dnp(u + d.n, v, stride(d, 1), c[1], d.ny);
    s = s + dnp(u + 2 * d.n, v, 1, c[2], d.nz);
    div[v] = s;
  }
}

// Pass 2: the combined gradient g and per-block partial energies. The bound
// keeps the registers at 3 blocks per SM: at 91 registers the pass took
// 221 us at 128^3, at 56 under the bound 125 us (NVIDIA H100 80GB HBM3,
// 700 W power limit).
__global__ void __launch_bounds__(kThreads, 3) terms_kernel(const float* __restrict__ w,
                             const float* __restrict__ cn,
                             const float* __restrict__ u,
                             const float* __restrict__ gw,
                             const float* __restrict__ div,
                             float* __restrict__ g,
                             double* __restrict__ partial, Dims d,
                             TermParams p) {
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  double e[3] = {0.0, 0.0, 0.0};  // data, smoothing, level set (unweighted)
  if (v < d.n) {
    int c[3];
    coords(v, d, c);
    int ext[3];
    int64_t st[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      ext[a] = extent(d, a);
      st[a] = stride(d, a);
    }
    const float wv = w[v], cv = cn[v];
    const bool band = fabsf(cv) < kBand || fabsf(wv) < kBand;
    float diff = wv - cv;
    if (p.band_union && !band) diff = 0.0f;
    float grad[3], total[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      grad[k] = gw[k * d.n + v];
      total[k] = p.w_data * (diff * grad[k]);
    }
    e[0] = (double)(diff * diff);

    if (p.w_smooth != 0.0f) {
      float jac[3][3];  // jac[i][a] = d_a u_i
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int a = 0; a < 3; ++a)
          jac[i][a] = dnp(u + i * d.n, v, st[a], c[a], ext[a]);
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
        const float* uk = u + k * d.n;
        float lap = d2rep(uk, v, st[0], c[0], ext[0]);
        lap = lap + d2rep(uk, v, st[1], c[1], ext[1]);
        lap = lap + d2rep(uk, v, st[2], c[2], ext[2]);
        const float gs =
            p.killing ? -(1.0f + p.gamma) * lap - dnp(div, v, st[k], c[k], ext[k])
                      : -lap;
        total[k] = total[k] + p.w_smooth * gs;
      }
      // 1/2 |J + J^T|^2 = |J|^2 + sum_ij J_ij J_ji
      e[1] = p.killing ? (double)((1.0f + p.gamma) * sq + cross) : (double)sq;
    }

    if (p.w_ls != 0.0f) {
      const float norm =
          sqrtf(grad[0] * grad[0] + grad[1] * grad[1] + grad[2] * grad[2]);
      float scale = (norm - 1.0f) / (norm + kLsEps);
      float el = (norm - 1.0f) * (norm - 1.0f);
      if (p.band_union && !band) {
        scale = 0.0f;
        el = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        // Row i of the Hessian dotted with grad Phi_w.
        float hg = 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j)
          hg += dnp(gw + i * d.n, v, st[j], c[j], ext[j]) * grad[j];
        total[i] = total[i] + p.w_ls * (scale * hg);
      }
      e[2] = (double)el;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) g[k * d.n + v] = total[k];
  }
  block_reduce<3, false>(e);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) partial[(int64_t)blockIdx.x * kPartials + k] = e[k];
  }
}

// Passes 3-5: "same" 1D convolution along one axis with zero padding; grid
// y is the component.
__global__ void conv_axis_kernel(const float* __restrict__ in,
                                 float* __restrict__ out, Dims d, int axis,
                                 Taps taps) {
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= d.n) return;
  const int64_t e = blockIdx.y * d.n + v;
  int c[3];
  coords(v, d, c);
  const int i = c[axis], n = extent(d, axis);
  const int64_t s = stride(d, axis);
  const int r = taps.n / 2;
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    if (t < taps.n) {
      // Convolution (not correlation): offset t - r takes tap n-1-t.
      const int j = i + t - r;
      const float val = (j >= 0 && j < n) ? in[e + (int64_t)(t - r) * s] : 0.0f;
      acc = acc + taps.w[t] * val;
    }
  }
  out[e] = acc;
}

// Pass 6: u' = u - rate g, and per-block update statistics.
__global__ void update_kernel(const float* __restrict__ u,
                              const float* __restrict__ g,
                              const float* __restrict__ rate,
                              float* __restrict__ new_u,
                              double* __restrict__ partial, Dims d) {
  double sum[1] = {0.0};
  double mx[4] = {0.0, 0.0, 0.0, 0.0};  // max|du|, max|u'_0..2|
  const float neg_rate = -__ldg(rate);
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < d.n;
       v += (int64_t)gridDim.x * blockDim.x) {
    float upd[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      upd[k] = neg_rate * g[k * d.n + v];
      const float nu = u[k * d.n + v] + upd[k];
      new_u[k * d.n + v] = nu;
      mx[1 + k] = nanmax(mx[1 + k], (double)fabsf(nu));
    }
    const float ul = sqrtf(upd[0] * upd[0] + upd[1] * upd[1] + upd[2] * upd[2]);
    sum[0] += (double)ul;
    mx[0] = nanmax(mx[0], (double)ul);
  }
  block_reduce<1, false>(sum);
  block_reduce<4, true>(mx);
  if (threadIdx.x == 0) {
    double* out = partial + (int64_t)blockIdx.x * kPartials;
    out[3] = sum[0];
#pragma unroll
    for (int k = 0; k < 4; ++k) out[4 + k] = mx[k];
  }
}

// Pass 7: one block folds the per-block partials into stats[8]: columns
// 0-2 of the terms pass's `blocks` rows, columns 3-7 of the update pass's
// `ublocks` rows.
__global__ void finalize_kernel(const double* __restrict__ partial,
                                int64_t blocks, int64_t ublocks,
                                float* __restrict__ stats,
                                float w_data, float w_smooth, float w_ls) {
  double sum[4] = {0.0, 0.0, 0.0, 0.0};
  double mx[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t b = threadIdx.x; b < blocks; b += blockDim.x) {
    const double* row = partial + b * kPartials;
#pragma unroll
    for (int k = 0; k < 3; ++k) sum[k] += row[k];
  }
  for (int64_t b = threadIdx.x; b < ublocks; b += blockDim.x) {
    const double* row = partial + b * kPartials;
    sum[3] += row[3];
#pragma unroll
    for (int k = 0; k < 4; ++k) mx[k] = nanmax(mx[k], row[4 + k]);
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

int64_t blocks_for(int64_t n) { return (n + kThreads - 1) / kThreads; }

int64_t update_blocks_for(int64_t n) {
  const int64_t b = blocks_for(n);
  return b < kUpdateBlocks ? b : kUpdateBlocks;
}

}  // namespace

#define LSF_CHECK_LAUNCH()                        \
  do {                                            \
    const cudaError_t err_ = cudaGetLastError();  \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

// Doubles the caller must provide in `partial` for a volume of this shape.
extern "C" int64_t lsf_fused_partials_len(int nx, int ny, int nz) {
  return blocks_for((int64_t)nx * ny * nz) * kPartials;
}

// All pointers are device pointers except `taps` (host, ntaps floats).
// Scratch: gw 3n floats, div n floats (Killing with w_smooth != 0, else may
// be null), g 3n floats, tmp 3n floats (with taps, else may be null),
// partial lsf_fused_partials_len doubles. Returns a cudaError_t.
extern "C" int lsf_fused_gradient_update(
    const float* warped, const float* canonical, const float* warp_cm,
    const float* rate, float* new_warp, float* stats, float* gw, float* div,
    float* g, float* tmp, double* partial, int nx, int ny, int nz,
    float w_data, float w_smooth, float w_ls, int killing, float gamma,
    int band_union, const float* taps, int ntaps, void* stream_ptr) {
  const bool need_div = killing && w_smooth != 0.0f;
  if (ntaps < 0 || ntaps > kMaxTaps || (ntaps && ntaps % 2 == 0) ||
      (ntaps && tmp == nullptr) || (need_div && div == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Dims d{nx, ny, nz, (int64_t)nx * ny * nz};
  const TermParams p{w_data, w_smooth, w_ls, gamma, killing, band_union};
  const int64_t blocks = blocks_for(d.n);
  const int64_t ublocks = update_blocks_for(d.n);

  derivs_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      warped, warp_cm, gw, need_div ? div : nullptr, d);
  LSF_CHECK_LAUNCH();
  terms_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      warped, canonical, warp_cm, gw, need_div ? div : nullptr, g, partial, d, p);
  LSF_CHECK_LAUNCH();

  const float* filtered = g;
  if (ntaps) {
    Taps t;
    t.n = ntaps;
    for (int i = 0; i < ntaps; ++i) t.w[i] = taps[ntaps - 1 - i];
    const dim3 blocks3((unsigned)blocks, 3);
    conv_axis_kernel<<<blocks3, kThreads, 0, stream>>>(g, tmp, d, 0, t);
    LSF_CHECK_LAUNCH();
    conv_axis_kernel<<<blocks3, kThreads, 0, stream>>>(tmp, g, d, 1, t);
    LSF_CHECK_LAUNCH();
    conv_axis_kernel<<<blocks3, kThreads, 0, stream>>>(g, tmp, d, 2, t);
    LSF_CHECK_LAUNCH();
    filtered = tmp;
  }

  update_kernel<<<(unsigned)ublocks, kThreads, 0, stream>>>(
      warp_cm, filtered, rate, new_warp, partial, d);
  LSF_CHECK_LAUNCH();
  finalize_kernel<<<1, kFinalizeThreads, 0, stream>>>(
      partial, blocks, ublocks, stats, w_data, w_smooth, w_ls);
  LSF_CHECK_LAUNCH();
  return (int)cudaSuccess;
}

extern "C" const char* lsf_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
