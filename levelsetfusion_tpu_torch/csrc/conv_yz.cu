// One "conv pass" over every x-slice of an (X, Y, Z) float32 block: a
// zero-padded K-tap convolution along y, then the same along z,
//   out[j] = sum_s taps[r + s] * a[j + s]      (zero outside the slice),
// repeated `reps` times inside the kernel. Three routes to the same pass:
//   - stencil on the CUDA cores;
//   - banded product on the tensor cores, out = C_y^T A C_z for each slice A
//     (Y x Z), with C[j + s, j] = taps[r + s], in float32 accuracy
//     (3xTF32 mma.sync);
//   - the same banded product with bf16 operands and float32 accumulate.
//
// Replaces the TPU kernels of experiments/mxu_conv.py::run (lines 117, 122,
// 132, 137, 149, 156): _kernel_vpu (the stencil as masked rolls) and
// _kernel_mxu at precision HIGHEST and DEFAULT (the banded product on the
// MXU). The TPU version cycles the layout (x,y,z) -> (x,z,Y) -> (x,Y,Z) to
// avoid transposes; here each product reads its operands in place, so the
// layout stays (x, y, z).
//
// What bounds it on the H100: the slice stays in shared memory across all
// reps (as the TPU kernel keeps it in VMEM), so device memory is touched
// once. The stencil is bound by shared-memory reads (2K per output value);
// the banded product by the tensor cores' issue rate: it does the dense
// Y x Y and Z x Z products, 2 * 2 * 128^3 flops per 128 x 128 slice, which
// is ~18x the work of the 7-tap band, and 3xTF32 triples that. Measured
// per conv pass at (128, 128, 128), one slice per SM: stencil 12.2 us,
// 3xTF32 91.2 us, bf16 44.8 us; the plain versions 471.9 us (stencil),
// 53.2 us (float32 einsum) and 92.2 us (bf16-rounded einsum) (NVIDIA H100
// 80GB HBM3, 700 W power limit).
//
// Design: one CTA per x-slice. The slice and one temporary live in dynamic
// shared memory (2 x 64 KB at 128 x 128; the banded kernels pad each row by
// kPad floats so the fragment reads of 8 rows by 4 columns hit 32 banks).
// The band matrices are read from global memory (L2). Each warp owns 16 x 8
// output tiles and walks K with mma.sync.aligned.m16n8k8 (TF32) or m16n8k16
// (bf16). 3xTF32 splits every operand x into big = tf32(x) and small =
// tf32(x - big) and sums small*big + big*small + big*big, which keeps float32
// accuracy as precision=HIGHEST does on the TPU; plain TF32 would not reach
// 1e-5. The bf16 route rounds every operand to bf16, the intermediate after
// the y-product included, as precision=DEFAULT does. TMA, wgmma and skipping
// the zero blocks of the band are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRadius = 7;
constexpr int kPad = 4;  // floats of padding per shared-memory row (banded)
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can use

struct Taps {
  float v[2 * kMaxRadius + 1];
};

// ---------------------------------------------------------------- stencil

// dst = src convolved along one axis of the (ny, nz) slice: `stride` is 1
// along z and nz along y, `n` the axis extent. The sum order is the TPU
// kernel's: the centre tap, then the -s and +s taps for s = 1..R.
template <int R>
__device__ __forceinline__ void conv_axis(const float* src, float* dst,
                                          int ny, int nz, bool along_y,
                                          const Taps& taps) {
  const int plane = ny * nz;
  for (int i = threadIdx.x; i < plane; i += blockDim.x) {
    const int y = i / nz;
    const int j = along_y ? y : i - y * nz;
    const int n = along_y ? ny : nz;
    const int stride = along_y ? nz : 1;
    float acc = taps.v[R] * src[i];
#pragma unroll
    for (int s = 1; s <= R; ++s) {
      if (j - s >= 0) acc += taps.v[R - s] * src[i - s * stride];
      if (j + s < n) acc += taps.v[R + s] * src[i + s * stride];
    }
    dst[i] = acc;
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    conv_yz_stencil_kernel(const float* __restrict__ in, float* __restrict__ out,
                           int ny, int nz, int reps, Taps taps) {
  extern __shared__ float smem[];
  const int plane = ny * nz;
  float* s = smem;
  float* t = smem + plane;
  const int64_t base = (int64_t)blockIdx.x * plane;
  for (int i = threadIdx.x; i < plane; i += blockDim.x) s[i] = in[base + i];
  __syncthreads();
  for (int rep = 0; rep < reps; ++rep) {
    conv_axis<R>(s, t, ny, nz, true, taps);
    __syncthreads();
    conv_axis<R>(t, s, ny, nz, false, taps);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < plane; i += blockDim.x) out[base + i] = s[i];
}

// ----------------------------------------------------------------- banded

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats as a bf16 pair, round to nearest even; `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// D (m x n, row stride ld, shared memory) = A (m x k) . B (k x n), where
// A(i, kk) and B(kk, j) are read through the accessors. Each warp computes
// 16 x 8 tiles of D; fragment layouts as in the PTX ISA for
// mma.m16n8k8 (.tf32) and mma.m16n8k16 (.bf16), with g = lane / 4 and
// t = lane % 4.
template <bool kBf16, typename LoadA, typename LoadB>
__device__ __forceinline__ void product(LoadA A, LoadB B, int m, int n, int k,
                                        float* d_out, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_n = n / 8;
  for (int tile = warp; tile < (m / 16) * tiles_n; tile += kWarps) {
    const int m0 = (tile / tiles_n) * 16, n0 = (tile % tiles_n) * 8;
    const int r0 = m0 + g, r1 = m0 + g + 8, col = n0 + g;
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (kBf16) {
      for (int k0 = 0; k0 < k; k0 += 16) {
        const int c0 = k0 + 2 * t, c1 = k0 + 2 * t + 8;
        const uint32_t a[4] = {pack_bf16(A(r0, c0), A(r0, c0 + 1)),
                               pack_bf16(A(r1, c0), A(r1, c0 + 1)),
                               pack_bf16(A(r0, c1), A(r0, c1 + 1)),
                               pack_bf16(A(r1, c1), A(r1, c1 + 1))};
        const uint32_t b[2] = {pack_bf16(B(c0, col), B(c0 + 1, col)),
                               pack_bf16(B(c1, col), B(c1 + 1, col))};
        mma_bf16(d, a, b);
      }
    } else {
      for (int k0 = 0; k0 < k; k0 += 8) {
        const float av[4] = {A(r0, k0 + t), A(r1, k0 + t), A(r0, k0 + t + 4),
                             A(r1, k0 + t + 4)};
        const float bv[2] = {B(k0 + t, col), B(k0 + t + 4, col)};
        uint32_t a_big[4], a_small[4], b_big[2], b_small[2];
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(av[q], a_big[q], a_small[q]);
#pragma unroll
        for (int q = 0; q < 2; ++q) split_tf32(bv[q], b_big[q], b_small[q]);
        mma_tf32(d, a_small, b_big);
        mma_tf32(d, a_big, b_small);
        mma_tf32(d, a_big, b_big);
      }
    }
    d_out[r0 * ld + n0 + 2 * t] = d[0];
    d_out[r0 * ld + n0 + 2 * t + 1] = d[1];
    d_out[r1 * ld + n0 + 2 * t] = d[2];
    d_out[r1 * ld + n0 + 2 * t + 1] = d[3];
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    conv_yz_banded_kernel(const float* __restrict__ in, const float* __restrict__ cy,
                          const float* __restrict__ cz, float* __restrict__ out,
                          int ny, int nz, int reps) {
  extern __shared__ float smem[];
  const int ld = nz + kPad;
  float* s = smem;            // the slice, ny rows of ld
  float* tmp = smem + ny * ld;  // C_y^T s
  const int64_t base = (int64_t)blockIdx.x * ny * nz;
  for (int i = threadIdx.x; i < ny * nz; i += blockDim.x) {
    const int y = i / nz;
    s[y * ld + i - y * nz] = in[base + i];
  }
  __syncthreads();
  // tmp(i, j) = sum_k C_y(k, i) s(k, j);  s(i, j) = sum_k tmp(i, k) C_z(k, j).
  const auto cy_t = [&](int i, int kk) { return __ldg(cy + kk * ny + i); };
  const auto s_at = [&](int kk, int j) { return s[kk * ld + j]; };
  const auto tmp_at = [&](int i, int kk) { return tmp[i * ld + kk]; };
  const auto cz_at = [&](int kk, int j) { return __ldg(cz + kk * nz + j); };
  for (int rep = 0; rep < reps; ++rep) {
    product<kBf16>(cy_t, s_at, ny, nz, ny, tmp, ld);
    __syncthreads();
    product<kBf16>(tmp_at, cz_at, ny, nz, nz, s, ld);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < ny * nz; i += blockDim.x) {
    const int y = i / nz;
    out[base + i] = s[y * ld + i - y * nz];
  }
}

cudaError_t allow_smem(const void* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int R>
cudaError_t launch_stencil(const float* in, float* out, int nx, int ny, int nz,
                           int reps, const Taps& taps, int bytes, cudaStream_t s) {
  const cudaError_t err = allow_smem((const void*)conv_yz_stencil_kernel<R>, bytes);
  if (err != cudaSuccess) return err;
  conv_yz_stencil_kernel<R><<<nx, kThreads, bytes, s>>>(in, out, ny, nz, reps, taps);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_banded(const float* in, const float* cy, const float* cz,
                          float* out, int nx, int ny, int nz, int reps, int bytes,
                          cudaStream_t s) {
  const cudaError_t err = allow_smem((const void*)conv_yz_banded_kernel<kBf16>, bytes);
  if (err != cudaSuccess) return err;
  conv_yz_banded_kernel<kBf16><<<nx, kThreads, bytes, s>>>(in, cy, cz, out, ny, nz, reps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lsf_conv_yz_stencil(const float* in, float* out, int nx, int ny,
                                   int nz, const float* taps, int ntaps, int reps,
                                   void* stream) {
  const int64_t bytes = 2LL * ny * nz * sizeof(float);
  const int radius = ntaps / 2;
  if (nx < 1 || ny < 1 || nz < 1 || reps < 0 || bytes > kMaxSmem ||
      ntaps % 2 == 0 || radius < 1 || radius > kMaxRadius) {
    return (int)cudaErrorInvalidValue;
  }
  Taps t = {};
  for (int i = 0; i < ntaps; ++i) t.v[i] = taps[i];
  const cudaStream_t s = (cudaStream_t)stream;
  const int b = (int)bytes;
  switch (radius) {
    case 1: return (int)launch_stencil<1>(in, out, nx, ny, nz, reps, t, b, s);
    case 2: return (int)launch_stencil<2>(in, out, nx, ny, nz, reps, t, b, s);
    case 3: return (int)launch_stencil<3>(in, out, nx, ny, nz, reps, t, b, s);
    case 4: return (int)launch_stencil<4>(in, out, nx, ny, nz, reps, t, b, s);
    case 5: return (int)launch_stencil<5>(in, out, nx, ny, nz, reps, t, b, s);
    case 6: return (int)launch_stencil<6>(in, out, nx, ny, nz, reps, t, b, s);
    default: return (int)launch_stencil<7>(in, out, nx, ny, nz, reps, t, b, s);
  }
}

extern "C" int lsf_conv_yz_banded(const float* in, const float* cy, const float* cz,
                                  float* out, int nx, int ny, int nz, int reps,
                                  int bf16, void* stream) {
  const int64_t bytes = 2LL * ny * (nz + kPad) * sizeof(float);
  if (nx < 1 || ny < 16 || nz < 16 || ny % 16 != 0 || nz % 16 != 0 ||
      (int64_t)ny * nz > 16384 || reps < 0 || bytes > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch_banded<true>(in, cy, cz, out, nx, ny, nz, reps, (int)bytes, s)
                    : launch_banded<false>(in, cy, cz, out, nx, ny, nz, reps, (int)bytes, s));
}

extern "C" const char* lsf_conv_yz_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
