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
// once. The stencil is bound by shared-memory reads (2K per output value).
// The banded products multiply only the k steps of C_y and C_z that hold a
// nonzero (a 7-tap band at 128: 2,544 3xTF32 or 592 bf16 mma.sync a slice
// and pass, against the dense 12,288 and 2,048). What bounds them then is
// shared memory: each step reads the slice's (or tmp's) fragments anew for
// every tile whose band covers it, ~5k wavefronts a slice and pass in both
// routes, and 3xTF32 issues its splits and three mma a step beside them.
// Per conv pass at (128, 128, 128), one slice per SM: stencil 12.2-12.9 us;
// 3xTF32 8.5-9.1 us and bf16 4.4-4.5 us, where the dense products took
// 91.4 and 45.0 us (NVIDIA H100 80GB HBM3, 700 W power limit; mxu_conv.run
// and experiments/conv_yz_sweep.py).
//
// Design: one CTA of 32 warps per x-slice (8 warps: 14.1 and 6.8 us, and
// ptxas spills the TF32 route). The slice and one temporary live in dynamic
// shared memory, each row padded so that the products' fragment reads hit
// 32 banks. The wrapper passes the band extents of C_y (per 16 columns, the
// y product's m-tiles) and C_z (per 8 columns, its n-tiles): the first and
// last k step holding a nonzero, computed from the matrices on the device.
// Each product walks only those steps; a tile whose range is empty is
// written as zeros. With finite inputs the skipped products are exact
// zeros, so the result is the dense product's; a NaN or Inf in the slice
// does not reach a skipped block, where the dense product would spread it.
// Each CTA splits (3xTF32: big = tf32(x), small = tf32(x - big)) or packs
// (bf16) the band's fragments of those steps once per call into shared
// memory behind the slice; where they do not fit (a dense C at 128), it
// loads and splits them from global memory at each step instead. In the y
// product a warp takes one m-tile and kAcc n-tiles, in the z product one
// n-tile and kAcc m-tiles: the band fragment of a step is read once and
// feeds kAcc independent accumulators. 3xTF32 sums small*big + big*small +
// big*big with m16n8k8, which keeps float32 accuracy as precision=HIGHEST
// does on the TPU; the bf16 route rounds every operand to bf16, the
// intermediate after the y product included, as precision=DEFAULT does
// (m16n8k16). TMA, wgmma and clusters are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRadius = 7;
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

constexpr int kBandThreads = 1024;  // 32 warps: one CTA holds an SM
constexpr int kBandWarps = kBandThreads / 32;
constexpr int kAcc = 4;  // output tiles (independent accumulators) a warp carries

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
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats as a bf16 pair, round to nearest even; `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The operand fragments of one mma step, layouts as in the PTX ISA for
// mma.m16n8k8 (.tf32) and mma.m16n8k16 (.bf16), with g = lane / 4 and
// t = lane % 4: 3xTF32 keeps each value as its big and small TF32 parts,
// bf16 as packed pairs.
template <bool kBf16> struct FragA { uint32_t big[4], small[4]; };
template <> struct FragA<true> { uint32_t v[4]; };
template <bool kBf16> struct FragB { uint32_t big[2], small[2]; };
template <> struct FragB<true> { uint32_t v[2]; };

template <bool kBf16> constexpr int kStepK = kBf16 ? 16 : 8;  // k of one mma step
// Bytes of one staged fragment (a warp's 32 lanes).
template <bool kBf16> constexpr int kFragABytes = 32 * (int)sizeof(FragA<kBf16>);
template <bool kBf16> constexpr int kFragBBytes = 32 * (int)sizeof(FragB<kBf16>);

__device__ __forceinline__ void mma_step(float (&d)[4], const FragA<false>& a,
                                         const FragB<false>& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

__device__ __forceinline__ void mma_step(float (&d)[4], const FragA<true>& a,
                                         const FragB<true>& b) {
  mma_bf16(d, a.v, b.v);
}

// An operand M(i, k) as the products read it: in shared memory as rows of
// `ld` floats, or in global memory at p[i * si + k * sk] (the band matrices).
struct Shared {
  const float* p;
  int ld;
  __device__ float operator()(int i, int k) const { return p[i * ld + k]; }
  __device__ float2 pair(int i, int k) const {  // M(i, k), M(i, k + 1); k even
    return *reinterpret_cast<const float2*>(p + i * ld + k);
  }
};

struct Global {
  const float* p;
  int si, sk;
  __device__ float operator()(int i, int k) const { return __ldg(p + i * si + k * sk); }
  __device__ float2 pair(int i, int k) const {
    return make_float2((*this)(i, k), (*this)(i, k + 1));
  }
};

// The A fragment of rows r and r + 8 at the k step starting at k0.
template <bool kBf16, typename M>
__device__ __forceinline__ FragA<kBf16> load_a(const M& A, int r, int k0, int t) {
  FragA<kBf16> f;
  if constexpr (kBf16) {
    const int c0 = k0 + 2 * t, c1 = c0 + 8;
    const float2 v[4] = {A.pair(r, c0), A.pair(r + 8, c0), A.pair(r, c1), A.pair(r + 8, c1)};
#pragma unroll
    for (int q = 0; q < 4; ++q) f.v[q] = pack_bf16(v[q].x, v[q].y);
  } else {
    const float v[4] = {A(r, k0 + t), A(r + 8, k0 + t), A(r, k0 + t + 4), A(r + 8, k0 + t + 4)};
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(v[q], f.big[q], f.small[q]);
  }
  return f;
}

// The B fragment of column `col` at the k step starting at k0.
template <bool kBf16, typename M>
__device__ __forceinline__ FragB<kBf16> load_b(const M& B, int k0, int col, int t) {
  FragB<kBf16> f;
  if constexpr (kBf16) {
    const int c0 = k0 + 2 * t;
    f.v[0] = pack_bf16(B(c0, col), B(c0 + 1, col));
    f.v[1] = pack_bf16(B(c0 + 8, col), B(c0 + 9, col));
  } else {
    split_tf32(B(k0 + t, col), f.big[0], f.small[0]);
    split_tf32(B(k0 + t + 4, col), f.big[1], f.small[1]);
  }
  return f;
}

// Staged fragments: fragment f's 16-byte (bf16 B: 8-byte) vectors, lane
// by lane, so that a warp reads each vector as consecutive bytes.
__device__ __forceinline__ void put(unsigned char* base, int f, const FragA<false>& x) {
  uint4* p = reinterpret_cast<uint4*>(base) + 64 * f + (threadIdx.x & 31);
  p[0] = make_uint4(x.big[0], x.big[1], x.big[2], x.big[3]);
  p[32] = make_uint4(x.small[0], x.small[1], x.small[2], x.small[3]);
}

__device__ __forceinline__ void get(const unsigned char* base, int f, FragA<false>& x) {
  const uint4* p = reinterpret_cast<const uint4*>(base) + 64 * f + (threadIdx.x & 31);
  const uint4 b = p[0], s = p[32];
  x = {{b.x, b.y, b.z, b.w}, {s.x, s.y, s.z, s.w}};
}

__device__ __forceinline__ void put(unsigned char* base, int f, const FragA<true>& x) {
  reinterpret_cast<uint4*>(base)[32 * f + (threadIdx.x & 31)] =
      make_uint4(x.v[0], x.v[1], x.v[2], x.v[3]);
}

__device__ __forceinline__ void get(const unsigned char* base, int f, FragA<true>& x) {
  const uint4 v = reinterpret_cast<const uint4*>(base)[32 * f + (threadIdx.x & 31)];
  x = {{v.x, v.y, v.z, v.w}};
}

__device__ __forceinline__ void put(unsigned char* base, int f, const FragB<false>& x) {
  reinterpret_cast<uint4*>(base)[32 * f + (threadIdx.x & 31)] =
      make_uint4(x.big[0], x.big[1], x.small[0], x.small[1]);
}

__device__ __forceinline__ void get(const unsigned char* base, int f, FragB<false>& x) {
  const uint4 v = reinterpret_cast<const uint4*>(base)[32 * f + (threadIdx.x & 31)];
  x = {{v.x, v.y}, {v.z, v.w}};
}

__device__ __forceinline__ void put(unsigned char* base, int f, const FragB<true>& x) {
  reinterpret_cast<uint2*>(base)[32 * f + (threadIdx.x & 31)] = make_uint2(x.v[0], x.v[1]);
}

__device__ __forceinline__ void get(const unsigned char* base, int f, FragB<true>& x) {
  const uint2 v = reinterpret_cast<const uint2*>(base)[32 * f + (threadIdx.x & 31)];
  x = {{v.x, v.y}};
}

__device__ __forceinline__ void store_d(float* out, int ld, int r, int c,
                                        const float (&d)[4]) {
  *reinterpret_cast<float2*>(out + r * ld + c) = make_float2(d[0], d[1]);
  *reinterpret_cast<float2*>(out + (r + 8) * ld + c) = make_float2(d[2], d[3]);
}

// The banded kernels' dynamic shared memory, in bytes from its start: the
// slice (ny rows of lds floats) and tmp (ny rows of ldt), the band extents
// and fragment offsets at `meta`, the staged fragments at `stage`. The row
// pads put the fragment reads on 32 banks: the y product reads the slice
// as B (4 rows by 8 columns for TF32, rows 2t and 2t + 1 for bf16), the z
// product reads tmp as A (8 rows by 4 columns; bf16 in float2 pairs).
// `dense` is what staging every k step of every tile would take.
struct BandLayout {
  int lds, ldt, tiles_m, tiles_n;
  int64_t meta, stage, dense;
  __host__ __device__ BandLayout(int ny, int nz, bool bf16)
      : lds(nz + (bf16 ? 4 : 8)), ldt(nz + (bf16 ? 8 : 4)), tiles_m(ny / 16),
        tiles_n(nz / 8) {
    meta = 4LL * ny * (lds + ldt);
    stage = (meta + 12LL * (tiles_m + tiles_n) + 4 + 15) / 16 * 16;
    const int k = bf16 ? 16 : 8;
    dense = (int64_t)tiles_m * (ny / k) * (bf16 ? 512 : 1024) +
            (int64_t)tiles_n * (nz / k) * (bf16 ? 256 : 512);
  }
};

struct Block {
  float* s;
  float* tmp;
  int lds, ldt, ny, nz;
  const float* cy;
  const float* cz;
  const int2* ext_y;  // per m-tile: first and last k step of C_y's 16 columns
  const int2* ext_z;  // per n-tile: the same of C_z's 8 columns
  const int* off_y;   // per tile: index of its first staged fragment
  const int* off_z;
  const unsigned char* frags_y;
  const unsigned char* frags_z;
};

// tmp(i, j) = sum_k C_y(k, i) s(k, j): A(i, k) = C_y(k, i), B the slice. A
// warp takes one 16-row m-tile and kAcc n-tiles at a time and walks the
// m-tile's band extent: each step's band fragment is read once and feeds
// kAcc accumulators; the slice's fragments are loaded and split per tile.
template <bool kBf16, bool kStaged>
__device__ __forceinline__ void y_product(const Block& b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int groups = (b.nz / 8 + kAcc - 1) / kAcc;
  const Global band{b.cy, 1, b.ny};
  const Shared slice{b.s, b.lds};
  for (int unit = warp; unit < (b.ny / 16) * groups; unit += kBandWarps) {
    const int mt = unit / groups, m0 = mt * 16, n0 = (unit % groups) * 8 * kAcc;
    const int2 e = b.ext_y[mt];
    const int f0 = kStaged ? b.off_y[mt] - e.x : 0;
    float d[kAcc][4] = {};
    for (int step = e.x; step <= e.y; ++step) {
      const int k0 = step * kStepK<kBf16>;
      FragA<kBf16> a;
      if constexpr (kStaged) {
        get(b.frags_y, f0 + step, a);
      } else {
        a = load_a<kBf16>(band, m0 + g, k0, t);
      }
#pragma unroll
      for (int q = 0; q < kAcc; ++q) {
        if (n0 + 8 * q < b.nz) {
          mma_step(d[q], a, load_b<kBf16>(slice, k0, n0 + 8 * q + g, t));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kAcc; ++q) {
      if (n0 + 8 * q < b.nz) store_d(b.tmp, b.ldt, m0 + g, n0 + 8 * q + 2 * t, d[q]);
    }
  }
}

// s(i, j) = sum_k tmp(i, k) C_z(k, j): a warp takes one 8-column n-tile and
// kAcc m-tiles at a time and walks the n-tile's band extent.
template <bool kBf16, bool kStaged>
__device__ __forceinline__ void z_product(const Block& b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int groups = (b.ny / 16 + kAcc - 1) / kAcc;
  const Global band{b.cz, b.nz, 1};
  const Shared inter{b.tmp, b.ldt};
  for (int unit = warp; unit < (b.nz / 8) * groups; unit += kBandWarps) {
    const int nt = unit / groups, n0 = nt * 8, m0 = (unit % groups) * 16 * kAcc;
    const int2 e = b.ext_z[nt];
    const int f0 = kStaged ? b.off_z[nt] - e.x : 0;
    float d[kAcc][4] = {};
    for (int step = e.x; step <= e.y; ++step) {
      const int k0 = step * kStepK<kBf16>;
      FragB<kBf16> f;
      if constexpr (kStaged) {
        get(b.frags_z, f0 + step, f);
      } else {
        f = load_b<kBf16>(band, k0, n0 + g, t);
      }
#pragma unroll
      for (int q = 0; q < kAcc; ++q) {
        if (m0 + 16 * q < b.ny) {
          mma_step(d[q], load_a<kBf16>(inter, m0 + 16 * q + g, k0, t), f);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kAcc; ++q) {
      if (m0 + 16 * q < b.ny) store_d(b.s, b.lds, m0 + 16 * q + g, n0 + 2 * t, d[q]);
    }
  }
}

template <bool kBf16, bool kStaged>
__device__ __forceinline__ void passes(const Block& b, int reps) {
  for (int rep = 0; rep < reps; ++rep) {
    y_product<kBf16, kStaged>(b);
    __syncthreads();
    z_product<kBf16, kStaged>(b);
    __syncthreads();
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kBandThreads)
    conv_yz_banded_kernel(const float* __restrict__ in, const float* __restrict__ cy,
                          const float* __restrict__ cz, const int2* __restrict__ ext_y,
                          const int2* __restrict__ ext_z, float* __restrict__ out,
                          int ny, int nz, int reps, int stage_bytes) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  constexpr int kK = kStepK<kBf16>;
  const BandLayout l(ny, nz, kBf16);
  float* s = reinterpret_cast<float*>(band_smem);
  float* tmp = s + ny * l.lds;
  int2* ey = reinterpret_cast<int2*>(band_smem + l.meta);
  int2* ez = ey + l.tiles_m;
  int* oy = reinterpret_cast<int*>(ez + l.tiles_n);
  int* oz = oy + l.tiles_m;
  int* staged_y = oz + l.tiles_n;  // fragments staged for the y product; -1: none
  // The extents clipped to the matrices, then each tile's first fragment
  // and whether all of them fit the stage.
  for (int i = threadIdx.x; i < l.tiles_m + l.tiles_n; i += blockDim.x) {
    if (i < l.tiles_m) {
      ey[i] = make_int2(max(ext_y[i].x, 0), min(ext_y[i].y, ny / kK - 1));
    } else {
      const int2 e = ext_z[i - l.tiles_m];
      ez[i - l.tiles_m] = make_int2(max(e.x, 0), min(e.y, nz / kK - 1));
    }
  }
  const int64_t base = (int64_t)blockIdx.x * ny * nz;
  for (int i = threadIdx.x; i < ny * nz; i += blockDim.x) {
    const int y = i / nz;
    s[y * l.lds + i - y * nz] = in[base + i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int fy = 0, fz = 0;
    for (int mt = 0; mt < l.tiles_m; ++mt) {
      oy[mt] = fy;
      fy += max(ey[mt].y - ey[mt].x + 1, 0);
    }
    for (int nt = 0; nt < l.tiles_n; ++nt) {
      oz[nt] = fz;
      fz += max(ez[nt].y - ez[nt].x + 1, 0);
    }
    const int64_t need = (int64_t)fy * kFragABytes<kBf16> + (int64_t)fz * kFragBBytes<kBf16>;
    *staged_y = need <= stage_bytes ? fy : -1;
  }
  __syncthreads();
  const int fy = *staged_y;
  unsigned char* frags_y = band_smem + l.stage;
  unsigned char* frags_z = frags_y + (int64_t)max(fy, 0) * kFragABytes<kBf16>;
  const Block b{s, tmp, l.lds, l.ldt, ny, nz, cy, cz, ey, ez, oy, oz, frags_y, frags_z};
  if (fy >= 0) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const Global band_y{cy, 1, ny}, band_z{cz, nz, 1};
    for (int mt = warp; mt < l.tiles_m; mt += kBandWarps) {
      for (int step = ey[mt].x; step <= ey[mt].y; ++step) {
        put(frags_y, oy[mt] + step - ey[mt].x, load_a<kBf16>(band_y, mt * 16 + g, step * kK, t));
      }
    }
    for (int nt = warp; nt < l.tiles_n; nt += kBandWarps) {
      for (int step = ez[nt].x; step <= ez[nt].y; ++step) {
        put(frags_z, oz[nt] + step - ez[nt].x, load_b<kBf16>(band_z, step * kK, nt * 8 + g, t));
      }
    }
    __syncthreads();
    passes<kBf16, true>(b, reps);
  } else {
    passes<kBf16, false>(b, reps);
  }
  for (int i = threadIdx.x; i < ny * nz; i += blockDim.x) {
    const int y = i / nz;
    out[base + i] = s[y * l.lds + i - y * nz];
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
                          const int* ext_y, const int* ext_z, float* out, int nx,
                          int ny, int nz, int reps, cudaStream_t s) {
  const BandLayout l(ny, nz, kBf16);
  const int64_t stage_bytes = l.dense < kMaxSmem - l.stage ? l.dense : kMaxSmem - l.stage;
  const int bytes = (int)(l.stage + stage_bytes);
  const cudaError_t err = allow_smem((const void*)conv_yz_banded_kernel<kBf16>, bytes);
  if (err != cudaSuccess) return err;
  conv_yz_banded_kernel<kBf16><<<nx, kBandThreads, bytes, s>>>(
      in, cy, cz, reinterpret_cast<const int2*>(ext_y), reinterpret_cast<const int2*>(ext_z),
      out, ny, nz, reps, (int)stage_bytes);
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

// ext_y: int32 (Y / 16, 2), ext_z: int32 (Z / 8, 2), the first and last k
// step (of 8 rows for TF32, 16 for bf16) holding a nonzero of each group of
// C_y's and C_z's columns (mxu_conv.band_extents); first > last is empty.
extern "C" int lsf_conv_yz_banded(const float* in, const float* cy, const float* cz,
                                  const int* ext_y, const int* ext_z, float* out,
                                  int nx, int ny, int nz, int reps, int bf16,
                                  void* stream) {
  if (nx < 1 || ny < 16 || nz < 16 || ny % 16 != 0 || nz % 16 != 0 ||
      (int64_t)ny * nz > 16384 || reps < 0 || BandLayout(ny, nz, bf16).stage > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch_banded<true>(in, cy, cz, ext_y, ext_z, out, nx, ny, nz, reps, s)
                    : launch_banded<false>(in, cy, cz, ext_y, ext_z, out, nx, ny, nz, reps, s));
}

extern "C" const char* lsf_conv_yz_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
