// The per-voxel arithmetic shared by the shift-enumeration resample kernels
// (csrc/resample_variants.cu, csrc/v10_xslab.cu, csrc/stack_bodies.cu): the ±K clamp of the x/y
// displacement, the z setup and the tent weights, in the float steps of the
// JAX bodies (experiments/resample_variants.py::_z_setup, _tent). The _rn
// intrinsics keep nvcc from contracting a product and a sum into one FMA,
// so each step rounds as the plain torch versions' separate ops do.

#pragma once

#include <cuda_runtime.h>

namespace lsf_rz {

constexpr int kK = 2;           // clamp of ux and uy to [-kK, kK]
constexpr int kN = 2 * kK + 2;  // integer shifts per axis
constexpr int kLane = 128;      // the z extent the kernels take

__device__ __forceinline__ float clamp_k(float u) {
  return fminf(fmaxf(u, -(float)kK), (float)kK);
}

__device__ __forceinline__ float tent(float t) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(t)));
}

// tent(u - (c - K)): the weight of integer shift c of the padded field.
__device__ __forceinline__ float tent_at(float u, int c) {
  return tent(__fsub_rn(u, (float)(c - kK)));
}

struct ZSetup {
  int z0c, z1c;  // gathered z indices, clipped to [0, kLane)
  float w0, w1;  // their weights, 0 where the unclipped index is outside
};

__device__ __forceinline__ ZSetup z_setup(float uz, int z) {
  const float nz = floorf(uz);
  const float fz = __fsub_rn(uz, nz);
  const int z0 = z + (int)nz;
  ZSetup s;
  s.z0c = min(max(z0, 0), kLane - 1);
  s.z1c = min(max(z0 + 1, 0), kLane - 1);
  s.w0 = (z0 >= 0 && z0 < kLane) ? __fsub_rn(1.0f, fz) : 0.0f;
  s.w1 = (z0 + 1 >= 0 && z0 + 1 < kLane) ? fz : 0.0f;
  return s;
}

// (1 - w0 - w1) times the +1 fill: the weight that falls outside in z.
__device__ __forceinline__ float acc0(const ZSetup& s) {
  return __fsub_rn(__fsub_rn(1.0f, s.w0), s.w1);
}

// w0 r0 + w1 r1: one shift's z interpolation.
__device__ __forceinline__ float zmix(const ZSetup& s, float r0, float r1) {
  return __fadd_rn(__fmul_rn(s.w0, r0), __fmul_rn(s.w1, r1));
}

__device__ __forceinline__ float add_pair(float acc, float w, float g) {
  return __fadd_rn(acc, __fmul_rn(w, g));
}

// The runtime pair loops (csrc/resample_variants.cu's B3 tiles and B4 ring,
// csrc/stack_bodies.cu's B8 levels, v8 and v8c) read pair t = kN cy + cx
// (cy outer) from a table in constant memory, a uniform LDC a pair, in place
// of t / kN and the ring's wrap: the staged row it reads, counted in rows
// from the voxel's row in slot 0 (each kernel scales it by its row's bytes,
// a power of two), cx - K and cy - K as floats (exact), and cx, cy. The
// table is built at compile time for each start slot of a ring; a 37th
// pair, a copy of pair 0, lets a loop load pair t + 1 while it sums pair t.
// (Counters carried through the loop cost more: ptxas predicates the new-cy
// update into every step.)
struct alignas(16) Pair {
  int row;
  float fx, fy;  // with row, one 16-byte line (pair_sum)
  int pad0;
  int cx, cy;  // with row, two LDCs (v8); a third when cx, cy straddle 16 bytes
  int pad1[2];
};

template <int kStarts>
struct PairTable {
  Pair p[kStarts][kN * kN + 1];
};

// Pair t of a voxel whose x shift cx sits in slot (s0 + cx) mod `slots`, for
// each start slot s0 < kStarts: slot s begins at row s `slot_rows`, and y
// shift cy is cy rows further in.
template <int kStarts>
constexpr PairTable<kStarts> pair_table(int slots, int slot_rows) {
  PairTable<kStarts> table{};
  for (int s0 = 0; s0 < kStarts; ++s0) {
    for (int t = 0; t <= kN * kN; ++t) {
      const int cy = t % (kN * kN) / kN, cx = t % kN;
      table.p[s0][t] = Pair{(s0 + cx) % slots * slot_rows + cy, (float)(cx - kK),
                            (float)(cy - kK), 0, cx, cy, {0, 0}};
    }
  }
  return table;
}

// The float at byte `addr` of this CTA's shared memory window.
__device__ __forceinline__ float ld_shared(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

// The runtime pair loop of B4's ring and B8's levels: acc plus, over the 36
// pairs of `pairs` (one start slot's table) in t order, w0 R[z0c] + w1
// R[z1c] of pair t's staged row R, weighted by tent(uy - fy) tent(ux - fx)
// when kWeighted. a0 and a1 are the shared addresses of the voxel's z0c and
// z1c in its row of slot 0, and a table row is kRowBytes further on: pair t
// is two LDCs (row, fx, fy) and one IMAD or LEA an address, 22-23 SASS in
// all. (A pointer walk over the table made the loop's counter 64 bits: 3
// more SASS a pair; loading pair t + 1 before summing pair t timed slower,
// experiments/*_sweep.py.)
template <int kRowBytes, bool kWeighted>
__device__ __forceinline__ float pair_sum(float acc, const Pair* pairs, unsigned a0, unsigned a1,
                                          float ux, float uy, const ZSetup& zs) {
#pragma unroll 1
  for (int t = 0; t < kN * kN; ++t) {
    const int4 q = *reinterpret_cast<const int4*>(&pairs[t]);  // row, fx, fy, pad0
    const unsigned off = (unsigned)q.x * kRowBytes;
    const float g = zmix(zs, ld_shared(a0 + off), ld_shared(a1 + off));
    if constexpr (kWeighted) {
      const float w = __fmul_rn(tent(__fsub_rn(uy, __int_as_float(q.z))),
                                tent(__fsub_rn(ux, __int_as_float(q.y))));
      acc = add_pair(acc, w, g);
    } else {
      acc = __fadd_rn(acc, g);
    }
  }
  return acc;
}

}  // namespace lsf_rz
