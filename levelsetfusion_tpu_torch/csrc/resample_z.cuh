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

}  // namespace lsf_rz
