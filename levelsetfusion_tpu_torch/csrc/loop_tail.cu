// The solve loop's bookkeeping after an iteration's step, in one launch: the
// total energy, the adaptive rate's halving, the previous energy, the
// iteration's telemetry column, the per-axis max |u|, the last max |du|, the
// iteration count and the done flag of the next iteration.
//
// Replaces no TPU kernel. The JAX package's loop (levelsetfusion_tpu/models/
// single_level.py) carries this state through lax.while_loop, which XLA
// fuses.
//
//   energy      = (stats[0] + stats[1]) + stats[2]
//   rate        = rate * 0.5                 adaptive, where energy > prev
//   prev        = energy
//   telemetry[:, iteration] = stats[[0, 1, 2, 4, 3]] / [1, 1, 1, 1, voxels]
//   max_disp[d] = maximum(max_disp[d], stats[5 + d])    NaN wins, as torch's
//   max_update  = stats[4]
//   iteration  += 1
//   active      = iteration < n && max_update >= threshold
//
// all of it only where the flag is set: with the flag off the call returns at
// once and writes nothing (the solve's state is frozen past its gate). Each
// value is the plain version's (loop_tail_reference) float32 result bit for
// bit: the sum in that order, IEEE division by the voxel count (no
// reciprocal), the comparisons false on NaN, so that the rate halves where
// the plain version halves it.
//
// What bounds it on the H100: latency alone. It reads 5 + D + 7 values and
// writes 10 + D; the cost is one launch (in the captured chunk, one graph
// node) and a chain of dependent loads. One warp does it: lane k < 5 a
// telemetry row, lane d < D an axis's max, lane 0 the scalars. Every lane
// reads the flag and the iteration before any lane writes: in the captured
// chunk the flag is the `active` buffer this call writes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kRows = 5;  // telemetry rows

struct Params {
  int dim;          // D, the axes: 2 or 3 (stats hold 5 + D values)
  int n;            // max_iterations; telemetry has n + 1 columns
  float threshold;  // the convergence threshold, as the float32 it is compared as
  float voxels;     // the divisor of the sum of |du|
  int adaptive;     // halve the rate where the energy rose
};

// torch.maximum: NaN if either is NaN (the first one), else the larger.
__device__ __forceinline__ float torch_maximum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

__global__ void __launch_bounds__(kThreads) loop_tail_kernel(
    const float* __restrict__ stats, const unsigned char* flag, float* rate,
    float* prev_energy, float* __restrict__ telemetry, float* __restrict__ max_disp,
    float* max_update, long long* iteration, unsigned char* active, Params p) {
  const int lane = threadIdx.x;
  const bool on = *flag != 0;
  const long long it = *iteration;
  __syncwarp();  // every lane has read the flag and the count before any writes
  if (!on) return;
  if (lane < kRows) {
    // Row k's stat: the data, smoothing and level-set energies, then max |du|
    // (stats[4]) and the sum of |du| (stats[3]) over the voxel count.
    const int stat = lane < 3 ? lane : 7 - lane;
    const float divisor = lane == kRows - 1 ? p.voxels : 1.0f;
    const long long column = it < p.n ? it : p.n;
    telemetry[(long long)lane * (p.n + 1) + column] = __fdiv_rn(stats[stat], divisor);
  }
  if (lane < p.dim) max_disp[lane] = torch_maximum(max_disp[lane], stats[5 + lane]);
  if (lane != 0) return;
  const float energy = __fadd_rn(__fadd_rn(stats[0], stats[1]), stats[2]);
  if (p.adaptive && energy > *prev_energy) *rate = __fmul_rn(*rate, 0.5f);
  *prev_energy = energy;
  const float update = stats[4];
  *max_update = update;
  *iteration = it + 1;
  *active = (it + 1 < p.n) && (update >= p.threshold);
}

}  // namespace

// All pointers are device pointers. stats (5 + dim floats) and flag (one
// byte) in; rate, prev_energy, max_update (one float each), telemetry (5 rows
// of n + 1 floats), max_disp (dim floats), iteration (one int64) and active
// (one byte) updated in place. active may be flag. voxels is the divisor of
// the telemetry's sum of |du|. Launches one warp on `stream`, allocates
// nothing, reads nothing back to the host; capture-safe. Returns a
// cudaError_t.
extern "C" int lsf_loop_tail(const float* stats, const unsigned char* flag, float* rate,
                             float* prev_energy, float* telemetry, float* max_disp,
                             float* max_update, long long* iteration, unsigned char* active,
                             int dim, int n, float threshold, float voxels, int adaptive,
                             void* stream) {
  if (!stats || !flag || !rate || !prev_energy || !telemetry || !max_disp || !max_update ||
      !iteration || !active || dim < 1 || dim > kThreads || n < 0)
    return (int)cudaErrorInvalidValue;
  const Params p = {dim, n, threshold, voxels, adaptive != 0};
  loop_tail_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      stats, flag, rate, prev_energy, telemetry, max_disp, max_update, iteration, active, p);
  return (int)cudaGetLastError();
}

extern "C" const char* lsf_loop_tail_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
