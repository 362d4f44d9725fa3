// Probe of the copy mechanism a tiled fused kernel needs: out = 2a + u0 - u1
// over an (X, Y, Z) float32 volume, computed from haloed windows that are
// staged in shared memory, the next windows' copies in flight while the
// current one is computed.
//
// Replaces the TPU kernel experiments/dma_probe.py::run (line 145, body
// kernel2): manual HBM -> VMEM copies (pltpu.make_async_copy) of windows of
// XB + 2 HX by YB + 2 HY rows around each (XB, YB) output tile, window
// origins clamped into the volume, two slots and a DMA semaphore per copy,
// the interior sliced out of the staged window.
//
// Hopper design: an x-walking ring of plane windows, filled by the Tensor
// Memory Accelerator. A CTA owns one column (YB output rows in y, kZT floats
// in z) and walks one chunk [x0, x1) of x. The column's y window is the TPU's
// (YW rows from the clamped origin clip(j YB - HY, 0, Y - YW)); the chunk
// stages planes max(x0 - HX, 0) .. min(x1 + HX, X) - 1 in order, each once.
// The ring has 2 HX + 1 + kAhead slots of the three fields' (YW, kZT) window
// of one plane: when plane x is computed, planes x - HX .. x + HX (clamped)
// are resident, as a stencil over x would need them, and kAhead further
// planes are in flight. One elected thread issues a plane as two
// cp.async.bulk.tensor.4d copies, a's box {kZT, YW, 1, 1} and u's
// {kZT, YW, 1, 2} (u0 and u1 at once), completed on the slot's mbarrier;
// every thread waits on the barrier's phase parity. A box past Z is
// zero-filled and still counts toward the expected bytes, so a ragged Z needs
// only guarded stores. One __syncthreads a step; after it the elected thread
// refills the slot of the plane that has left the window. The wrapper
// (experiments/dma_probe.py::plan) chooses the chunks so that columns x
// chunks is about one wave of one CTA an SM.
//
// What bounds it on the H100: bytes into shared memory, and each CTA's
// steps. The y halo reads each input YW / YB = 2 times and the x halo adds
// 2 HX planes a chunk: at 128^3 (32 columns, 4 chunks of 32 planes) the
// copies move 3 x 2 x 158/128 + 1 = 8.4 volumes, against 14.5 for the
// per-tile windows of the first port (each input read (XW YW) / (XB YB) = 4.5
// times). Measured (NVIDIA H100 80GB HBM3, 700 W; CUDA events of
// chip_smoke.py phase 10, the first port's from its own dma_probe.main in
// the same call): 19.0 us at 128^3 (the first port 38.5-38.7, the plain
// version 20.0, torch.baddbmm 29.2, bound 10.0) and 109.9 us at 256^3
// (297.3, 184.9, 261.3, bound 80.1). The device time at 128^3 (15.3 us,
// experiments/dma_probe_sweep.py) is about 0.36 us for each of the longest
// chunk's 42 steps, about as much a step at 64-byte rows and at 2 to 7
// planes in flight: a CTA's chain of steps, not bytes, sets it. Three copies
// a plane took 16.6 us, 1-D row copies 137.4 (PERF.md).
//
// The result is exact: 2a is exact, so a contracted 2a + u0 rounds as the
// reference's two operations do.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kXB = 8, kYB = 16, kZB = 8;  // the TPU tile; X, Y, Z multiples of these
constexpr int kHX = 5, kHY = 8;            // halo
constexpr int kXW = kXB + 2 * kHX, kYW = kYB + 2 * kHY;  // window
constexpr int kZT = 32;                    // z extent of a column: 128-byte rows
constexpr int kAhead = 4;                  // planes in flight past the window
constexpr int kUBox = 2;                   // fields of u a copy holds: u0 and u1 at once
constexpr int kSlots = 2 * kHX + 1 + kAhead;
constexpr int kField = kYW * kZT;          // floats of one field in a slot
constexpr uint32_t kFieldBytes = kField * sizeof(float);
constexpr uint32_t kSlotBytes = 3 * kFieldBytes;  // a, u0, u1
constexpr int kSmemBytes = kSlots * (kSlotBytes + 8) + 128;  // slots, barriers, alignment
constexpr int kPerThread = kYB * kZT / kThreads;  // output voxels a thread and step
constexpr uint32_t kWaitLimit = 1u << 22;  // failed try_waits before a trap
static_assert(kYB * kZT % kThreads == 0, "a step's voxels split evenly over the threads");
static_assert(kFieldBytes % 128 == 0, "each field of a slot starts 128-byte aligned");

struct Params {
  const float* a;
  const float* u;
  float* out;
  int nx, ny, nz;
  int tiles_y, columns;  // columns = tiles_y x tiles_z
  int chunk;             // planes of x a CTA computes (the last chunk may have fewer)
};

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed; traps
// (an error at the next synchronisation, not a hang) if a copy never lands.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == kWaitLimit) __trap();
  }
}

// One box of `map` (encode's) at (z, y, x, field) into shared memory at `dst`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int z, int y, int x, int field) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(z), "r"(y), "r"(x), "r"(field)
      : "memory");
}

// Starts the copies of `plane`'s window of a, u0 and u1 into the slot at
// `dst`, completed on `bar`.
__device__ __forceinline__ void issue(const CUtensorMap& map_a, const CUtensorMap& map_u,
                                      const Params& p, uint32_t dst, uint32_t bar, int plane,
                                      int oy, int z0) {
  mbar_expect_tx(bar, kSlotBytes);
  tma_load(dst, map_a, bar, z0, oy, plane, 0);
  for (int c = 0; c < 2; c += kUBox)
    tma_load(dst + (1 + c) * kFieldBytes, map_u, bar, z0, oy, plane, c);
}

__global__ void __launch_bounds__(kThreads, 1)
    dma_probe_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_u, const Params p) {
  extern __shared__ unsigned char smem[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t base = (raw + 127u) & ~127u;
  const float* ring = reinterpret_cast<const float*>(smem + (base - raw));
  const uint32_t bars = base + kSlots * kSlotBytes;

  const int column = blockIdx.x % p.columns;
  const int j = column % p.tiles_y, z0 = column / p.tiles_y * kZT;
  const int x0 = blockIdx.x / p.columns * p.chunk;
  const int x1 = min(x0 + p.chunk, p.nx);
  const int s0 = max(x0 - kHX, 0);          // first staged plane
  const int last = min(x1 + kHX, p.nx) - 1;  // last staged plane
  const int y0 = j * kYB;
  const int oy = min(max(y0 - kHY, 0), p.ny - kYW);  // the TPU's clamped window origin

  int issued = s0;  // next plane to copy (thread 0's)
  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_a))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_u))
                 : "memory");
    for (int s = 0; s < kSlots; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (; issued <= min(last, s0 + kSlots - 1); ++issued) {
      const int k = issued - s0;
      issue(map_a, map_u, p, base + k * kSlotBytes, bars + 8 * k, issued, oy, z0);
    }
  }
  int landed = s0;  // next plane to wait for
  for (int x = x0; x < x1; ++x) {
    // Planes x - HX .. x + HX are resident once x + HX has landed.
    for (const int need = min(x + kHX, p.nx - 1); landed <= need; ++landed) {
      const int k = landed - s0;
      mbar_wait(bars + 8 * (k % kSlots), (k / kSlots) & 1);
    }
    const float* slot = ring + (x - s0) % kSlots * (3 * kField);
    float* row = p.out + ((int64_t)x * p.ny + y0) * p.nz + z0;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int zi = e % kZT, yi = e / kZT;
      const int w = (y0 - oy + yi) * kZT + zi;
      if (z0 + zi < p.nz)
        row[yi * p.nz + zi] = slot[w] * 2.0f + slot[kField + w] - slot[2 * kField + w];
    }
    __syncthreads();  // every thread is past plane x: plane x - HX leaves the window
    if (threadIdx.x == 0) {
      for (; issued <= min(last, x - kHX + kSlots); ++issued) {
        const int k = (issued - s0) % kSlots;
        issue(map_a, map_u, p, base + k * kSlotBytes, bars + 8 * k, issued, oy, z0);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so that
// libcuda is not linked.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// `fields` (nx, ny, nz) float32 volumes one after another at `base`, as the
// 4-D tensor {nz, ny, nx, fields} (innermost first), read in boxes
// {kZT, kYW, 1, box_fields}: a plane's window of box_fields fields a copy.
bool encode(EncodeTiled fn, CUtensorMap* map, const float* base, int nx, int ny, int nz,
            int fields, int box_fields) {
  const cuuint64_t dims[4] = {(cuuint64_t)nz, (cuuint64_t)ny, (cuuint64_t)nx,
                              (cuuint64_t)fields};
  const cuuint64_t row = (cuuint64_t)nz * sizeof(float);
  const cuuint64_t strides[3] = {row, row * ny, row * ny * nx};  // bytes, dims 1-3
  const cuuint32_t box[4] = {kZT, kYW, 1, (cuuint32_t)box_fields};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base), dims, strides,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace

// `chunks`: how many chunks x is cut into, each ceil(nx / chunks) planes
// (dma_probe.plan). Shape rules (else cudaErrorInvalidValue): X a multiple of
// XB with X >= XW, Y a multiple of YB with Y >= YW, Z a multiple of ZB,
// 1 <= chunks <= X; pointers 16-byte aligned. cudaErrorSymbolNotFound if
// libcuda has no cuTensorMapEncodeTiled; the runtime's error if the device
// cannot hold one CTA an SM of the ring.
extern "C" int lsf_dma_probe(const float* a, const float* u, float* out, int nx, int ny,
                             int nz, int chunks, void* stream) {
  if (nx % kXB != 0 || nx < kXW || ny % kYB != 0 || ny < kYW || nz % kZB != 0 ||
      nz < kZB || chunks < 1 || chunks > nx ||
      ((uintptr_t)a | (uintptr_t)u) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map_a, map_u;
  if (!encode(fn, &map_a, a, nx, ny, nz, 1, 1) ||
      !encode(fn, &map_u, u, nx, ny, nz, 2, kUBox))
    return (int)cudaErrorInvalidValue;
  static lsf_occ::WaveCache cache;
  if (lsf_occ::wave((const void*)dma_probe_kernel, kThreads, kSmemBytes, cache) < 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const int chunk = (nx + chunks - 1) / chunks;
  const int tiles_y = ny / kYB, columns = tiles_y * ((nz + kZT - 1) / kZT);
  const Params p{a, u, out, nx, ny, nz, tiles_y, columns, chunk};
  const int ctas = columns * ((nx + chunk - 1) / chunk);
  dma_probe_kernel<<<ctas, kThreads, kSmemBytes, (cudaStream_t)stream>>>(map_a, map_u, p);
  return (int)cudaGetLastError();
}

extern "C" const char* lsf_dma_probe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
