// The random and the shifted gather of the itemgrid sweep, as kernels of
// their own: the microbenchmarks of the gather that the sweep kernel
// depends on.
//
// Replaces the Pallas TPU kernels of experiments/micro_gather.py
// (make_kernel, every mode) and experiments/micro_gather2.py (make_kernel,
// every mode). On the TPU every mode computes one of two functions of a
// window x of 0/1 floats, out of VMEM, `iters` times over:
//   random modes (f32_row, bf16_row, bf16_lane, bf16_lane_unr, bf16_batch,
//   fact, take):  out[r] = iters * sum_g x[off[g, r]]
//   shifted modes (roll, roll_unr; roll64 with span 8):
//                 out[r] = iters * sum_g sum_{j<span} x[shift[g] + R j + r]
// The modes differ only in how the TPU, which has no vector gather, builds
// the gather: one-hot matmuls on the MXU, lane rolls, factorized one-hots.
// A GPU thread gathers with one load, so the modes collapse to the two
// kernels here, gather_sum and shifted_sum, with R = 1024 at the TPU
// script's shapes and any R >= 1 elsewhere.
//
// How: one thread per output r; the loop over g reads off[g, r]
// coalesced (neighbouring threads, neighbouring r) and gathers x. Where
// the whole window fits in shared memory (the TPU script's windows, 8 to
// 70 KB) every block stages it there first, the counterpart of the TPU's
// VMEM-resident window; otherwise the gathers go to L2 or device memory.
// The iters loop really runs iters times: x and the indices are
// loop-invariant, so a compiler may hoist the loads and multiply, which
// would time one pass and call it `iters`. Each index is therefore read
// with `ld.global.cg` from asm volatile, a load that may be neither
// hoisted nor merged, so every (i, g) issues its index load and its
// gather. chip_smoke.py holds the time at 2k iterations to 1.8-2.2x the
// time at k.
//
// Sums: the values are 0 and 1, so every partial sum is an integer below
// 2^24 and exact in float32 in any order; the kernels equal the plain
// versions (ops/gather.py) bit for bit.
//
// What bounds it on the H100: bytes. The offsets are read once (4 B per
// gather) and x once; at the sweep kernel's sizes (R = 1,048,576, 59
// gathers per output, 247.5 MB of offsets) that is 0.0764 ms at
// 3.35 TB/s for an L2-resident x of 4 MB. For an x beyond the 50 MB L2
// each random 4-byte gather fetches a 32-byte sector from device memory,
// so the sector traffic (8x the useful bytes) is the practical bound
// there. The adds (one per gather) are far below the card's rate.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
// a block may use 227 KB of shared memory (232,448 bytes); above the
// default 48 KB only after cudaFuncSetAttribute
constexpr int64_t kSharedMaxBytes = 232448;
constexpr int64_t kSharedDefaultBytes = 48 * 1024;

// An index load that the compiler may neither hoist out of the iters
// loop nor merge with the same load of another iteration.
__device__ __forceinline__ int load_index(const int32_t* p) {
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// The window x, staged into shared memory when kStaged.
template <bool kStaged>
__device__ __forceinline__ const float* window(const float* __restrict__ x,
                                               int64_t nx, float* xs) {
  if (!kStaged) return x;
  for (int64_t i = threadIdx.x; i < nx; i += blockDim.x) xs[i] = x[i];
  __syncthreads();
  return xs;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    gather_sum_kernel(const float* __restrict__ x, int64_t nx,
                      const int32_t* __restrict__ off,
                      float* __restrict__ out, int R, int ng, int iters) {
  extern __shared__ float xs[];
  const float* src = window<kStaged>(x, nx, xs);
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  float acc = 0.0f;
  for (int it = 0; it < iters; ++it)
    for (int g = 0; g < ng; ++g)
      acc += src[load_index(off + static_cast<int64_t>(g) * R + r)];
  out[r] = acc;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    shifted_sum_kernel(const float* __restrict__ x, int64_t nx,
                       const int32_t* __restrict__ shift,
                       float* __restrict__ out, int R, int ng, int span,
                       int iters) {
  extern __shared__ float xs[];
  const float* src = window<kStaged>(x, nx, xs);
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  float acc = 0.0f;
  for (int it = 0; it < iters; ++it)
    for (int g = 0; g < ng; ++g) {
      const int64_t base = static_cast<int64_t>(load_index(shift + g)) + r;
      for (int j = 0; j < span; ++j)
        acc += src[base + static_cast<int64_t>(R) * j];
    }
  out[r] = acc;
}

// Allow `kernel` `bytes` of dynamic shared memory (needed above 48 KB).
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int64_t bytes) {
  if (bytes <= kSharedDefaultBytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// out[r] = sum_{i<iters} sum_{g<ng} x[off[g * R + r]] for r < R; x holds
// nx float32, off (ng, R) int32 offsets into x, which the caller has
// checked lie in [0, nx). One launch on `stream`, the window staged in
// shared memory when it fits; returns the launch error.
extern "C" int nsx_gather_sum(const float* x, int64_t nx, const int32_t* off,
                              float* out, int R, int ng, int iters,
                              void* stream) {
  if (nx <= 0 || R <= 0 || ng < 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + kThreads - 1) / kThreads);
  const int64_t bytes = nx * static_cast<int64_t>(sizeof(float));
  if (bytes <= kSharedMaxBytes) {
    const cudaError_t err = allow_shared(gather_sum_kernel<true>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    gather_sum_kernel<true><<<grid, kThreads, static_cast<size_t>(bytes),
                              st>>>(x, nx, off, out, R, ng, iters);
  } else {
    gather_sum_kernel<false><<<grid, kThreads, 0, st>>>(x, nx, off, out, R,
                                                        ng, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[r] = sum_{i<iters} sum_{g<ng} sum_{j<span} x[shift[g] + R j + r] for
// r < R; shift (ng,) int32, which the caller has checked satisfies
// 0 <= shift[g] and shift[g] + R * span <= nx. One launch on `stream`, the
// window staged in shared memory when it fits; returns the launch error.
extern "C" int nsx_shifted_sum(const float* x, int64_t nx,
                               const int32_t* shift, float* out, int R,
                               int ng, int span, int iters, void* stream) {
  if (nx <= 0 || R <= 0 || ng < 0 || span < 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + kThreads - 1) / kThreads);
  const int64_t bytes = nx * static_cast<int64_t>(sizeof(float));
  if (bytes <= kSharedMaxBytes) {
    const cudaError_t err = allow_shared(shifted_sum_kernel<true>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    shifted_sum_kernel<true><<<grid, kThreads, static_cast<size_t>(bytes),
                               st>>>(x, nx, shift, out, R, ng, span,
                                     iters);
  } else {
    shifted_sum_kernel<false><<<grid, kThreads, 0, st>>>(
        x, nx, shift, out, R, ng, span, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
