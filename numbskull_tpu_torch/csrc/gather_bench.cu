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
// What bounds it on the H100. A gather is a load whose address is itself
// loaded, so a thread that walks its terms one after another keeps one
// load in flight; and a random 4-byte gather costs a 32-byte sector. At
// the sweep kernel's sizes the card has enough threads for the latency,
// and the rate at which the L1, the L2 (x of 4 MB) or device memory (x
// of 256 MB) serve random sectors binds: a thread with 8 index loads
// issued ahead of its gathers runs no faster than one with a single load
// in flight (PERF.md). Where the design gains:
//
// - the TPU script's shapes (R = 1024): one output's (it, g) terms are
//   split over `shares` threads of a block (8 outputs a block, 128
//   shares each, 128 blocks, where one thread an output filled 8 SMs),
//   the shares' sums added in a fixed tree in shared memory; the window
//   is staged in shared memory (the counterpart of the TPU's VMEM-
//   resident window) beside the block's columns of `off` or the shifts
//   (the TPU's off_ref in VMEM and shift_ref in SMEM), read back per
//   (it, g) with volatile shared loads; a thread holds 4 outputs and
//   issues the index loads of 8 g's before their 32 gathers;
// - the span-8 shifted gather: the shifts are walked in ascending order,
//   so that overlapping windows are read while they are in L2, with a
//   shift and its 32 coalesced loads (4 outputs, 8 blocks) in flight;
// - the global random gather keeps one output a thread, the index loads
//   of 8 terms issued before their gathers (ld.global.nc), the offsets
//   read without allocating L1 lines: with one term after another and
//   ld.global.cg index loads it ran up to 2.6 % slower than the parent
//   design with x of 1 MB to 256 MB (PERF.md).
//
// The plan's two decisions, the window staged or not and the shares of
// an output, come from the shapes in ops/gather.gather_plan; the entry
// points derive the grid and the shared bytes from them.
//
// The iters loop really runs iters times: x and the indices are
// loop-invariant, so a compiler may hoist the loads and multiply, which
// would time one pass and call it `iters`. Every index is therefore read
// from asm volatile (ld.global.L1::no_allocate; ld.volatile.shared when
// staged), a load that may be neither hoisted nor merged, so every
// (it, g) issues its index load and its gathers. chip_smoke.py holds the
// time at 2k iterations to 1.8-2.2x the time at k.
//
// Sums: the values are 0 and 1, so every partial sum is an integer below
// 2^24 and exact in float32 in any order while iters * ng * span < 2^24;
// the kernels equal the plain versions (ops/gather.py) bit for bit
// however the terms are split.
//
// Bounds at the sweep kernel's sizes (R = 1,048,576, 59 gathers an
// output, 247.5 MB of offsets): 0.0764 ms of bytes for an L2-resident x
// of 4 MB; for an x beyond the 50 MB L2 each random 4-byte gather
// fetches a 32-byte sector (0.666 ms), and the span-8 shifted gather
// streams 1.98 GB of overlapping windows (0.59 ms) for 250 MB of
// distinct x. The adds (one per gather) are far below the card's rate.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// both kernels' block; outputs a thread (gather_sum: 4 staged, where
// one 16-byte shared load brings a g's 4 offsets, 1 on the global path)
constexpr int kBlock = 256;
constexpr int kShiftOutputs = 4;
constexpr int kGatherBatch = 8;    // g's whose index loads go ahead
constexpr int kShiftChunk = kBlock;  // shifts staged at a time
// a block may use 227 KB of shared memory (232,448 bytes); above the
// default 48 KB only after cudaFuncSetAttribute
constexpr int64_t kSharedMaxBytes = 232448;
constexpr int64_t kSharedDefaultBytes = 48 * 1024;

// An index load that the compiler may neither hoist out of the iters
// loop nor merge with the same load of another iteration. It allocates
// no L1 line, so the offsets displace none of the gathered window there.
__device__ __forceinline__ int load_index(const int32_t* p) {
  int v;
  asm volatile("ld.global.L1::no_allocate.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int load_shared_index(const int32_t* p) {
  int v;
  asm volatile("ld.volatile.shared.s32 %0, [%1];"
               : "=r"(v)
               : "r"(shared_address(p)));
  return v;
}

__device__ __forceinline__ void load_shared_index4(const int32_t* p,
                                                   int (&v)[4]) {
  asm volatile("ld.volatile.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(shared_address(p)));
}

// x[i]: from the staged window, or through the read-only path
template <bool kStaged>
__device__ __forceinline__ float fetch(const float* __restrict__ x,
                                       const float* xs, int64_t i) {
  return kStaged ? xs[i] : __ldg(x + i);
}

// Adds the shares' partial sums of each output in a fixed tree in
// shared memory (share s takes share s + h's, h = shares / 2 down to 1);
// share 0 holds the totals after. Every thread of the block calls it.
template <int kOut>
__device__ __forceinline__ void add_shares(float (&acc)[kOut], float* red,
                                           int shares, int cols) {
  if (shares == 1) return;
  const int s = threadIdx.x / cols;
#pragma unroll
  for (int k = 0; k < kOut; ++k) red[k * kBlock + threadIdx.x] = acc[k];
  __syncthreads();
  for (int h = shares / 2; h > 0; h /= 2) {
    if (s < h) {
#pragma unroll
      for (int k = 0; k < kOut; ++k)
        red[k * kBlock + threadIdx.x] +=
            red[k * kBlock + threadIdx.x + h * cols];
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = red[k * kBlock + threadIdx.x];
}

// outputs a thread
__host__ __device__ constexpr int gather_outputs(bool staged) {
  return staged ? 4 : 1;
}

// Registers: at most 64 a thread when staged (the window bounds the
// blocks a multiprocessor holds), at most 80 otherwise.
// A block: kBlock threads, `shares` of them (a power of two) on each of
// its cols = kBlock / shares columns, thread (s, q) at s * cols + q; the
// block's cols * kOut outputs start at blockIdx.x * cols * kOut. Staged,
// column q holds the 4 consecutive outputs from r0 + 4q (one 16-byte
// shared load of a g's offsets); on the global path one output, r0 + q:
// 4 outputs a thread there (32 gathers in flight) ran no faster with x
// in L2 or device memory, whose random-sector rates bind there and not
// the loads in flight (PERF.md). kGatherBatch g's have their index
// loads issued ahead of their gathers. Share s takes the terms t = s,
// s + shares, ... of the (it, g) sequence t = it * ng + g. Shared
// memory: the staged offsets (ng rows of the block's columns), the
// shares' partial sums, the staged window.
template <bool kStaged>
__global__ void __launch_bounds__(kBlock, kStaged ? 4 : 3)
    gather_sum_kernel(const float* __restrict__ x, int64_t nx,
                      const int32_t* __restrict__ off,
                      float* __restrict__ out, int R, int ng, int iters,
                      int shares) {
  constexpr int kOut = gather_outputs(kStaged), kBatch = kGatherBatch;
  extern __shared__ __align__(16) unsigned char smem[];
  const int cols = kBlock / shares;
  const int q = threadIdx.x % cols, s = threadIdx.x / cols;
  const int per_block = cols * kOut;
  const int r0 = blockIdx.x * per_block;
  int32_t* offs = reinterpret_cast<int32_t*>(smem);
  float* red = reinterpret_cast<float*>(offs + (kStaged ? ng * per_block : 0));
  float* xs = red + (shares > 1 ? kBlock * kOut : 0);
  if (kStaged) {
    for (int64_t i = threadIdx.x; i < nx; i += kBlock) xs[i] = x[i];
    // columns beyond R read offset 0; their sums are never stored
    for (int i = threadIdx.x; i < ng * per_block; i += kBlock) {
      const int g = i / per_block, r = r0 + i - g * per_block;
      offs[i] = r < R ? off[static_cast<int64_t>(g) * R + r] : 0;
    }
    __syncthreads();
  }
  const int first = r0 + kOut * q;
  // the global path's column, clamped into [0, R) (a column beyond R
  // reads a valid one and is never stored)
  const int col = min(first, R - 1);
  float acc[kOut] = {};
  const int64_t total = static_cast<int64_t>(iters) * ng;
  if (s < total) {
    int g = s % ng;
    const int dg = shares % ng;
    // the index loads of up to kBatch terms, then their gathers
    auto batch = [&](int m) {
      int idx[kBatch][kOut];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (b < m) {
          if constexpr (kStaged)
            load_shared_index4(offs + g * per_block + kOut * q, idx[b]);
          else
            idx[b][0] = load_index(off + static_cast<int64_t>(g) * R + col);
          g += dg;
          if (g >= ng) g -= ng;
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (b < m) {
#pragma unroll
          for (int k = 0; k < kOut; ++k)
            acc[k] += fetch<kStaged>(x, xs, idx[b][k]);
        }
      }
    };
    const int64_t step = static_cast<int64_t>(kBatch) * shares;
    int64_t t = s;
    for (; t + step - shares < total; t += step) batch(kBatch);
    batch(static_cast<int>((total - t + shares - 1) / shares));
  }
  add_shares<kOut>(acc, red, shares, cols);
  if (s == 0) {
#pragma unroll
    for (int k = 0; k < kOut; ++k)
      if (first + k < R) out[first + k] = acc[k];
  }
}

// The block, thread and share layout of gather_sum_kernel, outputs r0 +
// q + cols * k (so each load of a warp is one coalesced run). The shifts
// are staged kShiftChunk at a time and sorted there (ascending, ties in
// order), so that the blocks, which walk the shifts in step, read
// windows that overlap the last ones while those are still in L2: with
// 59 shifts over a 256 MB window, a (g, j) window of 4 MB overlaps about
// 8 others. Share s takes the terms t = s, s + shares, ... of each
// chunk's (it, rank) sequence. kSpan: 1 or 8 unrolled, 0 for a runtime
// span; kBatch shifts are read ahead of their gathers. Shared memory:
// the chunk's shifts, the shares' partial sums, the staged window.
template <bool kStaged, int kSpan, int kBatch>
__global__ void __launch_bounds__(kBlock, 4)
    shifted_sum_kernel(const float* __restrict__ x, int64_t nx,
                       const int32_t* __restrict__ shift,
                       float* __restrict__ out, int R, int ng, int span,
                       int iters, int shares) {
  constexpr int kOut = kShiftOutputs;
  extern __shared__ __align__(16) unsigned char smem[];
  const int cols = kBlock / shares;
  const int q = threadIdx.x % cols, s = threadIdx.x / cols;
  const int r0 = blockIdx.x * cols * kOut;
  int32_t* sh = reinterpret_cast<int32_t*>(smem);
  float* red = reinterpret_cast<float*>(sh + min(ng, kShiftChunk));
  float* xs = red + (shares > 1 ? kBlock * kOut : 0);
  if (kStaged)   // synchronised with the first chunk's shifts
    for (int64_t i = threadIdx.x; i < nx; i += kBlock) xs[i] = x[i];
  int col[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) col[k] = min(r0 + q + cols * k, R - 1);
  const int sp = kSpan > 0 ? kSpan : span;
  float acc[kOut] = {};
  for (int g0 = 0; g0 < ng; g0 += kShiftChunk) {
    const int n = min(kShiftChunk, ng - g0);
    if (g0 > 0) __syncthreads();   // the previous chunk is done
    // each of the chunk's shifts goes to its rank: one a thread
    int v = 0, rank = 0;
    if (threadIdx.x < n) {
      v = shift[g0 + threadIdx.x];
      sh[threadIdx.x] = v;
    }
    __syncthreads();
    if (threadIdx.x < n)
      for (int u = 0; u < n; ++u) {
        const int w = sh[u];
        rank += w < v || (w == v && u < static_cast<int>(threadIdx.x));
      }
    __syncthreads();
    if (threadIdx.x < n) sh[rank] = v;
    __syncthreads();
    const int64_t total = static_cast<int64_t>(iters) * n;
    if (s >= total) continue;
    int g = s % n;
    const int dg = shares % n;
    auto batch = [&](int m) {
      int c[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (b < m) {
          c[b] = load_shared_index(sh + g);
          g += dg;
          if (g >= n) g -= n;
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (b < m) {
#pragma unroll(kSpan > 0 ? kSpan : 1)
          for (int j = 0; j < sp; ++j) {
            const int64_t base = c[b] + static_cast<int64_t>(R) * j;
#pragma unroll
            for (int k = 0; k < kOut; ++k)
              acc[k] += fetch<kStaged>(x, xs, base + col[k]);
          }
        }
      }
    };
    const int64_t step = static_cast<int64_t>(kBatch) * shares;
    int64_t t = s;
    for (; t + step - shares < total; t += step) batch(kBatch);
    batch(static_cast<int>((total - t + shares - 1) / shares));
  }
  add_shares<kOut>(acc, red, shares, cols);
  if (s == 0) {
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const int r = r0 + q + cols * k;
      if (r < R) out[r] = acc[k];
    }
  }
}

// Allow `kernel` `bytes` of dynamic shared memory (needed above 48 KB).
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int64_t bytes) {
  if (bytes <= kSharedDefaultBytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// One launch of `kernel` for R outputs, kOut a thread, with `shares` (a
// power of two up to kBlock) threads an output and `words` 4-byte words
// of dynamic shared memory besides the shares' partial sums; refuses a
// layout no kernel takes.
template <int kOut, typename Kernel, typename... Args>
int launch(Kernel kernel, int R, int shares, int64_t words, void* stream,
           Args... args) {
  if (shares < 1 || shares > kBlock || (shares & (shares - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = kBlock / shares * kOut;
  const int64_t bytes = 4 * (words + (shares > 1 ? kBlock * kOut : 0));
  if (bytes > kSharedMaxBytes) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(R + per_block - 1) / per_block, kBlock,
           static_cast<size_t>(bytes), static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

// every kernel, as nsx_gather_attrs numbers them
const void* const kKernels[] = {
    reinterpret_cast<const void*>(gather_sum_kernel<true>),
    reinterpret_cast<const void*>(gather_sum_kernel<false>),
    reinterpret_cast<const void*>(shifted_sum_kernel<true, 1, kGatherBatch>),
    reinterpret_cast<const void*>(shifted_sum_kernel<true, 8, 1>),
    reinterpret_cast<const void*>(shifted_sum_kernel<true, 0, 1>),
    reinterpret_cast<const void*>(shifted_sum_kernel<false, 1, kGatherBatch>),
    reinterpret_cast<const void*>(shifted_sum_kernel<false, 8, 1>),
    reinterpret_cast<const void*>(shifted_sum_kernel<false, 0, 1>)};

}  // namespace

// out[r] = sum_{i<iters} sum_{g<ng} x[off[g * R + r]] for r < R; x holds
// nx float32, off (ng, R) int32 offsets into x, which the caller has
// checked lie in [0, nx). The plan (ops/gather.gather_plan): the window
// staged in shared memory or not, and the shares of an output. One
// launch on `stream`; returns the launch error, cudaErrorInvalidValue
// for a plan these kernels do not take.
extern "C" int nsx_gather_sum(const float* x, int64_t nx, const int32_t* off,
                              float* out, int R, int ng, int iters,
                              int staged, int shares, void* stream) {
  if (nx <= 0 || R <= 0 || ng < 0 || iters < 0 || shares < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!staged)
    return launch<gather_outputs(false)>(gather_sum_kernel<false>, R, shares,
                                         0, stream, x, nx, off, out, R, ng,
                                         iters, shares);
  constexpr int kOut = gather_outputs(true);
  const int64_t per_block = kBlock / shares * kOut;
  return launch<kOut>(gather_sum_kernel<true>, R, shares,
                      ng * per_block + nx, stream, x, nx, off, out, R, ng,
                      iters, shares);
}

// out[r] = sum_{i<iters} sum_{g<ng} sum_{j<span} x[shift[g] + R j + r] for
// r < R; shift (ng,) int32, which the caller has checked satisfies
// 0 <= shift[g] and shift[g] + R * span <= nx. The plan as for
// nsx_gather_sum. One launch on `stream`; returns the launch error,
// cudaErrorInvalidValue for a plan these kernels do not take.
extern "C" int nsx_shifted_sum(const float* x, int64_t nx,
                               const int32_t* shift, float* out, int R,
                               int ng, int span, int iters, int staged,
                               int shares, void* stream) {
  if (nx <= 0 || R <= 0 || ng < 0 || span < 1 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t words = (ng < kShiftChunk ? ng : kShiftChunk) +
                        (staged ? nx : 0);
  const auto kernel =
      staged ? (span == 1   ? shifted_sum_kernel<true, 1, kGatherBatch>
                : span == 8 ? shifted_sum_kernel<true, 8, 1>
                            : shifted_sum_kernel<true, 0, 1>)
             : (span == 1   ? shifted_sum_kernel<false, 1, kGatherBatch>
                : span == 8 ? shifted_sum_kernel<false, 8, 1>
                            : shifted_sum_kernel<false, 0, 1>);
  return launch<kShiftOutputs>(kernel, R, shares, words, stream, x, nx, shift,
                               out, R, ng, span, iters, shares);
}

// Registers and local memory a thread (spills and local arrays) of kernel
// `which`, in the order of GATHER_KERNELS in ops/gather.py.
extern "C" int nsx_gather_attrs(int which, int* regs, int* local_bytes) {
  constexpr int n = sizeof(kKernels) / sizeof(kKernels[0]);
  if (which < 0 || which >= n) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(&a, kKernels[which]);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
