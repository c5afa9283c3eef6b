// Checkerboard Gibbs sampling of an n x m Ising lattice with EQUAL
// couplings of weight w and an ISTRUE bias b on every site.
//
// Replaces numbskull_tpu/ops/stencil_pallas.py::_gibbs_kernel (the Pallas
// TPU kernel launched by PallasGridGibbsEngine). What it computes is the
// same: per sweep, half-step 0 resamples the cells with (row + col) even
// and half-step 1 those with (row + col) odd, each from its up, down,
// left and right neighbours:
//   dpot = 2w (2s - deg) + 2b,  s = sum of the neighbours' values,
//   deg = number of neighbours (4 inside, 3 on an edge, 2 in a corner),
//   P(x = 1) = sigmoid(dpot);
// the burn-in sweeps are not tallied, and after each tallied sweep every
// cell's value is added to its count. The TPU kernel keeps the lattice in
// VMEM and therefore caps it at 1024 x 1024 cells; here the lattice lives
// in device memory and has no cap.
//
// How: one thread per cell and two launches per sweep, the tally fused
// into the second half-step's launch (cells of the other parity add the
// value they were given in the first launch). A half-step only writes
// cells of its own parity and only reads cells of the other, so no cell
// is read and written by one launch. The whole (burn, epochs) loop runs
// in nsx_stencil_gibbs, a host loop of the shared library: one ctypes
// call per run, not one Python call per launch.
//
// The draw: the TPU kernel draws with the TPU's hardware PRNG, which no
// other device reproduces; the port draws with the counter hash the
// itemgrid kernels use (hash_uniform, itemgrid_common.cuh) on the same
// 24-bit grid, (bits >> 8) * 2^-24, with seed int32(seed * 977), salt
// 2 * sweep + half (burn-in sweeps counted) and position (row, col).
// dpot is one fma, as XLA's CPU backend contracts 2w (2s - deg) + 2b;
// the draw is new = [u * (1 + expf(-dpot)) < 1], the boolean draw of the
// itemgrid sweep kernel, so that ops/stencil_kernel.grid_gibbs_reference
// computes the same bits with torch.exp.
//
// What bounds it on the H100: bytes. A sweep must read and write the
// lattice and the counts once each, 16 B per cell (16.8 MB at
// 1024 x 1024); these two launches read the lattice twice, 20 B per cell.
// The lattice and counts (8 B per cell, 8 MB at 1024 x 1024) stay in the
// 50 MB L2 up to about 2500 x 2500 cells, so there the DRAM-rate bound is
// a loose floor, and DRAM bandwidth bounds it only on larger lattices.
// The arithmetic (a hash, one expf, about 30 operations per updated cell)
// is far below the card's rate. Later work: one thread per cell of the
// half-step's parity, several sweeps per launch on tiles held in shared
// memory, and a CUDA graph for the launch loop.

#include "itemgrid_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
    stencil_half_kernel(int32_t* __restrict__ x, int32_t* __restrict__ count,
                        int n, int m, float two_w, float two_b,
                        uint32_t seed977, uint32_t salt, int parity,
                        int tally) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= m) return;
  for (int r = blockIdx.y; r < n; r += gridDim.y) {
    const int64_t i = static_cast<int64_t>(r) * m + c;
    int v = x[i];
    if (((r + c) & 1) == parity) {
      const int s = (r > 0 ? x[i - m] : 0) + (r < n - 1 ? x[i + m] : 0) +
                    (c > 0 ? x[i - 1] : 0) + (c < m - 1 ? x[i + 1] : 0);
      const int deg = 4 - (r == 0) - (r == n - 1) - (c == 0) - (c == m - 1);
      const float dpot =
          __fmaf_rn(two_w, static_cast<float>(2 * s - deg), two_b);
      const float u = hash_uniform(seed977, salt, static_cast<uint32_t>(r),
                                   static_cast<uint32_t>(c));
      const float z = expf(-dpot);
      v = __fmul_rn(u, __fadd_rn(1.0f, z)) < 1.0f ? 1 : 0;
      x[i] = v;
    }
    if (tally) count[i] += v;
  }
}

}  // namespace

// burn + epochs sweeps of the lattice x (n x m int32, row-major, in
// place); count (n x m int32) gains every tallied sweep's values. Two
// launches per sweep on `stream`; returns the first launch error (0 when
// all launched).
extern "C" int nsx_stencil_gibbs(int32_t* x, int32_t* count, int n, int m,
                                 float two_w, float two_b, int seed977,
                                 int burn, int epochs, void* stream) {
  if (n <= 0 || m <= 0 || burn < 0 || epochs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + kThreads - 1) / kThreads,
                  n < kMaxGridY ? n : kMaxGridY);
  for (int s = 0; s < burn + epochs; ++s) {
    for (int half = 0; half < 2; ++half) {
      stencil_half_kernel<<<grid, kThreads, 0, st>>>(
          x, count, n, m, two_w, two_b, static_cast<uint32_t>(seed977),
          2u * static_cast<uint32_t>(s) + static_cast<uint32_t>(half), half,
          half == 1 && s >= burn);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaSuccess);
}
