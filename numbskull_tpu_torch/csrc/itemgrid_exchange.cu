// The per-color exchange of graph-sharded Gibbs sampling: scatter the
// rows that the other shards resampled into this replica of the chains.
//
// Replaces numbskull_tpu/ops/itemgrid_pallas.py::_exchange_color (and its
// miniature, the kernel of tests/test_itemgrid_mc.py:112). On the TPU,
// after color c each device sends its updated row blocks to every peer
// with remote DMAs from inside the kernel and waits for theirs; values
// there live color-major, so a shard's rows are one contiguous block.
// The port keeps values in original variable order, so the exchange is
// a gather around a contiguous transfer: the sweep and learn-step
// kernels pack each row's new value at send[row - row0] (their optional
// `send` pointers), the transfer moves those buffers (nothing to move
// for shards in one process, which write straight into one payload; an
// all_gather over torch.distributed otherwise), and this kernel scatters
// every peer's buffer into the replica at the peer's row_vid.
//
// Layout: the step's rows of every shard, concatenated in shard order,
// are vid[offs[d] .. offs[d+1]); shard d's buffer starts at
// payload[d * stride], the free chain's values first and, in learning,
// the clamped chain's `rs` entries later. Rows of shard `skip` (this
// replica's own, already in place) are left alone.
//
// What bounds it on the H100: bytes. Each row moved reads its vid and
// its value (8 B, 12 B with the clamped chain) and writes one scattered
// int32 (two in learning); one thread per row, no reuse. The writes land
// in 32-byte sectors shared with rows of other shards, so the scatter
// moves more than the 4 B it stores when a color's rows are spread out.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void __launch_bounds__(256)
    unpack_kernel(const int32_t* vid, const int32_t* offs,
                  const int32_t* payload, int32_t* x, int32_t* xe,
                  int n_total, int n_g, int stride, int rs, int skip_lo,
                  int skip_hi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_total || (i >= skip_lo && i < skip_hi)) return;
  int d = 0;
  while (d + 1 < n_g && i >= offs[d + 1]) ++d;
  const int64_t src = static_cast<int64_t>(d) * stride + (i - offs[d]);
  const int v = vid[i];
  x[v] = payload[src];
  if (xe) xe[v] = payload[src + rs];
}

}  // namespace

extern "C" int nsx_exchange_unpack(const int32_t* vid, const int32_t* offs,
                                   const int32_t* payload, int32_t* x,
                                   int32_t* xe, int n_total, int n_g,
                                   int stride, int rs, int skip_lo,
                                   int skip_hi, void* stream) {
  if (n_total <= 0) return static_cast<int>(cudaGetLastError());
  unpack_kernel<<<(n_total + 255) / 256, 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      vid, offs, payload, x, xe, n_total, n_g, stride, rs, skip_lo,
      skip_hi);
  return static_cast<int>(cudaGetLastError());
}
