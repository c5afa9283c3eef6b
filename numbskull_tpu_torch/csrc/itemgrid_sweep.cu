// Fused chromatic Gibbs inference step for one color of a factor graph.
//
// Replaces numbskull_tpu/ops/itemgrid_pallas.py::_make_kernel (the Pallas
// TPU kernel launched by PallasItemGridEngine). What it computes is the
// same: for every variable (row) of one color, (1) gather its factors'
// argument values, (2) evaluate every factor at every candidate value of
// the row's variable, (3) sum weight x value into per-candidate
// potentials, (4) draw the new value by a masked inverse CDF (or the
// one-exp boolean form), (5) store it, and (6) after burn-in tally the
// drawn value. How it computes it is not the TPU's: a GPU gathers
// natively, so values stay in original variable order in device memory,
// item tables are CSR arrays read directly, and there is one launch per
// (epoch, color) with one thread per row, so no atomics are needed.
//
// What bounds it on the H100: the memory traffic of every epoch. It
// streams the item tables (25 B of metadata per item, 13 B per
// argument) and gathers argument values (x[arg_vid]) and weights
// (w[wid]) behind them, each gather a load that depends on the one
// before. At high cardinality the per-thread potential array pot[KMAX]
// (local memory at KMAX 32 and 128) and the KMAX-fold re-evaluation of
// every dense item add to that. Whether DRAM bandwidth or the latency of
// the dependent loads sets the time is not measured: counted from the
// table shapes, an epoch of a 1024x1024 Ising reads about 256 MB, which
// at 0.18 ms is an estimated 41 % of the 3.35 TB/s peak (H100 80GB
// HBM3, 700 W), too far below it to call the kernel bandwidth-bound.
// Later work: pack the item metadata into one 16-byte load and
// the arguments into 8 bytes, stage a block's argument values in
// shared memory, evaluate the candidates of one item across a warp at
// high cardinality, and run all epochs of a sweep in one persistent
// launch.
//
// Draw inputs reproduce the TPU kernel's software path exactly: the
// counter hash of _uniform_sw (itemgrid_pallas.py:1047), the (epoch,
// color, block) salts, the `row` and `tile` position maps, and the three
// draw formulas _draw, _draw_vec and _draw2 (the first two, the hash and
// the factor semantics live in itemgrid_common.cuh, shared with the
// learn kernel).
//
// Every read goes through `xr`. For a color that is not independent
// (--max_colors lets neighbours share the last color) the wrapper passes
// a snapshot of x taken before the launch, so each row sees the values
// from before the step, as the plain version does; otherwise xr == x.
//
// Graph-sharded runs (ops/itemgrid_mc.py, the counterpart of the TPU's
// multi-chip kernel, itemgrid_pallas.py:3259 and :3478) launch this
// kernel on one shard's tables with the shard's seed and salt. A
// non-null `send` makes each row also write its value after the step to
// send[row - row0]: the packed half of the per-color exchange
// (itemgrid_exchange.cu unpacks it into the other replicas). With a
// null `send` the kernel runs as before.
//
// Partitioned (BSP) inference (parallel/bsp.BSPItemGridInference) needs
// the TPU kernel's has_ext form (itemgrid_pallas.py:1840-1845, :1862-1868,
// :1920-1924): a non-null `ext`, a (V, kext) float32 table in variable
// order, adds ext[vid, k] to the row's potentials for k < min(kmax, kext)
// after the items and before the draw, so the boolean draw computes
// expf((p0 + e0) - (p1 + e1)) as the TPU's _draw2 does. The table adds
// V x kmax x 4 bytes to a launch's reads (8.4 MB per epoch on a 1M-variable
// boolean graph). With a null `ext` the kernel runs as before.

#include "itemgrid_common.cuh"

namespace {

enum : int { MAP_ROW = 0, MAP_TILE = 1 };
enum : int { DRAW_CDF = 0, DRAW_VEC = 1, DRAW_SIGMOID2 = 2 };

struct Step {
  const float* weights;
  const int32_t* xr;  // values read (x, or its snapshot)
  int32_t* x;
  int32_t* counts;
  int32_t* send;      // packed values after the step, or null
  const float* ext;   // (V, kext) external potentials, or null
  int row0, n_rows, kmax, map_kind, draw_kind;
  uint32_t seed977, salt16;
  int tally, kext;
};

// the row's uniform under the step's position map
__device__ __forceinline__ float uniform01(const Step& p, int upos) {
  const uint32_t blk = static_cast<uint32_t>(upos) >> 10;
  const uint32_t pos = static_cast<uint32_t>(upos) & 1023u;
  const uint32_t i0 = p.map_kind == MAP_TILE ? pos >> 7 : 0u;
  const uint32_t i1 = p.map_kind == MAP_TILE ? pos & 127u : pos;
  return hash_uniform(p.seed977, p.salt16 + blk, i0, i1);
}

template <int KMAX>
__global__ void __launch_bounds__(128)
    sweep_color_kernel(const Tables t, const Step p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n_rows) return;
  const int r = p.row0 + i;
  const int vid = t.row_vid[r];
  const int card = t.row_card[r];
  const int K = p.kmax;

  float pot[KMAX];
  for_k<KMAX>([&](int k) { pot[k] = 0.0f; });
  const int it_end = t.row_item[r + 1];
  for (int it = t.row_item[r]; it < it_end; ++it) {
    const int ftype = t.it_ftype[it];
    const float w = p.weights[t.it_wid[it]];
    const int a0 = t.it_arg[it];
    const int arity = t.it_arity[it];
    const bool dense = t.it_dense[it] != 0;
    const int d1 = t.it_d1[it], d2 = t.it_d2[it];
    // the dense / d1 / d2 rule of ops/gibbs.color_potentials
    for_k<KMAX>([&](int k) {
      const bool ok = dense ? k < card : (k == d1 || k == d2);
      if (ok) {
        const float e = eval_item(t, p.xr, ftype, a0, arity, k);
        pot[k] = __fadd_rn(pot[k], __fmul_rn(w, e));
      }
    });
  }
  add_ext<KMAX>(pot, p.ext, vid, K, p.kext);

  const float u01 = uniform01(p, t.row_upos[r]);
  int nv;
  if (p.draw_kind == DRAW_SIGMOID2) {
    const float z = expf(__fsub_rn(pot[0], pot[1]));
    nv = __fmul_rn(u01, __fadd_rn(1.0f, z)) < 1.0f ? 1 : 0;
  } else if (p.draw_kind == DRAW_VEC) {
    nv = draw_vec<KMAX>(pot, card, K, u01);
  } else {
    nv = draw_cdf<KMAX>(pot, card, K, u01);
  }

  const int flags = t.row_flags[r];
  int v = p.xr[vid];
  if (flags & ROW_UPDATE) {
    v = nv;
    p.x[vid] = nv;
  }
  if (p.send) p.send[i] = v;
  if (p.tally && (flags & ROW_TALLY)) p.counts[static_cast<int64_t>(vid) * K + v] += 1;
}

template <int KMAX>
cudaError_t launch(const Tables& t, const Step& p, cudaStream_t stream) {
  constexpr int threads = 128;
  const int blocks = (p.n_rows + threads - 1) / threads;
  sweep_color_kernel<KMAX><<<blocks, threads, 0, stream>>>(t, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nsx_itemgrid_sweep_color(
    const int32_t* row_vid, const int32_t* row_card, const int32_t* row_upos,
    const int8_t* row_flags, const int32_t* row_item,
    const int32_t* it_ftype, const int32_t* it_wid, const int32_t* it_arity,
    const int32_t* it_arg, const int8_t* it_dense, const int32_t* it_d1,
    const int32_t* it_d2, const int32_t* arg_vid, const int32_t* arg_eq,
    const int32_t* arg_card, const int8_t* arg_subst, const float* weights,
    const int32_t* xr, int32_t* x, int32_t* counts, int32_t* send,
    const float* ext, int row0, int n_rows, int kmax, int map_kind,
    int draw_kind, int seed977, int salt16, int tally, int kext,
    void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  if (ext != nullptr && kext < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Tables t{row_vid, row_card, row_upos, row_flags, row_item,
                 it_ftype, it_wid,  it_arity, it_arg,    it_dense,
                 it_d1,    it_d2,   arg_vid,  arg_eq,    arg_card,
                 arg_subst};
  const Step p{weights, xr, x, counts, send, ext, row0, n_rows, kmax, map_kind,
               draw_kind, static_cast<uint32_t>(seed977),
               static_cast<uint32_t>(salt16), tally, kext};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (kmax <= 2) return static_cast<int>(launch<2>(t, p, s));
  if (kmax <= 8) return static_cast<int>(launch<8>(t, p, s));
  if (kmax <= 32) return static_cast<int>(launch<32>(t, p, s));
  if (kmax <= 128) return static_cast<int>(launch<128>(t, p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
