// Dual-chain SGD weight learning for one color of a factor graph.
//
// Replaces numbskull_tpu/ops/itemgrid_pallas.py::_make_learn_kernel (the
// Pallas TPU kernel launched by PallasItemGridEngine.learn). What it
// computes per (epoch, color) is the same: for every variable (row) of
// the color, the potentials of the free chain x and of the clamped chain
// xe at every candidate value, one `cdf` draw per chain (the free chain
// resamples query and evidence rows, the clamped chain query rows only),
// then for every item of the row the gradient (eval at the free chain's
// new value - eval at the clamped chain's new value) x featureValue; per
// weight the gradients and their count sum, and the weight takes one
// step (mean or sum, L2 shrinkage or L1 truncated gradient, fixed weights
// skipped). The burn-in of the free chain runs the sweep kernel.
//
// How: three launches on one stream per (epoch, color).
//   learn_step_kernel    one thread per row: both chains' potentials and
//                        draws, the new values, and each item's
//                        (gradient, counted) into per-item scratch;
//   learn_reduce_kernel  one warp per chunk of at most 1024 items of one
//                        weight (the step's items sorted by weight): lane
//                        l adds items j*32 + l in order, then the 32 lane
//                        sums halve pairwise through shuffles;
//   learn_update_kernel  one thread per weight with items in the step:
//                        adds its chunk sums in chunk order and applies
//                        the update.
// The TPU kernel sums the gradient per block with one-hot MXU
// contractions; float atomics would make the weights depend on the
// order threads run in, so the reduction has a fixed order instead, and
// the same seed and graph give the same weights bit for bit from run to
// run, for any featureValue. ops/itemgrid._weight_sums is that order
// written out in PyTorch.
//
// What bounds it on the H100: memory traffic and launches. The step
// kernel reads the item tables once and gathers both chains' argument
// values (twice the sweep kernel's gathers), evaluates each item at
// every candidate for both chains and again at the two drawn values, and
// writes 5 B of scratch per item; the reduce kernel reads that scratch
// back through the sorted item order (9 B per item, the 4-byte index and
// the gathered values). At the graph sizes of the CLI the three launches
// per color cost a few microseconds each, comparable to the work. Not
// done yet: fusing the reduce into the step kernel's tail, and one
// persistent launch per epoch.
//
// Graph-sharded learning (ops/itemgrid_mc.py, the counterpart of the
// TPU's multi-chip learn kernel, itemgrid_pallas.py:3348) runs the step
// and reduce kernels on one shard's tables with the shard's seed; a
// non-null `send` / `send_e` packs each row's new value of the free /
// clamped chain at row - row0 for the exchange. Instead of the update
// kernel, learn_partial_kernel writes the shard's per-weight (gradient
// sum, count) as dense (W,) vectors, and after the shards' partials are
// gathered learn_apply_kernel adds them in shard order 0..n_g-1 from 0.0
// (the TPU kernel's fixed-order all-reduce, itemgrid_pallas.py:
// 2486-2493) and applies the same update as learn_update_kernel
// (apply_weight below). Bound: W x n_g x 8 B read, W x 4 B written per
// step, a few microseconds at the CLI's sizes.
//
// Partitioned (BSP) learning (parallel/bsp.BSPItemGridInference.learn)
// needs the TPU learn kernel's has_ext form (itemgrid_pallas.py:2117-2120,
// :2351-2360): non-null `ext_p` / `ext_e`, (V, kext) float32 tables in
// variable order, add the incoming boundary messages of the free / clamped
// chain to pot_p / pot_e for k < min(kmax, kext), after the items and
// before the two draws. The TPU kernel turns its affine path off under
// ext; this kernel has only the general arithmetic, so nothing else
// changes. Null tables: the launch as before.
//
// A color that is not independent (--max_colors) reads both chains from
// snapshots taken before the launch (xr, xer); otherwise xr == x and
// xer == xe. Draws hash the raw seed (no * 977) with the salts of the TPU
// kernel: the free chain (salt16 + block), the clamped chain
// (salt16 + block) ^ 0x55555555, the L1 coin salt_base ^ 0x33333333 at
// position (wid >> 7, wid & 127). Every float operation of the update is
// written out with its rounding (__fmul_rn, __fdiv_rn, __fmaf_rn):
// w * shrink - step * g and w - step * g are single fmas, as XLA's CPU
// backend contracts them in the interpret-mode TPU kernel that the port
// is held to (ops/itemgrid.fma32 is the plain version's fma).

#include "itemgrid_common.cuh"

namespace {

constexpr uint32_t kClampedSaltXor = 0x55555555u;

struct LearnStep {
  const float* weights;
  const float* it_fv;
  int32_t* x;          // free chain, written
  int32_t* xe;         // clamped chain, written
  const int32_t* xr;   // free chain, read (x, or its snapshot)
  const int32_t* xer;  // clamped chain, read (xe, or its snapshot)
  float* item_g;
  int8_t* item_inc;
  int32_t* send;       // packed free-chain values, or null
  int32_t* send_e;     // packed clamped-chain values, or null
  const float* ext_p;  // (V, kext) free-chain external potentials, or null
  const float* ext_e;  // (V, kext) clamped-chain external potentials, or null
  int row0, n_rows, kmax;
  uint32_t seed, salt16;
  int lrn_all;         // --learn_non_evidence: every updated row learns
  int kext;
};

template <int KMAX>
__global__ void __launch_bounds__(128)
    learn_step_kernel(const Tables t, const LearnStep p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n_rows) return;
  const int r = p.row0 + i;
  const int vid = t.row_vid[r];
  const int card = t.row_card[r];
  const int K = p.kmax;
  const int it0 = t.row_item[r], it1 = t.row_item[r + 1];

  float pot_p[KMAX], pot_e[KMAX];
  for_k<KMAX>([&](int k) {
    pot_p[k] = 0.0f;
    pot_e[k] = 0.0f;
  });
  for (int it = it0; it < it1; ++it) {
    const int ftype = t.it_ftype[it];
    const float w = p.weights[t.it_wid[it]];
    const int a0 = t.it_arg[it];
    const int arity = t.it_arity[it];
    const bool dense = t.it_dense[it] != 0;
    const int d1 = t.it_d1[it], d2 = t.it_d2[it];
    for_k<KMAX>([&](int k) {
      const bool ok = dense ? k < card : (k == d1 || k == d2);
      if (ok) {
        const float ep = eval_item(t, p.xr, ftype, a0, arity, k);
        const float ee = eval_item(t, p.xer, ftype, a0, arity, k);
        pot_p[k] = __fadd_rn(pot_p[k], __fmul_rn(w, ep));
        pot_e[k] = __fadd_rn(pot_e[k], __fmul_rn(w, ee));
      }
    });
  }
  add_ext<KMAX>(pot_p, p.ext_p, vid, K, p.kext);
  add_ext<KMAX>(pot_e, p.ext_e, vid, K, p.kext);

  // the `row` map: i0 = 0, i1 = position in the 1024-position block
  const uint32_t upos = static_cast<uint32_t>(t.row_upos[r]);
  const uint32_t salt = p.salt16 + (upos >> 10);
  const uint32_t pos = upos & 1023u;
  const int e_new = draw_cdf<KMAX>(
      pot_e, card, K, hash_uniform(p.seed, salt ^ kClampedSaltXor, 0u, pos));
  const int p_new =
      draw_cdf<KMAX>(pot_p, card, K, hash_uniform(p.seed, salt, 0u, pos));

  const int flags = t.row_flags[r];
  const bool upd = (flags & ROW_UPDATE) != 0;
  const bool upd_e = (flags & ROW_CLAMPED) != 0;
  const int p_val = upd ? p_new : p.xr[vid];
  const int e_val = upd_e ? e_new : p.xer[vid];
  if (upd) p.x[vid] = p_val;
  if (upd_e) p.xe[vid] = e_val;
  if (p.send) p.send[i] = p_val;
  if (p.send_e) p.send_e[i] = e_val;
  const bool lrn = p.lrn_all ? upd : (flags & ROW_EVIDENCE) != 0;

  for (int it = it0; it < it1; ++it) {
    const int d1 = t.it_d1[it], d2 = t.it_d2[it];
    const bool hit =
        d1 == e_val || d1 == p_val || d2 == e_val || d2 == p_val;
    const bool inc = lrn && (t.it_dense[it] != 0 || hit);
    float g = 0.0f;
    if (inc) {
      const int ftype = t.it_ftype[it];
      const int a0 = t.it_arg[it];
      const int arity = t.it_arity[it];
      const float ep = eval_item(t, p.xr, ftype, a0, arity, p_val);
      const float ee = eval_item(t, p.xer, ftype, a0, arity, e_val);
      g = __fmul_rn(__fsub_rn(ep, ee), p.it_fv[it]);
    }
    p.item_g[it] = g;
    p.item_inc[it] = inc ? 1 : 0;
  }
}

// one warp per chunk, eight chunks per block
__global__ void __launch_bounds__(256)
    learn_reduce_kernel(const int32_t* red_item, const int32_t* ch_start,
                        const int32_t* ch_len, const float* item_g,
                        const int8_t* item_inc, float* chunk_g,
                        int32_t* chunk_n, int ch0, int n_ch) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (c >= n_ch) return;  // the whole warp leaves together
  const int cc = ch0 + c;
  const int s = ch_start[cc], len = ch_len[cc];
  float acc = 0.0f;
  int n = 0;
  for (int j = 0; j < 32; ++j) {
    const int idx = j * 32 + lane;
    float g = 0.0f;
    if (idx < len) {
      const int it = red_item[s + idx];
      g = item_g[it];
      n += item_inc[it];
    }
    acc = __fadd_rn(acc, g);
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    n += __shfl_down_sync(0xffffffffu, n, off);
  }
  if (lane == 0) {
    chunk_g[cc] = acc;
    chunk_n[cc] = n;
  }
}

struct Update {
  int mean, regularization;
  float step, shrink, l1d, thresh;
  uint32_t seed, salt_w;
};

// one weight's SGD step from its gradient sum g over n counted items;
// the caller skips weights with n == 0 and fixed weights
__device__ float apply_weight(float wv, float g, int n, int wid,
                              const Update& u) {
  if (u.mean) g = __fdiv_rn(g, static_cast<float>(n));
  float nw;
  if (u.regularization == 2) {
    nw = __fmaf_rn(wv, u.shrink, -__fmul_rn(u.step, g));
  } else {
    nw = __fmaf_rn(-u.step, g, wv);
    if (u.regularization == 1) {
      const float coin =
          hash_uniform(u.seed, u.salt_w, static_cast<uint32_t>(wid) >> 7,
                       static_cast<uint32_t>(wid) & 127u);
      if (coin < u.thresh)
        nw = nw > 0.0f ? fmaxf(0.0f, __fsub_rn(nw, u.l1d))
                       : fminf(0.0f, __fadd_rn(nw, u.l1d));
    }
  }
  return nw;
}

__global__ void __launch_bounds__(128)
    learn_update_kernel(const int32_t* wt_wid, const int32_t* wt_ch0,
                        const int32_t* wt_nch, const float* chunk_g,
                        const int32_t* chunk_n, const int8_t* w_fixed,
                        float* w, int wt0, int n_wt, const Update u) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_wt) return;
  const int wid = wt_wid[wt0 + q];
  const int c0 = wt_ch0[wt0 + q], nc = wt_nch[wt0 + q];
  float g = chunk_g[c0];
  int n = chunk_n[c0];
  // in chunk order; unrolled so that the loads run ahead of the adds
#pragma unroll 8
  for (int c = 1; c < nc; ++c) {
    g = __fadd_rn(g, chunk_g[c0 + c]);
    n += chunk_n[c0 + c];
  }
  if (n == 0 || w_fixed[wid] != 0) return;  // not touched
  w[wid] = apply_weight(w[wid], g, n, wid, u);
}

// one thread per weight with items in the step: its chunk sums in chunk
// order, stored densely at gw[wid], nw[wid] (the wrapper zeroed both)
__global__ void __launch_bounds__(128)
    learn_partial_kernel(const int32_t* wt_wid, const int32_t* wt_ch0,
                         const int32_t* wt_nch, const float* chunk_g,
                         const int32_t* chunk_n, float* gw, int32_t* nw,
                         int wt0, int n_wt) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_wt) return;
  const int c0 = wt_ch0[wt0 + q], nc = wt_nch[wt0 + q];
  float g = chunk_g[c0];
  int n = chunk_n[c0];
#pragma unroll 8
  for (int c = 1; c < nc; ++c) {
    g = __fadd_rn(g, chunk_g[c0 + c]);
    n += chunk_n[c0 + c];
  }
  const int wid = wt_wid[wt0 + q];
  gw[wid] = g;
  nw[wid] = n;
}

// one thread per weight: the shards' partials (shard d's at
// payload[d * stride + goff], gradient sums as float bits, then counts)
// added in shard order from 0.0, then the update
__global__ void __launch_bounds__(128)
    learn_apply_kernel(const int32_t* payload, const int8_t* w_fixed,
                       float* w, int n_g, int stride, int goff, int n_w,
                       const Update u) {
  const int wid = blockIdx.x * blockDim.x + threadIdx.x;
  if (wid >= n_w) return;
  float g = 0.0f;
  int n = 0;
  for (int d = 0; d < n_g; ++d) {
    const int32_t* part = payload + static_cast<int64_t>(d) * stride + goff;
    g = __fadd_rn(g, __int_as_float(part[wid]));
    n += part[n_w + wid];
  }
  if (n == 0 || w_fixed[wid] != 0) return;  // not touched
  w[wid] = apply_weight(w[wid], g, n, wid, u);
}

template <int KMAX>
cudaError_t launch_step(const Tables& t, const LearnStep& p,
                        cudaStream_t stream) {
  constexpr int threads = 128;
  const int blocks = (p.n_rows + threads - 1) / threads;
  learn_step_kernel<KMAX><<<blocks, threads, 0, stream>>>(t, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nsx_learn_step(
    const int32_t* row_vid, const int32_t* row_card, const int32_t* row_upos,
    const int8_t* row_flags, const int32_t* row_item,
    const int32_t* it_ftype, const int32_t* it_wid, const int32_t* it_arity,
    const int32_t* it_arg, const int8_t* it_dense, const int32_t* it_d1,
    const int32_t* it_d2, const int32_t* arg_vid, const int32_t* arg_eq,
    const int32_t* arg_card, const int8_t* arg_subst, const float* it_fv,
    const float* weights, int32_t* x, int32_t* xe, const int32_t* xr,
    const int32_t* xer, float* item_g, int8_t* item_inc, int32_t* send,
    int32_t* send_e, const float* ext_p, const float* ext_e, int row0,
    int n_rows, int kmax, int seed, int salt16, int lrn_all, int kext,
    void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  if ((ext_p != nullptr || ext_e != nullptr) && kext < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables t{row_vid, row_card, row_upos, row_flags, row_item,
                 it_ftype, it_wid,  it_arity, it_arg,    it_dense,
                 it_d1,    it_d2,   arg_vid,  arg_eq,    arg_card,
                 arg_subst};
  const LearnStep p{weights, it_fv, x, xe, xr, xer, item_g, item_inc,
                    send, send_e, ext_p, ext_e, row0, n_rows, kmax,
                    static_cast<uint32_t>(seed), static_cast<uint32_t>(salt16),
                    lrn_all, kext};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (kmax <= 2) return static_cast<int>(launch_step<2>(t, p, s));
  if (kmax <= 8) return static_cast<int>(launch_step<8>(t, p, s));
  if (kmax <= 32) return static_cast<int>(launch_step<32>(t, p, s));
  if (kmax <= 128) return static_cast<int>(launch_step<128>(t, p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int nsx_learn_reduce(const int32_t* red_item,
                                const int32_t* ch_start,
                                const int32_t* ch_len, const float* item_g,
                                const int8_t* item_inc, float* chunk_g,
                                int32_t* chunk_n, int ch0, int n_ch,
                                void* stream) {
  if (n_ch <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n_ch + 7) / 8;
  learn_reduce_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      red_item, ch_start, ch_len, item_g, item_inc, chunk_g, chunk_n, ch0,
      n_ch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nsx_learn_update(const int32_t* wt_wid, const int32_t* wt_ch0,
                                const int32_t* wt_nch, const float* chunk_g,
                                const int32_t* chunk_n,
                                const int8_t* w_fixed, float* w, int wt0,
                                int n_wt, int mean, int regularization,
                                float step, float shrink, float l1d,
                                float thresh, int seed, int salt_w,
                                void* stream) {
  if (n_wt <= 0) return static_cast<int>(cudaGetLastError());
  const Update u{mean, regularization, step, shrink, l1d, thresh,
                 static_cast<uint32_t>(seed), static_cast<uint32_t>(salt_w)};
  const int blocks = (n_wt + 127) / 128;
  learn_update_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      wt_wid, wt_ch0, wt_nch, chunk_g, chunk_n, w_fixed, w, wt0, n_wt, u);
  return static_cast<int>(cudaGetLastError());
}

// zero the dense partial, then (n_wt > 0) one launch of the partial kernel
extern "C" int nsx_learn_partial(const int32_t* wt_wid,
                                 const int32_t* wt_ch0,
                                 const int32_t* wt_nch, const float* chunk_g,
                                 const int32_t* chunk_n, float* gw,
                                 int32_t* nw, int wt0, int n_wt, int n_w,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_w > 0) {
    cudaError_t e = cudaMemsetAsync(gw, 0, sizeof(float) * n_w, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(nw, 0, sizeof(int32_t) * n_w, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n_wt <= 0) return static_cast<int>(cudaGetLastError());
  learn_partial_kernel<<<(n_wt + 127) / 128, 128, 0, s>>>(
      wt_wid, wt_ch0, wt_nch, chunk_g, chunk_n, gw, nw, wt0, n_wt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nsx_learn_apply(const int32_t* payload, const int8_t* w_fixed,
                               float* w, int n_g, int stride, int goff,
                               int n_w, int mean, int regularization,
                               float step, float shrink, float l1d,
                               float thresh, int seed, int salt_w,
                               void* stream) {
  if (n_w <= 0) return static_cast<int>(cudaGetLastError());
  const Update u{mean, regularization, step, shrink, l1d, thresh,
                 static_cast<uint32_t>(seed), static_cast<uint32_t>(salt_w)};
  learn_apply_kernel<<<(n_w + 127) / 128, 128, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      payload, w_fixed, w, n_g, stride, goff, n_w, u);
  return static_cast<int>(cudaGetLastError());
}
