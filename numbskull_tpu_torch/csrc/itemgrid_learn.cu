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
// skipped). NOOP items carry no gradient and are not counted, as in the
// TPU kernel (itemgrid_pallas.py:363). The burn-in of the free chain runs
// the sweep kernel.
//
// How: two launches on one stream per (epoch, color), three where a
// categorical step has tiles of both forms. The host gives every tile a
// form (LearnForm below: ops/itemgrid.build_learn_tables decides, and
// each launch names the form it runs); the entry obeys it.
//   step kernel        one launch per form of the step's tiles:
//                      learn_item_kernel (FORM_ITEM) or learn_step_kernel
//                      (FORM_ROW, a step with a row of more than
//                      kItemTile items) at KMAX 2, learn_cat_kernel
//                      (FORM_CAT, re-read) and learn_kept_kernel
//                      (FORM_KEPT) at KMAX 8, 32, 128 (see below):
//                      one block of kTileRows threads per tile, a run of
//                      at most kTileRows of the color's rows whose items
//                      fit the shared-memory budget, at KMAX 2 896
//                      (ops/itemgrid.build_learn_tables cuts them). It
//                      draws both chains of every row and leaves each
//                      item's (gradient, counted) in shared memory, then
//                      sums them per weight into one partial slot per
//                      (tile, weight): a tile whose items share one weight
//                      (every tile of an Ising graph) with the whole block
//                      (thread l adds items l, l + 128, ... in order, then
//                      the 128 thread sums halve pairwise), otherwise one
//                      warp per weight over the tile's items listed by
//                      weight (lane l adds entries l, l + 32, ..., then the
//                      32 lanes halve).
//   learn_sum_kernel   per weight of the step, its partial slots (laid out
//                      weight-major, tiles in row order): a weight with
//                      more than kSumWidth partials takes a block of
//                      kSumWidth threads, any other one warp, each with the
//                      same strided sums and halving tree; then one thread
//                      applies the update.
// A row with more items than the budget is a tile of its own whose items
// are summed in pieces of the budget, each piece with its own slots. The
// TPU kernel sums the gradient per block of 1024 rows with one MXU
// contraction and adds the block sums in block order; blocks of a GPU
// launch run in no order, so here every sum has an order fixed by the
// tables alone (never by the grid, the SM count or timing), there are no
// float atomics, and the same seed and graph give the same weights bit
// for bit from run to run, for any featureValue. ops/itemgrid._weight_sums
// is that order written out in PyTorch.
//
// What bounds it on the H100: the latency of each item's chain of
// dependent loads (item -> arguments -> values), so the rows and items in
// flight per SM. Each item is evaluated at its candidates for both
// chains; eval_item2 reads an item's argument tables once for the two.
// At KMAX 2 the host cuts tiles at 896 items (ops/itemgrid.ITEM_CUT,
// greedily over the step's rows, so that tiles are full; under kItemTile,
// so that 8 blocks' shared memory fits an SM), and learn_item_kernel runs
// a tile's items in parallel, neighbouring threads on neighbouring items
// and arguments: each item's
// evaluations at 0 and 1 for both chains go to shared memory (EQUAL,
// ISTRUE, AND and OR from the one count their value reads), one thread
// per row adds its items' terms from there in item order (the plain
// version's order) and draws, and the gradient takes the evaluation
// already made at each drawn value, the same function of the same
// inputs; only an item that was not evaluated at a drawn value is
// evaluated again. That kernel is held to 64 registers, 8 blocks an SM.
// Only a step with a row of more than kItemTile items (a tile of its
// own, summed in pieces) is in the row form: learn_step_kernel, one
// thread per row, which reads its items a second time for the
// gradient. At KMAX 8, 32
// and 128 the categorical kernels run the tile's items in parallel for
// both chains' potentials through
// cat_potentials (itemgrid_common.cuh; every candidate the dense / d1 /
// d2 rule keeps evaluated from one read of the item's arguments for both
// chains, the terms added per (row, candidate) in item order). A tile of
// one piece whose every row's evaluations and potentials take at most a
// quarter of a warp's terms (kept_terms: DP and LF rows, narrow rows at
// low cards) is in the kept form: each warp walks its rows in runs that
// fit, keeps the run's evaluations at every candidate beside its
// potentials, draws, and takes each item's gradient from the evaluations
// kept at the two drawn values (kept_gradients: the same function of the
// same inputs; an item not evaluated at a drawn value is evaluated again
// from the tables, as above). Any other tile (a row wider than that, or
// a row in pieces) is re-read: its potentials in the dynamic shared
// memory, and after every row has drawn each item evaluated at the two
// drawn values from one more read of its arguments (cat_gradients). The
// host marks each tile's form in the tables (tl_form, FORM_KEPT where
// ops/itemgrid.kept_tiles keeps it, FORM_CAT elsewhere);
// learn_kept_kernel takes the kept tiles and learn_cat_kernel the
// others, each launched over the step where it has tiles, and a block of
// the other form's tile returns at once. The
// gradients never leave shared memory: per step the partials are 8 B per
// (tile, weight), and the sum kernel reads them once.
//
// Graph-sharded learning (ops/itemgrid_mc.py, the counterpart of the
// TPU's multi-chip learn kernel, itemgrid_pallas.py:3348) runs the step
// kernel on one shard's tables with the shard's seed; a non-null `send` /
// `send_e` packs each row's new value of the free / clamped chain at
// row - row0 for the exchange. Instead of the update, the sum kernel
// writes the shard's per-weight (gradient sum, count) as dense (W,)
// vectors (nsx_learn_partial), and after the shards' partials are
// gathered learn_apply_kernel adds them in shard order 0..n_g-1 from 0.0
// (the TPU kernel's fixed-order all-reduce, itemgrid_pallas.py:
// 2486-2493) and applies the same update (apply_weight below).
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

#include <algorithm>

#include "itemgrid_common.cuh"

namespace {

constexpr uint32_t kClampedSaltXor = 0x55555555u;
constexpr int kTileRows = 128;   // rows per tile: threads of a step block
constexpr int kSumWidth = 1024;  // threads of a weight-sum block
constexpr int kItemTile = 1024;  // KMAX 2: items of a tile run in parallel
constexpr int kMaxSmem = 48 * 1024;

// a learn tile's form, the kernel that takes it (ops/itemgrid.LEARN_FORMS)
enum LearnForm : int { FORM_CAT = 0, FORM_KEPT = 1, FORM_ITEM = 2,
                       FORM_ROW = 3 };

struct LearnStep {
  const float* weights;
  const float* it_fv;
  int32_t* x;          // free chain, written
  int32_t* xe;         // clamped chain, written
  const int32_t* xr;   // free chain, read (x, or its snapshot)
  const int32_t* xer;  // clamped chain, read (xe, or its snapshot)
  int32_t* send;       // packed free-chain values, or null
  int32_t* send_e;     // packed clamped-chain values, or null
  const float* ext_p;  // (V, kext) free-chain external potentials, or null
  const float* ext_e;  // (V, kext) clamped-chain external potentials, or null
  int row0, kmax;
  uint32_t seed, salt16;
  int lrn_all;         // --learn_non_evidence: every updated row learns
  int kext;
};

// the order of the gradient sums (ops/itemgrid.build_learn_tables)
struct Order {
  const int32_t* tl_r0;    // (NT + 1) first row of each tile
  const int32_t* tl_pc0;   // (NT + 1) first piece of each tile
  const int32_t* pc_g0;    // (NP + 1) first group of each piece
  const int32_t* pc_perm;  // (NP) the piece's list in perm; -1: one group
  const int32_t* gr_off;   // (NG) a group's first entry in its piece's list
  const int32_t* gr_len;   // (NG) its items
  const int32_t* gr_slot;  // (NG) its partial slot
  const int32_t* perm;     // piece-local items, by (piece, weight, item)
  const int32_t* tl_form;  // (NT) the tile's LearnForm; null where every
                           // tile is the launched kernel's
  float* part_g;           // (NG) partial gradient sums, by slot
  int32_t* part_n;         // (NG) partial counts
  int tile0;               // the step's first tile
  int piece_items;         // items per piece: the budget
  int smem_items;          // the step's longest piece (shared layout)
};

// lane l adds lane l + h for h = 16, 8, 4, 2, 1: lane 0 ends with the sum
__device__ __forceinline__ void warp_tree(float& g, int& n) {
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) {
    g = __fadd_rn(g, __shfl_down_sync(0xffffffffu, g, h));
    n += __shfl_down_sync(0xffffffffu, n, h);
  }
}

// the same halving over the P threads of a block (P = blockDim.x): pairs
// through shared memory down to 32 lanes, then the warp; every thread of
// the block calls it, and thread 0 ends with the sum
template <int P>
__device__ __forceinline__ void block_tree(float& g, int& n, float* rg,
                                           int* rn) {
  const int l = threadIdx.x;
#pragma unroll
  for (int h = P / 2; h >= 32; h >>= 1) {
    rg[l] = g;
    rn[l] = n;
    __syncthreads();
    if (l < h) {
      g = __fadd_rn(g, rg[l + h]);
      n += rn[l + h];
    }
    __syncthreads();
  }
  if (l < 32) warp_tree(g, n);
}

// eval_item for two value arrays at once (the free and the clamped
// chain), the row's own argument at candidate ka in the first and kb in
// the second: the arguments' tables are read once for the two
// (eval_args2)
__device__ __forceinline__ void eval_item2k(const Tables& t,
                                            const int32_t* xa,
                                            const int32_t* xb, int ftype,
                                            int a0, int arity, int ka, int kb,
                                            float& ea, float& eb) {
  eval_args2(
      ftype, arity,
      [&](int a, int& va, int& vb) {
        const int vid = arg_ref(t, a0 + a);
        if (vid < 0) {
          va = ka;
          vb = kb;
        } else {
          va = xa[vid];
          vb = xb[vid];
        }
      },
      [&](int a) { return t.arg_ec[a0 + a]; }, ea, eb);
}

__device__ __forceinline__ void eval_item2(const Tables& t,
                                           const int32_t* xa,
                                           const int32_t* xb, int ftype,
                                           int a0, int arity, int k,
                                           float& ea, float& eb) {
  eval_item2k(t, xa, xb, ftype, a0, arity, k, k, ea, eb);
}

// eval_item of item `it` at candidate k, its tables read here
__device__ __forceinline__ float eval_at(const Tables& t, const int32_t* x,
                                      int it, int k) {
  return eval_item(t, x, item_ftype(t, it), item_arg0(t, it),
                   item_arity(t, it), k);
}

// one item's gradient at the drawn values, evaluated from the tables
// (one read of its arguments for both chains)
__device__ __forceinline__ float item_grad(const Tables& t,
                                           const LearnStep& p, int it,
                                           int p_val, int e_val) {
  float ep, ee;
  eval_item2k(t, p.xr, p.xer, item_ftype(t, it), item_arg0(t, it),
              item_arity(t, it), p_val, e_val, ep, ee);
  return __fmul_rn(__fsub_rn(ep, ee), p.it_fv[it]);
}

// row r's two draws from its potentials (external potentials added
// first), both chains' writes and packs; p_val / e_val the row's values
// after the step, lrn whether its items carry the gradient
template <int KMAX>
__device__ __forceinline__ void draw_row(const Tables& t, const LearnStep& p,
                                         int r, int card, float* pot_p,
                                         float* pot_e, int& p_val,
                                         int& e_val, bool& lrn) {
  const int vid = t.row_vid[r];
  const int K = p.kmax;
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
  p_val = upd ? p_new : p.xr[vid];
  e_val = upd_e ? e_new : p.xer[vid];
  if (upd) p.x[vid] = p_val;
  if (upd_e) p.xe[vid] = e_val;
  if (p.send) p.send[r - p.row0] = p_val;
  if (p.send_e) p.send_e[r - p.row0] = e_val;
  lrn = p.lrn_all ? upd : (flags & ROW_EVIDENCE) != 0;
}

// the n items of piece pc, their (gradient, counted) in shared memory:
// one partial slot per weight of the piece; every thread of the block
// calls it
__device__ __forceinline__ void piece_sums(const Order& o, int pc, int n,
                                           const float* s_g,
                                           const uint8_t* s_inc, float* s_rg,
                                           int* s_rn) {
  const int g0 = o.pc_g0[pc], g1 = o.pc_g0[pc + 1];
  if (g1 - g0 == 1) {
    float g = 0.0f;
    int c = 0;
    for (int j = threadIdx.x; j < n; j += kTileRows) {
      g = __fadd_rn(g, s_g[j]);
      c += s_inc[j];
    }
    block_tree<kTileRows>(g, c, s_rg, s_rn);
    if (threadIdx.x == 0) {
      o.part_g[o.gr_slot[g0]] = g;
      o.part_n[o.gr_slot[g0]] = c;
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int32_t* list = o.perm + o.pc_perm[pc];
  for (int gi = g0 + (threadIdx.x >> 5); gi < g1; gi += kTileRows / 32) {
    const int off = o.gr_off[gi], len = o.gr_len[gi];
    float g = 0.0f;
    int c = 0;
    for (int j = lane; j < len; j += 32) {
      const int k = list[off + j];
      g = __fadd_rn(g, s_g[k]);
      c += s_inc[k];
    }
    warp_tree(g, c);
    if (lane == 0) {
      o.part_g[o.gr_slot[gi]] = g;
      o.part_n[o.gr_slot[gi]] = c;
    }
  }
}

// KMAX 2, a tile of at most kItemTile items (one piece): the items in
// parallel, thread j on items j, j + kTileRows, ... (neighbouring threads
// on neighbouring items and arguments), each evaluated for both chains at
// both candidates into shared memory; then one thread per row adds its
// items' terms in item order and draws; then the items in parallel again
// for the gradient, from the evaluations kept
__device__ __forceinline__ void item_tile(const Tables& t, const LearnStep& p,
                                          const Order& o, int tile, int tr0,
                                          int tr1, int T0, int T1,
                                          float4* s_mem, float* s_rg,
                                          int* s_rn) {
  __shared__ int s_ri[kTileRows + 1];  // rows' first items, tile-local
  __shared__ int s_card[kTileRows], s_pv[kTileRows], s_ev[kTileRows];
  __shared__ bool s_lrn[kTileRows];
  const int S = o.smem_items, nr = tr1 - tr0, n = T1 - T0;
  const int tid = threadIdx.x;
  float4* s_e = s_mem;  // (free at 0, free at 1, clamped at 0, clamped at 1)
  float* s_w = reinterpret_cast<float*>(s_e + S);
  float* s_g = s_w + S;
  uint8_t* s_inc = reinterpret_cast<uint8_t*>(s_g + S);
  // dense, d1 == 0, d1 == 1, d2 == 0, d2 == 1, NOOP
  uint8_t* s_flag = s_inc + S;
  uint8_t* s_row = s_flag + S;
  if (tid < nr) {
    s_ri[tid] = t.row_item[tr0 + tid] - T0;
    s_card[tid] = t.row_card[tr0 + tid];
  }
  if (tid == 0) s_ri[nr] = n;
  __syncthreads();

  for (int j = tid; j < n; j += kTileRows) {
    int lo = 0, hi = nr - 1;  // the last row whose first item is <= j
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_ri[mid] <= j) lo = mid;
      else hi = mid - 1;
    }
    const int it = T0 + j, card = s_card[lo];
    const int m = item_meta(t, it);
    const int ftype = meta_ftype(m);
    const float w = p.weights[item_wid(t, it)];
    const int a0 = item_arg0(t, it);
    const int arity = item_arity(t, it);
    const bool dense = meta_dense(m);
    const int d1 = meta_d1(m), d2 = meta_d2(m);
    float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (dense ? k < card : (k == d1 || k == d2))
        eval_item2(t, p.xr, p.xer, ftype, a0, arity, k, e[k], e[2 + k]);
    }
    s_e[j] = make_float4(e[0], e[1], e[2], e[3]);
    s_w[j] = w;
    s_flag[j] = static_cast<uint8_t>(dense | (d1 == 0) << 1 | (d1 == 1) << 2 |
                                     (d2 == 0) << 3 | (d2 == 1) << 4 |
                                     (ftype == -1) << 5);
    s_row[j] = static_cast<uint8_t>(lo);
  }
  __syncthreads();

  if (tid < nr) {
    const int card = s_card[tid];
    float pot_p[2] = {0.0f, 0.0f}, pot_e[2] = {0.0f, 0.0f};
    for (int j = s_ri[tid]; j < s_ri[tid + 1]; ++j) {
      const float4 e = s_e[j];
      const float w = s_w[j];
      const int f = s_flag[j];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if ((f & 1) ? k < card : (((f >> (1 + k)) | (f >> (3 + k))) & 1)) {
          pot_p[k] = __fadd_rn(pot_p[k], __fmul_rn(w, k ? e.y : e.x));
          pot_e[k] = __fadd_rn(pot_e[k], __fmul_rn(w, k ? e.w : e.z));
        }
      }
    }
    int p_val, e_val;
    bool lrn;
    draw_row<2>(t, p, tr0 + tid, card, pot_p, pot_e, p_val, e_val, lrn);
    s_pv[tid] = p_val;
    s_ev[tid] = e_val;
    s_lrn[tid] = lrn;
  }
  __syncthreads();

  for (int j = tid; j < n; j += kTileRows) {
    const int row = s_row[j], it = T0 + j;
    const int pv = s_pv[row], ev = s_ev[row], card = s_card[row];
    const int f = s_flag[j];
    const bool dense = (f & 1) != 0;
    bool hit, okp, oke;  // ok*: evaluated above at the drawn value
    if (static_cast<unsigned>(pv) < 2u && static_cast<unsigned>(ev) < 2u) {
      const bool sp = ((f >> (1 + pv)) | (f >> (3 + pv))) & 1;
      const bool se = ((f >> (1 + ev)) | (f >> (3 + ev))) & 1;
      hit = sp || se;
      okp = dense ? pv < card : sp;
      oke = dense ? ev < card : se;
    } else {  // a value outside {0, 1}: the slots from the tables
      const int m = item_meta(t, it);
      const int d1 = meta_d1(m), d2 = meta_d2(m);
      hit = d1 == ev || d1 == pv || d2 == ev || d2 == pv;
      okp = static_cast<unsigned>(pv) < 2u &&
            (dense ? pv < card : (pv == d1 || pv == d2));
      oke = static_cast<unsigned>(ev) < 2u &&
            (dense ? ev < card : (ev == d1 || ev == d2));
    }
    const bool inc = s_lrn[row] && !(f & 32) && (dense || hit);
    float g = 0.0f;
    if (inc) {
      const float4 e = s_e[j];
      float ep = pv ? e.y : e.x, ee = ev ? e.w : e.z;
      if (!okp) ep = eval_at(t, p.xr, it, pv);
      if (!oke) ee = eval_at(t, p.xer, it, ev);
      g = __fmul_rn(__fsub_rn(ep, ee), p.it_fv[it]);
    }
    s_g[j] = g;
    s_inc[j] = inc ? 1 : 0;
  }
  __syncthreads();
  if (o.tl_pc0[tile + 1] > o.tl_pc0[tile])
    piece_sums(o, o.tl_pc0[tile], n, s_g, s_inc, s_rg, s_rn);
}

// KMAX 2, every tile of the step at most kItemTile items: item_tile.
// At most 64 registers a thread, so that 8 blocks fit an SM: the step
// waits on its loads, and more rows in flight hide more of the wait
__global__ void __launch_bounds__(kTileRows, 8)
    learn_item_kernel(const Tables t, const LearnStep p, const Order o) {
  extern __shared__ float4 s_mem[];
  __shared__ float s_rg[kTileRows];
  __shared__ int s_rn[kTileRows];
  const int tile = o.tile0 + blockIdx.x;
  const int tr0 = o.tl_r0[tile], tr1 = o.tl_r0[tile + 1];
  item_tile(t, p, o, tile, tr0, tr1, t.row_item[tr0], t.row_item[tr1],
            s_mem, s_rg, s_rn);
}

// KMAX 2, a step with a tile of more than kItemTile items (a row of more
// than kItemTile items, a tile of its own; the step's other tiles are
// cut at 896): one thread per row (potentials, draws), then its
// items' gradients, piece by piece. Allowed 128 registers (4 blocks an
// SM): ptxas left to itself spills it
__global__ void __launch_bounds__(kTileRows, 4)
    learn_step_kernel(const Tables t, const LearnStep p, const Order o) {
  extern __shared__ float4 s_mem[];
  __shared__ float s_rg[kTileRows];
  __shared__ int s_rn[kTileRows];
  const int tile = o.tile0 + blockIdx.x;
  const int tr0 = o.tl_r0[tile], tr1 = o.tl_r0[tile + 1];
  const int T1 = t.row_item[tr1];
  int P0 = t.row_item[tr0];
  float* s_g = reinterpret_cast<float*>(s_mem);
  uint8_t* s_inc = reinterpret_cast<uint8_t*>(s_g + o.smem_items);
  const int r = tr0 + threadIdx.x;
  const bool active = r < tr1;
  int it0 = 0, it1 = 0, p_val = 0, e_val = 0;
  bool lrn = false;
  if (active) {
    const int card = t.row_card[r];
    it0 = t.row_item[r];
    it1 = t.row_item[r + 1];
    float pot_p[2] = {0.0f, 0.0f}, pot_e[2] = {0.0f, 0.0f};
    for (int it = it0; it < it1; ++it) {
      const int m = item_meta(t, it);
      const int ftype = meta_ftype(m);
      const float w = p.weights[item_wid(t, it)];
      const int a0 = item_arg0(t, it);
      const int arity = item_arity(t, it);
      const bool dense = meta_dense(m);
      const int d1 = meta_d1(m), d2 = meta_d2(m);
      for_k<2>([&](int k) {
        const bool ok = dense ? k < card : (k == d1 || k == d2);
        if (ok) {
          float ep, ee;
          eval_item2(t, p.xr, p.xer, ftype, a0, arity, k, ep, ee);
          pot_p[k] = __fadd_rn(pot_p[k], __fmul_rn(w, ep));
          pot_e[k] = __fadd_rn(pot_e[k], __fmul_rn(w, ee));
        }
      });
    }
    draw_row<2>(t, p, r, card, pot_p, pot_e, p_val, e_val, lrn);
  }

  // the tile's items [P0, T1), in pieces of piece_items
  for (int pc = o.tl_pc0[tile]; pc < o.tl_pc0[tile + 1];
       ++pc, P0 += o.piece_items) {
    const int P1 = min(P0 + o.piece_items, T1);
    if (active) {
      const int lo = max(it0, P0), hi = min(it1, P1);
      for (int it = lo; it < hi; ++it) {
        const int m = item_meta(t, it);
        const int d1 = meta_d1(m), d2 = meta_d2(m);
        const bool hit =
            d1 == e_val || d1 == p_val || d2 == e_val || d2 == p_val;
        const bool inc =
            lrn && meta_ftype(m) != -1 && (meta_dense(m) || hit);
        s_g[it - P0] = inc ? item_grad(t, p, it, p_val, e_val) : 0.0f;
        s_inc[it - P0] = inc ? 1 : 0;
      }
    }
    __syncthreads();
    piece_sums(o, pc, P1 - P0, s_g, s_inc, s_rg, s_rn);
    __syncthreads();  // the next piece reuses the shared memory
  }
}

// a warp's share [Q0, Q1) of a piece's items (the piece starts at P0):
// their gradients into s_g / s_inc at it - P0, items in parallel in
// chunks of at most 32 items and kCatArgs staged argument values, as
// cat_potentials walks them: lane j reads item j's record, the chunk's
// arguments of both chains are staged side by side (cat_stage), and lane
// j evaluates its item at its row's two drawn values from them
// (cat_eval). s_ri holds the tile's rows' first items (tables'
// numbering), s_pv / s_ev / s_lrn each row's drawn values and whether
// its items carry the gradient
__device__ void cat_gradients(const Tables& t, const LearnStep& p, int Q0,
                              int Q1, int P0, const int* s_ri, int nr,
                              const int* s_pv, const int* s_ev,
                              const bool* s_lrn, float* s_g, uint8_t* s_inc,
                              CatWarp<2>& sh) {
  const int lane = threadIdx.x & 31;
  for (int c0 = Q0; c0 < Q1;) {
    const int it = c0 + lane;
    const bool live = it < Q1;
    int m = 0, a0 = 0, arity = 0;
    if (live) {
      m = item_meta(t, it);
      a0 = item_arg0(t, it);
      arity = item_arity(t, it);
    }
    const int2 pre = warp_scan2(make_int2(0, min(arity, kCatArgs + 1)));
    const int nf =
        __popc(__ballot_sync(0xffffffffu, live && pre.y <= kCatArgs));
    const int n = nf > 0 ? nf : 1;
    if (lane < n) {
      sh.meta[lane] = m;
      sh.a0[lane] = a0;
      sh.arity[lane] = arity;
    }
    __syncwarp();
    const bool staged = nf > 0;
    const int A0 = sh.a0[0];
    if (staged)
      cat_stage<2>(t, p.xr, p.xer, A0, sh.a0[n - 1] + sh.arity[n - 1] - A0,
                   sh);
    if (lane < n) {
      const int row = row_of(s_ri, nr, it);
      const int pv = s_pv[row], ev = s_ev[row];
      const int d1 = meta_d1(m), d2 = meta_d2(m);
      const bool hit = d1 == ev || d1 == pv || d2 == ev || d2 == pv;
      const bool inc =
          s_lrn[row] && meta_ftype(m) != -1 && (meta_dense(m) || hit);
      float g = 0.0f;
      if (inc) {
        float ep, ee;
        cat_eval<2>(t, p.xr, p.xer, sh, staged, A0, lane, pv, ev, ep, ee);
        g = __fmul_rn(__fsub_rn(ep, ee), p.it_fv[it]);
      }
      s_g[it - P0] = g;
      s_inc[it - P0] = inc ? 1 : 0;
    }
    __syncwarp();  // the next chunk reuses the staged values
    c0 += n;
  }
}

// rows of a learn tile whose two chains' potentials fit kCatPotFloats
// each: the categorical kernel's potential pass takes a tile's rows this
// many at a time
__host__ __device__ constexpr int cat_pot_rows(int K) {
  return kCatPotFloats / cat_stride(K) < kTileRows
             ? kCatPotFloats / cat_stride(K)
             : kTileRows;
}

// KMAX 8, 32, 128, the step's tiles in the re-read form (a kept tile is
// learn_kept_kernel's: the block returns; tl_form is null in a step with
// none): the tile's rows, cat_pot_rows
// at a time, each warp a run of them (warp_rows), take both chains'
// potentials from cat_potentials (items in parallel, each item's
// arguments read once for the two chains and every candidate) into
// shared memory, and one lane per row draws both chains (draw_row, as
// before). Then the gradient pass runs each piece's items in parallel
// again, a quarter a warp (cat_gradients: each item evaluated at the two
// drawn values from one more staged read of its arguments), and
// piece_sums as before: the tiles, pieces and sum order of
// build_learn_tables are unchanged. The potentials and the gradients use
// the same dynamic shared memory in turn
template <int KMAX>
__global__ void __launch_bounds__(kTileRows, 4)
    learn_cat_kernel(const Tables t, const LearnStep p, const Order o) {
  extern __shared__ float4 s_mem[];
  __shared__ CatWarp<2> sh[kCatWarps];
  __shared__ float s_rg[kTileRows];
  __shared__ int s_rn[kTileRows];
  __shared__ int s_ri[kTileRows + 1], s_pv[kTileRows], s_ev[kTileRows];
  __shared__ bool s_lrn[kTileRows];
  const int tile = o.tile0 + blockIdx.x;
  if (o.tl_form != nullptr && o.tl_form[tile] != FORM_CAT) return;
  const int tid = threadIdx.x, lane = tid & 31;
  CatWarp<2>& w = sh[tid >> 5];
  const int tr0 = o.tl_r0[tile], tr1 = o.tl_r0[tile + 1], nr = tr1 - tr0;
  const int K = p.kmax, S = cat_stride(K), rows = cat_pot_rows(K);
  float* pot_p = reinterpret_cast<float*>(s_mem);
  float* pot_e = pot_p + rows * S;
  for (int s0 = 0; s0 < nr; s0 += rows) {
    int first, wn;
    warp_rows(min(rows, nr - s0), first, wn);
    if (wn > 0) {
      float* pp = pot_p + first * S;
      float* pe = pot_e + first * S;
      for (int q = lane; q < wn * S; q += 32) {
        pp[q] = 0.0f;
        pe[q] = 0.0f;
      }
      __syncwarp();
      const int r0 = tr0 + s0 + first;
      cat_potentials<2>(t, p.weights, p.xr, p.xer, r0, wn, K, pp, pe, w);
      if (lane < wn) {
        int pv, ev;
        bool lrn;
        draw_row<KMAX>(t, p, r0 + lane, w.card[lane], pp + lane * S,
                       pe + lane * S, pv, ev, lrn);
        s_pv[s0 + first + lane] = pv;
        s_ev[s0 + first + lane] = ev;
        s_lrn[s0 + first + lane] = lrn;
      }
    }
    __syncthreads();  // the next rows reuse the potentials
  }
  for (int i = tid; i <= nr; i += kTileRows) s_ri[i] = t.row_item[tr0 + i];
  __syncthreads();

  float* s_g = reinterpret_cast<float*>(s_mem);
  uint8_t* s_inc = reinterpret_cast<uint8_t*>(s_g + o.smem_items);
  const int T1 = s_ri[nr];
  int P0 = s_ri[0];
  for (int pc = o.tl_pc0[tile]; pc < o.tl_pc0[tile + 1];
       ++pc, P0 += o.piece_items) {
    const int P1 = min(P0 + o.piece_items, T1);
    const int per = (P1 - P0 + kCatWarps - 1) / kCatWarps;
    const int Q0 = min(P1, P0 + (tid >> 5) * per);
    cat_gradients(t, p, Q0, min(P1, Q0 + per), P0, s_ri, nr, s_pv, s_ev,
                  s_lrn, s_g, s_inc, w);
    __syncthreads();
    piece_sums(o, pc, P1 - P0, s_g, s_inc, s_rg, s_rn);
    __syncthreads();  // the next piece reuses the shared memory
  }
}

// terms a warp of the kept form holds, per chain: a run's potentials
// and its items' evaluations at every candidate (ops/itemgrid.KEPT_TERMS)
constexpr int kKeptTerms = 640;

// what row r takes of a warp's kKeptTerms in the kept form: its
// potentials' stride and a term for each candidate each of its items can
// be evaluated at (a dense item one for each candidate below the row's
// card and K, a sparse item at most two). ops/itemgrid.kept_terms counts
// the same, and keeps a tile only where each of its rows takes at most a
// quarter
__device__ __forceinline__ int kept_terms(const Tables& t, int r, int K) {
  const int items = min(t.row_item[r + 1] - t.row_item[r], kKeptTerms);
  return items * max(min(t.row_card[r], K), 2) + cat_stride(K);
}

// the index of candidate k among the terms of an item (dense: its nt
// terms; sparse: at d1 and d2), in cat_potentials' term order, or -1
// where it was not evaluated
__device__ __forceinline__ int term_of(bool dense, int d1, int d2, int nt,
                                       int K, int k) {
  if (dense)
    return static_cast<unsigned>(k) < static_cast<unsigned>(nt) ? k : -1;
  if (k == d1 && d1 < K) return 0;
  if (k == d2 && d2 < K) return d1 < K ? 1 : 0;
  return -1;
}

// featureValues a lane of kept_gradients has in flight
constexpr int kKeptBatch = 4;

// the kept form's gradients of a run's n items (the first at I0) into
// g / inc, where cat_potentials left each item's row, first term, d1
// and d2 (info, the same words as g) and its dense and NOOP bits (inc):
// lane l takes items l, l + 32, ..., kKeptBatch of them at a time, and
// their evaluations at their rows' two drawn values from the warp's
// terms of the free and the clamped chain. An item not evaluated at a
// drawn value (a sparse item, a value outside its d1 / d2) is left
// marked, and a second pass evaluates it at both from the tables
// (eval_item2k: the same function of the same inputs). sh.card holds the
// run's rows' cardinalities (cat_potentials); pv, ev, lrn their drawn
// values and whether their items carry the gradient
__device__ void kept_gradients(const Tables& t, const LearnStep& p, int I0,
                               int n, int K,
                               const CatWarp<2, kKeptTerms>& sh,
                               const int* pv, const int* ev, const bool* lrn,
                               float* g, uint8_t* inc) {
  constexpr uint8_t kAgain = 3;  // counted, evaluated again below
  const int lane = threadIdx.x & 31;
  bool again = false;
  for (int j0 = lane; j0 < n; j0 += 32 * kKeptBatch) {
    float fv[kKeptBatch];
#pragma unroll
    for (int b = 0; b < kKeptBatch; ++b)
      fv[b] = j0 + 32 * b < n ? p.it_fv[I0 + j0 + 32 * b] : 0.0f;
#pragma unroll
    for (int b = 0; b < kKeptBatch; ++b) {
      const int j = j0 + 32 * b;
      if (j >= n) break;
      const uint32_t q = __float_as_uint(g[j]);
      const int f = inc[j];
      const int row = q & 31, off = (q >> 5) & 1023;
      const int d1 = (q >> 15) & 255, d2 = (q >> 23) & 255;
      const int p_val = pv[row], e_val = ev[row];
      const bool hit =
          d1 == e_val || d1 == p_val || d2 == e_val || d2 == p_val;
      const bool counted = lrn[row] && !(f & 2) && ((f & 1) || hit);
      float gj = 0.0f;
      if (counted) {
        const int nt = (f & 1) ? min(sh.card[row], K) : 0;
        const int ip = term_of(f & 1, d1, d2, nt, K, p_val);
        const int ie = term_of(f & 1, d1, d2, nt, K, e_val);
        if (ip < 0 || ie < 0) {
          inc[j] = kAgain;  // g[j] keeps the item's word
          again = true;
          continue;
        }
        gj = __fmul_rn(__fsub_rn(sh.term[0][off + ip], sh.term[1][off + ie]),
                       fv[b]);
      }
      g[j] = gj;
      inc[j] = counted ? 1 : 0;
    }
  }
  if (!__any_sync(0xffffffffu, again)) return;
  for (int j = lane; j < n; j += 32) {
    if (inc[j] != kAgain) continue;
    const int it = I0 + j, row = __float_as_uint(g[j]) & 31;
    float ep, ee;
    eval_item2k(t, p.xr, p.xer, item_ftype(t, it), item_arg0(t, it),
                item_arity(t, it), pv[row], ev[row], ep, ee);
    g[j] = __fmul_rn(__fsub_rn(ep, ee), p.it_fv[it]);
    inc[j] = 1;
  }
}

// KMAX 8, 32, 128, the step's tiles in the kept form (tl_form, null in a
// step with no other; the others are learn_cat_kernel's: the block
// returns). Each warp takes a
// quarter of the tile's rows (warp_rows) in runs of as many as fit
// kKeptTerms: both chains' potentials and the run's evaluations at every
// candidate in the warp's terms (cat_potentials<2, true>), one lane per
// row draws both chains, and the run's items take their gradients from
// the evaluations kept (kept_gradients). Then piece_sums as before (a
// kept tile is one piece). Its warps keep 640 terms where
// learn_cat_kernel's keep 512, and it is held to 96 registers, so that
// DP tiles (3 KB of dynamic shared memory) run 5 blocks an SM
template <int KMAX>
__global__ void __launch_bounds__(kTileRows, 5)
    learn_kept_kernel(const Tables t, const LearnStep p, const Order o) {
  extern __shared__ float4 s_mem[];
  __shared__ CatWarp<2, kKeptTerms> sh[kCatWarps];
  __shared__ float s_rg[kTileRows];
  __shared__ int s_rn[kTileRows];
  __shared__ int s_pv[kTileRows], s_ev[kTileRows];
  __shared__ bool s_lrn[kTileRows];
  const int tile = o.tile0 + blockIdx.x;
  if (o.tl_form != nullptr && o.tl_form[tile] != FORM_KEPT) return;
  const int tid = threadIdx.x, lane = tid & 31;
  const int tr0 = o.tl_r0[tile], tr1 = o.tl_r0[tile + 1], nr = tr1 - tr0;
  const int pc0 = o.tl_pc0[tile], npc = o.tl_pc0[tile + 1] - pc0;
  const int K = p.kmax, S = cat_stride(K);
  // s_pv holds each row's kept_terms until it draws
  if (tid < nr) s_pv[tid] = kept_terms(t, tr0 + tid, K);
  __syncthreads();
  CatWarp<2, kKeptTerms>& w = sh[tid >> 5];
  float* s_g = reinterpret_cast<float*>(s_mem);
  uint8_t* s_inc = reinterpret_cast<uint8_t*>(s_g + o.smem_items);
  const int P0 = t.row_item[tr0];
  int first, wr;
  warp_rows(nr, first, wr);
  for (int r = first, wn; r < first + wr; r += wn) {
    // the rows whose terms fit (the first always does)
    const int need =
        lane < first + wr - r ? s_pv[r + lane] : kKeptTerms + 1;
    wn = __popc(__ballot_sync(
        0xffffffffu, warp_scan2(make_int2(need, 0)).x <= kKeptTerms));
    const int I0 = t.row_item[tr0 + r] - P0;  // local to the tile
    for (int q = lane; q < wn * S; q += 32) {
      w.term[0][q] = 0.0f;
      w.term[1][q] = 0.0f;
    }
    __syncwarp();
    cat_potentials<2, true>(t, p.weights, p.xr, p.xer, tr0 + r, wn, K,
                            w.term[0], w.term[1], w, wn * S,
                            reinterpret_cast<uint32_t*>(s_g) + I0,
                            s_inc + I0);
    if (lane < wn) {
      int pv, ev;
      bool lrn;
      draw_row<KMAX>(t, p, tr0 + r + lane, w.card[lane],
                     w.term[0] + lane * S, w.term[1] + lane * S, pv, ev,
                     lrn);
      s_pv[r + lane] = pv;
      s_ev[r + lane] = ev;
      s_lrn[r + lane] = lrn;
    }
    __syncwarp();
    kept_gradients(t, p, P0 + I0, w.ri[wn], K, w, s_pv + r, s_ev + r,
                   s_lrn + r, s_g + I0, s_inc + I0);
    __syncwarp();  // the next run reuses the warp's terms
  }
  __syncthreads();  // every item's gradient in s_g / s_inc
  if (npc == 1)
    piece_sums(o, pc0, t.row_item[tr1] - P0, s_g, s_inc, s_rg, s_rn);
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

// the per-weight tables of one step: weights q0 .. q0 + n_ws - 1, the
// first n_big of them with more than kSumWidth partial slots
struct WeightSums {
  const int32_t* wt_wid;
  const int32_t* wt_p0;   // first partial slot
  const int32_t* wt_np;   // partial slots
  const float* part_g;
  const int32_t* part_n;
  int q0, n_big, n_ws;
};

// a block per large weight, then a warp per weight; one thread then
// applies the update, or (gw non-null) stores the sums densely at
// gw[wid], nw[wid]
__global__ void __launch_bounds__(kSumWidth)
    learn_sum_kernel(const WeightSums s, const int8_t* w_fixed, float* w,
                     float* gw, int32_t* nw, const Update u) {
  __shared__ float s_rg[kSumWidth];
  __shared__ int s_rn[kSumWidth];
  float g = 0.0f;
  int n = 0, q;
  if (blockIdx.x < s.n_big) {
    q = s.q0 + blockIdx.x;
    const int p0 = s.wt_p0[q], np = s.wt_np[q];
#pragma unroll 8
    for (int j = threadIdx.x; j < np; j += kSumWidth) {
      g = __fadd_rn(g, s.part_g[p0 + j]);
      n += s.part_n[p0 + j];
    }
    block_tree<kSumWidth>(g, n, s_rg, s_rn);
    if (threadIdx.x != 0) return;
  } else {
    const int qi = s.n_big + (blockIdx.x - s.n_big) * (kSumWidth / 32) +
                   (threadIdx.x >> 5);
    if (qi >= s.n_ws) return;  // the whole warp leaves together
    q = s.q0 + qi;
    const int lane = threadIdx.x & 31;
    const int p0 = s.wt_p0[q], np = s.wt_np[q];
    for (int j = lane; j < np; j += 32) {
      g = __fadd_rn(g, s.part_g[p0 + j]);
      n += s.part_n[p0 + j];
    }
    warp_tree(g, n);
    if (lane != 0) return;
  }
  const int wid = s.wt_wid[q];
  if (gw != nullptr) {
    gw[wid] = g;
    nw[wid] = n;
    return;
  }
  if (n == 0 || w_fixed[wid] != 0) return;  // not touched
  w[wid] = apply_weight(w[wid], g, n, wid, u);
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

// a categorical kernel (learn_cat_kernel for the step's re-read tiles,
// learn_kept_kernel for its kept ones): static and dynamic shared memory
// together pass 48 KB
template <typename Kernel>
cudaError_t launch_cat(Kernel kernel, const Tables& t, const LearnStep& p,
                       const Order& o, int n_tiles, size_t smem,
                       cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<n_tiles, kTileRows, smem, stream>>>(t, p, o);
  return cudaSuccess;
}

// the kernel of `form`: shared memory per item (gradient, counted), and
// on the item path also both chains' evaluations, the weight, the slot
// flags and the row; the categorical kernels' potentials share it. A
// form that is not of this KMAX, or an item step whose longest piece
// passes kItemTile, is refused
template <int KMAX>
cudaError_t launch_step(const Tables& t, const LearnStep& p, const Order& o,
                        int n_tiles, int form, cudaStream_t stream) {
  if constexpr (KMAX == 2) {
    if ((form != FORM_ITEM && form != FORM_ROW) ||
        (form == FORM_ITEM && o.smem_items > kItemTile))
      return cudaErrorInvalidValue;
    const size_t smem =
        (static_cast<size_t>(o.smem_items) * (form == FORM_ITEM ? 27 : 5) +
         15) & ~15;
    if (form == FORM_ITEM)
      learn_item_kernel<<<n_tiles, kTileRows, smem, stream>>>(t, p, o);
    else
      learn_step_kernel<<<n_tiles, kTileRows, smem, stream>>>(t, p, o);
  } else {
    if (form != FORM_CAT && form != FORM_KEPT) return cudaErrorInvalidValue;
    const size_t pots = sizeof(float) * 2 * cat_pot_rows(p.kmax) *
                        static_cast<size_t>(cat_stride(p.kmax));
    const size_t smem =
        (std::max(pots, static_cast<size_t>(o.smem_items) * 5) + 15) & ~15;
    const cudaError_t e =
        form == FORM_KEPT
            ? launch_cat(learn_kept_kernel<KMAX>, t, p, o, n_tiles, smem,
                         stream)
            : launch_cat(learn_cat_kernel<KMAX>, t, p, o, n_tiles, smem,
                         stream);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

cudaError_t launch_sum(const WeightSums& s, const int8_t* w_fixed, float* w,
                       float* gw, int32_t* nw, const Update& u,
                       cudaStream_t stream) {
  constexpr int warps = kSumWidth / 32;
  const int blocks = s.n_big + (s.n_ws - s.n_big + warps - 1) / warps;
  learn_sum_kernel<<<blocks, kSumWidth, 0, stream>>>(s, w_fixed, w, gw, nw,
                                                      u);
  return cudaGetLastError();
}

// every kernel of the library, as nsx_learn_attrs numbers them
const void* const kKernels[] = {
    reinterpret_cast<const void*>(learn_item_kernel),
    reinterpret_cast<const void*>(learn_step_kernel),
    reinterpret_cast<const void*>(learn_cat_kernel<8>),
    reinterpret_cast<const void*>(learn_cat_kernel<32>),
    reinterpret_cast<const void*>(learn_cat_kernel<128>),
    reinterpret_cast<const void*>(learn_sum_kernel),
    reinterpret_cast<const void*>(learn_apply_kernel),
    reinterpret_cast<const void*>(learn_kept_kernel<8>),
    reinterpret_cast<const void*>(learn_kept_kernel<32>),
    reinterpret_cast<const void*>(learn_kept_kernel<128>)};

}  // namespace

// tile_rows and sum_width must equal the kernels' kTileRows and
// kSumWidth (the tables were cut for them); anything else is refused.
// `form` (a LearnForm) names the kernel, which takes the step's tiles
// that tl_form gives that form: a step with tiles of two forms is two
// calls. Where every tile of the step takes one form, tl_form is null,
// and no block reads it
extern "C" int nsx_learn_step(
    const int32_t* row_vid, const int32_t* row_card, const int32_t* row_upos,
    const int8_t* row_flags, const int32_t* row_item, const int32_t* it_arg,
    const int32_t* it_wid, const int32_t* it_meta, const int32_t* arg_vid,
    const int32_t* arg_ec, const float* it_fv,
    const float* weights, int32_t* x, int32_t* xe, const int32_t* xr,
    const int32_t* xer, int32_t* send, int32_t* send_e, const float* ext_p,
    const float* ext_e, const int32_t* tl_r0, const int32_t* tl_pc0,
    const int32_t* pc_g0, const int32_t* pc_perm, const int32_t* gr_off,
    const int32_t* gr_len, const int32_t* gr_slot, const int32_t* perm,
    const int32_t* tl_form, float* part_g, int32_t* part_n, int row0,
    int tile0, int n_tiles, int tile_rows, int piece_items, int smem_items, int kmax, int seed,
    int salt16, int lrn_all, int kext, int form, void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  if ((ext_p != nullptr || ext_e != nullptr) && kext < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile_rows != kTileRows || piece_items < 1 || smem_items < 0 ||
      smem_items > piece_items ||
      static_cast<int64_t>(smem_items) * 5 + 15 > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables t{row_vid, row_card, row_upos, row_flags, row_item,
                 it_arg,  it_wid,   it_meta,  arg_vid,   arg_ec};
  const LearnStep p{weights, it_fv, x, xe, xr, xer, send, send_e, ext_p,
                    ext_e, row0, kmax, static_cast<uint32_t>(seed),
                    static_cast<uint32_t>(salt16), lrn_all, kext};
  const Order o{tl_r0, tl_pc0,  pc_g0,   pc_perm,     gr_off,
                gr_len, gr_slot, perm,    tl_form,     part_g,
                part_n, tile0,   piece_items, smem_items};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (kmax <= 2)
    return static_cast<int>(launch_step<2>(t, p, o, n_tiles, form, s));
  if (kmax <= 8)
    return static_cast<int>(launch_step<8>(t, p, o, n_tiles, form, s));
  if (kmax <= 32)
    return static_cast<int>(launch_step<32>(t, p, o, n_tiles, form, s));
  if (kmax <= 128)
    return static_cast<int>(launch_step<128>(t, p, o, n_tiles, form, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// the weight sums of one step and each weight's update
extern "C" int nsx_learn_sum(const int32_t* wt_wid, const int32_t* wt_p0,
                             const int32_t* wt_np, const float* part_g,
                             const int32_t* part_n, const int8_t* w_fixed,
                             float* w, int q0, int n_big, int n_ws,
                             int sum_width, int mean, int regularization,
                             float step, float shrink, float l1d,
                             float thresh, int seed, int salt_w,
                             void* stream) {
  if (sum_width != kSumWidth || n_big < 0 || n_big > n_ws)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_ws <= 0) return static_cast<int>(cudaGetLastError());
  const WeightSums s{wt_wid, wt_p0, wt_np, part_g, part_n, q0, n_big, n_ws};
  const Update u{mean, regularization, step, shrink, l1d, thresh,
                 static_cast<uint32_t>(seed), static_cast<uint32_t>(salt_w)};
  return static_cast<int>(launch_sum(s, w_fixed, w, nullptr, nullptr, u,
                                     static_cast<cudaStream_t>(stream)));
}

// zero the dense partial, then (n_ws > 0) one launch of the sum kernel
// that stores each weight's sums at gw[wid], nw[wid]
extern "C" int nsx_learn_partial(const int32_t* wt_wid, const int32_t* wt_p0,
                                 const int32_t* wt_np, const float* part_g,
                                 const int32_t* part_n, float* gw,
                                 int32_t* nw, int q0, int n_big, int n_ws,
                                 int n_w, int sum_width, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sum_width != kSumWidth || n_big < 0 || n_big > n_ws)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_w > 0) {
    cudaError_t e = cudaMemsetAsync(gw, 0, sizeof(float) * n_w, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(nw, 0, sizeof(int32_t) * n_w, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n_ws <= 0) return static_cast<int>(cudaGetLastError());
  const WeightSums ws{wt_wid, wt_p0, wt_np, part_g, part_n, q0, n_big, n_ws};
  return static_cast<int>(launch_sum(ws, nullptr, nullptr, gw, nw, Update{},
                                     s));
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

// the blocks of kernel `which` of kKernels (numbered as below) that one
// SM holds at `threads` threads a block and `smem` bytes of dynamic
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor, with the
// opt-in launch_step gives the categorical kernels)
extern "C" int nsx_learn_occupancy(int which, int threads, int smem,
                                   int* blocks) {
  constexpr int n = sizeof(kKernels) / sizeof(kKernels[0]);
  if (which < 0 || which >= n) return static_cast<int>(cudaErrorInvalidValue);
  if ((which >= 2 && which <= 4) || which >= 7) {
    const cudaError_t e = cudaFuncSetAttribute(
        kKernels[which], cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kKernels[which], threads, static_cast<size_t>(smem)));
}

// the registers a thread and the local memory a thread (spills and local
// arrays) of kernel `which` of kKernels (0: learn_item_kernel, 1:
// learn_step_kernel, 2-4: learn_cat_kernel at KMAX 8, 32, 128, 5:
// learn_sum_kernel, 6: learn_apply_kernel, 7-9: learn_kept_kernel at KMAX
// 8, 32, 128), as the loaded module reports them
extern "C" int nsx_learn_attrs(int which, int* regs, int* local_bytes) {
  constexpr int n = sizeof(kKernels) / sizeof(kKernels[0]);
  if (which < 0 || which >= n) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(&a, kKernels[which]);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
