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
// How: two launches on one stream per (epoch, color).
//   learn_step_kernel  (learn_item_kernel at KMAX 2, see below)
//                      one block of kTileRows threads per tile, a run of
//                      at most kTileRows of the color's rows whose items
//                      fit the shared-memory budget
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
// At KMAX 2 with at most kItemTile items per tile (the boolean graphs of
// the main path) learn_item_kernel runs the tile's items in parallel,
// neighbouring threads on neighbouring items and arguments: each item's
// evaluations at 0 and 1 for both chains go to shared memory (EQUAL,
// ISTRUE, AND and OR from the one count their value reads), one thread
// per row adds its items' terms from there in item order (the plain
// version's order) and draws, and the gradient takes the evaluation
// already made at each drawn value, the same function of the same
// inputs; only an item that was not evaluated at a drawn value is
// evaluated again. That kernel is held to 64 registers, 8 blocks an SM.
// Other steps run learn_step_kernel, one thread per row, which reads its
// items a second time for the gradient. The gradients never leave shared
// memory: per step the partials are 8 B per (tile, weight), and the sum
// kernel reads them once.
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

#include "itemgrid_common.cuh"

namespace {

constexpr uint32_t kClampedSaltXor = 0x55555555u;
constexpr int kTileRows = 128;   // rows per tile: threads of a step block
constexpr int kSumWidth = 1024;  // threads of a weight-sum block
constexpr int kItemTile = 1024;  // KMAX 2: items of a tile run in parallel
constexpr int kMaxSmem = 48 * 1024;

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
// chain), every factor type: the arguments' tables are read once, and
// each result is eval_item's for its array (the same integer statistics,
// the same finalize)
__device__ __forceinline__ void eval_item2(const Tables& t,
                                            const int32_t* xa,
                                            const int32_t* xb, int ftype,
                                            int a0, int arity, int k,
                                            float& ea, float& eb) {
  ArgStats sa, sb;
  const int h = arity > 1 ? arity - 1 : 0;
  auto value = [&](int a, int& va, int& vb) {
    if (t.arg_subst[a0 + a]) {
      va = vb = k;
    } else {
      const int vid = t.arg_vid[a0 + a];
      va = xa[vid];
      vb = xb[vid];
    }
  };
  value(0, sa.v0, sb.v0);
  value(h, sa.head, sb.head);
  sa.head_eq = sb.head_eq = t.arg_eq[a0 + h];
  sa.v1 = sb.v1 = sa.v2 = sb.v2 = 0;
  if (arity > 1) value(1, sa.v1, sb.v1);
  if (arity > 2) value(2, sa.v2, sb.v2);
  sa.card0 = sb.card0 = t.arg_card[a0];
  sa.card1 = sb.card1 = arity > 1 ? t.arg_card[a0 + 1] : sa.card0;
  const int ua = sa.v0 - 1 < 0 ? 0 : (sa.v0 - 1 > h ? h : sa.v0 - 1);
  const int ub = sb.v0 - 1 < 0 ? 0 : (sb.v0 - 1 > h ? h : sb.v0 - 1);
  sa.ufo_sel = arg_value(t, xa, a0, ua, k);
  sb.ufo_sel = arg_value(t, xb, a0, ub, k);
  sa.n_zero = sa.n_one = sa.n_diff0 = sa.n_head_eq = sa.n_body_zero = 0;
  sa.n_neq_eq = sa.n_eq_eq = sa.n_body_neq_eq = 0;
  sb.n_zero = sb.n_one = sb.n_diff0 = sb.n_head_eq = sb.n_body_zero = 0;
  sb.n_neq_eq = sb.n_eq_eq = sb.n_body_neq_eq = 0;
  for (int a = 0; a < arity; ++a) {
    int va, vb;
    value(a, va, vb);
    const int e = t.arg_eq[a0 + a];
    sa.n_zero += va == 0;
    sb.n_zero += vb == 0;
    sa.n_one += va == 1;
    sb.n_one += vb == 1;
    sa.n_diff0 += va != sa.v0;
    sb.n_diff0 += vb != sb.v0;
    sa.n_neq_eq += va != e;
    sb.n_neq_eq += vb != e;
    sa.n_eq_eq += va == e;
    sb.n_eq_eq += vb == e;
    if (a < arity - 1) {
      sa.n_head_eq += va == sa.head;
      sb.n_head_eq += vb == sb.head;
      sa.n_body_zero += va == 0;
      sb.n_body_zero += vb == 0;
      sa.n_body_neq_eq += va != e;
      sb.n_body_neq_eq += vb != e;
    }
  }
  ea = finalize(ftype, sa);
  eb = finalize(ftype, sb);
}

// eval_item2, with the boolean types whose finalize reads one count
// (any argument 0: ISTRUE, AND; any 1: OR; any unlike the first: EQUAL)
// computed from that count alone, in fewer operations and registers (the
// item kernel; in the row kernel the branch costs registers and time)
__device__ __forceinline__ void eval_item2_fast(const Tables& t,
                                                const int32_t* xa,
                                                const int32_t* xb, int ftype,
                                                int a0, int arity, int k,
                                                float& ea, float& eb) {
  if (ftype != F_EQUAL && ftype != F_ISTRUE && ftype != F_AND &&
      ftype != F_OR) {
    eval_item2(t, xa, xb, ftype, a0, arity, k, ea, eb);
    return;
  }
  auto value = [&](int a, int& va, int& vb) {
    if (t.arg_subst[a0 + a]) {
      va = vb = k;
    } else {
      const int vid = t.arg_vid[a0 + a];
      va = xa[vid];
      vb = xb[vid];
    }
  };
  int v0a, v0b;
  value(0, v0a, v0b);
  bool za = false, zb = false, oa = false, ob = false, da = false,
       db = false;
  for (int a = 0; a < arity; ++a) {
    int va, vb;
    value(a, va, vb);
    za |= va == 0;
    zb |= vb == 0;
    oa |= va == 1;
    ob |= vb == 1;
    da |= va != v0a;
    db |= vb != v0b;
  }
  const bool neg_a = ftype == F_EQUAL ? da : ftype == F_OR ? !oa : za;
  const bool neg_b = ftype == F_EQUAL ? db : ftype == F_OR ? !ob : zb;
  ea = neg_a ? -1.0f : 1.0f;
  eb = neg_b ? -1.0f : 1.0f;
}

// eval_item of item `it` at candidate k, its tables read here
__device__ __forceinline__ float eval_at(const Tables& t, const int32_t* x,
                                      int it, int k) {
  return eval_item(t, x, t.it_ftype[it], t.it_arg[it], t.it_arity[it], k);
}

// one item's gradient at the drawn values, evaluated from the tables
__device__ __forceinline__ float item_grad(const Tables& t,
                                           const LearnStep& p, int it,
                                           int p_val, int e_val) {
  const int ftype = t.it_ftype[it];
  const int a0 = t.it_arg[it];
  const int arity = t.it_arity[it];
  const float ep = eval_item(t, p.xr, ftype, a0, arity, p_val);
  const float ee = eval_item(t, p.xer, ftype, a0, arity, e_val);
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
  uint8_t* s_flag = s_inc + S;  // dense, d1 == 0, d1 == 1, d2 == 0, d2 == 1
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
    const int ftype = t.it_ftype[it];
    const float w = p.weights[t.it_wid[it]];
    const int a0 = t.it_arg[it];
    const int arity = t.it_arity[it];
    const bool dense = t.it_dense[it] != 0;
    const int d1 = t.it_d1[it], d2 = t.it_d2[it];
    float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (dense ? k < card : (k == d1 || k == d2))
        eval_item2_fast(t, p.xr, p.xer, ftype, a0, arity, k, e[k],
                        e[2 + k]);
    }
    s_e[j] = make_float4(e[0], e[1], e[2], e[3]);
    s_w[j] = w;
    s_flag[j] = static_cast<uint8_t>(dense | (d1 == 0) << 1 | (d1 == 1) << 2 |
                                     (d2 == 0) << 3 | (d2 == 1) << 4);
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
      const int d1 = t.it_d1[it], d2 = t.it_d2[it];
      hit = d1 == ev || d1 == pv || d2 == ev || d2 == pv;
      okp = static_cast<unsigned>(pv) < 2u &&
            (dense ? pv < card : (pv == d1 || pv == d2));
      oke = static_cast<unsigned>(ev) < 2u &&
            (dense ? ev < card : (ev == d1 || ev == d2));
    }
    const bool inc = s_lrn[row] && (dense || hit);
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

// any other step: one thread per row (potentials, draws), then its
// items' gradients, piece by piece
template <int KMAX>
__global__ void __launch_bounds__(kTileRows)
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
          float ep, ee;
          eval_item2(t, p.xr, p.xer, ftype, a0, arity, k, ep, ee);
          pot_p[k] = __fadd_rn(pot_p[k], __fmul_rn(w, ep));
          pot_e[k] = __fadd_rn(pot_e[k], __fmul_rn(w, ee));
        }
      });
    }
    draw_row<KMAX>(t, p, r, card, pot_p, pot_e, p_val, e_val, lrn);
  }

  // the tile's items [P0, T1), in pieces of piece_items
  for (int pc = o.tl_pc0[tile]; pc < o.tl_pc0[tile + 1];
       ++pc, P0 += o.piece_items) {
    const int P1 = min(P0 + o.piece_items, T1);
    if (active) {
      const int lo = max(it0, P0), hi = min(it1, P1);
      for (int it = lo; it < hi; ++it) {
        const int d1 = t.it_d1[it], d2 = t.it_d2[it];
        const bool hit =
            d1 == e_val || d1 == p_val || d2 == e_val || d2 == p_val;
        const bool inc = lrn && (t.it_dense[it] != 0 || hit);
        s_g[it - P0] = inc ? item_grad(t, p, it, p_val, e_val) : 0.0f;
        s_inc[it - P0] = inc ? 1 : 0;
      }
    }
    __syncthreads();
    piece_sums(o, pc, P1 - P0, s_g, s_inc, s_rg, s_rn);
    __syncthreads();  // the next piece reuses the shared memory
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

// shared memory per item: (gradient, counted), and on the item path
// also both chains' evaluations, the weight, the slot flags and the row
template <int KMAX>
cudaError_t launch_step(const Tables& t, const LearnStep& p, const Order& o,
                        int n_tiles, cudaStream_t stream) {
  const bool items = KMAX == 2 && o.smem_items <= kItemTile;
  const size_t smem =
      (static_cast<size_t>(o.smem_items) * (items ? 27 : 5) + 15) & ~15;
  if (items)
    learn_item_kernel<<<n_tiles, kTileRows, smem, stream>>>(t, p, o);
  else
    learn_step_kernel<KMAX><<<n_tiles, kTileRows, smem, stream>>>(t, p, o);
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

}  // namespace

// tile_rows and sum_width must equal the kernels' kTileRows and
// kSumWidth (the tables were cut for them); anything else is refused
extern "C" int nsx_learn_step(
    const int32_t* row_vid, const int32_t* row_card, const int32_t* row_upos,
    const int8_t* row_flags, const int32_t* row_item,
    const int32_t* it_ftype, const int32_t* it_wid, const int32_t* it_arity,
    const int32_t* it_arg, const int8_t* it_dense, const int32_t* it_d1,
    const int32_t* it_d2, const int32_t* arg_vid, const int32_t* arg_eq,
    const int32_t* arg_card, const int8_t* arg_subst, const float* it_fv,
    const float* weights, int32_t* x, int32_t* xe, const int32_t* xr,
    const int32_t* xer, int32_t* send, int32_t* send_e, const float* ext_p,
    const float* ext_e, const int32_t* tl_r0, const int32_t* tl_pc0,
    const int32_t* pc_g0, const int32_t* pc_perm, const int32_t* gr_off,
    const int32_t* gr_len, const int32_t* gr_slot, const int32_t* perm,
    float* part_g, int32_t* part_n, int row0, int tile0, int n_tiles,
    int tile_rows, int piece_items, int smem_items, int kmax, int seed,
    int salt16, int lrn_all, int kext, void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  if ((ext_p != nullptr || ext_e != nullptr) && kext < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile_rows != kTileRows || piece_items < 1 || smem_items < 0 ||
      smem_items > piece_items ||
      static_cast<int64_t>(smem_items) * 5 + 15 > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables t{row_vid, row_card, row_upos, row_flags, row_item,
                 it_ftype, it_wid,  it_arity, it_arg,    it_dense,
                 it_d1,    it_d2,   arg_vid,  arg_eq,    arg_card,
                 arg_subst};
  const LearnStep p{weights, it_fv, x, xe, xr, xer, send, send_e, ext_p,
                    ext_e, row0, kmax, static_cast<uint32_t>(seed),
                    static_cast<uint32_t>(salt16), lrn_all, kext};
  const Order o{tl_r0,  tl_pc0,  pc_g0, pc_perm, gr_off,
                gr_len, gr_slot, perm,  part_g,  part_n,
                tile0,  piece_items, smem_items};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (kmax <= 2) return static_cast<int>(launch_step<2>(t, p, o, n_tiles, s));
  if (kmax <= 8) return static_cast<int>(launch_step<8>(t, p, o, n_tiles, s));
  if (kmax <= 32)
    return static_cast<int>(launch_step<32>(t, p, o, n_tiles, s));
  if (kmax <= 128)
    return static_cast<int>(launch_step<128>(t, p, o, n_tiles, s));
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
