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
// the packed item tables are CSR arrays read directly, and there is one
// launch per (epoch, color) in which one thread draws each row, so no
// atomics are needed.
//
// How, per step: at KMAX 2 (the boolean graphs: Ising,
// coin, voting) sweep_item_kernel; one block takes a tile of consecutive
// rows, whose items are contiguous in the tables, and walks them in
// chunks of kChunk items. Neighbouring threads take neighbouring items
// (coalesced reads of the packed records) and evaluate each at
// candidates 0 and 1 from one read of its arguments, EQUAL, ISTRUE, AND
// and OR from the one fact they read; a step of wide
// items (voting: one AND of arity 51 a row) gives each item a group of
// L threads that read its arguments side by side and combine what they
// found by OR or integer sums (eval_item01_group). Each product w x e
// goes to shared memory. Then one thread per row adds its items'
// terms in item order from 0.0, chunk after chunk, which is the order of
// the plain version, so the potentials are the same bits for any tile
// size; then it draws and writes (finish_row). The wrapper
// picks L and the tile's rows from the step's rows, items and arguments
// (ops/itemgrid.sweep_lanes, sweep_tile_rows), so that a short step
// still gives enough blocks for the 132 SMs. A step whose items are all
// EQUAL, ISTRUE, AND or OR runs the kernel built for those alone (FAST),
// held to 32 registers so that 16 blocks fill an SM; any other step the
// kernel with the general evaluator, held to 80 (6 blocks).
//
// At KMAX 8, 32 and 128 (any graph with a variable of cardinality 3 or
// more: the data-programming models, LF models, Potts grids)
// sweep_cat_kernel takes a tile of rows the same way, a run of them
// each warp, and cat_potentials (itemgrid_common.cuh) walks a warp's
// items in chunks: neighbouring lanes read neighbouring items' records,
// the chunk's argument values are read once into shared memory, and
// then lanes take (item, candidate) terms, every candidate that the
// dense / d1 / d2 rule keeps evaluated from that one read (a dense item
// at cardinality K read its arguments K times in the row kernel this
// replaces; a sparse item keeps two terms, not K). Then lanes take
// (row, candidate) pairs and add each row's terms in item order into its
// potentials in shared memory, the plain version's order, so the
// potentials are the same bits for any tile or chunk. One lane per row
// then draws from them (finish_row, as before). The wrapper picks the
// tile's rows (ops/itemgrid.cat_tile_rows): at most kCatThreads, and at
// most kCatPotFloats potentials, so 32 rows at KMAX 128. What bounds it
// (PERF.md): the work of a chunk, not its bytes; evaluating the
// counts of the semantics table for codes that read none of them took
// half of a DP epoch, so eval_args skips them.
//
// What bounds it on the H100: the bytes of every epoch, and, below them,
// the latency of each item's chain of dependent loads (item -> argument
// -> value) against the items in flight per SM. The packed tables read
// 12 B per item and 8 B per argument (25 B and 13 B unpacked): a
// 33.5M-variable Ising epoch moves about 4.9 GB (was 7.95), a bound of
// about 1.45 ms at the H100's 3.35 TB/s (H100 80GB HBM3, 700 W); its
// times stand in PERF.md. At high cardinality the categorical kernel
// also evaluates K terms a dense item, from shared memory, and keeps no
// per-thread potential array (the row kernel's pot[KMAX] sat in local
// memory at KMAX 32 and 128).
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

constexpr int kItemThreads = 128;  // threads of an item-kernel block
constexpr int kChunk = 512;        // items a block holds in shared memory
constexpr int kArgChunk = 1024;    // argument values it stages (FAST, L 1)

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
  int tile_rows;      // rows of a block's tile
};

// the row's uniform under the step's position map
__device__ __forceinline__ float uniform01(const Step& p, int upos) {
  const uint32_t blk = static_cast<uint32_t>(upos) >> 10;
  const uint32_t pos = static_cast<uint32_t>(upos) & 1023u;
  const uint32_t i0 = p.map_kind == MAP_TILE ? pos >> 7 : 0u;
  const uint32_t i1 = p.map_kind == MAP_TILE ? pos & 127u : pos;
  return hash_uniform(p.seed977, p.salt16 + blk, i0, i1);
}

// row r (step row i) after its items: external potentials, the draw, the
// writes of x, of send and of the tally
template <int KMAX>
__device__ __forceinline__ void finish_row(const Tables& t, const Step& p,
                                           int i, int r, int card,
                                           float* pot) {
  const int vid = t.row_vid[r];
  const int K = p.kmax;
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
  if (p.tally && (flags & ROW_TALLY))
    p.counts[static_cast<int64_t>(vid) * K + v] += 1;
}

// KMAX 8, 32, 128: block b takes the step's rows [b * tile_rows, ...),
// each of its kCatWarps warps a run of them (warp_rows), whose
// potentials cat_potentials sums item-parallel into shared memory
// (tile_rows x cat_stride(kmax) floats, dynamic); then one lane per row
// draws from them (finish_row). No warp waits for another
template <int KMAX>
__global__ void __launch_bounds__(kCatThreads)
    sweep_cat_kernel(const Tables t, const Step p) {
  extern __shared__ float s_pot[];
  __shared__ CatWarp<1> sh[kCatWarps];
  const int i0 = blockIdx.x * p.tile_rows;
  int first, nr;
  warp_rows(min(p.tile_rows, p.n_rows - i0), first, nr);
  if (nr <= 0) return;
  const int lane = threadIdx.x & 31, S = cat_stride(p.kmax);
  const int r0 = p.row0 + i0 + first;
  float* pot = s_pot + first * S;
  for (int q = lane; q < nr * S; q += 32) pot[q] = 0.0f;
  __syncwarp();
  CatWarp<1>& w = sh[threadIdx.x >> 5];
  cat_potentials<1>(t, p.weights, p.xr, nullptr, r0, nr, p.kmax, pot,
                    nullptr, w);
  if (lane < nr)
    finish_row<KMAX>(t, p, i0 + first + lane, r0 + lane, w.card[lane],
                     pot + lane * S);
}

// the one fact that finalize reads for EQUAL, ISTRUE, AND and OR, from
// bits of what an item's arguments hold: 1 a zero, 2 a one, 4 a value
// unlike the first argument's
__device__ __forceinline__ float fast_value(int ftype, unsigned bits) {
  const bool neg = ftype == F_EQUAL ? (bits & 4u) != 0
                   : ftype == F_OR  ? (bits & 2u) == 0
                                    : (bits & 1u) != 0;
  return neg ? -1.0f : 1.0f;
}

// what argument values va (candidate 0) and vb (candidate 1) hold, as
// fast_value reads it: bits 0-2 at candidate 0, bits 3-5 at candidate 1
__device__ __forceinline__ unsigned fast_bits(int va, int vb, int v0a,
                                              int v0b) {
  return static_cast<unsigned>(va == 0) |
         static_cast<unsigned>(va == 1) << 1 |
         static_cast<unsigned>(va != v0a) << 2 |
         static_cast<unsigned>(vb == 0) << 3 |
         static_cast<unsigned>(vb == 1) << 4 |
         static_cast<unsigned>(vb != v0b) << 5;
}

// an item of EQUAL, ISTRUE, AND or OR at candidates 0 and 1, from its
// arguments' values staged in shared memory (own: the row's variable)
__device__ __forceinline__ void eval_staged01(int ftype, const int* val,
                                              const uint8_t* own, int a0,
                                              int arity, float& e0,
                                              float& e1) {
  const int v0a = own[a0] ? 0 : val[a0], v0b = own[a0] ? 1 : val[a0];
  unsigned bits = 0;
  for (int a = a0; a < a0 + arity; ++a) {
    const int v = val[a];
    bits |= own[a] ? fast_bits(0, 1, v0a, v0b) : fast_bits(v, v, v0a, v0b);
  }
  e0 = fast_value(ftype, bits);
  e1 = fast_value(ftype, bits >> 3);
}

// the lanes of a group of L threads within its warp
template <int L>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (L == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << L) - 1u) << ((threadIdx.x & 31u) & ~(L - 1u));
  }
}

// an item at candidates 0 and 1 (values x), by the L lanes of a group
// (mask; L may be 1): lane l reads arguments l, l + L, ...; what they
// found is combined across the lanes by OR or by integer sums, which no
// order changes, and each candidate's finalize is eval_item's. FAST: the
// item is EQUAL, ISTRUE, AND or OR
template <int L, bool FAST>
__device__ __forceinline__ void eval_item01_group(const Tables& t,
                                                  const int32_t* x,
                                                  int ftype, int a0,
                                                  int arity, int lane,
                                                  unsigned mask, float& e0,
                                                  float& e1) {
  auto value = [&](int a, int& va, int& vb) {
    const int vid = arg_ref(t, a0 + a);
    if (vid < 0) {
      va = 0;
      vb = 1;
    } else {
      va = vb = x[vid];
    }
  };
  int v0a, v0b;
  value(0, v0a, v0b);
  if (FAST || ftype == F_EQUAL || ftype == F_ISTRUE || ftype == F_AND ||
      ftype == F_OR) {
    unsigned bits = 0;
    for (int a = lane; a < arity; a += L) {
      int va, vb;
      value(a, va, vb);
      bits |= fast_bits(va, vb, v0a, v0b);
    }
    bits = __reduce_or_sync(mask, bits);
    e0 = fast_value(ftype, bits);
    e1 = fast_value(ftype, bits >> 3);
    return;
  }
  ArgStats sa, sb;
  const int h = arity > 1 ? arity - 1 : 0;
  sa.v0 = v0a;
  sb.v0 = v0b;
  value(h, sa.head, sb.head);
  sa.head_eq = sb.head_eq = arg_eq(t, a0 + h);
  sa.v1 = sb.v1 = sa.v2 = sb.v2 = 0;
  if (arity > 1) value(1, sa.v1, sb.v1);
  if (arity > 2) value(2, sa.v2, sb.v2);
  sa.card0 = sb.card0 = arg_card(t, a0);
  sa.card1 = sb.card1 = arity > 1 ? arg_card(t, a0 + 1) : sa.card0;
  const int ua = sa.v0 - 1 < 0 ? 0 : (sa.v0 - 1 > h ? h : sa.v0 - 1);
  const int ub = sb.v0 - 1 < 0 ? 0 : (sb.v0 - 1 > h ? h : sb.v0 - 1);
  sa.ufo_sel = arg_value(t, x, a0 + ua, 0);
  sb.ufo_sel = arg_value(t, x, a0 + ub, 1);
  int c[16] = {};  // the counts of eval_item2, candidate 0 then 1
  for (int a = lane; a < arity; a += L) {
    int va, vb;
    value(a, va, vb);
    const int e = arg_eq(t, a0 + a);
    const bool body = a < arity - 1;
    c[0] += va == 0;
    c[1] += va == 1;
    c[2] += va != sa.v0;
    c[3] += va != e;
    c[4] += va == e;
    c[5] += body && va == sa.head;
    c[6] += body && va == 0;
    c[7] += body && va != e;
    c[8] += vb == 0;
    c[9] += vb == 1;
    c[10] += vb != sb.v0;
    c[11] += vb != e;
    c[12] += vb == e;
    c[13] += body && vb == sb.head;
    c[14] += body && vb == 0;
    c[15] += body && vb != e;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = __reduce_add_sync(mask, c[i]);
  sa.n_zero = c[0], sa.n_one = c[1], sa.n_diff0 = c[2], sa.n_neq_eq = c[3];
  sa.n_eq_eq = c[4], sa.n_head_eq = c[5], sa.n_body_zero = c[6];
  sa.n_body_neq_eq = c[7];
  sb.n_zero = c[8], sb.n_one = c[9], sb.n_diff0 = c[10];
  sb.n_neq_eq = c[11], sb.n_eq_eq = c[12], sb.n_head_eq = c[13];
  sb.n_body_zero = c[14], sb.n_body_neq_eq = c[15];
  e0 = finalize(ftype, sa);
  e1 = finalize(ftype, sb);
}

// KMAX 2: block b takes the step's rows [b * tile_rows, ...) and their
// items, in chunks of at most kChunk; each item goes to a group of L
// threads (L = 1: one thread). FAST: every item of the step is EQUAL,
// ISTRUE, AND or OR, of at most kArgChunk arguments (the wrapper knows
// it from the tables), so the general evaluator is compiled out, and at
// L = 1 a chunk also holds at most kArgChunk arguments, whose values the
// block first reads side by side into shared memory (coalesced, many
// loads in flight a thread) and the items then read from there. A term
// that the dense / d1 / d2 rule leaves out is stored as +0.0 and still
// added: a potential starts at +0.0 and a round-to-nearest sum is -0.0
// only when both terms are, so it is never -0.0, and adding +0.0 leaves
// every other float as it is. Only a dense item's k < card test needs
// the row, so the row applies it (card >= 2 passes both candidates).
template <int L, bool FAST>
__global__ void __launch_bounds__(kItemThreads, FAST ? 16 : 6)
    sweep_item_kernel(const Tables t, const Step p) {
  constexpr int kGroups = kItemThreads / L;
  constexpr bool kStaged = FAST && L == 1;
  __shared__ float2 s_term[kChunk];  // w x e at candidates 0 and 1
  __shared__ uint8_t s_dense[kChunk];
  __shared__ int s_val[kStaged ? kArgChunk : 1];      // argument values
  __shared__ uint8_t s_own[kStaged ? kArgChunk : 1];  // the row's own
  __shared__ int s_end;
  const int tid = threadIdx.x;
  const int g = tid / L, lane = tid % L;
  const unsigned mask = group_mask<L>();
  const int i0 = blockIdx.x * p.tile_rows;
  const int nr = min(p.tile_rows, p.n_rows - i0);
  const int r0 = p.row0 + i0;
  const int T0 = t.row_item[r0], T1 = t.row_item[r0 + nr];
  const bool mine = tid < nr;
  int it0 = 0, it1 = 0, card = 0;
  if (mine) {
    it0 = t.row_item[r0 + tid];
    it1 = t.row_item[r0 + tid + 1];
    card = t.row_card[r0 + tid];
  }
  float pot[2] = {0.0f, 0.0f};
  for (int c0 = T0, c1; c0 < T1; c0 = c1) {
    c1 = min(T1, c0 + kChunk);
    int A0 = 0;
    if constexpr (kStaged) {
      A0 = item_arg0(t, c0);
      if (item_arg0(t, c1) - A0 > kArgChunk) {
        // the chunk ends at the last item whose arguments fit
        if (tid == 0) s_end = c0 + 1;
        __syncthreads();
        for (int c = c0 + 2 + tid; c <= c1; c += kItemThreads)
          if (item_arg0(t, c) - A0 <= kArgChunk) atomicMax(&s_end, c);
        __syncthreads();
        c1 = s_end;
      }
      const int na = item_arg0(t, c1) - A0;
#pragma unroll 4
      for (int a = tid; a < na; a += kItemThreads) {
        const int v = arg_ref(t, A0 + a);
        s_val[a] = v < 0 ? 0 : p.xr[v];
        s_own[a] = v < 0;
      }
      __syncthreads();
    }
    const int n = c1 - c0;
    for (int j = g; j < n; j += kGroups) {  // uniform across a group
      const int it = c0 + j;
      const int m = item_meta(t, it);
      const float w = p.weights[item_wid(t, it)];
      const bool dense = meta_dense(m);
      const int d1 = meta_d1(m), d2 = meta_d2(m);
      const bool ok0 = dense || d1 == 0 || d2 == 0;
      const bool ok1 = dense || d1 == 1 || d2 == 1;
      float e0 = 0.0f, e1 = 0.0f;
      if (ok0 || ok1) {
        const int ftype = meta_ftype(m);
        if constexpr (kStaged)
          eval_staged01(ftype, s_val, s_own, item_arg0(t, it) - A0,
                        item_arity(t, it), e0, e1);
        else
          eval_item01_group<L, FAST>(t, p.xr, ftype, item_arg0(t, it),
                                     item_arity(t, it), lane, mask, e0, e1);
      }
      if (lane == 0) {
        s_term[j] = make_float2(ok0 ? __fmul_rn(w, e0) : 0.0f,
                                ok1 ? __fmul_rn(w, e1) : 0.0f);
        s_dense[j] = dense;
      }
    }
    __syncthreads();
    if (mine) {
      const int hi = min(it1, c1) - c0;
      for (int j = max(it0, c0) - c0; j < hi; ++j) {
        const float2 e = s_term[j];
        const bool all = card >= 2 || !s_dense[j];
        if (all || card >= 1) pot[0] = __fadd_rn(pot[0], e.x);
        if (all) pot[1] = __fadd_rn(pot[1], e.y);
      }
    }
    __syncthreads();  // the next chunk reuses the shared memory
  }
  if (mine) finish_row<2>(t, p, i0 + tid, r0 + tid, card, pot);
}

template <int KMAX>
cudaError_t launch_cat(const Tables& t, const Step& p, cudaStream_t stream) {
  const int blocks = (p.n_rows + p.tile_rows - 1) / p.tile_rows;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(p.tile_rows) * cat_stride(p.kmax);
  sweep_cat_kernel<KMAX><<<blocks, kCatThreads, smem, stream>>>(t, p);
  return cudaGetLastError();
}

template <int L, bool FAST>
cudaError_t launch_items(const Tables& t, const Step& p,
                         cudaStream_t stream) {
  const int blocks = (p.n_rows + p.tile_rows - 1) / p.tile_rows;
  sweep_item_kernel<L, FAST><<<blocks, kItemThreads, 0, stream>>>(t, p);
  return cudaGetLastError();
}

template <bool FAST>
cudaError_t launch_items(const Tables& t, const Step& p, int lanes,
                         cudaStream_t stream) {
  switch (lanes) {
    case 1: return launch_items<1, FAST>(t, p, stream);
    case 2: return launch_items<2, FAST>(t, p, stream);
    case 4: return launch_items<4, FAST>(t, p, stream);
    case 8: return launch_items<8, FAST>(t, p, stream);
    case 16: return launch_items<16, FAST>(t, p, stream);
    case 32: return launch_items<32, FAST>(t, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// every item kernel, then the categorical kernels, as
// nsx_itemgrid_sweep_attrs numbers them
const void* const kKernels[] = {
    reinterpret_cast<const void*>(sweep_item_kernel<1, false>),
    reinterpret_cast<const void*>(sweep_item_kernel<2, false>),
    reinterpret_cast<const void*>(sweep_item_kernel<4, false>),
    reinterpret_cast<const void*>(sweep_item_kernel<8, false>),
    reinterpret_cast<const void*>(sweep_item_kernel<16, false>),
    reinterpret_cast<const void*>(sweep_item_kernel<32, false>),
    reinterpret_cast<const void*>(sweep_item_kernel<1, true>),
    reinterpret_cast<const void*>(sweep_item_kernel<2, true>),
    reinterpret_cast<const void*>(sweep_item_kernel<4, true>),
    reinterpret_cast<const void*>(sweep_item_kernel<8, true>),
    reinterpret_cast<const void*>(sweep_item_kernel<16, true>),
    reinterpret_cast<const void*>(sweep_item_kernel<32, true>),
    reinterpret_cast<const void*>(sweep_cat_kernel<8>),
    reinterpret_cast<const void*>(sweep_cat_kernel<32>),
    reinterpret_cast<const void*>(sweep_cat_kernel<128>)};

}  // namespace

// tile_rows: rows of a tile, at KMAX 2 1 to kItemThreads, above it 1 to
// kCatThreads with tile_rows x cat_stride(kmax) <= kCatPotFloats; lanes:
// threads per item at KMAX 2, a power of two to 32; fast: every item of
// the step is EQUAL, ISTRUE, AND or OR; the categorical kernels ignore
// lanes and fast
extern "C" int nsx_itemgrid_sweep_color(
    const int32_t* row_vid, const int32_t* row_card, const int32_t* row_upos,
    const int8_t* row_flags, const int32_t* row_item, const int32_t* it_arg,
    const int32_t* it_wid, const int32_t* it_meta, const int32_t* arg_vid,
    const int32_t* arg_ec, const float* weights, const int32_t* xr,
    int32_t* x, int32_t* counts, int32_t* send, const float* ext, int row0,
    int n_rows, int kmax, int map_kind, int draw_kind, int seed977,
    int salt16, int tally, int kext, int tile_rows, int lanes, int fast,
    void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  if (ext != nullptr && kext < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Tables t{row_vid, row_card, row_upos, row_flags, row_item,
                 it_arg,  it_wid,   it_meta,  arg_vid,   arg_ec};
  const Step p{weights, xr, x, counts, send, ext, row0, n_rows, kmax, map_kind,
               draw_kind, static_cast<uint32_t>(seed977),
               static_cast<uint32_t>(salt16), tally, kext, tile_rows};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (kmax <= 2) {
    if (tile_rows < 1 || tile_rows > kItemThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(fast ? launch_items<true>(t, p, lanes, s)
                                 : launch_items<false>(t, p, lanes, s));
  }
  if (kmax > 128 || tile_rows < 1 || tile_rows > kCatThreads ||
      tile_rows * cat_stride(kmax) > kCatPotFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kmax <= 8) return static_cast<int>(launch_cat<8>(t, p, s));
  if (kmax <= 32) return static_cast<int>(launch_cat<32>(t, p, s));
  if (kmax <= 128) return static_cast<int>(launch_cat<128>(t, p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// the registers a thread and the local memory a thread (spills and local
// arrays) of kernel `which` of kKernels (0-5: the item kernel at 1, 2, 4,
// 8, 16, 32 lanes an item; 6-11: the same, FAST; 12-14: the categorical
// kernel at KMAX 8, 32, 128), as the loaded module reports them
extern "C" int nsx_itemgrid_sweep_attrs(int which, int* regs,
                                        int* local_bytes) {
  constexpr int n = sizeof(kKernels) / sizeof(kKernels[0]);
  if (which < 0 || which >= n) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e = cudaFuncGetAttributes(&a, kKernels[which]);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
