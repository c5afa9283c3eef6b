// Device code shared by the port's itemgrid kernels (itemgrid_sweep.cu,
// itemgrid_learn.cu): the packed tables and their accessors, the factor
// semantics, one item's evaluation, the counter hash of the TPU kernels'
// software PRNG, and the two draws that reproduce _draw and _draw_vec of
// numbskull_tpu/ops/itemgrid_pallas.py.
// Sums use __fadd_rn / __fmul_rn so the compiler cannot contract them
// into FMAs, and exponentials use expf (never __expf or fast math), the
// function torch.exp calls on the GPU.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

// factor function codes (numbskull_tpu_torch/types.py FACTORS)
enum : int {
  F_IMPLY_NATURAL = 0, F_OR = 1, F_AND = 2, F_EQUAL = 3, F_ISTRUE = 4,
  F_LINEAR = 7, F_RATIO = 8, F_LOGICAL = 9, F_AND_CAT = 12,
  F_IMPLY_MLN = 13, F_OR_CAT = 14, F_EQUAL_CAT_CONST = 15,
  F_IMPLY_NATURAL_CAT = 16, F_IMPLY_MLN_CAT = 17,
  F_DP_GEN_CLASS_PRIOR = 18, F_DP_GEN_LF_PRIOR = 19,
  F_DP_GEN_LF_PROPENSITY = 20, F_DP_GEN_LF_ACCURACY = 21,
  F_DP_GEN_LF_CLASS_PROPENSITY = 22, F_DP_GEN_DEP_FIXING = 23,
  F_DP_GEN_DEP_REINFORCING = 24, F_DP_GEN_DEP_EXCLUSIVE = 25,
  F_DP_GEN_DEP_SIMILAR = 26, F_UFO = 30,
};

// row_flags bits (ops/itemgrid.py ROW_*)
enum : int { ROW_UPDATE = 1, ROW_TALLY = 2, ROW_CLAMPED = 4,
             ROW_EVIDENCE = 8 };

// The packed tables of ops/itemgrid.build_tables: rows in five arrays;
// items in three int32 arrays (12 B an item: the CSR offset of the first
// argument, the weight, and one word of ftype, dense and the two slots);
// arguments in two (8 B: the variable, ~vid for the row's own, and one
// word of eq and card). The kernels read them only through the
// accessors below.
struct Tables {
  const int32_t* row_vid;
  const int32_t* row_card;
  const int32_t* row_upos;
  const int8_t* row_flags;
  const int32_t* row_item;   // (n_rows_total + 1) CSR offsets into items
  const int32_t* it_arg;     // (I + 1) CSR offsets into the arguments
  const int32_t* it_wid;
  const int32_t* it_meta;    // ftype + 1 | dense << 7 | d1 << 8 | d2 << 16
  const int32_t* arg_vid;    // variable read; ~vid: the row's own
  const int32_t* arg_ec;     // eq << 16 | card
};

// an item's first argument, its arity, its weight and its packed word
__device__ __forceinline__ int item_arg0(const Tables& t, int it) {
  return t.it_arg[it];
}
__device__ __forceinline__ int item_arity(const Tables& t, int it) {
  return t.it_arg[it + 1] - t.it_arg[it];
}
__device__ __forceinline__ int item_wid(const Tables& t, int it) {
  return t.it_wid[it];
}
__device__ __forceinline__ int item_meta(const Tables& t, int it) {
  return t.it_meta[it];
}
// the fields of a packed item word
__device__ __forceinline__ int meta_ftype(int m) { return (m & 31) - 1; }
__device__ __forceinline__ bool meta_dense(int m) { return (m >> 7) & 1; }
__device__ __forceinline__ int meta_d1(int m) { return (m >> 8) & 255; }
__device__ __forceinline__ int meta_d2(int m) { return (m >> 16) & 255; }
__device__ __forceinline__ int item_ftype(const Tables& t, int it) {
  return meta_ftype(item_meta(t, it));
}

// argument a: the variable it reads (negative: the row's own), its value
// with the row's variable at candidate k, its eq and its cardinality
__device__ __forceinline__ int arg_ref(const Tables& t, int a) {
  return t.arg_vid[a];
}
__device__ __forceinline__ int arg_value(const Tables& t, const int32_t* x,
                                         int a, int k) {
  const int v = arg_ref(t, a);
  return v < 0 ? k : x[v];
}
__device__ __forceinline__ int arg_eq(const Tables& t, int a) {
  return t.arg_ec[a] >> 16;
}
__device__ __forceinline__ int arg_card(const Tables& t, int a) {
  return t.arg_ec[a] & 0xFFFF;
}

struct ArgStats {
  int n_zero, n_one, n_diff0, n_head_eq, n_body_zero, n_neq_eq, n_eq_eq,
      n_body_neq_eq, head, head_eq, v0, v1, v2, card0, card1, ufo_sel;
};

// the semantics table of ops/factor_semantics.finalize
__device__ __forceinline__ float finalize(int ftype, const ArgStats& s) {
  switch (ftype) {
    case F_IMPLY_NATURAL:
      return s.n_zero > 0 ? 0.0f : (s.head != 0 ? 1.0f : -1.0f);
    case F_OR:
      return s.n_one > 0 ? 1.0f : -1.0f;
    case F_EQUAL:
      return s.n_diff0 > 0 ? -1.0f : 1.0f;
    case F_AND:
    case F_ISTRUE:
      return s.n_zero > 0 ? -1.0f : 1.0f;
    case F_LINEAR:
      return static_cast<float>(s.n_head_eq);
    case F_RATIO:
      return log1pf(static_cast<float>(s.n_head_eq));
    case F_LOGICAL:
      return s.n_head_eq > 0 ? 1.0f : 0.0f;
    case F_IMPLY_MLN:
      return s.n_body_zero > 0 ? 1.0f : (s.head != 0 ? 1.0f : 0.0f);
    case F_AND_CAT:
    case F_EQUAL_CAT_CONST:
      return s.n_neq_eq > 0 ? 0.0f : 1.0f;
    case F_OR_CAT:
      return s.n_eq_eq > 0 ? 1.0f : -1.0f;
    case F_IMPLY_NATURAL_CAT:
      return s.n_body_neq_eq > 0 ? 0.0f
                                 : (s.head == s.head_eq ? 1.0f : -1.0f);
    case F_IMPLY_MLN_CAT:
      return s.n_body_neq_eq > 0 ? 1.0f
                                 : (s.head == s.head_eq ? 1.0f : 0.0f);
    case F_DP_GEN_CLASS_PRIOR:
      return s.v0 == 1 ? 1.0f : -1.0f;
    case F_DP_GEN_LF_PRIOR:
      return s.v0 == 2 ? -1.0f : (s.v0 == 0 ? 0.0f : 1.0f);
    case F_DP_GEN_LF_PROPENSITY:
      return s.v0 == s.card0 - 1 ? 0.0f : 1.0f;
    case F_DP_GEN_LF_ACCURACY:
      return s.v1 == s.card1 - 1 ? 0.0f : (s.v0 == s.v1 ? 1.0f : -1.0f);
    case F_DP_GEN_LF_CLASS_PROPENSITY:
      return s.v1 == s.card1 - 1 ? 0.0f : (s.v0 == 1 ? 1.0f : -1.0f);
    case F_DP_GEN_DEP_FIXING:
    case F_DP_GEN_DEP_REINFORCING: {
      const int y = s.v0, l1 = s.v1, l2 = s.v2;
      if (l1 == s.card1 - 1) return l2 != 1 ? -1.0f : 0.0f;
      const bool hit =
          ftype == F_DP_GEN_DEP_FIXING
              ? ((l1 == 0 && l2 == 1 && y == 1) ||
                 (l1 == 1 && l2 == 0 && y == 0))
              : ((l1 == 0 && l2 == 0 && y == 0) ||
                 (l1 == 1 && l2 == 1 && y == 1));
      return hit ? 1.0f : 0.0f;
    }
    case F_DP_GEN_DEP_EXCLUSIVE: {
      const int ab = s.card0 - 1;
      return (s.v0 == ab || s.v1 == ab) ? 0.0f : -1.0f;
    }
    case F_DP_GEN_DEP_SIMILAR:
      return s.v0 == s.v1 ? 1.0f : 0.0f;
    case F_UFO:
      return s.v0 == 0 ? 0.0f : static_cast<float>(s.ufo_sel);
    default:  // NOOP and unknown codes (the planner rejects the latter)
      return 0.0f;
  }
}

// the codes whose finalize reads no count over the arguments (the
// data-programming codes and UFO: v0, v1, v2, the cards, ufo_sel), and
// those that read one fact of them (EQUAL, ISTRUE, AND, OR: fast_neg)
__device__ __forceinline__ bool reads_no_count(int ftype) {
  return ftype >= F_DP_GEN_CLASS_PRIOR;
}
__device__ __forceinline__ bool reads_one_fact(int ftype) {
  return ftype == F_EQUAL || ftype == F_ISTRUE || ftype == F_AND ||
         ftype == F_OR;
}

// the one fact of EQUAL, ISTRUE, AND and OR, from the arguments' values
// (val(a)): whether finalize's value is -1 (any unlike the first; any 0;
// no 1)
template <typename V>
__device__ __forceinline__ bool fast_neg(int ftype, int arity, V&& val) {
  const int v0 = val(0);
  const int want = ftype == F_EQUAL ? v0 : ftype == F_OR ? 1 : 0;
  bool any = false;
  for (int a = 0; a < arity; ++a) {
    const int v = val(a);
    any |= ftype == F_EQUAL ? v != want : v == want;
  }
  return ftype == F_OR ? !any : any;
}

// one item's factor value from accessors of its arguments: val(a) the
// value of argument a (the row's own at the candidate), ec(a) its packed
// eq << 16 | card; the integer statistics of the semantics table, then
// finalize (the codes that read no count, or one fact, skip the rest:
// the same value). Every evaluator below goes through it or eval_args2,
// so the semantics live in one place
template <typename V, typename E>
__device__ __forceinline__ float eval_args(int ftype, int arity, V&& val,
                                           E&& ec) {
  if (ftype < 0) return 0.0f;  // NOOP
  if (reads_one_fact(ftype))
    return fast_neg(ftype, arity, val) ? -1.0f : 1.0f;
  ArgStats s;
  const int h = arity > 1 ? arity - 1 : 0;
  s.v0 = val(0);
  s.head = val(h);
  s.head_eq = ec(h) >> 16;
  s.v1 = arity > 1 ? val(1) : 0;
  s.v2 = arity > 2 ? val(2) : 0;
  s.card0 = ec(0) & 0xFFFF;
  s.card1 = arity > 1 ? ec(1) & 0xFFFF : s.card0;
  const int us = s.v0 - 1 < 0 ? 0 : (s.v0 - 1 > h ? h : s.v0 - 1);
  s.ufo_sel = val(us);
  s.n_zero = s.n_one = s.n_diff0 = s.n_head_eq = s.n_body_zero = 0;
  s.n_neq_eq = s.n_eq_eq = s.n_body_neq_eq = 0;
  if (reads_no_count(ftype)) return finalize(ftype, s);
  for (int a = 0; a < arity; ++a) {
    const int v = val(a);
    const int e = ec(a) >> 16;
    s.n_zero += v == 0;
    s.n_one += v == 1;
    s.n_diff0 += v != s.v0;
    s.n_neq_eq += v != e;
    s.n_eq_eq += v == e;
    if (a < arity - 1) {
      s.n_head_eq += v == s.head;
      s.n_body_zero += v == 0;
      s.n_body_neq_eq += v != e;
    }
  }
  return finalize(ftype, s);
}

// eval_args for two value arrays at once (the free and the clamped
// chain): val2(a, va, vb) gives argument a in both, so an argument's
// tables are read once for the two; each result is eval_args's for its
// array (the same integer statistics, the same finalize)
template <typename V2, typename E>
__device__ __forceinline__ void eval_args2(int ftype, int arity, V2&& val2,
                                           E&& ec, float& ea, float& eb) {
  if (ftype < 0) {  // NOOP
    ea = eb = 0.0f;
    return;
  }
  if (reads_one_fact(ftype)) {
    int x, y;
    ea = fast_neg(ftype, arity, [&](int a) { val2(a, x, y); return x; })
             ? -1.0f : 1.0f;
    eb = fast_neg(ftype, arity, [&](int a) { val2(a, x, y); return y; })
             ? -1.0f : 1.0f;
    return;
  }
  ArgStats sa, sb;
  const int h = arity > 1 ? arity - 1 : 0;
  val2(0, sa.v0, sb.v0);
  val2(h, sa.head, sb.head);
  sa.head_eq = sb.head_eq = ec(h) >> 16;
  sa.v1 = sb.v1 = sa.v2 = sb.v2 = 0;
  if (arity > 1) val2(1, sa.v1, sb.v1);
  if (arity > 2) val2(2, sa.v2, sb.v2);
  sa.card0 = sb.card0 = ec(0) & 0xFFFF;
  sa.card1 = sb.card1 = arity > 1 ? ec(1) & 0xFFFF : sa.card0;
  const int ua = sa.v0 - 1 < 0 ? 0 : (sa.v0 - 1 > h ? h : sa.v0 - 1);
  const int ub = sb.v0 - 1 < 0 ? 0 : (sb.v0 - 1 > h ? h : sb.v0 - 1);
  int dummy;
  val2(ua, sa.ufo_sel, dummy);
  val2(ub, dummy, sb.ufo_sel);
  sa.n_zero = sa.n_one = sa.n_diff0 = sa.n_head_eq = sa.n_body_zero = 0;
  sa.n_neq_eq = sa.n_eq_eq = sa.n_body_neq_eq = 0;
  sb.n_zero = sb.n_one = sb.n_diff0 = sb.n_head_eq = sb.n_body_zero = 0;
  sb.n_neq_eq = sb.n_eq_eq = sb.n_body_neq_eq = 0;
  if (reads_no_count(ftype)) {
    ea = finalize(ftype, sa);
    eb = finalize(ftype, sb);
    return;
  }
  for (int a = 0; a < arity; ++a) {
    int va, vb;
    val2(a, va, vb);
    const int e = ec(a) >> 16;
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

// factor value of one item with the row's variable at candidate k, its
// arguments read from the tables
__device__ __forceinline__ float eval_item(const Tables& t, const int32_t* x,
                                           int ftype, int a0, int arity,
                                           int k) {
  return eval_args(
      ftype, arity, [&](int a) { return arg_value(t, x, a0 + a, k); },
      [&](int a) { return t.arg_ec[a0 + a]; });
}

// _uniform_sw's counter hash of (seed, salt) at position (i0, i1)
__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t salt,
                                              uint32_t i0, uint32_t i1) {
  uint32_t h = (i0 * 0x9E3779B9u) ^ (i1 * 0x85EBCA6Bu) ^
               (seed * 0xC2B2AE35u) ^ (salt * 0x27D4EB2Fu);
  h = (h ^ (h >> 15)) * 0x2C1B3C6Du;
  h = (h ^ (h >> 12)) * 0x297A2D39u;
  h = h ^ (h >> 15);
  return __fmul_rn(static_cast<float>(static_cast<int>(h >> 8)),
                   1.0f / 16777216.0f);
}

// candidate loops: unrolled at small KMAX, rolled at high cardinality
template <int KMAX, typename F>
__device__ __forceinline__ void for_k(F&& f) {
  if constexpr (KMAX <= 8) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) f(k);
  } else {
#pragma unroll 1
    for (int k = 0; k < KMAX; ++k) f(k);
  }
}

// external potentials (the has_ext forms of the TPU kernels): row vid's
// entries of a (V, kext) float32 table, added to the first min(K, kext)
// candidates after the row's items and before the draw; a null table adds
// nothing
template <int KMAX>
__device__ __forceinline__ void add_ext(float* pot, const float* ext, int vid,
                                        int K, int kext) {
  if (ext == nullptr) return;
  const float* e = ext + static_cast<int64_t>(vid) * kext;
  const int ke = K < kext ? K : kext;
  for_k<KMAX>([&](int k) {
    if (k < ke) pot[k] = __fadd_rn(pot[k], e[k]);
  });
}

// _draw: masked max, sequential exp sum, sequential cumulative count
template <int KMAX>
__device__ int draw_cdf(float* pot, int card, int K, float u01) {
  float m = pot[0];
  for_k<KMAX>([&](int k) {
    if (k >= 1 && k < K && k < card && pot[k] > m) m = pot[k];
  });
  float total = 0.0f;
  for_k<KMAX>([&](int k) {
    if (k < K) {
      pot[k] = k < card ? expf(__fsub_rn(pot[k], m)) : 0.0f;
      total = k == 0 ? pot[0] : __fadd_rn(total, pot[k]);
    }
  });
  const float u = __fmul_rn(u01, total);
  float csum = 0.0f;
  int val = 0;
  for_k<KMAX>([&](int k) {
    if (k < K) {
      csum = __fadd_rn(csum, pot[k]);
      val += csum < u;
    }
  });
  return val < card - 1 ? val : card - 1;
}

// _draw_vec: masked max, then a Hillis-Steele inclusive prefix sum over
// the global kmax width K (the add tree depends on K, not on card)
template <int KMAX>
__device__ int draw_vec(float* pot, int card, int K, float u01) {
  float m = -CUDART_INF_F;
  for_k<KMAX>([&](int k) {
    if (k < K && k < card) m = fmaxf(m, pot[k]);
  });
  for_k<KMAX>([&](int k) {
    if (k < K) pot[k] = k < card ? expf(__fsub_rn(pot[k], m)) : 0.0f;
  });
  if constexpr (KMAX <= 8) {
#pragma unroll
    for (int s = 1; s < KMAX; s *= 2) {
#pragma unroll
      for (int k = KMAX - 1; k >= s; --k)
        if (s < K && k < K) pot[k] = __fadd_rn(pot[k], pot[k - s]);
    }
  } else {
    for (int s = 1; s < K; s *= 2)
      for (int k = K - 1; k >= s; --k) pot[k] = __fadd_rn(pot[k], pot[k - s]);
  }
  const float u = __fmul_rn(u01, pot[K - 1]);
  int val = 0;
  for_k<KMAX>([&](int k) {
    if (k < K) val += pot[k] < u;
  });
  return val < card - 1 ? val : card - 1;
}

// ---- the categorical tile (KMAX 8, 32 and 128): items in parallel ------
//
// A warp takes a run of at most 32 consecutive rows of one step, whose
// items are consecutive in the tables, and cat_potentials walks them in
// chunks of at most 32 items, kCatArgs argument values and kCatTerms
// terms (an item of more arguments than kCatArgs is a chunk of its own
// and is not staged). (1) Lane j reads item j's record and weight
// (neighbouring lanes on neighbouring items: coalesced), finds its row,
// and counts its terms: a dense item one for each candidate below its
// row's card (and K), a sparse item one for each of d1 and d2 below K; a
// warp scan of those counts places the terms. (2) The chunk's argument
// values are read once, side by side, into shared memory, the row's own
// argument marked -1 (cat_stage). (3) The lanes take the chunk's items
// in groups (one lane an item when the chunk holds 32, 8 lanes an item
// when it holds 4, as at cardinality 128), a group's lanes its
// candidates, each evaluated from the staged values (eval_args, the one
// semantics, which reads only what the item's code needs) and stored as
// w x e. (4) Lane q adds, for
// one (row, candidate) of the rows the chunk touches, that row's terms
// of the chunk in item order into the potential in shared memory. Chunk
// after chunk, each potential is summed in item order from +0.0 over
// exactly the items the dense / d1 / d2 rule keeps, as the plain version
// sums it, so the potentials are the same bits for any tile or chunk.
// The warp needs no other warp: only __syncwarp orders its phases, so
// the warps of a block run their chunks independently, each hiding the
// others' loads. NC = 2 does it for two value arrays (the free and the
// clamped chain of learning) from one read; KEEP (learning's kept form)
// keeps a run's evaluations at every candidate for the gradient: there
// (3) stores e itself and (4) forms w x e (the same bits).
constexpr int kCatWarps = 4;        // warps of a block
constexpr int kCatThreads = 32 * kCatWarps;
constexpr int kCatArgs = 128;       // argument values a chunk stages
constexpr int kCatTerms = 512;      // terms a chunk holds, per chain
constexpr int kCatPotFloats = 4224; // potentials a block holds, per chain

// a row's potentials in shared memory: K floats at an odd stride, so
// that one lane per row reads them without bank conflicts
__host__ __device__ constexpr int cat_stride(int K) { return K | 1; }

// a warp's shared memory; TERMS (at least kCatTerms) terms a chain
template <int NC, int TERMS = kCatTerms>
struct CatWarp {
  int ri[33];               // its rows' first items, from its first row's
  int card[32];             // the rows' cardinalities
  int meta[32];             // the chunk's items: packed word,
  float w[32];              //   weight,
  int a0[32];               //   first argument (in the tables),
  int arity[32];            //   arity,
  int tend[32];             //   terms up to and with it,
  int row[32];              //   row
  int val[NC][kCatArgs];    // staged argument values; -1: the row's own
  int ec[kCatArgs];         // their eq << 16 | card
  float term[NC][TERMS];
};

// inclusive prefix sums of (x, y) over the warp's lanes in order
__device__ __forceinline__ int2 warp_scan2(int2 v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, v.x, o);
    const int y = __shfl_up_sync(0xffffffffu, v.y, o);
    if (lane >= o) {
      v.x += x;
      v.y += y;
    }
  }
  return v;
}

// the last of rows [0, nr) whose first item (ri) is at most j: the row
// that holds item j
__device__ __forceinline__ int row_of(const int* ri, int nr, int j) {
  int lo = 0, hi = nr - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ri[mid] <= j) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// the candidate of a sparse item's term s: d1 first where it is below K
__device__ __forceinline__ int sparse_k(int m, int s, int K) {
  return s == 0 && meta_d1(m) < K ? meta_d1(m) : meta_d2(m);
}

// (2): arguments [A0, A0 + na) of the tables, side by side into
// sh.val (-1 for the row's own) and sh.ec; then __syncwarp
template <int NC, int TERMS>
__device__ __forceinline__ void cat_stage(const Tables& t, const int32_t* xa,
                                          const int32_t* xb, int A0, int na,
                                          CatWarp<NC, TERMS>& sh) {
  for (int a = threadIdx.x & 31; a < na; a += 32) {
    const int v = arg_ref(t, A0 + a);
    sh.val[0][a] = v < 0 ? -1 : xa[v];
    if constexpr (NC == 2) sh.val[1][a] = v < 0 ? -1 : xb[v];
    sh.ec[a] = t.arg_ec[A0 + a];
  }
  __syncwarp();
}

// item j of a chunk at candidates ka (values of chain a) and kb (chain
// b, NC = 2), from its staged values (or, not staged, from the tables at
// A0): the factor values (ea, eb)
template <int NC, int TERMS>
__device__ __forceinline__ void cat_eval(const Tables& t, const int32_t* xa,
                                         const int32_t* xb,
                                         const CatWarp<NC, TERMS>& sh,
                                         bool staged,
                                         int A0, int j, int ka, int kb,
                                         float& ea, float& eb) {
  const int ftype = meta_ftype(sh.meta[j]), ar = sh.arity[j];
  const int o = sh.a0[j] - A0;
  if (staged) {
    auto ec = [&](int a) { return sh.ec[o + a]; };
    if constexpr (NC == 1) {
      ea = eval_args(
          ftype, ar,
          [&](int a) {
            const int v = sh.val[0][o + a];
            return v < 0 ? ka : v;
          },
          ec);
    } else {
      eval_args2(
          ftype, ar,
          [&](int a, int& x, int& y) {
            x = sh.val[0][o + a];
            y = sh.val[NC - 1][o + a];
            if (x < 0) x = ka;
            if (y < 0) y = kb;
          },
          ec, ea, eb);
    }
  } else {  // more than kCatArgs arguments: from the tables
    auto ec = [&](int a) { return t.arg_ec[A0 + a]; };
    if constexpr (NC == 1) {
      ea = eval_args(ftype, ar,
                     [&](int a) { return arg_value(t, xa, A0 + a, ka); }, ec);
    } else {
      eval_args2(
          ftype, ar,
          [&](int a, int& x, int& y) {
            x = arg_value(t, xa, A0 + a, ka);
            y = arg_value(t, xb, A0 + a, kb);
          },
          ec, ea, eb);
    }
  }
}

// The potentials of rows [r0, r0 + nr) (nr <= 32) at every candidate
// k < K, from values xa (and xb, NC = 2), added into
// pa[row * cat_stride(K) + k] (and pb), which the caller has zeroed (and
// ordered by __syncwarp). Every lane of the warp calls it; it returns
// after __syncwarp with sh.ri and sh.card holding the rows' first items
// (from the first row's) and cardinalities. KEEP (NC = 2): the chunks'
// terms follow one another in sh.term from index term0 on, so that the
// run's items' evaluations at every candidate they were evaluated at
// stay there for the caller, item after item in term order (the caller
// sees that they fit TERMS), and item j of the run leaves its row
// (bits 0-4), its first term (5-14) and its d1 (15-22) and d2 (23-30) in
// info[j] and its dense (bit 0) and NOOP (bit 1) bits in flags[j].
template <int NC, bool KEEP = false, int TERMS>
__device__ void cat_potentials(const Tables& t, const float* weights,
                               const int32_t* xa, const int32_t* xb, int r0,
                               int nr, int K, float* pa, float* pb,
                               CatWarp<NC, TERMS>& sh, int term0 = 0,
                               uint32_t* info = nullptr,
                               uint8_t* flags = nullptr) {
  static_assert(NC == 2 || !KEEP, "only learning keeps its evaluations");
  const int lane = threadIdx.x & 31;
  const int S = cat_stride(K);
  const int T0 = t.row_item[r0];
  [[maybe_unused]] int tb = term0;  // KEEP: the chunk's first term
  for (int i = lane; i <= nr; i += 32) sh.ri[i] = t.row_item[r0 + i] - T0;
  if (lane < nr) sh.card[lane] = t.row_card[r0 + lane];
  __syncwarp();
  const int n_items = sh.ri[nr];
  for (int c0 = 0; c0 < n_items;) {
    // (1) the items' records, their terms placed by a scan; the chunk
    // ends where the terms or the staged arguments would overflow
    const int it = T0 + c0 + lane;
    const bool live = c0 + lane < n_items;
    int m = 0, a0 = 0, arity = 0, nt = 0, row = 0;
    float w = 0.0f;
    if (live) {
      m = item_meta(t, it);
      a0 = item_arg0(t, it);
      arity = item_arity(t, it);
      w = weights[item_wid(t, it)];
      row = row_of(sh.ri, nr, c0 + lane);
      if (meta_dense(m)) {
        nt = min(sh.card[row], K);
      } else {
        const int d1 = meta_d1(m), d2 = meta_d2(m);
        nt = (d1 < K) + (d2 < K && d2 != d1);
      }
    }
    const int2 pre = warp_scan2(make_int2(nt, min(arity, kCatArgs + 1)));
    const int nf = __popc(__ballot_sync(
        0xffffffffu, live && pre.x <= kCatTerms && pre.y <= kCatArgs));
    const int n = nf > 0 ? nf : 1;
    if (lane < n) {
      sh.meta[lane] = m;
      sh.w[lane] = w;
      sh.a0[lane] = a0;
      sh.arity[lane] = arity;
      sh.tend[lane] = pre.x;
      sh.row[lane] = row;
    }
    if constexpr (KEEP) {
      if (lane < n) {
        info[c0 + lane] = static_cast<uint32_t>(row) |
                          static_cast<uint32_t>(tb + pre.x - nt) << 5 |
                          static_cast<uint32_t>(m & 0xFFFF00) << 7;
        flags[c0 + lane] = static_cast<uint8_t>(meta_dense(m) |
                                                (meta_ftype(m) < 0) << 1);
      }
    }
    __syncwarp();
    // (2) the chunk's argument values, side by side
    const bool staged = nf > 0;
    const int A0 = sh.a0[0];
    if (staged)
      cat_stage<NC>(t, xa, xb, A0, sh.a0[n - 1] + sh.arity[n - 1] - A0, sh);
    // (3) every term: the lanes in groups of L, the most that give each
    // of the chunk's n items a group, a group's lanes its candidates
    const int L = 32 >> (n > 1 ? 32 - __clz(n - 1) : 0);
    if (const int j = lane / L; j < n) {
      const int mj = sh.meta[j];
      const int t0 = j ? sh.tend[j - 1] : 0, nt_j = sh.tend[j] - t0;
      [[maybe_unused]] const float wj = sh.w[j];  // not KEEP
      for (int s = lane % L; s < nt_j; s += L) {
        const int k = meta_dense(mj) ? s : sparse_k(mj, s, K);
        float ea, eb;
        cat_eval<NC>(t, xa, xb, sh, staged, A0, j, k, k, ea, eb);
        if constexpr (KEEP) {
          sh.term[0][tb + t0 + s] = ea;
          sh.term[1][tb + t0 + s] = eb;
        } else {
          sh.term[0][t0 + s] = __fmul_rn(wj, ea);
          if constexpr (NC == 2) sh.term[1][t0 + s] = __fmul_rn(wj, eb);
        }
      }
    }
    __syncwarp();
    // (4) each (row, candidate) the chunk touches adds its terms in order
    const int ra = sh.row[0];
    const int pairs = (sh.row[n - 1] - ra + 1) * K;
    for (int q = lane; q < pairs; q += 32) {
      const int r = ra + q / K, k = q % K;
      const int lo = max(sh.ri[r], c0) - c0;
      const int hi = min(sh.ri[r + 1], c0 + n) - c0;
      float acc[NC];
      acc[0] = pa[r * S + k];
      if constexpr (NC == 2) acc[1] = pb[r * S + k];
      for (int j = lo; j < hi; ++j) {
        const int mj = sh.meta[j];
        const int t0 = j ? sh.tend[j - 1] : 0;
        int idx = -1;
        if (meta_dense(mj)) {
          if (k < sh.tend[j] - t0) idx = k;
        } else if (k == meta_d1(mj)) {
          idx = 0;
        } else if (k == meta_d2(mj)) {
          idx = meta_d1(mj) < K ? 1 : 0;
        }
        if (idx >= 0) {
          if constexpr (KEEP) {
            const float wj = sh.w[j];
            const int ti = tb + t0 + idx;
            acc[0] = __fadd_rn(acc[0], __fmul_rn(wj, sh.term[0][ti]));
            acc[1] = __fadd_rn(acc[1], __fmul_rn(wj, sh.term[1][ti]));
          } else {
            acc[0] = __fadd_rn(acc[0], sh.term[0][t0 + idx]);
            if constexpr (NC == 2)
              acc[1] = __fadd_rn(acc[1], sh.term[1][t0 + idx]);
          }
        }
      }
      pa[r * S + k] = acc[0];
      if constexpr (NC == 2) pb[r * S + k] = acc[1];
    }
    if constexpr (KEEP) tb += sh.tend[n - 1];
    __syncwarp();  // the next chunk reuses the chunk's shared memory
    c0 += n;
  }
}

// a block's rows [0, nr) cut into kCatWarps runs: warp w's first row
// and rows
__device__ __forceinline__ void warp_rows(int nr, int& first, int& rows) {
  const int per = (nr + kCatWarps - 1) / kCatWarps;
  first = min(nr, static_cast<int>(threadIdx.x >> 5) * per);
  rows = min(per, nr - first);
}

}  // namespace
