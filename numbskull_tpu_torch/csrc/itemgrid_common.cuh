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
__device__ float finalize(int ftype, const ArgStats& s) {
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

// factor value of one item with the row's variable at candidate k
__device__ float eval_item(const Tables& t, const int32_t* x, int ftype,
                           int a0, int arity, int k) {
  ArgStats s;
  const int h = arity > 1 ? arity - 1 : 0;
  s.v0 = arg_value(t, x, a0, k);
  s.head = arg_value(t, x, a0 + h, k);
  s.head_eq = arg_eq(t, a0 + h);
  s.v1 = arity > 1 ? arg_value(t, x, a0 + 1, k) : 0;
  s.v2 = arity > 2 ? arg_value(t, x, a0 + 2, k) : 0;
  s.card0 = arg_card(t, a0);
  s.card1 = arity > 1 ? arg_card(t, a0 + 1) : s.card0;
  const int us = s.v0 - 1 < 0 ? 0 : (s.v0 - 1 > h ? h : s.v0 - 1);
  s.ufo_sel = arg_value(t, x, a0 + us, k);
  s.n_zero = s.n_one = s.n_diff0 = s.n_head_eq = s.n_body_zero = 0;
  s.n_neq_eq = s.n_eq_eq = s.n_body_neq_eq = 0;
  for (int a = 0; a < arity; ++a) {
    const int v = arg_value(t, x, a0 + a, k);
    const int e = arg_eq(t, a0 + a);
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

// candidate loops: unrolled (pot[] in registers) at small KMAX, rolled
// (pot[] in local memory) at high cardinality
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

}  // namespace
