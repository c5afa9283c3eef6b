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
// draw formulas _draw, _draw_vec and _draw2. Sums use __fadd_rn /
// __fmul_rn so the compiler cannot contract them into FMAs, and
// exponentials use expf (never __expf or fast math), the function
// torch.exp calls on the GPU.

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

enum : int { MAP_ROW = 0, MAP_TILE = 1 };
enum : int { DRAW_CDF = 0, DRAW_VEC = 1, DRAW_SIGMOID2 = 2 };
enum : int { ROW_UPDATE = 1, ROW_TALLY = 2 };

struct Tables {
  const int32_t* row_vid;
  const int32_t* row_card;
  const int32_t* row_upos;
  const int8_t* row_flags;
  const int32_t* row_item;   // (n_rows_total + 1) CSR offsets
  const int32_t* it_ftype;
  const int32_t* it_wid;
  const int32_t* it_arity;
  const int32_t* it_arg;     // first argument of the item
  const int8_t* it_dense;
  const int32_t* it_d1;
  const int32_t* it_d2;
  const int32_t* arg_vid;
  const int32_t* arg_eq;
  const int32_t* arg_card;
  const int8_t* arg_subst;
};

struct Step {
  const float* weights;
  int32_t* x;
  int32_t* counts;
  int row0, n_rows, kmax, map_kind, draw_kind;
  uint32_t seed977, salt16;
  int tally;
};

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

// value of argument `a` of an item whose arguments start at `a0`, with
// the row's own variable at candidate `k`
__device__ __forceinline__ int arg_value(const Tables& t, const int32_t* x,
                                         int a0, int a, int k) {
  return t.arg_subst[a0 + a] ? k : x[t.arg_vid[a0 + a]];
}

// factor value of one item with the row's variable at candidate k
__device__ float eval_item(const Tables& t, const int32_t* x, int ftype,
                           int a0, int arity, int k) {
  ArgStats s;
  const int h = arity > 1 ? arity - 1 : 0;
  s.v0 = arg_value(t, x, a0, 0, k);
  s.head = arg_value(t, x, a0, h, k);
  s.head_eq = t.arg_eq[a0 + h];
  s.v1 = arity > 1 ? arg_value(t, x, a0, 1, k) : 0;
  s.v2 = arity > 2 ? arg_value(t, x, a0, 2, k) : 0;
  s.card0 = t.arg_card[a0];
  s.card1 = arity > 1 ? t.arg_card[a0 + 1] : s.card0;
  const int us = s.v0 - 1 < 0 ? 0 : (s.v0 - 1 > h ? h : s.v0 - 1);
  s.ufo_sel = arg_value(t, x, a0, us, k);
  s.n_zero = s.n_one = s.n_diff0 = s.n_head_eq = s.n_body_zero = 0;
  s.n_neq_eq = s.n_eq_eq = s.n_body_neq_eq = 0;
  for (int a = 0; a < arity; ++a) {
    const int v = arg_value(t, x, a0, a, k);
    const int e = t.arg_eq[a0 + a];
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

// _uniform_sw's counter hash at the row's draw position
__device__ __forceinline__ float uniform01(const Step& p, int upos) {
  const uint32_t blk = static_cast<uint32_t>(upos) >> 10;
  const uint32_t pos = static_cast<uint32_t>(upos) & 1023u;
  const uint32_t i0 = p.map_kind == MAP_TILE ? pos >> 7 : 0u;
  const uint32_t i1 = p.map_kind == MAP_TILE ? pos & 127u : pos;
  const uint32_t salt = p.salt16 + blk;
  uint32_t h = (i0 * 0x9E3779B9u) ^ (i1 * 0x85EBCA6Bu) ^
               (p.seed977 * 0xC2B2AE35u) ^ (salt * 0x27D4EB2Fu);
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
        const float e = eval_item(t, p.x, ftype, a0, arity, k);
        pot[k] = __fadd_rn(pot[k], __fmul_rn(w, e));
      }
    });
  }

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
  int v = p.x[vid];
  if (flags & ROW_UPDATE) {
    v = nv;
    p.x[vid] = nv;
  }
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
    int32_t* x, int32_t* counts, int row0, int n_rows, int kmax, int map_kind,
    int draw_kind, int seed977, int salt16, int tally, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const Tables t{row_vid, row_card, row_upos, row_flags, row_item,
                 it_ftype, it_wid,  it_arity, it_arg,    it_dense,
                 it_d1,    it_d2,   arg_vid,  arg_eq,    arg_card,
                 arg_subst};
  const Step p{weights, x, counts, row0, n_rows, kmax, map_kind, draw_kind,
               static_cast<uint32_t>(seed977), static_cast<uint32_t>(salt16),
               tally};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (kmax <= 2) return static_cast<int>(launch<2>(t, p, s));
  if (kmax <= 8) return static_cast<int>(launch<8>(t, p, s));
  if (kmax <= 32) return static_cast<int>(launch<32>(t, p, s));
  if (kmax <= 128) return static_cast<int>(launch<128>(t, p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
