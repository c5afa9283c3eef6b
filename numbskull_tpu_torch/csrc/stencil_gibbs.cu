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
// The draw: the TPU kernel draws with the TPU's hardware PRNG, which no
// other device reproduces; the port draws with the counter hash the
// itemgrid kernels use (hash_uniform, itemgrid_common.cuh) on the same
// 24-bit grid, u = (bits >> 8) * 2^-24, with seed int32(seed * 977), salt
// 2 * sweep + half (burn-in sweeps counted, the sweep's index in the
// call, not in a launch) and position (row, col). dpot is one fma, as
// XLA's CPU backend contracts 2w (2s - deg) + 2b; the draw is
// new = [u * (1 + expf(-dpot)) < 1], so that
// ops/stencil_kernel.grid_gibbs_reference computes the same bits with
// torch.exp.
//
// How: one launch runs a chunk of k consecutive sweeps (2k half-steps)
// over the whole lattice, cut into tiles of TR x TC cells. A block loads
// its tile plus a halo into shared memory (one byte a cell; cells beyond
// the lattice hold 0 and are never updated): 2k rows above, at least 2k
// below (the window's rows are rounded up to whole thread strips), and
// 2k rounded up to a thread's columns on the left and right, with a
// ghost ring of one row and one 8-cell word that is read, never updated. It
// runs the 2k half-steps there in place with a barrier between them, and
// writes back its tile only.
// - The halo's cells are updated redundantly. A wrong value at the
//   window's rim moves at most one cell inward per half-step, so after
//   2k half-steps the tile is exact; and a draw is a function of (seed,
//   salt, row, col) alone, so two blocks draw a shared halo cell alike.
//   Any tile, k and halo of at least 2k give the same bits.
// - A cell's degree comes from its global position: only the lattice's
//   edges lack neighbours, and there the neighbour reads the 0 of a cell
//   beyond the lattice.
// - One thread per updated cell, four to a word: thread (tx, ty) owns KW
//   8-cell words (KW = 1 or 2, from the plan) of RPT consecutive window
//   rows. Down a strip it keeps the rows above, at and below in
//   registers (one shared load a word and row), adds the four neighbours
//   of 8 cells as bytes of one 64-bit word, and draws the 4 cells of the
//   half-step's parity, 4 KW independent hash chains. Two words a thread
//   share a row's overhead (bounds, row hash factor, edge loads, tally)
//   over 8 draws but halve a block's threads: the plan takes them where
//   blocks are large.
// - The draw costs no exp per cell: 2s - deg takes 9 values, and for
//   each, u * (1 + expf(-dpot)) < 1 holds exactly for the bits
//   q = bits >> 8 below a threshold T (a float product rounds
//   monotonically in u), which the block finds by bisection over the
//   2^24 values of q with the same expf, fmul and compare. The draw is
//   q < T[2s - deg + 4].
// - The tally stays on chip: after each tallied sweep (sweep >= burn) a
//   thread adds its tile words to a byte count per tile cell in shared
//   memory (k <= 127). At the end the block stores its tile's counts to
//   the int32 counts in the chunk that holds sweep `burn`, adds them in
//   later chunks, and leaves them alone in burn-in chunks.
// - Between launches the lattice is one byte a cell in two ping-pong
//   buffers (a block reads its neighbours' tiles as halo while they are
//   being written, so a launch never writes what it reads). The first
//   launch reads the int32 x, the last writes the int32 result: the
//   kernel is templated on its input and output types, so there is no
//   pack or unpack pass. The byte state holds only 0 and 1, so the
//   wrapper refuses an x with another value.
//
// What was tried (one H100 80GB HBM3 at 700 W, chip_smoke.py's lattice
// mode and experiments/lattice_tiles.py; PERF.md has the tables):
// - one thread per cell pair over a byte window, one cell a loop
//   iteration with five shared loads, the tally in the cell's byte:
//   7.6 us a sweep at 1024 x 1024, 0.32 ms at 8192 x 8192;
// - word strips as here, the window loaded and stored a byte at a time:
//   5.0 us and 0.18 ms. Builds with the sweeps, the hash or the lookup
//   taken out showed the byte-wise load and store, latency-bound, as the
//   largest piece after the hash;
// - the load and store a word at a time (one 8-byte access of a u8 row,
//   two 16-byte of an int32 row, where rows are 8-aligned), and the sums
//   on 32-bit halves with a byte permute for each cell's threshold
//   offset: 4.0 us, 10.1 us at 2048 x 2048, 0.159 ms (the parent's two
//   launches a sweep: 13.1 us, 43.4 us, 0.83 ms);
// - two words a thread: 0.137 ms at 8192 x 8192 on 128 x 256 tiles, but
//   4.3 us at 1024 x 1024 (fewer warps a block), so the plan keeps one
//   word below 16 M cells.
// It stays at 2.4x the integer bound at 8192 x 8192: the row loop's
// overhead (shifts, byte picks, the threshold loads, the word's
// assembly) costs about as much as the hash. The window's load is not
// overlapped with the sweeps by cp.async or TMA: the blocks resident
// beside a loading block keep the SM busy, and a register cap for two
// blocks an SM moved nothing.
//
// The wrapper's plan (ops/stencil_kernel.lattice_plan) picks TR, TC, k
// and RPT from the lattice's shape and the call's sweep count; a call of
// S sweeps is ceil(S / k) launches. What bounds it on the H100: the
// integer arithmetic, about 14 operations per updated cell and sweep
// (the hash 9, the neighbour sum 3, the compare and the tally), at 64
// int32 lanes per SM and clock, about 56 us a sweep at 8192 x 8192; a
// call's bytes (x in, x out, counts out: 12 B a cell) are spread over
// its sweeps. The halo adds (TR + 4k)(TC + 4k) / (TR TC) - 1 of
// redundant updates or more (0.27 at 256 x 256 and k = 8).

#include "itemgrid_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kLevels = 9;           // 2s - deg in [-4, 4]
constexpr int kThresholdBytes = 64;  // the thresholds, before the window
constexpr int kMaxK = 127;           // byte tallies
constexpr size_t kMaxSmem = 232448;
constexpr uint64_t kOnes = 0x0101010101010101ull;

// one launch: sweeps [s0, s1) of the call, count_mode 0 (no tallied
// sweep), 1 (store: the chunk holds sweep `burn`) or 2 (add)
struct Chunk {
  int n, m;
  int tr, tc, tiles_x;
  int top, left;                    // halo rows above, cells to the left
  int rpt, wpr;                     // rows a thread, words a window row
  int wr;                           // window rows: blockDim.y * rpt
  float two_w, two_b;
  uint32_t seed977;
  int s0, s1, burn, count_mode;
};

__device__ __forceinline__ uint32_t mix_hash(uint32_t h) {
  h = (h ^ (h >> 15)) * 0x2C1B3C6Du;
  h = (h ^ (h >> 12)) * 0x297A2D39u;
  return h ^ (h >> 15);
}

// 8 cells of a row as the bytes of a word, from 8-aligned memory
__device__ __forceinline__ uint32_t pack4(int4 a) {
  return static_cast<uint32_t>(a.x | (a.y << 8) | (a.z << 16) | (a.w << 24));
}
__device__ __forceinline__ int4 unpack4(uint32_t w) {
  return make_int4(w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF, w >> 24);
}
__device__ __forceinline__ uint64_t load_word(const uint8_t* p) {
  return __ldg(reinterpret_cast<const unsigned long long*>(p));
}
__device__ __forceinline__ uint64_t load_word(const int32_t* p) {
  const int4* q = reinterpret_cast<const int4*>(p);
  return pack4(__ldg(q)) | static_cast<uint64_t>(pack4(__ldg(q + 1))) << 32;
}
__device__ __forceinline__ void store_word(uint8_t* p, uint64_t w) {
  *reinterpret_cast<unsigned long long*>(p) = w;
}
__device__ __forceinline__ void store_word(int32_t* p, uint64_t w) {
  int4* q = reinterpret_cast<int4*>(p);
  q[0] = unpack4(static_cast<uint32_t>(w));
  q[1] = unpack4(static_cast<uint32_t>(w >> 32));
}
__device__ __forceinline__ void add_word(int32_t* p, uint64_t w) {
  int4* q = reinterpret_cast<int4*>(p);
  for (int h = 0; h < 2; ++h) {
    const int4 a = q[h], b = unpack4(static_cast<uint32_t>(w >> (32 * h)));
    q[h] = make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
}

// One row's word after a half-step: the cells p = SEL, SEL + 2, ... of
// the word `cur` (those of the half-step's parity) redrawn where `live`.
// The bytes of a word never carry into each other, so each 32-bit half
// is summed on its own. Bytes of s: each cell's neighbour sum; of off:
// 4 (2s + 4 - deg), the byte offset of the cell's threshold in thr.
template <int SEL>
__device__ __forceinline__ uint64_t draw_word(
    uint64_t up, uint64_t cur, uint64_t down, uint32_t left,
    uint32_t right, uint64_t edges4, uint32_t rk, uint32_t cfw,
    const uint8_t* thr, uint64_t live) {
  const uint32_t c_lo = static_cast<uint32_t>(cur);
  const uint32_t c_hi = static_cast<uint32_t>(cur >> 32);
  const uint32_t s_lo = static_cast<uint32_t>(up) +
                        static_cast<uint32_t>(down) + ((c_lo << 8) | left) +
                        __funnelshift_r(c_lo, c_hi, 8);
  const uint32_t s_hi = static_cast<uint32_t>(up >> 32) +
                        static_cast<uint32_t>(down >> 32) +
                        __funnelshift_l(c_lo, c_hi, 8) +
                        ((c_hi >> 8) | (right << 24));
  const uint32_t off[2] = {(s_lo << 3) + static_cast<uint32_t>(edges4),
                           (s_hi << 3) + static_cast<uint32_t>(edges4 >> 32)};
  uint32_t v[2] = {0, 0};
#pragma unroll
  for (int p = SEL; p < 8; p += 2) {
    const uint32_t o = __byte_perm(off[p >> 2], 0, 0x4440 | (p & 3));
    const uint32_t t = *reinterpret_cast<const uint32_t*>(thr + o);
    const uint32_t h = mix_hash(rk ^ (cfw + p * 0x85EBCA6Bu));
    if ((h >> 8) < t) v[p >> 2] |= 1u << (8 * (p & 3));
  }
  const uint64_t upd =
      (SEL ? 0xFF00FF00FF00FF00ull : 0x00FF00FF00FF00FFull) & live;
  const uint64_t vw = v[0] | static_cast<uint64_t>(v[1]) << 32;
  return (cur & ~upd) | (vw & upd);
}

template <typename TIn, typename TOut, int KW>
__global__ void __launch_bounds__(kMaxThreads)
    lattice_chunk_kernel(const TIn* __restrict__ src, TOut* __restrict__ dst,
                         int32_t* __restrict__ count, const Chunk c) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* thr = reinterpret_cast<uint32_t*>(smem);  // at offset 0
  uint8_t* win = smem + kThresholdBytes;
  const int sw = c.wpr + 2;         // words a window row, ghosts included
  uint64_t* w64 = reinterpret_cast<uint64_t*>(win);
  uint64_t* cnt64 = w64 + (c.wr + 2) * sw;   // the tile's byte tallies
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int tile_y = blockIdx.x / c.tiles_x;
  const int tile_x = blockIdx.x - tile_y * c.tiles_x;
  const int r0 = tile_y * c.tr - c.top;    // global row of window row 0
  const int c0 = tile_x * c.tc - c.left;   // global col of window col 0

  if (tid < kLevels) {              // the draw's threshold per level
    const float dpot =
        __fmaf_rn(c.two_w, static_cast<float>(tid - 4), c.two_b);
    const float opz = __fadd_rn(1.0f, expf(-dpot));
    uint32_t lo = 0, hi = 1u << 24;
    while (lo < hi) {
      const uint32_t mid = (lo + hi) >> 1;
      const float u = __fmul_rn(static_cast<float>(static_cast<int>(mid)),
                                1.0f / 16777216.0f);
      if (__fmul_rn(u, opz) < 1.0f)
        lo = mid + 1;
      else
        hi = mid;
    }
    thr[tid] = lo;
  }
  // the window and its ghost ring, a word at a time: smem row sr is
  // global row r0 - 1 + sr, smem word w of a row holds global cols
  // c0 - 8 + 8 w ..; whole words of a lattice whose rows are 8-aligned
  // in one access, the rest cell by cell
  const bool aligned = (c.m & 7) == 0;
#pragma unroll 4
  for (int i = tid; i < (c.wr + 2) * sw; i += nthreads) {
    const int sr = i / sw;
    const int gr = r0 - 1 + sr, gc = c0 - 8 + 8 * (i - sr * sw);
    uint64_t word = 0;
    if (gr >= 0 && gr < c.n) {
      const TIn* row = src + static_cast<int64_t>(gr) * c.m;
      if (aligned && gc >= 0 && gc + 8 <= c.m) {
        word = load_word(row + gc);
      } else {
        for (int b = 0; b < 8; ++b)
          if (gc + b >= 0 && gc + b < c.m)
            word |= static_cast<uint64_t>(row[gc + b] & 1) << (8 * b);
      }
    }
    w64[i] = word;
  }
  const int cnt_words = c.tr * (c.tc / 8);
  if (c.count_mode != 0)
    for (int i = tid; i < cnt_words; i += nthreads) cnt64[i] = 0;

  // this thread's KW words (8 KW cells) of each row of its strip:
  // window words wx .. wx + KW - 1, global cols gc0 ..
  const int wx = KW * threadIdx.x;
  const int gc0 = c0 + 8 * wx;
  uint64_t live[KW], col_edges4[KW];
#pragma unroll
  for (int w = 0; w < KW; ++w) {
    live[w] = col_edges4[w] = 0;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int gc = gc0 + 8 * w + p;
      if (gc >= 0 && gc < c.m) {
        live[w] |= 0xFFull << (8 * p);
        col_edges4[w] |=
            static_cast<uint64_t>(4 * ((gc == 0) + (gc == c.m - 1)))
            << (8 * p);
      }
    }
  }
  const uint32_t cf0 = static_cast<uint32_t>(gc0) * 0x85EBCA6Bu;
  const int cnt_col = wx - c.left / 8;     // tile word, if in [0, tc / 8)
  const bool in_tile_cols = cnt_col >= 0 && cnt_col < c.tc / 8;
  const uint32_t seed_f = c.seed977 * 0xC2B2AE35u;
  const int sr0 = threadIdx.y * c.rpt + 1;  // first smem row of the strip
  __syncthreads();

  for (int sweep = c.s0; sweep < c.s1; ++sweep) {
    for (int half = 0; half < 2; ++half) {
      const uint32_t salt = 2u * static_cast<uint32_t>(sweep) + half;
      const uint32_t sk = seed_f ^ (salt * 0x27D4EB2Fu);
      const bool tally = half == 1 && sweep >= c.burn && in_tile_cols;
      uint64_t up[KW], cur[KW], down[KW];
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        up[w] = w64[(sr0 - 1) * sw + wx + w + 1];
        cur[w] = w64[sr0 * sw + wx + w + 1];
        down[w] = w64[(sr0 + 1) * sw + wx + w + 1];
      }
      for (int sr = sr0; sr < sr0 + c.rpt; ++sr) {
        // the next row's words, read before this row's store
        uint64_t next[KW];
#pragma unroll
        for (int w = 0; w < KW; ++w)
          next[w] = sr + 2 <= c.wr + 1 ? w64[(sr + 2) * sw + wx + w + 1] : 0;
        const int gr = r0 - 1 + sr;
        if (gr >= 0 && gr < c.n) {
          const uint32_t left = win[(sr * sw + wx) * 8 + 7];
          const uint32_t right = win[(sr * sw + wx + KW + 1) * 8];
          const uint64_t row_e4 =
              4 * kOnes * static_cast<uint64_t>((gr == 0) + (gr == c.n - 1));
          const uint32_t rk =
              (static_cast<uint32_t>(gr) * 0x9E3779B9u) ^ sk;
          uint64_t nw[KW];
#pragma unroll
          for (int w = 0; w < KW; ++w) {
            const uint32_t l =
                w == 0 ? left : static_cast<uint32_t>(cur[w - 1] >> 56);
            const uint32_t r = w == KW - 1
                                   ? right
                                   : static_cast<uint32_t>(cur[w + 1] & 0xFF);
            const uint32_t cfw = cf0 + 8u * w * 0x85EBCA6Bu;
            nw[w] = ((gr + half) & 1)
                        ? draw_word<1>(up[w], cur[w], down[w], l, r,
                                       col_edges4[w] + row_e4, rk, cfw, smem,
                                       live[w])
                        : draw_word<0>(up[w], cur[w], down[w], l, r,
                                       col_edges4[w] + row_e4, rk, cfw, smem,
                                       live[w]);
          }
          const int trow = sr - 1 - c.top;
#pragma unroll
          for (int w = 0; w < KW; ++w) {
            w64[sr * sw + wx + w + 1] = nw[w];
            if (tally && trow >= 0 && trow < c.tr)
              cnt64[trow * (c.tc / 8) + cnt_col + w] += nw[w];
          }
        }
#pragma unroll
        for (int w = 0; w < KW; ++w) {
          up[w] = cur[w];
          cur[w] = down[w];
          down[w] = next[w];
        }
      }
      __syncthreads();
    }
  }

  // the tile and its tallies, a word at a time
  const int tile_words = c.tc / 8;
  for (int i = tid; i < c.tr * tile_words; i += nthreads) {
    const int tr_i = i / tile_words, tw = i - tr_i * tile_words;
    const int gr = tile_y * c.tr + tr_i, gc = tile_x * c.tc + 8 * tw;
    if (gr >= c.n || gc >= c.m) continue;
    const uint64_t word = w64[(tr_i + c.top + 1) * sw + 1 + c.left / 8 + tw];
    const uint64_t tally = c.count_mode ? cnt64[i] : 0;
    const int64_t g = static_cast<int64_t>(gr) * c.m + gc;
    if (aligned && gc + 8 <= c.m) {
      store_word(dst + g, word);
      if (c.count_mode == 1)
        store_word(count + g, tally);
      else if (c.count_mode == 2)
        add_word(count + g, tally);
    } else {
      for (int b = 0; b < 8 && gc + b < c.m; ++b) {
        dst[g + b] = static_cast<TOut>((word >> (8 * b)) & 0xFF);
        const int t = static_cast<int>((tally >> (8 * b)) & 0xFF);
        if (c.count_mode == 1)
          count[g + b] = t;
        else if (c.count_mode == 2)
          count[g + b] += t;
      }
    }
  }
}
template <typename TIn, typename TOut, int KW>
cudaError_t launch_kw(const void* src, void* dst, int32_t* count,
                      const Chunk& c, dim3 grid, dim3 block, size_t smem,
                      cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lattice_chunk_kernel<TIn, TOut, KW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  lattice_chunk_kernel<TIn, TOut, KW><<<grid, block, smem, st>>>(
      static_cast<const TIn*>(src), static_cast<TOut*>(dst), count, c);
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t launch_chunk(const void* src, void* dst, int32_t* count,
                         const Chunk& c, int kw, dim3 grid, dim3 block,
                         size_t smem, cudaStream_t st) {
  return kw == 2 ? launch_kw<TIn, TOut, 2>(src, dst, count, c, grid, block,
                                            smem, st)
                 : launch_kw<TIn, TOut, 1>(src, dst, count, c, grid, block,
                                            smem, st);
}

}  // namespace

// burn + epochs sweeps of the n x m int32 lattice x (row-major, values
// in {0, 1}, not written) into x_out; count (n x m int32) receives the
// tallied sweeps' counts (written only when epochs > 0). One launch per
// chunk of k sweeps on tiles of tile_rows x tile_cols cells, kw words
// (8 kw cells) of rpt window rows a thread; buf0 (n x m bytes, with two
// or more chunks) and buf1
// (with three or more) carry the lattice between launches. Returns the
// first error (0 when all launched).
extern "C" int nsx_stencil_gibbs(const int32_t* x, int32_t* x_out,
                                 int32_t* count, uint8_t* buf0,
                                 uint8_t* buf1, int n, int m, float two_w,
                                 float two_b, int seed977, int burn,
                                 int epochs, int tile_rows, int tile_cols,
                                 int k, int rpt, int kw, void* stream) {
  if (n <= 0 || m <= 0 || burn < 0 || epochs < 0 || k < 1 || k > kMaxK ||
      tile_rows < 1 || rpt < 1 || (kw != 1 && kw != 2) ||
      tile_cols < 8 * kw || tile_cols % (8 * kw))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sweeps = burn + epochs;
  Chunk c;
  c.n = n;
  c.m = m;
  c.tr = tile_rows;
  c.tc = tile_cols;
  c.tiles_x = (m + tile_cols - 1) / tile_cols;
  c.top = 2 * k;
  c.left = (2 * k + 8 * kw - 1) / (8 * kw) * (8 * kw);
  c.rpt = rpt;
  c.wpr = (tile_cols + 2 * c.left) / 8;
  const int by = (tile_rows + 4 * k + rpt - 1) / rpt;
  c.wr = by * rpt;
  c.two_w = two_w;
  c.two_b = two_b;
  c.seed977 = static_cast<uint32_t>(seed977);
  c.burn = burn;
  const int64_t tiles =
      static_cast<int64_t>(c.tiles_x) * ((n + tile_rows - 1) / tile_rows);
  const size_t smem = kThresholdBytes +
                      static_cast<size_t>(c.wr + 2) * (c.wpr + 2) * 8 +
                      static_cast<size_t>(tile_rows) * tile_cols;
  if (tiles > 0x7fffffff || smem > kMaxSmem ||
      static_cast<int64_t>(c.wpr / kw) * by > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles)), block(c.wpr / kw, by);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (sweeps + k - 1) / k;
  for (int ci = 0; ci < chunks; ++ci) {
    c.s0 = ci * k;
    c.s1 = c.s0 + k < sweeps ? c.s0 + k : sweeps;
    const int t0 = c.s0 > burn ? c.s0 : burn;
    c.count_mode = t0 >= c.s1 ? 0 : (t0 == burn ? 1 : 2);
    const bool first = ci == 0, last = ci == chunks - 1;
    // chunk ci reads what chunk ci - 1 wrote into buf[(ci - 1) % 2]
    const void* src = first ? static_cast<const void*>(x)
                            : (ci % 2 == 1 ? buf0 : buf1);
    void* dst = last ? static_cast<void*>(x_out) : (ci % 2 == 0 ? buf0 : buf1);
    cudaError_t err;
    if (first && last)
      err = launch_chunk<int32_t, int32_t>(src, dst, count, c, kw, grid,
                                           block, smem, st);
    else if (first)
      err = launch_chunk<int32_t, uint8_t>(src, dst, count, c, kw, grid,
                                           block, smem, st);
    else if (last)
      err = launch_chunk<uint8_t, int32_t>(src, dst, count, c, kw, grid,
                                           block, smem, st);
    else
      err = launch_chunk<uint8_t, uint8_t>(src, dst, count, c, kw, grid,
                                           block, smem, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
