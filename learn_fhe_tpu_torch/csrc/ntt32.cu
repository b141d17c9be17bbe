// K-NTT and K-POLYMUL: batched negacyclic NTT, inverse NTT and polynomial
// product mod one prime q < 2^31.
//
// Replaces the Pallas kernels of bench/pallas_ntt14_experiment.py:
//   forward NTT   <- make_kernels.call_fwd      (pl.pallas_call at :166)
//   polymul       <- make_kernels.call_polymul  (pl.pallas_call at :183),
//                    whose inverse half is the inverse NTT here.
// The Pallas kernels load a batch tile into VMEM once and run every layer
// there, with dense per-position twiddle rows, and form the pointwise
// product as mulhi / lo with 2^32 mod q folded in, never dividing.
//
// What bounds them on an H100: a transform moves 2 x 4 B per coefficient
// through device memory and does log N Shoup butterflies per pair; at
// (2048, 2048) the bytes take 10.0 us and the instructions' issue 9.0 us,
// so loads have to overlap arithmetic. The design:
//   - up to N = 2048 a 256-thread block owns max(1, 2048 / N) rows (2048
//     values, 8 per thread at every N); the grid is ceil(rows / rows per
//     block), and the ragged last block masks its missing rows;
//   - the layers run in passes of up to 3 on values held in registers
//     (lft::fwd_radix / inv_radix, shared with the step kernel), [3, 3, 3, 2]
//     at N=2048, with one barrier between passes and the values waiting in
//     a swizzled shared buffer (8 KB per operand) in between;
//   - the first forward pass reads device memory straight into registers,
//     neighbouring threads on neighbouring values; the last (log_h = 0)
//     holds runs of contiguous outputs and writes them with 16-byte stores.
//     The inverse mirrors it: 16-byte loads into its first pass, the 1/N
//     scale in its last, a coalesced store;
//   - twiddles come per pass through the read-only cache: the 16 KB table
//     of a prime is shared by all blocks on an SM, and a block holds no
//     wait to hide staging behind;
//   - K-POLYMUL holds a and b in one block: at the last forward pass a
//     thread has the same coefficients of both, multiplies them without a
//     division (lft::mul_fold) and runs the first inverse pass before its
//     values leave registers;
//   - one instance per ring size 2^LOG_N, so every pass's index arithmetic
//     is constant; up to 2048, 8 or 16 KB of shared memory and at most 64
//     registers a thread let 4 blocks share an SM.
// Past 2048 (N = 2^12 .. 2^14, the Pallas kernels' own (256, 2^14)) a block
// owns one row (the row passes below). There one 1024-thread block an SM
// (64 registers) stalled the SM at every barrier and ran 256 rows in two
// waves, K-POLYMUL's two 64 KB operands left room for no second block and
// spilled, and the address arithmetic of an item's swizzled slots and of
// its twiddles' scalar loads took issue slots the butterflies needed
// (PERF.md, section 6). So:
//   - 512 threads a block (kRowThreads), 64 registers: two blocks an SM,
//     256 rows in one wave; a thread takes its pass's items in turns (1, 2
//     or 4 items of 8 values by ring; 8 of 2 or 4 in a narrow last pass),
//     the passes as above ([3, 3, 3, 3, 2] at 2^14);
//   - an item's buffer slots from one swizzle (lft::slot: value m's slot is
//     swizzle(base) with a constant XORed or added in), and each layer's
//     twiddles of an item in one 4-, 8- or 16-byte load
//     (lft::pass_twiddles_wide);
//   - K-POLYMUL keeps a and b in the buffer up to 2^13 (64 KB); from
//     kScratchLogN one operand's 64 KB: a's forward passes write NTT(a) to
//     y through the L2, b's last forward pass reads each item of it back
//     (the same thread wrote it), multiplies, runs its inverse layers, and
//     the inverse passes end in y; its turns run one or two at a time
//     (mul_turns), which keeps ptxas at 64 registers without a spill.
// At 2048 neither more resident blocks nor a persistent grid that brings
// the next rows in with bulk copies ran faster on an H100 (PERF.md): the
// SMs' issue of the compiled integer instructions sets the time, and most
// of the ALU's share is the compare and select of the conditional
// subtracts.
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "ntt32.cuh"

namespace {

constexpr int kMaxLogN = 14;
constexpr int kMaxCrossLogN = 13;  // the fused forward's rings (a sharded transform's local block)
constexpr int kRowsLogN = 11;  // up to 2^11 a block holds 2048 values; past it, one row
constexpr int kRowThreads = 512;  // past 2^11: a row's block, two of them an SM
constexpr int kScratchLogN = 14;  // from here K-POLYMUL's buffer holds one operand
// (parking NTT(a) at 2^12 and 2^13 too ran 10-17% slower on an H100: PERF.md)
constexpr int kNttTurns = 0;      // K-NTT / intt32 past 2^11: every turn of a pass unrolled
// K-POLYMUL past 2^11: turns unrolled 2 at a time at 2^14, one at a time
// below, where two let ptxas spill
__host__ __device__ constexpr int mul_turns(int log_n) { return log_n >= kScratchLogN ? 2 : 1; }

// Values of a block's rows per operand, its threads, and the blocks an SM
// must hold at once (launch bounds: 64 registers a thread at every ring).
__host__ __device__ constexpr int block_values(int log_n) {
  return log_n > kRowsLogN ? 1 << log_n : 1 << kRowsLogN;
}
__host__ __device__ constexpr int block_threads(int log_n) {
  return log_n > kRowsLogN ? kRowThreads : block_values(log_n) / 8;
}
__host__ __device__ constexpr int min_blocks(int log_n) { return 1024 / block_threads(log_n); }
// Operands of K in a block's buffer: K-POLYMUL's a and b up to 2^13, one
// from kScratchLogN (NTT(a) waits in y).
__host__ __device__ constexpr int buffer_operands(int log_n, int k) {
  return log_n >= kScratchLogN ? 1 : k;
}
// Dynamic shared memory of a block with K operands: none up to 2^11, where
// the buffer is static.
__host__ __device__ constexpr int dynamic_smem(int log_n, int k) {
  return log_n > kRowsLogN ? buffer_operands(log_n, k) * 4 * block_values(log_n) : 0;
}

// What a block works on: its shared buffer, the prime's tables and constants,
// and how many values of its rows exist.
struct Rows {
  uint32_t* buf;  // block_values per operand, at lft::swizzle(i) for value i of the rows
  const uint32_t* __restrict__ psi;
  const uint32_t* __restrict__ psi_s;
  const uint32_t* __restrict__ psi_inv;
  const uint32_t* __restrict__ psi_inv_s;
  uint32_t q, n_inv, n_inv_s, r32, r32_s;
  int limit;  // block_values, or fewer in the ragged last block
  // the fused forward's cross-shard layer (kCross below): the partner's
  // block from the block's first value, the layer's twiddle, its Shoup dual
  const uint32_t* __restrict__ cv = nullptr;
  uint32_t ct = 0, cts = 0;
  int upper = 0;
};

// Item t of a block's pass over layers L0 .. L0+W-1: its rows hold
// block_values >> W items, and item t's value m is value at + (m << kLogH) of
// the block's rows, with at = row * N + (hi << (LOG_N - L0)) + lo.
template <int LOG_N, int L0, int W>
struct Item {
  static constexpr int kLogH = LOG_N - L0 - W;
  static constexpr int kThreads = block_threads(LOG_N);
  static constexpr int kValues = block_values(LOG_N);
  static constexpr int kPerThread = (kValues >> W) / kThreads;
  int hi, at;
  __device__ __forceinline__ explicit Item(int t)
      : hi((t & ((1 << (LOG_N - W)) - 1)) >> kLogH),
        at(((t >> (LOG_N - W)) << LOG_N) + (hi << (LOG_N - L0)) + (t & ((1 << kLogH) - 1))) {}
};

// An item's values from device memory; zeros past the rows that exist.
template <int W, int LOG_H>
__device__ __forceinline__ void load_item(uint32_t (&x)[1 << W], const uint32_t* __restrict__ p,
                                          int at, int limit) {
  if (at >= limit) {
#pragma unroll
    for (int m = 0; m < (1 << W); ++m) x[m] = 0;
  } else if constexpr (LOG_H == 0) {
    lft::load_global<1 << W>(x, p + at);
  } else {
#pragma unroll
    for (int m = 0; m < (1 << W); ++m) x[m] = __ldg(p + at + (m << LOG_H));
  }
}

// An item's values to device memory, if its row exists.
template <int W, int LOG_H>
__device__ __forceinline__ void store_item(const uint32_t (&x)[1 << W], uint32_t* __restrict__ p,
                                           int at, int limit) {
  if (at >= limit) return;
  if constexpr ((1 << W) >= 4 && LOG_H == 0) {
#pragma unroll
    for (int c = 0; c < (1 << W); c += 4) {
      *reinterpret_cast<uint4*>(p + at + c) = make_uint4(x[c], x[c + 1], x[c + 2], x[c + 3]);
    }
  } else {
#pragma unroll
    for (int m = 0; m < (1 << W); ++m) p[at + (m << LOG_H)] = x[m];
  }
}

// The inverse of the layers L0 .. L0+W-1 on one item, with the 1/N scale
// when they end at layer 0.
template <int W, int L0>
__device__ __forceinline__ void inverse_layers(const Rows& k, uint32_t (&x)[1 << W], int hi) {
  uint32_t w[(1 << W) - 1], ws[(1 << W) - 1];
  lft::pass_twiddles<W, true>(w, ws, k.psi_inv, k.psi_inv_s, L0, hi);
  lft::inv_radix<W>(x, w, ws, k.q);
  if constexpr (L0 == 0) {
#pragma unroll
    for (int m = 0; m < (1 << W); ++m) x[m] = lft::mul_shoup(x[m], k.n_inv, k.n_inv_s, k.q);
  }
}

// Forward pass P, then the ones after it, on the block's K operands (K-NTT:
// the row; K-POLYMUL: a and b, operand o in buffer slice o). Pass 0 reads
// `in` (device memory, at the block's first value), the others the buffer;
// with kCross (K = 1) pass 0 takes lft::cross_fwd of in's values and of the
// partner's block's (k.cv) at the same places.
// The last pass (log_h = 0) holds runs of 2^W outputs: with K = 1 it writes
// them to `out`; with K = 2 it multiplies a's by b's and runs the inverse of
// its own layers on the product, which then goes to `out` if that was layer
// 0 and to the buffer otherwise.
template <int LOG_N, int P, int K, bool kCross = false>
__device__ __forceinline__ void forward_pass(const Rows& k, const uint32_t* const (&in)[K],
                                             uint32_t* __restrict__ out) {
  constexpr int L0 = 3 * P, W = lft::pass_width(LOG_N, P), R = 1 << W;
  constexpr bool kLast = P == lft::pass_count(LOG_N) - 1;
  static_assert(!kCross || K == 1, "the cross-shard layer feeds K-NTT");
  using It = Item<LOG_N, L0, W>;
#pragma unroll
  for (int i = 0; i < It::kPerThread; ++i) {
    const It it(threadIdx.x + i * It::kThreads);
    uint32_t x[K][R];
#pragma unroll
    for (int o = 0; o < K; ++o) {
      if constexpr (P == 0) {
        load_item<W, It::kLogH>(x[o], in[o], it.at, k.limit);
        if constexpr (kCross) {
          uint32_t v[R];
          load_item<W, It::kLogH>(v, k.cv, it.at, k.limit);
#pragma unroll
          for (int m = 0; m < R; ++m) x[o][m] = lft::cross_fwd(x[o][m], v[m], k.ct, k.cts, k.q, k.upper);
        }
      } else {
        lft::load_row<W, It::kLogH>(x[o], k.buf + o * It::kValues, it.at);
      }
    }
    {
      uint32_t w[R - 1], ws[R - 1];
      lft::pass_twiddles<W, true>(w, ws, k.psi, k.psi_s, L0, it.hi);
#pragma unroll
      for (int o = 0; o < K; ++o) lft::fwd_radix<W>(x[o], w, ws, k.q);
    }
    if constexpr (!kLast) {
#pragma unroll
      for (int o = 0; o < K; ++o) lft::store_row<W, It::kLogH>(x[o], k.buf + o * It::kValues, it.at);
    } else if constexpr (K == 1) {
      store_item<W, 0>(x[0], out, it.at, k.limit);
    } else {
#pragma unroll
      for (int m = 0; m < R; ++m) x[0][m] = lft::mul_fold(x[0][m], x[1][m], k.r32, k.r32_s, k.q);
      inverse_layers<W, L0>(k, x[0], it.hi);
      if constexpr (L0 == 0) {
        store_item<W, 0>(x[0], out, it.at, k.limit);
      } else {
        lft::store_row<W, 0>(x[0], k.buf, it.at);
      }
    }
  }
  if constexpr (!kLast) {
    __syncthreads();
    forward_pass<LOG_N, P + 1, K, kCross>(k, in, out);
  }
}

// The inverse of forward pass P, then of P-1 .. 0, on the row in buffer
// slice 0. kFromGlobal: P is the last forward pass (log_h = 0), and its
// input runs are read from `in` (device memory) instead of the buffer.
// Pass 0 scales by 1/N and writes `out`.
template <int LOG_N, int P, bool kFromGlobal>
__device__ __forceinline__ void inverse_pass(const Rows& k, const uint32_t* __restrict__ in,
                                             uint32_t* __restrict__ out) {
  constexpr int L0 = 3 * P, W = lft::pass_width(LOG_N, P), R = 1 << W;
  using It = Item<LOG_N, L0, W>;
#pragma unroll
  for (int i = 0; i < It::kPerThread; ++i) {
    const It it(threadIdx.x + i * It::kThreads);
    uint32_t x[R];
    if constexpr (kFromGlobal) {
      load_item<W, It::kLogH>(x, in, it.at, k.limit);
    } else {
      lft::load_row<W, It::kLogH>(x, k.buf, it.at);
    }
    inverse_layers<W, L0>(k, x, it.hi);
    if constexpr (P == 0) {
      store_item<W, It::kLogH>(x, out, it.at, k.limit);
    } else {
      lft::store_row<W, It::kLogH>(x, k.buf, it.at);
    }
  }
  if constexpr (P > 0) {
    __syncthreads();
    inverse_pass<LOG_N, P - 1, false>(k, in, out);
  }
}

// ---------------------------------------------------------------------------
// Past 2^11: a block owns one row, kRowThreads threads, two blocks an SM.
// ---------------------------------------------------------------------------

// Pass P of a row: its layers, and the item of thread threadIdx.x's turn j,
// i = threadIdx.x + j kRowThreads of the row's 2^(LOG_N - W): hi = i >>
// kLogH, its values at + (m << kLogH) (Item's map on one row).
template <int LOG_N, int P>
struct RowItem {
  static constexpr int kL0 = 3 * P, kW = lft::pass_width(LOG_N, P), kLogH = LOG_N - kL0 - kW;
  static constexpr int kTurns = (1 << (LOG_N - kW)) / kRowThreads;
  static constexpr bool kLast = P == lft::pass_count(LOG_N) - 1;
  int hi, at;
  __device__ __forceinline__ explicit RowItem(int j) {
    const int i = static_cast<int>(threadIdx.x) + j * kRowThreads;
    hi = i >> kLogH;
    at = (hi << (LOG_N - kL0)) + (i & ((1 << kLogH) - 1));
  }
};

// f(j) for each turn j < N of a row's pass: unrolled (kU = 0), or kU turns
// at a time (ptxas holds K-POLYMUL's passes to 64 registers without spilling
// only so).
template <int N, int kU, class F>
__device__ __forceinline__ void for_turns(F&& f) {
  if constexpr (kU == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) f(j);
  } else if constexpr (kU == 2) {
#pragma unroll 2
    for (int j = 0; j < N; ++j) f(j);
  } else {
    static_assert(kU == 1, "turns unrolled 0 (all), 1 or 2 at a time");
#pragma unroll 1
    for (int j = 0; j < N; ++j) f(j);
  }
}

// An item's values from device memory: contiguous runs in 16- or 8-byte
// loads, strided values one by one (neighbouring threads on neighbouring
// words); kL2: through the L2 alone (values this thread stored there).
template <int W, int LOG_H, bool kL2 = false>
__device__ __forceinline__ void row_load(uint32_t (&x)[1 << W], const uint32_t* p) {
  if constexpr (kL2) {
    static_assert(LOG_H == 0 && W >= 2, "a run of 4 or more values");
#pragma unroll
    for (int c = 0; c < (1 << W); c += 4) {
      const uint4 v = __ldcg(reinterpret_cast<const uint4*>(p + c));
      x[c] = v.x, x[c + 1] = v.y, x[c + 2] = v.z, x[c + 3] = v.w;
    }
  } else if constexpr (LOG_H == 0 && W >= 2) {
    lft::load_global<1 << W>(x, p);
  } else if constexpr (LOG_H == 0) {
    lft::load_words<1 << W>(x, p);
  } else {
#pragma unroll
    for (int m = 0; m < (1 << W); ++m) x[m] = __ldg(p + (m << LOG_H));
  }
}

// An item's values to device memory, the same way; kL2: kept in the L2.
template <int W, int LOG_H, bool kL2 = false>
__device__ __forceinline__ void row_store(const uint32_t (&x)[1 << W], uint32_t* p) {
  if constexpr (LOG_H == 0 && W >= 2) {
#pragma unroll
    for (int c = 0; c < (1 << W); c += 4) {
      const uint4 v = make_uint4(x[c], x[c + 1], x[c + 2], x[c + 3]);
      if constexpr (kL2) {
        __stcg(reinterpret_cast<uint4*>(p + c), v);
      } else {
        *reinterpret_cast<uint4*>(p + c) = v;
      }
    }
  } else {
    static_assert(!kL2, "a run of 4 or more values");
    if constexpr (LOG_H == 0 && W == 1) {
      *reinterpret_cast<uint2*>(p) = make_uint2(x[0], x[1]);
    } else {
#pragma unroll
      for (int m = 0; m < (1 << W); ++m) p[m << LOG_H] = x[m];
    }
  }
}

// inverse_layers with the twiddles in wide loads.
template <int W, int L0>
__device__ __forceinline__ void row_inverse_layers(const Rows& k, uint32_t (&x)[1 << W], int hi) {
  uint32_t w[(1 << W) - 1], ws[(1 << W) - 1];
  lft::pass_twiddles_wide<W>(w, ws, k.psi_inv, k.psi_inv_s, L0, hi);
  lft::inv_radix<W>(x, w, ws, k.q);
  if constexpr (L0 == 0) {
#pragma unroll
    for (int m = 0; m < (1 << W); ++m) x[m] = lft::mul_shoup(x[m], k.n_inv, k.n_inv_s, k.q);
  }
}

// What a row's last forward pass does with its runs of 2^W outputs.
enum class End {
  kStore,    // writes them to out (K-NTT)
  kScratch,  // writes them to out, kept in the L2 (K-POLYMUL's NTT(a) past kScratchLogN)
  kMul,      // multiplies them by b's (K = 2: the buffer's second operand;
             // K = 1: NTT(a), read back from out where kScratch put it), runs
             // the inverse of its own layers on the product, and puts that
             // in the buffer (in out if they end at layer 0)
};

// Forward pass P of a row, then the ones after it, on K operands (operand o
// in buffer slice o): pass 0 reads in[o] (device memory), the others the
// buffer; the last pass ends as E says. A turn takes one operand's item at a
// time under the twiddles it loaded once for all K; kU: for_turns' unrolling.
// kCross: as forward_pass's.
template <int LOG_N, int P, int K, End E, int kU, bool kCross = false>
__device__ __forceinline__ void row_forward(const Rows& k, const uint32_t* const (&in)[K], uint32_t* __restrict__ out) {
  static_assert(!kCross || (K == 1 && E == End::kStore), "the cross-shard layer feeds K-NTT");
  using It = RowItem<LOG_N, P>;
  constexpr int W = It::kW, R = 1 << W, kLogH = It::kLogH, kValues = 1 << LOG_N;
  for_turns<It::kTurns, kU>([&](int j) {
    const It it(j);
    const int sw = lft::swizzle(it.at);  // its values' slots: lft::slot(sw, m)
    uint32_t w[R - 1], ws[R - 1];
    lft::pass_twiddles_wide<W>(w, ws, k.psi, k.psi_s, It::kL0, it.hi);
    uint32_t x[R];
    if constexpr (!It::kLast || E != End::kMul) {
#pragma unroll
      for (int o = 0; o < K; ++o) {
        if constexpr (P == 0) {
          row_load<W, kLogH>(x, in[o] + it.at);
          if constexpr (kCross) {
            uint32_t v[R];
            row_load<W, kLogH>(v, k.cv + it.at);
#pragma unroll
            for (int m = 0; m < R; ++m) x[m] = lft::cross_fwd(x[m], v[m], k.ct, k.cts, k.q, k.upper);
          }
        } else {
          lft::load_slots<W, kLogH>(x, k.buf + o * kValues, sw);
        }
        lft::fwd_radix<W>(x, w, ws, k.q);
        if constexpr (!It::kLast) {
          lft::store_slots<W, kLogH>(x, k.buf + o * kValues, sw);
        } else {
          row_store<W, 0, E == End::kScratch>(x, out + it.at);
        }
      }
    } else {
      uint32_t y[R];
      if constexpr (P == 0) {
        row_load<W, kLogH>(x, in[0] + it.at);
      } else {
        lft::load_slots<W, kLogH>(x, k.buf, sw);
      }
      lft::fwd_radix<W>(x, w, ws, k.q);
      if constexpr (K == 2) {
        if constexpr (P == 0) {
          row_load<W, kLogH>(y, in[1] + it.at);
        } else {
          lft::load_slots<W, kLogH>(y, k.buf + kValues, sw);
        }
        lft::fwd_radix<W>(y, w, ws, k.q);
      } else {
        row_load<W, 0, true>(y, out + it.at);
      }
#pragma unroll
      for (int m = 0; m < R; ++m) x[m] = lft::mul_fold(x[m], y[m], k.r32, k.r32_s, k.q);
      row_inverse_layers<W, It::kL0>(k, x, it.hi);
      if constexpr (It::kL0 == 0) {
        row_store<W, 0>(x, out + it.at);
      } else {
        lft::store_slots<W, 0>(x, k.buf, sw);
      }
    }
  });
  if constexpr (!It::kLast) {
    __syncthreads();
    row_forward<LOG_N, P + 1, K, E, kU, kCross>(k, in, out);
  }
}

// The inverse of a row's forward pass P, then of P-1 .. 0, on buffer slice
// 0; kFromGlobal: P is the last forward pass, its runs read from `in`. Pass
// 0 scales by 1/N and writes `out`.
template <int LOG_N, int P, bool kFromGlobal, int kU>
__device__ __forceinline__ void row_inverse(const Rows& k, const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {
  using It = RowItem<LOG_N, P>;
  constexpr int W = It::kW, kLogH = It::kLogH;
  for_turns<It::kTurns, kU>([&](int j) {
    const It it(j);
    const int sw = lft::swizzle(it.at);  // its values' slots: lft::slot(sw, m)
    uint32_t x[1 << W];
    if constexpr (kFromGlobal) {
      row_load<W, kLogH>(x, in + it.at);
    } else {
      lft::load_slots<W, kLogH>(x, k.buf, sw);
    }
    row_inverse_layers<W, It::kL0>(k, x, it.hi);
    if constexpr (P == 0) {
      row_store<W, kLogH>(x, out + it.at);
    } else {
      lft::store_slots<W, kLogH>(x, k.buf, sw);
    }
  });
  if constexpr (P > 0) {
    __syncthreads();
    row_inverse<LOG_N, P - 1, false, kU>(k, in, out);
  }
}

// Values of the block's rows that exist, of `values` in all.
template <int LOG_N>
__device__ __forceinline__ int block_limit(long long values) {
  constexpr int kValues = block_values(LOG_N);
  const long long left = values - static_cast<long long>(blockIdx.x) * kValues;
  return left < kValues ? static_cast<int>(left) : kValues;
}

// The block's buffer for K operands, 16-byte aligned for the vector
// accesses: static up to 2^11, dynamic (dynamic_smem bytes) past it.
template <int LOG_N, int K>
__device__ __forceinline__ uint32_t* block_buffer() {
  if constexpr (LOG_N > kRowsLogN) {
    extern __shared__ uint4 dyn4[];
    return reinterpret_cast<uint32_t*>(dyn4);
  } else {
    __shared__ uint4 sh4[K * block_values(LOG_N) / 4];
    return reinterpret_cast<uint32_t*>(sh4);
  }
}

template <int LOG_N>
__global__ void __launch_bounds__(block_threads(LOG_N), min_blocks(LOG_N))
    ntt32_fwd_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                     const uint32_t* __restrict__ psi, const uint32_t* __restrict__ psi_s,
                     long long values, uint32_t q) {
  const size_t first = static_cast<size_t>(blockIdx.x) * block_values(LOG_N);
  const Rows k{block_buffer<LOG_N, 1>(), psi, psi_s, nullptr, nullptr, q, 0, 0, 0, 0,
               block_limit<LOG_N>(values)};
  const uint32_t* const in[1] = {x + first};
  if constexpr (LOG_N > kRowsLogN) {
    row_forward<LOG_N, 0, 1, End::kStore, kNttTurns>(k, in, y + first);
  } else {
    forward_pass<LOG_N, 0, 1>(k, in, y + first);
  }
}

// The fused forward of a coefficient-sharded transform (parallel/coef32.py,
// coef32_ntt_tail): the last cross-shard layer in the first pass's loads,
// then K-NTT's passes; rings up to kMaxCrossLogN.
template <int LOG_N>
__global__ void __launch_bounds__(block_threads(LOG_N), min_blocks(LOG_N))
    ntt32_fwd_cross_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ v,
                           uint32_t* __restrict__ y, const uint32_t* __restrict__ psi,
                           const uint32_t* __restrict__ psi_s, long long values, uint32_t q, uint32_t t,
                           uint32_t ts, int upper) {
  const size_t first = static_cast<size_t>(blockIdx.x) * block_values(LOG_N);
  const Rows k{block_buffer<LOG_N, 1>(), psi, psi_s, nullptr, nullptr, q, 0, 0, 0, 0,
               block_limit<LOG_N>(values), v + first, t, ts, upper};
  const uint32_t* const in[1] = {x + first};
  if constexpr (LOG_N > kRowsLogN) {
    row_forward<LOG_N, 0, 1, End::kStore, kNttTurns, true>(k, in, y + first);
  } else {
    forward_pass<LOG_N, 0, 1, true>(k, in, y + first);
  }
}

template <int LOG_N>
__global__ void __launch_bounds__(block_threads(LOG_N), min_blocks(LOG_N))
    ntt32_inv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                     const uint32_t* __restrict__ psi_inv, const uint32_t* __restrict__ psi_inv_s,
                     long long values, uint32_t q, uint32_t n_inv, uint32_t n_inv_s) {
  const size_t first = static_cast<size_t>(blockIdx.x) * block_values(LOG_N);
  const Rows k{block_buffer<LOG_N, 1>(), nullptr, nullptr, psi_inv, psi_inv_s, q, n_inv,
               n_inv_s, 0, 0, block_limit<LOG_N>(values)};
  if constexpr (LOG_N > kRowsLogN) {
    row_inverse<LOG_N, lft::pass_count(LOG_N) - 1, true, kNttTurns>(k, x + first, y + first);
  } else {
    inverse_pass<LOG_N, lft::pass_count(LOG_N) - 1, true>(k, x + first, y + first);
  }
}

// y = INTT(NTT(a) * NTT(b)) on the block's rows of a and b.
template <int LOG_N>
__global__ void __launch_bounds__(block_threads(LOG_N), min_blocks(LOG_N))
    negacyclic_mul32_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                            uint32_t* __restrict__ y, const uint32_t* __restrict__ psi,
                            const uint32_t* __restrict__ psi_s,
                            const uint32_t* __restrict__ psi_inv,
                            const uint32_t* __restrict__ psi_inv_s, long long values, uint32_t q,
                            uint32_t n_inv, uint32_t n_inv_s, uint32_t r32, uint32_t r32_s) {
  const size_t first = static_cast<size_t>(blockIdx.x) * block_values(LOG_N);
  const Rows k{block_buffer<LOG_N, 2>(), psi, psi_s, psi_inv, psi_inv_s, q, n_inv, n_inv_s,
               r32, r32_s, block_limit<LOG_N>(values)};
  constexpr int kLast = lft::pass_count(LOG_N) - 1;
  if constexpr (LOG_N >= kScratchLogN) {  // NTT(a) into y, then b's forward takes it back
    const uint32_t* const in_a[1] = {a + first};
    const uint32_t* const in_b[1] = {b + first};
    row_forward<LOG_N, 0, 1, End::kScratch, mul_turns(LOG_N)>(k, in_a, y + first);
    __syncthreads();  // b's first pass overwrites what a's last pass read
    row_forward<LOG_N, 0, 1, End::kMul, mul_turns(LOG_N)>(k, in_b, y + first);
    __syncthreads();
    row_inverse<LOG_N, kLast - 1, false, mul_turns(LOG_N)>(k, nullptr, y + first);
  } else if constexpr (LOG_N > kRowsLogN) {
    const uint32_t* const in[2] = {a + first, b + first};
    row_forward<LOG_N, 0, 2, End::kMul, mul_turns(LOG_N)>(k, in, y + first);
    __syncthreads();
    row_inverse<LOG_N, kLast - 1, false, mul_turns(LOG_N)>(k, nullptr, y + first);
  } else {
    const uint32_t* const in[2] = {a + first, b + first};
    forward_pass<LOG_N, 0, 2>(k, in, y + first);
    if constexpr (kLast > 0) {
      __syncthreads();
      inverse_pass<LOG_N, kLast - 1, false>(k, nullptr, y + first);
    }
  }
}

// Each kernel's instance for ring 2^log_n, 1 <= log_n <= kMaxLogN.
template <int... L>
auto fwd_kernel(int log_n, std::integer_sequence<int, L...>) {
  static const decltype(&ntt32_fwd_kernel<1>) table[] = {ntt32_fwd_kernel<L + 1>...};
  return table[log_n - 1];
}

template <int... L>
auto cross_kernel(int log_n, std::integer_sequence<int, L...>) {
  static const decltype(&ntt32_fwd_cross_kernel<1>) table[] = {ntt32_fwd_cross_kernel<L + 1>...};
  return table[log_n - 1];
}

template <int... L>
auto inv_kernel(int log_n, std::integer_sequence<int, L...>) {
  static const decltype(&ntt32_inv_kernel<1>) table[] = {ntt32_inv_kernel<L + 1>...};
  return table[log_n - 1];
}

template <int... L>
auto mul_kernel(int log_n, std::integer_sequence<int, L...>) {
  static const decltype(&negacyclic_mul32_kernel<1>) table[] = {negacyclic_mul32_kernel<L + 1>...};
  return table[log_n - 1];
}

constexpr auto kLogNs = std::make_integer_sequence<int, kMaxLogN>{};

// Blocks for `rows` rows of 2^log_n, or 0 for a shape the kernels do not take.
unsigned blocks(int rows, int log_n) {
  if (rows < 1 || log_n < 1 || log_n > kMaxLogN) return 0;
  const int per_block = block_values(log_n) >> log_n;
  return static_cast<unsigned>((rows + per_block - 1) / per_block);
}

// Opts `kernel` in to smem bytes of dynamic shared memory where that passes
// 48 KB; a CUDA error, or 0.
template <class Kernel>
int opt_in(Kernel kernel, int smem) {
  return smem > 48 * 1024
             ? static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
             : 0;
}

// Launches `kernel` for ring 2^log_n on `grid` blocks with K operands'
// buffer.
template <int K, class Kernel, class... Args>
int launch(Kernel kernel, unsigned grid, int log_n, void* stream, Args... args) {
  const int smem = dynamic_smem(log_n, K);
  if (const int err = opt_in(kernel, smem)) return err;
  kernel<<<grid, block_threads(log_n), smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* lft_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int lft_ntt32_fwd(const void* x, void* y, const void* psi, const void* psi_s, int rows, int log_n,
                  unsigned int q, void* stream) {
  const unsigned grid = blocks(rows, log_n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<1>(fwd_kernel(log_n, kLogNs), grid, log_n, stream, static_cast<const uint32_t*>(x),
                   static_cast<uint32_t*>(y), static_cast<const uint32_t*>(psi),
                   static_cast<const uint32_t*>(psi_s), static_cast<long long>(rows) << log_n, q);
}

// lft_ntt32_fwd's arguments with v (the partner's block, x's layout) after x
// and, after q, the layer's twiddle t, its Shoup dual ts and upper: the
// forward transform of each row's lft::cross_fwd values, 2 <= N <= 2^13.
int lft_ntt32_fwd_cross(const void* x, const void* v, void* y, const void* psi, const void* psi_s, int rows,
                        int log_n, unsigned int q, unsigned int t, unsigned int ts, int upper, void* stream) {
  const unsigned grid = log_n <= kMaxCrossLogN ? blocks(rows, log_n) : 0;
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<1>(cross_kernel(log_n, std::make_integer_sequence<int, kMaxCrossLogN>{}), grid, log_n, stream,
                   static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(v), static_cast<uint32_t*>(y),
                   static_cast<const uint32_t*>(psi), static_cast<const uint32_t*>(psi_s),
                   static_cast<long long>(rows) << log_n, q, t, ts, upper);
}

int lft_ntt32_inv(const void* x, void* y, const void* psi_inv, const void* psi_inv_s, int rows,
                  int log_n, unsigned int q, unsigned int n_inv, unsigned int n_inv_s,
                  void* stream) {
  const unsigned grid = blocks(rows, log_n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<1>(inv_kernel(log_n, kLogNs), grid, log_n, stream, static_cast<const uint32_t*>(x),
                   static_cast<uint32_t*>(y), static_cast<const uint32_t*>(psi_inv),
                   static_cast<const uint32_t*>(psi_inv_s), static_cast<long long>(rows) << log_n, q,
                   n_inv, n_inv_s);
}

int lft_negacyclic_mul32(const void* a, const void* b, void* y, const void* psi,
                         const void* psi_s, const void* psi_inv, const void* psi_inv_s, int rows,
                         int log_n, unsigned int q, unsigned int n_inv, unsigned int n_inv_s,
                         unsigned int r32, unsigned int r32_s, void* stream) {
  const unsigned grid = blocks(rows, log_n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<2>(mul_kernel(log_n, kLogNs), grid, log_n, stream, static_cast<const uint32_t*>(a),
                   static_cast<const uint32_t*>(b), static_cast<uint32_t*>(y),
                   static_cast<const uint32_t*>(psi), static_cast<const uint32_t*>(psi_s),
                   static_cast<const uint32_t*>(psi_inv), static_cast<const uint32_t*>(psi_inv_s),
                   static_cast<long long>(rows) << log_n, q, n_inv, n_inv_s, r32, r32_s);
}

// Host function: the instance of kind (0 K-NTT, 1 intt32, 2 K-POLYMUL) at
// ring 2^log_n, into out[3]: threads a block, dynamic shared memory bytes
// and blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor); no
// instance launches a cluster. A CUDA error, or 0.
int lft_ntt32_occupancy(int kind, int log_n, int* out) {
  if (kind < 0 || kind > 2 || log_n < 1 || log_n > kMaxLogN) return static_cast<int>(cudaErrorInvalidValue);
  const int k = kind == 2 ? 2 : 1, smem = dynamic_smem(log_n, k);
  const void* kernel = kind == 0   ? reinterpret_cast<const void*>(fwd_kernel(log_n, kLogNs))
                       : kind == 1 ? reinterpret_cast<const void*>(inv_kernel(log_n, kLogNs))
                                   : reinterpret_cast<const void*>(mul_kernel(log_n, kLogNs));
  if (const int err = opt_in(kernel, smem)) return err;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, block_threads(log_n), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = block_threads(log_n), out[1] = smem, out[2] = blocks;
  return 0;
}

}  // extern "C"
