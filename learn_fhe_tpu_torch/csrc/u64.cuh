// The u64 engine on the card: arithmetic mod odd primes q < 2^63, the
// negacyclic NTT on rows held in shared memory, the Zq gadget digits and the
// external product's phase, shared by K-NTT64 / K-POLYMUL64 (ntt64.cu) and
// K-EXTPROD64 / K-FHEW-BR64 (fhew_u64.cu), so that the four agree bit for bit.
//
// Device counterpart of learn_fhe_tpu/ops/modular.py (the u64 engine) and
// ops/ntt.py: residues are uint64 in [0, q). A product against a constant
// (a twiddle) is a Shoup product with the constant's dual floor(w 2^64 / q);
// a product of two variables is summed as 128 bits (hi:lo, __umul64hi) and
// brought back by Montgomery reduction (REDC). Every function returns the
// canonical residue, so the results are the JAX package's exactly.
//
// The NTT passes come in two instances. The eager one (kLazy false) reduces
// every butterfly's outputs to [0, q); it takes any q < 2^63. The lazy one
// (kLazy true, Harvey's butterflies) keeps forward values in [0, 4q) and
// inverse values in [0, 2q) and skips the Shoup products' last subtract; it
// needs 4q < 2^64, so the host takes it only for q < 2^62 (lazy_ok). Both
// make their values canonical once: at the end of the last forward pass,
// and in the 1/N scale of the last inverse pass, so either instance returns
// the same residues.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace lft64 {

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// Arithmetic. csub: s mod q for s < 2q, by the unsigned minimum (s - q wraps
// above s when s < q).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t umin(uint64_t a, uint64_t b) { return a < b ? a : b; }

__device__ __forceinline__ uint64_t csub(uint64_t s, uint64_t q) { return umin(s, s - q); }

__device__ __forceinline__ uint64_t add_q(uint64_t a, uint64_t b, uint64_t q) { return csub(a + b, q); }

__device__ __forceinline__ uint64_t sub_q(uint64_t a, uint64_t b, uint64_t q) {
  const uint64_t d = a - b;
  return umin(d, d + q);
}

// a * w mod q, up to one q, for a constant w < q with its Shoup dual ws:
// a w - floor(a ws / 2^64) q lies in [0, 2q) for any a < 2^64 when q < 2^63.
__device__ __forceinline__ uint64_t shoup_lazy(uint64_t a, uint64_t w, uint64_t ws, uint64_t q) {
  return a * w - __umul64hi(a, ws) * q;
}

__device__ __forceinline__ uint64_t shoup_q(uint64_t a, uint64_t w, uint64_t ws, uint64_t q) {
  return csub(shoup_lazy(a, w, ws, q), q);
}

// s mod q for s < 4q (q < 2^62).
__device__ __forceinline__ uint64_t reduce4(uint64_t s, uint64_t q) { return csub(csub(s, 2 * q), q); }

// The coefficient-sharded transform's forward cross-shard layer on one pair
// (parallel/coef.py): x this rank's value, v its partner's, t the layer's
// twiddle with its Shoup dual, all below q; upper ? v - t x : x + t v,
// canonical.
__device__ __forceinline__ uint64_t cross_fwd(uint64_t x, uint64_t v, uint64_t t, uint64_t ts, uint64_t q,
                                              bool upper) {
  return upper ? sub_q(v, shoup_q(x, t, ts, q), q) : add_q(x, shoup_q(v, t, ts, q), q);
}

// The prime with its REDC constant -q^-1 mod 2^64.
struct Mod {
  uint64_t q, neg_q_inv;
};

// t 2^-64 mod q for t = hi 2^64 + lo < q 2^64: (t + k q) / 2^64 with k = lo
// (-q^-1), below 2q; the low words' sum carries exactly when lo != 0.
__device__ __forceinline__ uint64_t redc(uint64_t hi, uint64_t lo, const Mod& m) {
  const uint64_t k = lo * m.neg_q_inv;
  return csub(hi + __umul64hi(k, m.q) + (lo != 0 ? 1u : 0u), m.q);
}

// a b mod q by two REDCs, the second by r2 = 2^128 mod q (ops/modular.py
// mul_mod).
__device__ __forceinline__ uint64_t mul_mod(uint64_t a, uint64_t b, uint64_t r2, const Mod& m) {
  const uint64_t t = redc(__umul64hi(a, b), a * b, m);
  return redc(__umul64hi(t, r2), t * r2, m);
}

// hi:lo += a b (128 bits).
__device__ __forceinline__ void mac128(uint64_t& hi, uint64_t& lo, uint64_t a, uint64_t b) {
  const uint64_t p = a * b;
  lo += p;
  hi += __umul64hi(a, b) + (lo < p ? 1u : 0u);
}

// ---------------------------------------------------------------------------
// The NTT. Layer L of the forward (Cooley-Tukey) transform has 2^L groups of
// 2 half values, half = n >> (L+1); group g pairs j and j + half with
// twiddle psi[2^L + g] of the bit-reversed table. A pass runs W <= 3
// consecutive layers l0 .. l0+W-1 on the 2^W values they combine: item (g,
// lo) holds values g 2^(log_n - l0) + m h + lo, m < 2^W, h = 2^(log_n - l0 -
// W); layer l0+t pairs m and m + 2^(W-1-t) in sub-group u with twiddle
// 2^(l0+t) + (g << t) + u. The passes are 3 layers wide but the last (1 to
// 3); the inverse (Gentleman-Sande) runs them in reverse, each pass's layers
// last first, and scales by 1/N. Every operation is exact mod q, so any
// grouping of the layers gives the radix-2 values.
// ---------------------------------------------------------------------------

// The prime's tables (device memory, n u64 each) and constants.
struct Tables {
  const uint64_t* __restrict__ psi;
  const uint64_t* __restrict__ psi_s;
  const uint64_t* __restrict__ psi_inv;
  const uint64_t* __restrict__ psi_inv_s;
  uint64_t q, neg_q_inv, n_inv, n_inv_s;
};

__host__ __device__ constexpr int pass_count(int log_n) { return (log_n + 2) / 3; }
__host__ __device__ constexpr int pass_width(int log_n, int p) {
  return p == pass_count(log_n) - 1 ? log_n - 3 * p : 3;
}

template <int W>
__device__ __forceinline__ void twiddles(uint64_t (&w)[(1 << W) - 1], uint64_t (&ws)[(1 << W) - 1],
                                         const uint64_t* __restrict__ tab, const uint64_t* __restrict__ tab_s,
                                         int l0, int g) {
#pragma unroll
  for (int t = 0; t < W; ++t) {
#pragma unroll
    for (int u = 0; u < (1 << t); ++u) {
      const int idx = (1 << (l0 + t)) + (g << t) + u;
      w[(1 << t) - 1 + u] = __ldg(tab + idx);
      ws[(1 << t) - 1 + u] = __ldg(tab_s + idx);
    }
  }
}

// The host's choice of instance: the lazy ranges need 4q < 2^64.
__host__ __device__ constexpr bool lazy_ok(uint64_t q) { return q < (1ull << 62); }

// The forward butterflies of W layers. Eager: inputs and outputs in [0, q).
// Lazy: inputs and outputs in [0, 4q); x0 comes into [0, 2q), v = x1 w in
// [0, 2q), and x0 + v, x0 - v + 2q stay below 4q.
template <int W, bool kLazy>
__device__ __forceinline__ void fwd_radix(uint64_t (&x)[1 << W], const uint64_t (&w)[(1 << W) - 1],
                                          const uint64_t (&ws)[(1 << W) - 1], uint64_t q) {
#pragma unroll
  for (int t = 0; t < W; ++t) {
    const int half = 1 << (W - 1 - t);
#pragma unroll
    for (int u = 0; u < (1 << t); ++u) {
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const int a = 2 * half * u + j;
        const uint64_t wt = w[(1 << t) - 1 + u], wst = ws[(1 << t) - 1 + u];
        if constexpr (kLazy) {
          const uint64_t x0 = csub(x[a], 2 * q);
          const uint64_t v = shoup_lazy(x[a + half], wt, wst, q);
          x[a + half] = x0 - v + 2 * q;
          x[a] = x0 + v;
        } else {
          const uint64_t v = shoup_q(x[a + half], wt, wst, q);
          x[a + half] = sub_q(x[a], v, q);
          x[a] = add_q(x[a], v, q);
        }
      }
    }
  }
}

// The inverse butterflies. Eager: [0, q) in and out. Lazy: [0, 2q) in and
// out; x0 + x1 is brought below 2q, (x0 - x1 + 2q) w below 2q by the lazy
// Shoup product.
template <int W, bool kLazy>
__device__ __forceinline__ void inv_radix(uint64_t (&x)[1 << W], const uint64_t (&w)[(1 << W) - 1],
                                          const uint64_t (&ws)[(1 << W) - 1], uint64_t q) {
#pragma unroll
  for (int t = W - 1; t >= 0; --t) {
    const int half = 1 << (W - 1 - t);
#pragma unroll
    for (int u = 0; u < (1 << t); ++u) {
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const int a = 2 * half * u + j;
        const uint64_t x0 = x[a], x1 = x[a + half];
        const uint64_t wt = w[(1 << t) - 1 + u], wst = ws[(1 << t) - 1 + u];
        if constexpr (kLazy) {
          x[a] = csub(x0 + x1, 2 * q);
          x[a + half] = shoup_lazy(x0 - x1 + 2 * q, wt, wst, q);
        } else {
          x[a] = add_q(x0, x1, q);
          x[a + half] = shoup_q(sub_q(x0, x1, q), wt, wst, q);
        }
      }
    }
  }
}

// One pass of W layers from l0 over `rows` rows of 2^log_n values at buf
// (row r at buf + (r << log_n)). A thread takes item i of a row (its
// twiddles, loaded once) in every row it covers: all `rows` where a row has
// more items than the block has threads, else every (blockDim / items)-th.
// Forward: the last pass (l0 + W = log_n) ends with the values made
// canonical. With kInv, the inverse layers; at l0 = 0 they end with the 1/N
// scale (canonical) and, where add is given, row 1 += add (the key switch's
// b). No barrier.
template <int W, bool kInv, bool kLazy>
__device__ __forceinline__ void pass(uint64_t* buf, int rows, int log_n, int l0, const Tables& t,
                                     const uint64_t* add) {
  const int log_h = log_n - l0 - W, log_items = log_n - W;
  const int items = 1 << log_items;  // per row; a power of 2, as blockDim is
  const bool wide = static_cast<int>(blockDim.x) >= items;
  const int row0 = wide ? threadIdx.x >> log_items : 0, row_step = wide ? blockDim.x >> log_items : 1;
  for (int i = threadIdx.x & (items - 1); i < items; i += blockDim.x) {
    const int g = i >> log_h;
    const int col = (g << (log_n - l0)) + (i & ((1 << log_h) - 1));
    uint64_t w[(1 << W) - 1], ws[(1 << W) - 1];
    if constexpr (kInv) {
      twiddles<W>(w, ws, t.psi_inv, t.psi_inv_s, l0, g);
    } else {
      twiddles<W>(w, ws, t.psi, t.psi_s, l0, g);
    }
    for (int row = row0; row < rows; row += row_step) {
      uint64_t* p = buf + (static_cast<size_t>(row) << log_n) + col;
      uint64_t x[1 << W];
#pragma unroll
      for (int m = 0; m < (1 << W); ++m) x[m] = p[m << log_h];
      if constexpr (kInv) {
        inv_radix<W, kLazy>(x, w, ws, t.q);
        if (l0 == 0) {
#pragma unroll
          for (int m = 0; m < (1 << W); ++m) {
            x[m] = shoup_q(x[m], t.n_inv, t.n_inv_s, t.q);
            if (add != nullptr && row == 1) x[m] = add_q(x[m], add[col + (m << log_h)], t.q);
          }
        }
      } else {
        fwd_radix<W, kLazy>(x, w, ws, t.q);
        if (kLazy && l0 + W == log_n) {
#pragma unroll
          for (int m = 0; m < (1 << W); ++m) x[m] = reduce4(x[m], t.q);
        }
      }
#pragma unroll
      for (int m = 0; m < (1 << W); ++m) p[m << log_h] = x[m];
    }
  }
}

template <bool kInv, bool kLazy>
__device__ __forceinline__ void run_pass(uint64_t* buf, int rows, int log_n, int p, const Tables& t,
                                         const uint64_t* add) {
  const int l0 = 3 * p, w = pass_width(log_n, p);
  if (w == 3) {
    pass<3, kInv, kLazy>(buf, rows, log_n, l0, t, add);
  } else if (w == 2) {
    pass<2, kInv, kLazy>(buf, rows, log_n, l0, t, add);
  } else {
    pass<1, kInv, kLazy>(buf, rows, log_n, l0, t, add);
  }
}

// The forward NTT of `rows` rows in shared memory, in place; a barrier after
// every pass. Every thread of the block calls it.
template <bool kLazy>
__device__ __forceinline__ void ntt_rows(uint64_t* buf, int rows, int log_n, const Tables& t) {
  for (int p = 0; p < pass_count(log_n); ++p) {
    run_pass<false, kLazy>(buf, rows, log_n, p, t, nullptr);
    __syncthreads();
  }
}

// The inverse NTT (with 1/N; row 1 += add where add is given), likewise.
template <bool kLazy>
__device__ __forceinline__ void intt_rows(uint64_t* buf, int rows, int log_n, const Tables& t,
                                          const uint64_t* add) {
  for (int p = pass_count(log_n) - 1; p >= 0; --p) {
    run_pass<true, kLazy>(buf, rows, log_n, p, t, add);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The Zq gadget (learn_fhe_tpu/ops/gadget.py:76-99, decompose_zq): the
// rounding shift, the centered two's-complement lift v, and v's signed
// digits in (-B/2, B/2] (for B = 2: [-1, 0]), each as a residue mod q. The
// digits of v are the unique representation of v mod B^d with digits in
// [-off, B - 1 - off], off = B/2 - 1 (1 for B = 2): digit k is field k of
// v + sum_k off B^k, less off, with no walk over the digits below it.
// Needs log_b d <= 64.
// ---------------------------------------------------------------------------

struct Gadget {
  int log_b, d, rb;
  uint64_t half, off, offsets;  // 2^(rb-1) mod q; off; sum_k off B^k
};

inline Gadget make_gadget(int log_b, int d, int rb, uint64_t half) {
  const uint64_t off = log_b >= 2 ? (1ull << (log_b - 1)) - 1ull : 1ull;
  uint64_t offsets = 0;
  for (int k = 0; k < d; ++k) offsets += off << (k * log_b);
  return Gadget{log_b, d, rb, half, off, offsets};
}

// v + offsets of a residue x: the digits are its fields.
__device__ __forceinline__ uint64_t lift(uint64_t x, const Gadget& g, uint64_t q) {
  if (g.rb) x = add_q(x, g.half, q) >> g.rb;
  return (x < (q >> 1) ? x : x - q) + g.offsets;
}

__device__ __forceinline__ uint64_t digit(uint64_t lifted, const Gadget& g, int i, uint64_t q) {
  const uint64_t field = (lifted >> (i * g.log_b)) & ((1ull << g.log_b) - 1ull);
  return sub_q(field, g.off, q);
}

// ---------------------------------------------------------------------------
// One external product or key switch of a block's RLWE ciphertext, in place.
//
// acc: a (row 0) and b (row 1) of 2^log_n values in shared memory. The key:
// `rows` rows of a and of b in the evaluation basis and the Montgomery
// domain (device memory). An external product (kSwitch false, rows = 2d)
// takes the digits of a as rows 0..d-1 and those of b as rows d..2d-1; a key
// switch (kSwitch true, rows = d) takes the digits of the source's a, where
// the source is acc gathered by `map` and negated by `sign` (the
// automorphism X -> X^t; map null: acc itself), and b += the source's b.
//
// A block takes the rows of its Share: all of them, or with kCluster, the
// rank-th of `size` near-equal runs, its cluster's blocks each holding the
// same acc. The digit rows go through `buf` (`group` rows of shared memory)
// a group at a time: the digits, their forward NTT, then the contraction,
// which adds each row's products with the key rows into 128-bit sums held
// in registers (a thread owns coefficients j = threadIdx.x + k blockDim.x
// of both outputs; it loads a row's key values for all of them before
// their products, so that their latencies overlap). Below q 2^64
// (the host checks rows (q-1)^2 < q 2^64), one REDC per output coefficient
// then gives sum_r key_r digit_r mod q, the value of the JAX package's
// Montgomery product per row and modular sum. With kCluster each block
// REDCs its own rows' sums into `part`; after a cluster barrier block c adds
// the c-th slice of the 2N coefficients over every block's part mod q
// (REDC(t1) + REDC(t2) = (t1 + t2) 2^-64 mod q) and writes the sums into
// every block's acc, through distributed shared memory; a second barrier
// ends the exchange. Last, the two inverse NTTs run in place on acc (in
// every block of a cluster). Every thread of the block (the cluster) calls
// it; it begins and ends at a barrier.
// ---------------------------------------------------------------------------

constexpr int kMaxLogN = 11;
constexpr int kThreads = 512;
constexpr int kPerThread = (1 << kMaxLogN) / kThreads;  // coefficients a thread owns
constexpr int kMaxCluster = 8;                          // the portable cluster size

struct Share {
  int rank, size;  // this block's rank in its cluster, the cluster's size
  uint64_t* part;  // kCluster: 2 rows of partial residues in shared memory
};

template <bool kSwitch, bool kLazy, bool kCluster>
__device__ __forceinline__ void phase(uint64_t* acc, uint64_t* buf, int group, uint64_t* gb, const Share& sh,
                                      int log_n, const Tables& t, const Gadget& g, int rows,
                                      const uint64_t* __restrict__ ka, const uint64_t* __restrict__ kb,
                                      const int32_t* __restrict__ map, const uint8_t* __restrict__ sign) {
  const int n = 1 << log_n;
  const uint64_t q = t.q;
  const Mod mod{q, t.neg_q_inv};
  const int first = kCluster ? sh.rank * rows / sh.size : 0;
  const int last = kCluster ? (sh.rank + 1) * rows / sh.size : rows;
  uint64_t ha[kPerThread], la[kPerThread], hb[kPerThread], lb[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) ha[k] = la[k] = hb[k] = lb[k] = 0;
  if constexpr (kSwitch) {  // the source's b, added after the inverse NTT
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      uint64_t v = acc[n + (map ? map[j] : j)];
      if (map && sign[j]) v = v ? q - v : 0;
      gb[j] = v;
    }
  }
  for (int r0 = first; r0 < last; r0 += group) {
    const int gr = min(group, last - r0);
    for (int it = threadIdx.x; it < (gr << log_n); it += blockDim.x) {
      const int r = r0 + (it >> log_n), j = it & (n - 1);
      uint64_t v;
      int i = r;
      if constexpr (kSwitch) {
        v = acc[map ? map[j] : j];
        if (map && sign[j]) v = v ? q - v : 0;
      } else {
        const bool of_b = r >= g.d;
        v = acc[(of_b ? n : 0) + j];
        i = of_b ? r - g.d : r;
      }
      buf[it] = digit(lift(v, g, q), g, i, q);
    }
    __syncthreads();
    ntt_rows<kLazy>(buf, gr, log_n, t);
#pragma unroll 2
    for (int r = 0; r < gr; ++r) {
      const size_t row = static_cast<size_t>(r0 + r) << log_n;
      uint64_t x[kPerThread], ya[kPerThread], yb[kPerThread];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int j = threadIdx.x + k * blockDim.x;
        x[k] = ya[k] = yb[k] = 0;
        if (j < n) {
          x[k] = buf[(r << log_n) + j];
          ya[k] = __ldg(ka + row + j);
          yb[k] = __ldg(kb + row + j);
        }
      }
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        mac128(ha[k], la[k], x[k], ya[k]);
        mac128(hb[k], lb[k], x[k], yb[k]);
      }
    }
    __syncthreads();  // buf is read; and acc, after the last group
  }
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int j = threadIdx.x + k * blockDim.x;
      if (j < n) {
        sh.part[j] = redc(ha[k], la[k], mod);
        sh.part[n + j] = redc(hb[k], lb[k], mod);
      }
    }
    cluster.sync();  // every block's part is written, and no block reads acc
    // this block's slice of the 2N sums, written into every block's acc
    const int end = (sh.rank + 1) * 2 * n / sh.size;
    for (int j = sh.rank * 2 * n / sh.size + threadIdx.x; j < end; j += blockDim.x) {
      uint64_t v[kMaxCluster];
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) v[c] = c < sh.size ? cluster.map_shared_rank(sh.part, c)[j] : 0;
      uint64_t sum = 0;
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) sum = add_q(sum, v[c], q);
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) {
        if (c < sh.size) cluster.map_shared_rank(acc, c)[j] = sum;
      }
    }
    cluster.sync();  // every acc holds the sums, and every part is read
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int j = threadIdx.x + k * blockDim.x;
      if (j < n) {
        acc[j] = redc(ha[k], la[k], mod);
        acc[n + j] = redc(hb[k], lb[k], mod);
      }
    }
  }
  __syncthreads();
  intt_rows<kLazy>(acc, 2, log_n, t, kSwitch ? gb : nullptr);
}

}  // namespace lft64
