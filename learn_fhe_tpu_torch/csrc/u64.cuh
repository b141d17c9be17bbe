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
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace lft64 {

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

// a * w mod q for a constant w < q with its Shoup dual ws: a w - floor(a ws /
// 2^64) q lies in [0, 2q) for any a < 2^64 when q < 2^63.
__device__ __forceinline__ uint64_t shoup_q(uint64_t a, uint64_t w, uint64_t ws, uint64_t q) {
  return csub(a * w - __umul64hi(a, ws) * q, q);
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

template <int W>
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
        const uint64_t v = shoup_q(x[a + half], w[(1 << t) - 1 + u], ws[(1 << t) - 1 + u], q);
        x[a + half] = sub_q(x[a], v, q);
        x[a] = add_q(x[a], v, q);
      }
    }
  }
}

template <int W>
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
        x[a] = add_q(x0, x1, q);
        x[a + half] = shoup_q(sub_q(x0, x1, q), w[(1 << t) - 1 + u], ws[(1 << t) - 1 + u], q);
      }
    }
  }
}

// One pass of W layers from l0 over `rows` rows of 2^log_n values at buf
// (row r at buf + (r << log_n)), the items spread over the block's threads.
// With kInv, the inverse layers; at l0 = 0 they end with the 1/N scale and,
// where add is given, row 1 += add (the key switch's b). No barrier.
template <int W, bool kInv>
__device__ __forceinline__ void pass(uint64_t* buf, int rows, int log_n, int l0, const Tables& t,
                                     const uint64_t* add) {
  const int log_h = log_n - l0 - W, log_items = log_n - W;
  const int items = rows << log_items;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int row = it >> log_items, i = it & ((1 << log_items) - 1);
    const int g = i >> log_h;
    const int col = (g << (log_n - l0)) + (i & ((1 << log_h) - 1));
    uint64_t* p = buf + (static_cast<size_t>(row) << log_n) + col;
    uint64_t x[1 << W], w[(1 << W) - 1], ws[(1 << W) - 1];
#pragma unroll
    for (int m = 0; m < (1 << W); ++m) x[m] = p[m << log_h];
    if constexpr (kInv) {
      twiddles<W>(w, ws, t.psi_inv, t.psi_inv_s, l0, g);
      inv_radix<W>(x, w, ws, t.q);
      if (l0 == 0) {
#pragma unroll
        for (int m = 0; m < (1 << W); ++m) {
          x[m] = shoup_q(x[m], t.n_inv, t.n_inv_s, t.q);
          if (add != nullptr && row == 1) x[m] = add_q(x[m], add[col + (m << log_h)], t.q);
        }
      }
    } else {
      twiddles<W>(w, ws, t.psi, t.psi_s, l0, g);
      fwd_radix<W>(x, w, ws, t.q);
    }
#pragma unroll
    for (int m = 0; m < (1 << W); ++m) p[m << log_h] = x[m];
  }
}

template <bool kInv>
__device__ __forceinline__ void run_pass(uint64_t* buf, int rows, int log_n, int p, const Tables& t,
                                         const uint64_t* add) {
  const int l0 = 3 * p, w = pass_width(log_n, p);
  if (w == 3) {
    pass<3, kInv>(buf, rows, log_n, l0, t, add);
  } else if (w == 2) {
    pass<2, kInv>(buf, rows, log_n, l0, t, add);
  } else {
    pass<1, kInv>(buf, rows, log_n, l0, t, add);
  }
}

// The forward NTT of `rows` rows in shared memory, in place; a barrier after
// every pass. Every thread of the block calls it.
__device__ __forceinline__ void ntt_rows(uint64_t* buf, int rows, int log_n, const Tables& t) {
  for (int p = 0; p < pass_count(log_n); ++p) {
    run_pass<false>(buf, rows, log_n, p, t, nullptr);
    __syncthreads();
  }
}

// The inverse NTT (with 1/N; row 1 += add where add is given), likewise.
__device__ __forceinline__ void intt_rows(uint64_t* buf, int rows, int log_n, const Tables& t,
                                          const uint64_t* add) {
  for (int p = pass_count(log_n) - 1; p >= 0; --p) {
    run_pass<true>(buf, rows, log_n, p, t, add);
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
// The digit rows go through `buf` (`group` rows of shared memory) a group at
// a time: the digits, their forward NTT, then the contraction, which adds
// each row's products with the key rows into 128-bit sums held in registers
// (a thread owns coefficients j = threadIdx.x + k blockDim.x of both
// outputs). Below q 2^64 (the host checks rows (q-1)^2 < q 2^64), one REDC
// per output coefficient then gives sum_r key_r digit_r mod q, the value of
// the JAX package's Montgomery product per row and modular sum. Last, the
// two inverse NTTs run in place on acc. Every thread of the block calls it;
// it begins and ends at a barrier.
// ---------------------------------------------------------------------------

constexpr int kMaxLogN = 11;
constexpr int kThreads = 512;
constexpr int kPerThread = (1 << kMaxLogN) / kThreads;  // coefficients a thread owns

template <bool kSwitch>
__device__ __forceinline__ void phase(uint64_t* acc, uint64_t* buf, int group, uint64_t* gb, int log_n,
                                      const Tables& t, const Gadget& g, int rows, const uint64_t* __restrict__ ka,
                                      const uint64_t* __restrict__ kb, const int32_t* __restrict__ map,
                                      const uint8_t* __restrict__ sign) {
  const int n = 1 << log_n;
  const uint64_t q = t.q;
  const Mod mod{q, t.neg_q_inv};
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
  for (int r0 = 0; r0 < rows; r0 += group) {
    const int gr = min(group, rows - r0);
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
    ntt_rows(buf, gr, log_n, t);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int j = threadIdx.x + k * blockDim.x;
      if (j < n) {
        for (int r = 0; r < gr; ++r) {
          const uint64_t x = buf[(r << log_n) + j];
          const size_t at = (static_cast<size_t>(r0 + r) << log_n) + j;
          mac128(ha[k], la[k], x, __ldg(ka + at));
          mac128(hb[k], lb[k], x, __ldg(kb + at));
        }
      }
    }
    __syncthreads();  // buf is read; and acc, after the last group
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < n) {
      acc[j] = redc(ha[k], la[k], mod);
      acc[n + j] = redc(hb[k], lb[k], mod);
    }
  }
  __syncthreads();
  intt_rows(acc, 2, log_n, t, kSwitch ? gb : nullptr);
}

}  // namespace lft64
