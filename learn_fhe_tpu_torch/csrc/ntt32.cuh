// Negacyclic NTT passes on values held in registers, for primes q < 2^31.
//
// The merged-twist transform of learn_fhe_tpu/ops/ntt32.py: the forward
// (Cooley-Tukey, layer 0 first) takes normal order to bit-reversed order, the
// inverse (Gentleman-Sande, last layer first, then the 1/n scale) takes it
// back. Layer L has m = 2^L groups of 2*half values, half = n >> (L+1); group
// g uses twiddle psi[m + g] from the plan's bit-reversed table. The results
// are bit-identical to the JAX package's radix-8/4/2 passes, since every
// operation is exact mod q.
//
// The kernels (K-NTT, K-POLYMUL, K-STEP) run the layers in passes of up to 3
// on values held in registers, with one barrier per pass; between passes the
// values wait in a swizzled buffer of shared memory. The schedule is the
// JAX package's radix-8 one: [3, 3, 3, 2] layers at N=2048.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "modular32.cuh"

namespace lft {

// Passes of the forward schedule for ring 2^log_n: pass p runs layers 3p ..
// 3p+2, the last pass the remaining 1 to 3.
__host__ __device__ constexpr int pass_count(int log_n) { return (log_n + 2) / 3; }
__host__ __device__ constexpr int pass_width(int log_n, int p) {
  return p == pass_count(log_n) - 1 ? log_n - 3 * p : 3;
}

// ---------------------------------------------------------------------------
// Register passes. A pass runs W <= 3 consecutive layers l0 .. l0+W-1 on the
// 2^W values that those layers combine: with log_h = log_n - l0 - W, the
// values of index (hi << (log_n - l0)) + (m << log_h) + lo for m < 2^W, one
// (hi, lo) per thread. Within the pass, layer l0+t pairs m and m + 2^(W-1-t)
// in group u = m >> (W-t) and takes twiddle (1 << (l0+t)) + (hi << t) + u of
// the bit-reversed table; a pass's 2^W - 1 twiddles are loaded once, in the
// order t = 0.., u = 0.., by pass_twiddles: from device memory through the
// read-only cache (kGlobal), or from a copy of the table in shared memory.
// ---------------------------------------------------------------------------

template <int W, bool kGlobal = false>
__device__ __forceinline__ void pass_twiddles(uint32_t (&w)[(1 << W) - 1],
                                              uint32_t (&ws)[(1 << W) - 1],
                                              const uint32_t* __restrict__ tab,
                                              const uint32_t* __restrict__ tab_s, int l0, int hi) {
#pragma unroll
  for (int t = 0; t < W; ++t) {
#pragma unroll
    for (int u = 0; u < (1 << t); ++u) {
      const int idx = (1 << (l0 + t)) + (hi << t) + u;
      if constexpr (kGlobal) {
        w[(1 << t) - 1 + u] = __ldg(tab + idx);
        ws[(1 << t) - 1 + u] = __ldg(tab_s + idx);
      } else {
        w[(1 << t) - 1 + u] = tab[idx];
        ws[(1 << t) - 1 + u] = tab_s[idx];
      }
    }
  }
}

// C contiguous words from device memory through the read-only cache, in one
// load (src aligned to 4 C bytes).
template <int C>
__device__ __forceinline__ void load_words(uint32_t* dst, const uint32_t* __restrict__ src) {
  if constexpr (C == 1) {
    dst[0] = __ldg(src);
  } else if constexpr (C == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
    dst[0] = v.x, dst[1] = v.y;
  } else {
    static_assert(C == 4, "one load takes 1, 2 or 4 words");
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  }
}

// pass_twiddles' values, in its order, from device memory in wide loads:
// layer l0+t's 2^t twiddles of an item are contiguous at (1 << (l0+t)) +
// (hi << t), a multiple of 2^t, so with the tables 16-byte aligned layer
// l0+1's are one 8-byte load and layer l0+2's one 16-byte load (3 loads of
// a table for a radix-8 item, not 7).
template <int W>
__device__ __forceinline__ void pass_twiddles_wide(uint32_t (&w)[(1 << W) - 1],
                                                   uint32_t (&ws)[(1 << W) - 1],
                                                   const uint32_t* __restrict__ tab,
                                                   const uint32_t* __restrict__ tab_s, int l0, int hi) {
  static_assert(W >= 1 && W <= 3, "a pass runs 1 to 3 layers");
  load_words<1>(w, tab + (1 << l0) + hi);
  load_words<1>(ws, tab_s + (1 << l0) + hi);
  if constexpr (W > 1) {
    load_words<2>(w + 1, tab + (2 << l0) + (hi << 1));
    load_words<2>(ws + 1, tab_s + (2 << l0) + (hi << 1));
  }
  if constexpr (W > 2) {
    load_words<4>(w + 3, tab + (4 << l0) + (hi << 2));
    load_words<4>(ws + 3, tab_s + (4 << l0) + (hi << 2));
  }
}

// Forward (Cooley-Tukey) layers of one pass, in place on x.
template <int W>
__device__ __forceinline__ void fwd_radix(uint32_t (&x)[1 << W], const uint32_t (&w)[(1 << W) - 1],
                                          const uint32_t (&ws)[(1 << W) - 1], uint32_t q) {
#pragma unroll
  for (int t = 0; t < W; ++t) {
    const int half = 1 << (W - 1 - t);
#pragma unroll
    for (int u = 0; u < (1 << t); ++u) {
      const int tw = (1 << t) - 1 + u;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const int a = 2 * half * u + j;
        const uint32_t v = mul_shoup(x[a + half], w[tw], ws[tw], q);
        x[a + half] = sub_mod(x[a], v, q);
        x[a] = add_mod(x[a], v, q);
      }
    }
  }
}

// Inverse (Gentleman-Sande) layers of one pass, last layer first, in place.
template <int W>
__device__ __forceinline__ void inv_radix(uint32_t (&x)[1 << W], const uint32_t (&w)[(1 << W) - 1],
                                          const uint32_t (&ws)[(1 << W) - 1], uint32_t q) {
#pragma unroll
  for (int t = W - 1; t >= 0; --t) {
    const int half = 1 << (W - 1 - t);
#pragma unroll
    for (int u = 0; u < (1 << t); ++u) {
      const int tw = (1 << t) - 1 + u;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const int a = 2 * half * u + j;
        const uint32_t x0 = x[a];
        const uint32_t x1 = x[a + half];
        x[a] = add_mod(x0, x1, q);
        x[a + half] = mul_shoup(sub_mod(x0, x1, q), w[tw], ws[tw], q);
      }
    }
  }
}

// Shared-memory slot of value i of a block's rows: bits 2-4 of i XORed with
// bits 5-7. Every pass then reaches 32 distinct banks per warp (for log_h =
// 2 the warp's 8 values of hi spread over bits 2-4), and a run of 4 values
// starting at a multiple of 4 stays 4 contiguous, 16-byte aligned slots. It
// is its own inverse on any multiple of 32 values.
__device__ __forceinline__ int swizzle(int i) { return i ^ (((i >> 5) & 7) << 2); }

// R contiguous values from device memory through the read-only cache,
// 16-byte aligned when R >= 4.
template <int R>
__device__ __forceinline__ void load_global(uint32_t (&x)[R], const uint32_t* __restrict__ p) {
  if constexpr (R >= 4) {
#pragma unroll
    for (int c = 0; c < R; c += 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + c));
      x[c] = v.x, x[c + 1] = v.y, x[c + 2] = v.z, x[c + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < R; ++m) x[m] = __ldg(p + m);
  }
}

// The pass's values of one row from (store: to) the swizzled buffer.
template <int W, int LOG_H>
__device__ __forceinline__ void load_row(uint32_t (&x)[1 << W], const uint32_t* buf, int base) {
  constexpr int R = 1 << W;
  if constexpr (R >= 4 && LOG_H == 0) {  // R contiguous values: 16-byte loads
#pragma unroll
    for (int c = 0; c < R; c += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(buf + swizzle(base + c));
      x[c] = v.x, x[c + 1] = v.y, x[c + 2] = v.z, x[c + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < R; ++m) x[m] = buf[swizzle(base + (m << LOG_H))];
  }
}

template <int W, int LOG_H>
__device__ __forceinline__ void store_row(const uint32_t (&x)[1 << W], uint32_t* buf, int base) {
  constexpr int R = 1 << W;
  if constexpr (R >= 4 && LOG_H == 0) {
#pragma unroll
    for (int c = 0; c < R; c += 4) {
      *reinterpret_cast<uint4*>(buf + swizzle(base + c)) = make_uint4(x[c], x[c + 1], x[c + 2], x[c + 3]);
    }
  } else {
#pragma unroll
    for (int m = 0; m < R; ++m) buf[swizzle(base + (m << LOG_H))] = x[m];
  }
}

// The same pass values' slots from swizzle(base) alone. The pass's values
// are base + (m << LOG_H) with base's bits LOG_H .. LOG_H+W-1 zero, and
// swizzle is linear in XOR on disjoint bits, so value m's slot is
// swizzle(base) ^ K_m, K_m = swizzle(m << LOG_H) a constant. The bits of K_m
// that swizzle(base) cannot hold (base's zero field, outside bits 2-4) are
// added, which a shared access takes as its immediate offset; the others
// are XORed: at most one instruction a value, not a swizzle each.
__host__ __device__ constexpr int slot_bits(int log_h, int w) {  // bits swizzle(base) may hold
  return ((1 << log_h) - 1) | (7 << 2) | ~((1 << (log_h + w)) - 1);
}
template <int W, int LOG_H>
__device__ __forceinline__ int slot(int s, int m) {
  const int k = (m << LOG_H) ^ ((((m << LOG_H) >> 5) & 7) << 2);
  return (s ^ (k & slot_bits(LOG_H, W))) + (k & ~slot_bits(LOG_H, W));
}

template <int W, int LOG_H>
__device__ __forceinline__ void load_slots(uint32_t (&x)[1 << W], const uint32_t* buf, int s) {
  constexpr int R = 1 << W;
  if constexpr (R >= 4 && LOG_H == 0) {
#pragma unroll
    for (int c = 0; c < R; c += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(buf + slot<W, 0>(s, c));
      x[c] = v.x, x[c + 1] = v.y, x[c + 2] = v.z, x[c + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < R; ++m) x[m] = buf[slot<W, LOG_H>(s, m)];
  }
}

template <int W, int LOG_H>
__device__ __forceinline__ void store_slots(const uint32_t (&x)[1 << W], uint32_t* buf, int s) {
  constexpr int R = 1 << W;
  if constexpr (R >= 4 && LOG_H == 0) {
#pragma unroll
    for (int c = 0; c < R; c += 4) {
      *reinterpret_cast<uint4*>(buf + slot<W, 0>(s, c)) = make_uint4(x[c], x[c + 1], x[c + 2], x[c + 3]);
    }
  } else {
#pragma unroll
    for (int m = 0; m < R; ++m) buf[slot<W, LOG_H>(s, m)] = x[m];
  }
}

}  // namespace lft
