// Negacyclic NTT of rows held in shared memory, for primes q < 2^31.
//
// The merged-twist transform of learn_fhe_tpu/ops/ntt32.py: the forward
// (Cooley-Tukey, layer 0 first) takes normal order to bit-reversed order, the
// inverse (Gentleman-Sande, last layer first, then the 1/n scale) takes it
// back. Layer L has m = 2^L groups of 2*half values, half = n >> (L+1); group
// g uses twiddle psi[m + g] from the plan's bit-reversed table. The results
// are bit-identical to the JAX package's radix-8/4/2 passes, since every
// operation is exact mod q.
//
// ntt_fwd_rows / ntt_inv_rows run each butterfly layer as one strided loop
// over all threads of the block followed by __syncthreads(); the whole block
// must call them (K-NTT, K-POLYMUL). The step kernel instead runs passes of
// up to 3 layers on values held in registers (fwd_radix / inv_radix below),
// with one barrier per pass.
#pragma once

#include <cstdint>

#include "modular32.cuh"

namespace lft {

// In place on `rows` consecutive rows of n = 2^log_n values; ends synchronised.
__device__ __forceinline__ void ntt_fwd_rows(uint32_t* x, int rows, int log_n,
                                             const uint32_t* __restrict__ psi,
                                             const uint32_t* __restrict__ psi_s, uint32_t q) {
  const int half_n = 1 << (log_n - 1);
  const int total = rows * half_n;
  for (int layer = 0; layer < log_n; ++layer) {
    const int shift = log_n - 1 - layer;  // half = 1 << shift
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int j = t & (half_n - 1);
      const int g = j >> shift;
      uint32_t* row = x + ((t >> (log_n - 1)) << log_n);
      const int iu = (g << (shift + 1)) + (j & ((1 << shift) - 1));
      const int iv = iu + (1 << shift);
      const int w = (1 << layer) + g;
      const uint32_t u = row[iu];
      const uint32_t tv = mul_shoup(row[iv], psi[w], psi_s[w], q);
      row[iu] = add_mod(u, tv, q);
      row[iv] = sub_mod(u, tv, q);
    }
    __syncthreads();
  }
}

// In place, including the scale by n^-1; ends synchronised.
__device__ __forceinline__ void ntt_inv_rows(uint32_t* x, int rows, int log_n,
                                             const uint32_t* __restrict__ psi_inv,
                                             const uint32_t* __restrict__ psi_inv_s, uint32_t q,
                                             uint32_t n_inv, uint32_t n_inv_s) {
  const int half_n = 1 << (log_n - 1);
  const int total = rows * half_n;
  for (int layer = log_n - 1; layer >= 0; --layer) {
    const int shift = log_n - 1 - layer;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int j = t & (half_n - 1);
      const int g = j >> shift;
      uint32_t* row = x + ((t >> (log_n - 1)) << log_n);
      const int iu = (g << (shift + 1)) + (j & ((1 << shift) - 1));
      const int iv = iu + (1 << shift);
      const int w = (1 << layer) + g;
      const uint32_t u = row[iu];
      const uint32_t v = row[iv];
      row[iu] = add_mod(u, v, q);
      row[iv] = mul_shoup(sub_mod(u, v, q), psi_inv[w], psi_inv_s[w], q);
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < (rows << log_n); t += blockDim.x) {
    x[t] = mul_shoup(x[t], n_inv, n_inv_s, q);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Register passes. A pass runs W <= 3 consecutive layers l0 .. l0+W-1 on the
// 2^W values that those layers combine: with log_h = log_n - l0 - W, the
// values of index (hi << (log_n - l0)) + (m << log_h) + lo for m < 2^W, one
// (hi, lo) per thread. Within the pass, layer l0+t pairs m and m + 2^(W-1-t)
// in group u = m >> (W-t) and takes twiddle (1 << (l0+t)) + (hi << t) + u of
// the bit-reversed table; a pass's 2^W - 1 twiddles are loaded once, in the
// order t = 0.., u = 0.., by pass_twiddles from a copy of the table in
// shared memory.
// ---------------------------------------------------------------------------

template <int W>
__device__ __forceinline__ void pass_twiddles(uint32_t (&w)[(1 << W) - 1],
                                              uint32_t (&ws)[(1 << W) - 1],
                                              const uint32_t* __restrict__ tab,
                                              const uint32_t* __restrict__ tab_s, int l0, int hi) {
#pragma unroll
  for (int t = 0; t < W; ++t) {
#pragma unroll
    for (int u = 0; u < (1 << t); ++u) {
      const int idx = (1 << (l0 + t)) + (hi << t) + u;
      w[(1 << t) - 1 + u] = tab[idx];
      ws[(1 << t) - 1 + u] = tab_s[idx];
    }
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
// bits 5-7. Every pass of the step kernel then reaches 32 distinct banks per
// warp (for log_h = 2 the warp's 8 values of hi spread over bits 2-4), and
// a run of 4 values starting at a multiple of 4 stays 4 contiguous, 16-byte
// aligned slots. It is its own inverse on any multiple of 32 values.
__device__ __forceinline__ int swizzle(int i) { return i ^ (((i >> 5) & 7) << 2); }

}  // namespace lft
