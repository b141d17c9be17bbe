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
// Each butterfly layer is one strided loop over all threads of the block
// followed by __syncthreads(); the whole block must call these functions.
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

}  // namespace lft
