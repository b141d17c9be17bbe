// Garner reconstruction of CRT residues to wrapping u64 torus values.
//
// Device counterpart of learn_fhe_tpu/ops/torus_crt.py:210-263
// (garner_to_u64): the mixed-radix walk v_i = (c_i - v_0 - v_1 q_0 - ...) /
// (q_0 ... q_{i-1}) mod q_i with Shoup constants, the recombination
// sum v_i * prod_{j<i} q_j mod 2^64, and the centered lift that subtracts Q
// when (v_{k-1}, ..., v_0) exceeds the mixed-radix digits of (Q-1)/2. The JAX
// package emulates the 64-bit sums on u32 limb planes; here they are native
// uint64_t. Bit-identical to it for every input.
#pragma once

#include <cstdint>

#include "modular32.cuh"

namespace lft {

constexpr int kMaxPrimes = 4;

// One CRT plan's constants, passed to kernels by value.
struct CrtConsts {
  int k;
  uint32_t q[kMaxPrimes];
  uint32_t n_inv[kMaxPrimes];    // the NTT's 1/n mod q_i and its Shoup dual
  uint32_t n_inv_s[kMaxPrimes];
  uint32_t half[kMaxPrimes];     // mixed-radix digits of (Q-1)/2
  uint64_t prefix[kMaxPrimes];   // prod_{j<i} q_j mod 2^64
  uint64_t q_mod;                // Q mod 2^64
  uint32_t inv[kMaxPrimes][kMaxPrimes];    // q_j^-1 mod q_i, j < i
  uint32_t inv_s[kMaxPrimes][kMaxPrimes];  // its Shoup dual
};

// Reads the host array laid out by TorusCrtPlan.kernel_consts.
inline CrtConsts load_crt_consts(const unsigned long long* c) {
  CrtConsts g{};
  g.k = static_cast<int>(c[0]);
  for (int i = 0; i < kMaxPrimes; ++i) {
    g.q[i] = static_cast<uint32_t>(c[1 + i]);
    g.n_inv[i] = static_cast<uint32_t>(c[5 + i]);
    g.n_inv_s[i] = static_cast<uint32_t>(c[9 + i]);
    g.half[i] = static_cast<uint32_t>(c[13 + i]);
    g.prefix[i] = c[17 + i];
    for (int j = 0; j < kMaxPrimes; ++j) {
      g.inv[i][j] = static_cast<uint32_t>(c[22 + kMaxPrimes * i + j]);
      g.inv_s[i][j] = static_cast<uint32_t>(c[22 + kMaxPrimes * kMaxPrimes + kMaxPrimes * i + j]);
    }
  }
  g.q_mod = c[21];
  return g;
}

// c[i]: the coefficient's residue mod q_i (i < g.k); returns its u64 value.
__device__ __forceinline__ uint64_t garner(const uint32_t (&c)[kMaxPrimes], const CrtConsts& g) {
  uint32_t v[kMaxPrimes] = {0, 0, 0, 0};
  uint64_t value = 0;
#pragma unroll
  for (int i = 0; i < kMaxPrimes; ++i) {
    if (i < g.k) {
      const uint32_t qi = g.q[i];
      uint32_t t = c[i];
#pragma unroll
      for (int j = 0; j < i; ++j) {
        const uint32_t vj = v[j] >= qi ? v[j] - qi : v[j];  // q_j < 2 q_i
        t = mul_shoup(sub_mod(t, vj, qi), g.inv[i][j], g.inv_s[i][j], qi);
      }
      v[i] = t;
      value += static_cast<uint64_t>(t) * g.prefix[i];
    }
  }
  bool over = false;
#pragma unroll
  for (int i = 0; i < kMaxPrimes; ++i) {
    if (i < g.k) over = v[i] > g.half[i] || (v[i] == g.half[i] && over);
  }
  return over ? value - g.q_mod : value;
}

}  // namespace lft
