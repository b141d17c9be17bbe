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

// The step kernel's cluster has a block per prime, and it keeps a
// coefficient's residues in registers: it takes at most kMaxPrimes.
constexpr int kMaxPrimes = 4;
// The width of the host layout (TorusCrtPlan.kernel_consts), and the most
// primes K-GARNER takes (the pow2 ring product at log_q = 64 needs 5).
constexpr int kCrtSlots = 5;

// One CRT plan's constants for up to M primes, passed to kernels by value.
template <int M>
struct CrtConstsOf {
  int k;
  uint32_t q[M];
  uint32_t n_inv[M];    // the NTT's 1/n mod q_i and its Shoup dual
  uint32_t n_inv_s[M];
  uint32_t half[M];     // mixed-radix digits of (Q-1)/2
  uint64_t prefix[M];   // prod_{j<i} q_j mod 2^64
  uint64_t q_mod;       // Q mod 2^64
  uint32_t inv[M][M];    // q_j^-1 mod q_i, j < i
  uint32_t inv_s[M][M];  // its Shoup dual
};

using CrtConsts = CrtConstsOf<kMaxPrimes>;

// Reads the first M primes' slots of the host array laid out by
// TorusCrtPlan.kernel_consts: k, then q, n_inv, n_inv_s, half and prefix at
// 1 + t * kCrtSlots + i, Q mod 2^64, then inv and inv_s at
// 2 + 5 * kCrtSlots (+ kCrtSlots^2) + kCrtSlots * i + j. The caller checks
// k <= M.
template <int M = kMaxPrimes>
inline CrtConstsOf<M> load_crt_consts(const unsigned long long* c) {
  static_assert(M <= kCrtSlots, "the host layout holds kCrtSlots primes");
  constexpr int w = kCrtSlots;
  constexpr int inv_at = 2 + 5 * w;
  CrtConstsOf<M> g{};
  g.k = static_cast<int>(c[0]);
  for (int i = 0; i < M; ++i) {
    g.q[i] = static_cast<uint32_t>(c[1 + i]);
    g.n_inv[i] = static_cast<uint32_t>(c[1 + w + i]);
    g.n_inv_s[i] = static_cast<uint32_t>(c[1 + 2 * w + i]);
    g.half[i] = static_cast<uint32_t>(c[1 + 3 * w + i]);
    g.prefix[i] = c[1 + 4 * w + i];
    for (int j = 0; j < M; ++j) {
      g.inv[i][j] = static_cast<uint32_t>(c[inv_at + w * i + j]);
      g.inv_s[i][j] = static_cast<uint32_t>(c[inv_at + w * w + w * i + j]);
    }
  }
  g.q_mod = c[1 + 5 * w];
  return g;
}

// c[i]: the coefficient's residue mod q_i (i < g.k); returns its u64 value.
template <int M>
__device__ __forceinline__ uint64_t garner(const uint32_t (&c)[M], const CrtConstsOf<M>& g) {
  uint32_t v[M] = {};
  uint64_t value = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
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
  for (int i = 0; i < M; ++i) {
    if (i < g.k) over = v[i] > g.half[i] || (v[i] == g.half[i] && over);
  }
  return over ? value - g.q_mod : value;
}

}  // namespace lft
