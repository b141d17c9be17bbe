// Arithmetic mod primes q < 2^31 on u32, for the port's kernels.
//
// Device counterpart of learn_fhe_tpu/ops/modular32.py: every function takes
// reduced residues and returns a reduced residue. A constant multiplier w
// comes with its Shoup dual w' = floor(w * 2^32 / q), so a * w mod q costs
// one __umulhi and two low multiplies (exact for any a < 2^32 since 2q < 2^32).
#pragma once

#include <cstdint>

namespace lft {

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + (q - b);
}

__device__ __forceinline__ uint32_t mul_shoup(uint32_t a, uint32_t w, uint32_t w_shoup, uint32_t q) {
  const uint32_t r = a * w - __umulhi(a, w_shoup) * q;
  return r >= q ? r - q : r;
}

// The coefficient-sharded transform's forward cross-shard layer on one pair
// (parallel/coef32.py): x this rank's value, v its partner's, t the layer's
// twiddle with its Shoup dual, all below q; upper ? v - t x : x + t v.
__device__ __forceinline__ uint32_t cross_fwd(uint32_t x, uint32_t v, uint32_t t, uint32_t ts, uint32_t q,
                                              bool upper) {
  return upper ? sub_mod(v, mul_shoup(x, t, ts, q), q) : add_mod(x, mul_shoup(v, t, ts, q), q);
}

// Variable x variable product, with no division: a*b = hi * 2^32 + lo, and
// 2^32 = r32 (mod q), so a*b = hi * r32 + lo (mod q), hi < 2^30. Takes r32 =
// 2^32 mod q with its Shoup dual; exact for 2^30 < q < 2^31, where lo < 2^32
// < 4q falls into [0, q) after at most two conditional subtracts.
__device__ __forceinline__ uint32_t mul_fold(uint32_t a, uint32_t b, uint32_t r32, uint32_t r32_s,
                                             uint32_t q) {
  uint32_t lo = a * b;
  lo = lo >= 2 * q ? lo - 2 * q : lo;
  lo = lo >= q ? lo - q : lo;
  return add_mod(mul_shoup(__umulhi(a, b), r32, r32_s, q), lo, q);
}

// Residue of a small two's-complement value (|x| < q), e.g. a gadget digit.
__device__ __forceinline__ uint32_t sign_fold(uint32_t x, uint32_t q) {
  return (x >> 31) ? x + q : x;
}

}  // namespace lft
