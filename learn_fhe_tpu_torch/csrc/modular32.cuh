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

// Variable x variable product; off the step kernel's path.
__device__ __forceinline__ uint32_t mul_mod(uint32_t a, uint32_t b, uint32_t q) {
  return static_cast<uint32_t>(static_cast<uint64_t>(a) * b % q);
}

// Residue of a small two's-complement value (|x| < q), e.g. a gadget digit.
__device__ __forceinline__ uint32_t sign_fold(uint32_t x, uint32_t q) {
  return (x >> 31) ? x + q : x;
}

}  // namespace lft
