// Chains of K u64 operations from csrc/u64.cuh, for counting each
// operation's SASS instructions by issue pipe: the count of one operation is
// (count at K = 16 - count at K = 8) / 8. Built and read by walk64_sass.py.
#include <cuda_runtime.h>

#include <cstdint>

#include "u64.cuh"

using namespace lft64;

struct P {
  uint64_t w, ws, q, nqi, r2, offsets;
};

__device__ __forceinline__ Mod mk_mod(const P& p) { return Mod{p.q, p.nqi}; }
__device__ __forceinline__ Gadget mk_gadget(const P& p) { return Gadget{11, 5, 0, 0ull, 1023ull, p.offsets}; }

template <bool kLazy>
__device__ __forceinline__ void fwd(uint64_t& a, uint64_t& b, const P& p) {
  uint64_t x[2] = {a, b};
  const uint64_t w[1] = {p.w}, ws[1] = {p.ws};
  fwd_radix<1, kLazy>(x, w, ws, p.q);
  a = x[0];
  b = x[1];
}

template <bool kLazy>
__device__ __forceinline__ void inv(uint64_t& a, uint64_t& b, const P& p) {
  uint64_t x[2] = {a, b};
  const uint64_t w[1] = {p.w}, ws[1] = {p.ws};
  inv_radix<1, kLazy>(x, w, ws, p.q);
  a = x[0];
  b = x[1];
}

// NAME<K>: K chained BODYs on a, b (loaded per thread), INIT before them,
// OUT stored.
#define PROBE(NAME, INIT, BODY, OUT)                                     \
  template <int K>                                                       \
  __global__ void NAME(uint64_t* out, const uint64_t* in, P p) {         \
    uint64_t a = in[threadIdx.x], b = in[threadIdx.x + 1024];            \
    INIT;                                                                \
    _Pragma("unroll") for (int k = 0; k < K; ++k) { BODY; }              \
    out[threadIdx.x] = OUT;                                              \
  }                                                                      \
  template __global__ void NAME<8>(uint64_t*, const uint64_t*, P);       \
  template __global__ void NAME<16>(uint64_t*, const uint64_t*, P);

PROBE(probe_mul64_lo, , a = a * b, a)
PROBE(probe_mulhi64, , a = __umul64hi(a, b), a)
PROBE(probe_csub, , a = csub(a, p.q), a)
PROBE(probe_add_q, , a = add_q(a, b, p.q), a)
PROBE(probe_sub_q, , a = sub_q(a, b, p.q), a)
PROBE(probe_shoup_eager, , a = shoup_q(a, p.w, p.ws, p.q), a)
PROBE(probe_shoup_lazy, , a = shoup_lazy(a, p.w, p.ws, p.q), a)
PROBE(probe_redc, const Mod m = mk_mod(p), { const uint64_t r = redc(a, b, m); b = a; a = r; }, a)
PROBE(probe_mac128, uint64_t hi = 0, mac128(hi, a, a, b), a + hi)
PROBE(probe_mul_mod, const Mod m = mk_mod(p), a = mul_mod(a, b, p.r2, m), a)
PROBE(probe_bfly_fwd_eager, , fwd<false>(a, b, p), a + b)
PROBE(probe_bfly_fwd_lazy, , fwd<true>(a, b, p), a + b)
PROBE(probe_bfly_inv_eager, , inv<false>(a, b, p), a + b)
PROBE(probe_bfly_inv_lazy, , inv<true>(a, b, p), a + b)
PROBE(probe_digit, const Gadget g = mk_gadget(p), a = digit(lift(a, g, p.q), g, 2, p.q) ^ b, a)  // and a 64-bit xor
