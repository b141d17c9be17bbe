// K-BGV-DROP: BGV's exact t-corrected limb drop, on u64 residues of
// (..., L, N) tensors whose limb l is reduced mod its own prime q_l.
//
// Replaces the XLA fusion learn_fhe_tpu/models/bgv/bgv.py:176 (_drop_limb,
// with its _DropPlan tables at :154-173; no Pallas call), which BGV runs
// len(ps) times on b and a in every key switch (the division by P,
// bgv.py:197-199), and once more in every mul and mod_switch. Each drop of
// the last limb q_l computes exactly (x - d) / q_l over the kept limbs, with
// d = x (mod q_l) and d = 0 (mod t):
//   rc = x_l centered (|rc| <= q_l / 2),  k = (-rc) q_l^-1 mod t centered,
//   d = rc + q_l k,  y_i = (x_i - d) q_l^-1 = (x_i - rc) q_l^-1 - k mod q_i
// (q_l k q_l^-1 = k mod q_i, so d itself is never formed).
// The outputs are the unique residues, so this equals the JAX package bit
// for bit whatever exact arithmetic computes them.
//
// What bounds it on an H100: a column reads its L limbs and writes L - k;
// at the BGV mul's key switch (batch 16 x (b, a), N = 2^14, 8 limbs to 4)
// that is 33.6 MB read and 16.8 MB written, about 15 us at 3.35 TB/s. Each
// kept limb of each drop costs one u64 Shoup product and a few adds and
// selects: about 12 us of the SMs' integer issue at that shape, so the
// bytes bound it, the instructions close behind.
//
// The design (redesigned for the H100 from the first version's own SASS:
// 1911 instructions a column at 8 -> 4 where the bound counts 1394, PERF.md):
// - A thread takes kCols = 2 adjacent columns (16-byte words), their L limbs
//   in registers, each table word read once for both (one column a thread
//   measured no faster at 8 -> 4 and slower in the loop instances). The
//   launch is a grid of the blocks the card holds at once, each taking an
//   equal run of units of 32 threads' columns, so no short last wave (the
//   first version's 1024 blocks at the key switch's shape were 2.6 waves).
// - The steps are unrolled at the counts BGV launches (8 -> 4, the key
//   switch and the rotation's, with its add; 8 -> 3, the mul's, with the add
//   of d0 / d1 before the last drop; 4 -> 3, mod_switch): the dropped limb
//   and the kept ones are constants there. Any other (L, k, then) runs the
//   steps in a loop, the dropped limb picked by compare and select.
// - The limbs stay below 2 q_i between the drops (Harvey's lazy ranges):
//   y_i = (x_i + q_i - rc) q_l^-1 by a lazy Shoup product, + q_i - kc, one
//   conditional subtract of 2 q_i; the dropped limb is made canonical before
//   it is centered, the outputs once at the end. rc and kc are centered
//   values in two's complement, so no select picks rc or kc mod q_i.
// - The correction takes one reduction mod t a step: k = -rc q_l^-1 mod t is
//   |rc| q_l^-1 mod t, negated where rc >= 0 (|rc| q_l^-1 < t q_l / 2 <
//   2^62, the wrapper checks t max(q) < 2^63), by a Barrett constant.
// One drop at a time, since a one-shot division by the product of the
// dropped primes picks another d and would not be bit-identical. Every prime
// of the basis exceeds half of the largest (one bit length, as BgvParams
// makes them), so |rc| <= q_l / 2 < q_i, and |kc| <= t / 2 < q_i. The tables
// (per step q_l, q_l^-1 mod t, and per kept limb q_l^-1 mod q_i with its
// Shoup dual) are loaded into shared memory once a block. Where the BGV op
// adds a tensor between the drops (mul's d0 / d1 before its last drop) or
// after them (the key switch's b), the add runs in the same launch: a mod-q
// add is exact.
#include <cuda_runtime.h>

#include <cstdint>

#include "u64.cuh"

namespace {

using lft64::csub;
using lft64::shoup_lazy;

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kCols = 2;  // columns a thread takes at once
constexpr int kMaxLimbs = 16;
constexpr int kStepWords = 2 + 2 * kMaxLimbs;  // q_l, q_l^-1 mod t, then 2 words a kept limb
constexpr int kTableWords = kMaxLimbs + (kMaxLimbs - 1) * kStepWords;

struct DropParts {
  const uint64_t* x[2];
  const uint64_t* add[2];
  uint64_t* y[2];
};

// v mod t for any u64 v, by mu = floor(2^64 / t): the quotient estimate is
// at most one short.
__device__ __forceinline__ uint64_t mod_t(uint64_t v, uint64_t t, uint64_t mu) {
  const uint64_t r = v - __umul64hi(v, mu) * t;
  return r >= t ? r - t : r;
}

// A column's correction for the drop of limb value r (canonical) under q_l:
// the centered residue rc and the centered k = -rc q_l^-1 mod t, each as a
// two's complement u64.
struct Correction {
  uint64_t rc, kc;
};

__device__ __forceinline__ Correction correction(uint64_t r, uint64_t ql, uint64_t inv_ql_t, uint64_t t, uint64_t mu) {
  const bool neg = r > (ql >> 1);
  const uint64_t m = mod_t((neg ? ql - r : r) * inv_ql_t, t, mu);  // |rc| q_l^-1 mod t
  const uint64_t k = neg ? m : (m != 0 ? t - m : 0);              // -rc q_l^-1 mod t
  return Correction{neg ? r - ql : r, k > (t >> 1) ? k - t : k};
}

// (x - d) q_l^-1 mod q with d = rc + q_l kc, as (x - rc) q_l^-1 - kc (q_l kc
// q_l^-1 = kc mod q), lazily: x below 2q, the result below 2q. u = q_l^-1
// mod q, us its Shoup dual. x + q - rc lies in (0, 4q), the lazy product
// below 2q, and that + q - kc in (0, 3q + t/2) (|rc| <= q_l / 2 < q, |kc| <=
// t / 2 < q).
__device__ __forceinline__ uint64_t divide(uint64_t x, const Correction& c, uint64_t q, uint64_t u, uint64_t us) {
  return csub(shoup_lazy(x + q - c.rc, u, us, q) + q - c.kc, 2 * q);
}

// Step s on kCols columns' limbs v (each below 2 q_i): drop limb L - 1 - s.
// At a constant s every limb index is a constant; at a run-time one the
// dropped limb is picked by compare and select and the kept ones are
// predicated, so the limbs stay in registers either way. Each table word is
// read once for the thread's columns.
template <int L>
__device__ __forceinline__ void drop(uint64_t (&v)[kCols][L], int s, const volatile uint64_t* tab,
                                     const uint64_t (&q)[L], uint64_t t, uint64_t mu) {
  const int dl = L - 1 - s;
  const volatile uint64_t* st = tab + kMaxLimbs + s * kStepWords;
  const uint64_t ql = st[0], inv_ql_t = st[1];
  Correction c[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    uint64_t r = 0;
#pragma unroll
    for (int j = 1; j < L; ++j) {
      if (j == dl) r = v[k][j];
    }
    c[k] = correction(csub(r, ql), ql, inv_ql_t, t, mu);
  }
#pragma unroll
  for (int i = 0; i < L - 1; ++i) {
    if (i < dl) {
      const uint64_t u = st[2 + 2 * i], us = st[3 + 2 * i];
#pragma unroll
      for (int k = 0; k < kCols; ++k) v[k][i] = divide(v[k][i], c[k], q[i], u, us);
    }
  }
}

// Steps from..to-1 (kConst: the counts are the instance's constants, the
// steps unrolled; else a loop).
template <int L, bool kConst>
__device__ __forceinline__ void drops(uint64_t (&v)[kCols][L], const volatile uint64_t* tab, const uint64_t (&q)[L],
                                      int from, int to, uint64_t t, uint64_t mu) {
  if constexpr (kConst) {
#pragma unroll
    for (int s = from; s < to; ++s) drop<L>(v, s, tab, q, t, mu);
  } else {
#pragma unroll 1
    for (int s = from; s < to; ++s) drop<L>(v, s, tab, q, t, mu);
  }
}

// The kCols consecutive u64 at p, in 16-byte words, or into them.
static_assert(kCols % 2 == 0, "a thread's columns move in 16-byte words");

__device__ __forceinline__ void load_cols(const uint64_t* __restrict__ p, uint64_t (&w)[kCols]) {
#pragma unroll
  for (int h = 0; h < kCols / 2; ++h) {
    const ulonglong2 x = reinterpret_cast<const ulonglong2*>(p)[h];
    w[2 * h] = x.x;
    w[2 * h + 1] = x.y;
  }
}

__device__ __forceinline__ void store_cols(uint64_t* __restrict__ p, const uint64_t (&w)[kCols]) {
#pragma unroll
  for (int h = 0; h < kCols / 2; ++h) reinterpret_cast<ulonglong2*>(p)[h] = make_ulonglong2(w[2 * h], w[2 * h + 1]);
}

// y[p] (rows, L - k - then, N) from x[p] (rows, L, N): k drops, + add[p]
// (rows, L - k, N; null: none), `then` drops; parts p = 0 and, where
// `parts` is 2, 1. kK, kThen: the instance's counts (kK = 0: k and then as
// given). The columns of all parts, in units of kWarp threads' kCols
// columns, are dealt to the blocks in equal runs; a block's warps take the
// units of its run in turn, a thread kCols adjacent columns of a unit. The
// table is read through a volatile pointer, so that no word of it is held
// in a register from one unit to the next (the unrolled instances took 174
// registers so, PERF.md).
template <int L, int kK, int kThen>
__global__ void __launch_bounds__(kThreads)
    bgv_drop_kernel(DropParts p, const uint64_t* __restrict__ g_tab, int k_arg, int then_arg, int log_n,
                    long long rows, int parts, uint64_t t, uint64_t mu) {
  constexpr bool kConst = kK != 0;
  __shared__ uint64_t tab_s[kTableWords];
  const volatile uint64_t* tab = tab_s;
  const int k = kConst ? kK : k_arg, then = kConst ? kThen : then_arg;
  const int words = kMaxLimbs + (k + then) * kStepWords;
  for (int i = threadIdx.x; i < words; i += blockDim.x) tab_s[i] = g_tab[i];
  __syncthreads();
  const int mid = L - k, out = L - k - then;
  const long long cols = (rows * parts) << log_n, unit = kWarp * kCols;
  const long long units = (cols + unit - 1) / unit;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  for (long long u = units * blockIdx.x / gridDim.x + threadIdx.x / kWarp; u < u1; u += kThreads / kWarp) {
    const long long f = (u * kWarp + lane) * kCols;
    if (f >= cols) break;
    const long long grow = f >> log_n;  // row of all parts
    const bool second = grow >= rows;
    const long long row = second ? grow - rows : grow, col = f & ((1ll << log_n) - 1);
    const uint64_t* __restrict__ x = second ? p.x[1] : p.x[0];  // no indexing of the parameter array at run time
    const uint64_t* __restrict__ add = second ? p.add[1] : p.add[0];
    uint64_t* __restrict__ y = second ? p.y[1] : p.y[0];
    uint64_t q[L], v[kCols][L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      q[l] = tab[l];
      uint64_t w[kCols];
      load_cols(x + ((row * L + l) << log_n) + col, w);
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c][l] = w[c];
    }
    drops<L, kConst>(v, tab, q, 0, k, t, mu);
    if (add != nullptr) {
#pragma unroll
      for (int l = 0; l < L - 1; ++l) {
        if (l < mid) {
          uint64_t w[kCols];
          load_cols(add + ((row * mid + l) << log_n) + col, w);
#pragma unroll
          for (int c = 0; c < kCols; ++c) v[c][l] = csub(v[c][l] + w[c], 2 * q[l]);  // below 3 q, then 2 q
        }
      }
    }
    drops<L, kConst>(v, tab, q, k, k + then, t, mu);
#pragma unroll
    for (int l = 0; l < L - 1; ++l) {
      if (l < out) {
        uint64_t w[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) w[c] = csub(v[c][l], q[l]);
        store_cols(y + ((row * out + l) << log_n) + col, w);
      }
    }
  }
}

// A kernel instance and the blocks of it the card holds at once.
struct Instance {
  void* kernel;
  int (*resident)();
};

template <int L, int kK, int kThen>
int resident_blocks() {
  static const int blocks = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bgv_drop_kernel<L, kK, kThen>, kThreads, 0);
    return per_sm * sms;
  }();
  return blocks;
}

template <int L, int kK = 0, int kThen = 0>
Instance instance() {
  return Instance{reinterpret_cast<void*>(bgv_drop_kernel<L, kK, kThen>), resident_blocks<L, kK, kThen>};
}

// The unrolled instances at BGV's counts, else the loop's for L limbs.
template <int... Ls>
Instance pick(int limbs, int k, int then) {
  if (limbs == 8 && k == 4 && then == 0) return instance<8, 4, 0>();
  if (limbs == 8 && k == 4 && then == 1) return instance<8, 4, 1>();
  if (limbs == 4 && k == 1 && then == 0) return instance<4, 1, 0>();
  Instance out{nullptr, nullptr};
  ((limbs == Ls ? (out = instance<Ls>(), 0) : 0), ...);
  return out;
}

}  // namespace

extern "C" {

// x0, x1 (null: one part), add0, add1 (either null: no add for that part),
// y0, y1: each part's (rows, limbs, 2^log_n) input, (rows, limbs - k, N) add
// and (rows, limbs - k - then, N) output, 16-byte aligned; tab: the drop
// table (ops/rns.py::_drop_table) of k + then steps; t < 2^32 and
// mu = floor(2^64 / t).
int lft_bgv_drop(const void* x0, const void* x1, const void* add0, const void* add1, void* y0, void* y1,
                 const void* tab, int limbs, int k, int then, int log_n, long long rows, unsigned long long t,
                 unsigned long long mu, void* stream) {
  if (limbs < 2 || limbs > kMaxLimbs || k < 1 || then < 0 || k + then >= limbs || log_n < 1 || log_n > 30 ||
      rows < 1 || rows > (1ll << 32) || x0 == nullptr || y0 == nullptr || (x1 == nullptr) != (y1 == nullptr) ||
      t < 2 || t >= (1ull << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  DropParts p{{static_cast<const uint64_t*>(x0), static_cast<const uint64_t*>(x1)},
              {static_cast<const uint64_t*>(add0), static_cast<const uint64_t*>(add1)},
              {static_cast<uint64_t*>(y0), static_cast<uint64_t*>(y1)}};
  int parts = x1 != nullptr ? 2 : 1;
  const Instance in = pick<2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16>(limbs, k, then);
  const long long blocks = (((rows * parts) << log_n) + kThreads * kCols - 1) / (kThreads * kCols);
  const int resident = in.resident();
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks < resident ? blocks : resident), 1, 1);
  const uint64_t* g_tab = static_cast<const uint64_t*>(tab);
  void* args[] = {&p, &g_tab, &k, &then, &log_n, &rows, &parts, &t, &mu};
  const cudaError_t err = cudaLaunchKernel(in.kernel, grid, dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
