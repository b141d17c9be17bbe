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
// kept limb of each drop costs one u64 Shoup product, two subtracts and two
// selects (some 50 32-bit instructions), and at that shape the integer
// instruction rate, about 22 us, bounds it more than the bytes.
//
// The design (a simple first kernel): a thread takes two adjacent columns of
// one part (b or a) in 16-byte words, holds their L limbs in registers (an
// instance per L = 2..16, every limb index a constant after unrolling; the
// steps a loop, the dropped limb picked by compare and select: the first
// version unrolled the steps too and spilled from L = 7) and runs the drops
// in sequence there: one drop at a time, since a one-shot
// division by the product of the dropped primes picks another d and would
// not be bit-identical. Every prime of the basis exceeds half of the largest
// (one bit length, as BgvParams makes them), so a centered residue and a
// centered k are brought into [0, q_i) by one conditional add; mod t goes
// by a Barrett constant, never a 64-bit division. The tables (per step q_l,
// q_l^-1 mod t, and per kept limb q_l^-1 mod q_i with its Shoup dual) are
// loaded into shared memory once a block. Where the BGV op adds a tensor
// between the drops (mul's d0 / d1 before its last drop) or after them (the
// key switch's b), the add runs in the same launch: a mod-q add is exact.
#include <cuda_runtime.h>

#include <cstdint>

#include "u64.cuh"

namespace {

using lft64::add_q;
using lft64::shoup_q;
using lft64::sub_q;

constexpr int kThreads = 256;
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

// A column's correction for the drop of limb value r under q_l: the centered
// residue rc = +-mag and the centered k = +-kmag.
struct Correction {
  bool neg;
  uint64_t mag;
  bool kneg;
  uint64_t kmag;
};

__device__ __forceinline__ Correction correction(uint64_t r, uint64_t ql, uint64_t inv_ql_t, uint64_t t, uint64_t mu) {
  Correction c;
  c.neg = r > (ql >> 1);
  c.mag = c.neg ? ql - r : r;  // |rc|
  const uint64_t rem = mod_t(c.mag, t, mu);
  const uint64_t rm = c.neg && rem != 0 ? t - rem : rem;  // rc mod t, floored
  const uint64_t k = mod_t((t - rm) * inv_ql_t, t, mu);   // (t - rm) q_l^-1 < t^2 < 2^64
  c.kneg = k > (t >> 1);
  c.kmag = c.kneg ? t - k : k;  // |kc|
  return c;
}

// (x - d) q_l^-1 mod q with d = rc + q_l kc, as (x - rc) q_l^-1 - kc mod q:
// u = q_l^-1 mod q, us its Shoup dual.
__device__ __forceinline__ uint64_t divide(uint64_t x, const Correction& c, uint64_t q, uint64_t u, uint64_t us) {
  const uint64_t rc = c.neg ? q - c.mag : c.mag;    // rc mod q: |rc| <= q_l / 2 < q
  const uint64_t kc = c.kneg ? q - c.kmag : c.kmag;  // kc mod q: |kc| <= t / 2 < q
  return sub_q(shoup_q(sub_q(x, rc, q), u, us, q), kc, q);
}

// Steps from..to-1 on the two columns v0, v1: step s drops limb L - 1 - s.
// The steps run in a loop; the limbs are indexed only by unrolled constants
// (the dropped one picked by compare and select), so they stay in registers,
// and each table word is loaded once for both columns.
template <int L>
__device__ __forceinline__ void drops(uint64_t (&v0)[L], uint64_t (&v1)[L], const uint64_t* __restrict__ tab,
                                      int from, int to, uint64_t t, uint64_t mu) {
#pragma unroll 1
  for (int s = from; s < to; ++s) {
    const int dl = L - 1 - s;
    const uint64_t* st = tab + kMaxLimbs + s * kStepWords;
    uint64_t r0 = 0, r1 = 0;
#pragma unroll
    for (int j = 1; j < L; ++j) {
      if (j == dl) {
        r0 = v0[j];
        r1 = v1[j];
      }
    }
    const Correction c0 = correction(r0, st[0], st[1], t, mu), c1 = correction(r1, st[0], st[1], t, mu);
#pragma unroll
    for (int i = 0; i < L - 1; ++i) {
      if (i < dl) {
        const uint64_t q = tab[i], u = st[2 + 2 * i], us = st[3 + 2 * i];
        v0[i] = divide(v0[i], c0, q, u, us);
        v1[i] = divide(v1[i], c1, q, u, us);
      }
    }
  }
}

// y[p] (rows, L - k - then, N) from x[p] (rows, L, N): k drops, + add[p]
// (rows, L - k, N; null: none), `then` drops; p = blockIdx.y. A thread takes
// two adjacent columns of a row.
template <int L>
__global__ void __launch_bounds__(kThreads)
    bgv_drop_kernel(DropParts p, const uint64_t* __restrict__ g_tab, int k, int then, int log_n, long long rows,
                    uint64_t t, uint64_t mu) {
  __shared__ uint64_t tab[kTableWords];
  const int words = kMaxLimbs + (k + then) * kStepWords;
  for (int i = threadIdx.x; i < words; i += blockDim.x) tab[i] = g_tab[i];
  __syncthreads();
  const uint64_t* __restrict__ x = blockIdx.y ? p.x[1] : p.x[0];  // no indexing of the parameter array at run time
  const uint64_t* __restrict__ add = blockIdx.y ? p.add[1] : p.add[0];
  uint64_t* __restrict__ y = blockIdx.y ? p.y[1] : p.y[0];
  const int log_pairs = log_n - 1, mid = L - k, out = L - k - then;
  const long long items = rows << log_pairs;
  for (long long it = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; it < items;
       it += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = it >> log_pairs;
    const long long col = (it & ((1ll << log_pairs) - 1)) << 1;
    const uint64_t* xr = x + ((row * L) << log_n) + col;
    uint64_t v0[L], v1[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const ulonglong2 w = *reinterpret_cast<const ulonglong2*>(xr + (static_cast<long long>(l) << log_n));
      v0[l] = w.x;
      v1[l] = w.y;
    }
    drops<L>(v0, v1, tab, 0, k, t, mu);
    if (add != nullptr) {
      const uint64_t* ar = add + ((row * mid) << log_n) + col;
#pragma unroll
      for (int l = 0; l < L - 1; ++l) {
        if (l < mid) {
          const ulonglong2 w = *reinterpret_cast<const ulonglong2*>(ar + (static_cast<long long>(l) << log_n));
          v0[l] = add_q(v0[l], w.x, tab[l]);
          v1[l] = add_q(v1[l], w.y, tab[l]);
        }
      }
    }
    drops<L>(v0, v1, tab, k, k + then, t, mu);
    uint64_t* yr = y + ((row * out) << log_n) + col;
#pragma unroll
    for (int l = 0; l < L - 1; ++l) {
      if (l < out) *reinterpret_cast<ulonglong2*>(yr + (static_cast<long long>(l) << log_n)) = make_ulonglong2(v0[l], v1[l]);
    }
  }
}

template <int L>
void* kernel_for() {
  return reinterpret_cast<void*>(bgv_drop_kernel<L>);
}

template <int... Ls>
struct Instances {
  static void* pick(int limbs) {
    void* out = nullptr;
    ((limbs == Ls ? (out = kernel_for<Ls>(), 0) : 0), ...);
    return out;
  }
};

unsigned grid_for(long long count) {
  const long long blocks = (count + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16);
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
      rows < 1 || x0 == nullptr || y0 == nullptr || (x1 == nullptr) != (y1 == nullptr) || t < 2 ||
      t >= (1ull << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const DropParts p{{static_cast<const uint64_t*>(x0), static_cast<const uint64_t*>(x1)},
                    {static_cast<const uint64_t*>(add0), static_cast<const uint64_t*>(add1)},
                    {static_cast<uint64_t*>(y0), static_cast<uint64_t*>(y1)}};
  void* kernel = Instances<2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16>::pick(limbs);
  const dim3 grid(grid_for(rows << (log_n - 1)), x1 != nullptr ? 2 : 1, 1);
  const uint64_t* g_tab = static_cast<const uint64_t*>(tab);
  void* args[] = {const_cast<DropParts*>(&p), &g_tab, &k, &then, &log_n, &rows, &t, &mu};
  const cudaError_t err =
      cudaLaunchKernel(kernel, grid, dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
