// The RNS u64 engine of CKKS: K-RNS-NTT, K-RNS-MAC, K-BASECONV and
// K-RESCALE, on u64 residues of (..., L, N) tensors whose limb l is reduced
// mod its own odd prime q_l < 2^63.
//
// Replace the XLA fusions of learn_fhe_tpu/ops/rns.py (no Pallas call):
//   K-RNS-NTT   <- fwd_stages / inv_stages via rns_ntt / rns_intt
//                  (rns.py:123,193,252,259)
//   K-RNS-MAC   <- rns_mul_eval (rns.py:280), CKKS mul's tensor and
//                  _ks_dot (models/ckks/ckks.py:588-597,706-716)
//   K-BASECONV  <- extend_bases / switch_bases (rns.py:356-422)
//   K-RESCALE   <- rescale_k's add of P/2, subtraction and division by P
//                  (rns.py:426-464)
// On CKKS's mul + relinearize + rescale they are every launch but the
// element-wise adds and the automorphism gathers.
//
// What bounds them on an H100: a transform moves 2 x 8 B per value and does
// log N u64 Shoup butterflies per pair (some twenty 32-bit instructions
// each), the other three a few u64 products per value read: the integer
// issue rate and the bytes are of the same order.
//
// The design, simple first:
// - K-RNS-NTT: one block per row, the row in dynamic shared memory (64 KB at
//   N = 2^13, past the 48 KB of a static array: the instance opts in with
//   cudaFuncSetAttribute), the passes of 3 layers of u64.cuh (lft64::pass)
//   under the row's limb's tables, rows copied in and out in 16-byte words.
//   Lazy (Harvey) butterflies where every prime is below 2^62.
// - K-RNS-MAC: one thread per value; the products of up to `chunk` terms
//   summed in 128 bits (chunk (q-1)^2 < q 2^64), one REDC per chunk, the
//   chunks' sums added mod q, the total brought out of the Montgomery
//   domain by a REDC against 2^128 mod q. Products of canonical residues
//   summed exactly mod q are the JAX package's in any order.
// - K-BASECONV: one thread per coefficient column: v_i = x_i q_hat_i^-1
//   (Shoup), the overflow count in f64 as XLA's CPU backend sums it (one
//   fused multiply-add per limb, in limb order, from 0; rint, ties to
//   even), then every output limb as the modular sum of Shoup products
//   (q_hat_i mod p_j) v_i less (u Q mod p_j). The modular sum is exact, so
//   it equals both of the JAX package's branches (a raw u64 sum and a
//   Barrett, or the log-depth fold past 2^64).
// - K-RESCALE: one thread per output value.
#include <cuda_runtime.h>

#include <cstdint>

#include "u64.cuh"

namespace {

using lft64::add_q;
using lft64::csub;
using lft64::shoup_q;
using lft64::sub_q;

constexpr int kMaxLogN = 13;
constexpr int kNttThreads = 512;
constexpr int kThreads = 256;
constexpr int kMaxTerms = 16;
constexpr int kMaxLimbs = 64;

// The stacked (L, N) twiddle tables and the (L,) per-limb constants.
struct Stacked {
  const uint64_t* __restrict__ psi;
  const uint64_t* __restrict__ psi_s;
  const uint64_t* __restrict__ psi_inv;
  const uint64_t* __restrict__ psi_inv_s;
  const uint64_t* __restrict__ q;
  const uint64_t* __restrict__ neg_q_inv;
  const uint64_t* __restrict__ n_inv;
  const uint64_t* __restrict__ n_inv_s;
};

// ---------------------------------------------------------------------------
// K-RNS-NTT
// ---------------------------------------------------------------------------

template <bool kInv, bool kLazy>
__global__ void __launch_bounds__(kNttThreads)
    rns_ntt_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, Stacked s, int limbs, int log_n) {
  extern __shared__ __align__(16) uint64_t buf[];
  const long long row = blockIdx.x;
  const int limb = static_cast<int>(row % limbs);
  const size_t off = static_cast<size_t>(limb) << log_n;
  const lft64::Tables t{s.psi + off, s.psi_s + off, s.psi_inv + off, s.psi_inv_s + off,
                        __ldg(s.q + limb), __ldg(s.neg_q_inv + limb), __ldg(s.n_inv + limb), __ldg(s.n_inv_s + limb)};
  const int pairs = 1 << (log_n - 1);
  const auto* src = reinterpret_cast<const ulonglong2*>(x + (row << log_n));
  auto* sb = reinterpret_cast<ulonglong2*>(buf);
  for (int i = threadIdx.x; i < pairs; i += blockDim.x) sb[i] = src[i];
  __syncthreads();
  if constexpr (kInv) {
    lft64::intt_rows<kLazy>(buf, 1, log_n, t, nullptr);
  } else {
    lft64::ntt_rows<kLazy>(buf, 1, log_n, t);
  }
  auto* dst = reinterpret_cast<ulonglong2*>(y + (row << log_n));
  for (int i = threadIdx.x; i < pairs; i += blockDim.x) dst[i] = sb[i];
}

template <bool kInv, bool kLazy>
int launch_ntt(const void* x, void* y, const Stacked& s, int rows, int limbs, int log_n, cudaStream_t stream) {
  const auto kernel = rns_ntt_kernel<kInv, kLazy>;
  // once per instance: the largest row's shared memory, past the static 48 KB
  static const cudaError_t opt =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 8 << kMaxLogN);
  if (opt != cudaSuccess) return static_cast<int>(opt);
  const int n = 1 << log_n;
  const int threads = n / 8 < 32 ? 32 : (n / 8 > kNttThreads ? kNttThreads : n / 8);
  kernel<<<static_cast<unsigned>(rows), threads, static_cast<size_t>(8) << log_n, stream>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(y), s, limbs, log_n);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K-RNS-MAC
// ---------------------------------------------------------------------------

struct Terms {
  const uint64_t* x[kMaxTerms];
  const uint64_t* y[kMaxTerms];
  const uint64_t* z[kMaxTerms];
};

// out0 = sum_k x_k y_k, and with kTwo out1 = sum_k x_k z_k, mod q_limb; the
// y and z of value i at i mod y_count (y_count < count: broadcast over the
// leading axes).
template <bool kTwo>
__global__ void __launch_bounds__(kThreads)
    rns_mac_kernel(Terms t, uint64_t* __restrict__ out, int terms, long long count, long long y_count, int limbs,
                   int log_n, const uint64_t* __restrict__ q_arr, const uint64_t* __restrict__ nqi_arr,
                   const uint64_t* __restrict__ r2_arr, int chunk) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int limb = static_cast<int>((i >> log_n) % limbs);
    const lft64::Mod m{__ldg(q_arr + limb), __ldg(nqi_arr + limb)};
    const long long iy = y_count == count ? i : i % y_count;
    uint64_t s0 = 0, h0 = 0, l0 = 0, s1 = 0, h1 = 0, l1 = 0;
    int in_chunk = 0;
    for (int k = 0; k < terms; ++k) {
      const uint64_t xv = t.x[k][i];
      lft64::mac128(h0, l0, xv, t.y[k][iy]);
      if constexpr (kTwo) lft64::mac128(h1, l1, xv, t.z[k][iy]);
      if (++in_chunk == chunk || k == terms - 1) {
        s0 = add_q(s0, lft64::redc(h0, l0, m), m.q);
        h0 = l0 = 0;
        if constexpr (kTwo) {
          s1 = add_q(s1, lft64::redc(h1, l1, m), m.q);
          h1 = l1 = 0;
        }
        in_chunk = 0;
      }
    }
    const uint64_t r2 = __ldg(r2_arr + limb);
    out[i] = lft64::redc(__umul64hi(s0, r2), s0 * r2, m);
    if constexpr (kTwo) out[count + i] = lft64::redc(__umul64hi(s1, r2), s1 * r2, m);
  }
}

unsigned grid_for(long long count) {
  const long long blocks = (count + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 132 * 32 ? blocks : 132 * 32);
}

// ---------------------------------------------------------------------------
// K-BASECONV
// ---------------------------------------------------------------------------

struct Conv {
  const uint64_t* __restrict__ q;      // (Lq)
  const uint64_t* __restrict__ qhi;    // (Lq) q_hat_i^-1 mod q_i
  const uint64_t* __restrict__ qhi_s;  // its Shoup dual
  const double* __restrict__ frac;     // (Lq) 1/q_i
  const uint64_t* __restrict__ p;      // (Lp)
  const uint64_t* __restrict__ w;      // (Lp, Lq) q_hat_i mod p_j
  const uint64_t* __restrict__ ws;     // its Shoup duals mod p_j
  const uint64_t* __restrict__ uq;     // (Lq+1, Lp) u Q mod p_j
  const uint64_t* __restrict__ add;    // (Lq) added mod q_i first, or null
};

__global__ void __launch_bounds__(kThreads)
    base_convert_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, Conv c, int lq, int lp, int log_n,
                        long long batch, long long x_stride) {
  const long long cols = batch << log_n;
  const int n = 1 << log_n;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < cols;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = i >> log_n;
    const int col = static_cast<int>(i & (n - 1));
    const uint64_t* xb = x + b * x_stride + col;
    uint64_t v[kMaxLimbs];
    double u = 0.0;
    for (int k = 0; k < lq; ++k) {
      const uint64_t q = __ldg(c.q + k);
      uint64_t xv = xb[static_cast<size_t>(k) << log_n];
      if (c.add != nullptr) xv = add_q(xv, __ldg(c.add + k), q);
      v[k] = shoup_q(xv, __ldg(c.qhi + k), __ldg(c.qhi_s + k), q);
      u = __fma_rn(__ull2double_rn(v[k]), __ldg(c.frac + k), u);
    }
    const int uc = static_cast<int>(rint(u));
    uint64_t* yb = y + ((b * lp) << log_n) + col;
    for (int j = 0; j < lp; ++j) {
      const uint64_t p = __ldg(c.p + j);
      const uint64_t* wj = c.w + static_cast<size_t>(j) * lq;
      const uint64_t* wsj = c.ws + static_cast<size_t>(j) * lq;
      uint64_t s = 0;
      for (int k = 0; k < lq; ++k) s = add_q(s, shoup_q(v[k], __ldg(wj + k), __ldg(wsj + k), p), p);
      yb[static_cast<size_t>(j) << log_n] = sub_q(s, __ldg(c.uq + static_cast<size_t>(uc) * lp + j), p);
    }
  }
}

// ---------------------------------------------------------------------------
// K-RESCALE
// ---------------------------------------------------------------------------

struct Rescale {
  const uint64_t* __restrict__ q;       // (L-k) kept primes
  const uint64_t* __restrict__ p_half;  // (P >> 1) mod q
  const uint64_t* __restrict__ p_inv;   // P^-1 mod q
  const uint64_t* __restrict__ p_inv_s;
  const uint64_t* __restrict__ bm;      // floor(2^64 / q) where the dropped limb needs a Barrett, else 0
};

// y (B, keep, N) = (x + P/2 - r) P^-1 mod q, x (B, limbs, N); r = conv (B,
// keep, N), or (conv null, k = 1) the dropped limb x[b, limbs-1] + P/2 mod
// q_d, reduced mod q by Barrett where bm != 0.
__global__ void __launch_bounds__(kThreads)
    rescale_kernel(const uint64_t* __restrict__ x, const uint64_t* __restrict__ conv, uint64_t* __restrict__ y,
                   Rescale c, int limbs, int keep, int log_n, long long count, uint64_t q_d, uint64_t ph_d) {
  const int n = 1 << log_n;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i >> log_n;
    const long long b = row / keep;
    const int l = static_cast<int>(row - b * keep);
    const long long col = i & (n - 1);
    const uint64_t q = __ldg(c.q + l);
    const uint64_t xv = add_q(x[((b * limbs + l) << log_n) + col], __ldg(c.p_half + l), q);
    uint64_t r;
    if (conv != nullptr) {
      r = conv[i];
    } else {
      r = add_q(x[((b * limbs + limbs - 1) << log_n) + col], ph_d, q_d);
      const uint64_t m = __ldg(c.bm + l);
      if (m != 0) r = csub(csub(r - __umul64hi(r, m) * q, q), q);
    }
    y[i] = shoup_q(sub_q(xv, r, q), __ldg(c.p_inv + l), __ldg(c.p_inv_s + l), q);
  }
}

template <typename T>
const T* cp(const void* p) {
  return static_cast<const T*>(p);
}

}  // namespace

extern "C" {

// x, y: (rows, 2^log_n) residues, row r under limb r mod limbs, 16-byte
// aligned; the stacked tables (limbs, 2^log_n) and per-limb (limbs,) q,
// -q^-1 mod 2^64, 1/N and its Shoup dual; lazy: every prime below 2^62.
int lft_rns_ntt_fwd(const void* x, void* y, const void* psi, const void* psi_s, const void* psi_inv,
                    const void* psi_inv_s, const void* q, const void* neg_q_inv, const void* n_inv,
                    const void* n_inv_s, int rows, int limbs, int log_n, int lazy, void* stream) {
  if (rows < 1 || limbs < 1 || log_n < 1 || log_n > kMaxLogN) return static_cast<int>(cudaErrorInvalidValue);
  const Stacked s{cp<uint64_t>(psi), cp<uint64_t>(psi_s), cp<uint64_t>(psi_inv), cp<uint64_t>(psi_inv_s),
                  cp<uint64_t>(q), cp<uint64_t>(neg_q_inv), cp<uint64_t>(n_inv), cp<uint64_t>(n_inv_s)};
  const auto st = static_cast<cudaStream_t>(stream);
  return lazy ? launch_ntt<false, true>(x, y, s, rows, limbs, log_n, st)
              : launch_ntt<false, false>(x, y, s, rows, limbs, log_n, st);
}

int lft_rns_ntt_inv(const void* x, void* y, const void* psi, const void* psi_s, const void* psi_inv,
                    const void* psi_inv_s, const void* q, const void* neg_q_inv, const void* n_inv,
                    const void* n_inv_s, int rows, int limbs, int log_n, int lazy, void* stream) {
  if (rows < 1 || limbs < 1 || log_n < 1 || log_n > kMaxLogN) return static_cast<int>(cudaErrorInvalidValue);
  const Stacked s{cp<uint64_t>(psi), cp<uint64_t>(psi_s), cp<uint64_t>(psi_inv), cp<uint64_t>(psi_inv_s),
                  cp<uint64_t>(q), cp<uint64_t>(neg_q_inv), cp<uint64_t>(n_inv), cp<uint64_t>(n_inv_s)};
  const auto st = static_cast<cudaStream_t>(stream);
  return lazy ? launch_ntt<true, true>(x, y, s, rows, limbs, log_n, st)
              : launch_ntt<true, false>(x, y, s, rows, limbs, log_n, st);
}

// xs, ys, zs: host arrays of `terms` device pointers (zs null: one sum);
// out: (2 if zs else 1, rows, 2^log_n); each x (rows, 2^log_n), each y and z
// (y_rows, 2^log_n), y_rows = rows or limbs (broadcast); per-limb q, -q^-1
// mod 2^64, 2^128 mod q; chunk: products summed before a REDC.
int lft_rns_mac(const void* xs, const void* ys, const void* zs, void* out, int terms, int rows, int limbs,
                int log_n, int y_rows, const void* q, const void* neg_q_inv, const void* r2, int chunk,
                void* stream) {
  if (terms < 1 || terms > kMaxTerms || rows < 1 || limbs < 1 || chunk < 1 || (y_rows != rows && y_rows != limbs))
    return static_cast<int>(cudaErrorInvalidValue);
  Terms t{};
  for (int k = 0; k < terms; ++k) {
    t.x[k] = reinterpret_cast<const uint64_t*>(static_cast<const uint64_t*>(xs)[k]);
    t.y[k] = reinterpret_cast<const uint64_t*>(static_cast<const uint64_t*>(ys)[k]);
    if (zs != nullptr) t.z[k] = reinterpret_cast<const uint64_t*>(static_cast<const uint64_t*>(zs)[k]);
  }
  const long long count = static_cast<long long>(rows) << log_n;
  const long long y_count = static_cast<long long>(y_rows) << log_n;
  const auto kernel = zs != nullptr ? rns_mac_kernel<true> : rns_mac_kernel<false>;
  kernel<<<grid_for(count), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<uint64_t*>(out), terms, count, y_count, limbs, log_n, cp<uint64_t>(q), cp<uint64_t>(neg_q_inv),
      cp<uint64_t>(r2), chunk);
  return static_cast<int>(cudaGetLastError());
}

// x: `batch` blocks of (lq, 2^log_n) residues over the qs, block b at x +
// b x_stride (values), rows contiguous; y: (batch, lp, 2^log_n) over the ps;
// the tables of Conv, each a device array; add: (lq,) or null.
int lft_base_convert(const void* x, void* y, const void* q, const void* qhi, const void* qhi_s, const void* frac,
                     const void* p, const void* w, const void* ws, const void* uq, const void* add, int lq, int lp,
                     int log_n, long long batch, long long x_stride, void* stream) {
  if (lq < 1 || lq > kMaxLimbs || lp < 1 || log_n < 0 || log_n > 30 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Conv c{cp<uint64_t>(q), cp<uint64_t>(qhi), cp<uint64_t>(qhi_s), cp<double>(frac), cp<uint64_t>(p),
               cp<uint64_t>(w), cp<uint64_t>(ws), cp<uint64_t>(uq), cp<uint64_t>(add)};
  base_convert_kernel<<<grid_for(batch << log_n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(y), c, lq, lp, log_n, batch, x_stride);
  return static_cast<int>(cudaGetLastError());
}

// x: (batch, limbs, 2^log_n); conv: (batch, keep, 2^log_n) or null (one
// dropped limb, prime q_d, ph_d = (q_d >> 1)); y: (batch, keep, 2^log_n);
// the kept limbs' (keep,) q, P/2 mod q, P^-1 mod q and its dual, Barrett m.
int lft_rescale(const void* x, const void* conv, void* y, const void* q, const void* p_half, const void* p_inv,
                const void* p_inv_s, const void* bm, int limbs, int keep, int log_n, long long batch,
                unsigned long long q_d, unsigned long long ph_d, void* stream) {
  if (keep < 1 || limbs <= keep || log_n < 0 || log_n > 30 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Rescale c{cp<uint64_t>(q), cp<uint64_t>(p_half), cp<uint64_t>(p_inv), cp<uint64_t>(p_inv_s),
                  cp<uint64_t>(bm)};
  const long long count = (batch * keep) << log_n;
  rescale_kernel<<<grid_for(count), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<const uint64_t*>(conv), static_cast<uint64_t*>(y), c, limbs,
      keep, log_n, count, q_d, ph_d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
