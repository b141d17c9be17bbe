// K-FHEW-BR: the whole LMKCDEY blind rotation of a batch of FHEW
// ciphertexts in one launch, and the host transcription of its schedule.
//
// Replaces the XLA scan learn_fhe_tpu/models/fhew/bootstrapping.py:423
// (blind_rotate_core_fused, vmapped over the batch at parallel/batch.py:
// 100-105; no Pallas call). Each ciphertext walks its fused schedule of
// (ext_idx, auto_idx) pairs to its first (-1, -1). A step runs
//   1. if ext >= 0, the external product with brk[ext]: the gadget digits
//      of acc's a and b (decompose_zq32, 2d rows), their forward NTTs, per
//      coefficient the contraction over the 2d rows with the key's a and b
//      rows, two inverse NTTs; the result replaces acc;
//   2. if auto >= 0, the automorphism X -> X^t by the gather map and signs
//      of ak[auto], then the RLWE key switch: the digits of the gathered a
//      (d rows), their forward NTTs, the contraction with ak[auto], two
//      inverse NTTs, and b += the gathered b.
// A phase whose index is -1 is skipped (the JAX vmap pays for both and
// discards one; the result is the same). Every operation is exact mod q, so
// the result is bit-identical to blind_rotate_core_fused_ref.
//
// What bounds it on an H100: integer instruction issue. At the reference
// fixture (N=512, d=4, batch 128) a step is 16 transforms of 512 points per
// ciphertext, while the keys it reads (brk 3.3 MB of values, ak 0.2 MB) stay
// in the 50 MB L2. One ciphertext alone on the card takes nearly as long as
// 128 (PERF.md): a walk is one block's chain of passes, and with 16 warps
// the forward passes keep the SM's issue busy, so the time follows the
// instructions a phase executes. The design:
//   - one 512-thread block per ciphertext (16 warps on an SM at batch 128,
//     two blocks on an SM from batch 264), its accumulator (a, b) in a
//     swizzled 2-row buffer of shared memory for the whole walk; blocks are
//     independent, and each reads its own schedule row;
//   - the key rows of a phase are copied into shared memory by the Tensor
//     Memory Accelerator (cp.async.bulk, completion on an mbarrier), issued
//     by one thread as soon as the buffer is free: the next step's brk rows
//     right after this step's external product has read its own, the next
//     automorphism's rows, gather map and signs right after this one's
//     contraction. The copies run under the NTT passes, and the contraction
//     reads shared memory. Where the rows do not fit (N=2048 with 16 digit
//     rows), or N < 16, the contraction reads them from device memory;
//   - pass 0 of the forward NTT makes its own digits: a thread computes the
//     digit of its row for the 2^W coefficients its radix-2^W item combines,
//     in closed form (no walk over the digits below it), straight from acc
//     (or from the gathered a) into registers, so the digits never wait in
//     the buffer. The other passes run on the swizzled digit buffer with the
//     pass geometry K-NTT and K-STEP share (ntt32.cuh; [3, 3, 3] layers at
//     N=512), one barrier per pass;
//   - the conditional subtracts of the butterflies, the digits and the
//     contraction are this kernel's own, by the unsigned minimum (two
//     instructions fewer per butterfly than modular32.cuh's);
//   - the contraction needs no Shoup duals: each coefficient sums its row
//     products in a u64 and reduces once per `chunk` rows, the most whose
//     sum fits 64 bits (the host computes it: all 2d rows at the reference
//     fixture's 28-bit q, 4 at q near 2^31). It reads only the key's values,
//     2 or 4 per access where N leaves work for every thread, and writes
//     acc, which the inverse passes then transform in place; the last
//     inverse pass of an automorphism adds the gathered b;
//   - 7 barriers per phase at N=512 (one per pass and the contraction);
//     the twiddle tables are staged in shared memory once per launch; one
//     instance per ring size 2^LOG_N, so the passes' index arithmetic is
//     constant; the digit count and the chunk are run-time values.
// An index outside the key ends that ciphertext's walk before any read by
// it and sets a bit of *error (1: ext, 2: auto); the output then holds acc
// as it stood.
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>
#include <vector>

#include "bulk.cuh"
#include "ntt32.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxLogN = 11;
constexpr int kMaxRows = 16;  // digit rows of the shared buffer: max(2d, d_ks)
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may take
constexpr int kBadExt = 1, kBadAuto = 2;

// Zq gadget: log_b, digits, rounding bits and 2^(bits-1) mod q; `off`, what
// a digit's field exceeds the digit by, and `offsets`, off at every digit
// (see gadget()).
struct Gadget {
  int log_b, d, rb;
  uint32_t half, off, offsets;
};

// The signed digits e_k of a (two's-complement) v, v = sum_k e_k B^k mod
// B^d, lie in [-off, B - 1 - off]: off = B/2 - 1, since a limb carries when
// it exceeds B/2 (for B = 2, when it is 1: off = 1). Those are B
// consecutive values, so digit k is field k of v + sum_k off B^k, less off.
Gadget gadget(int log_b, int d, int rb, uint32_t half) {
  const uint32_t off = log_b >= 2 ? (1u << (log_b - 1)) - 1u : 1u;
  uint32_t offsets = 0;
  for (int k = 0; k < d; ++k) offsets += off << (k * log_b);
  return Gadget{log_b, d, rb, half, off, offsets};
}

// The prime's constants: q, 1/N with its Shoup dual, 2^32 mod q with its
// dual, and the dual of 1 (floor(2^32 / q)).
struct Consts {
  uint32_t q, n_inv, n_inv_s, r32, r32_s, one_s;
};

// What a block works on: its buffers in shared memory, the staged twiddles.
struct Walk {
  uint32_t* buf;  // digit rows: value i of the rows at lft::swizzle(i)
  uint32_t* acc;  // acc's a (row 0) and b (row 1), value i at lft::swizzle(i)
  uint32_t* gb;   // the automorphism's gathered b, added after its key switch
  const uint32_t* psi;
  const uint32_t* psi_s;
  const uint32_t* psi_inv;
  const uint32_t* psi_inv_s;
  Consts c;
};

// Values of a swizzled buffer: rows of N, rounded up to a multiple of 32 so
// that lft::swizzle maps the buffer onto itself.
__host__ __device__ constexpr int buffer_values(int rows, int log_n) {
  return (((rows << log_n) + 31) / 32) * 32;
}

// Where a block's shared memory goes, in u32 from its start: two mbarriers
// (16 bytes), then the buffers, each 16-byte aligned; with `stage`, the
// copies of one external product's key rows (a then b) and of one
// automorphism's key rows, gather map and signs.
struct Layout {
  int buf, acc, gb, tw, ext, aut, words;
};

__host__ __device__ constexpr int align4(int words) { return (words + 3) & ~3; }

__host__ __device__ inline Layout layout(int log_n, int d_g, int d_k, bool stage) {
  const int n = 1 << log_n, rows = 2 * d_g > d_k ? 2 * d_g : d_k;
  Layout l{};
  l.buf = 4;
  l.acc = l.buf + align4(buffer_values(rows, log_n));
  l.gb = l.acc + align4(buffer_values(2, log_n));
  l.tw = l.gb + align4(n);
  l.ext = l.tw + 4 * n;
  l.aut = l.ext + (stage ? 4 * d_g * n : 0);
  l.words = l.aut + (stage ? align4(2 * d_k * n + n + n / 4) : 0);
  return l;
}

// ---------------------------------------------------------------------------
// The arithmetic.
// ---------------------------------------------------------------------------

// Modular add, subtract and Shoup product (q < 2^31) with the unsigned
// minimum as the conditional subtract: for s < 2q, min(s, s - q) = s mod q,
// since s - q wraps above s when s < q. Two instructions fewer per
// butterfly than lft::add_mod / sub_mod / mul_shoup, with the same results.
__device__ __forceinline__ uint32_t csub(uint32_t s, uint32_t q) { return min(s, s - q); }

__device__ __forceinline__ uint32_t add_q(uint32_t a, uint32_t b, uint32_t q) { return csub(a + b, q); }

__device__ __forceinline__ uint32_t sub_q(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t d = a - b;
  return min(d, d + q);
}

__device__ __forceinline__ uint32_t shoup_q(uint32_t a, uint32_t w, uint32_t w_shoup, uint32_t q) {
  return csub(a * w - __umulhi(a, w_shoup) * q, q);
}

// The forward (Cooley-Tukey) and inverse (Gentleman-Sande) layers of one
// pass, in place: lft::fwd_radix and lft::inv_radix on these operations.
template <int W>
__device__ __forceinline__ void fwd_radix(uint32_t (&x)[1 << W], const uint32_t (&w)[(1 << W) - 1],
                                          const uint32_t (&ws)[(1 << W) - 1], uint32_t q) {
#pragma unroll
  for (int t = 0; t < W; ++t) {
    const int half = 1 << (W - 1 - t);
#pragma unroll
    for (int u = 0; u < (1 << t); ++u) {
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const int a = 2 * half * u + j;
        const uint32_t v = shoup_q(x[a + half], w[(1 << t) - 1 + u], ws[(1 << t) - 1 + u], q);
        x[a + half] = sub_q(x[a], v, q);
        x[a] = add_q(x[a], v, q);
      }
    }
  }
}

template <int W>
__device__ __forceinline__ void inv_radix(uint32_t (&x)[1 << W], const uint32_t (&w)[(1 << W) - 1],
                                          const uint32_t (&ws)[(1 << W) - 1], uint32_t q) {
#pragma unroll
  for (int t = W - 1; t >= 0; --t) {
    const int half = 1 << (W - 1 - t);
#pragma unroll
    for (int u = 0; u < (1 << t); ++u) {
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const int a = 2 * half * u + j;
        const uint32_t x0 = x[a], x1 = x[a + half];
        x[a] = add_q(x0, x1, q);
        x[a + half] = shoup_q(sub_q(x0, x1, q), w[(1 << t) - 1 + u], ws[(1 << t) - 1 + u], q);
      }
    }
  }
}

// s mod q for any s < 2^64: hi * (2^32 mod q) + lo, each by a Shoup product.
__device__ __forceinline__ uint32_t reduce64(uint64_t s, const Consts& c) {
  return add_q(shoup_q(static_cast<uint32_t>(s >> 32), c.r32, c.r32_s, c.q),
               shoup_q(static_cast<uint32_t>(s), 1u, c.one_s, c.q), c.q);
}

// Digit i of a residue x < q as a residue: decompose_zq32 of
// learn_fhe_tpu/ops/gadget.py:108-137 (the rounding shift, the centered
// lift, the signed digits) in closed form, with no walk over the digits
// below it (see Gadget).
__device__ __forceinline__ uint32_t zq_digit(uint32_t x, const Gadget& g, int i, uint32_t q) {
  if (g.rb) x = add_q(x, g.half, q) >> g.rb;
  const uint32_t v = x < (q >> 1) ? x : x - q;  // the centered lift, two's complement
  const uint32_t field = ((v + g.offsets) >> (i * g.log_b)) & ((1u << g.log_b) - 1u);
  return sub_q(field, g.off, q);
}

// V contiguous values (V = 1, 2 or 4; 4V-byte aligned) from (to) any address.
template <int V>
__device__ __forceinline__ void load_vec(uint32_t (&x)[V], const uint32_t* p) {
  if constexpr (V == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (V == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(const uint32_t (&x)[V], uint32_t* p) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(x[0], x[1], x[2], x[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// ---------------------------------------------------------------------------
// The phases' passes.
// ---------------------------------------------------------------------------

// Forward pass 0 (layers 0 .. W-1) of `rows` digit rows, the digits made in
// registers: an external product's rows 0..d-1 are the digits of acc's a,
// rows d..2d-1 those of b (kAuto false); an automorphism's row i is digit i
// of the gathered a, acc.a[map[j]] negated where sign[j] (kAuto), and the
// gathered b goes to k.gb. Ends at a barrier.
template <int LOG_N, bool kAuto>
__device__ __forceinline__ void first_pass(const Walk& k, const Gadget& g, int rows,
                                           const int32_t* map, const uint8_t* sign) {
  constexpr int W = lft::pass_width(LOG_N, 0), R = 1 << W;
  constexpr int log_h = LOG_N - W;  // one group: a row's items are i < 2^log_h
  const uint32_t q = k.c.q;
  uint32_t w[R - 1], ws[R - 1];
  lft::pass_twiddles<W>(w, ws, k.psi, k.psi_s, 0, 0);
  for (int t = threadIdx.x; t < (rows << log_h); t += kThreads) {
    const int row = t >> log_h, i = t & ((1 << log_h) - 1);
    const bool of_b = !kAuto && row >= g.d;
    const int digit = of_b ? row - g.d : row;
    uint32_t x[R];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int j = i + (m << log_h);
      uint32_t v;
      if constexpr (kAuto) {
        v = k.acc[lft::swizzle(map[j])];
        if (sign[j]) v = v ? q - v : 0u;
      } else {
        v = k.acc[lft::swizzle((of_b ? 1 << LOG_N : 0) + j)];
      }
      x[m] = zq_digit(v, g, digit, q);
    }
    fwd_radix<W>(x, w, ws, q);
    lft::store_row<W, log_h>(x, k.buf, (row << LOG_N) + i);
  }
  if constexpr (kAuto) {
    for (int j = threadIdx.x; j < (1 << LOG_N); j += kThreads) {
      uint32_t v = k.acc[lft::swizzle((1 << LOG_N) + map[j])];
      if (sign[j]) v = v ? q - v : 0u;
      k.gb[j] = v;
    }
  }
  __syncthreads();
}

// Forward pass P >= 1 (layers 3P .. 3P+W-1) of rows 0 .. rows-1 of the
// digit buffer, then the passes after it; each ends at a barrier.
template <int LOG_N, int P>
__device__ __forceinline__ void forward_passes(const Walk& k, int rows) {
  if constexpr (P < lft::pass_count(LOG_N)) {
    constexpr int L0 = 3 * P, W = lft::pass_width(LOG_N, P), R = 1 << W;
    constexpr int log_h = LOG_N - L0 - W;
    constexpr int log_items = LOG_N - W;  // items of a row: 2^log_items
    for (int t = threadIdx.x; t < (rows << log_items); t += kThreads) {
      const int i = t & ((1 << log_items) - 1);
      const int hi = i >> log_h;
      const int base = ((t >> log_items) << LOG_N) + (hi << (LOG_N - L0)) + (i & ((1 << log_h) - 1));
      uint32_t x[R], w[R - 1], ws[R - 1];
      lft::load_row<W, log_h>(x, k.buf, base);
      lft::pass_twiddles<W>(w, ws, k.psi, k.psi_s, L0, hi);
      fwd_radix<W>(x, w, ws, k.c.q);
      lft::store_row<W, log_h>(x, k.buf, base);
    }
    __syncthreads();
    forward_passes<LOG_N, P + 1>(k, rows);
  }
}

// Rows r0 .. r1-1 of one contraction item: their products summed in a u64,
// reduced, and written to out (or added to it mod q).
template <int LOG_N, int V>
__device__ __forceinline__ void sum_rows(const Walk& k, uint32_t (&out)[V], int j, const uint32_t* key, int r0,
                                         int r1, bool add) {
  uint64_t s[V];
#pragma unroll
  for (int m = 0; m < V; ++m) s[m] = 0;
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    uint32_t x[V], y[V];
    load_vec<V>(x, k.buf + lft::swizzle((r << LOG_N) + j));
    load_vec<V>(y, key + (r << LOG_N));
#pragma unroll
    for (int m = 0; m < V; ++m) s[m] += static_cast<uint64_t>(x[m]) * y[m];
  }
#pragma unroll
  for (int m = 0; m < V; ++m) {
    const uint32_t part = reduce64(s[m], k.c);
    out[m] = add ? add_q(out[m], part, k.c.q) : part;
  }
}

// Per coefficient j and output o (acc's a, then b): the sum over the `rows`
// NTT rows of row r times key row r of ka (o = 0) or kb (o = 1), written to
// row o of acc. A thread takes V neighbouring coefficients of one output,
// sums `chunk` row products at a time in a u64 (the host has checked that
// chunk * (q-1)^2 < 2^64) and reduces each such sum. The first sum is a
// call of its own: where it takes every row (any q below 2^30 at 2d = 8),
// the code the loop would wrap around it is skipped. The key rows may lie
// in shared or device memory. Ends at a barrier.
template <int LOG_N>
__device__ __forceinline__ void contract(const Walk& k, int rows, int chunk, const uint32_t* ka,
                                         const uint32_t* kb) {
  constexpr int n = 1 << LOG_N;
  constexpr int V = n >= 1024 ? 4 : n >= 512 ? 2 : 1;  // 2N / V >= kThreads items where N allows
  constexpr int cols = n / V;
  for (int t = threadIdx.x; t < 2 * cols; t += kThreads) {
    const int o = t >= cols;
    const int j = (t - o * cols) * V;
    const uint32_t* key = (o ? kb : ka) + j;
    uint32_t out[V];
    sum_rows<LOG_N, V>(k, out, j, key, 0, min(rows, chunk), false);
    for (int r0 = chunk; r0 < rows; r0 += chunk) sum_rows<LOG_N, V>(k, out, j, key, r0, min(rows, r0 + chunk), true);
    store_vec<V>(out, k.acc + lft::swizzle((o << LOG_N) + j));
  }
  __syncthreads();
}

// Inverse pass P of acc's two rows (the 1/N scale in pass 0, and there,
// with add_b, b += the gathered b), then P-1 .. 0; each ends at a barrier.
template <int LOG_N, int P>
__device__ __forceinline__ void inverse_passes(const Walk& k, bool add_b) {
  constexpr int L0 = 3 * P, W = lft::pass_width(LOG_N, P), R = 1 << W;
  constexpr int log_h = LOG_N - L0 - W;
  constexpr int log_items = LOG_N - W;
  const uint32_t q = k.c.q;
  for (int t = threadIdx.x; t < (2 << log_items); t += kThreads) {
    const int row = t >> log_items;
    const int i = t & ((1 << log_items) - 1);
    const int hi = i >> log_h;
    const int col = (hi << (LOG_N - L0)) + (i & ((1 << log_h) - 1));
    const int base = (row << LOG_N) + col;
    uint32_t x[R], w[R - 1], ws[R - 1];
    lft::load_row<W, log_h>(x, k.acc, base);
    lft::pass_twiddles<W>(w, ws, k.psi_inv, k.psi_inv_s, L0, hi);
    inv_radix<W>(x, w, ws, q);
    if constexpr (P == 0) {
#pragma unroll
      for (int m = 0; m < R; ++m) x[m] = shoup_q(x[m], k.c.n_inv, k.c.n_inv_s, q);
      if (add_b && row == 1) {
#pragma unroll
        for (int m = 0; m < R; ++m) x[m] = add_q(x[m], k.gb[col + (m << log_h)], q);
      }
    }
    lft::store_row<W, log_h>(x, k.acc, base);
  }
  __syncthreads();
  if constexpr (P > 0) inverse_passes<LOG_N, P - 1>(k, add_b);
}

template <int LOG_N>
__global__ void __launch_bounds__(kThreads, 2)
    fhew_blind_rotate_kernel(const uint32_t* __restrict__ acc_a, const uint32_t* __restrict__ acc_b,
                             uint32_t* __restrict__ out_a, uint32_t* __restrict__ out_b,
                             const int32_t* __restrict__ ext_idx, const int32_t* __restrict__ auto_idx,
                             int steps, const uint32_t* __restrict__ brk_a,
                             const uint32_t* __restrict__ brk_b, int n_keys,
                             const uint32_t* __restrict__ ak_a, const uint32_t* __restrict__ ak_b,
                             const int32_t* __restrict__ auto_src, const uint8_t* __restrict__ auto_sign,
                             int windows, const uint32_t* __restrict__ psi,
                             const uint32_t* __restrict__ psi_s, const uint32_t* __restrict__ psi_inv,
                             const uint32_t* __restrict__ psi_inv_s, Consts c, Gadget gg, Gadget gk,
                             int chunk, int stage, int* __restrict__ error) {
  extern __shared__ uint4 sh4[];  // 16-byte aligned for the vector accesses and the copies
  constexpr int n = 1 << LOG_N;
  uint32_t* sh = reinterpret_cast<uint32_t*>(sh4);
  uint64_t* bar_ext = reinterpret_cast<uint64_t*>(sh);
  uint64_t* bar_auto = bar_ext + 1;
  const Layout l = layout(LOG_N, gg.d, gk.d, stage != 0);
  uint32_t* tw = sh + l.tw;  // psi, psi_s, psi_inv, psi_inv_s
  const Walk k{sh + l.buf, sh + l.acc, sh + l.gb, tw, tw + n, tw + 2 * n, tw + 3 * n, c};
  if (threadIdx.x == 0) {
    lft::bulk::mbar_init(bar_ext);
    lft::bulk::mbar_init(bar_auto);
  }
  const size_t row = static_cast<size_t>(blockIdx.x) << LOG_N;
  const uint32_t* tables[4] = {psi, psi_s, psi_inv, psi_inv_s};
  for (int j = threadIdx.x; j < n; j += kThreads) {
#pragma unroll
    for (int t = 0; t < 4; ++t) tw[t * n + j] = __ldg(tables[t] + j);
    k.acc[lft::swizzle(j)] = __ldg(acc_a + row + j);
    k.acc[lft::swizzle(n + j)] = __ldg(acc_b + row + j);
  }
  __syncthreads();

  // The copies: each phase's rows into its own buffer, issued by thread 0
  // once that buffer is free; every thread keeps the same account of what
  // is in flight, since the indices are the same for the whole block.
  const int rows_g = 2 * gg.d;
  const uint32_t ext_bytes = static_cast<uint32_t>(rows_g * n * 4);  // of a, and of b
  const uint32_t aut_bytes = static_cast<uint32_t>(gk.d * n * 4);
  uint32_t* ext_buf = sh + l.ext;
  uint32_t* aut_buf = sh + l.aut;
  uint32_t ext_phase = 0, auto_phase = 0;
  bool ext_pending = false, auto_pending = false;
  auto fetch_ext = [&](int e) {
    if (!stage || e < 0 || e >= n_keys) return;
    if (threadIdx.x == 0) {
      const size_t key = static_cast<size_t>(e) * rows_g << LOG_N;
      lft::bulk::mbar_expect(bar_ext, 2 * ext_bytes);
      lft::bulk::bulk_copy(ext_buf, brk_a + key, ext_bytes, bar_ext);  // its fence: after the reads of the last copy
      lft::bulk::bulk_copy(ext_buf + rows_g * n, brk_b + key, ext_bytes, bar_ext);
    }
    ext_pending = true;
  };
  auto fetch_auto = [&](int au) {
    if (!stage || au < 0 || au >= windows) return;
    if (threadIdx.x == 0) {
      const size_t key = static_cast<size_t>(au) * gk.d << LOG_N;
      const size_t map = static_cast<size_t>(au) << LOG_N;
      lft::bulk::mbar_expect(bar_auto, 2 * aut_bytes + 5 * n);
      lft::bulk::bulk_copy(aut_buf, ak_a + key, aut_bytes, bar_auto);
      lft::bulk::bulk_copy(aut_buf + gk.d * n, ak_b + key, aut_bytes, bar_auto);
      lft::bulk::bulk_copy(aut_buf + 2 * gk.d * n, auto_src + map, 4 * n, bar_auto);
      lft::bulk::bulk_copy(aut_buf + 2 * gk.d * n + n, auto_sign + map, n, bar_auto);
    }
    auto_pending = true;
  };

  constexpr int kLastPass = lft::pass_count(LOG_N) - 1;
  const int32_t* e_row = ext_idx + static_cast<size_t>(blockIdx.x) * steps;
  const int32_t* a_row = auto_idx + static_cast<size_t>(blockIdx.x) * steps;
  int e_next = steps > 0 ? e_row[0] : -1, a_next = steps > 0 ? a_row[0] : -1;
  fetch_ext(e_next);
  fetch_auto(a_next);
  int bad = 0;
  for (int s = 0; s < steps; ++s) {
    const int e = e_next, au = a_next;  // the same for every thread of the block
    if (e == -1 && au == -1) break;     // the end of this ciphertext's schedule
    if (e < -1 || e >= n_keys) bad |= kBadExt;
    if (au < -1 || au >= windows) bad |= kBadAuto;
    if (bad) break;
    e_next = s + 1 < steps ? e_row[s + 1] : -1;
    a_next = s + 1 < steps ? a_row[s + 1] : -1;
    if (e >= 0) {
      first_pass<LOG_N, false>(k, gg, rows_g, nullptr, nullptr);
      forward_passes<LOG_N, 1>(k, rows_g);
      const size_t key = static_cast<size_t>(e) * rows_g << LOG_N;
      const uint32_t* ka = brk_a + key;
      const uint32_t* kb = brk_b + key;
      if (stage) {
        lft::bulk::mbar_wait(bar_ext, ext_phase++ & 1u);
        ext_pending = false;
        ka = ext_buf;
        kb = ext_buf + rows_g * n;
      }
      contract<LOG_N>(k, rows_g, chunk, ka, kb);
      fetch_ext(e_next);  // this step's rows are read
      inverse_passes<LOG_N, kLastPass>(k, false);
    } else {
      fetch_ext(e_next);
    }
    if (au >= 0) {
      const size_t key = static_cast<size_t>(au) * gk.d << LOG_N;
      const uint32_t* ka = ak_a + key;
      const uint32_t* kb = ak_b + key;
      const int32_t* map = auto_src + (static_cast<size_t>(au) << LOG_N);
      const uint8_t* sign = auto_sign + (static_cast<size_t>(au) << LOG_N);
      if (stage) {
        lft::bulk::mbar_wait(bar_auto, auto_phase++ & 1u);
        auto_pending = false;
        ka = aut_buf;
        kb = aut_buf + gk.d * n;
        map = reinterpret_cast<const int32_t*>(aut_buf + 2 * gk.d * n);
        sign = reinterpret_cast<const uint8_t*>(aut_buf + 2 * gk.d * n + n);
      }
      first_pass<LOG_N, true>(k, gk, gk.d, map, sign);
      forward_passes<LOG_N, 1>(k, gk.d);
      contract<LOG_N>(k, gk.d, chunk, ka, kb);
      fetch_auto(a_next);  // this step's rows, map and signs are read
      inverse_passes<LOG_N, kLastPass>(k, true);
    } else {
      fetch_auto(a_next);
    }
  }
  // No copy may land after the block has gone.
  if (ext_pending) lft::bulk::mbar_wait(bar_ext, ext_phase & 1u);
  if (auto_pending) lft::bulk::mbar_wait(bar_auto, auto_phase & 1u);
  if (bad && threadIdx.x == 0) atomicOr(error, bad);
  for (int j = threadIdx.x; j < n; j += kThreads) {
    out_a[row + j] = k.acc[lft::swizzle(j)];
    out_b[row + j] = k.acc[lft::swizzle(n + j)];
  }
}

using WalkKernel = decltype(&fhew_blind_rotate_kernel<1>);

template <int... L>
WalkKernel walk_kernel_at(int log_n, std::integer_sequence<int, L...>) {
  static const WalkKernel table[] = {fhew_blind_rotate_kernel<L + 1>...};
  return table[log_n - 1];
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// ---------------------------------------------------------------------------
// The schedule, on the host: the C transcription of build_schedule and
// fuse_schedule (learn_fhe_tpu_torch/models/fhew/bootstrapping.py), a copy
// of native/fhe_native.cpp:180-268.
// ---------------------------------------------------------------------------

using i64 = long long;

}  // namespace

extern "C" {

// The walk of `batch` ciphertexts over their (batch, steps) schedules.
// chunk: the row products the contraction sums before it reduces, with
// chunk * (q-1)^2 < 2^64. error: one int on the device, OR-ed with 1 (2)
// where an ext (auto) index lies outside the key.
int lft_fhew_blind_rotate(const void* acc_a, const void* acc_b, void* out_a, void* out_b,
                          const void* ext_idx, const void* auto_idx, int batch, int steps,
                          const void* brk_a, const void* brk_b, int n_keys, const void* ak_a,
                          const void* ak_b, const void* auto_src, const void* auto_sign, int windows,
                          const void* psi, const void* psi_s, const void* psi_inv,
                          const void* psi_inv_s, int log_n, unsigned int q, unsigned int n_inv,
                          unsigned int n_inv_s, int log_b_g, int d_g, int rb_g, unsigned int half_g,
                          int log_b_k, int d_k, int rb_k, unsigned int half_k, int chunk, void* error,
                          void* stream) {
  const int rows = 2 * d_g > d_k ? 2 * d_g : d_k;
  if (batch < 1 || steps < 0 || log_n < 1 || log_n > kMaxLogN || d_g < 1 || d_k < 1 ||
      rows > kMaxRows || log_b_g < 1 || log_b_k < 1 || q < 2 || q >= (1u << 31) || chunk < 1 ||
      static_cast<uint64_t>(q - 1) * (q - 1) > UINT64_MAX / static_cast<uint64_t>(chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The key rows are read with 16-byte accesses or copies.
  for (const void* p : {brk_a, brk_b, ak_a, ak_b, auto_src, auto_sign}) {
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  // Staged copies need 16-byte sizes: N >= 16 (the signs' rows are N
  // bytes); and they must fit beside the rest.
  bool stage = log_n >= 4;
  size_t smem = layout(log_n, d_g, d_k, stage).words * sizeof(uint32_t);
  if (stage && smem > kMaxSmem) {
    stage = false;
    smem = layout(log_n, d_g, d_k, false).words * sizeof(uint32_t);
  }
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const WalkKernel kernel = walk_kernel_at(log_n, std::make_integer_sequence<int, kMaxLogN>{});
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const uint64_t r32 = (1ull << 32) % q;
  const Consts c{q, n_inv, n_inv_s, static_cast<uint32_t>(r32), static_cast<uint32_t>((r32 << 32) / q),
                 static_cast<uint32_t>((1ull << 32) / q)};
  kernel<<<static_cast<unsigned>(batch), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(acc_a), static_cast<const uint32_t*>(acc_b),
      static_cast<uint32_t*>(out_a), static_cast<uint32_t*>(out_b),
      static_cast<const int32_t*>(ext_idx), static_cast<const int32_t*>(auto_idx), steps,
      static_cast<const uint32_t*>(brk_a), static_cast<const uint32_t*>(brk_b), n_keys,
      static_cast<const uint32_t*>(ak_a), static_cast<const uint32_t*>(ak_b),
      static_cast<const int32_t*>(auto_src), static_cast<const uint8_t*>(auto_sign), windows,
      static_cast<const uint32_t*>(psi), static_cast<const uint32_t*>(psi_s),
      static_cast<const uint32_t*>(psi_inv), static_cast<const uint32_t*>(psi_inv_s), c,
      gadget(log_b_g, d_g, rb_g, half_g), gadget(log_b_k, d_k, rb_k, half_k), chunk, stage ? 1 : 0,
      static_cast<int*>(error));
  return static_cast<int>(cudaGetLastError());
}

// For each of `batch` rows of a (values in Z_2N), the (op, idx) schedule of
// length sched_len: op 0 = external product (idx = key index j), 1 =
// automorphism by g^idx (idx 0: t = -g), 2 = padding. minus_map, plus_map:
// (2N,) value -> dlog or -1. Returns 0, or -1 if a schedule overflows
// sched_len or a value is in both tables.
int lft_fhew_build_schedule(const i64* a, i64 batch, i64 n_lwe, const i64* minus_map,
                            const i64* plus_map, i64 half, int window, int32_t* ops,
                            int32_t* idxs, i64 sched_len) {
  std::vector<std::vector<int32_t>> i_minus(half), i_plus(half);
  for (i64 t = 0; t < batch; ++t) {
    for (i64 l = 0; l < half; ++l) {
      i_minus[l].clear();
      i_plus[l].clear();
    }
    const i64* row = a + t * n_lwe;
    for (i64 j = 0; j < n_lwe; ++j) {
      const i64 aj = row[j];
      const i64 lm = minus_map[aj], lp = plus_map[aj];
      if (lm >= 0 && lp < 0) {
        i_minus[lm].push_back(static_cast<int32_t>(j));
      } else if (lp >= 0 && lm < 0) {
        i_plus[lp].push_back(static_cast<int32_t>(j));
      } else if (aj != 0) {
        return -1;
      }
    }
    int32_t* op_row = ops + t * sched_len;
    int32_t* idx_row = idxs + t * sched_len;
    i64 k = 0;
    auto emit = [&](int32_t op, int32_t idx) -> bool {
      if (k >= sched_len) return false;
      op_row[k] = op;
      idx_row[k] = idx;
      ++k;
      return true;
    };
    auto walk = [&](const std::vector<std::vector<int32_t>>& buckets) -> bool {
      int v = 0;
      for (i64 l = static_cast<i64>(buckets.size()) - 1; l >= 1; --l) {
        for (int32_t j : buckets[l]) {
          if (!emit(0, j)) return false;
        }
        v += 1;
        if (!buckets[l - 1].empty() || v == window || l == 1) {
          if (!emit(1, v)) return false;
          v = 0;
        }
      }
      return true;
    };
    bool ok = walk(i_minus);
    for (int32_t j : i_minus[0]) ok = ok && emit(0, j);
    ok = ok && emit(1, 0);  // ak[0]: t = -g
    ok = ok && walk(i_plus);
    for (int32_t j : i_plus[0]) ok = ok && emit(0, j);
    if (!ok) return -1;
    for (; k < sched_len; ++k) {
      op_row[k] = 2;
      idx_row[k] = 0;
    }
  }
  return 0;
}

// Each automorphism merged into the external product before it: (ops, idxs)
// (batch, sched_len) to (e_out, a_out) of the same shape, -1 where absent.
// Returns the longest fused schedule of the batch.
int lft_fhew_fuse_schedule(const int32_t* ops, const int32_t* idxs, i64 batch, i64 sched_len,
                           int32_t* e_out, int32_t* a_out) {
  i64 max_len = 0;
  for (i64 b = 0; b < batch; ++b) {
    const int32_t* op_row = ops + b * sched_len;
    const int32_t* idx_row = idxs + b * sched_len;
    int32_t* e_row = e_out + b * sched_len;
    int32_t* a_row = a_out + b * sched_len;
    for (i64 t = 0; t < sched_len; ++t) e_row[t] = a_row[t] = -1;
    i64 k = 0;
    bool open_ext = false;
    for (i64 t = 0; t < sched_len; ++t) {
      const int32_t op = op_row[t];
      if (op == 0) {
        e_row[k++] = idx_row[t];
        open_ext = true;
      } else if (op == 1) {
        if (open_ext) {
          a_row[k - 1] = idx_row[t];
          open_ext = false;
        } else {
          a_row[k++] = idx_row[t];
        }
      } else {
        break;  // padding, only at the tail
      }
    }
    if (k > max_len) max_len = k;
  }
  return static_cast<int>(max_len);
}

}  // extern "C"
