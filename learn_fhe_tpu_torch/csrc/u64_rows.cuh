// The row passes of K-POLYMUL64, K-NTT64 and intt64 (ntt64.cu) and
// K-EXTPROD64 (fhew_u64.cu) since their redesign for the H100: the
// negacyclic NTT of rows held in shared memory, with the first and the last
// passes fused into what comes before and after them. The arithmetic is
// u64.cuh's (the same butterflies, eager and lazy, and the same canonical
// results), so the outputs stay bit-identical to the plain versions.
//
// What bounded the kernels before their redesign (PERF.md): one block's
// chain of barrier-separated stages. K-POLYMUL64 loaded both rows, ran 4
// forward passes, the product and 4 inverse passes with a barrier after
// each, and stored; K-EXTPROD64 stored its digit rows before the first pass
// and read its transforms back for the contraction, on one 512-thread block
// an SM (208 KB of shared memory for all 10 digit rows), so no other block
// filled its barriers and its contraction's waits on the key rows. The
// butterflies themselves issue at about 0.61 of the rate the SASS-counted
// bound assumes (PERF.md section 3).
//
// The design:
// - The passes: 3 layers each over the first log N - 2 layers (`head`),
//   then a pass of the last 2 layers whose item is 4 consecutive values.
//   A thread takes one item of a pass in each row it covers, its twiddles
//   loaded once and reused over those rows.
// - Fusion. K-NTT64's first pass reads device memory and its last writes
//   it (canonical, or in the Montgomery domain by one Shoup product);
//   intt64 runs the other way. K-EXTPROD64's first forward pass makes the
//   gadget digits from acc, and the last inverse pass of both scales by 1/N
//   and writes device memory. The last forward pass, the pointwise product
//   and the first inverse pass of K-POLYMUL64 run on one item in registers;
//   K-EXTPROD64's last forward pass feeds the contraction directly, and its
//   first inverse pass runs on the REDC-ed sums in registers. K-POLYMUL64
//   has 6 barriers, not 10; K-NTT64 and intt64 3 at N = 2048.
// - At N = 2048 (kLogN, the multi-key sets' ring) every pass's shape is a
//   constant, so a shared-memory access is an offset from the item's base;
//   K-POLYMUL64's rows come in by two bulk copies (TMA) there, elsewhere
//   its first pass reads them from device memory.
// - The layout is rows of 2^log_n values, one after the other. The pass at
//   l0 = 6 and the last pass then serve a warp's u64 access in 8 wavefronts
//   instead of 2; an XOR layout that served every access in 2 cost more
//   instructions than the conflicts cost time (PERF.md), and was left out.
// - Harvey's lazy values reach the products unreduced: a value below 4q
//   times one below q fits the REDC bound (q 2^64) for up to 2^62 / q rows
//   (K-EXTPROD64's host caps its group so), and two below 4q do for q <
//   2^60 (K-POLYMUL64 reduces them first above it).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk.cuh"
#include "u64.cuh"

namespace lft64 {
namespace rows {

// ---------------------------------------------------------------------------
// The pass plan
// ---------------------------------------------------------------------------

// The last pass takes 2 layers (1 at N = 2); the head passes before it 3
// each, the last of them what is left.
__host__ __device__ constexpr int last_width(int log_n) { return log_n < 2 ? log_n : 2; }
__host__ __device__ constexpr int head_layers(int log_n) { return log_n - last_width(log_n); }
__host__ __device__ constexpr int head_passes(int log_n) { return (head_layers(log_n) + 2) / 3; }
__host__ __device__ constexpr int head_width(int log_n, int p) {
  return p == head_passes(log_n) - 1 ? head_layers(log_n) - 3 * p : 3;
}

// ---------------------------------------------------------------------------
// A pass of W layers from l0 over `rows` rows: item i of a row holds the
// values col + (m << log_h), m < 2^W, col = (g << (log_n - l0)) + (i mod h),
// g = i / h, h = 2^(log_n - l0 - W); layer l0 + t pairs them as u64.cuh's
// fwd_radix / inv_radix do, with twiddle 2^(l0+t) + (g << t) + u. The
// block's threads take the items: where a row has fewer items than the
// block has threads, thread k takes item k mod items of rows k / items,
// k / items + threads / items, ...; else items k, k + threads, ... of every
// row (threads: the block's, blockDim.x or the same as a constant).
// in.load(row, col, log_h, x) brings an item's values in, out.store puts
// them out; no barrier.
// ---------------------------------------------------------------------------

template <int W, bool kInv, bool kLazy, class In, class Out>
__device__ __forceinline__ void pass(int threads, int rows, int log_n, int l0, const Tables& t, In& in, Out& out) {
  const int log_h = log_n - l0 - W, log_items = log_n - W, items = 1 << log_items;
  const bool wide = threads >= items;
  const int row0 = wide ? static_cast<int>(threadIdx.x) >> log_items : 0;
  const int row_step = wide ? threads >> log_items : 1;
  for (int i = threadIdx.x & (items - 1); i < items; i += threads) {
    const int g = i >> log_h;
    const int col = (g << (log_n - l0)) + (i & ((1 << log_h) - 1));
    uint64_t w[(1 << W) - 1], ws[(1 << W) - 1];
    if constexpr (kInv) {
      twiddles<W>(w, ws, t.psi_inv, t.psi_inv_s, l0, g);
    } else {
      twiddles<W>(w, ws, t.psi, t.psi_s, l0, g);
    }
#pragma unroll 2  // two rows' butterflies in flight: 1% on K-EXTPROD64 (PERF.md)
    for (int row = row0; row < rows; row += row_step) {
      uint64_t x[1 << W];
      in.load(row, col, log_h, x);
      if constexpr (kInv) {
        inv_radix<W, kLazy>(x, w, ws, t.q);
      } else {
        fwd_radix<W, kLazy>(x, w, ws, t.q);
      }
      out.store(row, col, log_h, x);
    }
  }
}

// Head pass p (3 p, ..., its width); forward or inverse.
template <bool kInv, bool kLazy, class In, class Out>
__device__ __forceinline__ void head_pass(int threads, int p, int rows, int log_n, const Tables& t, In& in, Out& out) {
  const int w = head_width(log_n, p);
  if (w == 3) {
    pass<3, kInv, kLazy>(threads, rows, log_n, 3 * p, t, in, out);
  } else if (w == 2) {
    pass<2, kInv, kLazy>(threads, rows, log_n, 3 * p, t, in, out);
  } else {
    pass<1, kInv, kLazy>(threads, rows, log_n, 3 * p, t, in, out);
  }
}

// Rows of 2^log_n values in shared memory, one after the other.
struct Smem {
  uint64_t* buf;
  int log_n;
  template <int V>
  __device__ __forceinline__ void load(int row, int col, int log_h, uint64_t (&x)[V]) const {
    const uint64_t* p = buf + (row << log_n) + col;
#pragma unroll
    for (int m = 0; m < V; ++m) x[m] = p[m << log_h];
  }
  template <int V>
  __device__ __forceinline__ void store(int row, int col, int log_h, const uint64_t (&x)[V]) const {
    uint64_t* p = buf + (row << log_n) + col;
#pragma unroll
    for (int m = 0; m < V; ++m) p[m << log_h] = x[m];
  }
};

// ---------------------------------------------------------------------------
// K-NTT64 and intt64: the transform of the block's `per` rows from row
// `first` of device memory, `have` of them real (a ragged last block reads
// zeros for the others and does not store them); buf holds per rows of
// 2^log_n. The forward's first head pass reads device memory and its last
// pass writes it from registers; the inverse's first pass (the last 2
// layers) reads device memory and its last head pass writes it, scaled by
// 1/N. At N <= 4 the one pass does both. Every thread of the block calls
// them.
// ---------------------------------------------------------------------------

// The inverse's rows out to device memory, scaled by 1/N (canonical): intt64's
// and K-POLYMUL64's.
struct ScaledRows {
  uint64_t* __restrict__ y;
  long long first;
  int have, log_n;
  uint64_t q, n_inv, n_inv_s;
  template <int V>
  __device__ __forceinline__ void store(int row, int col, int log_h, const uint64_t (&x)[V]) const {
    if (row >= have) return;
    uint64_t* dst = y + ((first + row) << log_n);
#pragma unroll
    for (int m = 0; m < V; ++m) dst[col + (m << log_h)] = shoup_q(x[m], n_inv, n_inv_s, q);
  }
};

// The block's input rows in device memory. An item of consecutive values
// (log_h = 0: the last pass's) comes in by 16-byte loads (x 16-byte
// aligned: the wrappers check it), any other item by 8-byte loads.
struct DeviceRows {
  const uint64_t* __restrict__ x;
  long long first;
  int have, log_n;
  template <int V>
  __device__ __forceinline__ void load(int row, int col, int log_h, uint64_t (&v)[V]) const {
    const uint64_t* src = x + ((first + row) << log_n) + col;
    if (row >= have) {
#pragma unroll
      for (int m = 0; m < V; ++m) v[m] = 0;
    } else if (log_h == 0 && V % 2 == 0) {
#pragma unroll
      for (int h = 0; h < V / 2; ++h) {
        const ulonglong2 p = __ldg(reinterpret_cast<const ulonglong2*>(src) + h);
        v[2 * h] = p.x;
        v[2 * h + 1] = p.y;
      }
    } else {
#pragma unroll
      for (int m = 0; m < V; ++m) v[m] = __ldg(src + (m << log_h));
    }
  }
};

// The forward transform's values out to device memory from the last pass
// (an item of V = 2 or 4 consecutive values, in 16-byte stores; y is a
// fresh allocation): canonical (the lazy values below 4q brought into [0,
// q) by two minimums), or with kMont, in the Montgomery domain: x 2^64 mod
// q as one Shoup product by r1 = 2^64 mod q with its dual r1_s, exact and
// canonical for any x < 2^64 (u64.cuh's shoup_q), so the lazy values go in
// unreduced. Either way the values of to_montgomery(ntt64_ref(x)) /
// ntt64_ref(x) bit for bit.
template <bool kLazy, bool kMont>
struct ForwardRows {
  uint64_t* __restrict__ y;
  long long first;
  int have, log_n;
  uint64_t q, r1, r1_s;
  template <int V>
  __device__ __forceinline__ void store(int row, int col, int, const uint64_t (&x)[V]) const {
    static_assert(V % 2 == 0, "the last pass's item is 2 or 4 values");
    if (row >= have) return;
    uint64_t v[V];
#pragma unroll
    for (int m = 0; m < V; ++m) {
      if constexpr (kMont) {
        v[m] = shoup_q(x[m], r1, r1_s, q);
      } else {
        v[m] = kLazy ? reduce4(x[m], q) : x[m];
      }
    }
    ulonglong2* dst = reinterpret_cast<ulonglong2*>(y + ((first + row) << log_n) + col);
#pragma unroll
    for (int h = 0; h < V / 2; ++h) dst[h] = make_ulonglong2(v[2 * h], v[2 * h + 1]);
  }
};

// kLogN as polymul's: 11 (N = 2048, every offset a constant), 1 or 2 (N = 2
// or 4: no head pass), or 0 (any N >= 8, log_n as given). src gives the
// first pass its items: a DeviceRows of x (`forward`), or what builds them
// (rns64.cu's cross-shard layer).
template <int kThreads, bool kLazy, int kLogN, bool kMont, class Src>
__device__ __forceinline__ void forward_from(Src& src, uint64_t* __restrict__ y, const Tables& t, long long first,
                                             int per, int have, int log_n_arg, uint64_t r1, uint64_t r1_s,
                                             uint64_t* buf) {
  constexpr int W = kLogN ? last_width(kLogN) : 2;
  const int log_n = kLogN ? kLogN : log_n_arg, threads = kThreads;
  ForwardRows<kLazy, kMont> dst{y, first, have, log_n, t.q, r1, r1_s};
  if constexpr (kLogN == 1 || kLogN == 2) {
    pass<W, false, kLazy>(threads, per, log_n, 0, t, src, dst);
  } else {
    Smem sm{buf, log_n};
    const int hp = head_passes(log_n);
#pragma unroll
    for (int p = 0; p < hp; ++p) {
      if (p == 0) {
        head_pass<false, kLazy>(threads, p, per, log_n, t, src, sm);
      } else {
        head_pass<false, kLazy>(threads, p, per, log_n, t, sm, sm);
      }
      __syncthreads();
    }
    pass<W, false, kLazy>(threads, per, log_n, head_layers(log_n), t, sm, dst);
  }
}

template <int kThreads, bool kLazy, int kLogN, bool kMont>
__device__ __forceinline__ void forward(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, const Tables& t,
                                        long long first, int per, int have, int log_n_arg, uint64_t r1,
                                        uint64_t r1_s, uint64_t* buf) {
  DeviceRows src{x, first, have, kLogN ? kLogN : log_n_arg};
  forward_from<kThreads, kLazy, kLogN, kMont>(src, y, t, first, per, have, log_n_arg, r1, r1_s, buf);
}

// src gives the first pass its items (row, col, log_h 0): a DeviceRows of x,
// or what builds them (rns64.cu's MAC sums).
template <int kThreads, bool kLazy, int kLogN, class Src>
__device__ __forceinline__ void inverse(Src& src, uint64_t* __restrict__ y, const Tables& t, long long first, int per,
                                        int have, int log_n_arg, uint64_t* buf) {
  constexpr int W = kLogN ? last_width(kLogN) : 2;
  const int log_n = kLogN ? kLogN : log_n_arg, threads = kThreads;
  ScaledRows dst{y, first, have, log_n, t.q, t.n_inv, t.n_inv_s};
  if constexpr (kLogN == 1 || kLogN == 2) {
    pass<W, true, kLazy>(threads, per, log_n, 0, t, src, dst);
  } else {
    Smem sm{buf, log_n};
    pass<W, true, kLazy>(threads, per, log_n, head_layers(log_n), t, src, sm);
#pragma unroll
    for (int p = head_passes(log_n) - 1; p >= 0; --p) {
      __syncthreads();
      if (p == 0) {
        head_pass<true, kLazy>(threads, p, per, log_n, t, sm, dst);
      } else {
        head_pass<true, kLazy>(threads, p, per, log_n, t, sm, sm);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K-POLYMUL64: y = INTT(NTT(a) NTT(b)) for the block's `per` rows of each
// operand from row `first` of device memory, `have` of them real (a ragged
// last block reads zeros for the others and does not store them). buf
// holds a's rows, then b's (2 per rows of 2^log_n). Every thread of the
// block calls it.
// ---------------------------------------------------------------------------

// Operand rows in device memory: rows [0, per) are a's, [per, 2 per) b's.
struct OperandRows {
  const uint64_t* __restrict__ a;
  const uint64_t* __restrict__ b;
  long long first;
  int per, have, log_n;
  __device__ __forceinline__ const uint64_t* row_of(int row) const {
    const int r = row < per ? row : row - per;
    return (row < per ? a : b) + ((first + r) << log_n);
  }
  template <int V>
  __device__ __forceinline__ void load(int row, int col, int log_h, uint64_t (&x)[V]) const {
    const bool real = (row < per ? row : row - per) < have;
    const uint64_t* src = row_of(row);
#pragma unroll
    for (int m = 0; m < V; ++m) x[m] = real ? __ldg(src + col + (m << log_h)) : 0;
  }
};

// The last forward layers of a and b, their product (two REDCs, as
// lft64::mul_mod) and the first inverse layers, item by item in registers.
template <int W, bool kLazy, class In, class Out>
__device__ __forceinline__ void polymul_middle(int threads, int per, int log_n, const Tables& t, uint64_t r2, In& in,
                                               Out& out) {
  const int l0 = log_n - W, items = 1 << l0;
  const bool wide = threads >= items;
  const int row0 = wide ? static_cast<int>(threadIdx.x) >> l0 : 0, row_step = wide ? threads >> l0 : 1;
  const Mod mod{t.q, t.neg_q_inv};
  const bool reduce = kLazy && t.q >= (1ull << 60);  // else a b < 16 q^2 < q 2^64 unreduced
  for (int i = threadIdx.x & (items - 1); i < items; i += threads) {
    const int col = i << W;
    uint64_t w[(1 << W) - 1], ws[(1 << W) - 1], wi[(1 << W) - 1], wis[(1 << W) - 1];
    twiddles<W>(w, ws, t.psi, t.psi_s, l0, i);
    twiddles<W>(wi, wis, t.psi_inv, t.psi_inv_s, l0, i);
    for (int row = row0; row < per; row += row_step) {
      uint64_t xa[1 << W], xb[1 << W];
      in.load(row, col, 0, xa);
      in.load(per + row, col, 0, xb);
      fwd_radix<W, kLazy>(xa, w, ws, t.q);
      fwd_radix<W, kLazy>(xb, w, ws, t.q);
#pragma unroll
      for (int m = 0; m < (1 << W); ++m) {
        if (reduce) {
          xa[m] = reduce4(xa[m], t.q);
          xb[m] = reduce4(xb[m], t.q);
        }
        xa[m] = mul_mod(xa[m], xb[m], r2, mod);
      }
      inv_radix<W, kLazy>(xa, wi, wis, t.q);
      out.store(row, col, 0, xa);
    }
  }
}

// kLogN: the ring's log N as a constant (the multi-key sets' 11), with which
// every pass's shape, and so every shared-memory offset, is known when the
// kernel is compiled; 0: log_n as given.
// The product of the block's rows: src gives a's rows (0 .. per-1) and b's
// (per .. 2 per-1) to the first pass (it may be buf itself).
template <int kThreads, bool kLazy, int kLogN, class Src>
__device__ __forceinline__ void polymul(Src& src, uint64_t* __restrict__ y, const Tables& t, long long first, int per,
                                        int have, int log_n_arg, uint64_t r2, uint64_t* buf) {
  const int log_n = kLogN ? kLogN : log_n_arg, threads = kThreads;
  const int hp = head_passes(log_n);
  Smem sm{buf, log_n};
  ScaledRows dst{y, first, have, log_n, t.q, t.n_inv, t.n_inv_s};
#pragma unroll
  for (int p = 0; p < hp; ++p) {  // a's and b's rows together
    if (p == 0) {
      head_pass<false, kLazy>(threads, p, 2 * per, log_n, t, src, sm);
    } else {
      head_pass<false, kLazy>(threads, p, 2 * per, log_n, t, sm, sm);
    }
    __syncthreads();
  }
  if (last_width(log_n) == 2) {
    if (hp == 0) {
      polymul_middle<2, kLazy>(threads, per, log_n, t, r2, src, dst);
    } else {
      polymul_middle<2, kLazy>(threads, per, log_n, t, r2, sm, sm);
    }
  } else {
    polymul_middle<1, kLazy>(threads, per, log_n, t, r2, src, dst);  // N = 2: no head pass
  }
#pragma unroll
  for (int p = hp - 1; p >= 0; --p) {
    __syncthreads();
    if (p == 0) {
      head_pass<true, kLazy>(threads, p, per, log_n, t, sm, dst);
    } else {
      head_pass<true, kLazy>(threads, p, per, log_n, t, sm, sm);
    }
  }
}

// K-POLYMUL64 at N = 2048, a block per row pair: thread 0 brings a's and
// b's rows into buf by two bulk copies (TMA) on an mbarrier, the block
// waits for them and runs the passes in place. sh: the mbarrier, then buf
// (2 x 2048 u64), 16-byte aligned.
constexpr int kBulkLogN = 11;

template <int kThreads, bool kLazy>
__device__ __forceinline__ void polymul_bulk(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                                             uint64_t* __restrict__ y, const Tables& t, uint64_t r2, uint64_t* bar,
                                             uint64_t* buf) {
  constexpr int n = 1 << kBulkLogN;
  constexpr uint32_t kRowBytes = n * sizeof(uint64_t);
  const long long row = blockIdx.x;
  if (threadIdx.x == 0) {
    lft::bulk::mbar_init(bar);
    lft::bulk::mbar_expect(bar, 2 * kRowBytes);
    lft::bulk::bulk_copy(buf, a + (row << kBulkLogN), kRowBytes, bar);
    lft::bulk::bulk_copy(buf + n, b + (row << kBulkLogN), kRowBytes, bar);
  }
  __syncthreads();  // the mbarrier is initialised before any thread waits on it
  lft::bulk::mbar_wait(bar, 0);
  Smem src{buf, kBulkLogN};
  polymul<kThreads, kLazy, kBulkLogN>(src, y, t, row, 1, 1, kBulkLogN, r2, buf);
}

// ---------------------------------------------------------------------------
// K-EXTPROD64: the external product (or key switch) of one RLWE ciphertext,
// a block's whole work. acc (rows 0 and 1 of sh: a and b) holds the input;
// the digit rows pass through buf (`group` rows after acc) a group at a
// time. A group's head passes start from the digits (pass 0 makes them from
// acc); its last forward pass (W = last_width layers, an item of 2^W
// consecutive values) runs item by item into the contraction: each row's
// transformed values times the key's a and b rows at those positions,
// summed in 128 bits over the group's rows, one REDC per group (below q
// 2^64: ext_group), the group residues added mod q. REDC(t1) + REDC(t2) =
// (t1 + t2) 2^-64 mod q, and every value is congruent to its reduced one,
// so the sums are those of one REDC of every row's canonical products. A
// thread owns the last pass's items k, k + threads, ... (kOwn at most) in
// every group. After the last group the first inverse pass runs on those
// sums in registers and writes acc; the other inverse passes run on acc,
// the last scaled by 1/N (and, for a key switch, b + the input's b) into
// device memory. At N <= 4 there is no head pass: the contraction makes its
// digits from acc and the inverse pass in registers writes device memory.
// ---------------------------------------------------------------------------

constexpr int kExtThreads = 256;
constexpr int kOwn = 2;  // last-pass items a thread owns (at N = 2048)
// Shared memory a block may take where two share an SM (228 KB, 1 KB of it
// reserved per block).
constexpr int kExtSmem = 115 * 1024;

// The block's threads: one per last-pass item, at most 256.
__host__ __device__ constexpr int ext_threads(int log_n) {
  return (1 << log_n >> last_width(log_n)) < kExtThreads ? 1 << log_n >> last_width(log_n) : kExtThreads;
}

// The digit rows of a group: as many of `rows` as fit beside acc in a
// block's share of an SM (5 at N = 2048), and on the lazy instance no more
// than whose unreduced products (below 4q times below q) sum below q 2^64:
// G 4q <= 2^64 - 1 (the eager instance's canonical ones: rows (q-1)^2 < q
// 2^64, which the host checks for all rows).
__host__ __device__ constexpr int ext_group(int log_n, int rows, uint64_t q) {
  const int fit = kExtSmem / 8 / (1 << log_n) - 2 < rows ? kExtSmem / 8 / (1 << log_n) - 2 : rows;
  const uint64_t lazy_rows = lazy_ok(q) ? ~0ull / (4 * q) : static_cast<uint64_t>(rows);
  return static_cast<uint64_t>(fit) < lazy_rows ? fit : static_cast<int>(lazy_rows);
}

// The gadget digits of a group's rows, made from acc as pass 0 reads them:
// row r of the group is digit row r0 + r, of a (rows < d, or every row of a
// key switch) or of b. An item's lifted values are kept over its rows.
struct DigitRows {
  const uint64_t* acc;
  const Gadget& g;
  uint64_t q;
  int r0, log_n;
  bool key_switch;
  int cached_col = -1, cached_src = -1;
  uint64_t lifted[8];
  template <int V>
  __device__ __forceinline__ void load(int row, int col, int log_h, uint64_t (&x)[V]) {
    const int r = r0 + row;
    const int src = key_switch || r < g.d ? 0 : 1;
    if (col != cached_col || src != cached_src) {
      const uint64_t* p = acc + (src << log_n) + col;
#pragma unroll
      for (int m = 0; m < V; ++m) lifted[m] = lift(p[m << log_h], g, q);
      cached_col = col;
      cached_src = src;
    }
    const int i = src ? r - g.d : r;
#pragma unroll
    for (int m = 0; m < V; ++m) x[m] = digit(lifted[m], g, i, q);
  }
};

// The results out to device memory, scaled by 1/N; with a key switch, b +
// the input's b.
struct ResultRows {
  uint64_t* __restrict__ out_a;
  uint64_t* __restrict__ out_b;
  const uint64_t* __restrict__ in_b;
  size_t base;
  uint64_t q, n_inv, n_inv_s;
  template <int V>
  __device__ __forceinline__ void store(int row, int col, int log_h, const uint64_t (&x)[V]) const {
    uint64_t* dst = (row ? out_b : out_a) + base;
#pragma unroll
    for (int m = 0; m < V; ++m) {
      const int j = col + (m << log_h);
      uint64_t v = shoup_q(x[m], n_inv, n_inv_s, q);
      if (row && in_b != nullptr) v = add_q(v, __ldg(in_b + base + j), q);
      dst[j] = v;
    }
  }
};

// V (2 or 4) consecutive u64 of device memory, 16-byte aligned (the wrapper
// checks the key's base), in 16-byte loads.
template <int V>
__device__ __forceinline__ void load_key(const uint64_t* __restrict__ p, uint64_t (&v)[V]) {
#pragma unroll
  for (int h = 0; h < V / 2; ++h) {
    const ulonglong2 x = __ldg(reinterpret_cast<const ulonglong2*>(p) + h);
    v[2 * h] = x.x;
    v[2 * h + 1] = x.y;
  }
}

// kLogN as polymul's: 11 (the multi-key sets' N = 2048, every offset a
// constant), 1 or 2 (N = 2 or 4, no head pass), or 0 (any N >= 8, log_n as
// given).
template <bool kLazy, int kLogN>
__device__ __forceinline__ void external_product(uint64_t* sh, int group, const uint64_t* __restrict__ ct_a,
                                                 const uint64_t* __restrict__ ct_b, uint64_t* __restrict__ out_a,
                                                 uint64_t* __restrict__ out_b, size_t ct,
                                                 const uint64_t* __restrict__ ka, const uint64_t* __restrict__ kb,
                                                 int rows, bool key_switch, const Tables& t, const Gadget& g,
                                                 int log_n_arg) {
  constexpr int W = kLogN ? last_width(kLogN) : 2, V = 1 << W;
  // the last-pass items a thread owns: kOwn, or what a constant ring needs
  constexpr int own = kLogN ? ((1 << kLogN >> W) + ext_threads(kLogN) - 1) / ext_threads(kLogN) : kOwn;
  const int log_n = kLogN ? kLogN : log_n_arg;
  const int n = 1 << log_n, threads = kLogN ? ext_threads(kLogN) : static_cast<int>(blockDim.x);
  const uint64_t q = t.q;
  const Mod mod{q, t.neg_q_inv};
  const size_t base = ct << log_n;
  uint64_t* acc = sh;
  Smem acc_rows{acc, log_n}, buf{sh + 2 * n, log_n};
  for (int j = threadIdx.x; j < n; j += threads) {
    acc[j] = __ldg(ct_a + base + j);
    acc[n + j] = __ldg(ct_b + base + j);
  }
  __syncthreads();
  const int hp = head_passes(log_n), l0 = head_layers(log_n), items = n >> W;
  const bool head = kLogN == 0 || hp > 0;  // a constant
  uint64_t ra[own][V], rb[own][V];
#pragma unroll
  for (int k = 0; k < own; ++k) {
#pragma unroll
    for (int m = 0; m < V; ++m) ra[k][m] = rb[k][m] = 0;
  }
  for (int r0 = 0; r0 < rows; r0 += group) {
    const int gr = min(group, rows - r0);
    DigitRows digits{acc, g, q, r0, log_n, key_switch};
    if (head) {
      head_pass<false, kLazy>(threads, 0, gr, log_n, t, digits, buf);
#pragma unroll
      for (int p = 1; p < hp; ++p) {
        __syncthreads();
        head_pass<false, kLazy>(threads, p, gr, log_n, t, buf, buf);
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < own; ++k) {
      const int i = threadIdx.x + k * threads;
      if (i < items) {
        uint64_t w[V - 1], ws[V - 1], ha[V], la[V], hb[V], lb[V];
        twiddles<W>(w, ws, t.psi, t.psi_s, l0, i);
#pragma unroll
        for (int m = 0; m < V; ++m) ha[m] = la[m] = hb[m] = lb[m] = 0;
        for (int r = 0; r < gr; ++r) {
          uint64_t x[V], ya[V], yb[V];
          const size_t key = (static_cast<size_t>(r0 + r) << log_n) + V * i;
          load_key(ka + key, ya);
          load_key(kb + key, yb);
          if (head) {
            buf.load(r, V * i, 0, x);
          } else {
            digits.load(r, V * i, 0, x);
          }
          fwd_radix<W, kLazy>(x, w, ws, q);  // lazy: below 4q, unreduced
#pragma unroll
          for (int m = 0; m < V; ++m) {
            mac128(ha[m], la[m], x[m], ya[m]);
            mac128(hb[m], lb[m], x[m], yb[m]);
          }
        }
#pragma unroll
        for (int m = 0; m < V; ++m) {
          ra[k][m] = add_q(ra[k][m], redc(ha[m], la[m], mod), q);
          rb[k][m] = add_q(rb[k][m], redc(hb[m], lb[m], mod), q);
        }
      }
    }
    __syncthreads();  // buf is read (and acc, after the last group)
  }
  ResultRows result{out_a, out_b, key_switch ? ct_b : nullptr, base, q, t.n_inv, t.n_inv_s};
#pragma unroll
  for (int k = 0; k < own; ++k) {
    const int i = threadIdx.x + k * threads;
    if (i < items) {
      uint64_t w[V - 1], ws[V - 1];
      twiddles<W>(w, ws, t.psi_inv, t.psi_inv_s, l0, i);
      inv_radix<W, kLazy>(ra[k], w, ws, q);
      inv_radix<W, kLazy>(rb[k], w, ws, q);
      if (head) {
        acc_rows.store(0, V * i, 0, ra[k]);
        acc_rows.store(1, V * i, 0, rb[k]);
      } else {
        result.store(0, V * i, 0, ra[k]);
        result.store(1, V * i, 0, rb[k]);
      }
    }
  }
#pragma unroll
  for (int p = hp - 1; p >= 0; --p) {
    __syncthreads();
    if (p == 0) {
      head_pass<true, kLazy>(threads, p, 2, log_n, t, acc_rows, result);
    } else {
      head_pass<true, kLazy>(threads, p, 2, log_n, t, acc_rows, acc_rows);
    }
  }
}

}  // namespace rows
}  // namespace lft64
