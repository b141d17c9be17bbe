// The RNS u64 engine of CKKS: K-RNS-NTT, K-RNS-MAC, K-BASECONV and
// K-RESCALE, on u64 residues of (..., L, N) tensors whose limb l is reduced
// mod its own odd prime q_l < 2^63.
//
// Replace the XLA fusions of learn_fhe_tpu/ops/rns.py (no Pallas call):
//   K-RNS-NTT   <- fwd_stages / inv_stages via rns_ntt / rns_intt
//                  (rns.py:123,193,252,259)
//   K-RNS-MAC   <- rns_mul_eval (rns.py:280), CKKS mul's tensor and
//                  _ks_dot (models/ckks/ckks.py:588-597,706-716); inside
//                  K-RNS-NTT's inverse (rns_intt_mac) <- rns_intt of them
//                  under one jit (rns.py:193,280,287; ckks.py:592-597,738-739)
//   K-BASECONV  <- extend_bases / switch_bases (rns.py:356-422); writing
//                  into a caller's rows, with x's own limbs copied beside
//                  them <- the concatenate, permute and stack of the key
//                  switch's hoist (models/ckks/ckks.py:692 _ks_hoist,
//                  models/bgv/bgv.py:495, models/ckks/evalmod.py mod_raise)
//   K-RESCALE   <- rescale_k's add of P/2, subtraction and division by P
//                  (rns.py:426-464), with the rns_add after it where one
//                  follows (models/ckks/ckks.py:600,675,741)
//   K-RNS-ADD   <- rns_add / rns_sub / rns_neg (rns.py:268-278)
//   K-RNS-MAC's gathered instances <- the evaluation-slot permutation of
//                  the hoisted mask and of b before their products
//                  (models/ckks/bootstrapping.py:142-147, ckks.py:666)
//   K-AUTOMORPH <- _automorphism_rns (models/ckks/ckks.py:605-611)
// On CKKS's mul + relinearize + rescale they are every launch; on its
// rotations and bootstrap, with the last two.
//
// What bounds them on an H100: a transform moves 2 x 8 B per value and does
// log N u64 Shoup butterflies per pair (some twenty 32-bit instructions
// each), the other three a few u64 products per value read: the integer
// issue rate and the bytes are of the same order.
//
// The design:
// - K-RNS-NTT (redesigned for the H100): the row passes of u64_rows.cuh
//   (head passes of 3 layers, a last pass of 2 on items of 4 consecutive
//   values) under each row's limb's tables (row r under limb r mod L), the
//   first pass reading device memory and the last writing it. The first
//   version gave each 64 KB row of N = 2^13 one 512-thread block: one block
//   an SM by its registers, so at the CKKS mul's 128-row launches each SM
//   ran one barrier-separated chain with nothing to fill its waits (0.23 of
//   the bound, PERF.md). From N = 2048 up a row is now spread over a
//   cluster of kCluster blocks (2 of 256 threads, 4 sub-rows each: of the
//   shapes measured, 8 x 128, 4 x 128, 4 x 256, 2 x 512 and a first pass
//   through L2 as a kernel of its own, the fastest at the CKKS mul's
//   launches, PERF.md): the first pass's 3 layers leave 8
//   independent sub-rows of N/8 values; block c of the cluster runs that
//   pass on its share of the row's items (read from device memory) and
//   writes each output into the shared memory of the block holding its
//   sub-row (distributed shared memory), and after one cluster barrier
//   each block runs the other passes on its sub-rows alone, the last one
//   into device memory in 16-byte stores. The inverse runs the same passes
//   the other way: the last pass from device memory in 16-byte loads, the
//   head passes down to layer 3 on the block's sub-rows, a cluster barrier,
//   then the first pass on the cluster's share of items, each value read
//   from the block that holds it and scaled by 1/N on its way out. N = 2^13
//   (CKKS's ring) has an instance with every pass's shape a constant. Past
//   it (the production bootstrap's N = 2^16, and 2^14, 2^15) a block's 4
//   sub-rows would outgrow its shared memory (256 KB at 2^16), so the
//   cluster grows with the ring: 2^(log N - 13) blocks of 8 / C sub-rows,
//   2^13 values (64 KB, dynamic shared memory) a block, the same passes
//   (a cluster of 8 at 2^16, one sub-row a block), lazy instances only,
//   every shape a constant; every rns_intt_mac instance but the shared-x
//   one (which stays at 2^13: its x row would be 512 KB) takes the same
//   clusters. Below N = 2048 a block takes one row through rows::forward /
//   rows::inverse. Lazy (Harvey) butterflies where every prime is below
//   2^62.
// - Past N = 2^13, redesigned for the H100 from a pass split by clock64()
//   stamps and the occupancy calculator (PERF.md): BGV's mul launches 64
//   and 128 rows at 2^14, 128 and 256 blocks of 8 warps, so an SM ran one
//   block's barrier-separated chain of passes alone. Smaller blocks, 4 or 8
//   a row, lost: clusters of 4 and 8 place on 124 of the 132 SMs, and 64
//   rows of 8-block clusters took a second wave (62 fit). What paid: at
//   2^14 a launch whose rows the card holds at once takes a wide instance,
//   512 threads on the same 64 KB (a thread's items of a pass halved; 64
//   registers for the transforms, 2 blocks an SM), its buffer swizzled so
//   that the head pass from layer 9 (groups of 4 columns 32 apart) spreads
//   over the banks, each sub-row's block mapped where it is used; at 2^16
//   the key switch's sums (a run-time count of terms, 102 registers: 2
//   blocks an SM) with ptxas held to 80 registers, so that the 3 blocks its
//   64 KB allow share an SM. Every other launch past 2^13 keeps these
//   clusters of 256-thread blocks, which measured fastest at its rows (a
//   wide instance at 256 rows, and 512 or 1024 threads at 2^16, were
//   slower). The 2^13 instances keep their launch bounds: a minimum of one
//   block an SM let ptxas take 92 registers in the forward, and 256-row
//   launches lost 15%.
// - K-RNS-MAC (redesigned for the H100): every sum the port makes feeds an
//   inverse transform, so rns_intt_mac builds them inside the inverse's
//   first pass and never stores them: the first version wrote its sums
//   (two thirds of the key switch's bytes) and the inverse read them back.
//   Each 4-value item of that pass is sum_k x_k y_k from 16-byte words of
//   each term's x and y, summed in 128 bits with one REDC per chunk of terms
//   (chunk (q-1)^2 < q 2^64), the chunks added mod q (mac_item). A REDC
//   leaves 2^-64, which the inverse's final scale takes out (N^-1 2^64 in
//   place of N^-1; the transform is Z_q-linear) instead of a REDC a value
//   against 2^128 mod q. A block's output row gives its sum, x row, limb and
//   key row once (the first version took two 64-bit divisions a value). The
//   kernel alone (rns_mac) takes mac_item's sums out of the Montgomery
//   domain by that REDC, an item of 4 values a thread in 16-byte words.
// - K-BASECONV (redesigned for the H100): one thread per coefficient
//   column, its tables in shared memory, loaded once a block. v_i = x_i
//   q_hat_i^-1 (Shoup) in registers where lq is a constant of the instance
//   (1, 2 and 8: the CKKS paths' digit and P sizes), in shared memory in
//   the instance for any lq <= 64; the overflow count in f64 as XLA's CPU
//   backend sums it (one fused multiply-add per limb, in limb order, from
//   0; rint, ties to even); then every output limb as sum_i v_i w'_ji in
//   128 bits, w'_ji = q_hat_i 2^64 mod p_j, one REDC per chunk of terms
//   (chunk max(q) < 2^64), the chunks added mod p_j, less (u Q mod p_j).
//   The first version kept the v_i in a local-memory array indexed at run
//   time and summed Shoup products one modular add at a time (PERF.md).
//   The modular sum is exact, so it equals both of the JAX package's
//   branches (a raw u64 sum and a Barrett, or the log-depth fold past
//   2^64). Given a row table, each output limb goes to its row of the
//   caller's tensor and the thread stores each x limb it has read into its
//   own row too: the key switch's digits land in QP order in one
//   (..., D, Lqp, N) tensor with no copy after (only the store addresses
//   differ; the sums are as before).
// - K-RESCALE: one thread per output value; an add after the division (the
//   key switch's b, the mul's d0 and d1) is one more read and add mod q in
//   the same thread, not a launch of its own.
// - K-RNS-ADD: bytes-bound (three u64 moves a value for one add and one
//   compare): a thread per 16-byte word of a, b and y, the two parts of a
//   ciphertext in one launch (the grid's y), an (L, N) operand read at its
//   row mod L where it repeats over the other's leading axes.
// - K-RNS-MAC's gathered instances (rns_mac / rns_intt_mac with perms):
//   mac_item with a term's x read at the columns of its permutation table
//   (the table in 16-byte words, x in 8-byte loads from its row), a null
//   table reading x in place; separate instances, so the ungathered ones
//   are as they were. The rotations of a hoisted mask then cost no copy.
//   Inside the inverse, where every term reads one x (the bootstrap's b
//   sums; lazy, N = 2^13, 1-4 terms: rns_intt_mac_shared_kernel), each
//   block copies the x row into shared memory by one bulk copy and the
//   tables index it; a thread's tables and y come in 16-byte loads for a
//   group of its items before their sums (redesigned for the H100: the
//   first version's 8-byte loads from L2, an item and a term at a time,
//   cost 4.7-9.6 us a launch, PERF.md).
// - K-AUTOMORPH: one thread per 4 consecutive outputs of b and a, the
//   signed gather of each from its row.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bulk.cuh"
#include "u64.cuh"
#include "u64_rows.cuh"

namespace {

namespace cg = cooperative_groups;

using lft64::add_q;
using lft64::csub;
using lft64::shoup_q;
using lft64::sub_q;

constexpr int kFixedLogN = 13;  // CKKS's ring at its mul and the N = 2^13 bootstrap: every shape a constant
constexpr int kMaxLogN = 16;    // the production bootstrap's ring
constexpr int kThreads = 256;
constexpr int kMaxTerms = 16;
constexpr int kMaxLimbs = 64;
constexpr size_t kMaxSmem = 227 * 1024;  // a block's shared memory at most (dynamic, opted in)

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

constexpr int kNttThreads = 256;  // a cluster's block
constexpr int kRowThreads = 128;  // a row's block below kSplitLogN
constexpr int kSplitLogN = 11;  // from N = 2048 up a row runs on a cluster
constexpr int kSplit = 3;       // the first pass's layers: 8 sub-rows after it
constexpr int kSubs = 1 << kSplit;
constexpr int kCluster = 2;                       // blocks per row up to N = 2^13
constexpr int kPerBlock = kSubs / kCluster;       // sub-rows a block holds there
constexpr int kRowValues = 1 << (kSplitLogN - 1);  // below kSplitLogN: a block's row, at most
constexpr int kBufValues = kPerBlock << (kFixedLogN - kSplit);
// The items a thread takes at N = 2^13 in the inverse's passes that read
// their values from device memory (kItemsAhead, the last two layers) or
// from the other block (kSplitAhead, the first three): unrolled, their
// loads overlap. (Unrolling the forward's first pass measured slower.)
constexpr int kSplitAhead = (1 << (kFixedLogN - kSplit)) / kCluster / kNttThreads;
constexpr int kItemsAhead = (kPerBlock << (kFixedLogN - kSplit - 2)) / kNttThreads;
// Past N = 2^13 a block's 4 sub-rows of N/8 outgrow its shared memory (256
// KB at 2^16): there the cluster grows with the ring instead, 2^(log N -
// 13) blocks (2, 4, 8 at 2^14, 2^15, 2^16), each holding 8 / C sub-rows,
// 2^13 values (64 KB of dynamic shared memory), so every block runs the
// passes of the 2^13 instance's blocks on twice as many values. Smaller
// blocks, more of them a row, lost there: clusters of 4 and 8 blocks place
// on 124 of the card's 132 SMs, and a 64-row launch at 2^14 on clusters of
// 8 took a second wave (62 clusters at once, PERF.md). A launch at 2^14
// whose rows the card holds at once (the BGV mul's 64 and 128 rows: one
// block an SM) takes a wide instance instead, kWideThreads a block on the
// same 64 KB, so that each thread takes half as many items of every pass.
constexpr int kWideLogN = 14;
constexpr int kWideThreads = 512;
constexpr int kWideNttBlocks = 2;  // the wide transforms: 64 registers, 2 blocks an SM (132 clusters)
// The wide sums: 2 blocks an SM with 1 term (64 registers, no spill), 1 with
// 2 (120 registers; at 64 they spilled, PERF.md).
template <int kTerms>
constexpr int kWideMacBlocks = kTerms == 1 ? 2 : 1;

// A cluster instance's shape (kLogN: its ring, or 0 for any N = 2^11,
// 2^12; kThreads: its block, kNttThreads or, for the wide instances,
// kWideThreads): blocks per row, sub-rows a block holds, its dynamic shared
// memory (none up to 2^13: a static buffer), and the items a thread takes
// unrolled in the inverse's first pass and in its last. A wide instance
// swizzles its buffer and maps each sub-row's block where it is used.
template <int kLogN, int kThreads_ = kNttThreads>
struct RowShape {
  static constexpr bool kBig = kLogN > kFixedLogN;
  static constexpr bool kWide = kThreads_ != kNttThreads;
  static constexpr int kThreads = kThreads_;
  static constexpr int kC = kBig ? 1 << (kLogN - kFixedLogN) : kCluster;
  static constexpr int kPer = kSubs / kC;
  static constexpr int kBufBytes = kBig ? (kPer << (kLogN - kSplit)) * static_cast<int>(sizeof(uint64_t)) : 0;
  static constexpr int kAheadSplit = kBig ? (1 << (kLogN - kSplit)) / kC / kThreads : kSplitAhead;
  static constexpr int kAheadItems = kBig ? (kPer << (kLogN - kSplit - 2)) / kThreads : kItemsAhead;
  static_assert(kC <= 8, "a portable cluster holds at most 8 blocks");
  static_assert(!kWide || kBig, "the wide instances run past 2^13");
  static_assert(!kBig || (kAheadSplit >= 1 && kAheadSplit * kC * kThreads == 1 << (kLogN - kSplit)),
                "every thread the same share of the first pass");
  static_assert(!kBig || (kAheadItems >= 1 && kAheadItems * kThreads == kPer << (kLogN - kSplit - 2)),
                "every thread the same share of the last pass");
};

template <int kLogN>
using WideShape = RowShape<kLogN, kWideThreads>;

// A buffer column's place in a block's shared memory: where kSw (the wide
// instances), bits 2-3 of the column XORed with bits 5-6. The head pass
// whose items hold 8 values 4 apart in groups of 4 columns 32 apart (at
// 2^14 the one from layer 9) then has a half-warp's accesses in 16
// distinct banks (4 to a bank without); every other pass's accesses stay
// within their aligned runs of 16 or 32 columns, so they keep theirs.
template <bool kSw>
__device__ __forceinline__ int swz(int col) {
  return kSw ? col ^ (((col >> 5) & 3) << 2) : col;
}

// The tables of limb `limb`.
__device__ __forceinline__ lft64::Tables limb_tables(const Stacked& s, int limb, int log_n) {
  const size_t off = static_cast<size_t>(limb) << log_n;
  return lft64::Tables{s.psi + off,          s.psi_s + off,          s.psi_inv + off,          s.psi_inv_s + off,
                       __ldg(s.q + limb),    __ldg(s.neg_q_inv + limb), __ldg(s.n_inv + limb), __ldg(s.n_inv_s + limb)};
}

// The cluster barrier in halves: an arrival that orders no memory, and the
// wait for every thread of the cluster to arrive.
__device__ __forceinline__ void cluster_arrive_relaxed() { asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;\n" ::: "memory"); }

// An item's twiddles and their Shoup duals, as lft64::twiddles gives them:
// layer t's 2^t of them are consecutive in the table from ((2^l0 + g) <<
// t), so past the first they come in 16-byte loads (the stacked tables and
// each limb's row of them start on a 16-byte boundary).
template <int W>
__device__ __forceinline__ void item_twiddles(uint64_t (&w)[(1 << W) - 1], uint64_t (&ws)[(1 << W) - 1],
                                              const uint64_t* __restrict__ tab, const uint64_t* __restrict__ tab_s,
                                              int l0, int g) {
  w[0] = __ldg(tab + (1 << l0) + g);
  ws[0] = __ldg(tab_s + (1 << l0) + g);
#pragma unroll
  for (int t = 1; t < W; ++t) {
    const auto* a = reinterpret_cast<const ulonglong2*>(tab + (((1 << l0) + g) << t));
    const auto* b = reinterpret_cast<const ulonglong2*>(tab_s + (((1 << l0) + g) << t));
#pragma unroll
    for (int h = 0; h < (1 << t) / 2; ++h) {
      const ulonglong2 x = __ldg(a + h), y = __ldg(b + h);
      w[(1 << t) - 1 + 2 * h] = x.x;
      w[(1 << t) + 2 * h] = x.y;
      ws[(1 << t) - 1 + 2 * h] = y.x;
      ws[(1 << t) + 2 * h] = y.y;
    }
  }
}

// Values of the block's sub-rows: in shared memory (Buf, swizzled where
// kSw), or in device memory from the block's first sub-row on (Dev: 16-byte
// loads for an item of consecutive values, as rows::DeviceRows; the
// forward's canonical output in 16-byte stores, as rows::ForwardRows).
// An item of consecutive values (the last pass's) moves in 16-byte words:
// a warp's access then takes half the wavefronts of 8-byte ones.
template <bool kSw = false>
struct Buf {
  uint64_t* p;
  template <int V>
  __device__ __forceinline__ void load(int col, int log_h, uint64_t (&x)[V]) const {
    if (log_h == 0 && V % 2 == 0) {
#pragma unroll
      for (int h = 0; h < V / 2; ++h) {
        const ulonglong2 v = reinterpret_cast<const ulonglong2*>(p + swz<kSw>(col))[h];
        x[2 * h] = v.x;
        x[2 * h + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int m = 0; m < V; ++m) x[m] = p[swz<kSw>(col + (m << log_h))];
    }
  }
  template <int V>
  __device__ __forceinline__ void store(int col, int log_h, const uint64_t (&x)[V]) const {
    if (log_h == 0 && V % 2 == 0) {
#pragma unroll
      for (int h = 0; h < V / 2; ++h) {
        reinterpret_cast<ulonglong2*>(p + swz<kSw>(col))[h] = make_ulonglong2(x[2 * h], x[2 * h + 1]);
      }
    } else {
#pragma unroll
      for (int m = 0; m < V; ++m) p[swz<kSw>(col + (m << log_h))] = x[m];
    }
  }
};

template <bool kLazy>
struct Dev {
  const uint64_t* __restrict__ x;
  uint64_t* __restrict__ y;
  uint64_t q;
  template <int V>
  __device__ __forceinline__ void load(int col, int, uint64_t (&v)[V]) const {
    static_assert(V % 2 == 0, "the last pass's item is 2 or 4 values");
#pragma unroll
    for (int h = 0; h < V / 2; ++h) {
      const ulonglong2 p = __ldg(reinterpret_cast<const ulonglong2*>(x + col) + h);
      v[2 * h] = p.x;
      v[2 * h + 1] = p.y;
    }
  }
  template <int V>
  __device__ __forceinline__ void store(int col, int, const uint64_t (&v)[V]) const {
    static_assert(V % 2 == 0, "the last pass's item is 2 or 4 values");
    ulonglong2* dst = reinterpret_cast<ulonglong2*>(y + col);
#pragma unroll
    for (int h = 0; h < V / 2; ++h) {
      dst[h] = kLazy ? make_ulonglong2(lft64::reduce4(v[2 * h], q), lft64::reduce4(v[2 * h + 1], q))
                     : make_ulonglong2(v[2 * h], v[2 * h + 1]);
    }
  }
};

// A pass of W layers from l0 >= kSplit over the block's Sh::kPer sub-rows
// (the row's sub-rows sub0, sub0 + 1, ...; buffer column (s << log_s) + c
// for column c of its sub-row s). Item i of a sub-row holds the values c +
// (m << log_h), m < 2^W, c = (g << (log_n - l0)) + (i mod h), g = i / h, h =
// 2^(log_n - l0 - W): its items are those of the whole row's pass (rows::pass)
// that fall in it, so its twiddle group is (sub << (l0 - kSplit)) + g. The
// block's threads take the items k, k + Sh::kThreads, ... of its sub-rows
// one after the other; kAhead of them unrolled, so that a pass reading
// device memory has their loads in flight together. No barrier.
template <class Sh, int W, bool kInv, bool kLazy, int kAhead = 1, class In, class Out>
__device__ __forceinline__ void sub_pass(int sub0, int log_n, int l0, const lft64::Tables& t, const In& in,
                                         const Out& out) {
  const int log_s = log_n - kSplit, log_h = log_n - l0 - W, log_items = log_s - W;
#pragma unroll (kAhead)
  for (int k = threadIdx.x; k < (Sh::kPer << log_items); k += Sh::kThreads) {
    const int s = k >> log_items, i = k & ((1 << log_items) - 1), g = i >> log_h;
    const int col = (s << log_s) + (g << (log_n - l0)) + (i & ((1 << log_h) - 1));
    const int tg = ((sub0 + s) << (l0 - kSplit)) + g;
    uint64_t w[(1 << W) - 1], ws[(1 << W) - 1], x[1 << W];
    in.load(col, log_h, x);
    if constexpr (kInv) {
      item_twiddles<W>(w, ws, t.psi_inv, t.psi_inv_s, l0, tg);
      lft64::inv_radix<W, kLazy>(x, w, ws, t.q);
    } else {
      item_twiddles<W>(w, ws, t.psi, t.psi_s, l0, tg);
      lft64::fwd_radix<W, kLazy>(x, w, ws, t.q);
    }
    out.store(col, log_h, x);
  }
}

// Head pass p >= 1 (layers 3 p, ..., its width) on the block's sub-rows.
template <class Sh, bool kInv, bool kLazy, class In, class Out>
__device__ __forceinline__ void sub_head_pass(int p, int sub0, int log_n, const lft64::Tables& t, const In& in,
                                              const Out& out) {
  const int w = lft64::rows::head_width(log_n, p);
  if (w == 3) {
    sub_pass<Sh, 3, kInv, kLazy>(sub0, log_n, 3 * p, t, in, out);
  } else if (w == 2) {
    sub_pass<Sh, 2, kInv, kLazy>(sub0, log_n, 3 * p, t, in, out);
  } else {
    sub_pass<Sh, 1, kInv, kLazy>(sub0, log_n, 3 * p, t, in, out);
  }
}

// The buffer column 0 of each of the row's sub-rows, in the block of the
// cluster that holds it.
template <int kPer>
__device__ __forceinline__ void sub_row_holders(cg::cluster_group& cluster, uint64_t* buf, int log_s,
                                                uint64_t* (&holder)[kSubs]) {
#pragma unroll
  for (int m = 0; m < kSubs; ++m) {
    holder[m] = cluster.map_shared_rank(buf, m / kPer) + ((m % kPer) << log_s);
  }
}

// The buffer column 0 of sub-row m: from `holder`, or in a wide instance
// mapped where it is used (not held in registers across the pass).
template <class Sh>
__device__ __forceinline__ uint64_t* holder_of(cg::cluster_group& cluster, uint64_t* buf, int log_s,
                                               uint64_t* const (&holder)[kSubs], int m) {
  if constexpr (Sh::kWide) {
    return cluster.map_shared_rank(buf, m / Sh::kPer) + ((m % Sh::kPer) << log_s);
  } else {
    return holder[m];
  }
}

// cluster_inverse's last pass: sub_pass, or, for the sums from a shared x
// row (RowSums, below), staged_last_pass.
template <int kTerms>
struct RowSums;

template <class Sh, bool kLazy, int kAhead, class Src, class Out>
__device__ __forceinline__ void inverse_last_pass(int sub0, int log_n, const lft64::Tables& t, const Src& src,
                                                  const Out& out) {
  sub_pass<Sh, 2, true, kLazy, kAhead>(sub0, log_n, log_n - 2, t, src, out);
}

template <class Sh, bool kLazy, int kAhead, int kTerms>
__device__ __forceinline__ void inverse_last_pass(int sub0, int, const lft64::Tables& t, const RowSums<kTerms>& src,
                                                  const Buf<>& out);

// The inverse of one row on its cluster into y (the row's 2^log_n values):
// the last pass (2 layers) takes its items from src (kAhead of them
// unrolled) into the block's sub-rows, the head passes down to layer 3 run
// on them, a cluster barrier, then the first pass on the cluster's share of
// items, each value read from the block that holds it and scaled by t.n_inv
// on its way out. Every thread of the cluster calls it. Sh: the instance's
// RowShape.
template <class Sh, bool kLazy, int kAhead, class Src>
__device__ __forceinline__ void cluster_inverse(const Src& src, uint64_t* __restrict__ y, const lft64::Tables& t,
                                                int log_n, uint64_t* buf) {
  cg::cluster_group cluster = cg::this_cluster();
  const int log_s = log_n - kSplit, hp = lft64::rows::head_passes(log_n);
  const int rank = static_cast<int>(cluster.block_rank()), sub0 = rank * Sh::kPer;
  const int share = (1 << log_s) / Sh::kC, first = rank * share;
  uint64_t* holder[kSubs];
  if constexpr (!Sh::kWide) sub_row_holders<Sh::kPer>(cluster, buf, log_s, holder);
  Buf<Sh::kWide> sm{buf};
  inverse_last_pass<Sh, kLazy, kAhead>(sub0, log_n, t, src, sm);
#pragma unroll
  for (int p = hp - 1; p >= 1; --p) {
    __syncthreads();
    sub_head_pass<Sh, true, kLazy>(p, sub0, log_n, t, sm, sm);
  }
  cluster.sync();  // every sub-row is done
  uint64_t w[kSubs - 1], ws[kSubs - 1];
  item_twiddles<kSplit>(w, ws, t.psi_inv, t.psi_inv_s, 0, 0);
#pragma unroll (Sh::kAheadSplit)
  for (int k = threadIdx.x; k < share; k += Sh::kThreads) {
    const int i = first + k;
    uint64_t v[kSubs];
#pragma unroll
    for (int m = 0; m < kSubs; ++m) v[m] = holder_of<Sh>(cluster, buf, log_s, holder, m)[swz<Sh::kWide>(i)];
    lft64::inv_radix<kSplit, kLazy>(v, w, ws, t.q);
#pragma unroll
    for (int m = 0; m < kSubs; ++m) y[i + (m << log_s)] = shoup_q(v[m], t.n_inv, t.n_inv_s, t.q);
  }
  cluster.sync();  // no block leaves while another reads its buffer
}

// A cluster block's buffer of sub-rows: static up to N = 2^13, the dynamic
// Sh::kBufBytes past it (which the launch passes).
template <class Sh>
__device__ __forceinline__ uint64_t* row_buf() {
  if constexpr (Sh::kBig) {
    extern __shared__ __align__(16) uint64_t big_buf[];
    return big_buf;
  } else {
    __shared__ __align__(16) uint64_t buf[kBufValues];
    return buf;
  }
}

// The last forward cross-shard layer of a coefficient-sharded transform
// (parallel/coef.py), run in the first pass's loads: each value of a row is
// lft64::cross_fwd of x's value and of the partner's block v's at its place
// (v in x's layout), under the row's limb's twiddle t[limb] and its Shoup
// dual ts[limb] (limb = row mod L, as limb_tables takes it).
struct Cross64 {
  const uint64_t* __restrict__ v;
  const uint64_t* __restrict__ t;
  const uint64_t* __restrict__ ts;
  int upper;
};

// One row on a cluster of Sh::kC blocks (grid: rows x kC; N >= 2048).
// kLogN: 13 to 16 (every shape a constant) or 0 (log_n as given, 2^11 or
// 2^12); Sh: its RowShape. kCross: the forward's first pass takes its
// values through cr (Cross64) from x and cr.v.
template <bool kInv, bool kLazy, int kLogN, class Sh = RowShape<kLogN>, bool kCross = false>
__device__ __forceinline__ void ntt_row(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, const Stacked& st,
                                        int limbs, int log_n_arg, Cross64 cr = {}) {
  uint64_t* buf = row_buf<Sh>();
  cg::cluster_group cluster = cg::this_cluster();
  const int log_n = kLogN ? kLogN : log_n_arg;
  const int log_s = log_n - kSplit;
  const int rank = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / Sh::kC;
  const int limb = static_cast<int>(row % limbs);
  const lft64::Tables t = limb_tables(st, limb, log_n);
  const int sub0 = rank * Sh::kPer;
  const size_t base = static_cast<size_t>(row) << log_n;
  const size_t mine = base + (static_cast<size_t>(sub0) << log_s);
  if constexpr (kInv) {
    cluster_inverse<Sh, kLazy, Sh::kAheadItems>(Dev<kLazy>{x + mine, nullptr, t.q}, y + base, t, log_n, buf);
  } else {
    // the first pass: this block's share of the row's 2^log_s items
    const int share = (1 << log_s) / Sh::kC, first = rank * share;
    uint64_t* holder[kSubs];
    if constexpr (!Sh::kWide) sub_row_holders<Sh::kPer>(cluster, buf, log_s, holder);
    uint64_t w[kSubs - 1], ws[kSubs - 1];
    Buf<Sh::kWide> sm{buf};
    // a block writes into another's shared memory only once every block of
    // the cluster has started: an arrival here, the wait before the first
    // store, the loads and butterflies of the first item between them
    cluster_arrive_relaxed();
    bool started = false;
    item_twiddles<kSplit>(w, ws, t.psi, t.psi_s, 0, 0);
    uint64_t ct = 0, cts = 0;
    if constexpr (kCross) ct = __ldg(cr.t + limb), cts = __ldg(cr.ts + limb);
    for (int k = threadIdx.x; k < share; k += Sh::kThreads) {
      const int i = first + k;
      uint64_t v[kSubs];
#pragma unroll
      for (int m = 0; m < kSubs; ++m) v[m] = __ldg(x + base + i + (m << log_s));
      if constexpr (kCross) {
        uint64_t p[kSubs];
#pragma unroll
        for (int m = 0; m < kSubs; ++m) p[m] = __ldg(cr.v + base + i + (m << log_s));
#pragma unroll
        for (int m = 0; m < kSubs; ++m) v[m] = lft64::cross_fwd(v[m], p[m], ct, cts, t.q, cr.upper);
      }
      lft64::fwd_radix<kSplit, kLazy>(v, w, ws, t.q);
      if (!started) {
        cluster_wait();
        started = true;
      }
#pragma unroll
      for (int m = 0; m < kSubs; ++m) holder_of<Sh>(cluster, buf, log_s, holder, m)[swz<Sh::kWide>(i)] = v[m];
    }
    if (!started) cluster_wait();
    cluster.sync();  // every sub-row is in its block
#pragma unroll
    for (int p = 1; p < lft64::rows::head_passes(log_n); ++p) {
      if (p > 1) __syncthreads();
      sub_head_pass<Sh, false, kLazy>(p, sub0, log_n, t, sm, sm);
    }
    __syncthreads();
    Dev<kLazy> dst{nullptr, y + mine, t.q};
    sub_pass<Sh, 2, false, kLazy>(sub0, log_n, log_n - 2, t, sm, dst);
  }
}

template <bool kInv, bool kLazy, int kLogN>
__global__ void __launch_bounds__(kNttThreads)
    rns_ntt_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, Stacked st, int limbs, int log_n_arg) {
  ntt_row<kInv, kLazy, kLogN>(x, y, st, limbs, log_n_arg);
}

// The wide instance (lazy, 2^14): kWideThreads a block on the 64 KB of
// the ring's cluster, ptxas held to the registers that let kWideNttBlocks
// blocks share an SM.
template <bool kInv, int kLogN>
__global__ void __launch_bounds__(kWideThreads, kWideNttBlocks)
    rns_ntt_wide_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, Stacked st, int limbs) {
  ntt_row<kInv, true, kLogN, WideShape<kLogN>>(x, y, st, limbs, kLogN);
}

// Below N = 2048: a block per row (kLogN 1 or 2: N = 2 or 4, no head pass;
// 0: any other N).
template <bool kInv, bool kLazy, int kLogN>
__global__ void __launch_bounds__(kRowThreads)
    rns_ntt_rows_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, Stacked st, int limbs, int log_n) {
  __shared__ __align__(16) uint64_t buf[kLogN == 1 || kLogN == 2 ? 1 : kRowValues];
  const long long row = blockIdx.x;
  const lft64::Tables t = limb_tables(st, static_cast<int>(row % limbs), log_n);
  if constexpr (kInv) {
    lft64::rows::DeviceRows src{x, row, 1, kLogN ? kLogN : log_n};
    lft64::rows::inverse<kRowThreads, kLazy, kLogN>(src, y, t, row, 1, 1, log_n, buf);
  } else {
    lft64::rows::forward<kRowThreads, kLazy, kLogN, false>(x, y, t, row, 1, 1, log_n, 0, 0, buf);
  }
}

// The fused forward of a coefficient-sharded transform (parallel/coef.py,
// coef_ntt_tail): the last cross-shard layer in the first pass's loads, then
// the local transform, as rns_ntt_kernel (cluster instances, kLogN 13 or 0:
// 2^11, 2^12) and rns_ntt_rows_kernel (below 2048) run it.
template <bool kLazy, int kLogN>
__global__ void __launch_bounds__(kNttThreads)
    rns_ntt_cross_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, Stacked st, Cross64 cr, int limbs,
                         int log_n_arg) {
  ntt_row<false, kLazy, kLogN, RowShape<kLogN>, true>(x, y, st, limbs, log_n_arg, cr);
}

// The rows' first pass reads x and the partner's block v (DeviceRows each)
// and hands it each value's cross_fwd.
struct CrossRows {
  lft64::rows::DeviceRows x, v;
  uint64_t t, ts, q;
  int upper;
  template <int V>
  __device__ __forceinline__ void load(int row, int col, int log_h, uint64_t (&out)[V]) const {
    uint64_t p[V];
    x.load(row, col, log_h, out);
    v.load(row, col, log_h, p);
#pragma unroll
    for (int m = 0; m < V; ++m) out[m] = lft64::cross_fwd(out[m], p[m], t, ts, q, upper);
  }
};

template <bool kLazy, int kLogN>
__global__ void __launch_bounds__(kRowThreads)
    rns_ntt_cross_rows_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, Stacked st, Cross64 cr,
                              int limbs, int log_n) {
  __shared__ __align__(16) uint64_t buf[kLogN == 1 || kLogN == 2 ? 1 : kRowValues];
  const long long row = blockIdx.x;
  const int limb = static_cast<int>(row % limbs), ln = kLogN ? kLogN : log_n;
  const lft64::Tables t = limb_tables(st, limb, log_n);
  CrossRows src{{x, row, 1, ln}, {cr.v, row, 1, ln}, __ldg(cr.t + limb), __ldg(cr.ts + limb), t.q, cr.upper};
  lft64::rows::forward_from<kRowThreads, kLazy, kLogN, false>(src, y, t, row, 1, 1, log_n, 0, 0, buf);
}

// A launch of `rows` clusters of Sh's shape (attr: the cluster attribute
// the configuration points to), with dyn_bytes of dynamic shared memory.
template <class Sh>
cudaLaunchConfig_t cluster_config(int rows, int dyn_bytes, cudaStream_t stream, cudaLaunchAttribute& attr) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = Sh::kC;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * Sh::kC, 1, 1);
  cfg.blockDim = dim3(Sh::kThreads, 1, 1);
  cfg.dynamicSmemBytes = dyn_bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Opts `kernel` in to dyn_bytes of dynamic shared memory (0: none asked).
template <class K>
cudaError_t allow_smem(K kernel, int dyn_bytes) {
  return dyn_bytes ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_bytes)
                   : cudaSuccess;
}

// Launches `kernel` on `rows` clusters of Sh's shape with dyn_bytes of
// dynamic shared memory (by default the shape's buffer).
template <class Sh, class... P, class... A>
int launch_clusters(void (*kernel)(P...), int rows, cudaStream_t stream, int dyn_bytes, A... args) {
  if (rows > (1 << 30) / Sh::kC) return static_cast<int>(cudaErrorInvalidValue);
  if (const cudaError_t err = allow_smem(kernel, dyn_bytes); err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config<Sh>(rows, dyn_bytes, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The clusters of kKernel (shape Sh) the device holds at once, asked once
// (cudaOccupancyMaxActiveClusters); 0 where the query fails.
template <class Sh, auto kKernel>
int resident_clusters() {
  static const int count = [] {
    int n = 0;
    if (allow_smem(kKernel, Sh::kBufBytes) != cudaSuccess) return 0;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config<Sh>(1, Sh::kBufBytes, nullptr, attr);
    return cudaOccupancyMaxActiveClusters(&n, kKernel, &cfg) == cudaSuccess ? n : 0;
  }();
  return count;
}

// Whether a lazy transform of `rows` rows at N = 2^log_n takes the wide
// instance: at 2^14 where the card holds every row's cluster at once.
template <bool kInv>
bool takes_wide_ntt(int log_n, int rows) {
  return log_n == kWideLogN && rows <= resident_clusters<WideShape<kWideLogN>, rns_ntt_wide_kernel<kInv, kWideLogN>>();
}

// K-RNS-NTT's cluster instance at ring kLogN (0: 2^11, 2^12) on `rows` rows.
template <bool kInv, bool kLazy, int kLogN>
int launch_ntt_rows(const uint64_t* x, uint64_t* y, const Stacked& s, int rows, int limbs, int log_n,
                    cudaStream_t stream) {
  using Sh = RowShape<kLogN>;
  if constexpr (kLazy && kLogN == kWideLogN) {
    if (takes_wide_ntt<kInv>(log_n, rows)) {
      using Wh = WideShape<kLogN>;
      return launch_clusters<Wh>(rns_ntt_wide_kernel<kInv, kLogN>, rows, stream, Wh::kBufBytes, x, y, s, limbs);
    }
  }
  return launch_clusters<Sh>(rns_ntt_kernel<kInv, kLazy, kLogN>, rows, stream, Sh::kBufBytes, x, y, s, limbs, log_n);
}

template <bool kInv, bool kLazy>
int launch_ntt(const void* x, void* y, const Stacked& s, int rows, int limbs, int log_n, cudaStream_t stream) {
  const auto* px = static_cast<const uint64_t*>(x);
  auto* py = static_cast<uint64_t*>(y);
  if (log_n < kSplitLogN) {
    const auto kernel = log_n == 1   ? rns_ntt_rows_kernel<kInv, kLazy, 1>
                        : log_n == 2 ? rns_ntt_rows_kernel<kInv, kLazy, 2>
                                     : rns_ntt_rows_kernel<kInv, kLazy, 0>;
    kernel<<<static_cast<unsigned>(rows), kRowThreads, 0, stream>>>(px, py, s, limbs, log_n);
    return static_cast<int>(cudaGetLastError());
  }
  if (log_n == kFixedLogN) return launch_ntt_rows<kInv, kLazy, kFixedLogN>(px, py, s, rows, limbs, log_n, stream);
  if (log_n < kFixedLogN) return launch_ntt_rows<kInv, kLazy, 0>(px, py, s, rows, limbs, log_n, stream);
  if constexpr (kLazy) {  // past N = 2^13 the lazy instances alone (every prime below 2^62)
    if (log_n == 14) return launch_ntt_rows<kInv, kLazy, 14>(px, py, s, rows, limbs, log_n, stream);
    if (log_n == 15) return launch_ntt_rows<kInv, kLazy, 15>(px, py, s, rows, limbs, log_n, stream);
    return launch_ntt_rows<kInv, kLazy, 16>(px, py, s, rows, limbs, log_n, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fused forward's instance at ring 2^log_n <= 2^13 on `rows` rows.
template <bool kLazy>
int launch_ntt_cross(const void* x, void* y, const Stacked& s, const Cross64& cr, int rows, int limbs, int log_n,
                     cudaStream_t stream) {
  const auto* px = static_cast<const uint64_t*>(x);
  auto* py = static_cast<uint64_t*>(y);
  if (log_n < kSplitLogN) {
    const auto kernel = log_n == 1   ? rns_ntt_cross_rows_kernel<kLazy, 1>
                        : log_n == 2 ? rns_ntt_cross_rows_kernel<kLazy, 2>
                                     : rns_ntt_cross_rows_kernel<kLazy, 0>;
    kernel<<<static_cast<unsigned>(rows), kRowThreads, 0, stream>>>(px, py, s, cr, limbs, log_n);
    return static_cast<int>(cudaGetLastError());
  }
  if (log_n == kFixedLogN) {
    return launch_clusters<RowShape<kFixedLogN>>(rns_ntt_cross_kernel<kLazy, kFixedLogN>, rows, stream, 0, px, py, s, cr,
                                                 limbs, log_n);
  }
  return launch_clusters<RowShape<0>>(rns_ntt_cross_kernel<kLazy, 0>, rows, stream, 0, px, py, s, cr, limbs, log_n);
}

// ---------------------------------------------------------------------------
// K-RNS-MAC
// ---------------------------------------------------------------------------

struct Terms {
  static constexpr bool kGather = false;
  const uint64_t* x[kMaxTerms];
  const uint64_t* w[2 * kMaxTerms];  // term k's y at k, its z at kMaxTerms + k
};

// The gathered instances' operands: term k reads x_k[..., perm_k[c]] at
// column c where perm_k (N int32, 16-byte aligned) is given, x_k[..., c]
// where it is null. CKKS's hoisted rotations read their slot permutation
// (a rotation of the evaluation basis) here rather than from a permuted
// copy of x.
struct GatherTerms : Terms {
  static constexpr bool kGather = true;
  const int32_t* perm[kMaxTerms];
};

// A launch's operands: `terms` products a sum; each x of `rows` rows, row r
// under limb r mod limbs; each y and z of y_rows rows (rows, or limbs: a key
// broadcast over the batch); `sums` sums (1: the y; 2: the y and the z);
// `chunk` products summed in 128 bits before a REDC.
struct MacShape {
  int terms, rows, limbs, y_rows, sums, chunk;
};

// Output row r of the sums x rows: sum s = r / rows of x row r mod rows
// (under its limb) against y (s = 0) or z row (r mod rows) mod y_rows, which
// is the x row itself, or its limb where the key is broadcast. Element
// offsets of the x row and the y (or z) row, the pointer table's offset for
// s (sel) and the limb: once per block, no 64-bit division per value.
struct MacRow {
  size_t x_off, w_off;
  int sel, limb;
};

__device__ __forceinline__ MacRow mac_row(const MacShape& sh, long long r, int log_n) {
  const int s = r >= sh.rows ? 1 : 0;
  const long long xrow = r - static_cast<long long>(s) * sh.rows;
  const int limb = static_cast<int>(xrow % sh.limbs);
  const long long yrow = sh.y_rows == sh.rows ? xrow : limb;
  return MacRow{static_cast<size_t>(xrow) << log_n, static_cast<size_t>(yrow) << log_n, s * kMaxTerms, limb};
}

// The output row that the g-th row of blocks of a launch takes: with two
// sums, the two of one x row one after the other, so that the second finds
// x in L2.
__device__ __forceinline__ long long mac_out_row(const MacShape& sh, long long g) {
  return sh.sums == 2 ? (g & 1) * sh.rows + (g >> 1) : g;
}

// V consecutive u64 of device memory: 16-byte words (every operand's base is
// 16-byte aligned, the wrappers check it, and so are its rows and an item's
// first column), one 8-byte word at V = 1.
template <int V>
__device__ __forceinline__ void load_words(const uint64_t* __restrict__ p, uint64_t (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = __ldg(p);
  } else {
    lft64::rows::load_key(p, v);
  }
}

// V values of x row x_row at the columns a permutation table gives from
// `at` (V consecutive int32, read in one 4-, 8- or 16-byte word), each in an
// 8-byte load.
template <int V>
__device__ __forceinline__ void load_gathered(const uint64_t* __restrict__ x_row, const int32_t* __restrict__ at,
                                              uint64_t (&v)[V]) {
  int idx[V];
  if constexpr (V == 4) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(at));
    idx[0] = w.x, idx[1] = w.y, idx[2] = w.z, idx[3] = w.w;
  } else if constexpr (V == 2) {
    const int2 w = __ldg(reinterpret_cast<const int2*>(at));
    idx[0] = w.x, idx[1] = w.y;
  } else {
    idx[0] = __ldg(at);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = __ldg(x_row + idx[j]);
}

// The sums of V consecutive columns from col of one output row, times
// 2^-64: v_j = 2^-64 sum_k x_k y_k mod q (canonical). Each term's x and y
// (or z) come in 16-byte words; their products are summed in 128 bits, one
// REDC per chunk of terms (chunk (q-1)^2 < q 2^64), the chunks' residues
// added mod q. Products of canonical residues summed exactly mod q are the
// JAX package's in any order. Each REDC leaves the 2^-64 that the caller
// undoes: K-RNS-MAC by a REDC against 2^128 mod q, the fused inverse in its
// final scale. kTerms: the terms as a constant, 1 or 2 (one chunk at any q
// < 2^63: 2 (q-1)^2 < q 2^64), or 0 (terms as given).
//
// TT: Terms, or GatherTerms (the gathered instances), whose table column of
// `col` is c_off + col: a cluster's block takes its columns from c_off,
// and r.x_off counts them.
template <int kTerms, int V, class TT = Terms>
__device__ __forceinline__ void mac_item(const TT& t, const MacRow& r, int terms, int chunk, const lft64::Mod& m,
                                         size_t col, uint64_t (&v)[V], size_t c_off = 0) {
  uint64_t hi[V], lo[V];
#pragma unroll
  for (int j = 0; j < V; ++j) hi[j] = lo[j] = v[j] = 0;
  const int count = kTerms ? kTerms : terms;
  int in_chunk = 0;
#pragma unroll (kTerms ? kTerms : 1)
  for (int k = 0; k < count; ++k) {
    uint64_t x[V], y[V];
    if constexpr (TT::kGather) {
      if (t.perm[k] != nullptr) {
        load_gathered(t.x[k] + (r.x_off - c_off), t.perm[k] + c_off + col, x);
      } else {
        load_words(t.x[k] + r.x_off + col, x);
      }
    } else {
      load_words(t.x[k] + r.x_off + col, x);
    }
    load_words(t.w[r.sel + k] + r.w_off + col, y);
#pragma unroll
    for (int j = 0; j < V; ++j) lft64::mac128(hi[j], lo[j], x[j], y[j]);
    if (kTerms == 0 && ++in_chunk == chunk) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[j] = add_q(v[j], lft64::redc(hi[j], lo[j], m), m.q);
        hi[j] = lo[j] = 0;
      }
      in_chunk = 0;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const uint64_t s = lft64::redc(hi[j], lo[j], m);
    v[j] = kTerms ? s : add_q(v[j], s, m.q);  // REDC(0) = 0 where the last chunk was full
  }
}

// K-RNS-MAC alone (rns_mac): out[s] = sum_k x_k (y_k, or z_k for s = 1) mod
// q_limb, mac_item's sums brought out of the Montgomery domain by a REDC
// against 2^128 mod q; x read once per sum (the second from L1). A thread
// takes an item of V consecutive values of one x row (V = 4, or N below
// 4); a block kThreads items: where a row holds as many, blockIdx.y's share
// of row blockIdx.x, else the items of kThreads / items rows from
// blockIdx.x's.
constexpr int kLogThreads = 8;
static_assert(kThreads == 1 << kLogThreads, "K-RNS-MAC's thread mapping");

template <int V, class TT>
__device__ __forceinline__ void mac_rows(const TT& t, uint64_t* __restrict__ out, const MacShape& sh, int log_n,
                                         const uint64_t* __restrict__ q_arr, const uint64_t* __restrict__ nqi_arr,
                                         const uint64_t* __restrict__ r2_arr) {
  const int log_items = log_n - (V == 4 ? 2 : V == 2 ? 1 : 0);
  long long row = blockIdx.x;
  int item = (blockIdx.y << kLogThreads) + threadIdx.x;
  if (log_items < kLogThreads) {
    row = (row << (kLogThreads - log_items)) + (threadIdx.x >> log_items);
    item = threadIdx.x & ((1 << log_items) - 1);
    if (row >= sh.rows) return;
  }
  MacRow r = mac_row(sh, row, log_n);
  const lft64::Mod m{__ldg(q_arr + r.limb), __ldg(nqi_arr + r.limb)};
  const uint64_t r2 = __ldg(r2_arr + r.limb);
  const size_t col = static_cast<size_t>(item) * V;
  for (int s = 0; s < sh.sums; ++s) {
    r.sel = s * kMaxTerms;
    uint64_t v[V];
    mac_item<0>(t, r, sh.terms, sh.chunk, m, col, v);
    uint64_t* dst = out + ((static_cast<size_t>(s) * sh.rows) << log_n) + r.x_off + col;
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = lft64::redc(__umul64hi(v[j], r2), v[j] * r2, m);
    if constexpr (V == 1) {
      dst[0] = v[0];
    } else {
#pragma unroll
      for (int h = 0; h < V / 2; ++h) reinterpret_cast<ulonglong2*>(dst)[h] = make_ulonglong2(v[2 * h], v[2 * h + 1]);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    rns_mac_kernel(Terms t, uint64_t* __restrict__ out, MacShape sh, int log_n, const uint64_t* __restrict__ q_arr,
                   const uint64_t* __restrict__ nqi_arr, const uint64_t* __restrict__ r2_arr) {
  mac_rows<V>(t, out, sh, log_n, q_arr, nqi_arr, r2_arr);
}

// The gathered instance (rns_mac with perms).
template <int V>
__global__ void __launch_bounds__(kThreads)
    rns_mac_gather_kernel(GatherTerms t, uint64_t* __restrict__ out, MacShape sh, int log_n,
                          const uint64_t* __restrict__ q_arr, const uint64_t* __restrict__ nqi_arr,
                          const uint64_t* __restrict__ r2_arr) {
  mac_rows<V>(t, out, sh, log_n, q_arr, nqi_arr, r2_arr);
}

// The inverse's first pass's items as the MAC sums of one output row (mac_item
// at the row's offsets, which the cluster kernel moves to its block's first
// sub-row): load(col, log_h, v) for sub_pass, load(row, col, log_h, v) for
// the row passes (the block's one row). The sums are never stored.
// c_off: the block's first column (the gathered instances' table offset).
template <int kTerms, class TT = Terms>
struct MacSums {
  const TT& t;
  MacRow r;
  int terms, chunk;
  lft64::Mod m;
  size_t c_off = 0;
  template <int V>
  __device__ __forceinline__ void load(int col, int, uint64_t (&v)[V]) const {
    mac_item<kTerms>(t, r, terms, chunk, m, col, v, c_off);
  }
  template <int V>
  __device__ __forceinline__ void load(int, int col, int, uint64_t (&v)[V]) const {
    mac_item<kTerms>(t, r, terms, chunk, m, col, v, c_off);
  }
};

// Items of the fused inverse's first pass a thread takes unrolled, their
// loads in flight together: all of them (K-RNS-NTT's kItemsAhead) with 1 or
// 2 terms (80 registers, no spill; with 2 terms half as many measured 0.3
// us slower at the CKKS mul's 128 rows, PERF.md), one with a run-time count.
// Past N = 2^13, where a thread has twice the items, half of them: the
// 2^13 instance's count (the wide instances: half of theirs).
template <int kTerms, class Sh>
constexpr int kMacAhead = kTerms == 1 || kTerms == 2 ? Sh::kAheadItems / (Sh::kBig ? 2 : 1) : 1;

// K-RNS-MAC inside K-RNS-NTT's inverse (rns_intt_mac): cluster g runs the
// inverse of output row mac_out_row(g) with the row's MAC sums as its first
// pass's items, so they are never stored and read back. The sums carry
// 2^-64; the inverse is Z_q-linear, so the final scale by N^-1 2^64 mod q
// (st.n_inv and its dual, which the wrapper passes in place of N^-1) takes
// it out, canonical as K-RNS-NTT's. The passes, tables and barriers are
// K-RNS-NTT's. kLogN: as rns_ntt_kernel's; kTerms as mac_item's; Sh: the
// instance's RowShape.
template <bool kLazy, int kLogN, int kTerms, class Sh, class TT>
__device__ __forceinline__ void intt_mac_cluster(const TT& t, uint64_t* __restrict__ y, const Stacked& st,
                                                 const MacShape& sh, int log_n_arg) {
  uint64_t* buf = row_buf<Sh>();
  const int log_n = kLogN ? kLogN : log_n_arg;
  const long long r = mac_out_row(sh, blockIdx.x / Sh::kC);
  MacRow row = mac_row(sh, r, log_n);
  const lft64::Tables tab = limb_tables(st, row.limb, log_n);
  const size_t mine = static_cast<size_t>(cg::this_cluster().block_rank() * Sh::kPer) << (log_n - kSplit);
  row.x_off += mine;
  row.w_off += mine;
  const MacSums<kTerms, TT> src{t, row, sh.terms, sh.chunk, {tab.q, tab.neg_q_inv}, mine};
  cluster_inverse<Sh, kLazy, kMacAhead<kTerms, Sh>>(src, y + (static_cast<size_t>(r) << log_n), tab, log_n, buf);
}

template <bool kLazy, int kLogN, int kTerms>
__global__ void __launch_bounds__(kNttThreads)
    rns_intt_mac_kernel(Terms t, uint64_t* __restrict__ y, Stacked st, MacShape sh, int log_n_arg) {
  intt_mac_cluster<kLazy, kLogN, kTerms, RowShape<kLogN>>(t, y, st, sh, log_n_arg);
}

// The gathered instance (rns_intt_mac with perms): terms as given.
template <bool kLazy, int kLogN>
__global__ void __launch_bounds__(kNttThreads)
    rns_intt_mac_gather_kernel(GatherTerms t, uint64_t* __restrict__ y, Stacked st, MacShape sh, int log_n_arg) {
  intt_mac_cluster<kLazy, kLogN, 0, RowShape<kLogN>>(t, y, st, sh, log_n_arg);
}

// The wide instance (lazy, 2^14), as rns_ntt_wide_kernel's: kWideThreads a
// block, kWideMacBlocks an SM.
template <int kLogN, int kTerms>
__global__ void __launch_bounds__(kWideThreads, kWideMacBlocks<kTerms>)
    rns_intt_mac_wide_kernel(Terms t, uint64_t* __restrict__ y, Stacked st, MacShape sh) {
  intt_mac_cluster<true, kLogN, kTerms, WideShape<kLogN>>(t, y, st, sh, kLogN);
}

// Sums of a run-time count of terms (the key switch's digits) at N = 2^16:
// the ring's cluster with ptxas held to the registers that let the 3 blocks
// its 64 KB allow share an SM (102 registers let 2, PERF.md).
constexpr int kResidentLogN = 16;
constexpr int kResidentBlocks = 3;

template <int kLogN, int kTerms>
__global__ void __launch_bounds__(kNttThreads, kResidentBlocks)
    rns_intt_mac_resident_kernel(Terms t, uint64_t* __restrict__ y, Stacked st, MacShape sh) {
  intt_mac_cluster<true, kLogN, kTerms, RowShape<kLogN>>(t, y, st, sh, kLogN);
}

// Below N = 2048: a block per output row through rows::inverse (kLogN as
// rns_ntt_rows_kernel's).
template <bool kLazy, int kLogN, class TT>
__device__ __forceinline__ void intt_mac_row(const TT& t, uint64_t* __restrict__ y, const Stacked& st,
                                             const MacShape& sh, int log_n, uint64_t* buf) {
  const long long r = mac_out_row(sh, blockIdx.x);
  const MacRow row = mac_row(sh, r, log_n);
  const lft64::Tables tab = limb_tables(st, row.limb, log_n);
  MacSums<0, TT> src{t, row, sh.terms, sh.chunk, {tab.q, tab.neg_q_inv}};
  lft64::rows::inverse<kRowThreads, kLazy, kLogN>(src, y, tab, r, 1, 1, log_n, buf);
}

template <bool kLazy, int kLogN>
__global__ void __launch_bounds__(kRowThreads)
    rns_intt_mac_rows_kernel(Terms t, uint64_t* __restrict__ y, Stacked st, MacShape sh, int log_n) {
  __shared__ __align__(16) uint64_t buf[kLogN == 1 || kLogN == 2 ? 1 : kRowValues];
  intt_mac_row<kLazy, kLogN>(t, y, st, sh, log_n, buf);
}

template <bool kLazy, int kLogN>
__global__ void __launch_bounds__(kRowThreads)
    rns_intt_mac_gather_rows_kernel(GatherTerms t, uint64_t* __restrict__ y, Stacked st, MacShape sh, int log_n) {
  __shared__ __align__(16) uint64_t buf[kLogN == 1 || kLogN == 2 ? 1 : kRowValues];
  intt_mac_row<kLazy, kLogN>(t, y, st, sh, log_n, buf);
}

// The gathered instance where every term reads one x (rns_intt_mac with
// perms and one x tensor: the bootstrap's b sums, sum_j pt_j be[sigma_j]),
// lazy at N = 2^13 with 1-4 terms. The first version read each gathered
// value with an 8-byte load at a scattered column of the x row in device
// memory (a 32-byte L2 sector for 8 bytes, per term) one item and one term
// after the other, so the loads' latency showed once per item and term.
// Here each block of a row's cluster copies the x row (64 KB) into its
// shared memory by one bulk copy, issued first; the tables then index
// shared memory. Each thread issues the 16-byte loads of its items' tables
// and y (kStaged items at a time) before the copy is waited for and
// before their sums, which take the x values from shared memory.
constexpr int kRowBytes = (1 << kFixedLogN) * static_cast<int>(sizeof(uint64_t));
constexpr int kRowTerms = 4;  // a lazy instance's terms in one 128-bit sum: 4 (q-1)^2 < q 2^64 for q < 2^62

// Items a thread stages at a time: all of them (kItemsAhead) with 1 or 2
// terms, half as many with 3 or 4 (their tables and y in registers).
template <int kTerms>
constexpr int kStaged = kTerms <= 2 ? kItemsAhead : kItemsAhead / 2;

// The sums of the inverse's first pass from the x row in shared memory:
// fetch issues an item's loads of each term's table (16-byte words; the
// identity's columns where a term has none) and y, sum makes the item's
// values from them, 2^-64 sum_k x[idx_k] y_k mod q (one REDC: kTerms <=
// kRowTerms), ready waits for the row's copy.
template <int kTerms>
struct RowSums {
  static_assert(kTerms >= 1 && kTerms <= kRowTerms, "one REDC an item");
  const GatherTerms& t;
  MacRow r;  // w_off at the block's first column
  lft64::Mod m;
  const uint64_t* xs;  // the x row, 2^13 values
  int c_off;           // the block's first column
  uint64_t* bar;       // the copy's mbarrier
  struct Staged {
    int idx[kTerms][4];
    uint64_t y[kTerms][4];
  };
  __device__ __forceinline__ void fetch(int col, Staged& s) const {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
      if (t.perm[k] != nullptr) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(t.perm[k] + c_off + col));
        s.idx[k][0] = w.x, s.idx[k][1] = w.y, s.idx[k][2] = w.z, s.idx[k][3] = w.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) s.idx[k][j] = c_off + col + j;
      }
      load_words(t.w[r.sel + k] + r.w_off + col, s.y[k]);
    }
  }
  __device__ __forceinline__ void ready() const { lft::bulk::mbar_wait(bar, 0); }
  __device__ __forceinline__ void sum(const Staged& s, uint64_t (&v)[4]) const {
    uint64_t hi[4] = {0, 0, 0, 0}, lo[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) lft64::mac128(hi[j], lo[j], xs[s.idx[k][j]], s.y[k][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = lft64::redc(hi[j], lo[j], m);
  }
};

// The inverse's last pass (the first it runs; 2 layers on items of 4
// consecutive values) from a source that stages: sub_pass's items at N =
// 2^13, kAhead of them at a time, each group's loads (src.fetch, the
// twiddles) issued before its sums; the first group's sums wait for the
// copy (src.ready).
template <bool kLazy, int kAhead, class Src>
__device__ __forceinline__ void staged_last_pass(int sub0, const lft64::Tables& t, const Src& src, const Buf<>& out) {
  constexpr int log_s = kFixedLogN - kSplit, l0 = kFixedLogN - 2, log_items = log_s - 2;
  static_assert(kItemsAhead % kAhead == 0 && kItemsAhead * kNttThreads == kPerBlock << log_items, "every item once");
#pragma unroll
  for (int a0 = 0; a0 < kItemsAhead; a0 += kAhead) {
    typename Src::Staged st[kAhead];
    uint64_t w[kAhead][3], ws[kAhead][3];
    int col[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int k = threadIdx.x + (a0 + a) * kNttThreads;
      const int s = k >> log_items, i = k & ((1 << log_items) - 1);
      col[a] = (s << log_s) + (i << 2);
      src.fetch(col[a], st[a]);
      item_twiddles<2>(w[a], ws[a], t.psi_inv, t.psi_inv_s, l0, ((sub0 + s) << (l0 - kSplit)) + i);
    }
    if (a0 == 0) src.ready();
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      uint64_t x[4];
      src.sum(st[a], x);
      lft64::inv_radix<2, kLazy>(x, w[a], ws[a], t.q);
      out.store(col[a], 0, x);
    }
  }
}

template <class Sh, bool kLazy, int kAhead, int kTerms>
__device__ __forceinline__ void inverse_last_pass(int sub0, int, const lft64::Tables& t, const RowSums<kTerms>& src,
                                                  const Buf<>& out) {
  static_assert(Sh::kPer == kPerBlock && Sh::kThreads == kNttThreads, "the shared-x instance runs at N = 2^13");
  staged_last_pass<kLazy, kStaged<kTerms>>(sub0, t, src, out);
}

// Grid and cluster as rns_intt_mac_gather_kernel's; dynamic shared memory:
// the x row (kRowBytes).
template <int kTerms>
__global__ void __launch_bounds__(kNttThreads)
    rns_intt_mac_shared_kernel(GatherTerms t, uint64_t* __restrict__ y, Stacked st, MacShape sh) {
  __shared__ __align__(16) uint64_t buf[kBufValues];
  __shared__ __align__(8) uint64_t bar;
  extern __shared__ __align__(16) uint64_t xs[];
  const long long r = mac_out_row(sh, blockIdx.x / kCluster);
  MacRow row = mac_row(sh, r, kFixedLogN);
  if (threadIdx.x == 0) {
    lft::bulk::mbar_init(&bar);
    lft::bulk::mbar_expect(&bar, kRowBytes);
    lft::bulk::bulk_copy(xs, t.x[0] + row.x_off, kRowBytes, &bar);
  }
  __syncthreads();  // the mbarrier is made before any thread waits on it
  const lft64::Tables tab = limb_tables(st, row.limb, kFixedLogN);
  const int c_off = static_cast<int>(cg::this_cluster().block_rank()) * kPerBlock << (kFixedLogN - kSplit);
  row.w_off += c_off;
  const RowSums<kTerms> src{t, row, {tab.q, tab.neg_q_inv}, xs, c_off, &bar};
  cluster_inverse<RowShape<kFixedLogN>, true, kItemsAhead>(src, y + (static_cast<size_t>(r) << kFixedLogN), tab,
                                                           kFixedLogN, buf);
}

// Whether rns_intt_mac of `terms` terms on `rows` output rows at N =
// 2^log_n (lazy) takes the wide instance: 1 or 2 terms at 2^14, where the
// card holds every row's cluster at once.
bool takes_wide_mac(int log_n, int terms, int rows) {
  using Wh = WideShape<kWideLogN>;
  if (log_n != kWideLogN || (terms != 1 && terms != 2)) return false;
  return rows <= (terms == 1 ? resident_clusters<Wh, rns_intt_mac_wide_kernel<kWideLogN, 1>>()
                             : resident_clusters<Wh, rns_intt_mac_wide_kernel<kWideLogN, 2>>());
}

// rns_intt_mac's cluster instance at ring kLogN (0: 2^11, 2^12) on `rows`
// output rows: for 1 and 2 terms where kConst (the lazy instances at 2^13
// and past it; wide where takes_wide_mac), else the one for any terms (at
// 2^16 the resident one).
template <bool kLazy, int kLogN, bool kConst>
int launch_mac_rows(const Terms& t, uint64_t* y, const Stacked& s, const MacShape& sh, int rows, int log_n,
                    cudaStream_t stream) {
  using Sh = RowShape<kLogN>;
  const int dyn = Sh::kBufBytes;
  if constexpr (kLazy && kLogN == kWideLogN) {
    if (takes_wide_mac(log_n, sh.terms, rows)) {
      using Wh = WideShape<kLogN>;
      const auto kernel = sh.terms == 1 ? rns_intt_mac_wide_kernel<kLogN, 1> : rns_intt_mac_wide_kernel<kLogN, 2>;
      return launch_clusters<Wh>(kernel, rows, stream, Wh::kBufBytes, t, y, s, sh);
    }
  }
  if constexpr (kConst) {
    if (sh.terms == 1) return launch_clusters<Sh>(rns_intt_mac_kernel<kLazy, kLogN, 1>, rows, stream, dyn, t, y, s, sh, log_n);
    if (sh.terms == 2) return launch_clusters<Sh>(rns_intt_mac_kernel<kLazy, kLogN, 2>, rows, stream, dyn, t, y, s, sh, log_n);
  }
  if constexpr (kLazy && kLogN == kResidentLogN) {
    return launch_clusters<Sh>(rns_intt_mac_resident_kernel<kLogN, 0>, rows, stream, dyn, t, y, s, sh);
  } else {
    return launch_clusters<Sh>(rns_intt_mac_kernel<kLazy, kLogN, 0>, rows, stream, dyn, t, y, s, sh, log_n);
  }
}

template <bool kLazy>
int launch_intt_mac(const Terms& t, uint64_t* y, const Stacked& s, const MacShape& sh, int log_n,
                    cudaStream_t stream) {
  const int rows = sh.sums * sh.rows;
  if (log_n < kSplitLogN) {
    const auto kernel = log_n == 1   ? rns_intt_mac_rows_kernel<kLazy, 1>
                        : log_n == 2 ? rns_intt_mac_rows_kernel<kLazy, 2>
                                     : rns_intt_mac_rows_kernel<kLazy, 0>;
    kernel<<<static_cast<unsigned>(rows), kRowThreads, 0, stream>>>(t, y, s, sh, log_n);
    return static_cast<int>(cudaGetLastError());
  }
  if (log_n == kFixedLogN) return launch_mac_rows<kLazy, kFixedLogN, kLazy>(t, y, s, sh, rows, log_n, stream);
  if (log_n < kFixedLogN) return launch_mac_rows<kLazy, 0, false>(t, y, s, sh, rows, log_n, stream);
  if constexpr (kLazy) {  // past N = 2^13 the lazy instances alone
    if (log_n == 14) return launch_mac_rows<true, 14, true>(t, y, s, sh, rows, log_n, stream);
    if (log_n == 15) return launch_mac_rows<true, 15, true>(t, y, s, sh, rows, log_n, stream);
    return launch_mac_rows<true, 16, true>(t, y, s, sh, rows, log_n, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gathered instance's cluster launch at ring kLogN (0: 2^11, 2^12).
template <bool kLazy, int kLogN>
int launch_gather_rows(const GatherTerms& t, uint64_t* y, const Stacked& s, const MacShape& sh, int rows, int log_n,
                       cudaStream_t stream) {
  using Sh = RowShape<kLogN>;
  return launch_clusters<Sh>(rns_intt_mac_gather_kernel<kLazy, kLogN>, rows, stream, Sh::kBufBytes, t, y, s, sh,
                             log_n);
}

// The gathered instances: a cluster per output row from N = 2048 (every
// shape a constant at 2^13), a block per row below; terms as given.
template <bool kLazy>
int launch_intt_mac_gather(const GatherTerms& t, uint64_t* y, const Stacked& s, const MacShape& sh, int log_n,
                           cudaStream_t stream) {
  const int rows = sh.sums * sh.rows;
  if (log_n < kSplitLogN) {
    const auto kernel = log_n == 1   ? rns_intt_mac_gather_rows_kernel<kLazy, 1>
                        : log_n == 2 ? rns_intt_mac_gather_rows_kernel<kLazy, 2>
                                     : rns_intt_mac_gather_rows_kernel<kLazy, 0>;
    kernel<<<static_cast<unsigned>(rows), kRowThreads, 0, stream>>>(t, y, s, sh, log_n);
    return static_cast<int>(cudaGetLastError());
  }
  if (log_n == kFixedLogN) return launch_gather_rows<kLazy, kFixedLogN>(t, y, s, sh, rows, log_n, stream);
  if (log_n < kFixedLogN) return launch_gather_rows<kLazy, 0>(t, y, s, sh, rows, log_n, stream);
  if constexpr (kLazy) {  // past N = 2^13 the lazy instances alone
    if (log_n == 14) return launch_gather_rows<true, 14>(t, y, s, sh, rows, log_n, stream);
    if (log_n == 15) return launch_gather_rows<true, 15>(t, y, s, sh, rows, log_n, stream);
    return launch_gather_rows<true, 16>(t, y, s, sh, rows, log_n, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The shared-x instances (lazy, N = 2^13, 1 to kRowTerms terms, every
// term's x one row): a cluster per output row, as the gathered instance.
int launch_intt_mac_shared(const GatherTerms& t, uint64_t* y, const Stacked& s, const MacShape& sh,
                           cudaStream_t stream) {
  const auto kernel = sh.terms == 1   ? rns_intt_mac_shared_kernel<1>
                      : sh.terms == 2 ? rns_intt_mac_shared_kernel<2>
                      : sh.terms == 3 ? rns_intt_mac_shared_kernel<3>
                                      : rns_intt_mac_shared_kernel<4>;
  return launch_clusters<RowShape<kFixedLogN>>(kernel, sh.sums * sh.rows, stream, kRowBytes, t, y, s, sh);
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
  const uint64_t* __restrict__ ws;     // its Shoup duals floor(w 2^64 / p_j)
  const uint64_t* __restrict__ uq;     // (Lq+1, Lp) u Q mod p_j
  const uint64_t* __restrict__ add;    // (Lq) added mod q_i first, or null
};

// -p^-1 mod 2^64 for an odd p: p is its own inverse to 3 bits, and each
// Newton step doubles the bits.
__device__ __forceinline__ uint64_t neg_inv64(uint64_t p) {
  uint64_t inv = p;
#pragma unroll
  for (int i = 0; i < 5; ++i) inv *= 2 - p * inv;
  return 0 - inv;
}

// The shared-memory words of a block's tables: per input limb q, q_hat^-1,
// its dual, 1/q and the added constant; per output limb p and -p^-1; w'
// (Lp Lq) and uq ((Lq+1) Lp); the chunk; the instance for any lq adds its
// threads' v (lq per thread).
__host__ __device__ constexpr size_t conv_words(int lq, int lp, bool v_in_smem) {
  return static_cast<size_t>(5 * lq + 2 * lp + lp * lq + (lq + 1) * lp + 1) +
         (v_in_smem ? static_cast<size_t>(lq) * kThreads : 0);
}

// sum_k v_k w_k mod p for canonical v_k < 2^64 / chunk: the products summed
// in 128 bits, one REDC per chunk of terms (w in the Montgomery domain, so
// each REDC gives the chunk's sum of v_k (w_k 2^-64) mod p), the chunks'
// residues added mod p. v(k) gives term k.
template <int kLq, class V>
__device__ __forceinline__ uint64_t conv_sum(const V& v, const uint64_t* w, int lq, int chunk, const lft64::Mod& m) {
  uint64_t s = 0, hi = 0, lo = 0;
  if (chunk >= lq) {  // every term in one sum (55-bit primes: chunk 512)
#pragma unroll
    for (int k = 0; k < (kLq ? kLq : lq); ++k) lft64::mac128(hi, lo, v(k), w[k]);
    return lft64::redc(hi, lo, m);
  }
  int in_chunk = 0;
#pragma unroll
  for (int k = 0; k < (kLq ? kLq : lq); ++k) {
    lft64::mac128(hi, lo, v(k), w[k]);
    if (++in_chunk == chunk) {
      s = add_q(s, lft64::redc(hi, lo, m), m.q);
      hi = lo = 0;
      in_chunk = 0;
    }
  }
  return add_q(s, lft64::redc(hi, lo, m), m.q);  // REDC(0) = 0 where the last chunk was full
}

// kLq: the input limbs, a constant (v in registers), or 0 (lq as given, v
// in shared memory).
template <int kLq>
__global__ void __launch_bounds__(kThreads)
    base_convert_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, Conv c, int lq_arg, int lp, int log_n,
                        long long batch, long long x_stride, long long y_stride, const int* __restrict__ rows,
                        int copy) {
  extern __shared__ __align__(16) uint64_t sh[];
  const int lq = kLq ? kLq : lq_arg;
  uint64_t* s_q = sh;
  uint64_t* s_qhi = s_q + lq;
  uint64_t* s_qhi_s = s_qhi + lq;
  double* s_frac = reinterpret_cast<double*>(s_qhi_s + lq);
  uint64_t* s_add = reinterpret_cast<uint64_t*>(s_frac + lq);
  uint64_t* s_p = s_add + lq;
  uint64_t* s_nqi = s_p + lp;
  uint64_t* s_w = s_nqi + lp;
  uint64_t* s_uq = s_w + lp * lq;
  uint64_t* s_chunk = s_uq + (lq + 1) * lp;
  uint64_t* s_v = s_chunk + 1;  // the instance for any lq: v_k of thread t at k kThreads + t
  for (int k = threadIdx.x; k < lq; k += blockDim.x) {
    s_q[k] = __ldg(c.q + k);
    s_qhi[k] = __ldg(c.qhi + k);
    s_qhi_s[k] = __ldg(c.qhi_s + k);
    s_frac[k] = __ldg(c.frac + k);
    s_add[k] = c.add != nullptr ? __ldg(c.add + k) : 0;
  }
  for (int j = threadIdx.x; j < lp; j += blockDim.x) {
    s_p[j] = __ldg(c.p + j);
    s_nqi[j] = neg_inv64(s_p[j]);
  }
  // w' = w 2^64 mod p = w 2^64 - ws p, which is -(ws p) mod 2^64: below p,
  // so its low word is all of it
  for (int i = threadIdx.x; i < lp * lq; i += blockDim.x) s_w[i] = 0 - __ldg(c.ws + i) * __ldg(c.p + i / lq);
  for (int i = threadIdx.x; i < (lq + 1) * lp; i += blockDim.x) s_uq[i] = __ldg(c.uq + i);
  if (threadIdx.x == 0) {  // terms a 128-bit sum takes below p 2^64: chunk max(q) < 2^64
    uint64_t top = 0;
    for (int k = 0; k < lq; ++k) {
      const uint64_t qk = __ldg(c.q + k);
      if (qk > top) top = qk;
    }
    *s_chunk = ~0ull / top;
  }
  __syncthreads();
  const int chunk = static_cast<int>(*s_chunk < static_cast<uint64_t>(lq) ? *s_chunk : lq);
  const bool has_add = c.add != nullptr;
  const long long cols = batch << log_n;
  const int n = 1 << log_n;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < cols;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = i >> log_n;
    const int col = static_cast<int>(i & (n - 1));
    const uint64_t* xb = x + b * x_stride + col;
    uint64_t* yb = y + b * y_stride + col;
    uint64_t v[kLq ? kLq : 1];
    double u = 0.0;
#pragma unroll
    for (int k = 0; k < lq; ++k) {
      const uint64_t q = s_q[k];
      uint64_t xv = __ldg(xb + (static_cast<size_t>(k) << log_n));
      if (copy) yb[static_cast<size_t>(__ldg(rows + k)) << log_n] = xv;  // x's own limb into its row
      if (has_add) xv = add_q(xv, s_add[k], q);
      const uint64_t vk = shoup_q(xv, s_qhi[k], s_qhi_s[k], q);
      if constexpr (kLq != 0) {
        v[k] = vk;
      } else {
        s_v[k * kThreads + threadIdx.x] = vk;
      }
      u = __fma_rn(__ull2double_rn(vk), s_frac[k], u);
    }
    const uint64_t* uq = s_uq + static_cast<int>(rint(u)) * lp;
#pragma unroll 2  // two outputs' sums in flight: 3% at 8 -> 8 (PERF.md)
    for (int j = 0; j < lp; ++j) {
      const lft64::Mod m{s_p[j], s_nqi[j]};
      uint64_t s;
      if constexpr (kLq != 0) {
        s = conv_sum<kLq>([&](int k) { return v[k]; }, s_w + j * lq, lq, chunk, m);
      } else {
        s = conv_sum<0>([&](int k) { return s_v[k * kThreads + threadIdx.x]; }, s_w + j * lq, lq, chunk, m);
      }
      const int row = rows != nullptr ? __ldg(rows + lq + j) : j;
      yb[static_cast<size_t>(row) << log_n] = sub_q(s, uq[j], m.q);
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
// q_d, reduced mod q by Barrett where bm != 0; then + add mod q where an
// add is given: add0 (half, keep, N) for b < half, add1 for the others
// (CKKS's b and a: x's leading axis of 2), either null for none.
__global__ void __launch_bounds__(kThreads)
    rescale_kernel(const uint64_t* __restrict__ x, const uint64_t* __restrict__ conv, uint64_t* __restrict__ y,
                   Rescale c, int limbs, int keep, int log_n, long long count, uint64_t q_d, uint64_t ph_d,
                   const uint64_t* __restrict__ add0, const uint64_t* __restrict__ add1, long long half) {
  const long long part_values = (half * keep) << log_n;
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
    uint64_t v = shoup_q(sub_q(xv, r, q), __ldg(c.p_inv + l), __ldg(c.p_inv_s + l), q);
    const uint64_t* add = b < half ? add0 : add1;
    if (add != nullptr) v = add_q(v, add[b < half ? i : i - part_values], q);
    y[i] = v;
  }
}

// ---------------------------------------------------------------------------
// K-AUTOMORPH
// ---------------------------------------------------------------------------

constexpr int kMaxParts = 2;  // CKKS's b and a, permuted by one t

struct Parts {
  const uint64_t* x[kMaxParts];
  uint64_t* y[kMaxParts];
};

// The coefficient automorphism X -> X^t of (rows, N) residues, row r under
// limb r mod limbs, for part blockIdx.y: y[c] = x[src[c]], negated mod q
// (q - v where v != 0) where the sign is set. code: N int32, src | sign <<
// 31 (16-byte aligned). A thread takes items of V consecutive outputs: the
// codes in one word, x in 8-byte loads from its row (a row is 2^log_n u64,
// so the gather stays in it), y in 16-byte stores.
template <int V>
__global__ void __launch_bounds__(kThreads)
    automorphism_kernel(Parts p, const int32_t* __restrict__ code, const uint64_t* __restrict__ q_arr, int rows,
                        int limbs, int log_n) {
  constexpr int kLogV = V == 4 ? 2 : V == 2 ? 1 : 0;
  const int log_items = log_n - kLogV;
  const long long items = static_cast<long long>(rows) << log_items;
  const uint64_t* __restrict__ x = blockIdx.y ? p.x[1] : p.x[0];  // no indexing of the parameter array at run time
  uint64_t* __restrict__ y = blockIdx.y ? p.y[1] : p.y[0];
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < items;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(i >> log_items);
    const int col = static_cast<int>(i & ((1 << log_items) - 1)) << kLogV;
    const uint64_t q = __ldg(q_arr + row % limbs);
    const size_t base = static_cast<size_t>(row) << log_n;
    int c[V];
    if constexpr (V == 4) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(code + col));
      c[0] = w.x, c[1] = w.y, c[2] = w.z, c[3] = w.w;
    } else if constexpr (V == 2) {
      const int2 w = __ldg(reinterpret_cast<const int2*>(code + col));
      c[0] = w.x, c[1] = w.y;
    } else {
      c[0] = __ldg(code + col);
    }
    uint64_t v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const uint64_t a = __ldg(x + base + (c[j] & 0x7fffffff));
      v[j] = c[j] < 0 && a != 0 ? q - a : a;
    }
    if constexpr (V == 1) {
      y[base + col] = v[0];
    } else {
#pragma unroll
      for (int h = 0; h < V / 2; ++h) {
        reinterpret_cast<ulonglong2*>(y + base + col)[h] = make_ulonglong2(v[2 * h], v[2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K-RNS-ADD
// ---------------------------------------------------------------------------

enum AddOp { kAdd = 0, kSub = 1, kNeg = 2 };

// One or two parts (a ciphertext's b and a), part blockIdx.y, each with its
// own layout: y's rows, and the rows of a and of b that repeat over them.
struct AddParts {
  const uint64_t* a[kMaxParts];
  const uint64_t* b[kMaxParts];  // null for kNeg
  uint64_t* y[kMaxParts];
  int rows[kMaxParts];
  int a_rows[kMaxParts];
  int b_rows[kMaxParts];
};

// y = a + b, a - b or -a mod q of each value of a part's (rows, N)
// residues, row r under limb r mod limbs, each as the JAX package's
// element-wise ops compute it (the unsigned minimum of the two candidates;
// q - a where a != 0); a's row r is its row r mod a_rows, b's r mod b_rows
// (a_rows, b_rows: rows, or limbs for an (L, N) operand broadcast over the
// other's leading axes). A thread takes 16-byte words, two values, of a, b
// and y.
template <int kOp>
__global__ void __launch_bounds__(kThreads)
    rns_add_kernel(AddParts p, const uint64_t* __restrict__ q_arr, int limbs, int log_n) {
  // the part's fields by a select, not an index: a runtime index into the
  // parameter arrays copies the struct to the stack (72 bytes a thread)
  const bool second = blockIdx.y != 0;
  const int log_w = log_n - 1;  // words a row
  const long long words = static_cast<long long>(second ? p.rows[1] : p.rows[0]) << log_w;
  const int a_rows = second ? p.a_rows[1] : p.a_rows[0], b_rows = second ? p.b_rows[1] : p.b_rows[0];
  const auto* __restrict__ a = reinterpret_cast<const ulonglong2*>(second ? p.a[1] : p.a[0]);
  const auto* __restrict__ b = reinterpret_cast<const ulonglong2*>(second ? p.b[1] : p.b[0]);
  auto* __restrict__ y = reinterpret_cast<ulonglong2*>(second ? p.y[1] : p.y[0]);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < words;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(i >> log_w);
    const long long col = i & ((1ll << log_w) - 1);
    const uint64_t q = __ldg(q_arr + row % limbs);
    const ulonglong2 u = __ldg(a + ((static_cast<long long>(row % a_rows) << log_w) | col));
    ulonglong2 v;
    if constexpr (kOp == kNeg) {
      v = make_ulonglong2(u.x != 0 ? q - u.x : 0, u.y != 0 ? q - u.y : 0);
    } else {
      const ulonglong2 w = __ldg(b + ((static_cast<long long>(row % b_rows) << log_w) | col));
      if constexpr (kOp == kAdd) {
        v = make_ulonglong2(add_q(u.x, w.x, q), add_q(u.y, w.y, q));
      } else {
        v = make_ulonglong2(sub_q(u.x, w.x, q), sub_q(u.y, w.y, q));
      }
    }
    y[i] = v;
  }
}

template <typename T>
const T* cp(const void* p) {
  return static_cast<const T*>(p);
}

// The device pointers of the host arrays xs, ys and zs (zs null: one sum).
Terms terms_of(const void* xs, const void* ys, const void* zs, int terms) {
  Terms t{};
  for (int k = 0; k < terms; ++k) {
    t.x[k] = reinterpret_cast<const uint64_t*>(static_cast<const uint64_t*>(xs)[k]);
    t.w[k] = reinterpret_cast<const uint64_t*>(static_cast<const uint64_t*>(ys)[k]);
    if (zs != nullptr) t.w[kMaxTerms + k] = reinterpret_cast<const uint64_t*>(static_cast<const uint64_t*>(zs)[k]);
  }
  return t;
}

// terms_of's, with each term's permutation table from the host array perms
// (0: none).
GatherTerms gather_terms_of(const void* xs, const void* ys, const void* zs, const void* perms, int terms) {
  GatherTerms t{};
  static_cast<Terms&>(t) = terms_of(xs, ys, zs, terms);
  for (int k = 0; k < terms; ++k) {
    t.perm[k] = reinterpret_cast<const int32_t*>(static_cast<const uint64_t*>(perms)[k]);
  }
  return t;
}

bool mac_args_ok(int terms, int rows, int limbs, int y_rows, int chunk) {
  return terms >= 1 && terms <= kMaxTerms && rows >= 1 && limbs >= 1 && chunk >= 1 &&
         (y_rows == rows || y_rows == limbs);
}

// A cluster instance's shape, and how many of its blocks an SM and of its
// clusters the device holds at once: out = {blocks a row, threads a block,
// dynamic shared memory, blocks an SM, clusters}.
template <class Sh, class K>
int occupancy_of(K kernel, int* out) {
  if (const cudaError_t err = allow_smem(kernel, Sh::kBufBytes); err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0, clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, Sh::kThreads, Sh::kBufBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<Sh>(1, Sh::kBufBytes, nullptr, attr);
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int got[] = {Sh::kC, Sh::kThreads, Sh::kBufBytes, blocks, clusters};
  for (int i = 0; i < 5; ++i) out[i] = got[i];
  return 0;
}

// The instance a lazy launch of `rows` rows at ring kLogN takes: kind 0 the
// forward transform, 1 its inverse, 2 rns_intt_mac with `terms` terms, 3
// its gathered instance.
template <int kLogN>
int occupancy_at(int kind, int terms, int rows, int* out) {
  using Sh = RowShape<kLogN>;
  if constexpr (kLogN == kWideLogN) {
    using Wh = WideShape<kLogN>;
    if (kind == 0 && takes_wide_ntt<false>(kLogN, rows)) return occupancy_of<Wh>(rns_ntt_wide_kernel<false, kLogN>, out);
    if (kind == 1 && takes_wide_ntt<true>(kLogN, rows)) return occupancy_of<Wh>(rns_ntt_wide_kernel<true, kLogN>, out);
    if (kind == 2 && takes_wide_mac(kLogN, terms, rows)) {
      return terms == 1 ? occupancy_of<Wh>(rns_intt_mac_wide_kernel<kLogN, 1>, out)
                        : occupancy_of<Wh>(rns_intt_mac_wide_kernel<kLogN, 2>, out);
    }
  }
  if (kind == 0) return occupancy_of<Sh>(rns_ntt_kernel<false, true, kLogN>, out);
  if (kind == 1) return occupancy_of<Sh>(rns_ntt_kernel<true, true, kLogN>, out);
  if (kind == 2 && terms == 1) return occupancy_of<Sh>(rns_intt_mac_kernel<true, kLogN, 1>, out);
  if (kind == 2 && terms == 2) return occupancy_of<Sh>(rns_intt_mac_kernel<true, kLogN, 2>, out);
  if (kind == 2) {
    if constexpr (kLogN == kResidentLogN) {
      return occupancy_of<Sh>(rns_intt_mac_resident_kernel<kLogN, 0>, out);
    } else {
      return occupancy_of<Sh>(rns_intt_mac_kernel<true, kLogN, 0>, out);
    }
  }
  if (kind == 3) return occupancy_of<Sh>(rns_intt_mac_gather_kernel<true, kLogN>, out);
  return static_cast<int>(cudaErrorInvalidValue);
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

// lft_rns_ntt_fwd's arguments with v (the partner's block, x's layout) after
// x, and after the tables the layer's per-limb twiddle t, its Shoup dual ts
// (limbs,) and upper: the forward transform of each row's lft64::cross_fwd
// values, 2 <= N <= 2^13.
int lft_rns_ntt_cross(const void* x, const void* v, void* y, const void* psi, const void* psi_s, const void* psi_inv,
                      const void* psi_inv_s, const void* q, const void* neg_q_inv, const void* n_inv,
                      const void* n_inv_s, const void* t, const void* ts, int rows, int limbs, int log_n, int lazy,
                      int upper, void* stream) {
  if (rows < 1 || limbs < 1 || log_n < 1 || log_n > kFixedLogN) return static_cast<int>(cudaErrorInvalidValue);
  const Stacked s{cp<uint64_t>(psi), cp<uint64_t>(psi_s), cp<uint64_t>(psi_inv), cp<uint64_t>(psi_inv_s),
                  cp<uint64_t>(q), cp<uint64_t>(neg_q_inv), cp<uint64_t>(n_inv), cp<uint64_t>(n_inv_s)};
  const Cross64 cr{cp<uint64_t>(v), cp<uint64_t>(t), cp<uint64_t>(ts), upper};
  const auto st = static_cast<cudaStream_t>(stream);
  return lazy ? launch_ntt_cross<true>(x, y, s, cr, rows, limbs, log_n, st)
              : launch_ntt_cross<false>(x, y, s, cr, rows, limbs, log_n, st);
}

// xs, ys, zs: host arrays of `terms` device pointers (zs null: one sum),
// each 16-byte aligned; out: (2 if zs else 1, rows, 2^log_n); each x (rows,
// 2^log_n), each y and z (y_rows, 2^log_n), y_rows = rows or limbs
// (broadcast); per-limb q, -q^-1 mod 2^64, 2^128 mod q; chunk: products
// summed before a REDC.
int lft_rns_mac(const void* xs, const void* ys, const void* zs, void* out, int terms, int rows, int limbs,
                int log_n, int y_rows, const void* q, const void* neg_q_inv, const void* r2, int chunk,
                void* stream) {
  if (!mac_args_ok(terms, rows, limbs, y_rows, chunk) || log_n < 0 || log_n > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  const MacShape sh{terms, rows, limbs, y_rows, zs != nullptr ? 2 : 1, chunk};
  const int log_v = log_n < 2 ? log_n : 2, log_items = log_n - log_v;
  const dim3 grid = log_items >= kLogThreads
                        ? dim3(static_cast<unsigned>(rows), 1u << (log_items - kLogThreads), 1)
                        : dim3(static_cast<unsigned>((rows + (kThreads >> log_items) - 1) >> (kLogThreads - log_items)), 1, 1);
  const auto kernel = log_v == 2 ? rns_mac_kernel<4> : log_v == 1 ? rns_mac_kernel<2> : rns_mac_kernel<1>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(terms_of(xs, ys, zs, terms),
                                                                   static_cast<uint64_t*>(out), sh, log_n,
                                                                   cp<uint64_t>(q), cp<uint64_t>(neg_q_inv),
                                                                   cp<uint64_t>(r2));
  return static_cast<int>(cudaGetLastError());
}

// rns_intt of lft_rns_mac's sums, in one launch: xs, ys, zs, out, terms,
// rows, limbs, y_rows, chunk as lft_rns_mac's (out: the inverse transforms,
// row r under limb r mod limbs), the stacked tables as lft_rns_ntt_inv's
// but N^-1 2^64 mod q and its Shoup dual in place of 1/N; lazy: every prime
// below 2^62.
int lft_rns_intt_mac(const void* xs, const void* ys, const void* zs, void* out, int terms, int rows, int limbs,
                     int log_n, int y_rows, const void* psi, const void* psi_s, const void* psi_inv,
                     const void* psi_inv_s, const void* q, const void* neg_q_inv, const void* n_inv_mac,
                     const void* n_inv_mac_s, int chunk, int lazy, void* stream) {
  if (!mac_args_ok(terms, rows, limbs, y_rows, chunk) || log_n < 1 || log_n > kMaxLogN)
    return static_cast<int>(cudaErrorInvalidValue);
  const Stacked s{cp<uint64_t>(psi), cp<uint64_t>(psi_s), cp<uint64_t>(psi_inv), cp<uint64_t>(psi_inv_s),
                  cp<uint64_t>(q), cp<uint64_t>(neg_q_inv), cp<uint64_t>(n_inv_mac), cp<uint64_t>(n_inv_mac_s)};
  const MacShape sh{terms, rows, limbs, y_rows, zs != nullptr ? 2 : 1, chunk};
  const Terms t = terms_of(xs, ys, zs, terms);
  auto* y = static_cast<uint64_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  return lazy ? launch_intt_mac<true>(t, y, s, sh, log_n, st) : launch_intt_mac<false>(t, y, s, sh, log_n, st);
}

// lft_rns_mac with a permutation table per term: perms, a host array of
// `terms` device pointers to N int32 (16-byte aligned), 0 for a term read
// in place; term k reads x_k[..., perm_k[c]] at column c.
int lft_rns_mac_gather(const void* xs, const void* ys, const void* zs, const void* perms, void* out, int terms,
                       int rows, int limbs, int log_n, int y_rows, const void* q, const void* neg_q_inv,
                       const void* r2, int chunk, void* stream) {
  if (!mac_args_ok(terms, rows, limbs, y_rows, chunk) || log_n < 0 || log_n > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  const MacShape sh{terms, rows, limbs, y_rows, zs != nullptr ? 2 : 1, chunk};
  const int log_v = log_n < 2 ? log_n : 2, log_items = log_n - log_v;
  const dim3 grid = log_items >= kLogThreads
                        ? dim3(static_cast<unsigned>(rows), 1u << (log_items - kLogThreads), 1)
                        : dim3(static_cast<unsigned>((rows + (kThreads >> log_items) - 1) >> (kLogThreads - log_items)), 1, 1);
  const auto kernel =
      log_v == 2 ? rns_mac_gather_kernel<4> : log_v == 1 ? rns_mac_gather_kernel<2> : rns_mac_gather_kernel<1>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(gather_terms_of(xs, ys, zs, perms, terms),
                                                                   static_cast<uint64_t*>(out), sh, log_n,
                                                                   cp<uint64_t>(q), cp<uint64_t>(neg_q_inv),
                                                                   cp<uint64_t>(r2));
  return static_cast<int>(cudaGetLastError());
}

// lft_rns_intt_mac with lft_rns_mac_gather's permutation tables.
int lft_rns_intt_mac_gather(const void* xs, const void* ys, const void* zs, const void* perms, void* out, int terms,
                            int rows, int limbs, int log_n, int y_rows, const void* psi, const void* psi_s,
                            const void* psi_inv, const void* psi_inv_s, const void* q, const void* neg_q_inv,
                            const void* n_inv_mac, const void* n_inv_mac_s, int chunk, int lazy, void* stream) {
  if (!mac_args_ok(terms, rows, limbs, y_rows, chunk) || log_n < 1 || log_n > kMaxLogN)
    return static_cast<int>(cudaErrorInvalidValue);
  const Stacked s{cp<uint64_t>(psi), cp<uint64_t>(psi_s), cp<uint64_t>(psi_inv), cp<uint64_t>(psi_inv_s),
                  cp<uint64_t>(q), cp<uint64_t>(neg_q_inv), cp<uint64_t>(n_inv_mac), cp<uint64_t>(n_inv_mac_s)};
  const MacShape sh{terms, rows, limbs, y_rows, zs != nullptr ? 2 : 1, chunk};
  const GatherTerms t = gather_terms_of(xs, ys, zs, perms, terms);
  auto* y = static_cast<uint64_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  return lazy ? launch_intt_mac_gather<true>(t, y, s, sh, log_n, st)
              : launch_intt_mac_gather<false>(t, y, s, sh, log_n, st);
}

// lft_rns_intt_mac_gather where every term's x is one tensor (the same
// pointer in xs), every prime below 2^62 (lazy), log_n = 13 and 1 to 4
// terms: the instance that copies each x row into shared memory. Any other
// operands are refused (cudaErrorInvalidValue).
int lft_rns_intt_mac_gather_shared(const void* xs, const void* ys, const void* zs, const void* perms, void* out,
                                   int terms, int rows, int limbs, int log_n, int y_rows, const void* psi,
                                   const void* psi_s, const void* psi_inv, const void* psi_inv_s, const void* q,
                                   const void* neg_q_inv, const void* n_inv_mac, const void* n_inv_mac_s, int chunk,
                                   int lazy, void* stream) {
  if (!mac_args_ok(terms, rows, limbs, y_rows, chunk) || log_n != kFixedLogN || !lazy || terms > kRowTerms ||
      chunk < terms)
    return static_cast<int>(cudaErrorInvalidValue);
  const GatherTerms t = gather_terms_of(xs, ys, zs, perms, terms);
  for (int k = 1; k < terms; ++k) {
    if (t.x[k] != t.x[0]) return static_cast<int>(cudaErrorInvalidValue);
  }
  const Stacked s{cp<uint64_t>(psi), cp<uint64_t>(psi_s), cp<uint64_t>(psi_inv), cp<uint64_t>(psi_inv_s),
                  cp<uint64_t>(q), cp<uint64_t>(neg_q_inv), cp<uint64_t>(n_inv_mac), cp<uint64_t>(n_inv_mac_s)};
  const MacShape sh{terms, rows, limbs, y_rows, zs != nullptr ? 2 : 1, chunk};
  return launch_intt_mac_shared(t, static_cast<uint64_t*>(out), s, sh, static_cast<cudaStream_t>(stream));
}

// The shape and residency of the lazy cluster instance that a launch of
// `rows` rows takes, of kind 0 (forward transform), 1 (inverse), 2
// (rns_intt_mac with `terms` terms) or 3 (its gathered instance) at N =
// 2^log_n, 13 <= log_n <= 16, into out[5]: blocks a row, threads a block,
// dynamic shared memory bytes, blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and clusters on the device
// (cudaOccupancyMaxActiveClusters). Host function; a CUDA error, or 0.
int lft_rns_cluster_occupancy(int kind, int log_n, int terms, int rows, int* out) {
  switch (log_n) {
    case 13: return occupancy_at<13>(kind, terms, rows, out);
    case 14: return occupancy_at<14>(kind, terms, rows, out);
    case 15: return occupancy_at<15>(kind, terms, rows, out);
    case 16: return occupancy_at<16>(kind, terms, rows, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K-AUTOMORPH on one or two parts (x1, y1 null: one): each x and y (rows,
// 2^log_n), row r under limb r mod limbs, 16-byte aligned; code: 2^log_n
// int32, src | sign << 31; q: (limbs,).
int lft_rns_automorphism(const void* x0, const void* x1, void* y0, void* y1, const void* code, const void* q,
                         int rows, int limbs, int log_n, void* stream) {
  if (rows < 1 || limbs < 1 || log_n < 0 || log_n > 30 || (x1 == nullptr) != (y1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Parts p{{cp<uint64_t>(x0), cp<uint64_t>(x1)}, {static_cast<uint64_t*>(y0), static_cast<uint64_t*>(y1)}};
  const int log_v = log_n < 2 ? log_n : 2;
  const auto kernel = log_v == 2 ? automorphism_kernel<4> : log_v == 1 ? automorphism_kernel<2> : automorphism_kernel<1>;
  const dim3 grid(grid_for(static_cast<long long>(rows) << (log_n - log_v)), x1 != nullptr ? 2 : 1, 1);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, static_cast<const int32_t*>(code),
                                                                   cp<uint64_t>(q), rows, limbs, log_n);
  return static_cast<int>(cudaGetLastError());
}

// x: `batch` blocks of (lq, 2^log_n) residues over the qs, block b at x +
// b x_stride (values), rows contiguous; the tables of Conv, each a device
// array; add: (lq,) or null. Block b of y at y + b y_stride (values): with
// rows null, (lp, 2^log_n) over the ps; else output limb j in its row
// rows[lq + j] and, with copy, x's limb k (before add) also into row
// rows[k], in the same launch. rows: (lq + lp) int32 on the device.
int lft_base_convert_rows(const void* x, void* y, const void* q, const void* qhi, const void* qhi_s,
                          const void* frac, const void* p, const void* w, const void* ws, const void* uq,
                          const void* add, const void* rows, int copy, int lq, int lp, int log_n, long long batch,
                          long long x_stride, long long y_stride, void* stream) {
  if (lq < 1 || lq > kMaxLimbs || lp < 1 || log_n < 0 || log_n > 30 || batch < 1 || (copy && rows == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = lq == 8   ? base_convert_kernel<8>
                      : lq == 2 ? base_convert_kernel<2>
                      : lq == 1 ? base_convert_kernel<1>
                                : base_convert_kernel<0>;
  const size_t smem = conv_words(lq, lp, kernel == base_convert_kernel<0>) * sizeof(uint64_t);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Conv c{cp<uint64_t>(q), cp<uint64_t>(qhi), cp<uint64_t>(qhi_s), cp<double>(frac), cp<uint64_t>(p),
               cp<uint64_t>(w), cp<uint64_t>(ws), cp<uint64_t>(uq), cp<uint64_t>(add)};
  kernel<<<grid_for(batch << log_n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(y), c, lq, lp, log_n, batch, x_stride, y_stride,
      static_cast<const int*>(rows), copy);
  return static_cast<int>(cudaGetLastError());
}

// x: (batch, limbs, 2^log_n); conv: (batch, keep, 2^log_n) or null (one
// dropped limb, prime q_d, ph_d = (q_d >> 1)); y: (batch, keep, 2^log_n);
// the kept limbs' (keep,) q, P/2 mod q, P^-1 mod q and its dual, Barrett m.
// Then + add mod q: add0 (half, keep, 2^log_n) onto the first `half` blocks
// of y, add1 (batch - half, keep, 2^log_n) onto the others; either may be
// null (no add there).
int lft_rescale_add(const void* x, const void* conv, void* y, const void* q, const void* p_half, const void* p_inv,
                    const void* p_inv_s, const void* bm, const void* add0, const void* add1, int limbs, int keep,
                    int log_n, long long batch, long long half, unsigned long long q_d, unsigned long long ph_d,
                    void* stream) {
  if (keep < 1 || limbs <= keep || log_n < 0 || log_n > 30 || batch < 1 || half < 0 || half > batch)
    return static_cast<int>(cudaErrorInvalidValue);
  const Rescale c{cp<uint64_t>(q), cp<uint64_t>(p_half), cp<uint64_t>(p_inv), cp<uint64_t>(p_inv_s),
                  cp<uint64_t>(bm)};
  const long long count = (batch * keep) << log_n;
  rescale_kernel<<<grid_for(count), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<const uint64_t*>(conv), static_cast<uint64_t*>(y), c, limbs,
      keep, log_n, count, q_d, ph_d, cp<uint64_t>(add0), cp<uint64_t>(add1), half);
  return static_cast<int>(cudaGetLastError());
}

// K-RNS-ADD on one or two parts (a1, y1 null: one): op 0 y = a + b, 1 a - b,
// 2 -a (b null), mod the row's prime; each a, b and y 16-byte aligned. Part
// k: y (rows_k, 2^log_n), row r under limb r mod limbs; a's row r its row r
// mod a_rows_k, b's r mod b_rows_k (each rows_k or limbs); q: (limbs,).
int lft_rns_add(const void* a0, const void* b0, void* y0, const void* a1, const void* b1, void* y1, const void* q,
                int op, int limbs, int log_n, int rows0, int a_rows0, int b_rows0, int rows1, int a_rows1,
                int b_rows1, void* stream) {
  const bool two = a1 != nullptr;
  const bool need_b = op != kNeg;
  const auto rows_ok = [&](int rows, int r) { return r >= 1 && (r == rows || r == limbs) && rows % r == 0; };
  const auto part_ok = [&](const void* b, int rows, int a_rows, int b_rows) {
    return rows >= 1 && rows_ok(rows, a_rows) && (!need_b || (b != nullptr && rows_ok(rows, b_rows)));
  };
  if (limbs < 1 || log_n < 1 || log_n > 30 || op < kAdd || op > kNeg || two != (y1 != nullptr) ||
      !part_ok(b0, rows0, a_rows0, b_rows0) || (two && !part_ok(b1, rows1, a_rows1, b_rows1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const AddParts p{{cp<uint64_t>(a0), cp<uint64_t>(a1)},
                   {cp<uint64_t>(b0), cp<uint64_t>(b1)},
                   {static_cast<uint64_t*>(y0), static_cast<uint64_t*>(y1)},
                   {rows0, two ? rows1 : 0},
                   {a_rows0, two ? a_rows1 : 1},
                   {need_b ? b_rows0 : 1, two && need_b ? b_rows1 : 1}};
  const auto kernel = op == kAdd ? rns_add_kernel<kAdd> : op == kSub ? rns_add_kernel<kSub> : rns_add_kernel<kNeg>;
  const int rows = two && rows1 > rows0 ? rows1 : rows0;
  const dim3 grid(grid_for(static_cast<long long>(rows) << (log_n - 1)), two ? 2 : 1, 1);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, cp<uint64_t>(q), limbs, log_n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
