// K-STEP: one whole TFHE blind-rotation step (tggsw.cmux_rotate for k=1,
// d=1), in place on the accumulator:
//
//   acc += (X^s - 1) (*) ExtProd(brk_i, acc),   s = exps[b] mod 2N
//
// Replaces the Pallas step kernel bench/pallas_step_experiment.py:118-198
// (step_kernel, pl.pallas_call at :202), which kept the whole batch's (N, B)
// planes of every stage live in the TPU's VMEM at once and never compiled.
//
// Design for Hopper: one cluster of K blocks per ciphertext, grid (K, B),
// cluster {K, 1, 1}; block r of a cluster owns CRT prime r. Per block, in a
// (2, N) u32 buffer of shared memory (16 KB at N=2048), beside a copy of
// the prime's four twiddle tables (32 KB), staged at the start of the step:
//   1. the gadget digit of each coefficient of acc's a and b rows (the u32
//      form of decompose_t64, rounding_bits >= 33), sign-folded into prime
//      r, read straight from acc into the first NTT pass's registers;
//   2. the forward NTT of both rows in passes of up to 3 layers in
//      registers (radix 8: [3, 3, 3, 2] layers at N=2048), one barrier each;
//   3. in the last forward pass, still in registers: the Shoup contraction
//      with this step's key rows of prime r, the monomial as mv*e - e with
//      row s of prime r's (2N, N) table, and the first inverse pass;
//   4. the remaining inverse passes, the 1/N scale folded into the last;
//   5. cluster.sync(), then Garner across the cluster: each block takes a
//      strided quarter of the 2N coefficients, reads their K residues from
//      its peers' buffers (distributed shared memory), and adds the u64
//      delta into acc; a second cluster barrier keeps every block's buffer
//      alive until its peers have read it.
// Every block reads all of acc for its digits before the first
// cluster.sync(); after it, each coefficient is read and written only by
// the one block that owns it, so the blocks of a cluster do not race, and
// clusters own disjoint ciphertexts. Values stay reduced mod q between
// layers (the primes are close to 2^31, so [0, 4q) would overflow u32), so
// the result is bit-identical to cmux_rotate_ref.
//
// What bounds it on an H100: integer instruction issue in the SMs. A step
// at batch 128 runs 2048 transforms of 2048 points (about 23 M Shoup
// butterflies) against about 17 MB of device-memory traffic (acc in and
// out, the key, row s of the monomial table per ciphertext and prime).
// A block has 256 threads of at most 64 registers, so 4 fit on an SM, and
// the card holds at most 124 clusters of 4 at once, so at batch 128 four
// clusters run in a second wave. A block alone on an SM finishes in about
// half the time of four sharing it (timed over batch sizes, PERF.md): the
// SM's issue, not memory, sets the time. The four primes of a ciphertext run in
// parallel, a block waits at 6 barriers per step instead of 176, and each
// ring size has its own instance (template LOG_N), so the passes' index
// arithmetic is constant. lft_tfhe_blind_rotate launches the steps of a
// whole blind rotation from C, so no Python runs between them, and every
// launch after the first is a programmatic dependent launch: a step's loads
// of the key, the monomial rows and the twiddles overlap the previous
// step's end.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "ntt32.cuh"
#include "torus_crt.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLogN = 11;
constexpr int kOwned = 4;  // Garner coefficients a thread loads at once

// First (and, with d=1, only) signed digit of a torus value from its high
// word: decompose_t64_u32 of learn_fhe_tpu/ops/gadget.py:175-197, returned
// as a two's-complement u32.
__device__ __forceinline__ uint32_t gadget_digit(int64_t x, int log_b, int rounding_bits) {
  const uint32_t hi = static_cast<uint32_t>(static_cast<uint64_t>(x) >> 32);
  uint32_t v = (hi + (1u << (rounding_bits - 33))) >> (rounding_bits - 32);
  const uint32_t limb = v & ((1u << log_b) - 1u);
  v >>= log_b;
  const uint32_t carry = (((limb - 1u) | v) & limb) >> (log_b - 1);
  return limb - (carry << log_b);
}

// What one block works on: its ciphertext's acc rows, its prime's tables,
// key rows and monomial row, and its (2, N) buffer.
struct Block {
  uint32_t* buf;
  const int64_t* acc_a;
  const int64_t* acc_b;
  const uint32_t* __restrict__ psi;
  const uint32_t* __restrict__ psi_s;
  const uint32_t* __restrict__ psi_inv;
  const uint32_t* __restrict__ psi_inv_s;
  const uint32_t* __restrict__ kav;  // (2, N): the digit rows' key under prime r, a part
  const uint32_t* __restrict__ kad;
  const uint32_t* __restrict__ kbv;  // b part
  const uint32_t* __restrict__ kbd;
  const uint32_t* __restrict__ mv;  // row s of prime r's monomial table and its duals
  const uint32_t* __restrict__ md;
  uint32_t q, n_inv, n_inv_s;
  int log_b, rounding_bits;
};

// The inverse layers of a pass on both rows, with the 1/N scale when the
// pass ends at layer 0.
template <int W, int L0>
__device__ __forceinline__ void inverse_layers(const Block& k, uint32_t (&x0)[1 << W],
                                               uint32_t (&x1)[1 << W], int hi) {
  uint32_t w[(1 << W) - 1], ws[(1 << W) - 1];
  lft::pass_twiddles<W>(w, ws, k.psi_inv, k.psi_inv_s, L0, hi);
  lft::inv_radix<W>(x0, w, ws, k.q);
  lft::inv_radix<W>(x1, w, ws, k.q);
  if constexpr (L0 == 0) {
#pragma unroll
    for (int m = 0; m < (1 << W); ++m) {
      x0[m] = lft::mul_shoup(x0[m], k.n_inv, k.n_inv_s, k.q);
      x1[m] = lft::mul_shoup(x1[m], k.n_inv, k.n_inv_s, k.q);
    }
  }
}

// Forward pass over layers l0 .. l0+W-1 of both rows. kFirst: the values
// are the digits of acc, read from device memory. kLast: the pass ends at
// layer log_n - 1, and the contraction, the monomial and the inverse of the
// same layers follow in registers.
template <int LOG_N, int L0, int W, bool kFirst, bool kLast>
__device__ __forceinline__ void forward_pass(const Block& k) {
  constexpr int R = 1 << W;
  constexpr int n = 1 << LOG_N;
  constexpr int log_h = LOG_N - L0 - W;
#pragma unroll
  for (int t = threadIdx.x; t < (n >> W); t += kThreads) {
    const int lo = t & ((1 << log_h) - 1);
    const int hi = t >> log_h;
    const int base = (hi << (LOG_N - L0)) + lo;
    uint32_t x0[R], x1[R];
    if constexpr (kFirst) {
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int i = base + (m << log_h);
        x0[m] = lft::sign_fold(gadget_digit(k.acc_a[i], k.log_b, k.rounding_bits), k.q);
        x1[m] = lft::sign_fold(gadget_digit(k.acc_b[i], k.log_b, k.rounding_bits), k.q);
      }
    } else {
      lft::load_row<W, log_h>(x0, k.buf, base);
      lft::load_row<W, log_h>(x1, k.buf, n + base);
    }
    {
      uint32_t w[R - 1], ws[R - 1];
      lft::pass_twiddles<W>(w, ws, k.psi, k.psi_s, L0, hi);
      lft::fwd_radix<W>(x0, w, ws, k.q);
      lft::fwd_radix<W>(x1, w, ws, k.q);
    }
    if constexpr (kLast) {
      // log_h == 0: this thread holds coefficients base .. base+R-1 of both
      // NTT rows (the digits of a and of b); in chunks of up to 4 to bound
      // the registers live at once.
      constexpr int C = R < 4 ? R : 4;
#pragma unroll
      for (int c = 0; c < R; c += C) {
        const int j = base + c;
        uint32_t v0[C], d0[C], v1[C], d1[C], ea[C], eb[C];
        lft::load_global<C>(v0, k.kav + j);
        lft::load_global<C>(d0, k.kad + j);
        lft::load_global<C>(v1, k.kav + n + j);
        lft::load_global<C>(d1, k.kad + n + j);
#pragma unroll
        for (int m = 0; m < C; ++m) {
          ea[m] = lft::add_mod(lft::mul_shoup(x0[c + m], v0[m], d0[m], k.q),
                               lft::mul_shoup(x1[c + m], v1[m], d1[m], k.q), k.q);
        }
        lft::load_global<C>(v0, k.kbv + j);
        lft::load_global<C>(d0, k.kbd + j);
        lft::load_global<C>(v1, k.kbv + n + j);
        lft::load_global<C>(d1, k.kbd + n + j);
#pragma unroll
        for (int m = 0; m < C; ++m) {
          eb[m] = lft::add_mod(lft::mul_shoup(x0[c + m], v0[m], d0[m], k.q),
                               lft::mul_shoup(x1[c + m], v1[m], d1[m], k.q), k.q);
        }
        lft::load_global<C>(v0, k.mv + j);
        lft::load_global<C>(d0, k.md + j);
#pragma unroll
        for (int m = 0; m < C; ++m) {
          x0[c + m] = lft::sub_mod(lft::mul_shoup(ea[m], v0[m], d0[m], k.q), ea[m], k.q);
          x1[c + m] = lft::sub_mod(lft::mul_shoup(eb[m], v0[m], d0[m], k.q), eb[m], k.q);
        }
      }
      inverse_layers<W, L0>(k, x0, x1, hi);
    }
    lft::store_row<W, log_h>(x0, k.buf, base);
    lft::store_row<W, log_h>(x1, k.buf, n + base);
  }
}

// Inverse pass over layers L0+2 .. L0 of both rows (never the last pass,
// so always 3 layers).
template <int LOG_N, int L0>
__device__ __forceinline__ void inverse_pass(const Block& k) {
  constexpr int W = 3;
  constexpr int R = 1 << W;
  constexpr int n = 1 << LOG_N;
  constexpr int log_h = LOG_N - L0 - W;
#pragma unroll
  for (int t = threadIdx.x; t < (n >> W); t += kThreads) {
    const int lo = t & ((1 << log_h) - 1);
    const int hi = t >> log_h;
    const int base = (hi << (LOG_N - L0)) + lo;
    uint32_t x0[R], x1[R];
    lft::load_row<W, log_h>(x0, k.buf, base);
    lft::load_row<W, log_h>(x1, k.buf, n + base);
    inverse_layers<W, L0>(k, x0, x1, hi);
    lft::store_row<W, log_h>(x0, k.buf, base);
    lft::store_row<W, log_h>(x1, k.buf, n + base);
  }
}

// Pass P runs layers 3P .. 3P+2; only the last may be narrower ([3, 3, 3,
// 2] at N=2048). The forward passes run in order, each ending at a
// barrier; the last one also runs the inverse of its own layers.
template <int LOG_N, int P>
__device__ __forceinline__ void forward_passes(const Block& k) {
  constexpr bool kLast = P == lft::pass_count(LOG_N) - 1;
  forward_pass<LOG_N, 3 * P, lft::pass_width(LOG_N, P), P == 0, kLast>(k);
  __syncthreads();
  if constexpr (!kLast) forward_passes<LOG_N, P + 1>(k);
}

// The inverse passes P, P-1, .., 0, with a barrier between two.
template <int LOG_N, int P>
__device__ __forceinline__ void inverse_passes(const Block& k) {
  if constexpr (P >= 0) {
    inverse_pass<LOG_N, 3 * P>(k);
    if constexpr (P > 0) {
      __syncthreads();
      inverse_passes<LOG_N, P - 1>(k);
    }
  }
}

// One instance per ring size 2^LOG_N, so that every pass's geometry is a
// compile-time constant.
template <int LOG_N>
__global__ void __launch_bounds__(kThreads, 4)
    tfhe_step_kernel(int64_t* acc_a, int64_t* acc_b, const int64_t* __restrict__ exps,
                     const uint32_t* __restrict__ av, const uint32_t* __restrict__ ad,
                     const uint32_t* __restrict__ bv, const uint32_t* __restrict__ bd,
                     const uint32_t* __restrict__ mon_v, const uint32_t* __restrict__ mon_d,
                     const uint32_t* __restrict__ psi, const uint32_t* __restrict__ psi_s,
                     const uint32_t* __restrict__ psi_inv, const uint32_t* __restrict__ psi_inv_s,
                     int log_b, int rounding_bits, lft::CrtConsts g) {
  extern __shared__ uint4 sh4[];  // 16-byte aligned for the vector accesses
  uint32_t* buf = reinterpret_cast<uint32_t*>(sh4);
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());  // this block's prime
  constexpr int n = 1 << LOG_N;
  constexpr int n2 = 2 * n;
  const size_t row = static_cast<size_t>(blockIdx.y) << LOG_N;

  // Programmatic dependent launch (every step of a rotation but the first):
  // this block may start while the previous step still runs. Until
  // griddepcontrol.wait it touches only what no step kernel writes (exps,
  // the key, the monomial table, the twiddles; a step writes nothing but
  // acc), and it issues this step's loads of those, so their latency
  // overlaps the previous step's end. Whatever wrote them before the
  // rotation (the copy that lays out exps, say) had finished before the
  // first step began, since that step is launched without the attribute.
  const int s = static_cast<int>(exps[blockIdx.y]) & (n2 - 1);  // exps mod 2N; exps may be 2N
  const size_t key = static_cast<size_t>(r) * n2;                // (2, N) rows of prime r
  const size_t mon = (static_cast<size_t>(r) * n2 + s) << LOG_N;
  if constexpr (n2 >= 32) {
    // this block's key rows (4 x 2N u32) and monomial rows (2 x N) into L2
    const uint32_t* rows[6] = {av + key, ad + key, bv + key, bd + key, mon_v + mon, mon_d + mon};
    constexpr int lines = n2 / 32;  // 128-byte lines in 2N u32
    for (int i = threadIdx.x; i < 6 * lines; i += kThreads) {
      const int t = i / lines;
      const uint32_t* p = rows[t] + (i - t * lines) * 32;
      if (t < 4 || p < rows[t] + n) asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
    }
  }
  // this prime's twiddle tables into shared memory, after the (2, N) buffer
  const uint32_t* tw[4] = {psi + r * n, psi_s + r * n, psi_inv + r * n, psi_inv_s + r * n};
  uint32_t* staged = buf + n2;
  for (int j = threadIdx.x; j < n; j += kThreads) {
#pragma unroll
    for (int t = 0; t < 4; ++t) staged[t * n + j] = __ldg(tw[t] + j);
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) tw[t] = staged + t * n;
  __syncthreads();
  // The previous kernel has finished and its writes (the previous step's
  // acc) are visible. Only then may the next step launch: it waits in
  // turn for this one, so at most one step waits at a time.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  const Block k{buf, acc_a + row, acc_b + row, tw[0], tw[1], tw[2], tw[3],
                av + key, ad + key, bv + key, bd + key, mon_v + mon, mon_d + mon,
                g.q[r], g.n_inv[r], g.n_inv_s[r], log_b, rounding_bits};
  forward_passes<LOG_N, 0>(k);
  inverse_passes<LOG_N, lft::pass_count(LOG_N) - 2>(k);

  // Garner across the cluster: coefficient j's K residues are at slot
  // swizzle(j) of the K blocks' buffers. A thread owns every (K * 256)-th
  // coefficient (4 at N=2048, K=4), kOwned at a time. It loads their acc
  // values before the cluster barrier (no other block writes them), then
  // all their residues from its peers' buffers, then computes.
  const int stride = g.k * kThreads;
  const int j_first = r * kThreads + threadIdx.x;
  auto acc_at = [&](int j) { return j < n ? acc_a + row + j : acc_b + row + (j - n); };
  uint64_t old[kOwned];
  auto load_old = [&](int j0) {
#pragma unroll
    for (int u = 0; u < kOwned; ++u) {
      if (j0 + u * stride < n2) old[u] = static_cast<uint64_t>(*acc_at(j0 + u * stride));
    }
  };
  load_old(j_first);
  cluster.sync();  // release this block's buffer, acquire the peers'
  const uint32_t* peer[lft::kMaxPrimes];
#pragma unroll
  for (int i = 0; i < lft::kMaxPrimes; ++i) peer[i] = cluster.map_shared_rank(buf, i < g.k ? i : 0);
  for (int j0 = j_first; j0 < n2; j0 += kOwned * stride) {
    if (j0 != j_first) load_old(j0);
    uint32_t c[kOwned][lft::kMaxPrimes];
#pragma unroll
    for (int u = 0; u < kOwned; ++u) {
      const int slot = lft::swizzle(j0 + u * stride);
#pragma unroll
      for (int i = 0; i < lft::kMaxPrimes; ++i) {
        c[u][i] = i < g.k && j0 + u * stride < n2 ? peer[i][slot] : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < kOwned; ++u) {
      const int j = j0 + u * stride;
      if (j < n2) *acc_at(j) = static_cast<int64_t>(old[u] + lft::garner(c[u], g));
    }
  }
  // No block may exit while a peer can still read its buffer. Nothing needs
  // ordering here (every value read from a peer is consumed above), so the
  // arrival is relaxed and the barrier costs no memory fence.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\tbarrier.cluster.wait.aligned;" ::: "memory");
}

using StepKernel = decltype(&tfhe_step_kernel<1>);

template <int... L>
StepKernel step_kernel_at(int log_n, std::integer_sequence<int, L...>) {
  static const StepKernel table[] = {tfhe_step_kernel<L + 1>...};
  return table[log_n - 1];
}

// The step kernel's instance for ring 2^log_n, 1 <= log_n <= kMaxLogN.
StepKernel step_kernel(int log_n) {
  return step_kernel_at(log_n, std::make_integer_sequence<int, kMaxLogN>{});
}

// The launch of one step: grid (K, batch) in clusters of K blocks; with
// `dependent`, a programmatic dependent launch on the step before it.
void step_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attrs)[2], int log_n, int k,
                 int batch, bool dependent, cudaStream_t stream) {
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = static_cast<unsigned>(k);
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(k), static_cast<unsigned>(batch), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (6 * sizeof(uint32_t)) << log_n;  // (2, N) buffer + 4 tables
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = dependent ? 2 : 1;
}

// One step on `stream`; the caller offsets the key and exps to the step.
// `dependent` only where the kernel before it on the stream is a step.
int launch_step(int64_t* acc_a, int64_t* acc_b, const int64_t* exps, int batch, const uint32_t* av,
                const uint32_t* ad, const uint32_t* bv, const uint32_t* bd, const uint32_t* mon_v,
                const uint32_t* mon_d, const uint32_t* psi, const uint32_t* psi_s,
                const uint32_t* psi_inv, const uint32_t* psi_inv_s, int log_n, int log_b,
                int rounding_bits, const lft::CrtConsts& g, bool dependent, cudaStream_t stream) {
  if (batch > 65535 || g.k < 1 || g.k > lft::kMaxPrimes || log_n < 1 || log_n > kMaxLogN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[2];
  step_config(cfg, attrs, log_n, g.k, batch, dependent, stream);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, step_kernel(log_n), acc_a, acc_b, exps, av, ad, bv, bd, mon_v, mon_d,
                         psi, psi_s, psi_inv, psi_inv_s, log_b, rounding_bits, g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One blind-rotation step: the key is one step's (K, 2, N) rows, exps (batch,).
extern "C" int lft_tfhe_step(void* acc_a, void* acc_b, const void* exps, int batch,
                             const void* av, const void* ad, const void* bv, const void* bd,
                             const void* mon_v, const void* mon_d, const void* psi,
                             const void* psi_s, const void* psi_inv, const void* psi_inv_s,
                             int log_n, int log_b, int rounding_bits,
                             const unsigned long long* consts, void* stream) {
  return launch_step(static_cast<int64_t*>(acc_a), static_cast<int64_t*>(acc_b),
                     static_cast<const int64_t*>(exps), batch, static_cast<const uint32_t*>(av),
                     static_cast<const uint32_t*>(ad), static_cast<const uint32_t*>(bv),
                     static_cast<const uint32_t*>(bd), static_cast<const uint32_t*>(mon_v),
                     static_cast<const uint32_t*>(mon_d), static_cast<const uint32_t*>(psi),
                     static_cast<const uint32_t*>(psi_s), static_cast<const uint32_t*>(psi_inv),
                     static_cast<const uint32_t*>(psi_inv_s), log_n, log_b, rounding_bits,
                     lft::load_crt_consts(consts), false, static_cast<cudaStream_t>(stream));
}

// The whole blind rotation: `steps` launches of the step kernel on `stream`,
// step i with row i of exps (steps, batch) and of the stacked key
// (steps, K, 2, N). Returns the first launch's error, if any.
extern "C" int lft_tfhe_blind_rotate(void* acc_a, void* acc_b, const void* exps, long long steps,
                                     int batch, const void* av, const void* ad, const void* bv,
                                     const void* bd, const void* mon_v, const void* mon_d,
                                     const void* psi, const void* psi_s, const void* psi_inv,
                                     const void* psi_inv_s, int log_n, int log_b,
                                     int rounding_bits, const unsigned long long* consts,
                                     void* stream) {
  const lft::CrtConsts g = lft::load_crt_consts(consts);
  const long long key_stride = (2LL * g.k) << log_n;  // (K, 2, N) u32 per step
  for (long long i = 0; i < steps; ++i) {
    const long long k = i * key_stride;
    const int err = launch_step(
        static_cast<int64_t*>(acc_a), static_cast<int64_t*>(acc_b),
        static_cast<const int64_t*>(exps) + i * batch, batch, static_cast<const uint32_t*>(av) + k,
        static_cast<const uint32_t*>(ad) + k, static_cast<const uint32_t*>(bv) + k,
        static_cast<const uint32_t*>(bd) + k, static_cast<const uint32_t*>(mon_v),
        static_cast<const uint32_t*>(mon_d), static_cast<const uint32_t*>(psi),
        static_cast<const uint32_t*>(psi_s), static_cast<const uint32_t*>(psi_inv),
        static_cast<const uint32_t*>(psi_inv_s), log_n, log_b, rounding_bits, g, i > 0,
        static_cast<cudaStream_t>(stream));
    if (err != 0) return err;
  }
  return 0;
}
