// K-EXTPROD64 and K-FHEW-BR64: the u64 engine's external product / key
// switch of a batch of RLWE ciphertexts, and the whole LMKCDEY blind
// rotation of a batch of FHEW ciphertexts in one launch.
//
// Replaces XLA fusions of the JAX package (no Pallas call):
//   K-EXTPROD64 <- rgsw.external_product's u64 branch (learn_fhe_tpu/models/
//                  fhew/rgsw.py:154-159), rgsw.internal_product (rgsw.py:179,
//                  every row of an RGSW through one external product; the
//                  hot loop of key_share_merge) and rlwe.key_switch's u64
//                  branch (rlwe.py:190-214);
//   K-FHEW-BR64 <- the u64 branch of the scan blind_rotate_core_fused
//                  (learn_fhe_tpu/models/fhew/bootstrapping.py:423, u32
//                  false at :436), vmapped over the batch.
// Per digit row both compute the Zq gadget digit, its forward NTT, and its
// products with the key's evaluation-basis Montgomery rows summed in 128
// bits; REDC; two inverse NTTs. The results are bit-identical to
// external_product64_ref and blind_rotate_core_fused_ref's u64 branch.
//
// K-EXTPROD64 (redesigned, lft64::rows::external_product in u64_rows.cuh):
// one 256-thread block per product, two blocks an SM. What bounded it: at
// the merge's chunk (600 products of 10 rows, N = 2048, q ~ 2^55) the
// instructions' issue (0.085 ms counted) against 0.26 ms taken, with one
// 512-thread block an SM holding all 10 digit rows in 208 KB of shared
// memory, its 10 forward transforms 54% of a product and the contraction's
// waits on 320 KB of key rows (L2 hits: each key serves 10 consecutive
// products) 15%, with no other block to fill them, and 4.55 waves. The
// design: the digit rows pass through 5-row groups (112 KB a block, so two
// blocks an SM fill each other's waits); the digits are made inside the
// first forward pass, the last forward pass feeds the contraction directly
// (one REDC per group, the group residues added mod q), the first inverse
// pass runs on the sums in registers and the last writes device memory.
//
// K-FHEW-BR64 runs lft64::phase (u64.cuh).
// K-FHEW-BR64: each ciphertext walks its fused schedule of (ext_idx,
// auto_idx) pairs to its first (-1, -1). A step runs, if ext >= 0, the
// external product with brk[ext] (2d rows), then, if auto >= 0, the
// automorphism X -> X^t by the gather map and signs of ak[auto] and the key
// switch with ak[auto] (d rows), b += the gathered b.
//
// What bounds them on an H100: at the full multi-key set (q ~ 2^55, N =
// 2048, 2d = 10) an external product is 12 transforms of 2048 u64 points,
// some 135,000 Shoup butterflies of 27 (lazy) to 39 (eager) 32-bit
// instructions each (counted from the SASS), and its key rows are 320 KB;
// brk is 197 MB, far beyond the 50 MB L2. A ciphertext's walk is a chain of
// some 1,150 phases; with one block per ciphertext a phase took about 62 us
// (external product) or 39 us (key switch), the 10 forward transforms 58%
// of it, and a block took as long alone on the card as beside 127 others:
// the chain's latency, not the card's issue, set a gate round's time, and a
// round of 2 gates cost as much as one of 128.
//
// The design: acc (a, b) stays in shared memory for the whole walk; a
// phase (lft64::phase) makes the digit rows, runs their forward passes (3
// layers in registers each, twiddles loaded once per item and reused over
// the rows, Harvey's lazy butterflies for q < 2^62), sums the row products
// in 128 bits against the key rows (a row's key values for all of a
// thread's coefficients loaded at once), REDCs once, and runs the two
// inverse passes. K-FHEW-BR64 runs one cluster of C blocks per ciphertext:
// block c takes the c-th share of each phase's digit rows (their digits,
// forward transforms and contraction), block c adds slice c of the 2N
// partial residues of all blocks and writes the sums into every block's
// acc through distributed shared memory, and every block runs both inverse
// transforms on its own copy of acc, so the next phase needs no second
// exchange. (An L2 prefetch of a phase's key rows ahead of its digits was
// measured and left out: with the contraction's loads overlapped it gained
// nothing; PERF.md.) The host picks C from the batch
// (bootstrapping.walk64_cluster_size): the largest C up to the rows of a
// phase at which all clusters are resident at once, so a gate round of 2
// ciphertexts runs 5 blocks each at the full set, and a batch of 128 one
// block each (C = 1, no exchange).
//
// An index outside the key ends that ciphertext's walk (K-EXTPROD64: skips
// that input) before any read by it and ORs a bit into *error (1: ext or
// K-EXTPROD64's key index, 2: auto; a cluster's first block ORs it); that
// output then holds acc as it stood.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "u64.cuh"
#include "u64_rows.cuh"

namespace cg = cooperative_groups;

namespace {

using lft64::kThreads;
constexpr int kBadExt = 1, kBadAuto = 2;
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may take

// Shared memory of a block, in rows of 2^log_n u64: acc (a, b), the
// gathered b, with a cluster the partial residues (2 rows), the digit rows.
__host__ __device__ constexpr int fixed_rows(bool clustered) { return clustered ? 5 : 3; }

__device__ __forceinline__ void load_acc(uint64_t* acc, const uint64_t* __restrict__ a,
                                         const uint64_t* __restrict__ b, size_t ct, int log_n) {
  const int n = 1 << log_n;
  const size_t row = ct << log_n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    acc[j] = __ldg(a + row + j);
    acc[n + j] = __ldg(b + row + j);
  }
  __syncthreads();
}

__device__ __forceinline__ void store_acc(const uint64_t* acc, uint64_t* __restrict__ a, uint64_t* __restrict__ b,
                                          size_t ct, int log_n) {
  const int n = 1 << log_n;
  const size_t row = ct << log_n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    a[row + j] = acc[j];
    b[row + j] = acc[n + j];
  }
}

// Input i of the batch against key rows key_idx[i] (rows of 2^log_n each):
// an external product (key_switch 0, rows = 2d) or a key switch of the
// input (key_switch 1, rows = d), `group` digit rows at a time; kLogN 11 for
// N = 2048 (every offset a constant), 1 or 2 for N = 2 or 4, else 0
// (lft64::rows::external_product).
template <bool kLazy, int kLogN>
__global__ void __launch_bounds__(lft64::rows::kExtThreads, 2)
    external_product64_kernel(const uint64_t* __restrict__ ct_a, const uint64_t* __restrict__ ct_b,
                              uint64_t* __restrict__ out_a, uint64_t* __restrict__ out_b,
                              const int32_t* __restrict__ key_idx, const uint64_t* __restrict__ key_a,
                              const uint64_t* __restrict__ key_b, int n_keys, int rows, int key_switch,
                              lft64::Tables t, lft64::Gadget g, int log_n, int group, int* __restrict__ error) {
  extern __shared__ uint64_t sh[];
  const int e = key_idx[blockIdx.x];
  const size_t ct = blockIdx.x;
  if (e < 0 || e >= n_keys) {  // the output is the input
    const size_t base = ct << log_n;
    for (int j = threadIdx.x; j < (1 << log_n); j += blockDim.x) {
      out_a[base + j] = ct_a[base + j];
      out_b[base + j] = ct_b[base + j];
    }
    if (threadIdx.x == 0) atomicOr(error, kBadExt);
    return;
  }
  const size_t key = static_cast<size_t>(e) * rows << log_n;
  lft64::rows::external_product<kLazy, kLogN>(sh, group, ct_a, ct_b, out_a, out_b, ct, key_a + key, key_b + key, rows,
                                       key_switch != 0, t, g, log_n);
}

// The walk; with kCluster, one cluster of blocks per ciphertext (the
// launch's cluster size), else one block. A cluster needs d > 1, and the
// REDC bound leaves d = 1 to an eager q (>= 2^62), so a cluster is lazy.
template <bool kLazy, bool kCluster>
__global__ void __launch_bounds__(kThreads, 1)
    fhew_blind_rotate64_kernel(const uint64_t* __restrict__ acc_a, const uint64_t* __restrict__ acc_b,
                               uint64_t* __restrict__ out_a, uint64_t* __restrict__ out_b,
                               const int32_t* __restrict__ ext_idx, const int32_t* __restrict__ auto_idx,
                               int steps, const uint64_t* __restrict__ brk_a, const uint64_t* __restrict__ brk_b,
                               int n_keys, const uint64_t* __restrict__ ak_a, const uint64_t* __restrict__ ak_b,
                               const int32_t* __restrict__ auto_src, const uint8_t* __restrict__ auto_sign,
                               int windows, lft64::Tables t, lft64::Gadget gg, lft64::Gadget gk, int log_n,
                               int group, int* __restrict__ error) {
  static_assert(kLazy || !kCluster, "a cluster runs only the lazy instance");
  extern __shared__ uint64_t sh[];
  const int n = 1 << log_n;
  lft64::Share share{0, 1, nullptr};
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    share = lft64::Share{static_cast<int>(cluster.block_rank()), static_cast<int>(cluster.num_blocks()), sh + 3 * n};
  }
  uint64_t* acc = sh;
  uint64_t* gb = sh + 2 * n;
  uint64_t* buf = sh + (static_cast<size_t>(fixed_rows(kCluster)) << log_n);
  const size_t ct = blockIdx.x / share.size;
  load_acc(acc, acc_a, acc_b, ct, log_n);
  const int32_t* e_row = ext_idx + ct * steps;
  const int32_t* a_row = auto_idx + ct * steps;
  const int rows_g = 2 * gg.d;
  int bad = 0;
  for (int s = 0; s < steps; ++s) {
    const int e = e_row[s], au = a_row[s];  // the same for every thread of the cluster
    if (e == -1 && au == -1) break;         // the end of this ciphertext's schedule
    if (e < -1 || e >= n_keys) bad |= kBadExt;
    if (au < -1 || au >= windows) bad |= kBadAuto;
    if (bad) break;
    if (e >= 0) {
      const size_t key = static_cast<size_t>(e) * rows_g << log_n;
      lft64::phase<false, kLazy, kCluster>(acc, buf, group, gb, share, log_n, t, gg, rows_g, brk_a + key,
                                           brk_b + key, nullptr, nullptr);
    }
    if (au >= 0) {
      const size_t key = static_cast<size_t>(au) * gk.d << log_n;
      const size_t map = static_cast<size_t>(au) << log_n;
      lft64::phase<true, kLazy, kCluster>(acc, buf, group, gb, share, log_n, t, gk, gk.d, ak_a + key, ak_b + key,
                                          auto_src + map, auto_sign + map);
    }
  }
  if (share.rank == 0) {
    if (bad && threadIdx.x == 0) atomicOr(error, bad);
    store_acc(acc, out_a, out_b, ct, log_n);
  }
}

using WalkKernel = decltype(&fhew_blind_rotate64_kernel<true, true>);

// The walk's instance: lazy below 2^62 (lft64::lazy_ok), clustered where
// the launch has more than one block per ciphertext.
WalkKernel walk_kernel(uint64_t q, bool clustered) {
  if (!lft64::lazy_ok(q)) return fhew_blind_rotate64_kernel<false, false>;
  return clustered ? fhew_blind_rotate64_kernel<true, true> : fhew_blind_rotate64_kernel<true, false>;
}

// K-EXTPROD64's instance for the ring: N = 2048, N = 2 or 4, or any other N.
template <bool kLazy>
auto ext_kernel(int log_n) -> decltype(&external_product64_kernel<kLazy, 0>) {
  if (log_n == lft64::kMaxLogN) return external_product64_kernel<kLazy, lft64::kMaxLogN>;
  if (log_n == 1) return external_product64_kernel<kLazy, 1>;
  return log_n == 2 ? external_product64_kernel<kLazy, 2> : external_product64_kernel<kLazy, 0>;
}

// The walk's digit rows a block's buffer holds at once: as many of the
// `rows` it takes as fit in shared memory beside the fixed rows (all 10 of
// an external product at N=2048 and C = 1: 208 KB). Fewer rows at a time (4,
// then 5) ran slower on an H100: more barriers, fewer items per thread
// between them.
int group_rows(int log_n, int rows, bool clustered) {
  const int g = static_cast<int>(kMaxSmem / sizeof(uint64_t) >> log_n) - fixed_rows(clustered);
  return g < rows ? g : rows;
}

size_t smem_bytes(int log_n, int group, bool clustered) {
  return (static_cast<size_t>(fixed_rows(clustered) + group) << log_n) * sizeof(uint64_t);
}

// A walk of clusters of `cluster` blocks: the digit rows a block takes (the
// most of either phase's share) and its shared memory.
int walk_group(int log_n, int rows_g, int rows_k, int cluster) {
  const int rows = rows_g > rows_k ? rows_g : rows_k;
  return group_rows(log_n, (rows + cluster - 1) / cluster, cluster > 1);
}

// Whether `rows` products of two residues sum below q 2^64, the bound of one
// REDC; and the shape and gadget arguments the kernels take.
bool bad_args(int log_n, uint64_t q, int rows, int log_b, int d) {
  if (log_n < 1 || log_n > lft64::kMaxLogN || q < 3 || q % 2 == 0 || q >= (1ull << 63)) return true;
  if (rows < 1 || log_b < 1 || d < 1 || log_b * d > 64) return true;
  const unsigned __int128 sq = static_cast<unsigned __int128>(q - 1) * (q - 1);
  return sq * static_cast<unsigned>(rows) >= static_cast<unsigned __int128>(q) << 64;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

lft64::Tables tables(const void* psi, const void* psi_s, const void* psi_inv, const void* psi_inv_s, uint64_t q,
                     uint64_t neg_q_inv, uint64_t n_inv, uint64_t n_inv_s) {
  return lft64::Tables{static_cast<const uint64_t*>(psi), static_cast<const uint64_t*>(psi_s),
                       static_cast<const uint64_t*>(psi_inv), static_cast<const uint64_t*>(psi_inv_s),
                       q, neg_q_inv, n_inv, n_inv_s};
}

// The walk's launch configuration: batch clusters of `cluster` blocks (a
// cluster attribute only where cluster > 1).
void walk_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int batch, int cluster, size_t smem,
                 cudaStream_t stream) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * static_cast<unsigned>(cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
}

}  // namespace

extern "C" {

// ct_a, ct_b, out_a, out_b: (batch, 2^log_n) residues; key_idx: (batch,)
// int32; key_a, key_b: (n_keys, rows, 2^log_n) evaluation-basis Montgomery
// rows; key_switch: 0 for an external product (rows = 2d), 1 for a key
// switch (rows = d); the plan's tables and constants; the gadget (log_b, d,
// rounding bits, 2^(bits-1) mod q); error: one int on the device. The
// lazy instance runs for q < 2^62, the eager one above.
int lft_external_product64(const void* ct_a, const void* ct_b, void* out_a, void* out_b, const void* key_idx,
                           int batch, const void* key_a, const void* key_b, int n_keys, int rows, int key_switch,
                           const void* psi, const void* psi_s, const void* psi_inv, const void* psi_inv_s,
                           int log_n, unsigned long long q, unsigned long long neg_q_inv, unsigned long long n_inv,
                           unsigned long long n_inv_s, int log_b, int d, int rb, unsigned long long half, void* error,
                           void* stream) {
  if (batch < 1 || n_keys < 1 || bad_args(log_n, q, rows, log_b, d) || rows != (key_switch ? d : 2 * d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = lft64::rows::ext_group(log_n, rows, q);
  const size_t smem = static_cast<size_t>(2 + group) << log_n << 3;
  const auto kernel = lft64::lazy_ok(q) ? ext_kernel<true>(log_n) : ext_kernel<false>(log_n);
  if (const int err = prepare(kernel, smem)) return err;
  kernel<<<static_cast<unsigned>(batch), lft64::rows::ext_threads(log_n), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(ct_a), static_cast<const uint64_t*>(ct_b), static_cast<uint64_t*>(out_a),
      static_cast<uint64_t*>(out_b), static_cast<const int32_t*>(key_idx), static_cast<const uint64_t*>(key_a),
      static_cast<const uint64_t*>(key_b), n_keys, rows, key_switch,
      tables(psi, psi_s, psi_inv, psi_inv_s, q, neg_q_inv, n_inv, n_inv_s), lft64::make_gadget(log_b, d, rb, half),
      log_n, group, static_cast<int*>(error));
  return static_cast<int>(cudaGetLastError());
}

// The walk of `batch` ciphertexts over their (batch, steps) schedules: acc
// and out (batch, 2^log_n) a and b; brk (n_keys, 2d, 2^log_n), ak (windows,
// d_k, 2^log_n) evaluation-basis Montgomery rows; auto_src (windows, 2^log_n)
// int32, auto_sign bytes; the plan's tables and constants; the RGSW and the
// RLWE gadget; cluster: the blocks per ciphertext, 1..8, more than 1 only
// for q < 2^62 (a launch the card refuses returns its error); error: one
// int on the device, OR-ed with 1 (2) where an ext (auto) index lies
// outside the key. The lazy instance runs for q < 2^62, the eager one above.
int lft_fhew_blind_rotate64(const void* acc_a, const void* acc_b, void* out_a, void* out_b, const void* ext_idx,
                            const void* auto_idx, int batch, int steps, const void* brk_a, const void* brk_b,
                            int n_keys, const void* ak_a, const void* ak_b, const void* auto_src,
                            const void* auto_sign, int windows, const void* psi, const void* psi_s,
                            const void* psi_inv, const void* psi_inv_s, int log_n, unsigned long long q,
                            unsigned long long neg_q_inv, unsigned long long n_inv, unsigned long long n_inv_s,
                            int log_b_g, int d_g, int rb_g, unsigned long long half_g, int log_b_k, int d_k,
                            int rb_k, unsigned long long half_k, int cluster, void* error, void* stream) {
  if (batch < 1 || steps < 0 || cluster < 1 || cluster > lft64::kMaxCluster || (cluster > 1 && !lft64::lazy_ok(q)) ||
      bad_args(log_n, q, 2 * d_g, log_b_g, d_g) || bad_args(log_n, q, d_k, log_b_k, d_k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = walk_group(log_n, 2 * d_g, d_k, cluster);
  const size_t smem = smem_bytes(log_n, group, cluster > 1);
  const WalkKernel kernel = walk_kernel(q, cluster > 1);
  if (const int err = prepare(kernel, smem)) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  walk_config(cfg, attr, batch, cluster, smem, static_cast<cudaStream_t>(stream));
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const uint64_t*>(acc_a), static_cast<const uint64_t*>(acc_b),
      static_cast<uint64_t*>(out_a), static_cast<uint64_t*>(out_b), static_cast<const int32_t*>(ext_idx),
      static_cast<const int32_t*>(auto_idx), steps, static_cast<const uint64_t*>(brk_a),
      static_cast<const uint64_t*>(brk_b), n_keys, static_cast<const uint64_t*>(ak_a),
      static_cast<const uint64_t*>(ak_b), static_cast<const int32_t*>(auto_src),
      static_cast<const uint8_t*>(auto_sign), windows, tables(psi, psi_s, psi_inv, psi_inv_s, q, neg_q_inv, n_inv, n_inv_s),
      lft64::make_gadget(log_b_g, d_g, rb_g, half_g), lft64::make_gadget(log_b_k, d_k, rb_k, half_k), log_n, group,
      static_cast<int*>(error));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `cluster` blocks (2..8) of the walk the current
// device holds at once (cudaOccupancyMaxActiveClusters), at ring 2^log_n
// with phases of rows_g and rows_k digit rows; a negative CUDA error.
int lft_fhew_walk64_clusters(int cluster, int log_n, int rows_g, int rows_k) {
  if (cluster < 2 || cluster > lft64::kMaxCluster || log_n < 1 || log_n > lft64::kMaxLogN || rows_g < 1 ||
      rows_k < 1) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = walk_group(log_n, rows_g, rows_k, cluster);
  const size_t smem = smem_bytes(log_n, group, true);
  const WalkKernel kernel = fhew_blind_rotate64_kernel<true, true>;
  if (const int err = prepare(kernel, smem)) return -err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  walk_config(cfg, attr, 1, cluster, smem, nullptr);
  int count = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

}  // extern "C"
