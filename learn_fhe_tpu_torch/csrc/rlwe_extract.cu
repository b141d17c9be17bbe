// K-EXTRACT: the FHEW sample extract, with the gate's + Q/8 on b, one launch
// a gate batch after the walk (models/fhew/rlwe.py::sample_extract).
//
// Replaces the JAX package's XLA stages learn_fhe_tpu/parallel/batch.py:105-111
// (in the jitted `fhew_blind_rotate_batch_device` at :87) ->
// learn_fhe_tpu/models/fhew/rlwe.py:257 `sample_extract`, ops/poly.py:93
// `sample_extract_a`, and the gate's + Q/8 mod Q (parallel/batch.py:162,
// models/fhew/gates.py:66,179). For each row of the accumulator (a, b
// (B, N), int32 residues on the u32 engine and int64 on the u64) it writes
// the LWE ciphertext of coefficient i, int64:
//   a_out[j] = a[i - j] for j <= i, and (Q - a[N + i - j]) mod Q for j > i
//     (0 stays 0, as neg_mod has it);
//   b_out = b[i] when b_add is 0, else (b[i] + b_add) mod Q (add_mod's
//     single conditional subtract).
//
// What bounds it on an H100: bytes, and in practice the launch. At the
// 28-bit fixture (N = 512, B = 128, int32 in) it moves 0.79 MB (0.23 us at
// 3.35 TB/s), at the multi-key full set (N = 2048, B = 128, int64 in)
// 4.2 MB (1.25 us); a u8 round of 2 gates is pure launch.
//
// Design: a thread an output coefficient over the flattened (B, N); a warp's
// 32 outputs read 32 consecutive words of a in reverse order, so its reads
// and its writes are each one coalesced run. The thread of coefficient 0
// of a row also writes that row's b.
//
// Why a launch of its own and not an epilogue of K-FHEW-BR / K-FHEW-BR64:
// those walks were redesigned for their own loop (acc in shared memory,
// one block or a cluster a ciphertext) and write acc from their last
// inverse pass; folding the extract into that pass is a question for a
// later redesign.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rlwe_extract_kernel(const T* __restrict__ a, const T* __restrict__ b, long long* __restrict__ out_a,
                        long long* __restrict__ out_b, int batch, int log_n, int i, unsigned long long q,
                        unsigned long long b_add) {
  const int big_n = 1 << log_n;
  const long long total = static_cast<long long>(batch) << log_n;
  for (long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * kThreads) {
    const long long row = idx >> log_n;
    const int j = static_cast<int>(idx & (big_n - 1));
    const T* ar = a + (row << log_n);
    long long v;
    if (j <= i) {
      v = static_cast<long long>(__ldg(ar + (i - j)));
    } else {
      const long long x = static_cast<long long>(__ldg(ar + (big_n + i - j)));
      v = x == 0 ? 0 : static_cast<long long>(q) - x;
    }
    out_a[idx] = v;
    if (j == 0) {
      unsigned long long s = static_cast<unsigned long long>(static_cast<long long>(__ldg(b + (row << log_n) + i)));
      if (b_add) {
        s += b_add;
        s -= s >= q ? q : 0;
      }
      out_b[row] = static_cast<long long>(s);
    }
  }
}

}  // namespace

extern "C" {

// a, b (batch, 2^log_n): int64 if wide, else int32; out_a (batch, 2^log_n)
// and out_b (batch,) int64; 0 <= i < 2^log_n; b_add < q.
int lft_rlwe_extract(const void* a, const void* b, void* out_a, void* out_b, int wide, int batch, int log_n, int i,
                     unsigned long long q, unsigned long long b_add, void* stream) {
  if (batch < 1 || log_n < 0 || log_n > 24 || i < 0 || i >= (1 << log_n) || (b_add && b_add >= q))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(batch) << log_n;
  const long long need = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < 65536 ? need : 65536);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide) {
    rlwe_extract_kernel<long long><<<blocks, kThreads, 0, st>>>(
        static_cast<const long long*>(a), static_cast<const long long*>(b), static_cast<long long*>(out_a),
        static_cast<long long*>(out_b), batch, log_n, i, q, b_add);
  } else {
    rlwe_extract_kernel<int><<<blocks, kThreads, 0, st>>>(
        static_cast<const int*>(a), static_cast<const int*>(b), static_cast<long long*>(out_a),
        static_cast<long long*>(out_b), batch, log_n, i, q, b_add);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
