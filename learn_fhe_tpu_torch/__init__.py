"""learn-fhe-tpu-torch: the PyTorch + CUDA port of `learn_fhe_tpu`.

Same layout and names as the JAX package, which stays the reference:
  utils/    -- host side: primes, samplers, numpy<->torch views, kernel build
  ops/      -- modular arithmetic, NTT, gadget decomposition, CRT torus products
  models/   -- the schemes (so far tfhe/: the programmable bootstrap; fhew/:
               gates, multi-key / threshold keys, encrypted bool and u8)
  parallel/ -- batched bootstrap pipelines
  examples/ -- the port of `examples/multi_key_uint8.py`
  csrc/     -- hand-written CUDA kernels for Hopper (sm_90a), built at first use

Torus values and residues mod primes up to 2^63 (u64) are carried as int64
bit patterns, residues mod the 31-bit primes as int32. Every kernel wrapper runs its plain PyTorch version
for CPU tensors and the kernel for CUDA tensors, and raises rather than fall
back. Nothing here imports JAX.
"""

__version__ = "0.1.0"
