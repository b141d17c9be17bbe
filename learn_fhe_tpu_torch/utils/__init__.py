"""Host side: primes, samplers, numpy<->torch views, the CUDA kernel build."""
