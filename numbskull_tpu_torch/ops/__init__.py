"""Compute ops on torch tensors: factor evaluation, sampler state, and
the fused itemgrid sweep (CUDA kernel plus its plain version)."""
