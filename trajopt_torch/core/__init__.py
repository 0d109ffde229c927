"""Linearization, backward passes and the CUDA kernel wrappers of the port."""
