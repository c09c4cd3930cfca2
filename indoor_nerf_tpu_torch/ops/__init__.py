"""Tensor ops of the serving path; the CUDA kernel wrappers live here."""
