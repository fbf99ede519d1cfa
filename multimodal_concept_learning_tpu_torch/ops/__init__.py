"""Attention, paged KV cache and sampling ops, and the CUDA kernels' wrappers."""
