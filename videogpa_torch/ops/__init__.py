"""Compute primitives: layers, RoPE and attention (with its CUDA kernel)."""
