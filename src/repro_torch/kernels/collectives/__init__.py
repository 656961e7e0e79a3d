"""Fused bucket staging: CUDA kernels (kernel.py), plain versions (ref.py)
and the public API (ops.py)."""
