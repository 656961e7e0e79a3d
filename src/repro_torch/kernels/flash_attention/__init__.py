"""Flash-attention forward (``repro/kernels/flash_attention``)."""
