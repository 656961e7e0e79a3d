"""RWKV-6 WKV chunk (``repro/kernels/rwkv6``)."""
