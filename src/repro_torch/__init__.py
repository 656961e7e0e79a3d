"""PyTorch/CUDA port of ``repro``: the paper's data-parallel training step
(gradient buckets, CommSchedule IR, funnel/concom/depcha embeddings) on
``torch.distributed``, with the bucket staging kernels written by hand for
Hopper (``repro_torch.kernels.collectives``).

The package mirrors ``repro``'s subpackage layout module for module and
imports neither ``jax`` nor ``repro``; the tests hold each module against
its ``repro`` counterpart on the same inputs.
"""
