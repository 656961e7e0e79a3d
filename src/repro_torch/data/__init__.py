"""Deterministic synthetic data pipelines."""
from repro_torch.data.pipeline import ImagePipeline, TokenPipeline

__all__ = ["ImagePipeline", "TokenPipeline"]
