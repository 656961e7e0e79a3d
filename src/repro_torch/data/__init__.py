"""Deterministic synthetic data pipelines."""
from repro_torch.data.pipeline import ImagePipeline

__all__ = ["ImagePipeline"]
