"""Synthetic data pipelines (numpy)."""
from .tokens import TokenPipeline  # noqa: F401
