"""Synthetic data pipelines (numpy): tokens, graphs, reachability
workloads."""
from .tokens import TokenPipeline  # noqa: F401
