"""Architecture configs the port runs: copies of the reference package's
jax-free config modules (``base.py`` and one file per architecture), so
shape names and sizes have one source of truth in each package."""
from .registry import ARCHS, get_config, get_smoke  # noqa: F401
