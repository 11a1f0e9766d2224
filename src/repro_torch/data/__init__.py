"""The token pipeline of the trainer: a copy of the JAX package's
``data/``."""

from .pipeline import DataConfig, TokenPipeline  # noqa: F401

__all__ = ["DataConfig", "TokenPipeline"]
