"""Checkpoints of the trainer, in the JAX package's on-disk format."""

from .checkpointer import CheckpointConfig, Checkpointer  # noqa: F401

__all__ = ["CheckpointConfig", "Checkpointer"]
