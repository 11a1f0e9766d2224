"""The trainer's optimizer: AdamW as plain functions on tensors, and int8
gradient compression with error feedback (the JAX package's ``optim/``)."""

from .compression import CompressionState, compressed_mean  # noqa: F401
from .optimizer import (  # noqa: F401
    OptConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    decay_mask,
    global_norm,
    opt_state_specs,
)

__all__ = [
    "CompressionState",
    "OptConfig",
    "adamw_init",
    "adamw_update",
    "compressed_mean",
    "cosine_schedule",
    "decay_mask",
    "global_norm",
    "opt_state_specs",
]
