"""The port's model stack: so far the SSM family's serving path (Mamba2)."""

from .model_api import Model, count_params, get_model  # noqa: F401
