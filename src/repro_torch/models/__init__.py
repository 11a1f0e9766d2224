"""The port's model stack: the SSM family (Mamba2) and the Zamba2 hybrid,
served and trained."""

from .model_api import Model, count_params, get_model  # noqa: F401
