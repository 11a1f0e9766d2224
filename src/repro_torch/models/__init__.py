"""The port's model stack: so far the SSM family (Mamba2), served and
trained."""

from .model_api import Model, count_params, get_model  # noqa: F401
