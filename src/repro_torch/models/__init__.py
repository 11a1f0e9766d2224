"""The port's model stack: the SSM family (Mamba2), the Zamba2 hybrid, the
decoder-only transformers (dense, MoE, VLM) and the encoder-decoder,
served and trained."""

from .model_api import Model, batch_specs, count_params, get_model  # noqa: F401
