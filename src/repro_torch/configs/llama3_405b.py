"""Llama-3.1-405B [dense]: the FSDP+TP showcase.

[arXiv:2407.21783].  126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256, rope_theta=500000, untied embeddings.
The dims are the JAX package's ``configs/llama3_405b.py``, verbatim.
"""
import dataclasses

import torch

from .base import ModelCfg

CONFIG = ModelCfg(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab=128256, rope_theta=5e5, tie_embeddings=False,
    fsdp=True, remat_groups=9, act_shard="dmodel", q_chunk=256,
    param_dtype=torch.bfloat16,
)


def smoke() -> ModelCfg:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=128, vocab=256, q_chunk=16, loss_chunk=32,
    )
