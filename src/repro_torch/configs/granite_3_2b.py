"""Granite-3.0-2B [dense]: GQA kv=8.

[hf:ibm-granite/granite-3.0-2b-base].  40L d_model=2048 32H (kv=8)
d_ff=8192 vocab=49155.
The dims are the JAX package's ``configs/granite_3_2b.py``, verbatim.
"""
import dataclasses

from .base import ModelCfg

CONFIG = ModelCfg(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=49155, fsdp=True,
    remat_groups=5, act_shard="seq",
)


def smoke() -> ModelCfg:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, q_chunk=16, loss_chunk=32,
    )
