"""Qwen1.5-32B [dense]: QKV bias, MHA-ish GQA kv=40.

[hf:Qwen/Qwen1.5-0.5B family].  64L d_model=5120 40H (kv=40)
d_ff=27392 vocab=152064.
The dims are the JAX package's ``configs/qwen1p5_32b.py``, verbatim.
"""
import dataclasses

from .base import ModelCfg

CONFIG = ModelCfg(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab=152064, qkv_bias=True, fsdp=True,
    remat_groups=8, act_shard="dmodel", q_chunk=256,
)


def smoke() -> ModelCfg:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, q_chunk=16, loss_chunk=32,
    )
