"""Mixtral-8x22B [moe]: 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf].  56L d_model=6144 48H (GQA kv=8) expert
d_ff=16384 vocab=32768, window=4096.
The dims are the JAX package's ``configs/mixtral_8x22b.py``, verbatim.
"""
import dataclasses

from .base import ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768, window=4096, fsdp=True,
    remat_groups=8, act_shard="", q_chunk=256,
    moe=MoECfg(n_experts=8, top_k=2),
)


def smoke() -> ModelCfg:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, window=32, q_chunk=16, loss_chunk=32,
        moe=MoECfg(n_experts=4, top_k=2),
    )
