"""Snowflake Arctic 480B [moe]: 128 experts top-2 + dense residual.

[hf:Snowflake/snowflake-arctic-base].  35L d_model=7168 56H (GQA kv=8)
expert d_ff=4864 vocab=32000.  56 heads % 16 TP != 0 — the q-head axis is
group-padded 56→64 (paper §6 padding on the mesh axis; see
ModelCfg.padded_heads).
The dims are the JAX package's ``configs/arctic_480b.py``, verbatim.
"""
import dataclasses

import torch

from .base import ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, fsdp=True,
    remat_groups=7, act_shard="dmodel", q_chunk=256,
    param_dtype=torch.bfloat16,
    moe=MoECfg(n_experts=128, top_k=2, dense_residual=True),
)


def smoke() -> ModelCfg:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=7, n_kv_heads=1,
        d_ff=128, vocab=256, q_chunk=16, loss_chunk=32,
        moe=MoECfg(n_experts=8, top_k=2, dense_residual=True),
    )
