"""InternLM2-20B [dense]: GQA kv=8.

[arXiv:2403.17297; hf].  48L d_model=6144 48H (kv=8) d_ff=16384
vocab=92544.
The dims are the JAX package's ``configs/internlm2_20b.py``, verbatim.
"""
import dataclasses

from .base import ModelCfg

CONFIG = ModelCfg(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92544, fsdp=True,
    remat_groups=8, act_shard="dmodel", q_chunk=256,
)


def smoke() -> ModelCfg:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, q_chunk=16, loss_chunk=32,
    )
