"""InternVL2-2B [vlm]: InternViT frontend (stub) + InternLM2-1.8B backbone.

[arXiv:2404.16821; hf].  24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553.  The vision tower is a STUB: input_specs feeds precomputed
patch embeddings (B, 256, d_model).
The dims are the JAX package's ``configs/internvl2_2b.py``, verbatim.
"""
import dataclasses

from .base import ModelCfg

CONFIG = ModelCfg(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553, frontend_len=256, fsdp=True,
    remat_groups=4, act_shard="seq",
)


def smoke() -> ModelCfg:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, frontend_len=8, q_chunk=16, loss_chunk=32,
    )
