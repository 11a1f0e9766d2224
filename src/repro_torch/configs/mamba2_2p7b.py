"""Mamba2-2.7B [ssm]: attention-free SSD (state-space duality).

[arXiv:2405.21060].  64L d_model=2560, d_inner=5120 (expand 2),
ssm_state=128, head_dim=64 (80 SSD heads), vocab=50280.  The dims are
the JAX package's ``configs/mamba2_2p7b.py``, verbatim.
"""
import dataclasses

from .base import ModelCfg, SSMCfg

CONFIG = ModelCfg(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, fsdp=True, head_dim=1, remat_groups=8, act_shard="seq",
    ssm=SSMCfg(state=128, head_dim=64, expand=2, conv_width=4, chunk=128),
)


def smoke() -> ModelCfg:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, vocab=256, q_chunk=16, loss_chunk=32,
        ssm=SSMCfg(state=16, head_dim=16, expand=2, conv_width=4, chunk=16),
    )
