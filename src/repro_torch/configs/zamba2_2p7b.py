"""Zamba2-2.7B [hybrid]: Mamba2 backbone + shared attention block.

[arXiv:2411.15242; hf].  54 Mamba2 layers, d_model=2560, shared
attn+MLP block (32H, d_ff=10240) applied every 6 layers, vocab=32000,
ssm_state=64.  Simplification: shared block applied to the hidden state
directly (no concat-with-embedding / per-use LoRA).  The dims are the JAX
package's ``configs/zamba2_2p7b.py``, verbatim.
"""
import dataclasses

from .base import ModelCfg, SSMCfg

CONFIG = ModelCfg(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, attn_every=6, fsdp=True, remat_groups=6, act_shard="seq",
    ssm=SSMCfg(state=64, head_dim=64, expand=2, conv_width=4, chunk=128),
)


def smoke() -> ModelCfg:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, attn_every=2, q_chunk=16, loss_chunk=32,
        ssm=SSMCfg(state=16, head_dim=16, expand=2, conv_width=4, chunk=16),
    )
