"""Whisper-large-v3 [audio]: encoder-decoder, conv frontend stubbed.

[arXiv:2212.04356].  32L enc + 32L dec, d_model=1280, 20H MHA (kv=20),
d_ff=5120, vocab=51866, 1500 audio frames.  QKV bias per the released
model; RoPE replaces learned positions (DESIGN.md deviation note).
The dims are the JAX package's ``configs/whisper_large_v3.py``, verbatim.
"""
import dataclasses

from .base import ModelCfg

CONFIG = ModelCfg(
    name="whisper-large-v3", family="encdec",
    n_layers=32, enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, frontend_len=1500, qkv_bias=True, fsdp=True,
    remat_groups=4, act_shard="seq",
)


def smoke() -> ModelCfg:
    return dataclasses.replace(
        CONFIG, n_layers=2, enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, frontend_len=12,
        q_chunk=16, loss_chunk=32,
    )
