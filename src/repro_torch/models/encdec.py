"""Encoder-decoder transformer (Whisper-family backbone): trained,
prefilled and decoded.

A port of the JAX package's ``models/encdec.py``.  The conv/mel frontend
is a stub there and here: the batch carries precomputed frame embeddings
``frames`` (B, frontend_len, d_model).  As in the reference, rope replaces
Whisper's learned positions; the MLPs are ungated with the tanh gelu
(:func:`~.layers.gelu`, ``jax.nn.gelu``'s default).

:class:`EncDecModel` holds ``embed``, ``enc_layers`` and ``dec_layers``
(``nn.ModuleList``s of one :class:`~.layers.SpecModule` a layer) and
``enc_norm``; the reference stacks each group's leaves (L, ...).  Under
autograd with ``cfg.remat`` each layer runs under
``torch.utils.checkpoint``.  The serving cache is the reference's
(``self``: a full-length KV cache a decoder layer; ``cross``: each
layer's keys and values of the encoder output), written in place.  The
reference's sharding constraint on each layer's input is in place and
changes no value.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import ParamSpec
from .layers import (
    INVALID_POS,
    SpecModule,
    attention_block,
    attention_param_specs,
    chunked_xent,
    embed_param_specs,
    embed_tokens,
    gelu,
    load_tree,
    mlp_block,
    mlp_param_specs,
    rms_norm,
    to_stored_kv,
    unembed,
)
from .transformer import _constrain_act, stack_specs

__all__ = [
    "EncDecModel",
    "encdec_param_specs",
    "encode",
    "decode_stack",
    "encdec_loss",
    "encdec_prefill",
    "encdec_decode_step",
    "encdec_cache_specs",
    "encdec_init_cache",
]


def _enc_layer_specs(cfg) -> dict:
    return {
        "ln1": ParamSpec((cfg.d_model,), cfg.param_dtype, ("",)),
        "ln2": ParamSpec((cfg.d_model,), cfg.param_dtype, ("",)),
        "attn": attention_param_specs(cfg),
        "ffn": mlp_param_specs(cfg, gated=False),
    }


def _dec_layer_specs(cfg) -> dict:
    return {
        "ln1": ParamSpec((cfg.d_model,), cfg.param_dtype, ("",)),
        "lnx": ParamSpec((cfg.d_model,), cfg.param_dtype, ("",)),
        "ln2": ParamSpec((cfg.d_model,), cfg.param_dtype, ("",)),
        "self_attn": attention_param_specs(cfg),
        "cross_attn": attention_param_specs(cfg),
        "ffn": mlp_param_specs(cfg, gated=False),
    }


def encdec_param_specs(cfg) -> dict:
    return {
        "embed": embed_param_specs(cfg),
        "enc_layers": stack_specs(_enc_layer_specs(cfg), cfg.enc_layers),
        "enc_norm": ParamSpec((cfg.d_model,), cfg.param_dtype, ("",)),
        "dec_layers": stack_specs(_dec_layer_specs(cfg), cfg.n_layers),
    }


class EncDecModel(nn.Module):
    """The encoder-decoder's parameters.  Made empty; :meth:`load_flat`
    fills them from the reference's tree."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = SpecModule(embed_param_specs(cfg), device)
        self.enc_layers = nn.ModuleList(
            [SpecModule(_enc_layer_specs(cfg), device)
             for _ in range(cfg.enc_layers)])
        self.enc_norm = nn.Parameter(torch.empty(
            (cfg.d_model,), dtype=cfg.param_dtype, device=device))
        self.dec_layers = nn.ModuleList(
            [SpecModule(_dec_layer_specs(cfg), device)
             for _ in range(cfg.n_layers)])

    def load_flat(self, leaves) -> "EncDecModel":
        return load_tree(self, leaves, encdec_param_specs(self.cfg))


def _remat(cfg) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def _enc_block(cfg, blk: SpecModule, x):
    p = blk.tensors()
    x = _constrain_act(cfg, x)
    h, _ = attention_block(cfg, p["attn"], rms_norm(x, p["ln1"]), 0,
                           causal=False, use_rope=True)
    y = x + h
    return y + mlp_block(cfg, p["ffn"], rms_norm(y, p["ln2"]), act=gelu)


def encode(cfg, params: EncDecModel, frames):
    """frames: (B, F, D) precomputed frame embeddings (the frontend
    stub).  Non-causal self-attention with rope, the gelu MLP, then
    ``enc_norm``."""
    x = frames.to(cfg.compute_dtype)
    for blk in params.enc_layers:
        x = (checkpoint(_enc_block, cfg, blk, x, use_reentrant=False)
             if _remat(cfg) else _enc_block(cfg, blk, x))
    return rms_norm(x, params.enc_norm)


def _dec_block(cfg, p, x, pos, enc_out, self_cache, cross_cache):
    x = _constrain_act(cfg, x)
    h, _ = attention_block(
        cfg, p["self_attn"], rms_norm(x, p["ln1"]), pos,
        causal=True, cache=self_cache,
    )
    x = x + h
    h, _ = attention_block(
        cfg, p["cross_attn"], rms_norm(x, p["lnx"]), pos,
        causal=False, cache=cross_cache, x_kv=enc_out, cross=True,
    )
    x = x + h
    return x + mlp_block(cfg, p["ffn"], rms_norm(x, p["ln2"]), act=gelu)


def _train_dec_block(cfg, blk: SpecModule, x, pos, enc_out):
    return _dec_block(cfg, blk.tensors(), x, pos, enc_out, None, None)


def decode_stack(cfg, params: EncDecModel, tokens, pos, enc_out=None,
                 cache=None):
    """The decoder over ``tokens`` from position ``pos``: cross-attention
    to ``enc_out``, or (``enc_out`` None) to the cache's precomputed
    ``cross`` keys and values; ``cache['self']`` is written in place.
    Returns ``(x, cache)``, ``x`` after the final norm."""
    x = embed_tokens(cfg, params.embed.tensors(), tokens)
    if cache is None and _remat(cfg):
        for blk in params.dec_layers:
            x = checkpoint(_train_dec_block, cfg, blk, x, pos, enc_out,
                           use_reentrant=False)
    else:
        for i, blk in enumerate(params.dec_layers):
            sc = cc = None
            if cache is not None:
                sc = {k: v[i] for k, v in cache["self"].items()}
                cc = {k: v[i] for k, v in cache["cross"].items()}
            x = _dec_block(cfg, blk.tensors(), x, pos, enc_out, sc, cc)
    return rms_norm(x, params.embed.final_norm), cache


def encdec_loss(cfg, params: EncDecModel, batch):
    """batch: frames (B, F, D), tokens, targets, mask (B, S)."""
    enc_out = encode(cfg, params, batch["frames"])
    x, _ = decode_stack(cfg, params, batch["tokens"], 0, enc_out)
    return chunked_xent(cfg, params.embed.tensors(), x, batch["targets"],
                        batch["mask"])


def encdec_cache_specs(cfg, batch: int, max_len: int) -> dict:
    hs, hd = cfg.stored_kv_heads, cfg.head_dim
    cd = cfg.compute_dtype
    L, F = cfg.n_layers, cfg.frontend_len
    return {
        "self": {
            "k": ParamSpec((L, batch, max_len, hs, hd), cd,
                           ("layers", "batch", "", "tensor", "")),
            "v": ParamSpec((L, batch, max_len, hs, hd), cd,
                           ("layers", "batch", "", "tensor", "")),
            "positions": ParamSpec((L, max_len), torch.int32,
                                   ("layers", "")),
            "pos": ParamSpec((L,), torch.int32, ("layers",)),
        },
        "cross": {
            "k": ParamSpec((L, batch, F, hs, hd), cd,
                           ("layers", "batch", "", "tensor", "")),
            "v": ParamSpec((L, batch, F, hs, hd), cd,
                           ("layers", "batch", "", "tensor", "")),
        },
    }


def encdec_init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """Zeros, except the self caches' positions: :data:`INVALID_POS`."""
    cache = {
        part: {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
               for k, s in specs.items()}
        for part, specs in encdec_cache_specs(cfg, batch, max_len).items()
    }
    cache["self"]["positions"].fill_(INVALID_POS)
    return cache


def _precompute_cross_kv(cfg, params: EncDecModel, enc_out, cross: dict):
    """Each decoder layer's cross-attention keys and values of
    ``enc_out``, written into ``cross`` (``k``, ``v`` (L, B, F, Hs, D))."""
    cdt = cfg.compute_dtype
    for i, blk in enumerate(params.dec_layers):
        p = blk.cross_attn.tensors()
        k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(cdt))
        v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(cdt))
        if "bk" in p:
            k = k + p["bk"].to(cdt)
            v = v + p["bv"].to(cdt)
        cross["k"][i].copy_(to_stored_kv(k, cfg))
        cross["v"][i].copy_(to_stored_kv(v, cfg))


def encdec_prefill(cfg, params, batch, cache):
    """batch: frames + prompt tokens.  Encodes, caches the cross keys and
    values, runs the decoder over the prompt through the self cache.
    Returns (last position's logits, cache)."""
    enc_out = encode(cfg, params, batch["frames"])
    _precompute_cross_kv(cfg, params, enc_out, cache["cross"])
    del enc_out
    x, cache = decode_stack(cfg, params, batch["tokens"], 0, cache=cache)
    return unembed(cfg, params.embed.tensors(), x[:, -1:, :]), cache


def encdec_decode_step(cfg, params, cache, token, pos):
    x, cache = decode_stack(cfg, params, token, pos, cache=cache)
    return unembed(cfg, params.embed.tensors(), x), cache
