"""Decoder-only transformer LM (dense, MoE, sliding-window attention, VLM
soft prefix): trained, prefilled and decoded.

A port of the JAX package's ``models/transformer.py``.  The reference
stacks the layers' leaves on a leading axis and scans them; here
:class:`LMModel` holds ``embed`` and ``layers``, an ``nn.ModuleList`` of
one :class:`~.layers.SpecModule` a layer (``ln1``, ``ln2``, ``attn``,
``ffn``), and the forward loops over the layers.  Under autograd with
``cfg.remat`` each layer runs under ``torch.utils.checkpoint``: the
reference's ``remat_groups`` two-level scan with whole-group remat
changes memory, not values.  The reference's sharding constraints are
in place (:func:`_constrain_act` on each layer's input and at each group
boundary of ``remat_groups``): under a mesh they resolve the layout by
the logical rules, and they change no value
(:func:`~repro_torch.parallel.sharding.constrain`).

The KV cache is the reference's stacked one (``k``, ``v`` (L, B, T, Hs,
D), ``positions`` (L, T), ``pos`` (L,)); each layer reads and writes its
slice in place, where the reference returns a new cache.
:func:`lm_init_cache` sizes it full-length by default (``ring=False``),
sliding-window archs too, as the reference's does: a window-sized ring
cannot take a whole prompt in one write.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import ParamSpec, constrain
from .layers import (
    INVALID_POS,
    SpecModule,
    attention_block,
    attention_param_specs,
    chunked_xent,
    embed_param_specs,
    embed_tokens,
    load_tree,
    mlp_block,
    mlp_param_specs,
    moe_block,
    moe_param_specs,
    rms_norm,
    unembed,
)

__all__ = [
    "LMModel",
    "stack_specs",
    "lm_param_specs",
    "lm_forward",
    "lm_loss",
    "lm_prefill",
    "lm_decode_step",
    "lm_cache_specs",
    "lm_init_cache",
]


def stack_specs(specs: Any, n: int) -> Any:
    """Add a leading 'layers' axis to every ParamSpec leaf."""
    if isinstance(specs, ParamSpec):
        return ParamSpec((n,) + specs.shape, specs.dtype,
                         ("layers",) + specs.axes)
    return {k: stack_specs(v, n) for k, v in specs.items()}


def _layer_specs(cfg) -> dict:
    return {
        "ln1": ParamSpec((cfg.d_model,), cfg.param_dtype, ("",)),
        "ln2": ParamSpec((cfg.d_model,), cfg.param_dtype, ("",)),
        "attn": attention_param_specs(cfg),
        "ffn": moe_param_specs(cfg) if cfg.moe is not None
        else mlp_param_specs(cfg),
    }


def lm_param_specs(cfg) -> dict:
    return {
        "embed": embed_param_specs(cfg),
        "layers": stack_specs(_layer_specs(cfg), cfg.n_layers),
    }


class LMModel(nn.Module):
    """The transformer's parameters: ``embed`` and ``layers``.  Made
    empty; :meth:`load_flat` fills them from the reference's tree.
    ``moe_routes``: None, or a list to which every MoE routing of a
    forward without autograd appends its routes
    (:func:`~.layers._moe_route`)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.moe_routes: list | None = None
        self.embed = SpecModule(embed_param_specs(cfg), device)
        self.layers = nn.ModuleList(
            [SpecModule(_layer_specs(cfg), device)
             for _ in range(cfg.n_layers)])

    def load_flat(self, leaves) -> "LMModel":
        return load_tree(self, leaves, lm_param_specs(self.cfg))


def _block(cfg, p, x, pos, cache, routes=None):
    h, _ = attention_block(
        cfg, p["attn"], rms_norm(x, p["ln1"]), pos,
        causal=True, window=cfg.window, cache=cache,
    )
    x = x + h
    ffn_in = rms_norm(x, p["ln2"])
    if cfg.moe is not None:
        return x + moe_block(cfg, p["ffn"], ffn_in, routes)
    return x + mlp_block(cfg, p["ffn"], ffn_in)


def _constrain_act(cfg, x):
    """Residual-stream sharding constraint (SP): 'seq' shards the sequence
    over 'model' (dense archs), 'dmodel' shards d_model (MoE archs, whose
    grouped dispatch reshapes away the seq axis)."""
    if cfg.act_shard == "seq":
        return constrain(x, ("batch", "sequence", ""))
    if cfg.act_shard == "dmodel":
        return constrain(x, ("batch", "", "tensor"))
    return constrain(x, ("batch", "", ""))


def _group_end(cfg, i: int) -> bool:
    """Whether layer ``i`` closes a group of the reference's two-level
    remat (``remat_groups`` dividing the depth), whose output it
    constrains: the tensor the outer remat saves."""
    g = cfg.remat_groups
    return (g > 1 and cfg.n_layers % g == 0
            and (i + 1) % (cfg.n_layers // g) == 0)


def _train_block(cfg, blk: SpecModule, x, pos):
    return _block(cfg, blk.tensors(), _constrain_act(cfg, x), pos, None)


def lm_forward(cfg, params: LMModel, tokens, pos, cache=None,
               prefix_embeds=None):
    """tokens: (B, S); pos: the first position.  ``prefix_embeds`` (B, F,
    D), a soft prefix (VLM patches), goes before the token embeddings.
    ``cache`` (from :func:`lm_init_cache`) is written in place, layer by
    layer.  Returns ``(x, cache)``, ``x`` after the final norm."""
    emb = params.embed.tensors()
    x = embed_tokens(cfg, emb, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    if cache is None and cfg.remat and torch.is_grad_enabled():
        for i, blk in enumerate(params.layers):
            x = checkpoint(_train_block, cfg, blk, x, pos, use_reentrant=False)
            if _group_end(cfg, i):
                x = _constrain_act(cfg, x)
    else:
        for i, blk in enumerate(params.layers):
            c_i = None if cache is None else {k: v[i] for k, v in cache.items()}
            x = _block(cfg, blk.tensors(), _constrain_act(cfg, x), pos, c_i,
                       params.moe_routes)
    return rms_norm(x, emb["final_norm"]), cache


def lm_loss(cfg, params: LMModel, batch):
    """batch: tokens (B,S), targets (B,S), mask (B,S) [+ prefix_embeds];
    the prefix's positions carry no loss."""
    prefix = batch.get("prefix_embeds")
    x, _ = lm_forward(cfg, params, batch["tokens"], 0, prefix_embeds=prefix)
    if prefix is not None:
        x = x[:, prefix.shape[1]:, :]
    return chunked_xent(cfg, params.embed.tensors(), x, batch["targets"],
                        batch["mask"])


def lm_cache_specs(cfg, batch: int, max_len: int, ring: bool = True) -> dict:
    """Stacked (layers-leading) KV cache specs.  ``ring=True``: sliding-
    window archs allocate only ``window`` slots (a decode-only cache);
    ``ring=False``: full length."""
    tc = min(max_len, cfg.window) if (cfg.window and ring) else max_len
    hs, hd = cfg.stored_kv_heads, cfg.head_dim
    cd = cfg.compute_dtype
    return {
        "k": ParamSpec((cfg.n_layers, batch, tc, hs, hd), cd,
                       ("layers", "batch", "", "tensor", "")),
        "v": ParamSpec((cfg.n_layers, batch, tc, hs, hd), cd,
                       ("layers", "batch", "", "tensor", "")),
        "positions": ParamSpec((cfg.n_layers, tc), torch.int32,
                               ("layers", "")),
        "pos": ParamSpec((cfg.n_layers,), torch.int32, ("layers",)),
    }


def lm_init_cache(cfg, batch: int, max_len: int, ring: bool = False,
                  device=None) -> dict:
    """Zeros, except the slots' positions: :data:`INVALID_POS`
    (unwritten)."""
    specs = lm_cache_specs(cfg, batch, max_len, ring=ring)
    c = {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
         for k, s in specs.items()}
    c["positions"].fill_(INVALID_POS)
    return c


def lm_prefill(cfg, params, tokens, cache, prefix_embeds=None):
    """Run the whole prompt (after its prefix), writing the KV caches.
    Returns (last position's logits, cache)."""
    x, cache = lm_forward(cfg, params, tokens, 0, cache=cache,
                          prefix_embeds=prefix_embeds)
    return unembed(cfg, params.embed.tensors(), x[:, -1:, :]), cache


def lm_decode_step(cfg, params, cache, token, pos):
    """One token for the whole batch.  token: (B, 1); pos: its position."""
    x, cache = lm_forward(cfg, params, token, pos, cache=cache)
    return unembed(cfg, params.embed.tensors(), x), cache
