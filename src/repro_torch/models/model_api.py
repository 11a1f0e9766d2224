"""Unified model protocol, as in the JAX package:

    specs   = model.param_specs()                 # ParamSpec tree
    params  = model.init(seed)                    # the family's nn.Module
    loss    = model.loss(params, batch)           # scalar, differentiable
    logits, cache = model.prefill(params, batch, cache)
    logits, cache = model.decode_step(params, cache, token, pos)

plus ``cache_specs`` / ``init_cache``, and :func:`batch_specs` for the
dry-run's inputs.  ``params`` is the family's module
(:class:`~repro_torch.models.ssm.SSMModel`,
:class:`~repro_torch.models.transformer.LMModel`,
:class:`~repro_torch.models.encdec.EncDecModel`) where the reference
passes a dict tree.  The model runs on ``device``: ``None`` means the
card, and ``"cpu"`` runs the kernels' plain versions (the tests);
without CUDA and without ``device="cpu"``, :func:`get_model` raises.
Parameters are trainable: ``loss`` runs under autograd; prefill and
decode run under ``torch.inference_mode()`` and update the cache in
place.

Families: ``ssm`` and ``hybrid`` (Mamba2, Zamba2) through
:mod:`~repro_torch.models.ssm`; ``dense``, ``moe``, ``vlm`` and
``hybrid-attn`` through :mod:`~repro_torch.models.transformer` (a VLM's
batch may carry ``prefix_embeds``); ``encdec`` through
:mod:`~repro_torch.models.encdec` (its batch carries ``frames``).
"""

from __future__ import annotations

from dataclasses import dataclass
from math import prod
from typing import Any, Callable, NamedTuple

import torch

from .. import resolve_device
from ..configs.base import ModelCfg, ShapeCfg
from ..parallel.sharding import ParamSpec
from . import encdec, ssm, transformer
from .layers import flatten_tree, init_params_

__all__ = ["Model", "get_model", "count_params", "family", "batch_specs"]


class Family(NamedTuple):
    specs: Callable          # cfg -> spec tree
    module: type             # (cfg, device) -> the parameters' nn.Module
    loss: Callable           # (cfg, params, batch) -> loss
    prefill: Callable        # (cfg, params, batch, cache) -> (logits, cache)
    decode: Callable         # (cfg, params, cache, token, pos)
    cache_specs: Callable    # (cfg, batch, max_len, ring) -> spec tree
    init_cache: Callable     # (cfg, batch, max_len, device) -> cache


def _ssm_prefill(cfg, params, batch, cache):
    return ssm.ssm_prefill(cfg, params, batch["tokens"], cache)


def _lm_prefill(cfg, params, batch, cache):
    return transformer.lm_prefill(cfg, params, batch["tokens"], cache,
                                  prefix_embeds=batch.get("prefix_embeds"))


_SSM = Family(ssm.ssm_param_specs, ssm.SSMModel, ssm.ssm_loss, _ssm_prefill,
              ssm.ssm_decode_step,
              lambda cfg, b, n, ring: ssm.ssm_cache_specs(cfg, b, n),
              ssm.ssm_init_cache)
_LM = Family(
    transformer.lm_param_specs, transformer.LMModel, transformer.lm_loss,
    _lm_prefill, transformer.lm_decode_step, transformer.lm_cache_specs,
    lambda cfg, b, n, device: transformer.lm_init_cache(cfg, b, n,
                                                        device=device),
)
_ENCDEC = Family(
    encdec.encdec_param_specs, encdec.EncDecModel, encdec.encdec_loss,
    encdec.encdec_prefill, encdec.encdec_decode_step,
    lambda cfg, b, n, ring: encdec.encdec_cache_specs(cfg, b, n),
    encdec.encdec_init_cache,
)
_FAMILIES = {"ssm": _SSM, "hybrid": _SSM, "dense": _LM, "moe": _LM,
             "vlm": _LM, "hybrid-attn": _LM, "encdec": _ENCDEC}


def family(cfg: ModelCfg) -> Family:
    """The functions and module class of ``cfg``'s family."""
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family}") from None


# Batch entries that are embeddings (the VLM prefix, the audio frames):
# carried to the device in the compute dtype.
_EMBEDDINGS = ("prefix_embeds", "frames")


@dataclass
class Model:
    cfg: ModelCfg
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.fam = family(self.cfg)

    def param_specs(self):
        return self.fam.specs(self.cfg)

    def init(self, seed: int = 0) -> torch.nn.Module:
        """Parameters drawn from a ``torch.Generator`` seeded with ``seed``
        on the model's device, by the reference's ``init_from_specs`` rule
        (ones on 1-D leaves of its stacked tree, N(0, 0.02²) elsewhere),
        in pieces into place (:func:`~.layers.init_params_`).  On
        ``meta`` (shapes only) there is nothing to draw and no generator."""
        gen = None
        if self.device.type != "meta":
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        model = self.fam.module(self.cfg, device=self.device)
        return init_params_(model, self.param_specs(), gen)

    def _batch(self, batch) -> dict:
        """``batch``'s tensors or numpy arrays on the model's device:
        token ids as int64, embeddings in the compute dtype."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v).to(self.device)
            if k in ("tokens", "targets"):
                t = t.long()
            elif k in _EMBEDDINGS:
                t = t.to(self.cfg.compute_dtype)
            out[k] = t
        return out

    def loss(self, params, batch):
        """The training loss of ``batch`` (``tokens``, ``targets``,
        ``mask``, and ``prefix_embeds`` or ``frames`` where the family
        takes them)."""
        return self.fam.loss(self.cfg, params, self._batch(batch))

    def prefill(self, params, batch, cache):
        with torch.inference_mode():
            return self.fam.prefill(self.cfg, params, self._batch(batch),
                                    cache)

    def decode_step(self, params, cache, token, pos):
        with torch.inference_mode():
            token = torch.as_tensor(token).to(self.device)
            return self.fam.decode(self.cfg, params, cache, token, pos)

    def cache_specs(self, batch: int, max_len: int, ring: bool = False):
        """The serving cache's spec tree.  ``ring=True`` gives a
        sliding-window arch a window-sized ring (the reference's decode
        cache); the default is the full-length cache that
        :meth:`init_cache` allocates."""
        return self.fam.cache_specs(self.cfg, batch, max_len, ring)

    def init_cache(self, batch: int, max_len: int):
        return self.fam.init_cache(self.cfg, batch, max_len,
                                   device=self.device)


def get_model(cfg: ModelCfg, device=None) -> Model:
    """The model of ``cfg``'s family on ``device`` (``None``: the card;
    raises without CUDA unless ``device="cpu"``)."""
    return Model(cfg, device)


def count_params(cfg: ModelCfg, active_only: bool = False) -> int:
    """Total parameters N (raw dims); the hybrid's shared block counts
    once, however many times it is applied.  ``active_only`` counts the
    expert weights (``w1``, ``w2``, ``w3``) at ``top_k / n_experts``, as
    the reference does; arctic's dense residual MLP counts in full."""
    leaves = flatten_tree(family(cfg).specs(cfg))
    total = sum(prod(s.shape) for _, s in leaves)
    if active_only and cfg.moe is not None:
        expert = sum(prod(s.shape) for path, s in leaves
                     if path.rsplit(".", 1)[-1] in ("w1", "w2", "w3"))
        total = total - expert + expert * cfg.moe.top_k // cfg.moe.n_experts
    return int(total)


# ---------------------------------------------------------------------------
# Batch specs per (arch × shape) — the dry-run inputs.
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelCfg, shape: ShapeCfg) -> dict:
    """ParamSpec tree for the input batch of a given shape config, the
    reference's: train/prefill a full (B, S) token batch (a VLM's tokens
    after its ``frontend_len`` prefix embeddings, an encoder-decoder's
    with its ``frames``), prefill without ``targets`` and ``mask``;
    decode one token a sequence and the position."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        n = s - cfg.frontend_len if cfg.family == "vlm" else s
        batch = {
            "tokens": ParamSpec((b, n), i32, ("batch", "")),
            "targets": ParamSpec((b, n), i32, ("batch", "")),
            "mask": ParamSpec((b, n), torch.float32, ("batch", "")),
        }
        extra = {"vlm": "prefix_embeds", "encdec": "frames"}.get(cfg.family)
        if extra:
            batch[extra] = ParamSpec((b, cfg.frontend_len, cfg.d_model),
                                     cfg.compute_dtype, ("batch", "", ""))
        if shape.kind == "prefill":
            batch.pop("targets")
            batch.pop("mask")
        return batch
    # decode: one new token against a seq_len-deep cache
    return {
        "token": ParamSpec((b, 1), i32, ("batch", "")),
        "pos": ParamSpec((), i32, ()),
    }
