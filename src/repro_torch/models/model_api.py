"""Unified model protocol, as in the JAX package:

    specs   = model.param_specs()                 # ParamSpec tree
    params  = model.init(seed)                    # the family's nn.Module
    loss    = model.loss(params, batch)           # scalar, differentiable
    logits, cache = model.prefill(params, batch, cache)
    logits, cache = model.decode_step(params, cache, token, pos)

plus ``cache_specs`` / ``init_cache``.  ``params`` is the family's module
(:class:`~repro_torch.models.ssm.SSMModel`) where the reference passes a
dict tree.  The model runs on ``device``: ``None`` means the card, and
``"cpu"`` runs the kernels' plain versions (the tests); without CUDA and
without ``device="cpu"``, ``init``, ``init_cache``, ``loss``, ``prefill``
and ``decode_step`` raise.  Parameters are trainable: ``loss`` runs under
autograd; prefill and decode run under ``torch.inference_mode()`` and
update the cache in place.

The SSM family and the Zamba2 hybrid (``ssm`` and ``hybrid``) run
through :mod:`~repro_torch.models.ssm`; the transformer families raise
``NotImplementedError`` naming their ``ROADMAP.md`` item.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import prod
from typing import Any

import torch

from .. import resolve_device
from ..configs.base import ModelCfg
from . import ssm
from .layers import flatten_tree, iter_init

__all__ = ["Model", "get_model", "count_params"]

_LATER = {f: "item 7c (the transformer families)"
          for f in ("dense", "moe", "vlm", "hybrid-attn", "encdec")}


@dataclass
class Model:
    cfg: ModelCfg
    device: Any = None

    def _dev(self) -> torch.device:
        return resolve_device(self.device)

    def param_specs(self):
        return ssm.ssm_param_specs(self.cfg)

    def init(self, seed: int = 0) -> ssm.SSMModel:
        """Parameters drawn from a ``torch.Generator`` seeded with ``seed``
        on the model's device, as the reference's ``init_from_specs`` lays
        them out (ones on 1-D leaves, N(0, 0.02²) elsewhere)."""
        dev = self._dev()
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model = ssm.SSMModel(self.cfg, device=dev)
        return model.load_flat(iter_init(self.param_specs(), gen))

    def loss(self, params, batch):
        """The training loss of ``batch`` (``tokens``, ``targets``,
        ``mask``: tensors or numpy arrays, moved to the model's device)."""
        dev = self._dev()
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        for k in ("tokens", "targets"):
            b[k] = b[k].long()
        return ssm.ssm_loss(self.cfg, params, b)

    def prefill(self, params, batch, cache):
        dev = self._dev()
        with torch.inference_mode():
            tokens = torch.as_tensor(batch["tokens"]).to(dev)
            return ssm.ssm_prefill(self.cfg, params, tokens, cache)

    def decode_step(self, params, cache, token, pos):
        dev = self._dev()
        with torch.inference_mode():
            token = torch.as_tensor(token).to(dev)
            return ssm.ssm_decode_step(self.cfg, params, cache, token, pos)

    def cache_specs(self, batch: int, max_len: int):
        return ssm.ssm_cache_specs(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int):
        return ssm.ssm_init_cache(self.cfg, batch, max_len, device=self._dev())


def get_model(cfg: ModelCfg, device=None) -> Model:
    fam = cfg.family
    if fam in _LATER:
        raise NotImplementedError(
            f"the {fam} family is not in the port yet: ROADMAP.md queue A, "
            f"{_LATER[fam]}"
        )
    if fam not in ("ssm", "hybrid"):
        raise ValueError(f"unknown family {fam}")
    return Model(cfg, device)


def count_params(cfg: ModelCfg, active_only: bool = False) -> int:
    """Total parameters N (raw dims); the hybrid's shared block counts
    once, however many times it is applied.  Neither family has experts,
    so ``active_only`` counts the same."""
    specs = get_model(cfg).param_specs()
    return int(sum(prod(s.shape) for _, s in flatten_tree(specs)))
