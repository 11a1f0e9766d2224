"""Model building blocks the SSM family serves with: norms, the token
embedding and unembedding, and parameter init from spec trees.

The part of the JAX package's ``models/layers.py`` that Mamba2 reaches,
with the same names and numerics: norms in f32, stored in the input's
dtype; the embedding and the logits in the compute dtype.  Attention,
MLP, MoE and the chunked cross-entropy come with the families that use
them (``ROADMAP.md`` queue A, items 7a-7c).

Every block is a function of ``(cfg, p, x, ...)`` with ``p`` a mapping
from the reference's leaf names to tensors.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from ..parallel.sharding import ParamSpec

__all__ = [
    "silu",
    "rms_norm",
    "gated_rms_norm",
    "embed_param_specs",
    "embed_tokens",
    "unembed",
    "flatten_tree",
    "init_from_specs",
    "iter_init",
]


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` in x's dtype, the form of ``jax.nn.silu``."""
    return x * torch.sigmoid(x)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def gated_rms_norm(x, z, w, eps: float = 1e-6):
    """Mamba2's RMSNormGated: norm(x * silu(z))."""
    return rms_norm(x * silu(z.float()).to(x.dtype), w, eps)


def embed_param_specs(cfg) -> dict[str, ParamSpec]:
    pd = cfg.param_dtype
    specs = {
        "embedding": ParamSpec(
            (cfg.vocab_padded, cfg.d_model), pd, ("tensor", "fsdp")
        ),
        "final_norm": ParamSpec((cfg.d_model,), pd, ("",)),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec(
            (cfg.d_model, cfg.vocab_padded), pd, ("fsdp", "tensor")
        )
    return specs


def embed_tokens(cfg, p: Mapping[str, torch.Tensor], tokens: torch.Tensor):
    """Token embedding in the compute dtype.  The reference looks up
    multi-token inputs as a one-hot matmul (for its gradient); each row of
    that product is 1·row + 0·others, which equals the table row exactly,
    so the port gathers for every length."""
    table = p["embedding"].to(cfg.compute_dtype)
    return table[tokens]


def unembed(cfg, p: Mapping[str, torch.Tensor], x: torch.Tensor):
    """Logits in the compute dtype, over the padded vocabulary."""
    cdt = cfg.compute_dtype
    if cfg.tie_embeddings:
        w = p["embedding"].to(cdt).T
    else:
        w = p["lm_head"].to(cdt)
    return torch.matmul(x, w)


def flatten_tree(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(dotted path, leaf)`` for every leaf of a tree of dicts (a spec
    tree, or the reference's parameters), in the order ``jax.tree.flatten``
    visits it (keys sorted)."""
    if not isinstance(tree, Mapping):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += flatten_tree(tree[k], f"{prefix}.{k}" if prefix else k)
    return out


def iter_init(specs, generator: torch.Generator, scale: float = 0.02,
              device=None):
    """``(dotted path, tensor)`` leaf by leaf, the values of
    :func:`init_from_specs`; a caller that stores each leaf as it comes
    holds one leaf's draw at a time."""
    device = generator.device if device is None else torch.device(device)
    for path, spec in flatten_tree(specs):
        if len(spec.shape) <= 1 or spec.shape[-1] == 1:
            yield path, torch.ones(spec.shape, dtype=spec.dtype, device=device)
        else:
            v = torch.randn(spec.shape, generator=generator,
                            dtype=torch.float32, device=device)
            yield path, v.mul_(scale).to(spec.dtype)


def init_from_specs(specs, generator: torch.Generator, scale: float = 0.02,
                    device=None) -> dict[str, torch.Tensor]:
    """``{dotted path: tensor}`` for a spec tree: ones for 1-D leaves (and
    leaves whose last dim is 1), else ``N(0, 1)·scale`` drawn in f32 from
    ``generator`` leaf by leaf in flatten order and cast to the leaf's
    dtype — the reference's ``init_from_specs``.  A torch generator draws
    other numbers than a jax key; the tests carry the reference's values
    across with ``convert.params_from_reference``."""
    return dict(iter_init(specs, generator, scale, device))
