"""Model building blocks the SSM family serves and trains with: norms,
the token embedding and unembedding, the chunked cross-entropy, and
parameter init from spec trees.

The part of the JAX package's ``models/layers.py`` that Mamba2 reaches,
with the same names and numerics: norms in f32, stored in the input's
dtype; the embedding and the logits in the compute dtype; the loss in
f32.  Attention, MLP and MoE come with the families that use them
(``ROADMAP.md`` queue A, items 7b-7c).

Every block is a function of ``(cfg, p, x, ...)`` with ``p`` a mapping
from the reference's leaf names to tensors.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import ParamSpec

NEG_INF = -1e30

__all__ = [
    "NEG_INF",
    "chunked_xent",
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


class _OneHotLookup(torch.autograd.Function):
    """``table[tokens]`` whose gradient is the reference's: the JAX package
    looks up multi-token inputs as a one-hot matmul, so the table's
    gradient is ``onehot(tokens)ᵀ · g``, one dot in the table's dtype (for
    bf16: summed in f32, rounded once).  The forward gathers, which is
    exact (a row of the product is 1·row + 0·others); the backward is that
    dot, which is deterministic on the card, where an ``index_add_`` would
    sum in another order from run to run."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.vocab = table.shape[0]
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        flat = tokens.reshape(-1)
        n = flat.numel()
        onehot_t = g.new_zeros((ctx.vocab, n))  # (V, N): onehotᵀ
        onehot_t[flat, torch.arange(n, device=flat.device)] = 1
        return torch.matmul(onehot_t, g.reshape(n, -1)), None


def embed_tokens(cfg, p: Mapping[str, torch.Tensor], tokens: torch.Tensor):
    """Token embedding in the compute dtype.  Values are the table's rows
    (the reference's one-hot matmul gives them exactly); under autograd a
    multi-token lookup takes the reference's gradient
    (:class:`_OneHotLookup`).  Serving, under ``inference_mode``, gathers."""
    table = p["embedding"].to(cfg.compute_dtype)
    if (tokens.shape[-1] > 1 and torch.is_grad_enabled()
            and table.requires_grad):
        return _OneHotLookup.apply(table, tokens)
    return table[tokens]


def unembed(cfg, p: Mapping[str, torch.Tensor], x: torch.Tensor):
    """Logits in the compute dtype, over the padded vocabulary."""
    cdt = cfg.compute_dtype
    if cfg.tie_embeddings:
        w = p["embedding"].to(cdt).T
    else:
        w = p["lm_head"].to(cdt)
    return torch.matmul(x, w)


def chunked_xent(cfg, p: Mapping[str, torch.Tensor], x, targets, mask):
    """Sequence-chunked softmax cross-entropy: the f32 logits (B, S, V)
    are never held whole, only (B, loss_chunk, V) per chunk, each chunk
    under ``torch.utils.checkpoint`` (the reference scans the chunks under
    ``jax.checkpoint``).  The mean of the masked token losses, over at
    least one token."""
    s = x.shape[1]
    c = cfg.loss_chunk
    if s % c != 0 or s <= c:
        return _xent_chunk(cfg, p, x, targets, mask)
    num = torch.zeros((), dtype=torch.float32, device=x.device)
    den = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        n_i, d_i = checkpoint(
            _xent_chunk, cfg, p, x[:, i:i + c], targets[:, i:i + c],
            mask[:, i:i + c], False, use_reentrant=False,
        )
        num = num + n_i
        den = den + d_i
    return num / torch.clamp(den, min=1.0)


def _xent_chunk(cfg, p, x, targets, mask, reduce=True):
    """One chunk's loss: f32 logits with the padded vocabulary entries
    set to :data:`NEG_INF`, ``logsumexp - gold``.  The reference takes the
    gold logit as a masked sum over the vocabulary; a gather gives the same
    value (a sum of zeros and one value is exact)."""
    logits = unembed(cfg, p, x).float()
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, NEG_INF)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    mask = mask.float()
    nll = (logz - gold) * mask
    num, den = torch.sum(nll), torch.sum(mask)
    if reduce:
        return num / torch.clamp(den, min=1.0)
    return num, den


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
