"""Model building blocks the SSM family and the Zamba2 hybrid serve and
train with: norms, rope, attention with its ring KV cache, the gated MLP,
the token embedding and unembedding, the chunked cross-entropy, and
parameter init from spec trees.

The part of the JAX package's ``models/layers.py`` that Mamba2 and Zamba2
reach, with the same names and numerics: norms in f32, stored in the
input's dtype; rope's angles in f32; attention scores and the PV product
summed in f32 from compute-dtype inputs, masked with the finite
:data:`NEG_INF`, the probabilities rounded to the compute dtype before
the PV product; the embedding and the logits in the compute dtype; the
loss in f32.  Attention is plain torch (einsums as the reference writes
them), not a fused attention call: those neither keep the finite mask nor
round the probabilities where the reference does.  Cross-attention and
MoE come with the families that use them (``ROADMAP.md`` queue A, item
7c).

Every block is a function of ``(cfg, p, x, ...)`` with ``p`` a mapping
from the reference's leaf names to tensors.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import ParamSpec

f32 = torch.float32

# The attention mask's fill: finite, so a row with every key masked is a
# uniform row after the softmax (the reference's), where -inf gives NaN.
NEG_INF = -1e30
# Position of an unwritten KV-cache slot: the causal mask (pq >= pk)
# rejects it for every query.
INVALID_POS = 2**30

__all__ = [
    "INVALID_POS",
    "NEG_INF",
    "attention_block",
    "attention_param_specs",
    "chunked_attention",
    "chunked_xent",
    "expand_kv",
    "mlp_block",
    "mlp_param_specs",
    "pad_heads",
    "pad_q_heads",
    "rope",
    "silu",
    "rms_norm",
    "gated_rms_norm",
    "to_stored_kv",
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


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D), pos: (B, S) or (S,).  Rotates pairs (x_i,
    x_{i+D/2}); the frequencies, angles, sin and cos in f32."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=f32, device=x.device) / half)
    if pos.ndim == 1:
        pos = pos[None, :]
    ang = pos.to(f32)[:, :, None] * freqs  # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Head padding for tensor parallelism (the identity at tp = 1).
# ---------------------------------------------------------------------------

def pad_heads(t: torch.Tensor, target: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, target, D) zero-padded (tail)."""
    h = t.shape[2]
    if h == target:
        return t
    return torch.nn.functional.pad(t, (0, 0, 0, target - h))


def pad_q_heads(t: torch.Tensor, cfg, axis: int = 2) -> torch.Tensor:
    """Pad the q-head axis to ``cfg.padded_heads``.

    MHA: tail pad.  GQA: pad *within each kv group* so the q→kv map stays
    a consecutive repeat (see ``ModelCfg.padded_heads``)."""
    hq, hp, hkv = cfg.n_heads, cfg.padded_heads, cfg.n_kv_heads
    if hp == hq:
        return t
    axis = axis % t.ndim
    if hq == hkv:
        pads = [0, 0] * t.ndim
        pads[2 * (t.ndim - 1 - axis) + 1] = hp - hq
        return torch.nn.functional.pad(t, pads)
    g, gp = hq // hkv, hp // hkv
    shape = list(t.shape)
    grouped = t.reshape(*shape[:axis], hkv, g, *shape[axis + 1:])
    pads = [0, 0] * grouped.ndim
    pads[2 * (grouped.ndim - 1 - (axis + 1)) + 1] = gp - g
    padded = torch.nn.functional.pad(grouped, pads)
    return padded.reshape(*shape[:axis], hp, *shape[axis + 1:])


def to_stored_kv(t: torch.Tensor, cfg) -> torch.Tensor:
    """True kv heads -> stored (shardable) kv heads: consecutive repeat or
    zero pad, per ``ModelCfg.stored_kv_heads``."""
    hkv, hs = t.shape[2], cfg.stored_kv_heads
    if hs == hkv:
        return t
    if cfg.n_heads == cfg.n_kv_heads:
        return pad_heads(t, hs)  # padded-MHA: zero tail, aligned with q pad
    return torch.repeat_interleave(t, hs // hkv, dim=2)  # GQA replication


def expand_kv(t: torch.Tensor, hq: int) -> torch.Tensor:
    """Stored kv heads -> one kv head per q head (consecutive repeat).
    Attention itself never materializes it (the grouped einsum of
    :func:`_attn_chunk`); kept as the reference semantics."""
    hs = t.shape[2]
    if hs == hq:
        return t
    return torch.repeat_interleave(t, hq // hs, dim=2)


# ---------------------------------------------------------------------------
# Attention.
# ---------------------------------------------------------------------------

def _attn_chunk(q, k, v, pos_q, pos_k, causal, window, dtype):
    """q: (B,C,Hq,D); k,v: (B,T,Hs,D) with Hs | Hq (GQA groups); pos_q:
    (B,C); pos_k: (B,T).  The grouped einsum never materializes the kv
    heads at Hq width.  Scores and the PV product are summed in f32 from
    the inputs' values (the reference's ``preferred_element_type=f32``),
    the mask fills with :data:`NEG_INF`, and the probabilities are rounded
    to ``dtype`` before the PV product."""
    b, c, hq, d = q.shape
    hs = k.shape[2]
    g = hq // hs
    scale = d ** -0.5
    qg = q.reshape(b, c, hs, g, d)
    scores = torch.einsum("bchgd,bthd->bhgct", qg.float(), k.float()) * scale
    pq = pos_q[:, None, None, :, None]  # (B,1,1,C,1)
    pk = pos_k[:, None, None, None, :]  # (B,1,1,1,T)
    mask = (pq >= pk) if causal else (pk >= 0)  # pk < 0: unwritten slots
    if window is not None:
        mask = mask & (pq - pk < window)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgct,bthd->bchgd", probs.to(dtype).float(),
                       v.float()).to(dtype)
    return out.reshape(b, c, hq, d)


def chunked_attention(
    q, k, v, pos_q, pos_k, *, causal: bool, window: Optional[int],
    q_chunk: int, dtype,
):
    """Query-chunked attention (memory: O(q_chunk · T) scores).  Under
    autograd each query chunk runs under ``torch.utils.checkpoint`` (the
    reference scans the chunks under ``jax.checkpoint``)."""
    b, s, h, d = q.shape
    if pos_q.ndim == 1:
        pos_q = pos_q[None].expand(b, s)
    if pos_k.ndim == 1:
        pos_k = pos_k[None].expand(b, k.shape[1])
    if s <= q_chunk or s % q_chunk != 0:
        return _attn_chunk(q, k, v, pos_q, pos_k, causal, window, dtype)
    grad = torch.is_grad_enabled()
    outs = []
    for i in range(0, s, q_chunk):
        args = (q[:, i:i + q_chunk], k, v, pos_q[:, i:i + q_chunk], pos_k,
                causal, window, dtype)
        outs.append(checkpoint(_attn_chunk, *args, use_reentrant=False)
                    if grad else _attn_chunk(*args))
    return torch.cat(outs, dim=1)


def attention_param_specs(cfg, d_in: int | None = None) -> dict[str, ParamSpec]:
    d = d_in or cfg.d_model
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kv_tensor = "tensor" if (cfg.n_kv_heads % max(cfg.tp, 1) == 0) else ""
    pd = cfg.param_dtype
    specs = {
        "wq": ParamSpec((d, hq, hd), pd, ("fsdp", "tensor", "")),
        "wk": ParamSpec((d, hkv, hd), pd, ("fsdp", kv_tensor, "")),
        "wv": ParamSpec((d, hkv, hd), pd, ("fsdp", kv_tensor, "")),
        "wo": ParamSpec((hq, hd, d), pd, ("tensor", "", "fsdp")),
    }
    if cfg.qkv_bias:
        specs |= {
            "bq": ParamSpec((hq, hd), pd, ("tensor", "")),
            "bk": ParamSpec((hkv, hd), pd, (kv_tensor, "")),
            "bv": ParamSpec((hkv, hd), pd, (kv_tensor, "")),
        }
    return specs


def _ring_write(cache: dict, k_st, v_st) -> torch.Tensor:
    """Write ``s`` new keys, values and positions into the ring cache at
    slot ``pos % Tc``, in place, and advance ``pos``; returns the slots'
    positions.  The reference writes with ``lax.dynamic_update_slice``,
    which clamps its start so that the update fits (``min(pos % Tc, Tc -
    s)``): a prefill longer than the ring's free tail lands ending at the
    last slot, not wrapped.  The clamp is reproduced; the start stays on
    the device (no host sync)."""
    tc, s = cache["k"].shape[1], k_st.shape[1]
    if s > tc:
        raise ValueError(f"{s} new positions for a cache of {tc} slots")
    pos = cache["pos"]
    ar = torch.arange(s, device=pos.device)
    idx = torch.clamp(pos % tc, max=tc - s).long() + ar
    cache["k"].index_copy_(1, idx, k_st.to(cache["k"].dtype))
    cache["v"].index_copy_(1, idx, v_st.to(cache["v"].dtype))
    cache["positions"].index_copy_(0, idx, (pos + ar).to(pos.dtype))
    pos.add_(s)
    return cache["positions"]


def attention_block(
    cfg,
    p: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    pos,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    use_rope: bool = True,
    cache: Optional[dict] = None,
    x_kv: Optional[torch.Tensor] = None,
    cross: bool = False,
):
    """Self-attention sublayer.  Returns ``(out, cache)``.

    ``pos`` is the first token's position (an int or 0-dim tensor) or the
    tokens' positions (B, S).  KV cache protocol (ring buffer):
      cache = {'k': (B,Tc,Hs,D), 'v': ..., 'positions': (Tc,) int32,
               'pos': 0-dim int32}
    updated in place, where the reference returns a new cache.  Unwritten
    slots carry :data:`INVALID_POS` in 'positions' so the causal mask
    rejects them; the write slot is ``pos % Tc`` (clamped as the
    reference's ``dynamic_update_slice``).  Cross-attention (``cross=True``
    or ``x_kv``) comes with the encoder-decoder: ``ROADMAP.md`` queue A,
    item 7c."""
    if cross or x_kv is not None:
        raise NotImplementedError(
            "cross-attention is not in the port yet: ROADMAP.md queue A, "
            "item 7c (the transformer families)"
        )
    cdt = cfg.compute_dtype
    s = x.shape[1]
    pos = torch.as_tensor(pos, device=x.device)
    pos_q = pos if pos.ndim else pos + torch.arange(s, device=x.device)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cdt))
    if "bq" in p:
        q = q + p["bq"].to(cdt)
    if use_rope:
        q = rope(q, pos_q, cfg.rope_theta)
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cdt))
    if "bk" in p:
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    if use_rope:
        k = rope(k, pos_q, cfg.rope_theta)
    k_st, v_st = to_stored_kv(k, cfg), to_stored_kv(v, cfg)
    if cache is not None:
        pos_k = _ring_write(cache, k_st, v_st)
        k_st, v_st = cache["k"], cache["v"]
    else:
        pos_k = pos_q
    q = pad_q_heads(q, cfg)
    out = chunked_attention(
        q, k_st, v_st, pos_q, pos_k, causal=causal, window=window,
        q_chunk=cfg.q_chunk, dtype=cdt,
    )
    wo = pad_q_heads(p["wo"].to(cdt), cfg, axis=0)
    y = torch.einsum("bshk,hkd->bsd", out, wo)
    return y, cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU).
# ---------------------------------------------------------------------------

def mlp_param_specs(cfg, d: int | None = None, d_ff: int | None = None,
                    gated: bool = True) -> dict[str, ParamSpec]:
    d = d or cfg.d_model
    ff = d_ff or cfg.d_ff
    pd = cfg.param_dtype
    specs = {
        "w_up": ParamSpec((d, ff), pd, ("fsdp", "tensor")),
        "w_down": ParamSpec((ff, d), pd, ("tensor", "fsdp")),
    }
    if gated:
        specs["w_gate"] = ParamSpec((d, ff), pd, ("fsdp", "tensor"))
    return specs


def mlp_block(cfg, p, x, act=silu):
    cdt = cfg.compute_dtype
    up = torch.matmul(x, p["w_up"].to(cdt))
    if "w_gate" in p:
        gate = torch.matmul(x, p["w_gate"].to(cdt))
        h = act(gate) * up
    else:
        h = act(up)
    return torch.matmul(h, p["w_down"].to(cdt))


# ---------------------------------------------------------------------------
# Embedding, unembedding, loss.
# ---------------------------------------------------------------------------

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
