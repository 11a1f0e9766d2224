"""Model building blocks: norms, rope, attention with its ring KV cache
and cross-attention, the gated and the gelu MLP, the sort-based capacity
MoE, the token embedding and unembedding, the chunked cross-entropy, and
parameter init from spec trees.

The JAX package's ``models/layers.py`` with the same names and numerics:
norms in f32, stored in the input's dtype; rope's angles in f32;
attention scores and the PV product summed in f32 from compute-dtype
inputs, masked with the finite :data:`NEG_INF`, the probabilities rounded
to the compute dtype before the PV product; the MoE router's
probabilities in f32; the embedding and the logits in the compute dtype;
the loss in f32.  Attention is plain torch (einsums as the reference
writes them), not a fused attention call: those neither keep the finite
mask nor round the probabilities where the reference does.

Every block is a function of ``(cfg, p, x, ...)`` with ``p`` a mapping
from the reference's leaf names to tensors.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
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
    "SpecModule",
    "rms_norm",
    "gated_rms_norm",
    "to_stored_kv",
    "embed_param_specs",
    "embed_tokens",
    "unembed",
    "flatten_tree",
    "gelu",
    "init_params_",
    "load_tree",
    "moe_block",
    "moe_param_specs",
]


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` in x's dtype, the form of ``jax.nn.silu``."""
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of gelu, ``jax.nn.gelu``'s default
    (``approximate=True``); torch's default is the exact erf form, up to
    4e-4 away at |x| = 3."""
    return F.gelu(x, approximate="tanh")


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
    reference scans the chunks under ``jax.checkpoint``).  A length that
    is not a multiple of ``q_chunk`` ends with a shorter chunk, where the
    reference takes the whole length as one chunk: each query's scores
    are the same sums either way, and a prompt of 2047 tokens would
    otherwise hold its whole (B, H, 2047, 2047) f32 scores (8 GiB at
    llama3-405b's 128 heads, batch 4)."""
    b, s, h, d = q.shape
    if pos_q.ndim == 1:
        pos_q = pos_q[None].expand(b, s)
    if pos_k.ndim == 1:
        pos_k = pos_k[None].expand(b, k.shape[1])
    if s <= q_chunk:
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
    """Full attention sublayer.  Returns ``(out, cache)``.

    ``pos`` is the first token's position (an int or 0-dim tensor) or the
    tokens' positions (B, S).  Self-attention KV cache protocol (ring
    buffer):
      cache = {'k': (B,Tc,Hs,D), 'v': ..., 'positions': (Tc,) int32,
               'pos': 0-dim int32}
    updated in place, where the reference returns a new cache.  Unwritten
    slots carry :data:`INVALID_POS` in 'positions' so the causal mask
    rejects them; the write slot is ``pos % Tc`` (clamped as the
    reference's ``dynamic_update_slice``).

    Cross-attention (``cross=True`` or ``x_kv`` given) is non-causal and
    takes no rope: keys and values come from ``x_kv`` (train, prefill) or
    from a precomputed cache ``{'k', 'v'}`` (decode, ``x_kv`` None), at
    positions ``arange(F)``.  A cache given with ``x_kv`` gets the new
    keys and values (its entries replaced)."""
    cdt = cfg.compute_dtype
    cross = cross or (x_kv is not None)
    s = x.shape[1]
    pos = torch.as_tensor(pos, device=x.device)
    pos_q = pos if pos.ndim else pos + torch.arange(s, device=x.device)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cdt))
    if "bq" in p:
        q = q + p["bq"].to(cdt)
    rotate = use_rope and not cross
    if rotate:
        q = rope(q, pos_q, cfg.rope_theta)
    if cross and cache is not None and x_kv is None:
        k_st, v_st = cache["k"], cache["v"]
        pos_k = torch.arange(k_st.shape[1], device=x.device)
    else:
        src = x_kv if cross else x
        k = torch.einsum("bsd,dhk->bshk", src, p["wk"].to(cdt))
        v = torch.einsum("bsd,dhk->bshk", src, p["wv"].to(cdt))
        if "bk" in p:
            k = k + p["bk"].to(cdt)
            v = v + p["bv"].to(cdt)
        if rotate:
            k = rope(k, pos_q, cfg.rope_theta)
        k_st, v_st = to_stored_kv(k, cfg), to_stored_kv(v, cfg)
        if cross:
            if cache is not None:
                cache["k"], cache["v"] = k_st, v_st
            pos_k = torch.arange(k_st.shape[1], device=x.device)
        elif cache is not None:
            pos_k = _ring_write(cache, k_st, v_st)
            k_st, v_st = cache["k"], cache["v"]
        else:
            pos_k = pos_q
    q = pad_q_heads(q, cfg)
    out = chunked_attention(
        q, k_st, v_st, pos_q, pos_k, causal=causal and not cross,
        window=window, q_chunk=cfg.q_chunk, dtype=cdt,
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
# Mixture of experts (sort-based capacity dispatch).
# ---------------------------------------------------------------------------

def moe_param_specs(cfg) -> dict[str, ParamSpec]:
    m = cfg.moe
    d, ff, e = cfg.d_model, cfg.d_ff, m.n_experts
    pd = cfg.param_dtype
    if m.expert_parallel:
        ax = ("expert", "", "")
        ax_t = ("expert", "", "")
    else:
        ax = ("", "fsdp", "tensor")
        ax_t = ("", "tensor", "fsdp")
    specs = {
        "router": ParamSpec((d, e), pd, ("fsdp", "")),
        "w1": ParamSpec((e, d, ff), pd, ax),
        "w3": ParamSpec((e, d, ff), pd, ax),
        "w2": ParamSpec((e, ff, d), pd, ax_t),
    }
    if m.dense_residual:
        specs["dense"] = mlp_param_specs(cfg)
    return specs


def top_k(probs: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest entries of each row,
    the lower index first among equal values, as ``lax.top_k`` orders
    them (``torch.topk`` does not promise an order on ties): a stable
    descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_route(cfg, p, xf, record: Optional[list] = None):
    """Sort-based capacity routing for one token group.  xf: (n, d).
    Returns (dispatch buffer (E, cap, d), slot_of (n, k), gates (n, k)),
    and appends ``{"eidx": (n, k) experts, "dropped": (n, k) bool}`` to
    ``record`` where one is given.

    The reference's steps: f32 router probabilities, top-k (lower expert
    first on ties), gates renormalised over the k picks; assignments
    sorted by expert (stable), ranked within their expert by
    ``searchsorted(side="left")``; an assignment ranked at or beyond the
    capacity ``max(ceil(n·k/e·cf), 4)`` goes to the overflow row
    ``e·cap``, which is zero in the combine (the token keeps its gate
    weights as renormalised before the drop)."""
    m = cfg.moe
    cdt = cfg.compute_dtype
    n, d = xf.shape
    e, k = m.n_experts, m.top_k
    logits = torch.matmul(xf, p["router"].to(cdt)).float()
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = top_k(probs, k)  # (n, k)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)

    cap = max(int(math.ceil(n * k / e * m.capacity_factor)), 4)
    flat_e = eidx.reshape(-1)  # (n*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(n * k, device=xf.device) - first
    slot = torch.where(rank < cap, sorted_e * cap + rank, e * cap)
    token_of = order // k
    # Only the overflow row takes several writes; it is cut off below.
    disp = xf.new_zeros((e * cap + 1, d), dtype=cdt)
    disp[slot] = xf[token_of].to(cdt)
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot
    slot_of = slot_of.reshape(n, k)
    if record is not None:
        record.append({"eidx": eidx, "dropped": slot_of == e * cap})
    return disp[: e * cap].reshape(e, cap, d), slot_of, gates


def _moe_combine(cfg, y, slot_of, gates):
    """y: (E, cap, d) expert outputs; gather back per token, the overflow
    row reading zeros."""
    cdt = cfg.compute_dtype
    e, cap, d = y.shape
    yf = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))])
    picked = yf[slot_of]  # (n, k, d)
    return torch.sum(picked * gates.to(cdt)[..., None], dim=1)


def moe_block(cfg, p, x, record: Optional[list] = None):
    """Top-k capacity MoE.  Tokens are grouped by the data-parallel
    groups (``cfg.dp``; one group outside a mesh), and each group routes
    and dispatches on its own (its routes appended to ``record``, see
    :func:`_moe_route`); the experts run as one batched product over
    every group, then each group gathers its tokens back.  With
    ``dense_residual`` (arctic) a gated MLP runs beside the experts."""
    m = cfg.moe
    cdt = cfg.compute_dtype
    b, s, d = x.shape
    g = cfg.dp if (cfg.dp > 1 and b % cfg.dp == 0) else 1
    xg = x.reshape(g, (b // g) * s, d)
    routed = [_moe_route(cfg, p, xf, record) for xf in xg]
    h = torch.stack([r[0] for r in routed])  # (G, E, cap, d)
    a1 = torch.einsum("gecd,edf->gecf", h, p["w1"].to(cdt))
    a3 = torch.einsum("gecd,edf->gecf", h, p["w3"].to(cdt))
    y = torch.einsum("gecf,efd->gecd", silu(a1) * a3, p["w2"].to(cdt))
    out = torch.stack([_moe_combine(cfg, yi, r[1], r[2])
                       for yi, r in zip(y, routed)]).reshape(b, s, d)
    if m.dense_residual:
        out = out + mlp_block(cfg, p["dense"], x)
    return out


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


# ---------------------------------------------------------------------------
# Modules laid out as the reference's parameter trees.
# ---------------------------------------------------------------------------

class SpecModule(nn.Module):
    """Parameters laid out as a spec tree: each :class:`ParamSpec` leaf is
    a parameter (made empty and trainable; serving runs under
    ``inference_mode``), each dict a child module of the same kind."""

    def __init__(self, specs: dict, device=None):
        super().__init__()
        for name, spec in specs.items():
            if isinstance(spec, ParamSpec):
                self.register_parameter(name, nn.Parameter(
                    torch.empty(spec.shape, dtype=spec.dtype, device=device)))
            else:
                self.add_module(name, SpecModule(spec, device))

    def tensors(self) -> dict:
        """The tree of tensors the blocks take: ``{leaf: tensor}``, and a
        nested dict for each child."""
        out = dict(self.named_parameters(recurse=False))
        out.update((k, m.tensors()) for k, m in self.named_children())
        return out


def _targets(module: nn.Module, path: str) -> list:
    """The parameters of ``module`` behind the reference tree's leaf
    ``path``: one, or for a leaf of a stacked group (an ``nn.ModuleList``
    attribute, the reference's (L, ...) leaves) one per layer."""
    group, _, rest = path.partition(".")
    sub = getattr(module, group, None)
    if isinstance(sub, nn.ModuleList):
        return [blk.get_parameter(rest) for blk in sub]
    return [module.get_parameter(path)]


def load_tree(module: nn.Module, leaves, specs) -> nn.Module:
    """Fill ``module``'s parameters from ``(dotted path, tensor)`` pairs of
    the reference's tree ``specs`` (a stacked group's leaves (L, ...) split
    over its layers), casting to each parameter's dtype.  Every leaf must
    come exactly once."""
    seen = set()
    with torch.no_grad():
        for path, value in leaves:
            try:
                dst = _targets(module, path)
            except AttributeError as e:
                raise KeyError(f"unknown parameter {path!r}") from e
            src = value if len(dst) > 1 or dst[0].ndim < value.ndim else [value]
            if len(dst) != len(src):
                raise ValueError(f"{path}: {len(src)} layers stacked, the "
                                 f"model has {len(dst)}")
            for t, v in zip(dst, src):
                t.copy_(v)
            seen.add(path)
    want = {k for k, _ in flatten_tree(specs)}
    if seen != want:
        raise KeyError(
            f"missing {sorted(want - seen)}, unexpected {sorted(seen - want)}"
        )
    return module


@torch.no_grad()
def init_params_(module: nn.Module, specs, generator: torch.Generator,
                 scale: float = 0.02, piece: int = 1 << 26) -> nn.Module:
    """Fill ``module``'s parameters by the reference's ``init_from_specs``
    rule on its tree ``specs`` (ones where the *stacked* leaf is 1-D or
    ends in 1, else ``N(0, 1)·scale``), leaf by leaf in flatten order
    and layer by layer within a stacked leaf.  Each draw is made in f32
    pieces of at most ``piece`` elements along the leading dims and cast
    into place, so no leaf's f32 draw is held whole: arctic's expert
    weights are 8.9 GB of bf16 a layer.  A torch generator draws other
    numbers than a jax key; the tests carry the reference's values across
    with ``convert.params_from_reference``."""
    for path, spec in flatten_tree(specs):
        ones = len(spec.shape) <= 1 or spec.shape[-1] == 1
        for t in _targets(module, path):
            if ones:
                t.fill_(1)
                continue
            flat = t.view(-1, t.shape[-1])
            rows = max(1, piece // t.shape[-1])
            for i in range(0, flat.shape[0], rows):
                part = flat[i:i + rows]
                v = torch.randn(part.shape, generator=generator,
                                dtype=torch.float32, device=t.device)
                part.copy_(v.mul_(scale))
    return module
