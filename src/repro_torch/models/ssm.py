"""Mamba2 (SSD, state-space duality) and the Zamba2 hybrid: served and
trained.

A port of the JAX package's ``models/ssm.py``.  SSD runs the chunked
algorithm of the Mamba2 paper: the sequence is split into chunks of Q
tokens; within a chunk the dual (quadratic) form is used, between chunks
the recurrent state is carried — here as a Python loop over chunks, where
the reference scans.  The causal conv goes through the hand-written
kernel (``kernels.conv1d``) when ``SSMCfg.pallas_conv`` is set and S > 1,
as in the reference.

Zamba2 (``attn_every > 0``) is the stack of Mamba2 blocks with one
*shared* attention + MLP block (:class:`SharedAttn`, held once) applied
after layers i with ``(i + 1) % attn_every == 0``; each application has
its own KV cache.  As in the reference, the shared block is applied to
the hidden state directly (no concat-with-embedding / per-application
LoRA of the released model).

Parameters live in modules whose names are the reference tree's leaf
names: :class:`SSMModel` has ``embed`` (``embedding``, ``final_norm``),
``layers``, a ``ModuleList`` of :class:`MambaBlock`, and for the hybrid
``shared_attn`` (``ln1``, ``ln2``, ``attn.w{q,k,v,o}``,
``ffn.w_{up,gate,down}``).  The reference stacks the layers' leaves on a
leading axis; here each layer holds its own.

Serving runs under ``torch.inference_mode()``.  The decode cache is
updated in place: :func:`ssm_forward` writes each layer's new SSM and
conv state, and each attention application's keys, values and positions,
into the cache it was given, where the reference returns a new cache.
Training (:func:`ssm_loss`) differentiates the same forward; with
``cfg.remat`` each layer (with the shared block after it, where one
follows) runs under ``torch.utils.checkpoint``: the reference's
``remat_groups`` two-level scan with whole-group remat changes memory,
not results.  The intra-chunk decay of SSD masks its exponent before
``exp``: the reference's ``where(tri, exp(diff), 0)`` overflows above the
diagonal at 128-token chunks, and its gradient is then NaN
(``ROADMAP.md`` queue C); the forward is the same.  The reference's
``_constrain_act`` sharding constraints are in place (each layer's input,
each ``remat_groups`` group's output); they change no value.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.conv1d import causal_conv1d
from ..parallel.sharding import ParamSpec
from .layers import (
    INVALID_POS,
    SpecModule,
    attention_block,
    attention_param_specs,
    chunked_xent,
    embed_param_specs,
    embed_tokens,
    gated_rms_norm,
    load_tree,
    mlp_block,
    mlp_param_specs,
    rms_norm,
    silu,
    unembed,
)
from .transformer import _constrain_act, _group_end

f32 = torch.float32

__all__ = [
    "MambaBlock",
    "SharedAttn",
    "SSMModel",
    "mamba_layer_specs",
    "mamba_block",
    "ssm_param_specs",
    "ssm_forward",
    "ssm_loss",
    "ssm_prefill",
    "ssm_decode_step",
    "ssm_cache_specs",
    "ssm_init_cache",
]

# ---------------------------------------------------------------------------
# Mamba2 block.
# ---------------------------------------------------------------------------

def mamba_layer_specs(cfg) -> dict[str, ParamSpec]:
    d, din, n, h = cfg.d_model, cfg.d_inner, cfg.ssm.state, cfg.ssm_heads
    w = cfg.ssm.conv_width
    pd = cfg.param_dtype
    conv_ch = din + 2 * n
    h_ax = "tensor" if h % max(cfg.tp, 1) == 0 else ""
    return {
        "ln": ParamSpec((d,), pd, ("",)),
        "w_zx": ParamSpec((d, 2 * din), pd, ("fsdp", "tensor")),
        "w_bc": ParamSpec((d, 2 * n), pd, ("fsdp", "")),
        "w_dt": ParamSpec((d, h), pd, ("fsdp", h_ax)),
        "dt_bias": ParamSpec((h,), pd, ("",)),
        "A_log": ParamSpec((h,), pd, ("",)),
        "D": ParamSpec((h,), pd, ("",)),
        "conv_w": ParamSpec((w, conv_ch), pd, ("", "tensor")),
        "conv_b": ParamSpec((conv_ch,), pd, ("tensor",)),
        "norm_w": ParamSpec((din,), pd, ("",)),
        "out_proj": ParamSpec((din, d), pd, ("tensor", "fsdp")),
    }


def _causal_conv(xbc, conv_w, conv_b, state: Optional[torch.Tensor],
                 use_kernel: bool = False, tile_s: Optional[int] = None):
    """Depthwise causal conv, width W.  xbc: (B,S,C).
    state: (B, W-1, C) tail of the previous sequence (decode) or None.
    Returns (out, new_state).

    ``use_kernel`` routes the math through the conv kernel
    (``kernels.conv1d``), which accumulates in f32.  Otherwise — and for
    the single-token decode step (S == 1) — the conv is the reference's
    unrolled loop in xbc's dtype: in bf16 every product and sum rounds to
    bf16, as the reference writes it."""
    b, s, c = xbc.shape
    w = conv_w.shape[0]
    if state is None:
        pad = xbc.new_zeros((b, w - 1, c))
    else:
        pad = state.to(xbc.dtype)
    if use_kernel and s > 1:
        # The last W-1 rows of [pad, xbc], without building the concat.
        new_state = torch.cat([pad[:, s:], xbc[:, -(w - 1):]], dim=1)
        out = causal_conv1d(xbc, conv_w, conv_b, tile_s=tile_s, state=state,
                            device=xbc.device)
        return out, new_state
    full = torch.cat([pad, xbc], dim=1)  # (B, S+W-1, C)
    new_state = full[:, -(w - 1):, :]
    out = torch.zeros_like(xbc)
    for i in range(w):  # width is 4 — unrolled stencil (1-D, radius w-1)
        out = out + full[:, i:i + s, :] * conv_w[i]
    out = out + conv_b
    return silu(out), new_state


def _ssd_chunked(x, dt, A, B_, C_, chunk):
    """Streaming chunked SSD.  x: (B,L,H,P); dt: (B,L,H); A: (H,) (neg);
    B_, C_: (B,L,N).  Returns (y: (B,L,H,P), final_state: (B,H,P,N)).

    One chunk is live at a time: the intra-chunk quadratic factor
    (B,Q,Q,H) never materializes for the whole sequence.  Q is the
    largest divisor of L that is at most ``chunk`` (the reference's rule:
    exactness over speed for odd prompt lengths)."""
    b, l, h, p = x.shape
    n = B_.shape[-1]
    q = min(chunk, l)
    while l % q:
        q -= 1
    nc = l // q
    xs = x.reshape(b, nc, q, h, p)
    dts = dt.reshape(b, nc, q, h)
    Bs = B_.reshape(b, nc, q, n)
    Cs = C_.reshape(b, nc, q, n)
    ii = torch.arange(q, device=x.device)
    tri = (ii[:, None] >= ii[None, :])[None, :, :, None]  # (1,Qi,Qj,1)
    hprev = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    ys = []
    for k in range(nc):
        xc, dtc, Bc, Cc = xs[:, k], dts[:, k], Bs[:, k], Cs[:, k]
        dA = dtc * A  # (B,Q,H)
        dA_cs = torch.cumsum(dA, dim=1)
        # contribution of the incoming state
        y_off = torch.einsum("bin,bhpn,bih->bihp", Cc, hprev, torch.exp(dA_cs))
        # intra-chunk dual form
        diff = dA_cs[:, :, None, :] - dA_cs[:, None, :, :]  # (B,Qi,Qj,H)
        # Masked before exp: above the diagonal diff is positive and
        # overflows at Q = 128, and where(tri, exp(diff), 0)'s gradient is
        # then 0 · inf = NaN.  exp(-inf) = 0, so the values are the same.
        lmat = torch.exp(diff.masked_fill(~tri, float("-inf")))
        scores = torch.einsum("bin,bjn->bij", Cc, Bc)
        w = scores[..., None] * lmat * dtc[:, None, :, :]  # (B,Qi,Qj,H)
        y = torch.einsum("bijh,bjhp->bihp", w, xc)
        # state update
        decay_out = torch.exp(dA_cs[:, -1:, :] - dA_cs)  # (B,Q,H)
        states = torch.einsum("bjn,bjh,bjhp->bhpn", Bc, dtc * decay_out, xc)
        hprev = hprev * torch.exp(dA_cs[:, -1, :])[:, :, None, None] + states
        ys.append(y + y_off)
    y = torch.stack(ys, dim=1).reshape(b, l, h, p)
    return y, hprev


def _in_proj(cfg, p, x):
    """The block's input projections: ``(z, xbc, dt)`` — the gate, the
    conv's input ``[x_in, B, C]`` (B,S,d_inner+2N) in the compute dtype,
    and the softplus'd step sizes in f32."""
    cdt = cfg.compute_dtype
    din = cfg.d_inner
    zx = torch.matmul(x, p["w_zx"].to(cdt))
    z, xin = zx[..., :din], zx[..., din:]
    bc = torch.matmul(x, p["w_bc"].to(cdt))
    dt = torch.matmul(x, p["w_dt"].to(cdt))
    # jax.nn.softplus is logaddexp(x, 0); F.softplus agrees to an ulp.
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return z, torch.cat([xin, bc], dim=-1), dt


def mamba_block(cfg, p, x, ssm_state=None, conv_state=None):
    """x: (B,S,D).  Returns (y, new_ssm_state, new_conv_state)."""
    cdt = cfg.compute_dtype
    b, s, d = x.shape
    din, n, h = cfg.d_inner, cfg.ssm.state, cfg.ssm_heads
    ph = cfg.ssm.head_dim
    z, xbc, dt = _in_proj(cfg, p, x)
    xbc, new_conv = _causal_conv(
        xbc, p["conv_w"].to(cdt), p["conv_b"].to(cdt), conv_state,
        use_kernel=cfg.ssm.pallas_conv, tile_s=cfg.ssm.conv_tile,
    )
    xin, B_, C_ = xbc[..., :din], xbc[..., din:din + n], xbc[..., din + n:]
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(b, s, h, ph).float()
    if s == 1 and ssm_state is not None:
        # recurrent decode step
        dA = torch.exp(dt[:, 0] * A)  # (B,H)
        dx = dt[:, 0, :, None] * xh[:, 0]  # (B,H,P)
        new_state = ssm_state * dA[:, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", dx, B_[:, 0].float()
        )
        y = torch.einsum("bhpn,bn->bhp", new_state, C_[:, 0].float())
        y = y[:, None]  # (B,1,H,P)
    else:
        y, new_state = _ssd_chunked(
            xh, dt, A, B_.float(), C_.float(), cfg.ssm.chunk
        )
    y = y + p["D"].float()[:, None] * xh
    y = y.reshape(b, s, din).to(cdt)
    y = gated_rms_norm(y, z, p["norm_w"])
    return torch.matmul(y, p["out_proj"].to(cdt)), new_state, new_conv


# ---------------------------------------------------------------------------
# Modules.
# ---------------------------------------------------------------------------

class MambaBlock(SpecModule):
    """One Mamba2 layer's parameters; ``forward`` is :func:`mamba_block`
    on an already normalized input."""

    def __init__(self, cfg, device=None):
        super().__init__(mamba_layer_specs(cfg), device)
        self.cfg = cfg

    def forward(self, x, ssm_state=None, conv_state=None):
        return mamba_block(self.cfg, self.tensors(), x, ssm_state, conv_state)


class SharedAttn(nn.Module):
    """The hybrid's shared block: ``ln1``, ``ln2``, ``attn`` (the
    attention leaves) and ``ffn`` (the gated MLP's); ``forward`` is the
    reference's ``_shared_attn_apply``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        for name in ("ln1", "ln2"):
            self.register_parameter(name, nn.Parameter(torch.empty(
                (cfg.d_model,), dtype=cfg.param_dtype, device=device)))
        self.attn = SpecModule(attention_param_specs(cfg), device)
        self.ffn = SpecModule(mlp_param_specs(cfg), device)

    def forward(self, x, pos, cache=None):
        """``x + attn(norm(x))``, then ``+ mlp(norm(·))``; returns ``(x,
        cache)`` with ``cache`` (one application's) updated in place."""
        cfg = self.cfg
        h, cache = attention_block(
            cfg, self.attn.tensors(), rms_norm(x, self.ln1), pos,
            causal=True, window=cfg.window, cache=cache,
        )
        x = x + h
        x = x + mlp_block(cfg, self.ffn.tensors(), rms_norm(x, self.ln2))
        return x, cache


class SSMModel(nn.Module):
    """The SSM family's parameters: ``embed``, ``layers`` and, for the
    hybrid, ``shared_attn``.  Parameters are made empty; :meth:`load_flat`
    fills them; :func:`ssm_forward` runs the model."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = SpecModule(embed_param_specs(cfg), device)
        self.layers = nn.ModuleList(
            [MambaBlock(cfg, device) for _ in range(cfg.n_layers)]
        )
        if cfg.attn_every:
            self.shared_attn = SharedAttn(cfg, device)

    def load_flat(self, leaves) -> "SSMModel":
        """Fill the parameters from ``(dotted path, tensor)`` pairs of the
        reference's tree (``embed.<leaf>``, ``shared_attn.<...>``, and
        ``layers.<leaf>`` stacked (L, ...) over the layers), casting to
        each parameter's dtype (:func:`~.layers.load_tree`)."""
        return load_tree(self, leaves, ssm_param_specs(self.cfg))


# ---------------------------------------------------------------------------
# Full SSM / hybrid model.
# ---------------------------------------------------------------------------

def _n_attn_apps(cfg) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def _stack_specs(specs: dict, n: int) -> dict:
    """Add a leading 'layers' axis to every ParamSpec leaf."""
    return {
        k: ParamSpec((n,) + s.shape, s.dtype, ("layers",) + s.axes)
        for k, s in specs.items()
    }


def ssm_param_specs(cfg) -> dict:
    """The reference's spec tree: ``embed``, ``layers`` stacked (L, ...)
    and, for the hybrid, ``shared_attn`` (counted once)."""
    specs = {
        "embed": embed_param_specs(cfg),
        "layers": _stack_specs(mamba_layer_specs(cfg), cfg.n_layers),
    }
    if cfg.attn_every:
        specs["shared_attn"] = {
            "ln1": ParamSpec((cfg.d_model,), cfg.param_dtype, ("",)),
            "ln2": ParamSpec((cfg.d_model,), cfg.param_dtype, ("",)),
            "attn": attention_param_specs(cfg),
            "ffn": mlp_param_specs(cfg),
        }
    return specs


def _shares_attn(cfg, i: int) -> bool:
    """Whether the shared block follows layer ``i``."""
    return bool(cfg.attn_every) and (i + 1) % cfg.attn_every == 0


def _train_layer(cfg, params: "SSMModel", i: int, x, pos):
    """Layer ``i`` of the training forward: ``x + block(norm(x))``, then
    the shared block where one follows the layer."""
    p = params.layers[i].tensors()
    x = _constrain_act(cfg, x)
    x = x + mamba_block(cfg, p, rms_norm(x, p["ln"]))[0]
    if _shares_attn(cfg, i):
        x, _ = params.shared_attn(x, pos)
    return x


def ssm_forward(cfg, params: SSMModel, tokens, pos, cache=None):
    """cache = None (train) or the dict from :func:`ssm_init_cache`, whose
    ``ssm``/``conv`` states (and, for the hybrid, each application's
    ``attn`` keys, values, positions and write position) are read and then
    overwritten in place, layer by layer.  ``pos`` is the first token's
    position (the hybrid's attention reads it).  Without a cache, under
    autograd and with ``cfg.remat``, each layer runs under
    ``torch.utils.checkpoint``."""
    emb = params.embed.tensors()
    x = embed_tokens(cfg, emb, tokens)
    if cache is None and cfg.remat and torch.is_grad_enabled():
        for i in range(cfg.n_layers):
            x = checkpoint(_train_layer, cfg, params, i, x, pos,
                           use_reentrant=False)
            if _group_end(cfg, i):
                x = _constrain_act(cfg, x)
        return rms_norm(x, emb["final_norm"]), None
    attn = cache.get("attn") if cache is not None else None
    for i, blk in enumerate(params.layers):
        ssm_s = cache["ssm"][i] if cache is not None else None
        conv_s = cache["conv"][i] if cache is not None else None
        x = _constrain_act(cfg, x)
        y, new_ssm, new_conv = mamba_block(
            cfg, blk.tensors(), rms_norm(x, blk.ln), ssm_s, conv_s
        )
        x = x + y
        if cache is not None:
            cache["ssm"][i].copy_(new_ssm)
            cache["conv"][i].copy_(new_conv)
        if _shares_attn(cfg, i):
            app = i // cfg.attn_every
            c_app = None if attn is None else {
                k: v[app] for k, v in attn.items()}
            x, _ = params.shared_attn(x, pos, c_app)
    x = rms_norm(x, emb["final_norm"])
    return x, cache


def ssm_loss(cfg, params: SSMModel, batch):
    """The mean next-token cross-entropy of ``batch`` (``tokens``,
    ``targets`` (B, S) int64 and ``mask`` (B, S) tensors on the
    parameters' device), through :func:`~.layers.chunked_xent`."""
    x, _ = ssm_forward(cfg, params, batch["tokens"], 0)
    return chunked_xent(cfg, params.embed.tensors(), x, batch["targets"],
                        batch["mask"])


def ssm_cache_specs(cfg, batch: int, max_len: int) -> dict:
    """The serving cache: per layer the SSM and conv states; for the
    hybrid, per shared-block application a KV ring of ``max_len`` slots
    (``attn``: ``k``, ``v`` (A, B, max_len, Hs, D) in the compute dtype,
    ``positions`` (A, max_len) and ``pos`` (A,) int32)."""
    n, h, p = cfg.ssm.state, cfg.ssm_heads, cfg.ssm.head_dim
    w = cfg.ssm.conv_width
    conv_ch = cfg.d_inner + 2 * n
    h_ax = "tensor" if h % max(cfg.tp, 1) == 0 else ""
    specs = {
        "ssm": ParamSpec((cfg.n_layers, batch, h, p, n), f32,
                         ("layers", "batch", h_ax, "", "")),
        "conv": ParamSpec((cfg.n_layers, batch, w - 1, conv_ch),
                          cfg.compute_dtype, ("layers", "batch", "", "tensor")),
    }
    if cfg.attn_every:
        napp = _n_attn_apps(cfg)
        hs, hd = cfg.stored_kv_heads, cfg.head_dim
        specs["attn"] = {
            "k": ParamSpec((napp, batch, max_len, hs, hd), cfg.compute_dtype,
                           ("", "batch", "", "tensor", "")),
            "v": ParamSpec((napp, batch, max_len, hs, hd), cfg.compute_dtype,
                           ("", "batch", "", "tensor", "")),
            "positions": ParamSpec((napp, max_len), torch.int32, ("", "")),
            "pos": ParamSpec((napp,), torch.int32, ("",)),
        }
    return specs


def ssm_init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """Zeros, except the attention slots' positions: :data:`INVALID_POS`
    (unwritten)."""
    def zeros(tree):
        if isinstance(tree, ParamSpec):
            return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
        return {k: zeros(v) for k, v in tree.items()}

    cache = zeros(ssm_cache_specs(cfg, batch, max_len))
    if cfg.attn_every:
        cache["attn"]["positions"].fill_(INVALID_POS)
    return cache


def ssm_prefill(cfg, params, tokens, cache):
    x, new_cache = ssm_forward(cfg, params, tokens, 0, cache=cache)
    logits = unembed(cfg, params.embed.tensors(), x[:, -1:, :])
    return logits, new_cache


def ssm_decode_step(cfg, params, cache, token, pos):
    x, new_cache = ssm_forward(cfg, params, token, pos, cache=cache)
    logits = unembed(cfg, params.embed.tensors(), x)
    return logits, new_cache
