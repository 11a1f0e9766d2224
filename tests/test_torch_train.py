"""The port's training path (``repro_torch``: ``models/layers.py``'s
chunked cross-entropy, ``ssm_loss``, ``optim/``, ``data/``,
``runtime/fault_tolerance.py``, ``checkpoint/`` and ``launch/train.py``)
against the JAX package, on the CPU.

Inputs are made from seeds with numpy (the reference's parameters from a
jax key, carried across with ``convert.params_from_reference``) and go
through both packages.  The conv runs as the Pallas kernel in interpret
mode on the JAX side and as the port's plain version (``device="cpu"``).
The reference's step is its ``launch/train.py`` step function (jitted,
outside a mesh): ``repro.launch.train.main`` fails under jax 0.9.0 (its
mesh makes ``Explicit`` axes, which ``with_sharding_constraint`` rejects;
``ROADMAP.md`` queue C).  Tolerances:

* f32 compute: losses ``rtol = 1e-6``; gradients ``atol = 1e-5 · max|g|``
  per leaf (``rtol = 1e-5``) — f32 sums of up to a few hundred terms
  (matmuls, SSD einsums, the loss's reductions) run in another order in
  XLA and ATen, and exp/log/sigmoid differ by about an ulp; observed
  errors are below 3e-6 of a leaf's scale.
* bf16 compute: the loss within two bf16 ulps (``rtol = 2**-7``), as
  ``test_torch_mamba2.py`` states them; gradients within four bf16 ulps of
  a leaf's scale (``atol = 2**-6 · max|g|``, ``rtol = 2**-6``) — the
  backward rounds to bf16 at as many places again as the forward, and a
  one-ulp difference in a bf16 cotangent is carried through the layers
  below; observed errors reach 1.4 ulps (5.4e-3 of the scale).
* AdamW: ``rtol = 4e-7`` (a few f32 ulps), and ``atol = 2e-6`` of a
  leaf's largest value: the gradient norm (a sum in another order), hence
  the clip scale, the bias corrections (``pow``) and the schedule
  (``cos``) may differ by an ulp between XLA and ATen, and where
  ``b1·m + (1-b1)·g`` cancels, a small moment carries the absolute error
  of its larger terms; the update is elementwise in the reference's
  order.
* SSD at chunk 128 against chunk 16 (the same sequence): the chunked
  algorithm is exact whatever the chunk, so the two differ by f32
  rounding alone (``atol = 1e-4 · max|g|`` per leaf: the decay products
  are taken over other spans).
* Compression: the port quantizes with the IEEE quotient; where the JAX
  code differs, the reciprocal-product code ``round(g · (1/scale))``
  differs from the IEEE one there (``ROADMAP.md`` queue C).
* The data pipeline, the monitor, checkpoint files and the port's resumed
  run are held bit for bit.
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointConfig as JCkptConfig  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro.optim import cosine_schedule as j_cosine  # noqa: E402
from repro.optim import global_norm as j_global_norm  # noqa: E402
from repro.optim import opt_state_specs as j_opt_state_specs  # noqa: E402
from repro.optim.compression import _quantize as j_quantize  # noqa: E402
from repro.optim.compression import compressed_mean as j_compressed  # noqa: E402
from repro.runtime import fault_tolerance as jft  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointConfig, Checkpointer  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import get_model as t_get_model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.layers import flatten_tree  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    OptConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    decay_mask,
    global_norm,
    opt_state_specs,
)
from repro_torch.optim.compression import _quantize  # noqa: E402
from repro_torch.optim.compression import compressed_mean  # noqa: E402
from repro_torch.runtime import fault_tolerance as tft  # noqa: E402

ARCH = "mamba2-2.7b"
CONV_TILE = 8
B, S = 2, 64  # S = 2 loss chunks of the smoke config (loss_chunk 32)


def _cfgs(dtype, chunk=16, pallas=True):
    """The smoke config on both sides: compute dtype ``dtype``, SSD chunk
    ``chunk``, the conv on the kernel at an explicit tile (``pallas``)."""
    jc = jconfigs.get_smoke_config(ARCH)
    tc = tconfigs.get_smoke_config(ARCH)
    jc = dataclasses.replace(jc, compute_dtype=getattr(jnp, dtype), ssm=(
        dataclasses.replace(jc.ssm, pallas_conv=pallas, conv_tile=CONV_TILE,
                            chunk=chunk)))
    tc = dataclasses.replace(tc, compute_dtype=getattr(torch, dtype), ssm=(
        dataclasses.replace(tc.ssm, pallas_conv=pallas, conv_tile=CONV_TILE,
                            chunk=chunk)))
    return jc, tc


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)),
                        tree)


def _batch(vocab, seq=S, batch=B, seed=0, step=0):
    return JTokenPipeline(JDataConfig(vocab=vocab, seq_len=seq,
                                      global_batch=batch,
                                      seed=seed)).batch_at(step)


def _port_grads(model) -> dict:
    """The port's gradients as the reference's tree (layers stacked)."""
    out: dict = {"embed": {}, "layers": {}}
    for path, _ in flatten_tree(tssm.ssm_param_specs(model.cfg)):
        group, leaf = path.split(".")
        if group == "embed":
            out["embed"][leaf] = getattr(model.embed, leaf).grad.numpy()
        else:
            out["layers"][leaf] = np.stack(
                [getattr(b, leaf).grad.numpy() for b in model.layers])
    return out


def _grad_close(got, want, dtype):
    """Per leaf, within the band of ``dtype`` (module docstring)."""
    for (path, g), (_, w) in zip(flatten_tree(got), flatten_tree(want)):
        scale = float(np.abs(w).max())
        r = 1e-5 if dtype == "float32" else 2.0 ** -6
        np.testing.assert_allclose(g, w, rtol=r, atol=r * scale,
                                   err_msg=path)


def _loss_tol(dtype):
    return dict(rtol=1e-6 if dtype == "float32" else 2.0 ** -7)


# -- chunked cross-entropy ----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq,loss_chunk,vocab", [
    (24, 32, 250),   # one chunk (s <= loss_chunk), padded vocabulary
    (64, 16, 256),   # four chunks, no padding
    (48, 16, 250),   # three chunks, padded vocabulary
    (40, 16, 250),   # s not a multiple of the chunk: one chunk
])
def test_chunked_xent_matches_reference(dtype, seq, loss_chunk, vocab):
    """Value and gradients (x, the tied embedding) against
    ``jax.value_and_grad``, with a mask that has zeros."""
    jc = dataclasses.replace(jconfigs.get_smoke_config(ARCH), vocab=vocab,
                             loss_chunk=loss_chunk,
                             compute_dtype=getattr(jnp, dtype))
    tc = dataclasses.replace(tconfigs.get_smoke_config(ARCH), vocab=vocab,
                             loss_chunk=loss_chunk,
                             compute_dtype=getattr(torch, dtype))
    assert tc.vocab_padded == 256
    rng = np.random.default_rng(seq + vocab)
    d = tc.d_model
    x = rng.standard_normal((B, seq, d)).astype(np.float32)
    emb = (rng.standard_normal((256, d)) * 0.5).astype(np.float32)
    tgt = rng.integers(0, vocab, (B, seq)).astype(np.int32)
    mask = (rng.random((B, seq)) > 0.25).astype(np.float32)
    assert (mask == 0).any()

    def jloss(x_, e_):
        return jlayers.chunked_xent(jc, {"embedding": e_}, x_,
                                    jnp.asarray(tgt), jnp.asarray(mask))

    jx = jnp.asarray(x, getattr(jnp, dtype))
    jl, (jgx, jge) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jx, jnp.asarray(emb))
    tx = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_()
    te = torch.tensor(emb).requires_grad_()
    tl = tlayers.chunked_xent(tc, {"embedding": te}, tx,
                              torch.tensor(tgt).long(), torch.tensor(mask))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), **_loss_tol(dtype))
    _grad_close({"x": tx.grad.float().numpy(), "e": te.grad.numpy()},
                {"x": _np(jgx), "e": _np(jge)}, dtype)


# -- ssm_loss -------------------------------------------------------------------


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def loss_run(request):
    """``jax.value_and_grad(jssm.ssm_loss)`` and the port's loss and
    gradients on the same parameters and batch."""
    dtype = request.param
    jc, tc = _cfgs(dtype)
    params = j_get_model(jc).init(jax.random.PRNGKey(1))
    batch = _batch(jc.vocab)
    jl, jg = jax.value_and_grad(
        lambda p: jssm.ssm_loss(jc, p, jax.tree.map(jnp.asarray, batch))
    )(params)
    model = convert.params_from_reference(_np(params), tc, device="cpu")
    tl = t_get_model(tc, device="cpu").loss(model, batch)
    tl.backward()
    return dict(dtype=dtype, jl=float(jl), jg=_np(jg), tl=tl,
                tg=_port_grads(model))


def test_ssm_loss_matches_reference(loss_run):
    assert loss_run["tl"].dtype == torch.float32 and loss_run["tl"].ndim == 0
    np.testing.assert_allclose(float(loss_run["tl"]), loss_run["jl"],
                               **_loss_tol(loss_run["dtype"]))


def test_ssm_loss_gradients_match_reference(loss_run):
    """Every leaf's gradient, the conv's custom VJP and the one-hot
    embedding gradient included."""
    assert (sorted(p for p, _ in flatten_tree(loss_run["tg"]))
            == sorted(p for p, _ in flatten_tree(loss_run["jg"])))
    _grad_close(loss_run["tg"], loss_run["jg"], loss_run["dtype"])


def test_embedding_gradient_is_the_one_hot_dot():
    """Under autograd a multi-token lookup's table gradient is
    ``onehotᵀ · g`` in bf16 (summed in f32, rounded once), not a bf16
    scatter-add; serving's gather gives the same values."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                              compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(3)
    table = torch.tensor(rng.standard_normal((256, 64)).astype(np.float32),
                         requires_grad=True)
    tokens = torch.ones((2, 300), dtype=torch.long)  # one token, 600 times
    tokens[0, ::7] = 5
    g = torch.tensor(rng.standard_normal((2, 300, 64)).astype(np.float32))
    g = g.to(torch.bfloat16)
    out = tlayers.embed_tokens(cfg, {"embedding": table}, tokens)
    with torch.no_grad():
        assert torch.equal(
            out, tlayers.embed_tokens(cfg, {"embedding": table}, tokens))
    out.backward(g)
    gf = g.float().reshape(-1, 64).numpy()
    flat = tokens.reshape(-1).numpy()
    for tok in (1, 5):
        want = gf[flat == tok].sum(0, dtype=np.float64)
        want = torch.tensor(want, dtype=torch.float32).to(torch.bfloat16)
        got = table.grad[tok].to(torch.bfloat16)
        # f32 sums of bf16 values in another order: one bf16 ulp at most.
        assert torch.allclose(got.float(), want.float(), rtol=2.0 ** -8,
                              atol=0)
    assert not table.grad[[0, 2, 3]].any()


# -- the NaN repair at chunk 128 ------------------------------------------------


@pytest.fixture(scope="module")
def chunk128():
    """Mamba2-2.7B's own chunk length (128) over a 128-token batch, f32."""
    jc, tc = _cfgs("float32", chunk=128)
    jc16, _ = _cfgs("float32", chunk=16)
    params = j_get_model(jc).init(jax.random.PRNGKey(2))
    batch = _batch(jc.vocab, seq=128)
    jb = jax.tree.map(jnp.asarray, batch)
    out = {}
    for name, c in (("j128", jc), ("j16", jc16)):
        loss, g = jax.value_and_grad(lambda p: jssm.ssm_loss(c, p, jb))(
            params)
        out[name] = (float(loss), _np(g))
    model = convert.params_from_reference(_np(params), tc, device="cpu")
    tl = t_get_model(tc, device="cpu").loss(model, batch)
    tl.backward()
    out["t128"] = (float(tl), _port_grads(model))
    with torch.no_grad():
        out["t_x"] = tssm.ssm_forward(
            tc, model, torch.tensor(batch["tokens"]).long(), 0)[0].numpy()
    out["j_x"] = np.asarray(jssm.ssm_forward(jc, params, jb["tokens"],
                                             jnp.int32(0))[0])
    return out


def test_reference_gradient_is_nan_at_chunk_128(chunk128):
    """The reference's ``where(tri, exp(diff), 0)`` overflows above the
    diagonal and its gradient is 0 · inf = NaN (``ROADMAP.md`` queue C);
    the port's gradients are finite."""
    jg = dict(flatten_tree(chunk128["j128"][1]))
    assert not np.isfinite(jg["embed.embedding"]).all()
    assert not np.isfinite(jg["layers.w_zx"]).all()
    assert np.isfinite(chunk128["j128"][0])
    for path, g in flatten_tree(chunk128["t128"][1]):
        assert np.isfinite(g).all(), path


def test_port_gradient_at_chunk_128_equals_reference_at_chunk_16(chunk128):
    for (path, g), (_, w) in zip(flatten_tree(chunk128["t128"][1]),
                                 flatten_tree(chunk128["j16"][1])):
        assert np.isfinite(w).all(), path
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=path)


def test_port_forward_at_chunk_128_equals_reference(chunk128):
    np.testing.assert_allclose(chunk128["t128"][0], chunk128["j128"][0],
                               rtol=1e-6)
    np.testing.assert_allclose(chunk128["t_x"], chunk128["j_x"], rtol=1e-5,
                               atol=1e-5)


# -- AdamW ------------------------------------------------------------------


def _opt_inputs(n_steps, seed=0):
    """Reference parameters of the smoke config (f32) and ``n_steps``
    gradient trees; step 1's is large enough to be clipped."""
    jc, tc = _cfgs("float32")
    params = _np(j_get_model(jc).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    grads = []
    for i in range(n_steps):
        s = 10.0 if i == 1 else 0.01
        grads.append(jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * s).astype(np.float32),
            params))
    return jc, tc, params, grads


OPT = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=1.0,
           weight_decay=0.1)


def _unstack(tree, tc):
    """``{port name: tensor}`` from a reference-shaped numpy tree."""
    return {k: v for k, v in convert.opt_state_from_reference(
        {"m": tree, "v": tree, "count": np.int32(0)}, tc, "cpu")["m"].items()}


def test_adamw_update_matches_reference_over_steps():
    """Five steps on the port's per-layer tree against the reference on
    its stacked tree: warm-up, cosine decay, one clipped step, and decay on
    the stacked 1-D leaves (``ln``, ``D``, ...) but not ``final_norm``."""
    jc, tc, params, grads = _opt_inputs(5)
    jcfg, tcfg = JOptConfig(**OPT), OptConfig(**OPT)
    jp = jax.tree.map(jnp.asarray, params)
    jo = j_adamw_init(jp)
    model = convert.params_from_reference(params, tc, device="cpu")
    named = dict(model.named_parameters())
    to = adamw_init(named)
    decay = decay_mask(named, tssm.ssm_param_specs(tc))
    for g in grads:
        jp, jo, jm = j_adamw_update(jcfg, jax.tree.map(jnp.asarray, g), jo,
                                    jp)
        _, to, tm = adamw_update(tcfg, _unstack(g, tc), to, named, decay)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=4e-7)
    assert float(jm["grad_norm"]) > 0 and int(to["count"]) == 5
    assert to["count"].dtype == torch.int32
    got = {"p": convert.params_to_reference(model),
           **convert.opt_state_to_reference(to)}
    want = {"p": _np(jp), "m": _np(jo["m"]), "v": _np(jo["v"]),
            "count": np.asarray(jo["count"])}
    assert int(got["count"]) == int(want["count"])
    for (path, a), (_, b) in zip(flatten_tree({k: got[k] for k in "pmv"}),
                                 flatten_tree({k: want[k] for k in "pmv"})):
        np.testing.assert_allclose(a, b, rtol=4e-7,
                                   atol=2e-6 * float(np.abs(b).max()),
                                   err_msg=path)


def test_adamw_on_the_stacked_tree():
    """On the reference's stacked tree itself (``decay_mask`` of its names,
    ``layers.<leaf>``, is the reference's ``p.ndim > 1`` there)."""
    _, tc, params, grads = _opt_inputs(3, seed=1)
    cfg = dict(OPT, weight_decay=0.5)
    jp = jax.tree.map(jnp.asarray, params)
    jo = j_adamw_init(jp)
    tp = {p: torch.tensor(a) for p, a in flatten_tree(params)}
    to = adamw_init(tp)
    decay = decay_mask(tp, tssm.ssm_param_specs(tc))
    assert decay == {p: a.ndim > 1 for p, a in tp.items()}
    for g in grads:
        jp, jo, _ = j_adamw_update(JOptConfig(**cfg),
                                   jax.tree.map(jnp.asarray, g), jo, jp)
        _, to, _ = adamw_update(
            OptConfig(**cfg),
            {p: torch.tensor(a) for p, a in flatten_tree(g)}, to, tp, decay)
    for path, want in flatten_tree(_np(jp)):
        np.testing.assert_allclose(tp[path].numpy(), want, rtol=4e-7,
                                   atol=2e-6 * float(np.abs(want).max()),
                                   err_msg=path)


def test_decay_mask_follows_the_reference_spec_rank():
    """The port's 1-D per-layer leaves are decayed (stacked (L, ·) in the
    reference), ``embed.final_norm`` is not; deciding by the port's tensor
    rank would leave six leaves a layer undecayed."""
    tc = tconfigs.get_smoke_config(ARCH)
    model = t_get_model(tc, device="cpu").init(0)
    named = dict(model.named_parameters())
    mask = decay_mask(named, tssm.ssm_param_specs(tc))
    assert mask["embed.final_norm"] is False
    assert mask["embed.embedding"] is True
    for leaf in ("ln", "dt_bias", "A_log", "D", "conv_b", "norm_w",
                 "w_zx", "conv_w"):
        assert mask[f"layers.3.{leaf}"] is True, leaf
        assert named[f"layers.3.{leaf}"].ndim >= 1
    assert sum(not mask[k] and named[k].ndim > 1 for k in mask) == 0
    assert sum(mask[k] and named[k].ndim == 1 for k in mask) == 6 * 4


def test_cosine_schedule_and_global_norm_match_reference():
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 37, 50, 99, 100, 140):
        want = float(j_cosine(JOptConfig(**cfg), jnp.int32(step)))
        got = float(cosine_schedule(OptConfig(**cfg),
                                    torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=4e-7, atol=1e-12)
    rng = np.random.default_rng(5)
    tree = {f"l{i}": rng.standard_normal((7, 13)).astype(np.float32)
            for i in range(6)}
    np.testing.assert_allclose(
        float(global_norm({k: torch.tensor(v) for k, v in tree.items()})),
        float(j_global_norm(jax.tree.map(jnp.asarray, tree))), rtol=1e-6)


def test_opt_state_specs_match_reference():
    jc, tc = _cfgs("float32")
    want = j_opt_state_specs(jssm.ssm_param_specs(jc))
    got = opt_state_specs(tssm.ssm_param_specs(tc))
    is_spec = lambda x: type(x).__name__ == "ParamSpec"  # noqa: E731
    jl = jax.tree_util.tree_flatten_with_path(want, is_leaf=is_spec)[0]
    want_t = {"/".join(str(getattr(k, "key", k)) for k in path):
              (s.shape, s.axes, jnp.dtype(s.dtype).name) for path, s in jl}
    got_t = {}
    for k in ("m", "v"):
        for path, s in flatten_tree(got[k]):
            got_t[f"{k}/{path.replace('.', '/')}"] = (
                s.shape, s.axes, str(s.dtype).split(".")[-1])
    got_t["count"] = ((), (), str(got["count"].dtype).split(".")[-1])
    assert got_t == want_t


# -- compression ------------------------------------------------------------


def _oracles(g):
    """``(codes, scale)`` of the quantize, per worker (axis 0), in numpy:
    the IEEE quotients the port takes (``max|g| / 127``, ``g / scale``),
    and the reciprocal products that JAX's jitted code computes on the CPU
    (``max|g| · (1/127)``, ``g · (1/scale)``)."""
    shape = (g.shape[0],) + (1,) * (g.ndim - 1)
    amax = np.maximum(np.abs(g).reshape(g.shape[0], -1).max(1),
                      np.float32(1e-12)).reshape(shape)
    ieee_s = (amax / np.float32(127)).astype(np.float32)
    recip_s = (amax * (np.float32(1) / np.float32(127))).astype(np.float32)
    ieee = np.clip(np.round(g / ieee_s), -127, 127)
    recip = np.clip(np.round(g * (np.float32(1) / recip_s)), -127, 127)
    return (ieee, ieee_s), (recip, recip_s)


def test_quantize_matches_reference():
    """The port equals the IEEE oracle; the reference run op by op
    equals it too, and jitted equals the reciprocal oracle."""
    rng = np.random.default_rng(6)
    jitted = jax.jit(j_quantize)
    n_differ = 0
    for i in range(32):
        g = (rng.standard_normal(4000) * 10.0 ** (i % 8 - 4)).astype(
            np.float32)
        (ieee, ieee_s), (recip, recip_s) = _oracles(g[None])
        tq, ts = _quantize(torch.tensor(g))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert float(ts) == float(ieee_s[0, 0])
        assert np.array_equal(tq.numpy(), ieee[0])
        jq, js = j_quantize(jnp.asarray(g))
        assert float(js) == float(ts) and np.array_equal(jq, tq.numpy())
        jq, js = jitted(jnp.asarray(g))
        assert float(js) == float(recip_s[0, 0])
        assert np.array_equal(np.asarray(jq), recip[0])
        n_differ += int((recip != ieee).sum() + (recip_s != ieee_s).sum())
    assert n_differ > 0  # the two rules do meet different roundings here


@pytest.mark.parametrize("with_residual", [False, True])
def test_compressed_mean_matches_shard_map(with_residual):
    """Four workers: the reference under ``shard_map`` on the 4-device CPU
    mesh (``tests/conftest.py``), the port over a list of 4 gradient
    mappings.  Each side's residuals equal its own oracle
    (:func:`_oracles`) exactly; the means agree within two f32 ulps (the
    scales may differ by an ulp, and ``psum`` adds them in its own
    order)."""
    rng = np.random.default_rng(7)
    g = {"a": (rng.standard_normal((4, 300, 7))
               * rng.uniform(0.1, 3.0, (4, 1, 1))).astype(np.float32),
         "b": rng.standard_normal((4, 50)).astype(np.float32)}
    r = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32)
         for k, v in g.items()}
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    if with_residual:
        fn = jax.shard_map(lambda g_, r_: j_compressed(g_, r_, "data"),
                           mesh=mesh, in_specs=(P("data"), P("data")),
                           out_specs=(P("data"), P("data")))
        jm, jr = jax.jit(fn)(g, r)
    else:
        fn = jax.shard_map(lambda g_: j_compressed(g_, None, "data"),
                           mesh=mesh, in_specs=(P("data"),),
                           out_specs=(P("data"), P("data")))
        jm, jr = jax.jit(fn)(g)
    per = [{k: torch.tensor(v[w:w + 1]) for k, v in g.items()}
           for w in range(4)]
    res = ([{k: torch.tensor(v[w:w + 1]) for k, v in r.items()}
            for w in range(4)] if with_residual else None)
    tm, tr = compressed_mean(per, res)
    for k in g:
        gm = np.concatenate([tm[w][k].numpy() for w in range(4)])
        gr = np.concatenate([tr[w][k].numpy() for w in range(4)])
        gg = g[k] + r[k] if with_residual else g[k]
        (ieee, ieee_s), (recip, recip_s) = _oracles(gg)
        assert np.array_equal(gr, gg - ieee.astype(np.float32) * ieee_s), k
        assert np.array_equal(np.asarray(jr[k]),
                              gg - recip.astype(np.float32) * recip_s), k
        total = ieee.sum(0)
        s_sum = ieee_s[0] + ieee_s[1] + ieee_s[2] + ieee_s[3]
        want = (total * (s_sum / np.float32(4)) / np.float32(4)).astype(
            np.float32)
        assert all(np.array_equal(gm[w], want) for w in range(4)), k
        np.testing.assert_allclose(gm, np.asarray(jm[k]), rtol=2.4e-7,
                                   atol=0, err_msg=k)


# -- data pipeline and fault tolerance -----------------------------------------


@pytest.mark.parametrize("backend", ["synthetic", "memmap"])
@pytest.mark.parametrize("host_count", [1, 2, 4])
def test_pipeline_batches_equal_reference(tmp_path, backend, host_count):
    """``batch_at`` equals the reference bit for bit on every host slice;
    the memmap backend reads a token file written here."""
    path = None
    if backend == "memmap":
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(8).integers(0, 1000, 5000).astype(
            np.uint32).tofile(path)
    for rank in range(host_count):
        kw = dict(vocab=1000, seq_len=33, global_batch=8, seed=3,
                  backend=backend, path=path, host_rank=rank,
                  host_count=host_count)
        jp, tp = JTokenPipeline(JDataConfig(**kw)), TokenPipeline(
            DataConfig(**kw))
        for step in (0, 1, 17):
            want, got = jp.batch_at(step), tp.batch_at(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                assert np.array_equal(got[k], want[k]), (k, step)


def test_memmap_backend_needs_a_file():
    with pytest.raises(ValueError, match="token file"):
        TokenPipeline(DataConfig(vocab=10, seq_len=4, global_batch=2,
                                 backend="memmap"))


def test_cluster_monitor_gives_the_reference_actions():
    """A scripted heartbeat sequence (steady hosts, a straggler, a dead
    host, with and without spares) through both monitors."""
    script = []
    t = 0.0
    for step in range(12):
        t += 1.0
        for host in range(4):
            if host == 3 and step >= 6:
                continue  # host 3 stops reporting
            lag = 2.5 if (host == 2 and step in (8, 9)) else 0.0
            script.append((host, step, t + lag))
    for spares in (0, 1):
        jm = jft.ClusterMonitor(policy=jft.StragglerPolicy(
            spare_hosts=spares))
        tm = tft.ClusterMonitor(policy=tft.StragglerPolicy(
            spare_hosts=spares))
        got = [tm.tick(h, s, t).value for h, s, t in script]
        want = [jm.tick(h, s, t).value for h, s, t in script]
        assert got == want
        assert {"continue", "restart_from_ckpt" if spares == 0
                else "evict"} <= set(got)
    assert (dataclasses.asdict(tft.plan_elastic_remesh(64, 16))
            == dataclasses.asdict(jft.plan_elastic_remesh(64, 16)))
    assert (tft.StragglerPolicy().checkpoint_interval(0.5)
            == jft.StragglerPolicy().checkpoint_interval(0.5))


def test_reference_mesh_axes_are_explicit_and_constrain_rejects_them():
    """The cause of the reference's three failures under jax 0.9.0
    (``test_sharding.py::test_constrain_with_mesh`` and
    ``test_train_integration.py``'s two): ``make_test_mesh``'s
    ``jax.make_mesh`` makes ``Explicit`` axes, and
    ``with_sharding_constraint`` takes only ``Auto`` axes.  Hence the
    tests here hold the port to the reference's step function outside a
    mesh, not to ``repro.launch.train.main``."""
    from jax.sharding import AxisType

    from repro.launch.mesh import make_test_mesh
    from repro.parallel.sharding import activate_mesh, constrain

    mesh = make_test_mesh()
    assert all(t == AxisType.Explicit for t in mesh.axis_types)
    with activate_mesh(mesh), pytest.raises(ValueError, match="Auto axes"):
        constrain(jnp.ones((4, 4)), ("batch", ""))


# -- conversion and checkpoints ------------------------------------------------


def test_params_and_opt_state_round_trip_to_the_reference():
    jc, tc = _cfgs("float32")
    params = _np(j_get_model(jc).init(jax.random.PRNGKey(4)))
    model = convert.params_from_reference(params, tc, device="cpu")
    back = convert.params_to_reference(model)
    for (p, a), (_, b) in zip(flatten_tree(back), flatten_tree(params)):
        assert a.dtype == np.float32 and np.array_equal(a, b), p
    opt = {"m": params, "v": jax.tree.map(lambda a: a * 2, params),
           "count": np.int32(7)}
    state = convert.opt_state_from_reference(opt, tc, device="cpu")
    assert set(state["m"]) == {n for n, _ in model.named_parameters()}
    again = convert.opt_state_to_reference(state)
    assert again["count"].dtype == np.int32 and int(again["count"]) == 7
    for (p, a), (_, b) in zip(flatten_tree({"m": again["m"],
                                            "v": again["v"]}),
                              flatten_tree({"m": opt["m"], "v": opt["v"]})):
        assert np.array_equal(a, b), p


def _jax_step(jc, opt_cfg):
    """The reference's step function (``repro/launch/train.py:71-76``)."""
    jm = j_get_model(jc)

    @jax.jit
    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jm.loss)(params, batch)
        new_p, new_o, metrics = j_adamw_update(opt_cfg, grads, opt_state,
                                               params)
        metrics["loss"] = loss
        return new_p, new_o, metrics

    return jm, step


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """Two reference steps saved by the JAX ``Checkpointer``; the port
    restores them and takes the third step, which equals the reference's
    third within the f32 band."""
    jc, tc = _cfgs("float32", pallas=False)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jm, jstep = _jax_step(jc, JOptConfig(**ocfg))
    params = jm.init(jax.random.PRNGKey(5))
    opt = j_adamw_init(params)
    data = JTokenPipeline(JDataConfig(vocab=jc.vocab, seq_len=32,
                                      global_batch=2))
    for step in range(2):
        params, opt, _ = jstep(params, opt,
                               jax.tree.map(jnp.asarray, data.batch_at(step)))
    JCheckpointer(JCkptConfig(str(tmp_path))).save(2, (params, opt))
    params, opt, jmet = jstep(params, opt,
                              jax.tree.map(jnp.asarray, data.batch_at(2)))

    model = t_get_model(tc, device="cpu")
    tparams = model.init(0)
    state, step = ttrain.restore_state(
        Checkpointer(CheckpointConfig(str(tmp_path))), model, tparams)
    assert step == 2 and int(state["count"]) == 2
    tparams, state, tmet = ttrain.train_step(
        model, tparams, state, data.batch_at(2), OptConfig(**ocfg))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    got = convert.params_to_reference(tparams)
    for (p, a), (_, b) in zip(flatten_tree(got), flatten_tree(_np(params))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=p)
    assert int(state["count"]) == int(opt["count"]) == 3


def test_port_checkpoint_restores_with_the_reference(tmp_path):
    """A port checkpoint (async save, then ``wait``) read by the JAX
    ``Checkpointer.restore`` into the reference's own tree: every leaf
    exact, and the same files and manifest keys."""
    jc, tc = _cfgs("float32", pallas=False)
    model = t_get_model(tc, device="cpu")
    tparams = model.init(3)
    state = adamw_init(dict(tparams.named_parameters()))
    batch = _batch(tc.vocab, seq=32)
    for _ in range(2):
        tparams, state, _ = ttrain.train_step(model, tparams, state, batch,
                                              OptConfig(lr=1e-3))
    ck = Checkpointer(CheckpointConfig(str(tmp_path), keep=1))
    ttrain.save_state(ck, 1, tparams, state, blocking=False)
    ck.wait()
    ttrain.save_state(ck, 2, tparams, state, blocking=False)
    ck.wait()
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_2"]
    assert (tmp_path / "LATEST").read_text() == "2"
    like = j_get_model(jc).init(jax.random.PRNGKey(0))
    (jp, jo), step = JCheckpointer(JCkptConfig(str(tmp_path))).restore(
        (like, j_adamw_init(like)))
    assert step == 2
    want_p = convert.params_to_reference(tparams)
    want_o = convert.opt_state_to_reference(state)
    for (p, a), (_, b) in zip(flatten_tree(jp), flatten_tree(want_p)):
        assert a.dtype == b.dtype and np.array_equal(a, b), p
    for k in ("m", "v"):
        for (p, a), (_, b) in zip(flatten_tree(jo[k]),
                                  flatten_tree(want_o[k])):
            assert np.array_equal(a, b), (k, p)
    assert jo["count"].dtype == np.int32 and int(jo["count"]) == 2
    manifest = json.loads((tmp_path / "step_2" / "manifest.json").read_text())
    assert "0/layers/w_zx" in manifest["leaves"]
    assert manifest["leaves"]["1/count"]["shape"] == []


# -- the trainer --------------------------------------------------------------


def test_train_cli_lowers_the_loss_over_30_steps(capsys):
    losses = ttrain.main(["--smoke", "--device", "cpu", "--steps", "30",
                          "--lr", "3e-3", "--log-every", "10"])
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05
    assert "improved" in capsys.readouterr().out


def test_train_resume_equals_the_uninterrupted_run(tmp_path, capsys):
    """A run resumed from a step-4 checkpoint runs only steps 4-7, and its
    losses and final checkpoint equal the uninterrupted run's bit for
    bit."""
    args = ["--smoke", "--device", "cpu", "--steps", "8", "--ckpt-every",
            "4", "--batch", "4", "--seq", "64", "--lr", "3e-3"]
    full, part = tmp_path / "full", tmp_path / "part"
    want = ttrain.main(args + ["--ckpt-dir", str(full)])
    part.mkdir()
    shutil.copytree(full / "step_4", part / "step_4")
    (part / "LATEST").write_text("4")
    got = ttrain.main(args + ["--ckpt-dir", str(part)])
    assert "resumed from step 4" in capsys.readouterr().out
    assert len(got) == 4 and got == want[4:]
    files = sorted(p.name for p in (full / "step_8").iterdir())
    assert files == sorted(p.name for p in (part / "step_8").iterdir())
    for name in files:
        if name.endswith(".npy"):
            assert np.array_equal(np.load(full / "step_8" / name),
                                  np.load(part / "step_8" / name)), name


def test_train_step_runs_the_conv_kernels_wrapper_twice_per_layer(
        monkeypatch):
    """With the conv on the kernel and per-layer checkpointing, a step
    calls the kernel's wrapper twice a layer: the forward and its
    recompute before the backward (on the card, 2 × 64 launches for
    Mamba2-2.7B)."""
    from repro_torch.kernels import conv1d

    _, tc = _cfgs("bfloat16")
    assert tc.remat
    calls = []
    real = conv1d.causal_conv1d_launch
    monkeypatch.setattr(conv1d, "causal_conv1d_launch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = t_get_model(tc, device="cpu")
    params = model.init(0)
    state = adamw_init(dict(params.named_parameters()))
    _, _, met = ttrain.train_step(model, params, state, _batch(tc.vocab),
                                  OptConfig())
    assert len(calls) == 2 * tc.n_layers
    assert np.isfinite(float(met["loss"]))
    assert all(p.grad is None for p in params.parameters())


def test_trainer_without_cpu_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--smoke", "--steps", "1"])
