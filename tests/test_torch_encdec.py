"""The port's encoder-decoder (``whisper-large-v3``) against the JAX
package, on the CPU.

The smoke config (2 encoder and 2 decoder layers, 4 heads of 16 with QKV
bias, 12 frames) runs on both sides, as published (bf16 compute) and in
f32 (compute and parameters).  The reference's parameters are carried
across with ``convert.params_from_reference``; tokens and frames are made
with numpy.  The reference runs outside a mesh.  Tolerances, as
``test_torch_transformer.py`` states them: f32 ``atol = rtol = 1e-5``;
bf16 two bf16 ulps of the result's scale; the loss within ``rtol =
1e-6`` (f32) or two bf16 ulps; each gradient leaf within ``1e-5`` (f32)
or ``2**-6`` (bf16) of its scale, or in bf16 no further from the
reference's f32 gradient than twice the reference's bf16 one is (the
score path's nearly cancelling sums); the key biases' gradients, zero in
exact arithmetic, zero within the band of the value biases'; the cache's
integer leaves exactly.  The tanh gelu is held to ``jax.nn.gelu`` in f32
within 2 ulps (``rtol = 2**-22``) and ``1e-6`` absolute: in the negative
tail (x < -5, where gelu is under 1e-6 in magnitude) ATen's tanh stops
short of -1 where XLA's reaches it (5.4e-7 at x = -6).  In bf16 within
one bf16 ulp (``2**-7 · |gelu|``), and ``2**-8 · |x|`` more for x < 0:
jax evaluates the tanh form op by op in bf16 (``1 + tanh`` rounds to 0
in the negative tail, ``x · cdf`` rounds again) where the port
evaluates in f32 and rounds once.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import count_params as j_count_params  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import count_params as t_count_params  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import get_model as t_get_model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.layers import flatten_tree  # noqa: E402

from test_torch_transformer import (  # noqa: E402
    _close,
    _grad_close,
    _jspec_table,
    _np,
    _spec_table,
    _t,
)

ARCH = "whisper-large-v3"
B, S, N_DECODE = 2, 21, 5  # 21: not a multiple of q_chunk (16)


def _cfgs(dtype):
    jc = jconfigs.get_smoke_config(ARCH)
    tc = tconfigs.get_smoke_config(ARCH)
    if dtype == "float32":
        jc = dataclasses.replace(jc, compute_dtype=jnp.float32,
                                 param_dtype=jnp.float32)
        tc = dataclasses.replace(tc, compute_dtype=torch.float32,
                                 param_dtype=torch.float32)
    return jc, tc


def _frames(cfg, seed=5):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def run(request):
    """The reference's parameters, the port's copy, and the reference's
    prefill, five decode steps and final cache."""
    dtype = request.param
    jc, tc = _cfgs(dtype)
    jm = j_get_model(jc)
    params = jm.init(jax.random.PRNGKey(1))
    params_np = _np(params)
    toks = np.random.default_rng(0).integers(
        0, jc.vocab, (B, S + N_DECODE)).astype(np.int32)
    frames = _frames(jc)
    max_len = S + N_DECODE + 3  # three slots stay unwritten
    batch = {"tokens": jnp.asarray(toks[:, :S]),
             "frames": jnp.asarray(frames).astype(jc.compute_dtype)}
    logits, cache = jm.prefill(params, batch, jm.init_cache(B, max_len))
    prefill_cache = _np(cache)
    decode = []
    for i in range(N_DECODE):
        lg, cache = jm.decode_step(params, cache,
                                   jnp.asarray(toks[:, S + i:S + i + 1]),
                                   jnp.int32(S + i))
        decode.append(_np(lg))
    return dict(
        dtype=dtype, jc=jc, tc=tc, params=params, params_np=params_np,
        toks=toks, frames=frames, max_len=max_len,
        prefill_logits=_np(logits), prefill_cache=prefill_cache,
        decode=decode, cache=_np(cache),
        model=convert.params_from_reference(params_np, tc, device="cpu"),
    )


def _port_serve(run):
    tc, toks = run["tc"], run["toks"]
    tm = t_get_model(tc, device="cpu")
    cache = tm.init_cache(B, run["max_len"])
    logits, cache = tm.prefill(run["model"], {"tokens": toks[:, :S],
                                              "frames": run["frames"]}, cache)
    decode = []
    for i in range(N_DECODE):
        lg, cache = tm.decode_step(run["model"], cache,
                                   toks[:, S + i:S + i + 1], S + i)
        decode.append(lg.float().numpy())
    return logits.float().numpy(), decode, cache


# -- configs and parameters ---------------------------------------------------


@pytest.mark.parametrize("kind", ["full", "smoke"])
def test_config_and_param_specs_match_reference(kind):
    get = "get_config" if kind == "full" else "get_smoke_config"
    jc = getattr(jconfigs, get)(ARCH)
    tc = getattr(tconfigs, get)(ARCH)
    for f in dataclasses.fields(tc):
        a, b = getattr(tc, f.name), getattr(jc, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            assert str(a).split(".")[-1] == jnp.dtype(b).name, f.name
        elif f.name not in ("ssm", "moe"):
            assert a == b, f.name
    assert (_spec_table(ted.encdec_param_specs(tc))
            == _jspec_table(jed.encdec_param_specs(jc)))
    for active in (False, True):
        assert (t_count_params(tc, active_only=active)
                == j_count_params(jc, active_only=active))
    if kind == "full":
        assert t_count_params(tc) == 1_535_101_440


def test_params_from_reference_round_trip(run):
    model = run["model"]
    assert len(model.enc_layers) == run["tc"].enc_layers
    assert len(model.dec_layers) == run["tc"].n_layers
    back = convert.params_to_reference(model)
    assert ([p for p, _ in flatten_tree(back)]
            == [p for p, _ in flatten_tree(run["params_np"])])
    for (path, a), (_, b) in zip(flatten_tree(back),
                                 flatten_tree(run["params_np"])):
        assert np.array_equal(a, b), path


def test_init_cache_matches_reference(run):
    want = _np(j_get_model(run["jc"]).init_cache(B, run["max_len"]))
    got = _t(t_get_model(run["tc"], device="cpu").init_cache(
        B, run["max_len"]))
    assert [p for p, _ in flatten_tree(got)] == [
        p for p, _ in flatten_tree(want)]
    for (path, a), (_, b) in zip(flatten_tree(got), flatten_tree(want)):
        assert a.shape == b.shape and np.array_equal(a, b), path


def test_init_lays_out_the_reference_tree():
    """Ones on the 1-D leaves (``final_norm``, ``enc_norm``), N(0, 0.02²)
    on the rest, the stacked norms included."""
    _, tc = _cfgs("float32")
    model = t_get_model(tc, device="cpu").init(0)
    for name, p in model.named_parameters():
        if name in ("embed.final_norm", "enc_norm"):
            assert bool(torch.all(p == 1)), name
        else:
            assert abs(float(p.detach().std()) - 0.02) < 0.01, name


# -- blocks -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_is_the_tanh_form_of_jax(dtype):
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x, jd)).astype(jnp.float32))
    got = tlayers.gelu(torch.tensor(x).to(td)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2.0 ** -22, atol=1e-6)
    else:
        band = 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * np.maximum(-x, 0)
        assert (np.abs(got - want) <= band).all()
    # torch's default, the erf form, is another function: 4e-4 off at 3.
    exact = torch.nn.functional.gelu(torch.tensor(3.0))
    assert abs(float(exact) - float(jax.nn.gelu(3.0))) > 3e-4


def _attn_params(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s.shape) * 0.2).astype(np.float32)
            for k, s in tlayers.attention_param_specs(cfg).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype):
    """Cross-attention from ``x_kv`` (train, prefill) and at decode from
    the precomputed cache ``{'k', 'v'}``: non-causal, no rope, keys at
    ``arange(F)``; both equal the reference's, and the cached call equals
    the one from ``x_kv``."""
    jc, tc = _cfgs(dtype)
    jc = dataclasses.replace(jc, compute_dtype=getattr(jnp, dtype))
    tc = dataclasses.replace(tc, compute_dtype=getattr(torch, dtype))
    p = _attn_params(tc)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 3, tc.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 12, tc.d_model)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: torch.tensor(a) for k, a in p.items()}
    want, wcache = jlayers.attention_block(
        jc, jp, jnp.asarray(x, jd), jnp.int32(7), causal=False,
        x_kv=jnp.asarray(enc, jd), cross=True,
        cache={"k": jnp.zeros(1), "v": jnp.zeros(1)})
    tcache = {"k": None, "v": None}
    got, gcache = tlayers.attention_block(
        tc, tp, torch.tensor(x).to(td), 7, causal=False,
        x_kv=torch.tensor(enc).to(td), cross=True, cache=tcache)
    assert gcache is tcache
    _close(got.float().numpy(), _np(want), dtype, "from x_kv")
    for name in ("k", "v"):
        _close(tcache[name].float().numpy(), _np(wcache[name]), dtype, name)
    # Decode: the precomputed keys and values, no x_kv.
    want2, _ = jlayers.attention_block(
        jc, jp, jnp.asarray(x, jd), jnp.int32(9), causal=False, cross=True,
        cache={"k": wcache["k"], "v": wcache["v"]})
    got2, _ = tlayers.attention_block(
        tc, tp, torch.tensor(x).to(td), 9, causal=False, cross=True,
        cache={"k": tcache["k"], "v": tcache["v"]})
    _close(got2.float().numpy(), _np(want2), dtype, "from the cache")
    assert torch.equal(got2, got)  # no rope: the position does not matter
    # Without a cache.
    got3, none = tlayers.attention_block(tc, tp, torch.tensor(x).to(td), 0,
                                         x_kv=torch.tensor(enc).to(td))
    assert none is None and torch.equal(got3, got)


def test_encode_matches_reference(run):
    dtype = run["dtype"]
    want = jed.encode(run["jc"], run["params"],
                      jnp.asarray(run["frames"]).astype(run["jc"].compute_dtype))
    with torch.no_grad():
        got = ted.encode(run["tc"], run["model"], torch.tensor(run["frames"]))
    _close(got.float().numpy(), _np(want), dtype, "encode")


# -- serving -------------------------------------------------------------------


def test_prefill_and_decode_match_reference(run):
    logits, decode, _ = _port_serve(run)
    _close(logits, run["prefill_logits"], run["dtype"], "prefill")
    for i, (got, want) in enumerate(zip(decode, run["decode"])):
        _close(got, want, run["dtype"], f"decode {i}")


def test_final_cache_matches_reference(run):
    _, _, cache = _port_serve(run)
    got, want = _t(cache), run["cache"]
    for part, name in (("self", "k"), ("self", "v"), ("cross", "k"),
                       ("cross", "v")):
        _close(got[part][name], want[part][name], run["dtype"],
               f"{part}.{name}")
    for name in ("positions", "pos"):
        assert np.array_equal(got["self"][name], want["self"][name]), name
    assert (got["self"]["pos"] == S + N_DECODE).all()


def test_reference_prefill_continued_by_the_port(run):
    cache = convert.cache_from_reference(run["prefill_cache"], run["tc"],
                                         device="cpu")
    tm = t_get_model(run["tc"], device="cpu")
    lg, _ = tm.decode_step(run["model"], cache, run["toks"][:, S:S + 1], S)
    _close(lg.float().numpy(), run["decode"][0], run["dtype"], "decode 0")


def test_decode_matches_teacher_forcing(run):
    """prefill(S) + decode steps against one forward of the whole
    sequence from the encoder output (the f32 band, or the bf16 one)."""
    tc, toks = run["tc"], run["toks"]
    _, decode, _ = _port_serve(run)
    with torch.no_grad():
        enc = ted.encode(tc, run["model"], torch.tensor(run["frames"]))
        x, _ = ted.decode_stack(tc, run["model"], torch.tensor(toks), 0, enc)
        lg = tlayers.unembed(tc, run["model"].embed.tensors(), x)
    want = lg.float().numpy()
    for i, got in enumerate(decode):
        _close(got[:, 0], want[:, S + i], run["dtype"], f"step {i}")


def test_serve_takes_the_frames(run):
    toks, _ = tserve.serve(run["tc"], run["model"], run["toks"][:, :S], 3,
                           device="cpu",
                           frames=torch.tensor(run["frames"]))
    assert tuple(toks.shape) == (B, 3)
    with pytest.raises(ValueError, match="frames"):
        tserve.serve(run["tc"], run["model"], run["toks"][:, :S], 3,
                     device="cpu")


# -- training ------------------------------------------------------------------


def _loss_batch(jc):
    """A batch of 64 tokens and its frames: numpy, and the reference's
    (frames in ``jc``'s compute dtype)."""
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jc.vocab, (B, 65)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
         "mask": np.ones((B, 64), np.float32), "frames": _frames(jc, 6)}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jb["frames"] = jb["frames"].astype(jc.compute_dtype)
    return b, jb


@functools.lru_cache(maxsize=None)
def _reference_loss(dtype):
    """The reference's parameters (key 2), and its loss and gradients
    (jitted, as its trainer takes them) on :func:`_loss_batch`: the f32
    run is both the f32 case and the f32 gradient the bf16 case is held
    to (the smoke's parameters are f32 in both)."""
    jc, _ = _cfgs(dtype)
    jm = j_get_model(jc)
    params = jm.init(jax.random.PRNGKey(2))
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
        params, _loss_batch(jc)[1])
    return params, float(loss), _np(grads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_reference(dtype):
    jc, tc = _cfgs(dtype)
    params, loss, grads = _reference_loss(dtype)
    b, _ = _loss_batch(jc)
    model = convert.params_from_reference(_np(params), tc, device="cpu")
    t_loss = t_get_model(tc, device="cpu").loss(model, b)
    t_loss.backward()
    r = 1e-6 if dtype == "float32" else 2.0 ** -7
    assert float(t_loss.detach()) == pytest.approx(loss, rel=r)

    def grads_f32():
        p32, _, g32 = _reference_loss("float32")
        assert all(np.array_equal(a, w) for a, w in zip(
            jax.tree.leaves(_np(params)), jax.tree.leaves(_np(p32))))
        return g32

    _grad_close(convert._stack({n: p.grad for n, p in
                                model.named_parameters()}),
                grads, dtype, grads_f32)


def test_opt_state_round_trip():
    """The AdamW state crosses both ways over the three stacked groups."""
    from repro_torch.optim import adamw_init

    _, tc = _cfgs("float32")
    model = t_get_model(tc, device="cpu").init(0)
    opt = adamw_init(dict(model.named_parameters()))
    for i, t in enumerate(opt["m"].values()):
        t.fill_(i)
    ref = convert.opt_state_to_reference(opt)
    assert set(ref["m"]) == {"embed", "enc_layers", "enc_norm", "dec_layers"}
    back = convert.opt_state_from_reference(ref, tc, device="cpu")
    for k, t in opt["m"].items():
        assert torch.equal(back["m"][k], t), k
