"""The port's Mamba2 serving path against the JAX package, on the CPU.

The reference's parameters (``init_from_specs`` from a jax key) are carried
across with ``convert.params_from_reference``; token ids are made with
numpy.  Both sides run the smoke config of ``mamba2-2.7b`` with
``pallas_conv=True`` and an explicit ``conv_tile`` (the JAX kernel in
interpret mode, the port's kernel through its plain version with
``device="cpu"``), in f32 and in bf16 compute dtype.  Tolerances:

* f32 compute: ``atol = rtol = 1e-5`` — f32 sums of up to 128 terms
  (matmuls, SSD einsums, norms) run in another order in XLA and ATen, and
  sigmoid/exp differ by about an ulp; observed errors are ~5e-7.
* bf16 compute: two bf16 ulps of the result's scale (``rtol = 2**-7``,
  ``atol = 2**-7 · max|ref|``) — XLA may keep f32 between bf16
  elementwise ops where PyTorch rounds after each, and a matmul's
  accumulation order can move a bf16 result by an ulp, which the later
  layers carry along.

Decode tokens are fixed (teacher tokens), not argmax'd, so a near-tie can
not send the two sides down different paths.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import count_params as j_count_params  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import count_params as t_count_params  # noqa: E402
from repro_torch.models import get_model as t_get_model  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.layers import flatten_tree  # noqa: E402

ARCH = "mamba2-2.7b"
CONV_TILE = 8
B, S, N_DECODE = 2, 21, 4  # S is not a multiple of CONV_TILE or the chunk


def _cfgs(dtype):
    """The smoke config on both sides, compute dtype ``dtype``, with the
    conv routed through the kernel at an explicit tile."""
    jc = jconfigs.get_smoke_config(ARCH)
    tc = tconfigs.get_smoke_config(ARCH)
    jc = dataclasses.replace(jc, compute_dtype=getattr(jnp, dtype), ssm=(
        dataclasses.replace(jc.ssm, pallas_conv=True, conv_tile=CONV_TILE)))
    tc = dataclasses.replace(tc, compute_dtype=getattr(torch, dtype), ssm=(
        dataclasses.replace(tc.ssm, pallas_conv=True, conv_tile=CONV_TILE)))
    return jc, tc


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a):
    return a.detach().float().numpy()


def _close(got, want, dtype, what=""):
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        tol = dict(atol=1e-5, rtol=1e-5)
    else:
        tol = dict(atol=2.0 ** -7 * float(np.abs(want).max()), rtol=2.0 ** -7)
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def run(request):
    """The reference's parameters, the port's copy, and the reference's
    forward, prefill and decode results on fixed tokens."""
    dtype = request.param
    jc, tc = _cfgs(dtype)
    jm = j_get_model(jc)
    params = jm.init(jax.random.PRNGKey(1))
    params_np = jax.tree.map(_np, params)
    toks = np.random.default_rng(0).integers(
        0, jc.vocab, (B, S + N_DECODE)).astype(np.int32)
    x_full, _ = jssm.ssm_forward(jc, params, jnp.asarray(toks[:, :S]),
                                 jnp.int32(0))
    cache = jm.init_cache(B, S + N_DECODE)
    logits, cache = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                               cache)
    prefill_cache = jax.tree.map(_np, cache)
    decode = []
    for i in range(N_DECODE):
        lg, cache = jm.decode_step(params, cache,
                                   jnp.asarray(toks[:, S + i:S + i + 1]),
                                   jnp.int32(S + i))
        decode.append(_np(lg))
    return dict(
        dtype=dtype, jc=jc, tc=tc, params=params, params_np=params_np,
        toks=toks, x_full=_np(x_full), prefill_logits=_np(logits),
        prefill_cache=prefill_cache, decode=decode,
        model=convert.params_from_reference(params_np, tc, device="cpu"),
    )


# -- configs ----------------------------------------------------------------


def _spec_table(specs):
    return {p: (s.shape, s.axes, str(s.dtype).split(".")[-1].split("'")[0])
            for p, s in flatten_tree(specs)}


@pytest.mark.parametrize("kind", ["full", "smoke"])
def test_config_dims_match_reference(kind):
    get = "get_config" if kind == "full" else "get_smoke_config"
    jc = getattr(jconfigs, get)(ARCH)
    tc = getattr(tconfigs, get)(ARCH)
    for f in dataclasses.fields(tc):
        a, b = getattr(tc, f.name), getattr(jc, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            assert str(a).split(".")[-1] == jnp.dtype(b).name, f.name
        elif f.name in ("ssm", "moe"):
            assert (a is None) == (b is None), f.name
            if a is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    assert (tc.d_inner, tc.ssm_heads, tc.vocab_padded) == (
        jc.d_inner, jc.ssm_heads, jc.vocab_padded)
    assert t_count_params(tc) == j_count_params(jc)
    jspecs = jax.tree_util.tree_flatten_with_path(
        jssm.ssm_param_specs(jc),
        is_leaf=lambda x: type(x).__name__ == "ParamSpec")[0]
    want = {".".join(k.key for k in path): (s.shape, s.axes,
                                           jnp.dtype(s.dtype).name)
            for path, s in jspecs}
    assert _spec_table(tssm.ssm_param_specs(tc)) == want
    if kind == "full":
        assert (tc.n_layers, tc.d_model, tc.d_inner, tc.ssm.state,
                tc.ssm_heads, tc.ssm.conv_width, tc.vocab_padded) == (
            64, 2560, 5120, 128, 80, 4, 50304)


@pytest.mark.parametrize("arch,item", [
    ("zamba2-2.7b", "item 7b"), ("granite-3-2b", "item 7c"),
    ("whisper-large-v3", "item 7c"),
])
def test_unported_architectures_name_their_roadmap_item(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        tconfigs.get_config(arch)
    hybrid = dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                                 family="hybrid", attn_every=2)
    with pytest.raises(NotImplementedError, match="item 7b"):
        t_get_model(hybrid)
    # Training (item 7a) is ported: the loss is a finite f32 scalar.
    _, tc = _cfgs("float32")
    model = t_get_model(tc, device="cpu")
    toks = np.random.default_rng(1).integers(0, tc.vocab, (B, S + 1))
    loss = model.loss(model.init(0), {
        "tokens": toks[:, :-1], "targets": toks[:, 1:],
        "mask": np.ones((B, S), np.float32)})
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert bool(torch.isfinite(loss))


# -- parameters -------------------------------------------------------------


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_params_from_reference_is_exact(run, param_dtype):
    """Every leaf lands in its layer's module unchanged; bf16 leaves arrive
    as float32 arrays and go back to bf16 exactly."""
    jd = getattr(jnp, param_dtype)
    tc = dataclasses.replace(run["tc"], param_dtype=getattr(torch, param_dtype))
    params = jax.tree.map(lambda a: a.astype(jd), run["params"])
    model = convert.params_from_reference(jax.tree.map(_np, params), tc,
                                          device="cpu")
    assert len(model.layers) == tc.n_layers
    state = model.state_dict()
    assert set(state) == (
        {f"embed.{k}" for k in params["embed"]}
        | {f"layers.{i}.{k}" for i in range(tc.n_layers)
           for k in params["layers"]})
    for k, v in params["embed"].items():
        assert state[f"embed.{k}"].dtype == getattr(torch, param_dtype)
        assert np.array_equal(_t(state[f"embed.{k}"]), _np(v)), k
    for k, v in params["layers"].items():
        for i in range(tc.n_layers):
            assert np.array_equal(_t(state[f"layers.{i}.{k}"]), _np(v[i])), k


def test_init_lays_out_the_reference_tree():
    """Ones on 1-D leaves, N(0, 0.02²) elsewhere — the stacked layer
    leaves are 2-D, so their norms are drawn too, as in the reference."""
    _, tc = _cfgs("float32")
    model = t_get_model(tc, device="cpu").init(seed=3)
    assert torch.equal(model.embed.final_norm, torch.ones(tc.d_model))
    w = model.layers[0].w_zx
    assert abs(float(w.std()) - 0.02) < 0.002
    assert not torch.equal(model.layers[0].ln, torch.ones(tc.d_model))


# -- the block, the forward pass, prefill and decode ---------------------------


@pytest.mark.parametrize("seq", [13, 1], ids=["prefill", "decode"])
def test_mamba_block_matches_reference(run, seq):
    """One block on layer 0's parameters with random (nonzero) conv and SSM
    states: S = 13 takes the conv kernel and the chunked SSD, S = 1 the
    unrolled conv in the compute dtype and the recurrent step."""
    jc, dtype = run["jc"], run["dtype"]
    p0 = {k: v[0] for k, v in run["params"]["layers"].items()}
    rng = np.random.default_rng(6)
    conv_ch = jc.d_inner + 2 * jc.ssm.state
    x = rng.standard_normal((B, seq, jc.d_model)).astype(np.float32)
    conv_s = rng.standard_normal(
        (B, jc.ssm.conv_width - 1, conv_ch)).astype(np.float32)
    ssm_s = (rng.standard_normal(
        (B, jc.ssm_heads, jc.ssm.head_dim, jc.ssm.state)) * 0.1).astype(
        np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jssm.mamba_block(jc, p0, jnp.asarray(x, jd), jnp.asarray(ssm_s),
                            jnp.asarray(conv_s, jd))
    with torch.inference_mode():
        got = run["model"].layers[0](torch.from_numpy(x).to(td),
                                     torch.from_numpy(ssm_s),
                                     torch.from_numpy(conv_s).to(td))
    for g, w, name in zip(got, want, ("y", "ssm_state", "conv_state")):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(_t(g), _np(w), dtype, name)


def test_ssm_forward_matches_reference(run):
    with torch.inference_mode():
        x, cache = tssm.ssm_forward(
            run["tc"], run["model"],
            torch.from_numpy(run["toks"][:, :S]).long(), 0)
    assert cache is None
    assert x.dtype == run["tc"].compute_dtype
    _close(_t(x), run["x_full"], run["dtype"], "x")


def test_prefill_then_decode_matches_reference(run):
    tc, toks = run["tc"], run["toks"]
    model = t_get_model(tc, device="cpu")
    cache = model.init_cache(B, S + N_DECODE)
    logits, cache = model.prefill(
        run["model"], {"tokens": toks[:, :S]}, cache)
    assert tuple(logits.shape) == (B, 1, tc.vocab_padded)
    _close(_t(logits), run["prefill_logits"], run["dtype"], "prefill")
    for k in ("ssm", "conv"):
        _close(_t(cache[k]), run["prefill_cache"][k], run["dtype"], k)
    for i in range(N_DECODE):
        logits, cache = model.decode_step(
            run["model"], cache, toks[:, S + i:S + i + 1], S + i)
        _close(_t(logits), run["decode"][i], run["dtype"], f"decode {i}")


def test_reference_prefill_continues_in_the_port(run):
    """The reference's prefill cache, carried across with
    ``convert.cache_from_reference``, decoded by the port."""
    tc, toks = run["tc"], run["toks"]
    cache = convert.cache_from_reference(run["prefill_cache"], tc,
                                         device="cpu")
    assert cache["conv"].dtype == tc.compute_dtype
    assert cache["ssm"].dtype == torch.float32
    model = t_get_model(tc, device="cpu")
    for i in range(N_DECODE):
        logits, cache = model.decode_step(
            run["model"], cache, toks[:, S + i:S + i + 1], S + i)
        _close(_t(logits), run["decode"][i], run["dtype"], f"decode {i}")


def test_serve_is_prefill_then_greedy_decode(run):
    tc = run["tc"]
    prompts = run["toks"][:, :S]
    toks, timings = tserve.serve(tc, run["model"], prompts, 3, device="cpu")
    assert tuple(toks.shape) == (B, 3)
    assert timings["decode_steps"] == 2
    assert timings["prefill_s"] > 0 and timings["decode_s"] > 0
    model = t_get_model(tc, device="cpu")
    cache = model.init_cache(B, S + 3)
    logits, cache = model.prefill(run["model"], {"tokens": prompts}, cache)
    want = [logits[:, -1, :tc.vocab].argmax(-1)]
    for i in range(2):
        logits, cache = model.decode_step(run["model"], cache,
                                          want[-1][:, None], S + i)
        want.append(logits[:, -1, :tc.vocab].argmax(-1))
    assert torch.equal(toks, torch.stack(want, dim=1))


def test_serve_cli_runs_the_smoke_config_on_the_cpu(capsys):
    toks = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "9", "--gen", "3",
                        "--conv-tile", "4"])
    assert tuple(toks.shape) == (2, 3)
    assert "prefill 2x9" in capsys.readouterr().out
