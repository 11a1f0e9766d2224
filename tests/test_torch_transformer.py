"""The port's decoder-only transformers against the JAX package, on the CPU.

Seven architectures: the dense ``granite-3-2b``, ``qwen1.5-32b`` (MHA,
QKV bias), ``internlm2-20b`` and ``llama3-405b`` (bf16 parameters, untied
embeddings), the MoE ``mixtral-8x22b`` (sliding window) and
``arctic-480b`` (bf16, dense residual, 7 q heads on 1 kv head), and the
VLM ``internvl2-2b`` (a soft patch prefix).  Each runs its ``smoke()``
config on both sides, as published (bf16 compute) and in f32 (compute and
parameters).  The reference's parameters (``init_from_specs`` from a jax
key) are carried across with ``convert.params_from_reference``; tokens
and prefixes are made with numpy.  The reference runs outside a mesh: its
``_constrain_act`` and ``constrain`` are then the identity, as the
port's absence of them is.  Tolerances, as ``test_torch_zamba2.py``
states them for attention and the MLP:

* f32: ``atol = rtol = 1e-5`` — f32 sums (matmuls, attention scores,
  softmax, norms) run in another order in XLA and ATen, and exp, sin,
  cos and pow differ by about an ulp.
* bf16 compute: two bf16 ulps of the result's scale (``rtol = 2**-7``,
  ``atol = 2**-7 · max|ref|``) — XLA may keep f32 between bf16
  elementwise ops where PyTorch rounds after each, and a one-ulp
  difference in a bf16 activation is carried through later layers.
* Training: the loss within ``rtol = 1e-6`` (f32) or two bf16 ulps;
  each gradient leaf within ``1e-5`` (f32) or four bf16 ulps (``2**-6``)
  of its scale.  A bf16 leaf that misses that band passes if the port's
  gradient is no further from the reference's f32 gradient than twice
  the reference's own bf16 gradient is: the reference's init draws the
  stacked layer norms at N(0, 0.02²), so queries and keys are small,
  the softmax rows near uniform, and the score path's gradients are
  sums that nearly cancel, whose bf16 rounding is larger than their
  value.  The key bias's gradient (qwen, whisper) is zero in exact
  arithmetic (a bias on every key shifts a query's scores by one
  constant, which the softmax ignores): both sides are held to zero
  within the band of the same layer's value-bias gradient.
* Exact: the param-spec table, ``count_params``, the cache's positions
  and write positions, and the MoE routing (``_moe_route``'s experts,
  slots and gates) given the same probabilities.

Decode tokens are fixed (teacher tokens), not argmax'd, so a near-tie
cannot send the two sides down different paths.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import count_params as j_count_params  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import count_params as t_count_params  # noqa: E402
from repro_torch.models import get_model as t_get_model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import flatten_tree  # noqa: E402

ARCHS = ["granite-3-2b", "qwen1.5-32b", "internlm2-20b", "llama3-405b",
         "mixtral-8x22b", "arctic-480b", "internvl2-2b"]
MOE = ["mixtral-8x22b", "arctic-480b"]
# S: three query chunks of 16, and with the decode steps past mixtral's
# smoke window (32); the VLM's 8 prefix positions make 56, one chunk.
B, S, N_DECODE = 2, 48, 5


def _cfgs(arch, dtype, **kw):
    """The smoke config on both sides: as published (``"bfloat16"``), or
    with f32 compute and parameters (``"float32"``)."""
    jc = jconfigs.get_smoke_config(arch)
    tc = tconfigs.get_smoke_config(arch)
    if dtype == "float32":
        jc = dataclasses.replace(jc, compute_dtype=jnp.float32,
                                 param_dtype=jnp.float32)
        tc = dataclasses.replace(tc, compute_dtype=torch.float32,
                                 param_dtype=torch.float32)
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


def _np(tree):
    def one(a):
        a = jnp.asarray(a)
        if jnp.issubdtype(a.dtype, jnp.integer):
            return np.asarray(a)
        return np.asarray(a.astype(jnp.float32))

    return jax.tree.map(one, tree)


def _t(tree):
    return {k: (_t(v) if isinstance(v, dict) else
                v.detach().float().numpy() if v.is_floating_point()
                else v.numpy()) for k, v in tree.items()}


def _close(got, want, dtype, what=""):
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        tol = dict(atol=1e-5, rtol=1e-5)
    else:
        tol = dict(atol=2.0 ** -7 * float(np.abs(want).max()), rtol=2.0 ** -7)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               err_msg=what, **tol)


def _grad_close(got, want, dtype, want_f32=None):
    """Each gradient leaf within the band of the module docstring.
    ``want_f32``: a callable giving the reference's gradients of the same
    parameters in f32, asked for only where a bf16 leaf misses its band."""
    r = 1e-5 if dtype == "float32" else 2.0 ** -6
    leaves = dict(flatten_tree(want))
    assert [p for p, _ in flatten_tree(got)] == list(leaves)
    exact = None
    for path, g in flatten_tree(got):
        w = leaves[path]
        if path.endswith(".bk"):  # zero in exact arithmetic
            bound = r * float(np.abs(leaves[path[:-2] + "bv"]).max())
            assert np.abs(g).max() <= bound and np.abs(w).max() <= bound, path
            continue
        scale = float(np.abs(w).max())
        if np.allclose(g, w, rtol=r, atol=r * scale) or want_f32 is None:
            np.testing.assert_allclose(g, w, rtol=r, atol=r * scale,
                                       err_msg=path)
            continue
        exact = exact or dict(flatten_tree(want_f32()))
        own = float(np.abs(w - exact[path]).max())
        assert float(np.abs(g - exact[path]).max()) <= 2 * own, path


def _prefix(cfg, seed=5):
    """A VLM's patch prefix (B, F, D), float32 numpy; None otherwise."""
    if cfg.family != "vlm":
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module",
                params=[(a, d) for a in ARCHS for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def run(request):
    """The reference's parameters, the port's copy, and the reference's
    prefill, five decode steps and final cache on fixed tokens."""
    arch, dtype = request.param
    jc, tc = _cfgs(arch, dtype)
    jm = j_get_model(jc)
    params = jm.init(jax.random.PRNGKey(1))
    params_np = _np(params)
    toks = np.random.default_rng(0).integers(
        0, jc.vocab, (B, S + N_DECODE)).astype(np.int32)
    prefix = _prefix(jc)
    f = 0 if prefix is None else prefix.shape[1]
    batch = {"tokens": jnp.asarray(toks[:, :S])}
    if prefix is not None:
        batch["prefix_embeds"] = jnp.asarray(prefix).astype(jc.compute_dtype)
    max_len = f + S + N_DECODE + 3  # three slots stay unwritten
    cache = jm.init_cache(B, max_len)
    logits, cache = jm.prefill(params, batch, cache)
    decode = []
    for i in range(N_DECODE):
        lg, cache = jm.decode_step(params, cache,
                                   jnp.asarray(toks[:, S + i:S + i + 1]),
                                   jnp.int32(f + S + i))
        decode.append(_np(lg))
    return dict(
        arch=arch, dtype=dtype, jc=jc, tc=tc, params=params,
        params_np=params_np, toks=toks, prefix=prefix, f=f, max_len=max_len,
        prefill_logits=_np(logits), decode=decode, cache=_np(cache),
        model=convert.params_from_reference(params_np, tc, device="cpu"),
    )


def _port_serve(run):
    """The port's prefill and decode steps on the run's tokens: (logits,
    the decode steps' logits, the final cache)."""
    tc, toks, f = run["tc"], run["toks"], run["f"]
    tm = t_get_model(tc, device="cpu")
    cache = tm.init_cache(B, run["max_len"])
    batch = {"tokens": toks[:, :S]}
    if run["prefix"] is not None:
        batch["prefix_embeds"] = run["prefix"]
    logits, cache = tm.prefill(run["model"], batch, cache)
    decode = []
    for i in range(N_DECODE):
        lg, cache = tm.decode_step(run["model"], cache,
                                   toks[:, S + i:S + i + 1], f + S + i)
        decode.append(lg.float().numpy())
    return logits.float().numpy(), decode, cache


# -- configs ----------------------------------------------------------------


def _spec_table(specs):
    return {p: (s.shape, s.axes, str(s.dtype).split(".")[-1].split("'")[0])
            for p, s in flatten_tree(specs)}


def _jspec_table(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: type(x).__name__ == "ParamSpec")[0]
    return {".".join(k.key for k in path): (s.shape, s.axes,
                                           jnp.dtype(s.dtype).name)
            for path, s in leaves}


@pytest.mark.parametrize("kind", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_dims_match_reference(arch, kind):
    get = "get_config" if kind == "full" else "get_smoke_config"
    jc = getattr(jconfigs, get)(arch)
    tc = getattr(tconfigs, get)(arch)
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
    assert (tc.vocab_padded, tc.head_dim, tc.padded_heads,
            tc.stored_kv_heads) == (jc.vocab_padded, jc.head_dim,
                                    jc.padded_heads, jc.stored_kv_heads)
    assert (_spec_table(ttf.lm_param_specs(tc))
            == _jspec_table(jtf.lm_param_specs(jc)))


@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("kind", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_matches_reference(arch, kind, active_only):
    get = "get_config" if kind == "full" else "get_smoke_config"
    jc = getattr(jconfigs, get)(arch)
    tc = getattr(tconfigs, get)(arch)
    n = t_count_params(tc, active_only=active_only)
    assert n == j_count_params(jc, active_only=active_only)
    if tc.moe is None or not active_only:
        assert n == t_count_params(tc)
    else:
        assert n < t_count_params(tc)


def test_published_sizes():
    """The sizes the card's phases are planned from (f32 bytes a layer,
    or bf16 where the config's parameters are bf16)."""
    def layer_gb(arch):
        c = tconfigs.get_config(arch)
        per = t_count_params(dataclasses.replace(c, n_layers=1)) - (
            t_count_params(dataclasses.replace(c, n_layers=0)))
        return per * torch.empty((), dtype=c.param_dtype).element_size() / 1e9

    assert t_count_params(tconfigs.get_config("granite-3-2b")) == 2_533_787_648
    assert round(layer_gb("qwen1.5-32b"), 2) == 2.10
    assert round(layer_gb("internlm2-20b"), 2) == 1.56
    assert round(layer_gb("llama3-405b"), 2) == 6.38
    assert round(layer_gb("mixtral-8x22b"), 1) == 10.0
    assert round(layer_gb("arctic-480b"), 1) == 27.2


# -- parameters and cache ---------------------------------------------------


def test_params_from_reference_round_trip(run):
    model = run["model"]
    state = model.state_dict()
    assert set(state) == (
        {f"embed.{k}" for k in run["params"]["embed"]}
        | {f"layers.{i}.{p}" for i in range(run["tc"].n_layers)
           for p, _ in flatten_tree(run["params"]["layers"])})
    back = convert.params_to_reference(model)
    assert ([p for p, _ in flatten_tree(back)]
            == [p for p, _ in flatten_tree(run["params_np"])])
    for (path, a), (_, b) in zip(flatten_tree(back),
                                 flatten_tree(run["params_np"])):
        assert np.array_equal(a, b), path


def test_init_cache_matches_reference(run):
    jm = j_get_model(run["jc"])
    want = _np(jm.init_cache(B, run["max_len"]))
    got = _t(t_get_model(run["tc"], device="cpu").init_cache(
        B, run["max_len"]))
    assert [p for p, _ in flatten_tree(got)] == [
        p for p, _ in flatten_tree(want)]
    for (path, a), (_, b) in zip(flatten_tree(got), flatten_tree(want)):
        assert a.shape == b.shape and np.array_equal(a, b), path


@pytest.mark.parametrize("arch", ["granite-3-2b", "mixtral-8x22b"])
def test_init_lays_out_the_reference_tree(arch):
    """Ones where the reference's stacked leaf is 1-D (``final_norm``),
    N(0, 0.02²) elsewhere — the stacked layer norms are 2-D, so they are
    drawn, as in the reference."""
    _, tc = _cfgs(arch, "float32")
    model = t_get_model(tc, device="cpu").init(0)
    for name, p in model.named_parameters():
        if name == "embed.final_norm":
            assert bool(torch.all(p == 1)), name
        else:
            assert abs(float(p.detach().std()) - 0.02) < 0.01, name
    again = t_get_model(tc, device="cpu").init(0)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n


def test_init_draws_in_pieces_as_it_draws_whole():
    """The pieces cover each leaf once: a small piece gives every leaf a
    full draw (finite, no element left as made)."""
    _, tc = _cfgs("arctic-480b", "float32")
    model = ttf.LMModel(tc, device="cpu")
    for p in model.parameters():
        p.data.fill_(float("nan"))
    gen = torch.Generator().manual_seed(0)
    tlayers.init_params_(model, ttf.lm_param_specs(tc), gen, piece=100)
    for name, p in model.named_parameters():
        assert bool(torch.isfinite(p).all()), name


# -- serving ----------------------------------------------------------------


def test_prefill_and_decode_match_reference(run):
    logits, decode, _ = _port_serve(run)
    _close(logits, run["prefill_logits"], run["dtype"], "prefill")
    for i, (got, want) in enumerate(zip(decode, run["decode"])):
        _close(got, want, run["dtype"], f"decode {i}")


def test_final_cache_matches_reference(run):
    _, _, cache = _port_serve(run)
    got, want = _t(cache), run["cache"]
    for name in ("k", "v"):
        _close(got[name], want[name], run["dtype"], name)
    assert np.array_equal(got["positions"], want["positions"])
    assert np.array_equal(got["pos"], want["pos"])
    n = run["f"] + S + N_DECODE
    assert (got["pos"] == n).all() and (got["positions"][:, n:] == 2**30).all()


def test_reference_prefill_continued_by_the_port(run):
    """A JAX prefill's cache, carried across with
    ``convert.cache_from_reference``, continued by the port's decode."""
    jc, tc, toks, f = run["jc"], run["tc"], run["toks"], run["f"]
    jm = j_get_model(jc)
    batch = {"tokens": jnp.asarray(toks[:, :S])}
    if run["prefix"] is not None:
        batch["prefix_embeds"] = jnp.asarray(run["prefix"]).astype(
            jc.compute_dtype)
    _, jcache = jm.prefill(run["params"], batch,
                           jm.init_cache(B, run["max_len"]))
    cache = convert.cache_from_reference(_np(jcache), tc, device="cpu")
    tm = t_get_model(tc, device="cpu")
    lg, _ = tm.decode_step(run["model"], cache, toks[:, S:S + 1], f + S)
    _close(lg.float().numpy(), run["decode"][0], run["dtype"], "decode 0")


# -- MoE routing ------------------------------------------------------------


def test_top_k_orders_ties_as_lax_top_k():
    """``lax.top_k`` puts the lower index first among equal values; the
    port's ``top_k`` does too, on a tied row and on rows of values from a
    coarse grid (as bf16-rounded router logits give), where ties are
    common."""
    rows = [np.array([[0.3, 0.3, 0.2, 0.2]], np.float32)]
    rng = np.random.default_rng(11)
    rows.append((np.round(rng.random((64, 8)) * 4) / 4).astype(np.float32))
    assert any(len(set(r.tolist())) < len(r) for r in rows[1])
    for probs in rows:
        want_v, want_i = lax.top_k(jnp.asarray(probs), 2)
        got_v, got_i = tlayers.top_k(torch.tensor(probs), 2)
        assert np.array_equal(got_i.numpy(), np.asarray(want_i))
        assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    assert tlayers.top_k(torch.tensor(rows[0]), 2)[1].tolist() == [[0, 1]]


def _exact_router_inputs(cfg, n, rng, crowd):
    """One-hot tokens and a router of 0 and -200 entries: the logits are
    exactly 0 or -200, so both sides' softmax gives exactly 1/m on a
    token's m tied experts and 0 elsewhere (the same probabilities).
    ``crowd``: the share of router rows that tie expert 0 in (ties alone
    crowd the low experts past capacity)."""
    e, d = cfg.moe.n_experts, cfg.d_model
    router = np.where(rng.random((d, e)) < 0.4, 0.0, -200.0)
    router[:, 0] = np.where(rng.random(d) < crowd, 0.0, router[:, 0])
    router[np.all(router < 0, axis=1), 1] = 0.0  # every row ties something
    x = np.zeros((n, d), np.float32)
    x[np.arange(n), rng.integers(0, d, n)] = 1.0
    return x, router.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,crowd", [("mixtral-8x22b", 0.0),
                                        ("mixtral-8x22b", 0.9),
                                        ("arctic-480b", 0.9)],
                         ids=["mixtral-tied", "mixtral-overflow",
                              "arctic-overflow"])
def test_moe_route_is_bit_equal_given_the_same_probabilities(arch, crowd,
                                                             dtype):
    jc, tc = _cfgs(arch, dtype)
    jc = dataclasses.replace(jc, compute_dtype=getattr(jnp, dtype))
    tc = dataclasses.replace(tc, compute_dtype=getattr(torch, dtype))
    n = 40
    x, router = _exact_router_inputs(tc, n, np.random.default_rng(12), crowd)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    disp, slot_of, gates = jlayers._moe_route(
        jc, {"router": jnp.asarray(router)}, jnp.asarray(x, jd))
    rec = []
    t_disp, t_slot, t_gates = tlayers._moe_route(
        tc, {"router": torch.tensor(router)}, torch.tensor(x).to(td), rec)
    assert np.array_equal(t_slot.numpy(), np.asarray(slot_of))
    assert np.array_equal(t_gates.numpy(), np.asarray(gates))
    assert np.array_equal(t_disp.float().numpy(), _np(disp))
    e = tc.moe.n_experts
    cap = t_disp.shape[1]
    # The experts picked: lax.top_k's on the reference's probabilities.
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    want_e = np.asarray(lax.top_k(probs, tc.moe.top_k)[1])
    assert np.array_equal(rec[0]["eidx"].numpy(), want_e)
    dropped = rec[0]["dropped"].numpy()
    assert np.array_equal(dropped, np.asarray(slot_of) == e * cap)
    assert dropped.any()  # the overflow row is in use
    # Ties decide: tokens with more tied experts than picks.
    assert ((np.asarray(probs) == np.asarray(probs).max(-1, keepdims=True))
            .sum(-1) > tc.moe.top_k).any()


@pytest.mark.parametrize("arch", MOE)
def test_moe_route_on_random_inputs_matches_reference(arch):
    """Routes (slots) equal and gates within the f32 band on ordinary
    inputs (the softmax's exp differs by an ulp between XLA and ATen),
    with tokens crowding one expert past capacity."""
    jc, tc = _cfgs(arch, "float32")
    rng = np.random.default_rng(13)
    x = rng.standard_normal((50, tc.d_model)).astype(np.float32)
    router = (rng.standard_normal((tc.d_model, tc.moe.n_experts))
              * 0.3).astype(np.float32)
    router[:, 2] += 0.5 * np.sign(x.mean(0))  # crowd expert 2
    disp, slot_of, gates = jlayers._moe_route(
        jc, {"router": jnp.asarray(router)}, jnp.asarray(x))
    t_disp, t_slot, t_gates = tlayers._moe_route(
        tc, {"router": torch.tensor(router)}, torch.tensor(x))
    e, cap = tc.moe.n_experts, t_disp.shape[1]
    assert (np.asarray(slot_of) == e * cap).any()
    assert np.array_equal(t_slot.numpy(), np.asarray(slot_of))
    _close(t_gates.numpy(), np.asarray(gates), "float32", "gates")
    assert np.array_equal(t_disp.numpy(), np.asarray(disp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_reference(arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    rng = np.random.default_rng(14)
    p = {path: (rng.standard_normal(s.shape) * 0.2).astype(np.float32)
         for path, s in flatten_tree(tlayers.moe_param_specs(tc))}
    tree: dict = {}
    for path, a in p.items():
        convert._set_path(tree, path, a)
    x = rng.standard_normal((B, 12, tc.d_model)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlayers.moe_block(jc, jax.tree.map(jnp.asarray, tree),
                             jnp.asarray(x, jd))
    t_tree: dict = {}
    for path, a in p.items():
        convert._set_path(t_tree, path, torch.tensor(a))
    got = tlayers.moe_block(tc, t_tree, torch.tensor(x).to(td))
    _close(got.float().numpy(), _np(want), dtype, "moe")


# -- the VLM's serving positions ----------------------------------------------


def _vlm():
    jc, tc = _cfgs("internvl2-2b", "float32")
    params = j_get_model(jc).init(jax.random.PRNGKey(7))
    return jc, tc, params


def test_reference_vlm_serve_decodes_at_the_wrong_position():
    """The reference's ``launch/serve.py`` sizes the cache as S + gen and
    decodes at S + i, ignoring the F prefix positions: its first decode
    step differs from a teacher-forced forward of the same tokens; sized
    F + S + gen and decoded at F + S it equals it."""
    jc, _, params = _vlm()
    jm = j_get_model(jc)
    s, gen = 32, 16
    f = jc.frontend_len
    toks = np.random.default_rng(8).integers(0, jc.vocab, (B, s + 1))
    prefix = jnp.asarray(_prefix(jc, seed=9))
    batch = {"tokens": jnp.asarray(toks[:, :s]), "prefix_embeds": prefix}
    x, _ = jtf.lm_forward(jc, params, jnp.asarray(toks), jnp.int32(0),
                          prefix_embeds=prefix)
    want = np.asarray(jlayers.unembed(jc, params["embed"], x[:, -1:]))
    errs = {}
    for name, max_len, pos in (("reference", s + gen, s),
                               ("fixed", f + s + gen, f + s)):
        _, cache = jm.prefill(params, batch, jm.init_cache(B, max_len))
        lg, _ = jm.decode_step(params, cache, jnp.asarray(toks[:, s:]),
                               jnp.int32(pos))
        errs[name] = float(np.abs(np.asarray(lg) - want).max())
    assert errs["fixed"] < 1e-5
    assert errs["reference"] > 1e-3


def test_reference_vlm_serve_fails_when_the_prefix_exceeds_gen():
    """With the prefix longer than gen (F = 8 > gen = 4), the reference's
    ``launch/serve.py`` cannot even prefill: the prompt and prefix do not
    fit its S + gen cache."""
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jserve.main(["--arch", "internvl2-2b", "--smoke", "--batch", "1",
                     "--prompt-len", "8", "--gen", "4"])


def test_port_vlm_serve_equals_the_forward():
    """The port's ``serve`` with the patch prefix generates the tokens a
    teacher-forced forward of the prefix, the prompt and the tokens so
    far picks greedily, even with the prefix longer than gen."""
    jc, tc, params = _vlm()
    model = convert.params_from_reference(_np(params), tc, device="cpu")
    s, gen = 16, 4
    toks = np.random.default_rng(10).integers(0, tc.vocab, (B, s))
    prefix = torch.tensor(_prefix(tc, seed=11))
    out, _ = tserve.serve(tc, model, toks, gen, device="cpu",
                          prefix_embeds=prefix)
    seq = torch.tensor(toks)
    with torch.no_grad():
        for i in range(gen):
            x, _ = ttf.lm_forward(tc, model, seq, 0, prefix_embeds=prefix)
            lg = tlayers.unembed(tc, model.embed.tensors(), x[:, -1])
            nxt = torch.argmax(lg[:, :tc.vocab], dim=-1)
            assert torch.equal(nxt, out[:, i]), i
            seq = torch.cat([seq, nxt[:, None]], dim=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_architecture(arch, capsys):
    toks = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert tuple(toks.shape) == (2, 3)
    assert "prefill 2x8" in capsys.readouterr().out


@pytest.mark.parametrize("cli", [tserve, ttrain])
def test_clis_default_to_granite(cli, monkeypatch):
    """Both CLIs take ``granite-3-2b`` when no ``--arch`` is given, as
    the reference's do."""
    asked = []

    def smoke(name):
        asked.append(name)
        return tconfigs.get_smoke_config(name)

    monkeypatch.setattr(cli, "get_smoke_config", smoke)
    cli.main(["--smoke", "--device", "cpu", "--batch", "1"]
             + (["--prompt-len", "4", "--gen", "2"] if cli is tserve
                else ["--seq", "8", "--steps", "1"]))
    assert asked == ["granite-3-2b"]


def test_moe_routes_are_recorded_on_the_model():
    """``LMModel.moe_routes``: each layer's routing of a prefill and of a
    decode step appended in order; nothing recorded under autograd."""
    jc, tc = _cfgs("mixtral-8x22b", "float32")
    params = j_get_model(jc).init(jax.random.PRNGKey(5))
    model = convert.params_from_reference(_np(params), tc, device="cpu")
    tm = t_get_model(tc, device="cpu")
    toks = np.random.default_rng(15).integers(0, tc.vocab, (B, 9))
    model.moe_routes = []
    cache = tm.init_cache(B, 9)
    tm.prefill(model, {"tokens": toks[:, :8]}, cache)
    tm.decode_step(model, cache, toks[:, 8:], 8)
    rec = model.moe_routes
    assert len(rec) == 2 * tc.n_layers
    assert [tuple(r["eidx"].shape) for r in rec] == (
        [(B * 8, 2)] * tc.n_layers + [(B, 2)] * tc.n_layers)
    assert all(r["dropped"].dtype == torch.bool for r in rec)
    model.moe_routes = []
    tm.loss(model, {"tokens": toks[:, :8], "targets": toks[:, 1:],
                    "mask": np.ones((B, 8), np.float32)})
    assert model.moe_routes == []
