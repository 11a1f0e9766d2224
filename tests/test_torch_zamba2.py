"""The port's Zamba2 hybrid against the JAX package, on the CPU.

The hybrid is Mamba2 plus one shared attention + MLP block applied after
every ``attn_every``-th layer.  The reference's parameters
(``init_from_specs`` from a jax key) are carried across with
``convert.params_from_reference``; token ids and layer inputs are made
with numpy.  Both sides run the smoke config of ``zamba2-2.7b`` (4
layers, ``attn_every`` 2, 4 heads of 16, ``q_chunk`` 16) with the conv on
the kernel at an explicit tile (the JAX kernel in interpret mode, the
port's through its plain version with ``device="cpu"``).  The reference
runs outside a mesh: its ``_constrain_act`` is then the identity, as the
port's absence of it is, and under jax 0.9.0 a mesh's ``Explicit`` axes
would make ``with_sharding_constraint`` raise (``ROADMAP.md`` queue C).
Tolerances, as ``test_torch_mamba2.py`` and ``test_torch_train.py``
state them:

* f32 compute: ``atol = rtol = 1e-5`` — f32 sums (matmuls, SSD einsums,
  attention scores, softmax) run in another order in XLA and ATen, and
  exp/sin/cos/pow differ by about an ulp.
* bf16 compute: two bf16 ulps of the result's scale (``rtol = 2**-7``,
  ``atol = 2**-7 · max|ref|``) — XLA may keep f32 between bf16
  elementwise ops where PyTorch rounds after each, and a one-ulp
  difference in a bf16 activation is carried through later layers.
* Training: the loss within ``rtol = 1e-6`` (f32) or two bf16 ulps;
  gradients within ``1e-5`` (f32) or four bf16 ulps (``2**-6``) of a
  leaf's scale; one AdamW step's parameters within ``rtol = 1e-5,
  atol = 1e-7``, but for at most 1e-3 of the elements, where a gradient
  is within ``100 · eps`` of zero and the first step's ``g / (|g| +
  eps)`` allows ``2 · lr`` (see the test); at
  chunk 128 against the reference at chunk 16,
  ``1e-4`` of a leaf's scale (decay products over other spans).
* Head padding, ring writes, positions and the cache's integer leaves are
  held exactly.

Decode tokens are fixed (teacher tokens), so a near-tie cannot send the
two sides down different paths.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.models import count_params as j_count_params  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import count_params as t_count_params  # noqa: E402
from repro_torch.models import get_model as t_get_model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.layers import flatten_tree  # noqa: E402
from repro_torch.optim import OptConfig, adamw_init  # noqa: E402

ARCH = "zamba2-2.7b"
CONV_TILE = 8
B, S, N_DECODE = 2, 21, 5  # S is not a multiple of the tile, chunk or q_chunk
MAX_LEN = S + N_DECODE + 3  # three slots stay unwritten


def _cfgs(dtype, chunk=16, **kw):
    jc = jconfigs.get_smoke_config(ARCH)
    tc = tconfigs.get_smoke_config(ARCH)
    jc = dataclasses.replace(jc, compute_dtype=getattr(jnp, dtype), ssm=(
        dataclasses.replace(jc.ssm, pallas_conv=True, conv_tile=CONV_TILE,
                            chunk=chunk)), **kw)
    tc = dataclasses.replace(tc, compute_dtype=getattr(torch, dtype), ssm=(
        dataclasses.replace(tc.ssm, pallas_conv=True, conv_tile=CONV_TILE,
                            chunk=chunk)), **kw)
    return jc, tc


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


def _port_grads(model) -> dict:
    """The port's gradients as the reference's tree (layers stacked)."""
    return convert._stack({n: p.grad for n, p in model.named_parameters()})


def _grad_close(got, want, dtype):
    assert ([p for p, _ in flatten_tree(got)]
            == [p for p, _ in flatten_tree(want)])
    for (path, g), (_, w) in zip(flatten_tree(got), flatten_tree(want)):
        scale = float(np.abs(w).max())
        r = 1e-5 if dtype == "float32" else 2.0 ** -6
        np.testing.assert_allclose(g, w, rtol=r, atol=r * scale,
                                   err_msg=path)


def _batch(vocab, seq=64, seed=0, step=0):
    return JTokenPipeline(JDataConfig(vocab=vocab, seq_len=seq,
                                      global_batch=B,
                                      seed=seed)).batch_at(step)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def run(request):
    """The reference's parameters, the port's copy, and the reference's
    forward, prefill, five decode steps and final cache on fixed tokens."""
    dtype = request.param
    jc, tc = _cfgs(dtype)
    jm = j_get_model(jc)
    params = jm.init(jax.random.PRNGKey(1))
    params_np = _np(params)
    toks = np.random.default_rng(0).integers(
        0, jc.vocab, (B, S + N_DECODE)).astype(np.int32)
    x_full, _ = jssm.ssm_forward(jc, params, jnp.asarray(toks[:, :S]),
                                 jnp.int32(0))
    cache = jm.init_cache(B, MAX_LEN)
    init_cache = _np(cache)
    logits, cache = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                               cache)
    prefill_cache = _np(cache)
    decode = []
    for i in range(N_DECODE):
        lg, cache = jm.decode_step(params, cache,
                                   jnp.asarray(toks[:, S + i:S + i + 1]),
                                   jnp.int32(S + i))
        decode.append(_np(lg))
    return dict(
        dtype=dtype, jc=jc, tc=tc, params=params, params_np=params_np,
        toks=toks, x_full=_np(x_full), prefill_logits=_np(logits),
        init_cache=init_cache, prefill_cache=prefill_cache, decode=decode,
        final_cache=_np(cache),
        model=convert.params_from_reference(params_np, tc, device="cpu"),
    )


def _port_serve(run, n_decode=N_DECODE):
    tc = run["tc"]
    model = t_get_model(tc, device="cpu")
    cache = model.init_cache(B, MAX_LEN)
    toks = run["toks"]
    logits, cache = model.prefill(run["model"], {"tokens": toks[:, :S]},
                                  cache)
    prefill = logits.float().numpy()
    decode = []
    for i in range(n_decode):
        lg, cache = model.decode_step(run["model"], cache,
                                      toks[:, S + i:S + i + 1], S + i)
        decode.append(lg.float().numpy())
    return prefill, decode, cache


# -- configs ----------------------------------------------------------------


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
    for prop in ("d_inner", "ssm_heads", "vocab_padded", "padded_heads",
                 "stored_kv_heads"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert tssm._n_attn_apps(tc) == jssm._n_attn_apps(jc)
    jspecs = jax.tree_util.tree_flatten_with_path(
        jssm.ssm_param_specs(jc),
        is_leaf=lambda x: type(x).__name__ == "ParamSpec")[0]
    want = {".".join(k.key for k in path): (s.shape, s.axes)
            for path, s in jspecs}
    got = {p: (s.shape, s.axes)
           for p, s in flatten_tree(tssm.ssm_param_specs(tc))}
    assert got == want
    if kind == "full":
        assert (tc.n_layers, tc.d_model, tc.d_inner + 2 * tc.ssm.state,
                tc.head_dim, tssm._n_attn_apps(tc)) == (54, 2560, 5248, 80, 9)


@pytest.mark.parametrize("kind", ["full", "smoke"])
def test_count_params_counts_the_shared_block_once(kind):
    get = "get_config" if kind == "full" else "get_smoke_config"
    tc = getattr(tconfigs, get)(ARCH)
    n = t_count_params(tc)
    assert n == j_count_params(getattr(jconfigs, get)(ARCH))
    shared = sum(int(np.prod(s.shape)) for p, s in flatten_tree(
        tssm.ssm_param_specs(tc)) if p.startswith("shared_attn."))
    plain = dataclasses.replace(tc, family="ssm", attn_every=0)
    assert n == t_count_params(plain) + shared
    if kind == "full":
        assert shared == 2 * 2560 + 4 * 2560 * 2560 + 3 * 2560 * 10240


def test_padding_report_scores_the_dims_in_card_lines():
    """The reference's keys; each entry is ``advise_dim`` in 128-byte lines
    of the compute dtype (64 bf16 elements): head_dim 80 pads to 128."""
    from repro_torch.core.padding import advise_dim

    tc, jc = tconfigs.get_config(ARCH), jconfigs.get_config(ARCH)
    rep = tc.padding_report
    assert set(rep) == set(jc.padding_report)
    for name, adv in rep.items():
        assert adv == advise_dim(getattr(tc, name), dtype_bytes=2)
        assert set(adv) == set(jc.padding_report[name])
    assert rep["head_dim"]["padded"] == 128 and rep["head_dim"]["unfavorable"]
    assert not rep["d_model"]["unfavorable"]


# -- layers -------------------------------------------------------------------


def _tp_cfgs(n_heads, n_kv, tp):
    base = dict(n_heads=n_heads, n_kv_heads=n_kv, tp=tp, head_dim=8)
    jc = dataclasses.replace(jconfigs.get_smoke_config(ARCH), **base)
    tc = dataclasses.replace(tconfigs.get_smoke_config(ARCH), **base)
    return jc, tc


@pytest.mark.parametrize("heads", [(4, 4, 1), (6, 6, 4), (6, 2, 4), (4, 2, 2)],
                         ids=["tp1", "mha-pad", "gqa-pad", "gqa-even"])
def test_head_padding_matches_reference(heads):
    jc, tc = _tp_cfgs(*heads)
    assert (tc.padded_heads, tc.stored_kv_heads) == (jc.padded_heads,
                                                     jc.stored_kv_heads)
    rng = np.random.default_rng(sum(heads))
    q = rng.standard_normal((2, 3, tc.n_heads, 8)).astype(np.float32)
    kv = rng.standard_normal((2, 3, tc.n_kv_heads, 8)).astype(np.float32)
    wo = rng.standard_normal((tc.n_heads, 8, 5)).astype(np.float32)
    cases = [
        (tlayers.pad_q_heads(torch.tensor(q), tc),
         jlayers.pad_q_heads(jnp.asarray(q), jc)),
        (tlayers.pad_q_heads(torch.tensor(wo), tc, axis=0),
         jlayers.pad_q_heads(jnp.asarray(wo), jc, axis=0)),
        (tlayers.to_stored_kv(torch.tensor(kv), tc),
         jlayers.to_stored_kv(jnp.asarray(kv), jc)),
        (tlayers.pad_heads(torch.tensor(q), tc.n_heads + 2),
         jlayers.pad_heads(jnp.asarray(q), jc.n_heads + 2)),
    ]
    stored = jlayers.to_stored_kv(jnp.asarray(kv), jc)
    cases.append((tlayers.expand_kv(torch.tensor(np.asarray(stored)),
                                    tc.padded_heads),
                  jlayers.expand_kv(stored, jc.padded_heads)))
    for got, want in cases:
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos_kind", ["1d", "2d"])
def test_rope_matches_reference(dtype, pos_kind):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = (rng.integers(0, 3000, (6,)) if pos_kind == "1d"
           else rng.integers(0, 3000, (2, 6))).astype(np.int32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = _np(jlayers.rope(jx, jnp.asarray(pos), 1e4))
    got = tlayers.rope(torch.tensor(x).to(getattr(torch, dtype)),
                       torch.tensor(pos), 1e4)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), want, dtype, "rope")


def _attn_inputs(seed, c=5, t=9, hq=4, hs=2, d=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, c, hq, d)).astype(np.float32)
    k = rng.standard_normal((2, t, hs, d)).astype(np.float32)
    v = rng.standard_normal((2, t, hs, d)).astype(np.float32)
    pos_q = np.broadcast_to(np.arange(4, 4 + c), (2, c)).astype(np.int32)
    pos_k = np.broadcast_to(np.arange(t), (2, t)).astype(np.int32).copy()
    return q, k, v, pos_q, pos_k


def _both_chunks(q, k, v, pos_q, pos_k, causal, window, dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlayers._attn_chunk(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(pos_q), jnp.asarray(pos_k), causal, window, jd)
    got = tlayers._attn_chunk(
        torch.tensor(q).to(td), torch.tensor(k).to(td),
        torch.tensor(v).to(td), torch.tensor(pos_q), torch.tensor(pos_k),
        causal, window, td)
    return got.float().numpy(), _np(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 3),
                                           (False, None)])
def test_attn_chunk_matches_reference(dtype, causal, window):
    """The grouped einsum (4 q heads on 2 stored kv heads), f32 scores,
    the mask, and the probabilities rounded before the PV product."""
    q, k, v, pos_q, pos_k = _attn_inputs(3)
    pos_k[:, -2:] = -1  # unwritten slots of a non-causal cache
    got, want = _both_chunks(q, k, v, pos_q, pos_k, causal, window, dtype)
    _close(got, want, dtype, "attn chunk")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_row_is_uniform_as_in_the_reference(dtype):
    """Hazard: the mask fill is the finite NEG_INF = -1e30.  A query whose
    every key is masked (all slots unwritten, INVALID_POS) gets the
    reference's uniform row, the mean of the values; a fill of -inf gives
    NaN there."""
    q, k, v, pos_q, pos_k = _attn_inputs(4)
    pos_k[:] = tlayers.INVALID_POS
    assert tlayers.NEG_INF == jlayers.NEG_INF == -1e30
    assert tlayers.INVALID_POS == int(jlayers.INVALID_POS)
    got, want = _both_chunks(q, k, v, pos_q, pos_k, True, None, dtype)
    assert np.isfinite(got).all()
    _close(got, want, dtype, "fully masked")
    mean_v = np.repeat(v.mean(axis=1), 2, axis=1)  # (B, Hq, D)
    if dtype == "float32":
        np.testing.assert_allclose(got, np.broadcast_to(
            mean_v[:, None], got.shape), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches_reference_and_its_gradient(dtype):
    """48 queries in chunks of 16 (each under torch.utils.checkpoint under
    autograd) against the reference's scan; and the gradient of q, k, v
    against ``jax.grad`` in f32."""
    q, k, v, _, _ = _attn_inputs(5, c=48, t=48)
    pos = np.arange(48, dtype=np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def jf(q_, k_, v_):
        return jlayers.chunked_attention(
            q_, k_, v_, jnp.asarray(pos), jnp.asarray(pos), causal=True,
            window=None, q_chunk=16, dtype=jd)

    want = jf(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd))
    tq, tk, tv = (torch.tensor(a).to(td).requires_grad_() for a in (q, k, v))
    got = tlayers.chunked_attention(
        tq, tk, tv, torch.tensor(pos), torch.tensor(pos), causal=True,
        window=None, q_chunk=16, dtype=td)
    _close(got.detach().float().numpy(), _np(want), dtype, "chunked")
    if dtype == "float32":
        g = np.random.default_rng(6).standard_normal(got.shape).astype(
            np.float32)
        jg = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))[1](
            jnp.asarray(g))
        got.backward(torch.tensor(g))
        for name, t, w in zip("qkv", (tq, tk, tv), jg):
            _close(t.grad.numpy(), np.asarray(w), dtype, name)


def _attn_params(tc, seed=8):
    rng = np.random.default_rng(seed)
    return {name: (rng.standard_normal(s.shape) * 0.2).astype(np.float32)
            for name, s in tlayers.attention_param_specs(tc).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start,s", [(0, 6), (5, 1), (3, 6), (7, 8)],
                         ids=["prefill", "decode", "clamped", "clamped-full"])
def test_attention_block_ring_write_matches_reference(dtype, start, s):
    """The ring KV cache of 8 slots, written at ``pos % Tc``.  Hazard: the
    reference's ``dynamic_update_slice`` clamps its start so that the
    update fits; a write of 6 at position 3 (free tail 5) lands at slots
    2..7, and one of 8 at position 7 at slots 0..7.  Outputs, keys,
    values, positions and the write position against the reference."""
    jc, tc = _cfgs(dtype)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    p = _attn_params(tc)
    rng = np.random.default_rng(start + s)
    x = rng.standard_normal((B, s, tc.d_model)).astype(np.float32)
    tcache_len, hs, hd = 8, tc.stored_kv_heads, tc.head_dim
    k0 = rng.standard_normal((B, tcache_len, hs, hd)).astype(np.float32)
    v0 = rng.standard_normal((B, tcache_len, hs, hd)).astype(np.float32)
    positions = np.full((tcache_len,), tlayers.INVALID_POS, np.int32)
    positions[:start] = np.arange(start)
    jcache = {"k": jnp.asarray(k0, jd), "v": jnp.asarray(v0, jd),
              "positions": jnp.asarray(positions),
              "pos": jnp.int32(start)}
    want, wcache = jlayers.attention_block(
        jc, jax.tree.map(jnp.asarray, p), jnp.asarray(x, jd),
        jnp.int32(start), cache=jcache)
    tcache = {"k": torch.tensor(k0).to(td), "v": torch.tensor(v0).to(td),
              "positions": torch.tensor(positions),
              "pos": torch.tensor(start, dtype=torch.int32)}
    got, gcache = tlayers.attention_block(
        tc, {k: torch.tensor(a) for k, a in p.items()},
        torch.tensor(x).to(td), start, cache=tcache)
    assert gcache is tcache
    _close(got.float().numpy(), _np(want), dtype, "out")
    wc = _np(wcache)
    for name in ("k", "v"):
        _close(tcache[name].float().numpy(), wc[name], dtype, name)
    assert np.array_equal(tcache["positions"].numpy(), wc["positions"])
    assert int(tcache["pos"]) == int(wc["pos"]) == start + s


def test_attention_without_a_cache_matches_reference():
    jc, tc = _cfgs("float32")
    p = _attn_params(tc, seed=9)
    x = np.random.default_rng(9).standard_normal(
        (B, 40, tc.d_model)).astype(np.float32)  # 40: not a q_chunk multiple
    want, _ = jlayers.attention_block(jc, jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x), jnp.int32(3))
    got, cache = tlayers.attention_block(
        tc, {k: torch.tensor(a) for k, a in p.items()}, torch.tensor(x), 3)
    assert cache is None
    _close(got.numpy(), np.asarray(want), "float32")


def test_cross_attention_names_its_roadmap_item():
    """Cross-attention (``ROADMAP.md`` queue A, item 7c) is in the port:
    ``cross=True`` with ``x_kv``, and ``x_kv`` alone, equal the
    reference's (keys and values from ``x_kv``, no rope, non-causal)."""
    jc, tc = _cfgs("float32")
    p = _attn_params(tc)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, 2, tc.d_model)).astype(np.float32)
    kv = rng.standard_normal((1, 5, tc.d_model)).astype(np.float32)
    want, _ = jlayers.attention_block(
        jc, jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.int32(0),
        x_kv=jnp.asarray(kv), cross=True)
    for kw in (dict(cross=True), {}):
        got, _ = tlayers.attention_block(
            tc, {k: torch.tensor(a) for k, a in p.items()}, torch.tensor(x),
            0, x_kv=torch.tensor(kv), **kw)
        _close(got.numpy(), np.asarray(want), "float32", str(kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_block_matches_reference(dtype):
    jc, tc = _cfgs(dtype)
    rng = np.random.default_rng(10)
    p = {name: (rng.standard_normal(s.shape) * 0.2).astype(np.float32)
         for name, s in tlayers.mlp_param_specs(tc).items()}
    assert set(p) == set(jlayers.mlp_param_specs(jc))
    x = rng.standard_normal((B, 7, tc.d_model)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlayers.mlp_block(jc, jax.tree.map(jnp.asarray, p),
                             jnp.asarray(x, jd))
    got = tlayers.mlp_block(tc, {k: torch.tensor(a) for k, a in p.items()},
                            torch.tensor(x).to(td))
    _close(got.float().numpy(), _np(want), dtype, "mlp")


# -- the hybrid -----------------------------------------------------------------


def test_params_from_reference_round_trip(run):
    back = convert.params_to_reference(run["model"])
    got, want = flatten_tree(back), flatten_tree(run["params_np"])
    assert [p for p, _ in got] == [p for p, _ in want]
    assert any(p.startswith("shared_attn.attn.") for p, _ in got)
    for (p, a), (_, b) in zip(got, want):
        assert np.array_equal(a, b), p


def test_init_lays_out_the_hybrid_tree():
    """Ones on the reference tree's 1-D leaves — ``final_norm`` and the
    shared block's unstacked ``ln1``/``ln2`` — and N(0, 0.02²) elsewhere,
    the stacked layer norms included; the same seed draws the same
    values."""
    _, tc = _cfgs("float32")
    model = t_get_model(tc, device="cpu").init(0)
    ones = {"embed.final_norm", "shared_attn.ln1", "shared_attn.ln2"}
    for name, p in model.named_parameters():
        if name in ones:
            assert torch.equal(p, torch.ones_like(p)), name
        elif p.numel() > 64:
            assert abs(float(p.detach().std()) - 0.02) < 0.01, name
    assert not torch.equal(model.layers[0].ln, torch.ones(tc.d_model))
    again = t_get_model(tc, device="cpu").init(0)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n


def test_init_cache_matches_reference(run):
    """Hazard: unwritten slots carry INVALID_POS, which the causal mask
    rejects; everything else starts at zero."""
    tc = run["tc"]
    got = _t(t_get_model(tc, device="cpu").init_cache(B, MAX_LEN))
    want = run["init_cache"]
    assert ([p for p, _ in flatten_tree(got)]
            == [p for p, _ in flatten_tree(want)])
    for (p, a), (_, b) in zip(flatten_tree(got), flatten_tree(want)):
        assert a.shape == b.shape and np.array_equal(a, b), p
    assert (got["attn"]["positions"] == tlayers.INVALID_POS).all()


def test_forward_matches_reference(run):
    with torch.no_grad():
        x, _ = tssm.ssm_forward(run["tc"], run["model"],
                                torch.tensor(run["toks"][:, :S]).long(), 0)
    _close(x.float().numpy(), run["x_full"], run["dtype"], "forward")


def test_prefill_and_decode_match_reference(run):
    prefill, decode, _ = _port_serve(run)
    _close(prefill, run["prefill_logits"], run["dtype"], "prefill")
    for i, (got, want) in enumerate(zip(decode, run["decode"])):
        _close(got, want, run["dtype"], f"decode step {i}")


def test_final_cache_matches_reference(run):
    """The SSM and conv states and each application's keys and values
    within the band; positions and write positions exactly."""
    _, _, cache = _port_serve(run)
    got, want = _t(cache), run["final_cache"]
    for (p, a), (_, b) in zip(flatten_tree(got), flatten_tree(want)):
        if p in ("attn.positions", "attn.pos"):
            assert np.array_equal(a, b), p
        else:
            _close(a, b, run["dtype"], p)
    assert (got["attn"]["positions"][:, -3:] == tlayers.INVALID_POS).all()


def test_reference_prefill_continued_by_the_port(run):
    """The reference's prefill cache, carried across, decoded by the port."""
    tc = run["tc"]
    cache = convert.cache_from_reference(run["prefill_cache"], tc,
                                         device="cpu")
    assert cache["attn"]["positions"].dtype == torch.int32
    model = t_get_model(tc, device="cpu")
    toks = run["toks"]
    for i in range(N_DECODE):
        lg, cache = model.decode_step(run["model"], cache,
                                      toks[:, S + i:S + i + 1], S + i)
        _close(lg.float().numpy(), run["decode"][i], run["dtype"], str(i))


def _count_conv_calls(monkeypatch) -> list:
    """Calls of the conv kernel's launch wrapper (on the card, one launch
    each; on the CPU it runs the plain version)."""
    from repro_torch.kernels import conv1d

    calls = []
    real = conv1d.causal_conv1d_launch
    monkeypatch.setattr(conv1d, "causal_conv1d_launch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_serve_runs_the_hybrid_through_the_conv_kernels_wrapper(
        monkeypatch):
    """``launch.serve --arch zamba2-2.7b``: one conv call a layer in the
    prefill (the single-token decode steps take the unrolled loop), as
    for Mamba2 (on the card, 54 launches for Zamba2-2.7B)."""
    calls = _count_conv_calls(monkeypatch)
    toks = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--conv-tile", "8", "--prompt-len", "24",
                        "--gen", "3", "--batch", "2"])
    assert tuple(toks.shape) == (2, 3)
    assert len(calls) == tconfigs.get_smoke_config(ARCH).n_layers


def test_train_step_runs_the_conv_kernels_wrapper_twice_per_layer(
        monkeypatch):
    """Per-layer checkpointing: the forward and its recompute before the
    backward (on the card, 2 × 54 launches a step for Zamba2-2.7B)."""
    calls = _count_conv_calls(monkeypatch)
    _, tc = _cfgs("bfloat16")
    assert tc.remat
    model = t_get_model(tc, device="cpu")
    params = model.init(0)
    state = adamw_init(dict(params.named_parameters()))
    _, _, met = ttrain.train_step(model, params, state, _batch(tc.vocab),
                                  OptConfig())
    assert len(calls) == 2 * tc.n_layers
    assert np.isfinite(float(met["loss"]))


# -- training -------------------------------------------------------------------


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def loss_run(request):
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
    return dict(dtype=dtype, jl=float(jl), jg=_np(jg), tl=float(tl),
                tg=_port_grads(model))


def test_loss_matches_reference(loss_run):
    rtol = 1e-6 if loss_run["dtype"] == "float32" else 2.0 ** -7
    np.testing.assert_allclose(loss_run["tl"], loss_run["jl"], rtol=rtol)


def test_loss_gradients_match_reference(loss_run):
    """Every leaf, the shared block's included (its gradient sums over its
    two applications)."""
    _grad_close(loss_run["tg"], loss_run["jg"], loss_run["dtype"])


def test_group_remat_changes_no_value():
    """The reference's two-level scan with whole-group remat
    (``remat_groups=2`` on 4 layers) gives the loss and gradients the
    port's per-layer checkpointing gives."""
    jc, tc = _cfgs("float32", remat_groups=2)
    params = j_get_model(jc).init(jax.random.PRNGKey(3))
    batch = _batch(jc.vocab, seed=1)
    jl, jg = jax.value_and_grad(
        lambda p: jssm.ssm_loss(jc, p, jax.tree.map(jnp.asarray, batch))
    )(params)
    model = convert.params_from_reference(_np(params), tc, device="cpu")
    tl = t_get_model(tc, device="cpu").loss(model, batch)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    _grad_close(_port_grads(model), _np(jg), "float32")


@pytest.fixture(scope="module")
def chunk128():
    """Zamba2's own SSD chunk (128) over a 128-token batch, f32."""
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
    return out


def test_reference_gradient_is_nan_at_chunk_128_and_the_ports_is_not(
        chunk128):
    """Hazard: the reference's ``where(tri, exp(diff), 0)`` overflows above
    the diagonal at chunk 128 and its gradient is 0 · inf = NaN
    (``ROADMAP.md`` queue C), in the hybrid as in Mamba2."""
    jg = dict(flatten_tree(chunk128["j128"][1]))
    assert not np.isfinite(jg["layers.w_zx"]).all()
    assert not np.isfinite(jg["shared_attn.attn.wq"]).all()
    assert np.isfinite(chunk128["j128"][0])
    for path, g in flatten_tree(chunk128["t128"][1]):
        assert np.isfinite(g).all(), path


def test_port_gradient_at_chunk_128_equals_reference_at_chunk_16(chunk128):
    np.testing.assert_allclose(chunk128["t128"][0], chunk128["j16"][0],
                               rtol=1e-6)
    for (path, g), (_, w) in zip(flatten_tree(chunk128["t128"][1]),
                                 flatten_tree(chunk128["j16"][1])):
        assert np.isfinite(w).all(), path
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=path)


def test_one_training_step_matches_the_reference_step():
    """``launch.train.train_step`` against the reference's step function
    (loss, gradients, AdamW; jitted, outside a mesh) from the same
    parameters: loss, gradient norm and every parameter after the step."""
    jc, tc = _cfgs("float32")
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jm = j_get_model(jc)

    @jax.jit
    def jstep(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jm.loss)(params, batch)
        new_p, new_o, metrics = j_adamw_update(JOptConfig(**ocfg), grads,
                                               opt_state, params)
        metrics["loss"] = loss
        return new_p, new_o, metrics

    params = jm.init(jax.random.PRNGKey(5))
    batch = _batch(jc.vocab, seq=32, seed=2)
    jb = jax.tree.map(jnp.asarray, batch)
    jgrad = dict(flatten_tree(_np(jax.grad(jm.loss)(params, jb))))
    tparams = convert.params_from_reference(_np(params), tc, device="cpu")
    jp, _, jmet = jstep(params, j_adamw_init(params), jb)
    model = t_get_model(tc, device="cpu")
    tparams, state, tmet = ttrain.train_step(
        model, tparams, adamw_init(dict(tparams.named_parameters())), batch,
        OptConfig(**ocfg))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    # Band: rtol 1e-5, atol 1e-7, as the Mamba2 resume test, except for at
    # most 1e-3 of the elements, each where the reference's gradient is
    # within 100 · eps (1e-6) of zero and not zero: AdamW's first step is
    # g / (|g| + eps) there, which turns the gradients' f32 band into up
    # to ±lr, so such an element moves by at most 2 · lr (+1%), as in
    # chip_smoke.py's card-vs-CPU step.
    eps, lr, n_out, n_all = 1e-8, 1e-3, 0, 0
    got = convert.params_to_reference(tparams)
    for (p, a), (_, b) in zip(flatten_tree(got), flatten_tree(_np(jp))):
        g = jgrad[p]
        out = ~np.isclose(a, b, rtol=1e-5, atol=1e-7)
        assert ((np.abs(g) < 100 * eps) & (g != 0))[out].all(), p
        assert (np.abs(a - b)[out] <= 2.02 * lr).all(), p
        n_out += int(out.sum())
        n_all += out.size
    assert n_out <= 1e-3 * n_all, n_out
    assert int(state["count"]) == 1


@pytest.mark.parametrize("lr", [3e-4, 3e-5])
def test_repeated_batch_at_full_width_follows_the_reference(lr):
    """Three AdamW steps on one repeated batch from the same parameters,
    at Zamba2's full width (d_model 2560, d_ff 10240, 32 heads) and
    depth cut to 2 layers (one shared-block application), vocab cut to
    4096, 1 × 256 tokens, f32 compute, lr from the first step (warm-up 1),
    the reference at chunk 16 and the port at its own 128.  At lr 3e-4 the
    first update overshoots at this width and the loss rises at the
    second step, in the reference as in the port; at 3e-5 it falls at
    every step in both.  Band: each step's loss and gradient norm within
    ``rtol = 1e-4`` of the reference's: the one-step band (f32 sums in
    another order, ``1e-5``) carried through two AdamW updates, in which
    an element whose gradient is near zero may move by up to ``2 · lr``
    (see ``test_one_training_step_matches_the_reference_step``)."""
    jc = dataclasses.replace(
        jconfigs.get_config(ARCH), n_layers=2, attn_every=2, vocab=4096,
        compute_dtype=jnp.float32, remat_groups=1, q_chunk=128,
        loss_chunk=128, ssm=dataclasses.replace(
            jconfigs.get_config(ARCH).ssm, chunk=16, pallas_conv=False))
    tc = dataclasses.replace(
        tconfigs.get_config(ARCH), n_layers=2, attn_every=2, vocab=4096,
        compute_dtype=torch.float32, q_chunk=128, loss_chunk=128,
        ssm=dataclasses.replace(tconfigs.get_config(ARCH).ssm,
                                pallas_conv=True, conv_tile=256))
    assert (jc.d_model, jc.d_ff, jc.n_heads, tc.ssm.chunk) == (
        2560, 10240, 32, 128)
    ocfg = dict(lr=lr, warmup_steps=1)
    jm = j_get_model(jc)

    @jax.jit
    def jstep(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jm.loss)(params, batch)
        new_p, new_o, metrics = j_adamw_update(JOptConfig(**ocfg), grads,
                                               opt_state, params)
        return new_p, new_o, loss, metrics["grad_norm"]

    batch = JTokenPipeline(JDataConfig(vocab=jc.vocab, seq_len=256,
                                       global_batch=1, seed=0)).batch_at(0)
    jb = jax.tree.map(jnp.asarray, batch)
    params = jm.init(jax.random.PRNGKey(0))
    start = _np(params)
    jp, jo, want = params, j_adamw_init(params), []
    for _ in range(3):
        jp, jo, loss, gnorm = jstep(jp, jo, jb)
        want.append((float(loss), float(gnorm)))
    del params, jp, jo
    model = t_get_model(tc, device="cpu")
    tp = convert.params_from_reference(start, tc, device="cpu")
    del start
    state, got = adamw_init(dict(tp.named_parameters())), []
    for _ in range(3):
        tp, state, met = ttrain.train_step(model, tp, state, batch,
                                           OptConfig(**ocfg))
        got.append((float(met["loss"]), float(met["grad_norm"])))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for losses in ([w[0] for w in want], [g[0] for g in got]):
        if lr == 3e-4:
            assert losses[1] > losses[0], losses
        else:
            assert losses[0] > losses[1] > losses[2], losses


def test_train_cli_trains_the_hybrid(tmp_path, capsys):
    """``--arch zamba2-2.7b`` through the trainer: the loss falls, and a
    checkpoint of the hybrid (the shared block's leaves nested as the
    reference's tree) resumes."""
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--lr", "3e-3",
            "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "4", "--log-every", "100"]
    losses = ttrain.main(args + ["--steps", "8"])
    assert losses[-1] < losses[0]
    resumed = ttrain.main(args + ["--steps", "10"])
    assert "resumed from step 8" in capsys.readouterr().out
    assert len(resumed) == 2
