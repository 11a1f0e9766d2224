"""The port's causal conv1d (``repro_torch.kernels.conv1d``) against the
JAX package's Pallas kernel, on the CPU.

The same inputs, made from a seed with numpy, go through
``repro.kernels.conv1d.causal_conv1d`` (Pallas in interpret mode, as its
own tests run it) and through the port with ``device="cpu"`` (the
kernel's plain version).  Both build the pre-activation in f32 in the same
order, so it agrees exactly; silu's sigmoid is XLA's ``logistic`` on one
side and ATen's ``sigmoid`` on the other, which differ by about an ulp.
Tolerances, stated per dtype:

* f32 output: ``atol = rtol = 1e-6`` — a few f32 ulps of outputs of
  magnitude up to ~4 (ulp 4.8e-7), from the sigmoid alone;
* bf16 output: one bf16 ulp (``rtol = 2**-8``, ``atol = 2**-16`` for
  outputs near 0) — an ulp of difference in f32 can move the rounding to
  bf16 by one step when it falls on a rounding boundary.

The custom VJP (``conv1d.py:141-181``) is ported as a
``torch.autograd.Function`` whose backward is plain torch math; its
gradients are held against ``jax.grad`` of the reference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import conv1d as jconv  # noqa: E402
from repro_torch.core.tiling import H100_SXM  # noqa: E402
from repro_torch.kernels import conv1d as tconv  # noqa: E402
from repro_torch.plan import PlanCache, Planner, planner  # noqa: E402

TOL = {
    "float32": dict(atol=1e-6, rtol=1e-6),
    "bfloat16": dict(atol=2.0 ** -16, rtol=2.0 ** -8),
}
# (batch, seq, channels, tile_s): a length the tile does not divide, and a
# single token.
SHAPES = [(2, 37, 24, 8), (3, 1, 16, 4)]


def _inputs(b, s, c, width, with_state, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    w = (rng.standard_normal((width, c)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal((c,)) * 0.1).astype(np.float32)
    state = (rng.standard_normal((b, width - 1, c)).astype(np.float32)
             if with_state else None)
    return x, w, bias, state


def _jax(x, w, bias, state, tile_s, dtype):
    jd = getattr(jnp, dtype)
    out = jconv.causal_conv1d(
        jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(bias, jd),
        tile_s=tile_s, interpret=True,
        state=None if state is None else jnp.asarray(state, jd),
    )
    return np.asarray(out.astype(jnp.float32))


def _port(x, w, bias, state, tile_s, dtype):
    td = getattr(torch, dtype)
    out = tconv.causal_conv1d(
        torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
        torch.from_numpy(bias).to(td), tile_s=tile_s,
        state=None if state is None else torch.from_numpy(state).to(td),
        device="cpu",
    )
    assert out.dtype == td
    return out.float().numpy()


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("width", [4, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["ragged37", "one_token"])
def test_conv_matches_reference(shape, dtype, width, with_state):
    b, s, c, tile_s = shape
    x, w, bias, state = _inputs(b, s, c, width, with_state)
    want = _jax(x, w, bias, state, tile_s, dtype)
    got = _port(x, w, bias, state, tile_s, dtype)
    assert got.shape == (b, s, c)
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_result_does_not_depend_on_the_tile(dtype):
    """Several tiles, one of them past S: the port's result is the same bit
    for bit, and each equals the reference at its tile within the band."""
    x, w, bias, state = _inputs(2, 45, 40, 4, True, seed=1)
    outs = {t: _port(x, w, bias, state, t, dtype) for t in (5, 16, 64)}
    for t, out in outs.items():
        assert np.array_equal(out, outs[5]), t
    np.testing.assert_allclose(outs[16], _jax(x, w, bias, state, 16, dtype),
                               **TOL[dtype])


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_prepend_halo_matches_reference(with_state):
    x, w, _, state = _inputs(2, 13, 8, 4, with_state)
    want, want_t = jconv._prepend_halo(
        jnp.asarray(x), jnp.asarray(w),
        None if state is None else jnp.asarray(state), 5)
    got, got_t = tconv._prepend_halo(
        torch.from_numpy(x), torch.from_numpy(w),
        None if state is None else torch.from_numpy(state), 5)
    assert got_t == want_t
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [4, 3])
def test_vjp_matches_jax_grad(width, dtype):
    """Gradients of sum(out · g) through the port's autograd Function
    against ``jax.grad`` through the reference's custom VJP.  Both compute
    the backward in f32 from the same formulas; the sums over batch and
    sequence (dw, db) run in another order, so f32 carries
    ``atol = rtol = 1e-5``; bf16 gradients are rounded once from f32, one
    bf16 ulp (``rtol = 2**-8``) beside that."""
    b, s, c = 2, 29, 16
    x, w, bias, _ = _inputs(b, s, c, width, False, seed=2)
    g = np.random.default_rng(3).standard_normal((b, s, c)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(x_, w_, b_):
        out = jconv.causal_conv1d(x_, w_, b_, tile_s=8, interpret=True)
        return (out.astype(jnp.float32) * g).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(bias, jd))
    xs = [torch.from_numpy(a).to(td).requires_grad_() for a in (x, w, bias)]
    out = tconv.causal_conv1d(*xs, tile_s=8, device="cpu")
    (out.float() * torch.from_numpy(g)).sum().backward()
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == "float32"
           else dict(atol=1e-5, rtol=2.0 ** -8))
    for t, ref, name in zip(xs, want, ("dx", "dw", "db")):
        assert t.grad.dtype == td, name
        np.testing.assert_allclose(
            t.grad.float().numpy(), np.asarray(ref.astype(jnp.float32)),
            err_msg=name, **tol)


@pytest.mark.parametrize("with_state", [False, True])
def test_planned_tile_equals_explicit_tile(with_state, monkeypatch):
    """``tile_s=None`` plans the (S, C) grid with halo (W-1, 0), as the
    reference's ``_planned_tile_s`` does, rounded up to the kernel's
    32-token runs; the result does not depend on the tile."""
    monkeypatch.setattr(planner, "_DEFAULT",
                        Planner(cache=PlanCache(persistent=False)))
    x, w, bias, state = _inputs(2, 37, 24, 4, with_state)
    planned = tconv._planned_tile_s(37, 24, 4, 4, H100_SXM.key())
    assert planned % tconv._RUN == 0
    got = tconv.causal_conv1d(x, w, bias, state=state, device="cpu")
    want = tconv.causal_conv1d(x, w, bias, tile_s=8, state=state,
                               device="cpu")
    assert torch.equal(got, want)


def test_plain_version_refuses_bad_shapes():
    x = torch.zeros(2, 8, 6)
    with pytest.raises(ValueError, match="conv_w"):
        tconv.causal_conv1d_launch(x, torch.zeros(4, 5), torch.zeros(6), 4)
    with pytest.raises(ValueError, match="state"):
        tconv.causal_conv1d_launch(x, torch.zeros(4, 6), torch.zeros(6), 4,
                                   state=torch.zeros(2, 2, 6))
    with pytest.raises(TypeError, match="f32 or bf16"):
        tconv.causal_conv1d_launch(x.half(), torch.zeros(4, 6),
                                   torch.zeros(6), 4)
