"""The port's boundary menu against the JAX launch, on the CPU.

The non-sharded cases of ``tests/test_boundary_menu.py`` — box, star and
one-sided operators under periodic and robin boundaries, fused T in {2, 3},
robin corners, the robin degeneracies, per-stage mixed boundaries and the
two verify rejections — plus the paper's 13-point star on a 3-D grid under
dirichlet, neumann and reflect at T in {1, 3}.  The same numpy inputs go
through the JAX launch (Pallas in interpret mode) and through the port
with ``device="cpu"`` (the chain kernel's plain version) at the same tile;
the results must be equal exactly: both sides add the correction terms as
one separate f32 sum in the same order, with the same host-side f32
coefficients.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import ir as jir  # noqa: E402
from repro.kernels.stencil import multi_stencil_pallas  # noqa: E402
from repro_torch import ir as tir  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.kernels.ref import star_weights_2nd_order  # noqa: E402

# The operators of tests/test_boundary_menu.py: a box(2, 1) whose corner
# ghosts are read, an asymmetric star, a fully one-sided (W-1, 0) trail.
BOX = np.array([(i, j) for i in (-1, 0, 1) for j in (-1, 0, 1)])
BOX_W = [0.02 * k - 0.07 for k in range(9)]
STAR = np.array([(0, 0), (-1, 0), (1, 0), (0, -1), (0, 2)])
STAR_W = [0.3, 0.2, 0.15, 0.1, 0.05]
TRAIL = np.array([(0, 0), (-1, 0), (-2, 0), (0, -1), (-1, -2)])
TRAIL_W = [0.4, 0.25, 0.1, 0.15, 0.05]
O13, W13 = star_weights_2nd_order(3, 2)


def _u(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(u, jprog, tile, window_kind="ring"):
    """The JAX launch and the port's launch of one program."""
    want = multi_stencil_pallas([jnp.asarray(u)], None, None, program=jprog,
                                tile=tile, window_kind=window_kind,
                                interpret=True)
    got = tir.run_program(tir.Program.from_json(jprog.serialize()), u,
                          tile=tile, window_kind=window_kind, device="cpu")
    return np.asarray(want), got.numpy()


def _chain(offs, w, steps, kind, value, d):
    return jir.chain_program([(offs, w)] * steps, d, boundary=kind,
                             value=value)


def _equal(want, got):
    assert want.shape == got.shape and want.dtype == got.dtype
    assert np.array_equal(want, got), float(np.abs(want - got).max())


@pytest.mark.parametrize("offs,w", [(BOX, BOX_W), (STAR, STAR_W),
                                    (TRAIL, TRAIL_W)])
@pytest.mark.parametrize("kind,value", [("periodic", 0.0),
                                        ("robin", (0.7, 0.3))])
def test_single_application_equals_jax(offs, w, kind, value):
    """T = 1, corner-reading box / asymmetric star / one-sided trail taps:
    a one-stage chain launch with correction taps (or the wrap fill)."""
    before = obs.totals()["launches.sweep_apply"]
    _equal(*_both(_u((24, 32)), _chain(offs, w, 1, kind, value, 2),
                  (8, 16)))
    assert obs.totals()["launches.sweep_apply"] == before


@pytest.mark.parametrize("kind,value", [("periodic", 0.0),
                                        ("robin", (-0.6, 0.25))])
@pytest.mark.parametrize("steps", [2, 3])
def test_fused_chain_equals_jax(kind, value, steps):
    """Fused T >= 2: intermediate values are conditioned in-kernel too."""
    _equal(*_both(_u((16, 32), seed=3),
                  _chain(STAR, STAR_W, steps, kind, value, 2), (16, 32)))


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
def test_fused_one_sided_periodic_equals_jax(window_kind):
    """(W-1, 0) halos under wrap, fused two stages deep."""
    _equal(*_both(_u((24, 32), seed=5),
                  _chain(TRAIL, TRAIL_W, 2, "periodic", 0.0, 2), (12, 16),
                  window_kind))


def test_robin_corner_single_application_equals_jax():
    """The affine ghost mix is applied once where two faces meet."""
    _equal(*_both(_u((8, 16), seed=9),
                  _chain(BOX, BOX_W, 1, "robin", (0.5, -1.25), 2), (8, 16)))


def test_robin_degenerates_to_dirichlet_and_neumann():
    """robin(0, beta) is dirichlet(beta) and robin(1, 0) is neumann, bit
    for bit in the port, and each equals the JAX launch."""
    u = _u((16, 16), seed=11)
    beta = 0.75
    rob0 = _both(u, _chain(STAR, STAR_W, 2, "robin", (0.0, beta), 2),
                 (16, 16))
    dir_ = _both(u, _chain(STAR, STAR_W, 2, "dirichlet", beta, 2), (16, 16))
    _equal(*rob0)
    _equal(rob0[1], dir_[1])
    rob1 = _both(u, _chain(STAR, STAR_W, 2, "robin", (1.0, 0.0), 2),
                 (16, 16))
    neu = _both(u, _chain(STAR, STAR_W, 2, "neumann", 0.0, 2), (16, 16))
    _equal(*rob1)
    _equal(rob1[1], neu[1])


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
def test_mixed_bc_chain_equals_jax(window_kind):
    """Per-stage mixed menu: robin input stage, neumann intermediate."""
    prog = jir.chain_program(
        [(STAR, STAR_W), (BOX, BOX_W)], 2,
        boundary=[("robin", (0.4, 0.6)), ("neumann", 0.0)],
    )
    _equal(*_both(_u((16, 32), seed=13), prog, (16, 32), window_kind))


def test_periodic_is_all_or_nothing():
    """Mixing wrap with any other kind has no single-domain embedding —
    both packages' verify reject it, and so does the port's launch."""
    stages = [(STAR, STAR_W), (STAR, STAR_W)]
    jprog = jir.chain_program(stages, 2, boundary=["periodic", "neumann"])
    with pytest.raises(jir.IRVerifyError):
        jir.lower(jprog, shape=(16, 32))
    prog = tir.Program.from_json(jprog.serialize())
    with pytest.raises(tir.IRVerifyError):
        tir.lower(prog, shape=(16, 32))
    with pytest.raises(tir.IRVerifyError):
        tir.run_program(prog, _u((16, 32)), tile=(8, 16), device="cpu")


def test_periodic_reach_exceeding_domain_rejected():
    """A wrap halo deeper than the axis (reach 5 > extent 4) has no
    single-copy ghost source."""
    jprog = jir.chain_program([(STAR, STAR_W)] * 5, 2, boundary="periodic")
    with pytest.raises(jir.IRVerifyError, match="exceeds the domain extent"):
        jir.lower(jprog, shape=(4, 32))
    with pytest.raises(tir.IRVerifyError, match="exceeds the domain extent"):
        tir.lower(tir.Program.from_json(jprog.serialize()), shape=(4, 32))


@pytest.mark.parametrize("T,window_kind", [(1, "ring"), (3, "ring"),
                                           (3, "trapezoid")])
@pytest.mark.parametrize("kind,value", [("dirichlet", 0.5),
                                        ("neumann", 0.0),
                                        ("reflect", 0.0)])
def test_star13_3d_equals_jax(kind, value, T, window_kind):
    """The paper's 13-point star on a 12x13x14 grid at a tile that does
    not divide it, under each of the three tap-corrected boundaries."""
    _equal(*_both(_u((12, 13, 14), seed=17),
                  _chain(O13, W13, T, kind, value, 3), (4, 8, 8),
                  window_kind))


@pytest.mark.parametrize("fill,pad_free", [(0, False), (0, True), (-3, True)])
def test_embed_inputs_wrap_and_fill_equal_jax(fill, pad_free):
    """The periodic ghost fill (corners composed axis by axis, as
    ``np.pad(mode="wrap")``) and a zero-point background, as the
    reference's ``embed_inputs`` builds them; round-up slack keeps
    ``fill``."""
    from repro.kernels import stencil as jst
    from repro_torch.kernels import stencil as tst

    x = np.random.default_rng(19).integers(-100, 100, (7, 9, 5)).astype(
        np.int8)
    pads = [(2, 3), (1, 2), (2, 4)]
    wrap = ((2, 2), (1, 1), (2, 1))
    (want,) = jst.embed_inputs([jnp.asarray(x)], pads, pad_free=pad_free,
                               wrap=wrap, fill=fill)
    (got,) = tst.embed_inputs([torch.from_numpy(x)], pads,
                              pad_free=pad_free, wrap=wrap, fill=fill)
    assert got.dtype == torch.int8
    _equal(np.asarray(want), got.numpy())
