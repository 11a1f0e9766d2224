"""The PyTorch port against the JAX package, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX launch
(Pallas in interpret mode, at an explicit tile that does not divide the
grid) and through the port with ``device="cpu"`` (the kernels' plain
versions).  f32 results must be equal exactly: both sides apply the taps
in ``zip(offsets, weights)`` order as separate f32 multiplies and adds
(the JAX side under the ISA pin ``tests/conftest.py`` sets, the torch
side as separate ops), and both zero intermediates outside the domain.
bf16 outputs are equal exactly too: both sides round the same f32 sum
once, half to even.

Also checked: the port's launch geometry, IR lowering, input embedding
and program wire format equal the reference's on the same inputs.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import ir as jir  # noqa: E402
from repro.core.cache_fitting import star_stencil as j_star  # noqa: E402
from repro.kernels import stencil as jst  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import ir as tir  # noqa: E402
from repro_torch.kernels import stencil as tst  # noqa: E402
from repro_torch.kernels.ops import (  # noqa: E402
    apply_multi_rhs,
    apply_star_2nd_order,
    apply_stencil,
)

# (shape, offsets, weights, tile, sweep_axis): the 13-point star on a
# 12x13x14 grid, the 41x53 ragged case of tests/test_ring_windows.py, and
# a 1-D conv-style (W-1, 0) asymmetric halo.
_OFF1D = np.array([[-3], [-2], [-1], [0]])
CASES = {
    "star3d": ((12, 13, 14), j_star(3, 2),
               np.linspace(-0.4, 0.5, 13).tolist(), (4, 8, 8), 0),
    "ragged2d": ((41, 53), j_star(2, 2),
                 np.linspace(0.05, -0.35, 9).tolist(), (16, 16), 0),
    "causal1d": ((70,), _OFF1D, [0.1, 0.2, 0.3, -0.4], (8,), 0),
}


def _data(shape, seed=0, n=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _equal(a, b):
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    assert a.shape == b.shape
    assert np.array_equal(a, b), float(np.abs(a - b).max())


@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_single_application_equals_jax(case, pipelined):
    shape, offs, w, tile, sw = CASES[case]
    (x,) = _data(shape)
    ref = jst.stencil_pallas(jnp.asarray(x), offs, w, tile=tile,
                             sweep_axis=sw, pipelined=pipelined,
                             interpret=True)
    got = tst.stencil_pallas(x, offs, w, tile=tile, sweep_axis=sw,
                             pipelined=pipelined, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    _equal(ref, got)


_BOX = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                 for k in (-1, 0, 1)])
# shape, tile, sweep_axis, operator, RHS count, dtype: tiles that do not
# divide the grid, grids thinner than the halo along the sweep axis and
# along c1, the 27-point box's corners, two bf16 RHS
DIRECT_CASES = [
    ((13, 11, 21), (4, 8, 16), 0, "star", 1, "float32"),
    ((3, 13, 14), (4, 8, 8), 0, "star", 1, "float32"),
    ((12, 13, 3), (4, 4, 8), 1, "star", 1, "float32"),
    ((9, 10, 11), (4, 4, 8), 2, "box", 1, "float32"),
    ((10, 9, 20), (4, 4, 16), 0, "star", 2, "bfloat16"),
]


@pytest.mark.parametrize("case", range(len(DIRECT_CASES)))
def test_direct_apply_on_ragged_grids_equals_jax(case):
    """A plain application reads the caller's grid (no launch buffer,
    ``launch_buffers.direct``) and equals the JAX launch, which pads."""
    from repro_torch import obs

    shape, tile, sw, op, p, dtype = DIRECT_CASES[case]
    offs = _BOX if op == "box" else j_star(3, 2)
    ws = [np.linspace(-0.4 + 0.1 * a, 0.5, len(offs)).tolist()
          for a in range(p)]
    xs = _data(shape, seed=case, n=p)
    ref = jst.multi_stencil_pallas(
        [jnp.asarray(x, dtype=dtype) for x in xs], [offs] * p, ws,
        tile=tile, sweep_axis=sw, interpret=True)
    before = obs.totals()["launch_buffers.direct"]
    got = tst.multi_stencil_pallas(
        [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs],
        [offs] * p, ws, tile=tile, sweep_axis=sw, device="cpu")
    assert obs.totals()["launch_buffers.direct"] == before + 1
    assert got.shape == shape and str(got.dtype) == f"torch.{dtype}"
    _equal(ref.astype(jnp.float32), got.float())


@pytest.mark.parametrize("sweep_axis,tile", [(1, (4, 8, 8)), (2, (8, 8, 4))])
def test_other_sweep_axes_equal_jax(sweep_axis, tile):
    shape, offs, w, _, _ = CASES["star3d"]
    (x,) = _data(shape, seed=5)
    ref = jst.stencil_iterate(jnp.asarray(x), offs, w, 2, tile=tile,
                              sweep_axis=sweep_axis, interpret=True)
    got = tst.stencil_iterate(x, offs, w, 2, tile=tile,
                              sweep_axis=sweep_axis, device="cpu")
    _equal(ref, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_rhs_equals_jax(dtype):
    shape, offs, w, tile, sw = CASES["star3d"]
    xs = _data(shape, seed=1, n=2)
    o2 = np.array([[0, 0, 0], [1, 0, 0], [0, -1, 0], [0, 0, 2]])
    w2 = [0.5, -0.25, 0.125, 0.3]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = jst.multi_stencil_pallas(
        [jnp.asarray(x).astype(jd) for x in xs], [offs, o2], [w, w2],
        tile=tile, sweep_axis=sw, interpret=True,
    )
    got = tst.multi_stencil_pallas(
        [torch.from_numpy(x).to(td) for x in xs], [offs, o2], [w, w2],
        tile=tile, sweep_axis=sw, device="cpu",
    )
    assert got.dtype == td
    _equal(np.asarray(ref.astype(jnp.float32)), got.float())


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
@pytest.mark.parametrize("T", [2, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_chain_equals_jax(case, T, window_kind):
    shape, offs, w, tile, sw = CASES[case]
    (x,) = _data(shape, seed=2)
    ref = jst.stencil_iterate(jnp.asarray(x), offs, w, T, tile=tile,
                              sweep_axis=sw, window_kind=window_kind,
                              interpret=True)
    got = tst.stencil_iterate(x, offs, w, T, tile=tile, sweep_axis=sw,
                              window_kind=window_kind, device="cpu")
    _equal(ref, got)


def test_chain_unpipelined_equals_jax():
    shape, offs, w, tile, sw = CASES["ragged2d"]
    (x,) = _data(shape, seed=3)
    ref = jst.stencil_iterate(jnp.asarray(x), offs, w, 3, tile=tile,
                              sweep_axis=sw, pipelined=False,
                              interpret=True)
    got = tst.stencil_iterate(x, offs, w, 3, tile=tile, sweep_axis=sw,
                              pipelined=False, device="cpu")
    _equal(ref, got)


def _hetero_stages():
    return [
        (j_star(3, 1), np.linspace(0.3, -0.2, 7).tolist()),
        (np.array([[-3, 0, 0], [-1, 0, 0], [0, 0, 0], [0, 1, 0], [0, 0, -1]]),
         [0.1, 0.2, -0.3, 0.25, 0.15]),
        (j_star(3, 2), np.linspace(-0.4, 0.5, 13).tolist()),
    ]


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
def test_heterogeneous_stages_equal_jax(window_kind):
    (x,) = _data((17, 19, 21), seed=4)
    stages = _hetero_stages()
    ref = jst.stencil_iterate(jnp.asarray(x), stages=stages, tile=(4, 8, 8),
                              sweep_axis=0, window_kind=window_kind,
                              interpret=True)
    got = tst.stencil_iterate(x, stages=stages, tile=(4, 8, 8),
                              sweep_axis=0, window_kind=window_kind,
                              device="cpu")
    _equal(ref, got)


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
def test_heterogeneous_chain_carried_across_equals_jax(window_kind):
    """The same stages= chain, serialized by the reference's IR and read
    by ``convert.from_reference``, runs bit-equal to the JAX launch."""
    (x,) = _data((17, 19, 21), seed=4)
    stages = _hetero_stages()
    ref = jst.stencil_iterate(jnp.asarray(x), stages=stages, tile=(4, 8, 8),
                              sweep_axis=0, window_kind=window_kind,
                              interpret=True)
    prog, arrays = convert.from_reference(
        jir.chain_program(stages, 3).serialize(), {"u": x}, device="cpu"
    )
    got = tir.run_program(prog, arrays, tile=(4, 8, 8), sweep_axis=0,
                          window_kind=window_kind, device="cpu")
    _equal(ref, got)


def test_stencil_from_reference_casts_weights_to_f32():
    offs, w = convert.stencil_from_reference(j_star(3, 1), [0.1] * 7)
    assert offs.dtype == np.int64 and offs.shape == (7, 3)
    assert w.dtype == np.float32 and w[0] == np.float32(0.1)
    with pytest.raises(ValueError, match="weights"):
        convert.stencil_from_reference(j_star(3, 1), [0.1] * 6)


def _damped_jacobi_program():
    """A two-stage damped-Jacobi chain ``u ← u + ω/diag · K u``: stage 1
    (7-point Laplacian) written as a combine that lowering folds into one
    stage, stage 2 (13-point star) as one apply with the damping folded
    into its weights."""
    k7 = j_star(3, 1)
    k13 = j_star(3, 2)
    w13 = [-7.5] + [4.0 / 3.0, 4.0 / 3.0, -1.0 / 12.0, -1.0 / 12.0] * 3
    om = 0.8 / 7.5
    j13 = [1.0 + om * w13[0]] + [om * w for w in w13[1:]]
    return jir.Program(d=3, ops=(
        jir.Load(result="u0", input="u"),
        jir.Apply(result="a1", operand="u0",
                  offsets=tuple(map(tuple, k7.tolist())),
                  weights=(-6.0,) + (1.0,) * 6),
        jir.Combine(result="c1", operands=("u0", "a1"),
                    coeffs=(1.0, (2.0 / 3.0) / 6.0)),
        jir.Apply(result="c2", operand="c1",
                  offsets=tuple(map(tuple, k13.tolist())),
                  weights=tuple(j13)),
        jir.Store(operand="c2"),
    ))


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
def test_program_carried_across_equals_jax(window_kind):
    """The reference's serialized program, read by ``convert.from_reference``
    and run through the port's ``ir.run_program``."""
    jprog = _damped_jacobi_program()
    (x,) = _data((13, 11, 18), seed=6)
    ref = jir.run_program(jprog, {"u": jnp.asarray(x)}, tile=(4, 8, 8),
                          sweep_axis=0, window_kind=window_kind,
                          interpret=True)
    prog, arrays = convert.from_reference(jprog.serialize(), {"u": x},
                                          device="cpu")
    assert prog.serialize() == jprog.serialize()
    got = tir.run_program(prog, arrays, tile=(4, 8, 8), sweep_axis=0,
                          window_kind=window_kind, device="cpu")
    _equal(ref, got)
    # The same chain spelled as stages=: lowered weights, same launch.
    lowered = tir.lower(prog, x.shape)
    assert lowered.kind == "chain" and len(lowered.stages) == 2
    got2 = tst.stencil_iterate(
        x, stages=[(np.asarray(o), w) for o, w in lowered.stages],
        tile=(4, 8, 8), sweep_axis=0, window_kind=window_kind, device="cpu",
    )
    _equal(got, got2)


def test_ops_api_equals_jax():
    from repro.kernels import ops as jops

    (x,) = _data((12, 13, 14), seed=7)
    ref = jops.apply_star_2nd_order(jnp.asarray(x), tile=(4, 8, 8),
                                    sweep_axis=0, interpret=True)
    _equal(ref, apply_star_2nd_order(x, tile=(4, 8, 8), sweep_axis=0,
                                     device="cpu"))
    offs = j_star(3, 1)
    w = np.linspace(-1.0, 1.0, 7).tolist()
    ref = jops.apply_stencil(jnp.asarray(x), offs, w, tile=(4, 8, 8),
                             sweep_axis=0, time_steps=2, interpret=True)
    _equal(ref, apply_stencil(x, offs, w, tile=(4, 8, 8), sweep_axis=0,
                              time_steps=2, device="cpu"))
    xs = _data((12, 13, 14), seed=8, n=2)
    ref = jops.apply_multi_rhs([jnp.asarray(v) for v in xs], [offs, offs],
                               [w, w[::-1]], tile=(4, 8, 8), sweep_axis=0,
                               interpret=True)
    _equal(ref, apply_multi_rhs(xs, [offs, offs], [w, w[::-1]],
                                tile=(4, 8, 8), sweep_axis=0, device="cpu"))


# -- geometry, lowering, embedding, wire format ------------------------------


def _spec(o, w):
    return (tuple(map(tuple, np.asarray(o).tolist())),
            tuple(float(v) for v in w))


@pytest.mark.parametrize("chain", [False, True])
def test_launch_geometry_equals_jax(chain):
    tile = (4, 8, 8)
    if chain:
        stages_w = tuple(_spec(o, w) for o, w in _hetero_stages())
        args = (stages_w[:1], stages_w, tile)
    else:
        args = ((_spec(j_star(3, 2), range(13)), _spec(j_star(3, 1), range(7))),
                None, tile)
    ref = jst._launch_geometry(*args)
    got = tst._launch_geometry(*args)
    r_offs, r_w, r_st, r_lo, r_hi = ref
    g_offs, g_w, g_st, g_lo, g_hi = got
    assert (r_lo, r_hi) == (g_lo, g_hi)
    assert [list(map(float, w)) for w in r_w] == [list(map(float, w)) for w in g_w]
    for a, b in zip(r_offs, g_offs):
        np.testing.assert_array_equal(a, b)
    if chain:
        assert len(r_st) == len(g_st)
        for a, b in zip(r_st, g_st):
            np.testing.assert_array_equal(a.offsets, b.offsets)
            for field in b._fields[1:]:
                assert getattr(a, field) == getattr(b, field), field
    else:
        assert r_st is None and g_st is None


def test_embed_inputs_equals_jax():
    (x,) = _data((7, 9, 5), seed=9)
    pads = [(2, 3), (0, 1), (4, 0)]
    (ref,) = jst.embed_inputs([jnp.asarray(x)], pads)
    (got,) = tst.embed_inputs([torch.from_numpy(x)], pads)
    _equal(ref, got)


def _programs():
    yield jir.stencil_program(j_star(3, 2), list(range(13)), time_steps=3)
    yield jir.chain_program([(o, w) for o, w in _hetero_stages()], 3)
    yield jir.rhs_program([j_star(2, 1), j_star(2, 2)],
                          [list(range(5)), list(range(9))])
    yield _damped_jacobi_program()
    yield jir.chain_program([(j_star(2, 1), [1.0] * 5)] * 2, 2,
                            boundary=["neumann", ("dirichlet", 2.5)])
    yield jir.chain_program([(j_star(2, 1), [0.5] * 5)] * 2, 2,
                            quants=[(0.05, 3), None])


@pytest.mark.parametrize("idx", range(6))
def test_program_wire_format_and_lowering_equal_jax(idx):
    jprog = list(_programs())[idx]
    text = jprog.serialize()
    prog = tir.Program.from_json(text)
    assert prog.serialize() == text
    assert prog.canonical().serialize() == jprog.canonical().serialize()
    assert tir.summarize_program(prog) == jir.summarize_program(jprog)
    shape = (9, 10, 11)[: jprog.d]
    assert tir.infer_halos(prog) == jir.infer_halos(jprog)
    ref = jir.lower(jprog, shape)
    got = tir.lower(prog, shape)
    assert json.dumps(ref.__dict__, sort_keys=True, default=str) == \
        json.dumps(got.__dict__, sort_keys=True, default=str)
