"""Per-stage storage dtypes and int8-quantized frontiers of the port
against the JAX launch, on the CPU.

The dtype cases of ``tests/test_ring_windows.py`` — bf16, ``None`` and f32
stages, a bf16 input chain, the jnp/torch and string spellings of a dtype,
and ``"float17"`` refused with ``TypeError`` — plus int8-quantized chains
and the quantized hand-off between launches (``_stencil_call(in_quant=)``
on the same int8 buffer in both packages).  The same numpy inputs go
through the JAX launch (interpret mode) and the port at ``device="cpu"``
at the same tile, and the results must be equal exactly, int8 codes
included: both sides quantize with an IEEE divide and half-even rounding
of the same f32 sum.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import ir as jir  # noqa: E402
from repro.core.cache_fitting import star_stencil  # noqa: E402
from repro.kernels import stencil as jst  # noqa: E402
from repro_torch import ir as tir  # noqa: E402
from repro_torch.kernels import stencil as tst  # noqa: E402

OFFS = star_stencil(2, 1)
W = np.linspace(-0.3, 0.4, len(OFFS)).tolist()
KW = dict(tile=(8, 16), sweep_axis=0)
O13 = star_stencil(3, 2)
W13 = np.linspace(-0.4, 0.5, 13).tolist()


def _u(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    """A result of either package as numpy (bf16 widened to f32 exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _equal(want, got):
    a, b = _np(want), _np(got)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b), float(np.abs(a.astype(np.float32)
                                              - b.astype(np.float32)).max())


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
def test_bf16_frontiers_equal_jax(window_kind):
    u = _u((40, 48))
    dts = ["bfloat16", "bfloat16", "float32"]
    want = jst.stencil_iterate(jnp.asarray(u), OFFS, W, 3, dtypes=dts,
                               window_kind=window_kind, interpret=True, **KW)
    got = tst.stencil_iterate(u, OFFS, W, 3, dtypes=dts,
                              window_kind=window_kind, device="cpu", **KW)
    assert got.dtype == torch.float32  # the last stage's dtype wins
    _equal(want, got)
    # ... and materially different from the f32 chain: the cast happened.
    f32 = tst.stencil_iterate(u, OFFS, W, 3, device="cpu", **KW)
    assert not torch.equal(got, f32)


def test_bf16_input_chain_and_output_dtype_equal_jax():
    """A bf16 input with default stage dtypes stays bf16 end to end."""
    ub = torch.from_numpy(_u((33, 40))).to(torch.bfloat16)
    want = jst.stencil_iterate(jnp.asarray(ub.float().numpy()).astype(
        jnp.bfloat16), OFFS, W, 2, interpret=True, **KW)
    got = tst.stencil_iterate(ub, OFFS, W, 2, device="cpu", **KW)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _equal(want, got)


def test_f32_and_none_stages_are_the_zero_fill_launch():
    """Stages that restate the input dtype (``None``, ``"float32"``) are the
    same launch as no dtypes at all, in both packages."""
    u = _u((37, 45), seed=1)
    dts = [None, "float32", None]
    want = jst.stencil_iterate(jnp.asarray(u), OFFS, W, 3, dtypes=dts,
                               interpret=True, **KW)
    got = tst.stencil_iterate(u, OFFS, W, 3, dtypes=dts, device="cpu", **KW)
    _equal(want, got)
    assert torch.equal(got, tst.stencil_iterate(u, OFFS, W, 3, device="cpu",
                                                **KW))


def test_bf16_stage_of_a_bf16_input_then_f32_equals_jax():
    """A bf16 input whose last stage stores f32: bf16 in, f32 out."""
    ub = torch.from_numpy(_u((24, 32), seed=2)).to(torch.bfloat16)
    dts = [None, "float32"]
    want = jst.stencil_iterate(jnp.asarray(ub.float().numpy()).astype(
        jnp.bfloat16), OFFS, W, 2, dtypes=dts, interpret=True, **KW)
    got = tst.stencil_iterate(ub, OFFS, W, 2, dtypes=dts, device="cpu", **KW)
    assert got.dtype == torch.float32
    _equal(want, got)


def test_dtype_spellings_equal_jax():
    """jnp dtypes, torch dtypes, numpy dtypes and names are one request."""
    u = _u((40, 48), seed=3)
    want = jst.stencil_iterate(
        jnp.asarray(u), OFFS, W, 3,
        dtypes=[jnp.bfloat16, "bfloat16", jnp.float32], interpret=True, **KW)
    for dts in (["bfloat16", "bfloat16", "float32"],
                [torch.bfloat16, "bfloat16", torch.float32],
                [jnp.bfloat16, jnp.dtype("bfloat16"), np.float32]):
        _equal(want, tst.stencil_iterate(u, OFFS, W, 3, dtypes=dts,
                                         device="cpu", **KW))


def test_unknown_dtype_name_raises_type_error():
    u = _u((40, 48))
    with pytest.raises(TypeError):
        jst.stencil_iterate(jnp.asarray(u), OFFS, W, 2,
                            dtypes=["float17", None], interpret=True, **KW)
    with pytest.raises(TypeError):
        tst.stencil_iterate(u, OFFS, W, 2, dtypes=["float17", None],
                            device="cpu", **KW)


def test_dtypes_of_a_multi_rhs_launch_raise():
    us = [_u((24, 32), seed=s) for s in (4, 5)]
    with pytest.raises(ValueError, match="single-RHS"):
        jst.multi_stencil_pallas([jnp.asarray(v) for v in us], [OFFS, OFFS],
                                 [W, W], dtypes=["bfloat16"], interpret=True,
                                 **KW)
    with pytest.raises(ValueError, match="single-RHS"):
        tst.multi_stencil_pallas(us, [OFFS, OFFS], [W, W],
                                 dtypes=["bfloat16"], device="cpu", **KW)


# -- int8-quantized frontiers -------------------------------------------------


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
@pytest.mark.parametrize("quants,bc", [
    ([(0.02, 3), None], None),
    ([(0.05, -7), (0.1, 0), None], "reflect"),
    ([None, (0.02, 3), None], ("robin", (0.7, 0.3))),
])
def test_quantized_chain_equals_jax(quants, bc, window_kind):
    """int8 frontiers: the codes, the dequantized reads and the masked
    zeros (code zp) are those of the JAX launch, exactly."""
    u = _u((12, 13, 14), seed=8) * np.float32(0.05)
    kind, value = bc if isinstance(bc, tuple) else (bc, 0.0)
    jprog = jir.chain_program([(O13, W13)] * len(quants), 3, boundary=kind,
                              value=value, quants=quants)
    kw = dict(tile=(4, 8, 8), sweep_axis=0, window_kind=window_kind)
    want = jir.run_program(jprog, jnp.asarray(u), interpret=True, **kw)
    got = tir.run_program(tir.Program.from_json(jprog.serialize()), u,
                          device="cpu", **kw)
    _equal(want, got)


def _spec(o, w):
    return (tuple(map(tuple, np.asarray(o).tolist())),
            tuple(float(v) for v in w))


@pytest.mark.parametrize("last", ["float32", "int8"])
def test_in_quant_launch_equals_jax(last):
    """The quantized hand-off: one launch reads int8 codes with
    ``in_quant`` (the buffer padded with the zero point); its last stage
    stores f32, or int8 codes again."""
    q_in = (0.05, -3)
    codes = np.random.default_rng(9).integers(-128, 128, (12, 13, 14),
                                              dtype=np.int8)
    sw = (_spec(O13, W13),) * 2
    quants = (None, (0.1, 4) if last == "int8" else None)
    args = dict(stages_w=sw, bcs_w=(("neumann", 0.0),) * 2,
                dtypes_w=("bfloat16", last), quants_w=quants,
                in_quant=q_in)
    want = jst._stencil_call((jnp.asarray(codes),), sw[:1], (4, 8, 8), 0,
                             True, True, **args)
    got = tst._stencil_call((torch.from_numpy(codes),), sw[:1], (4, 8, 8), 0,
                            True, **args)
    assert got.dtype == {"float32": torch.float32, "int8": torch.int8}[last]
    _equal(want, got)


def test_split_chain_equals_fused():
    """A quantized chain split after stage 1 into two launches — int8
    codes handed over through ``in_quant`` — equals the fused launch."""
    u = _u((12, 13, 14), seed=10) * np.float32(0.05)
    q = (0.02, 3)
    sw = (_spec(O13, W13),) * 3
    bcs = (("reflect", 0.0),) * 3
    fused = tst._stencil_call((torch.from_numpy(u),), sw[:1], (4, 8, 8), 0,
                              True, stages_w=sw, bcs_w=bcs,
                              dtypes_w=("int8", "int8", "float32"),
                              quants_w=(q, q, None))
    codes = tst._stencil_call((torch.from_numpy(u),), sw[:1], (4, 8, 8), 0,
                              True, stages_w=sw[:2], bcs_w=bcs[:2],
                              dtypes_w=("int8", "int8"), quants_w=(q, q))
    assert codes.dtype == torch.int8
    split = tst._stencil_call((codes,), sw[2:], (4, 8, 8), 0, True,
                              stages_w=sw[2:], bcs_w=bcs[2:],
                              dtypes_w=("float32",), in_quant=q)
    assert torch.equal(split, fused)


def test_int8_stage_without_quantization_is_refused():
    """An int8 stage is a quantized one: without ``(scale, zero_point)``
    the chain kernel has no rounding to store it with."""
    u = torch.from_numpy(_u((12, 13, 14)))
    sw = (_spec(O13, W13),) * 2
    with pytest.raises(ValueError, match="int8"):
        tst._stencil_call((u,), sw[:1], (4, 8, 8), 0, True, stages_w=sw,
                          dtypes_w=("int8", "float32"))


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
def test_program_json_with_every_op_round_trips_and_equals_jax(window_kind):
    """A reference program with boundary, quantize and dequantize ops and
    an ``Apply.dtype``, serialized by the reference and read by
    ``convert.from_reference``: the same wire format, the same lowering
    and the same result as the JAX launch."""
    from repro_torch import convert

    k13 = tuple(map(tuple, O13.tolist()))
    w13 = tuple(W13)
    jprog = jir.Program(d=3, ops=(
        jir.Load(result="u0", input="u"),
        jir.Boundary(result="b0", operand="u0", kind="reflect"),
        jir.Apply(result="a1", operand="b0", offsets=k13, weights=w13),
        jir.Quantize(result="q1", operand="a1", scale=0.02, zero_point=3),
        jir.Dequantize(result="d1", operand="q1", scale=0.02, zero_point=3),
        jir.Boundary(result="b1", operand="d1", kind="robin",
                     value=(0.7, 0.3)),
        jir.Apply(result="a2", operand="b1", offsets=k13, weights=w13,
                  dtype="bfloat16"),
        jir.Boundary(result="b2", operand="a2", kind="dirichlet", value=0.5),
        jir.Apply(result="a3", operand="b2", offsets=k13, weights=w13,
                  dtype="float32"),
        jir.Store(operand="a3"),
    ))
    u = _u((12, 13, 14), seed=11) * np.float32(0.05)
    prog, arrays = convert.from_reference(jprog.serialize(), {"u": u},
                                          device="cpu")
    assert prog.serialize() == jprog.serialize()
    shape = (12, 13, 14)
    want_low, got_low = jir.lower(jprog, shape), tir.lower(prog, shape)
    assert got_low.bcs == want_low.bcs and got_low.quants == want_low.quants
    assert got_low.dtypes == want_low.dtypes == ("int8", "bfloat16",
                                                 "float32")
    kw = dict(tile=(4, 8, 8), sweep_axis=0, window_kind=window_kind)
    want = jir.run_program(jprog, {"u": jnp.asarray(u)}, interpret=True,
                           **kw)
    _equal(want, tir.run_program(prog, arrays, device="cpu", **kw))
