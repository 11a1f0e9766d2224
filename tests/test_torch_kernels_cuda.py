"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (a CUDA kernel has no CPU mode; its plain version is tested on the
CPU in ``tests/test_torch_kernels_plain.py``).  The module imports only
torch, numpy and the port, so it runs on a machine without jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Kernel and plain version must agree bit for bit: both apply the taps in
``zip(offsets, weights)`` order as separate f32 multiplies and adds (the
kernels are built with ``--fmad=false``), add the boundary corrections as
one separate sum, and round each stage the same way (bf16 round to
nearest even; int8 codes by the IEEE divide and half-even ``rint``).

The conv kernel (``csrc/conv1d.cu``) equals its plain version bit for bit
too: the same f32 multiply-adds in the same order, and silu as
``acc * (1 / (1 + exp(-acc)))``, the form ATen's f32 sigmoid takes on the
card.  The Mamba2 smoke model on the card is held against the CPU within
the band of ``tests/test_torch_mamba2.py`` for bf16.

The differential corpus of ``tests/test_program_fuzz.py`` runs here too:
:func:`corpus_spec` is a jax-free copy of its ``gen_spec``, held equal to
the original seed by seed in ``tests/test_torch_program_corpus.py``.
"""

import itertools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import ir, obs  # noqa: E402
from repro_torch.core.cache_fitting import star_stencil  # noqa: E402
from repro_torch.core.tiling import (  # noqa: E402
    apply_smem_bytes,
    halo_from_offsets,
    launch_smem,
    sweep_smem_bytes,
)
from repro_torch.kernels import conv1d, sweep  # noqa: E402
from repro_torch.kernels import stencil as st  # noqa: E402

pytestmark = pytest.mark.cuda


def _launches(*kernels):
    """Kernel launches on the card so far, summed over ``kernels``
    (``repro_torch.obs.totals()``'s ``launches.<kernel>``)."""
    t = obs.totals()
    return sum(t[f"launches.{k}"] for k in kernels)

CASES = [
    # shape, tile, sweep_axis
    ((12, 13, 14), (4, 8, 8), 0),
    ((12, 13, 14), (4, 4, 8), 1),
    ((12, 13, 14), (8, 8, 4), 2),
    ((33, 40, 70), (4, 16, 32), 0),
    ((41, 53), (16, 16), 0),
    ((70,), (8,), 0),
]


BOX27 = np.array(list(itertools.product((-1, 0, 1), repeat=3)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _spec(o, w):
    return (tuple(map(tuple, np.asarray(o).tolist())),
            tuple(float(v) for v in w))


def _launch(shape, tile, offsets_w, stages_w=None, n=1, dtype=torch.float32,
            device="cpu", seed=0, **kw):
    rng = np.random.default_rng(seed)
    if kw.get("in_quant") is not None:
        us = [torch.from_numpy(rng.integers(-128, 128, shape, np.int8))
              .to(device) for _ in range(n)]
    else:
        us = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              .to(device, dtype) for _ in range(n)]
    return (us, *st._launch_inputs(us, offsets_w, tile, stages_w, **kw))


def _same_bits(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.element_size() == 1:
        return torch.equal(a, b)
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_sweep_apply_equals_plain(dev, case, pipelined, dtype):
    shape, tile, sw = CASES[case]
    d = len(shape)
    specs = (_spec(star_stencil(d, 2), np.linspace(-0.4, 0.5, 4 * d + 1)),
             _spec(star_stencil(d, 1), np.linspace(0.3, -0.2, 2 * d + 1)))
    _, ins, o, ws, _, lo_w, hi_w = _launch(shape, tile, specs, n=2,
                                           dtype=dtype, device=dev)
    before = _launches("sweep_apply")
    k = sweep.sweep_apply(ins, o, ws, lo_w, hi_w, tile, sw, pipelined)
    assert _launches("sweep_apply") == before + 1
    p = sweep.sweep_apply_plain(ins, o, ws, lo_w, hi_w, tile, sw)
    torch.cuda.synchronize()
    assert _same_bits(k, p)


def _apply_ops(d, p):
    """p operators cycling through the compiled shapes (7- and 13-point
    stars, the 27-point box in 3-D) and two the kernel does not compile
    (a star in reversed order, and one tap reaching 2 along each axis)."""
    box = np.array(list(itertools.product((-1, 0, 1), repeat=d)))
    far = np.array([[2] * d, [0] * d, [-2] * d])
    ops = [star_stencil(d, 2), star_stencil(d, 1)[::-1], star_stencil(d, 1),
           box, far]
    return tuple(_spec(ops[a % len(ops)],
                       np.linspace(-0.5 + 0.1 * a, 0.4, len(ops[a % len(ops)])))
                 for a in range(p))


# shape, tile, sweep_axis: each sweep axis, at tiles whose 8 f32 rings
# fit a block's shared memory
RHS_CASES = [((12, 13, 14), (4, 8, 8), 0), ((12, 13, 14), (4, 4, 8), 1),
             ((12, 13, 14), (8, 8, 4), 2), ((33, 40, 70), (4, 8, 32), 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", range(1, 9))
@pytest.mark.parametrize("case", range(len(RHS_CASES)))
def test_sweep_apply_rhs_counts_and_operators_equal_plain(dev, case, p,
                                                          dtype):
    """1 to 8 RHS, each sweep axis, compiled and table-driven operators
    in one launch."""
    shape, tile, sw = RHS_CASES[case]
    specs = _apply_ops(len(shape), p)
    _, ins, o, ws, _, lo_w, hi_w = _launch(shape, tile, specs, n=p,
                                           dtype=dtype, device=dev, seed=p)
    k = sweep.sweep_apply(ins, o, ws, lo_w, hi_w, tile, sw)
    pl = sweep.sweep_apply_plain(ins, o, ws, lo_w, hi_w, tile, sw)
    torch.cuda.synchronize()
    assert _same_bits(k, pl)


@pytest.mark.parametrize("offset", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [0, 1, 2, 3, 4])
def test_sweep_apply_misaligned_inputs_equal_plain(dev, case, dtype, offset):
    """Each RHS buffer starts `offset` elements into its allocation (a
    different offset for the second), so rows meet shared memory at
    every alignment; the piecewise copies keep the result exact."""
    shape, tile, sw = CASES[case]
    specs = _apply_ops(len(shape), 2)
    _, ins, o, ws, _, lo_w, hi_w = _launch(shape, tile, specs, n=2,
                                           dtype=dtype, device=dev)
    moved = []
    for a, x in enumerate(ins):
        off = offset + 3 * a
        flat = torch.empty(x.numel() + off, dtype=dtype, device=dev)
        view = flat[off:].view(x.shape)
        view.copy_(x)
        moved.append(view)
    k = sweep.sweep_apply(moved, o, ws, lo_w, hi_w, tile, sw)
    pl = sweep.sweep_apply_plain(ins, o, ws, lo_w, hi_w, tile, sw)
    torch.cuda.synchronize()
    assert _same_bits(k, pl)


# shape, tile, sweep_axis, offsets: sweep offsets beyond the kernel's
# register-block reach (kReach = 2), which the table-driven loop wraps
# row by row; the last 1-D case reaches farther than a tile's rows.
FAR_CASES = [
    ((70,), (8,), 0, [[-3], [0], [3]]),
    ((70,), (4,), 0, [[-5], [1], [4]]),
    ((41, 53), (16, 16), 0, star_stencil(2, 3)),
    ((12, 13, 14), (4, 8, 8), 0, star_stencil(3, 3)),
    ((12, 13, 14), (4, 4, 8), 1, star_stencil(3, 3)),
    ((12, 13, 14), (8, 8, 4), 2, star_stencil(3, 3)),
]


@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(FAR_CASES)))
def test_sweep_apply_far_sweep_offsets_equal_plain(dev, case, dtype,
                                                   pipelined):
    """Sweep reaches of 3 and 5, at each sweep axis, held bit for bit."""
    shape, tile, sw, offs = FAR_CASES[case]
    offs = np.asarray(offs)
    specs = (_spec(offs, np.linspace(-0.45, 0.35, len(offs))),)
    _, ins, o, ws, _, lo_w, hi_w = _launch(shape, tile, specs, dtype=dtype,
                                           device=dev, seed=case)
    assert max(lo_w[sw], hi_w[sw]) >= 3
    k = sweep.sweep_apply(ins, o, ws, lo_w, hi_w, tile, sw, pipelined)
    pl = sweep.sweep_apply_plain(ins, o, ws, lo_w, hi_w, tile, sw)
    torch.cuda.synchronize()
    assert _same_bits(k, pl)


@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sweep_apply_partial_wave_equals_plain(dev, dtype, pipelined):
    """357 tile columns (21 × 17): a grid that leaves its last wave of
    CTAs partly filled on any SM count, at the smoke's tile."""
    shape, tile = (24, 336, 520), (8, 16, 32)
    specs = (_spec(star_stencil(3, 2), np.linspace(-0.4, 0.5, 13)),)
    _, ins, o, ws, _, lo_w, hi_w = _launch(shape, tile, specs, dtype=dtype,
                                           device=dev)
    k = sweep.sweep_apply(ins, o, ws, lo_w, hi_w, tile, 0, pipelined)
    pl = sweep.sweep_apply_plain(ins, o, ws, lo_w, hi_w, tile, 0)
    torch.cuda.synchronize()
    assert _same_bits(k, pl)


@pytest.mark.parametrize("sw", [0, 1, 2])
def test_sweep_apply_occupancy_at_the_smoke_tile(dev, sw):
    """At the smoke's tile, a CTA of APPLY_THREADS threads fits an SM, for
    the kernel built for each sweep axis."""
    _, ins, o, ws, _, lo_w, hi_w = _launch(
        (16, 32, 64), (8, 16, 32),
        (_spec(star_stencil(3, 2), np.linspace(-0.4, 0.5, 13)),),
        device=dev)
    smem = apply_smem_bytes((8, 16, 32), sw, 4, list(zip(lo_w, hi_w)),
                            ins[0].stride(), pipelined=True)
    assert sweep.apply_occupancy(torch.float32, sw, smem) >= 1


@pytest.mark.parametrize("dtype,whole", [(torch.float32, True),
                                         (torch.bfloat16, False)])
def test_apply_copy16_reports_the_launchers_row_copies(dev, dtype, whole):
    """At the smoke's tile and the 13-point star's halo, f32 window rows
    (36 elements, 144 bytes) copy as whole 16-byte blocks and bf16 rows
    (72 bytes) do not; the launch equals its plain version either way."""
    _, ins, o, ws, _, lo_w, hi_w = _launch(
        (16, 32, 64), (8, 16, 32),
        (_spec(star_stencil(3, 2), np.linspace(-0.4, 0.5, 13)),),
        dtype=dtype, device=dev)
    args = (ins, o, ws, lo_w, hi_w, (8, 16, 32), 0)
    assert sweep.apply_copy16(*args) is whole
    k = sweep.sweep_apply(*args)
    torch.cuda.synchronize()
    assert _same_bits(k, sweep.sweep_apply_plain(*args))


# -- the apply on the caller's grid (padded=False) ----------------------------

# shape, tile, sweep_axis: each sweep axis; tiles that do not divide the
# grid; rows whose bytes are not a multiple of 16 (45 and 41 f32); grids
# thinner than the 13-point star's halo along the sweep axis, c0 and c1;
# aligned grids that take the flat copy; 2-D and 1-D grids
DIRECT_CASES = [
    ((12, 13, 14), (4, 8, 8), 0),
    ((12, 13, 14), (4, 4, 8), 1),
    ((12, 13, 14), (8, 8, 4), 2),
    ((37, 41, 45), (8, 16, 32), 0),
    ((37, 41, 45), (8, 16, 32), 1),
    ((130, 66, 516), (8, 16, 32), 0),
    ((3, 40, 64), (8, 16, 32), 0),
    ((24, 3, 64), (8, 16, 32), 0),
    ((24, 40, 3), (8, 16, 32), 0),
    ((24, 64, 64), (8, 16, 32), 0),
    ((16, 64, 128), (8, 32, 32), 0),
    ((41, 53), (16, 16), 0),
    ((70,), (8,), 0),
]


def _direct_specs(d, ops):
    """The 13-point star; the 27-point box (corners; 3-D only, the
    7-point star below); or two RHS, the 13-point star and a 7-point star
    in reversed order (table-driven)."""
    if ops == "star13":
        return (_spec(star_stencil(d, 2), np.linspace(-0.4, 0.5, 4 * d + 1)),)
    if ops == "box27":
        offs = BOX27 if d == 3 else star_stencil(d, 1)
        return (_spec(offs, np.linspace(-0.3, 0.45, len(offs))),)
    return _apply_ops(d, 2)


def _direct_vs_padded(dev, shape, tile, sw, specs, dtype, pipelined, seed=0,
                      offset=0):
    """The direct launch on the grids (each starting ``offset`` elements
    into its allocation, the second 3 more) and the plain version over
    the launch buffers of the same grids, trimmed."""
    us, ins, o, ws, _, lo_w, hi_w = _launch(shape, tile, specs, n=len(specs),
                                            dtype=dtype, device=dev,
                                            seed=seed)
    grids = us
    if offset:
        grids = []
        for a, u in enumerate(us):
            off = offset + 3 * a
            flat = torch.empty(u.numel() + off, dtype=dtype, device=dev)
            view = flat[off:].view(u.shape)
            view.copy_(u)
            grids.append(view)
    before = _launches("sweep_apply")
    got = sweep.sweep_apply(grids, o, ws, lo_w, hi_w, tile, sw, pipelined,
                            padded=False)
    assert _launches("sweep_apply") == before + 1
    want = sweep.sweep_apply_plain(ins, o, ws, lo_w, hi_w, tile, sw)
    torch.cuda.synchronize()
    return got, want[tuple(slice(0, n) for n in shape)]


@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("ops", ["star13", "box27", "p2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(DIRECT_CASES)))
def test_direct_apply_equals_plain_over_the_launch_buffer(dev, case, dtype,
                                                          ops, pipelined):
    """The kernel reading the caller's grid and zero-filling its window
    outside it equals the plain version over the padded launch buffer of
    the same grid, bit for bit, at the grid's own shape."""
    shape, tile, sw = DIRECT_CASES[case]
    got, want = _direct_vs_padded(dev, shape, tile, sw,
                                  _direct_specs(len(shape), ops), dtype,
                                  pipelined, seed=case)
    assert got.shape == tuple(shape)
    assert _same_bits(got, want)


@pytest.mark.parametrize("offset", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [0, 3, 5, 9, 10])
def test_direct_apply_of_misaligned_grids_equals_plain(dev, case, dtype,
                                                       offset):
    """Grids that start `offset` elements into their allocation (the
    second 3 more): the flat copy gives way to the piecewise one, whose
    zero fill around the grid keeps the result exact."""
    shape, tile, sw = DIRECT_CASES[case]
    got, want = _direct_vs_padded(dev, shape, tile, sw,
                                  _direct_specs(len(shape), "p2"), dtype,
                                  True, offset=offset)
    assert _same_bits(got, want)


@pytest.mark.parametrize("case,flat", [(10, True), (9, True), (3, False)])
def test_direct_apply_takes_the_flat_copy_on_aligned_grids(dev, case, flat):
    """f32 grids whose rows are 16-byte multiples keep the flat copy on
    the direct read (an 8-byte piece, 16-byte blocks, an 8-byte piece a
    window row of the 13-point star); a ragged row does not."""
    shape, tile, sw = DIRECT_CASES[case]
    us, _, o, ws, _, lo_w, hi_w = _launch(shape, tile,
                                          _direct_specs(3, "star13"),
                                          device=dev)
    args = (us, o, ws, lo_w, hi_w, tile, sw)
    assert sweep.apply_copy16(*args, padded=False) is flat
    got = sweep.sweep_apply(*args, padded=False)
    torch.cuda.synchronize()
    assert _same_bits(got, sweep.sweep_apply_plain(*args, padded=False))


@pytest.mark.parametrize("shape,ops", [((37, 41, 45), "star13"),
                                       ((32, 48, 64), "box27")])
def test_split_loop_on_the_callers_grid_equals_padded_launches(
        dev, monkeypatch, shape, ops):
    """A planned T=4 loop split into depth-1 launches, each reading the
    last one's output as it is, equals four launches on padded buffers
    trimmed back, bit for bit; it enqueues four kernels and no buffer."""
    from repro_torch.plan import PlanCache, Planner, planner

    rec = Planner(cache=PlanCache(persistent=False))
    monkeypatch.setattr(planner, "_DEFAULT", rec)
    ((o, w),) = _direct_specs(3, ops)
    plan = next(p for p in rec.candidates(
        k=8, shape=shape, offsets=np.asarray(o), time_steps=4,
        hardware=sweep.hopper_device(dev)) if p.fused_depth == 1)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        shape).astype(np.float32)).to(dev)
    before = obs.totals()
    got = st.stencil_iterate(x, np.asarray(o), w, 4, plan=plan)
    torch.cuda.synchronize()
    after = obs.totals()
    d = {k: after[k] - before[k] for k in (
        "launches.sweep_apply", "launch_buffers.direct", "device_ops.fill",
        "device_ops.copy_in", "device_ops.trim")}
    assert d == {"launches.sweep_apply": 4, "launch_buffers.direct": 4,
                 "device_ops.fill": 0, "device_ops.copy_in": 0,
                 "device_ops.trim": 0}
    oo, ws, _, lo_w, hi_w = st._launch_geometry(((o, w),), None, plan.tile)
    want = x
    for _ in range(4):
        (ins,) = st.embed_inputs([want], [
            (lo, hi + -(-n // t) * t - n)
            for lo, hi, n, t in zip(lo_w, hi_w, shape, plan.tile)])
        want = sweep.sweep_apply([ins], oo, ws, lo_w, hi_w, plan.tile,
                                 plan.sweep_axis)[tuple(
                                     slice(0, n) for n in shape)]
    torch.cuda.synchronize()
    assert _same_bits(got, want.contiguous())


@pytest.mark.parametrize("shape,tile,ops,row_pad,smem,padded_smem", [
    ((512,) * 3, (8, 32, 32), "star13", 4, 115216, 103696),
    ((512,) * 3, (8, 32, 32), "box27", 6, 97936, 83248),
    ((128,) * 3, (128, 2, 32), "star13", 0, 114064, 114064),
])
def test_direct_apply_at_the_planned_tiles_keeps_two_ctas_an_sm(
        dev, shape, tile, ops, row_pad, smem, padded_smem):
    """At the benchmark's planned tiles the launch on the caller's grid
    keeps two CTAs an SM.  At 512^3 its shared rows are wider than the
    padded buffer's (``sweep._row_pad``: room to copy each row's end
    pieces with their 16-byte blocks); at 128^3 wider rows would cost the
    second CTA, so the rows keep the padded buffer's bytes and copy their
    end pieces apart."""
    specs = _direct_specs(3, ops)
    oo, ws, _, lo_w, hi_w = st._launch_geometry(specs, None, tile)
    x = torch.empty(shape, device=dev)
    plan = sweep._apply_plan([x], oo, ws, lo_w, hi_w, tile, 0, True,
                             padded=False)
    assert (plan["geom"][32], plan["smem"]) == (row_pad, smem)
    assert launch_smem("apply", shape, tile, 0, 4,
                       list(zip(lo_w, hi_w))) == padded_smem
    assert sweep.apply_occupancy(torch.float32, 0, smem) == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_sweep_chain_equals_plain(dev, case, pipelined, window_kind, dtype):
    shape, tile, sw = CASES[case]
    d = len(shape)
    if d == 3:
        stages_w = (
            _spec(star_stencil(3, 1), np.linspace(0.3, -0.2, 7)),
            _spec([[-3, 0, 0], [-1, 0, 0], [0, 0, 0], [0, 1, 0], [0, 0, -1]],
                  [0.1, 0.2, -0.3, 0.25, 0.15]),
            _spec(star_stencil(3, 2), np.linspace(-0.4, 0.5, 13)),
        )
    else:
        offs = star_stencil(d, 2) if d == 2 else np.array([[-3], [0], [1]])
        stages_w = (_spec(offs, np.linspace(-0.5, 0.5, len(offs))),) * 3
    _, ins, _, _, stages, lo_w, hi_w = _launch(
        shape, tile, stages_w[:1], stages_w, dtype=dtype, device=dev)
    before = _launches("sweep_chain")
    k = sweep.sweep_chain(ins[0], stages, lo_w, hi_w, tile, sw, pipelined,
                          window_kind, shape)
    assert _launches("sweep_chain") == before + 1
    p = sweep.sweep_chain_plain(ins[0], stages, lo_w, hi_w, tile, sw,
                                pipelined, window_kind, shape)
    torch.cuda.synchronize()
    assert _same_bits(k, p)


def test_chain_domain_offset_lifts_the_masks(dev):
    """``dom`` moves the true domain in global coordinates (the sharded
    launch's slab offset); kernel and plain version move it alike."""
    shape, tile = (12, 13, 14), (4, 8, 8)
    stages_w = (_spec(star_stencil(3, 2), np.linspace(-0.4, 0.5, 13)),) * 2
    _, ins, _, _, stages, lo_w, hi_w = _launch(
        shape, tile, stages_w[:1], stages_w, device=dev)
    args = (ins[0], stages, lo_w, hi_w, tile, 0, True, "ring", shape,
            (0, 5, -3))
    assert _same_bits(sweep.sweep_chain(*args),
                      sweep.sweep_chain_plain(*args))


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
def test_frontends_on_the_card_equal_the_cpu(dev, window_kind):
    x = np.random.default_rng(4).standard_normal((33, 40, 70)).astype(
        np.float32)
    offs = star_stencil(3, 2)
    w = np.linspace(-0.4, 0.5, 13).tolist()
    kw = dict(tile=(4, 16, 32), sweep_axis=0, window_kind=window_kind)
    for T in (1, 3):
        gpu = st.stencil_iterate(x, offs, w, T, **kw)
        cpu = st.stencil_iterate(x, offs, w, T, device="cpu", **kw)
        assert gpu.device.type == "cuda"
        assert _same_bits(gpu.cpu(), cpu)


def test_launch_refused_above_the_shared_memory_limit(dev):
    x = torch.zeros((8, 64, 256), device=dev)
    with pytest.raises(ValueError, match="smaller tile"):
        st.stencil_pallas(x, star_stencil(3, 2), [0.1] * 13,
                          tile=(8, 64, 256), sweep_axis=0)


# -- boundary conditions, stage dtypes, int8 frontiers ------------------------

# Per-stage boundary, dtype and quantization configurations (``in_quant``:
# the input is int8 codes).
CHAIN_CONFIGS = {
    "dirichlet": dict(bcs_w=(("dirichlet", 0.5),) * 2),
    "neumann": dict(bcs_w=(("neumann", 0.0),) * 2),
    "reflect": dict(bcs_w=(("reflect", 0.0),) * 2),
    "robin": dict(bcs_w=(("robin", (0.7, 0.3)), ("robin", (-0.6, 0.25)))),
    "periodic": dict(bcs_w=(("periodic", 0.0),) * 2),
    "bf16": dict(dtypes_w=("bfloat16", "float32")),
    "int8": dict(bcs_w=(("reflect", 0.0),) * 2, dtypes_w=("int8", "float32"),
                 quants_w=((0.02, 3), None)),
    "mixed": dict(bcs_w=(("robin", (0.4, 0.6)), ("neumann", 0.0)),
                  dtypes_w=("int8", "bfloat16"), quants_w=((0.02, 3), None)),
    "in_quant": dict(bcs_w=(None, ("reflect", 0.0)),
                     dtypes_w=("bfloat16", "int8"),
                     quants_w=(None, (0.05, -2)), in_quant=(0.1, 5)),
}


def _symmetric_chain(d, T):
    if d == 3:
        ops = (_spec(BOX27, np.linspace(-0.2, 0.3, 27)),
               _spec(star_stencil(3, 2), np.linspace(-0.4, 0.5, 13)))
    else:
        offs = star_stencil(d, 2)
        ops = (_spec(offs, np.linspace(-0.3, 0.4, len(offs))),) * 2
    return ops[:T]


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
@pytest.mark.parametrize("config", sorted(CHAIN_CONFIGS))
@pytest.mark.parametrize("case", range(len(CASES)))
def test_sweep_chain_conditions_equal_plain(dev, case, config, window_kind):
    shape, tile, sw = CASES[case]
    kw = CHAIN_CONFIGS[config]
    stages_w = _symmetric_chain(len(shape), 2)
    _, ins, _, _, stages, lo_w, hi_w = _launch(
        shape, tile, stages_w[:1], stages_w, device=dev, seed=case, **kw)
    iq = kw.get("in_quant")
    before = _launches("sweep_chain")
    k = sweep.sweep_chain(ins[0], stages, lo_w, hi_w, tile, sw, True,
                          window_kind, shape, in_quant=iq)
    assert _launches("sweep_chain") == before + 1
    p = sweep.sweep_chain_plain(ins[0], stages, lo_w, hi_w, tile, sw, True,
                                window_kind, shape, in_quant=iq)
    torch.cuda.synchronize()
    assert _same_bits(k, p)


# -- the register-blocked, 16-byte-copy design of sweep_chain.cu ---------------

_CHAIN3 = (
    _spec(star_stencil(3, 1), np.linspace(0.3, -0.2, 7)),
    _spec([[-3, 0, 0], [-1, 0, 0], [0, 0, 0], [0, 1, 0], [0, 0, -1]],
          [0.1, 0.2, -0.3, 0.25, 0.15]),
    _spec(star_stencil(3, 2), np.linspace(-0.4, 0.5, 13)),
)


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
@pytest.mark.parametrize("t_s", [1, 3, 5, 6])
def test_chain_rows_off_the_register_block_equal_plain(dev, t_s,
                                                       window_kind):
    """Sweep tiles that are no multiple of the kernel's 4-row register
    block: the steady entries and the ring warm-up's odd chunks leave a
    thread fewer rows than its block holds."""
    shape, tile = (13, 13, 15), (t_s, 8, 8)
    _, ins, _, _, stages, lo_w, hi_w = _launch(
        shape, tile, _CHAIN3[:1], _CHAIN3, device=dev, seed=t_s)
    args = (ins[0], stages, lo_w, hi_w, tile, 0, True, window_kind, shape)
    k = sweep.sweep_chain(*args)
    p = sweep.sweep_chain_plain(*args)
    torch.cuda.synchronize()
    assert _same_bits(k, p)


@pytest.mark.parametrize("offset", [1, 5])
@pytest.mark.parametrize("config", ["float32", "bfloat16", "in_quant"])
def test_chain_misaligned_input_equals_plain(dev, config, offset):
    """An input view that starts ``offset`` elements into its allocation,
    with an odd minor extent: the 16-byte copies' unaligned ends (or, where
    source and shared rows differ in alignment, the element path)."""
    shape, tile = (12, 13, 15), (4, 8, 8)
    kw = CHAIN_CONFIGS["in_quant"] if config == "in_quant" else {}
    dtype = torch.bfloat16 if config == "bfloat16" else torch.float32
    stages_w = _symmetric_chain(3, 2)
    _, ins, _, _, stages, lo_w, hi_w = _launch(
        shape, tile, stages_w[:1], stages_w, dtype=dtype, device=dev,
        seed=offset, **kw)
    x = ins[0]
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
    view = flat[offset:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    iq = kw.get("in_quant")
    k = sweep.sweep_chain(view, stages, lo_w, hi_w, tile, 0, True, "ring",
                          shape, in_quant=iq)
    p = sweep.sweep_chain_plain(x, stages, lo_w, hi_w, tile, 0, True,
                                "ring", shape, in_quant=iq)
    torch.cuda.synchronize()
    assert _same_bits(k, p)


@pytest.mark.parametrize("dom", [(0, 0, 0), (3, -5, 7)])
@pytest.mark.parametrize("kind", ["neumann", "reflect", "robin"])
def test_chain_face_columns_equal_plain(dev, kind, dom):
    """A grid of 5 x 3 columns: interior columns (no face test), columns
    touching exactly one face, corner columns, and steps away from and at
    the sweep faces; with ``dom`` moving the faces in global coordinates."""
    shape, tile = (20, 40, 48), (4, 8, 16)
    value = (0.7, 0.3) if kind == "robin" else 0.0
    stages_w = _symmetric_chain(3, 2)
    _, ins, _, _, stages, lo_w, hi_w = _launch(
        shape, tile, stages_w[:1], stages_w, device=dev,
        bcs_w=((kind, value),) * 2)
    for wk in ("ring", "trapezoid"):
        args = (ins[0], stages, lo_w, hi_w, tile, 0, True, wk, shape, dom)
        k = sweep.sweep_chain(*args)
        p = sweep.sweep_chain_plain(*args)
        torch.cuda.synchronize()
        assert _same_bits(k, p), wk


@pytest.mark.parametrize("kind", ["neumann", "reflect", "robin"])
@pytest.mark.parametrize("geometry", ["no_interior", "two_positions"])
def test_chain_face_frames_equal_plain(dev, geometry, kind):
    """The interior-then-frame split of an entry's cross positions at its
    edges: columns whose cross extent lies wholly in the face band (an
    empty interior, every position a frame position), and a stage on the
    table-driven loop (the 13-point star in reverse order) whose entries
    have more items than the block has threads, so a thread takes two
    positions of the interior or of the frame."""
    value = (0.7, 0.3) if kind == "robin" else 0.0
    if geometry == "no_interior":
        shape, tile = (8, 4, 5), (4, 4, 5)
        stages_w = _symmetric_chain(3, 2)
    else:
        shape, tile = (20, 40, 70), (4, 16, 32)
        rev = star_stencil(3, 2)[::-1]
        stages_w = (_spec(rev, np.linspace(-0.4, 0.5, 13)),
                    _spec(BOX27, np.linspace(-0.2, 0.3, 27)))
    _, ins, _, _, stages, lo_w, hi_w = _launch(
        shape, tile, stages_w[:1], stages_w, device=dev,
        bcs_w=((kind, value),) * 2)
    for wk in ("ring", "trapezoid"):
        args = (ins[0], stages, lo_w, hi_w, tile, 0, True, wk, shape)
        k = sweep.sweep_chain(*args)
        p = sweep.sweep_chain_plain(*args)
        torch.cuda.synchronize()
        assert _same_bits(k, p), wk


def test_chain_plan_cache_keys_on_values(dev):
    """Two launches that differ only in a quantization scale (given as
    0-dim tensors whose printed forms agree) and a robin coefficient build
    different tables: each equals its plain version, and they differ."""
    shape, tile = (12, 13, 14), (4, 8, 8)
    stages_w = _symmetric_chain(3, 2)
    outs = []
    for scale, alpha in ((0.02, 0.7), (0.02001, 0.70001)):
        kw = dict(bcs_w=(("robin", (torch.tensor(alpha), 0.3)),) * 2,
                  dtypes_w=("int8", "float32"),
                  quants_w=((torch.tensor(scale), 3), None))
        _, ins, _, _, stages, lo_w, hi_w = _launch(
            shape, tile, stages_w[:1], stages_w, device=dev, **kw)
        args = (ins[0], stages, lo_w, hi_w, tile, 0, True, "ring", shape)
        k = sweep.sweep_chain(*args)
        p = sweep.sweep_chain_plain(*args)
        torch.cuda.synchronize()
        assert _same_bits(k, p)
        outs.append(k)
    assert not torch.equal(outs[0], outs[1])


def test_chain_plan_evicted_during_a_side_stream_launch_equals_plain(
        dev, monkeypatch):
    """A boundary chain's launch plan is built on the default stream, then
    launched on a side stream held back by a sleep.  While that launch
    waits, new geometries evict the plan (the cache is cut to 4 plans)
    and the default stream takes memory of the plan's correction-term
    rows' size for zero fills, until it is handed the evicted rows' own.
    The side launch must still read its own rows and equal the plain
    version, in each of three rounds: the wrapper records the side
    stream's use of the kept rows.  A round counts only if the side launch
    had not run when the host finished evicting; one that had is taken
    again with a sleep four times as long, so the host's speed decides
    how long a round takes, not whether it passes."""
    monkeypatch.setattr(sweep, "_PLANS_MAX", 4)
    shape, tile = (12, 13, 14), (4, 8, 8)
    stages_w = _symmetric_chain(3, 2)
    kw = dict(bcs_w=(("neumann", 0.0),) * 2)

    def inputs(n0, seed):
        _, ins, _, _, stages, lo_w, hi_w = _launch(
            (n0,) + shape[1:], tile, stages_w[:1], stages_w, device=dev,
            seed=seed, **kw)
        return (ins[0], stages, lo_w, hi_w, tile, 0, True, "ring",
                (n0,) + shape[1:])

    evict = [inputs(shape[0] + 1 + i, i + 1)
             for i in range(sweep._PLANS_MAX)]

    def round_held(cycles):
        """One round: whether the side launch still waited when the host
        was done, after checking its result."""
        sweep._PLANS.clear()
        args = inputs(shape[0], 0)
        want = sweep.sweep_chain_plain(*args)
        assert _same_bits(sweep.sweep_chain(*args), want)
        (key,) = sweep._PLANS
        n_rows = sweep._PLANS[key]["bc"].shape[0]
        rows_at = sweep._PLANS[key]["bc"].data_ptr()
        # Cached memory for the zero fills: a cudaMalloc while the side
        # launch waits would synchronize the card and let it run early.
        warm = [torch.empty((n_rows, 8), dtype=torch.int32, device=dev)
                for _ in range(300)]
        del warm
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        ran = torch.cuda.Event()
        with torch.cuda.stream(side):
            torch.cuda._sleep(cycles)
            out = sweep.sweep_chain(*args)
            ran.record()
        for other in evict:
            sweep.sweep_chain(*other)
        assert key not in sweep._PLANS
        # Zero rows: no term fires, and every read stays in the window.
        junk = []
        for _ in range(256):
            junk.append(torch.zeros((n_rows, 8), dtype=torch.int32,
                                    device=dev))
            if junk[-1].data_ptr() == rows_at:
                break
        held = not ran.query()
        ran.synchronize()
        assert _same_bits(out, want)
        return held

    for _ in range(3):
        cycles = 1 << 31  # about 1 s at the SM clock
        while not round_held(cycles):
            assert cycles < 1 << 37, "the host never finished in time"
            cycles *= 4


def test_chain_occupancy_at_the_smoke_tile(dev):
    """At chain_T3_512's tile, one CTA of CHAIN_THREADS threads fits an SM:
    at least 16 resident warps."""
    halos = [[(2, 2)] * 3] * 3
    smem = sweep_smem_bytes((4, 16, 32), 0, 4, stage_halos=halos,
                            pipelined=True)
    n = sweep.chain_occupancy(torch.float32, smem)
    assert n >= 1
    assert n * sweep.CHAIN_THREADS // 32 >= 16


@pytest.mark.parametrize("kind", ["dirichlet", "neumann", "reflect", "robin",
                                  "periodic"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_single_stage_boundary_launch_equals_plain(dev, case, kind):
    """T = 1 with a boundary runs on the chain kernel, through the
    frontend and directly."""
    shape, tile, sw = CASES[case]
    value = {"dirichlet": 0.5, "robin": (0.7, 0.3)}.get(kind, 0.0)
    (spec,) = _symmetric_chain(len(shape), 1)
    prog = ir.chain_program([(np.asarray(spec[0]), spec[1])], len(shape),
                            boundary=kind, value=value)
    x = np.random.default_rng(case).standard_normal(shape).astype(np.float32)
    before = _launches("sweep_chain")
    gpu = ir.run_program(prog, x, tile=tile, sweep_axis=sw)
    assert _launches("sweep_chain") == before + 1
    cpu = ir.run_program(prog, x, tile=tile, sweep_axis=sw, device="cpu")
    assert _same_bits(gpu.cpu(), cpu)


def _corpus_seeds():
    root = Path(__file__).resolve().parent / "corpus"
    return sorted(int(json.loads(p.read_text())["seed"])
                  for p in root.glob("seed_*.json"))


def corpus_spec(seed: int) -> dict:
    """A jax-free copy of ``gen_spec`` of ``tests/test_program_fuzz.py``:
    one random legal program spec, fully determined by ``seed``."""
    rng = np.random.default_rng(int(seed))
    d = int(rng.integers(1, 4))
    shape = tuple(int(rng.integers(2, 5)) * 8 for _ in range(d))
    T = int(rng.integers(1, 5))
    stages = []
    for _ in range(T):
        n_taps = int(rng.integers(2, 6))
        offs = {(0,) * d}
        while len(offs) < n_taps:
            offs.add(tuple(int(o) for o in rng.integers(-2, 3, size=d)))
        if rng.random() < 0.25:
            offs = {tuple(-abs(o) for o in off) for off in offs}
        offs = sorted(offs)
        wts = [round(float(w), 3)
               for w in rng.uniform(-0.5, 0.5, len(offs))]
        stages.append({"offsets": [list(o) for o in offs], "weights": wts})
    r = rng.random()
    if r < 0.25:
        bcs: list = [["periodic", 0.0]] * T
    elif r < 0.6:
        menu = ("zero", "dirichlet", "neumann", "reflect", "robin")
        bcs = []
        for _ in range(T):
            kind = menu[int(rng.integers(0, len(menu)))]
            if kind == "zero":
                bcs.append(None)
            elif kind == "dirichlet":
                bcs.append(["dirichlet",
                            round(float(rng.uniform(-1, 1)), 3)])
            elif kind == "robin":
                bcs.append(["robin",
                            [round(float(rng.uniform(-1, 1)), 3),
                             round(float(rng.uniform(-1, 1)), 3)]])
            else:
                bcs.append([kind, 0.0])
    else:
        bcs = [None] * T
    dtypes: list = []
    quants: list = []
    for j in range(T):
        q = rng.random()
        if j < T - 1 and q < 0.2:
            dtypes.append("int8")
            quants.append([float(rng.choice([0.02, 0.05, 0.1])),
                           int(rng.integers(-8, 9))])
        elif j < T - 1 and q < 0.4:
            dtypes.append("bfloat16")
            quants.append(None)
        else:
            dtypes.append(None)
            quants.append(None)
    tile = list(shape)
    a = int(rng.integers(0, d))
    if rng.random() < 0.5:
        tile[a] = shape[a] // 2
    return {
        "seed": int(seed),
        "d": d,
        "shape": list(shape),
        "stages": stages,
        "bcs": bcs,
        "dtypes": dtypes,
        "quants": quants,
        "window_kind": "ring" if rng.random() < 0.5 else "trapezoid",
        "tile": tile,
    }


def corpus_program(spec: dict) -> ir.Program:
    """The port's program of a corpus spec (``_build_program`` of
    ``tests/test_program_fuzz.py`` on the port's IR)."""
    return ir.chain_program(
        [(np.asarray(s["offsets"], dtype=np.int64), s["weights"])
         for s in spec["stages"]],
        spec["d"],
        boundary=[
            None if bc is None else (bc[0], bc[1] if not
                                     isinstance(bc[1], list)
                                     else tuple(bc[1]))
            for bc in spec["bcs"]
        ],
        dtypes=spec["dtypes"],
        quants=[None if q is None else (q[0], q[1])
                for q in spec["quants"]],
    )


def corpus_tile(spec: dict) -> tuple[int, ...]:
    """The corpus spec's tile, or — where its window and frontiers need
    more than the 227 KB of shared memory a block may have (the corpus
    tiles were sized for a TPU's VMEM) — the tile with its largest extent
    halved until they fit.  The result does not depend on the tile."""
    lowered = ir.lower(corpus_program(spec), tuple(spec["shape"]))
    d = spec["d"]
    halos = [halo_from_offsets([np.asarray(o).reshape(-1, d)], d)
             for o, _ in lowered.stages]
    tile = list(spec["tile"])
    h_s = sum(lo + hi for lo, hi in (h[0] for h in halos))
    while True:
        # Pipelined only with a sweep overlap and more than one sweep step,
        # as the kernels decide.
        pipe = h_s > 0 and -(-spec["shape"][0] // tile[0]) > 1
        try:
            for wk in ("ring", "trapezoid"):
                sweep_smem_bytes(tile, 0, 4, stage_halos=halos,
                                 pipelined=pipe, window_kind=wk)
            return tuple(tile)
        except ValueError:
            i = max(range(d), key=lambda a: tile[a])
            tile[i] = -(-tile[i] // 2)


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
@pytest.mark.parametrize("seed", _corpus_seeds())
def test_corpus_programs_on_the_card_equal_the_cpu(dev, seed, window_kind):
    spec = corpus_spec(seed)
    prog = corpus_program(spec)
    try:
        ir.lower(prog, tuple(spec["shape"]))
    except ir.IRVerifyError:
        pytest.skip(f"seed {seed}: ir.verify rejects the program")
    x = np.random.default_rng(seed).standard_normal(spec["shape"]).astype(
        np.float32)
    kw = dict(tile=corpus_tile(spec), window_kind=window_kind)
    before = _launches("sweep_chain", "sweep_apply")
    gpu = ir.run_program(prog, x, **kw)
    assert _launches("sweep_chain", "sweep_apply") \
        == before + 1
    cpu = ir.run_program(prog, x, device="cpu", **kw)
    assert _same_bits(gpu.cpu(), cpu)


# -- the Mamba2 conv kernel -----------------------------------------------------

# (batch, seq, channels, tile_s): a ragged last tile, one token, an odd
# channel count (one channel per thread), and the serving shapes of
# Mamba2-2.7B's prefill (C = 5120 + 2·128) and Zamba2-2.7B's (C = 5120 +
# 2·64).
CONV_CASES = [(2, 37, 24, 8), (3, 1, 16, 4), (2, 37, 25, 8),
              (4, 2048, 5376, 256), (4, 2048, 5248, 256)]


def _conv_inputs(b, s, c, width, with_state, dtype, dev, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((b, s, c), generator=g).to(dev, dtype)
    w = (torch.randn((width, c), generator=g) * 0.3).to(dev, dtype)
    bias = (torch.randn((c,), generator=g) * 0.1).to(dev, dtype)
    state = (torch.randn((b, width - 1, c), generator=g).to(dev, dtype)
             if with_state else None)
    return x, w, bias, state


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("width", [4, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_conv1d_equals_plain(dev, case, dtype, width, with_state):
    b, s, c, tile_s = CONV_CASES[case]
    x, w, bias, state = _conv_inputs(b, s, c, width, with_state, dtype, dev)
    before = _launches("conv1d")
    k = conv1d.causal_conv1d_launch(x, w, bias, tile_s, state)
    assert _launches("conv1d") == before + 1
    p = conv1d.causal_conv1d_plain(x, w, bias, state)
    torch.cuda.synchronize()
    assert _same_bits(k, p), float((k.float() - p.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv1d_does_not_depend_on_the_tile(dev, dtype):
    x, w, bias, state = _conv_inputs(2, 45, 40, 4, True, dtype, dev, seed=1)
    outs = [conv1d.causal_conv1d(x, w, bias, tile_s=t, state=state)
            for t in (1, 5, 16, 64)]
    torch.cuda.synchronize()
    assert all(_same_bits(o, outs[0]) for o in outs)


def test_conv1d_misaligned_buffer_takes_one_channel_per_thread(dev):
    """x starts one element into its allocation, so channel pairs are not
    aligned: the wrapper launches the one-channel variant."""
    b, s, c = 2, 19, 24
    flat = torch.randn(b * s * c + 1, device=dev, dtype=torch.bfloat16)
    x = flat[1:].view(b, s, c)
    assert x.is_contiguous() and x.data_ptr() % 4 != 0
    _, w, bias, state = _conv_inputs(b, s, c, 4, True, torch.bfloat16, dev)
    k = conv1d.causal_conv1d_launch(x, w, bias, 8, state)
    torch.cuda.synchronize()
    assert _same_bits(k, conv1d.causal_conv1d_plain(x, w, bias, state))


def test_conv1d_refuses_what_it_cannot_take(dev):
    x = torch.zeros((1, 8, 6), device=dev)
    with pytest.raises(ValueError, match="widths"):
        conv1d.causal_conv1d_launch(x, torch.zeros((5, 6), device=dev),
                                    torch.zeros(6, device=dev), 4)
    with pytest.raises(ValueError, match="contiguous"):
        conv1d.causal_conv1d_launch(
            torch.zeros((1, 6, 8), device=dev).transpose(1, 2),
            torch.zeros((4, 6), device=dev), torch.zeros(6, device=dev), 4)
    # C beyond what a run's 32-bit offsets hold: refused, not launched.
    with pytest.raises(RuntimeError, match="refused"):
        conv1d.causal_conv1d_launch(
            torch.zeros((1, 1, 60_000_000), device=dev, dtype=torch.bfloat16),
            torch.zeros((4, 60_000_000), device=dev, dtype=torch.bfloat16),
            torch.zeros(60_000_000, device=dev, dtype=torch.bfloat16), 1)
    # 70,000 one-token tiles: the warps form a flat grid, so the 65,535
    # limit of a grid dimension no longer applies; the shape runs and
    # equals the plain version.
    x, w, bias, _ = _conv_inputs(1, 70000, 2, 4, False, torch.float32, dev)
    k = conv1d.causal_conv1d_launch(x, w, bias, 1)
    torch.cuda.synchronize()
    assert _same_bits(k, conv1d.causal_conv1d_plain(x, w, bias))


# (batch, seq, channels, tile_s): S below the width, C = 2 (mod 8) with S
# a multiple of neither the 32-row run nor the tile, C = 4 (mod 8), C odd,
# and runs of one row.
CONV_VARIANT_CASES = [(2, 2, 40, 8), (2, 75, 5370, 45), (1, 33, 5372, 16),
                      (2, 37, 25, 8), (3, 5, 64, 1)]


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("width", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(CONV_VARIANT_CASES)))
def test_conv1d_variants_equal_plain(dev, case, dtype, width, with_state):
    b, s, c, tile_s = CONV_VARIANT_CASES[case]
    x, w, bias, state = _conv_inputs(b, s, c, width, with_state, dtype, dev,
                                     seed=case)
    k = conv1d.causal_conv1d_launch(x, w, bias, tile_s, state)
    p = conv1d.causal_conv1d_plain(x, w, bias, state)
    torch.cuda.synchronize()
    assert _same_bits(k, p), float((k.float() - p.float()).abs().max())


@pytest.mark.parametrize("offset", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv1d_misaligned_x_equals_plain(dev, dtype, offset):
    """x starts 1, 2 or 4 elements into its allocation: the wrapper takes
    a narrower variant (one or two channels a thread, or four where the
    offset keeps them aligned)."""
    b, s, c = 2, 41, 64
    flat = torch.randn(b * s * c + 8, device=dev).to(dtype)
    x = flat[offset:offset + b * s * c].view(b, s, c)
    _, w, bias, state = _conv_inputs(b, s, c, 4, True, dtype, dev, seed=3)
    k = conv1d.causal_conv1d_launch(x, w, bias, 16, state)
    torch.cuda.synchronize()
    assert _same_bits(k, conv1d.causal_conv1d_plain(x, w, bias, state))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv1d_takes_bf16_and_f32_weights_alike(dev, dtype):
    """bf16 weights and bias, and the same values as f32 (or mixed), give
    the same result bit for bit: the kernel widens them exactly."""
    x, w, bias, state = _conv_inputs(2, 70, 5376, 4, True, dtype, dev,
                                     seed=4)
    w16, b16 = w.to(torch.bfloat16), bias.to(torch.bfloat16)
    outs = [conv1d.causal_conv1d_launch(x, wt, bt, 32, state)
            for wt, bt in ((w16, b16), (w16.float(), b16.float()),
                           (w16, b16.float()), (w16.float(), b16))]
    p = conv1d.causal_conv1d_plain(x, w16, b16, state)
    torch.cuda.synchronize()
    assert all(_same_bits(o, p) for o in outs)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_smoke_model_on_the_card_equals_the_cpu(dev, dtype, arch):
    """Prefill (through the conv kernel) and two decode steps of the smoke
    config (Mamba2, and the Zamba2 hybrid with its shared attention) on
    the card against the CPU, with the same parameters: f32 to 1e-5, bf16
    within two bf16 ulps of the logits' scale (matmul accumulation order
    differs between cuBLAS and the CPU)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model

    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype, ssm=dataclasses.replace(
        cfg.ssm, pallas_conv=True, conv_tile=8))
    toks = torch.randint(0, cfg.vocab, (2, 23),
                         generator=torch.Generator().manual_seed(7))
    logits = {}
    params_cpu = get_model(cfg, device="cpu").init(0)
    for where in ("cpu", "cuda"):
        model = get_model(cfg, device=where)
        params = params_cpu
        if where == "cuda":
            from repro_torch.models.ssm import SSMModel

            params = SSMModel(cfg, device=dev)
            params.load_state_dict(params_cpu.state_dict())
        cache = model.init_cache(2, 23)
        before = _launches("conv1d")
        lg, cache = model.prefill(params, {"tokens": toks[:, :21]}, cache)
        if where == "cuda":
            assert _launches("conv1d") == before + cfg.n_layers
        out = [lg]
        for i in (21, 22):
            lg, cache = model.decode_step(params, cache, toks[:, i:i + 1], i)
            out.append(lg)
        logits[where] = torch.cat(out, dim=1).float().cpu()
    want = logits["cpu"]
    if dtype == torch.float32:
        tol = dict(atol=1e-5, rtol=1e-5)
    else:
        tol = dict(atol=2.0 ** -7 * float(want.abs().max()), rtol=2.0 ** -7)
    torch.testing.assert_close(logits["cuda"], want, **tol)


# -- planned launches -------------------------------------------------------------


@pytest.mark.parametrize("case", [
    ("apply", (40, 48, 64), 1), ("chain", (40, 48, 64), 3),
    ("rhs", (24, 40, 64), 1), ("int8", (24, 40, 64), 3),
])
def test_planned_launch_equals_the_plain_version(case, dev, monkeypatch):
    """``tile=None`` on the card: the plan is made for this card's
    description (``sweep.hopper_device``), the launches run the kernels,
    and the result equals the same plan's launches on the CPU."""
    from repro_torch.kernels import ref
    from repro_torch.plan import PlanCache, Planner, planner

    kind, shape, T = case
    rec = Planner(cache=PlanCache(persistent=False))
    monkeypatch.setattr(planner, "_DEFAULT", rec)
    desc = sweep.hopper_device(dev)
    assert desc.apply_ctas_per_sm >= 1 and desc.chain_ctas_per_sm >= 1
    assert desc.smem_per_sm >= desc.smem_per_block
    rng = np.random.default_rng(12)
    x = rng.standard_normal(shape).astype(np.float32)
    o13, w13 = ref.star_weights_2nd_order(3, 2)
    before = _launches("sweep_apply", "sweep_chain")
    if kind == "rhs":
        y = rng.standard_normal(shape).astype(np.float32)
        args = ([x, y], [o13, o13[::-1]], [w13, w13[::-1]])
        got = st.multi_stencil_pallas(*args)
    elif kind == "int8":
        prog = ir.chain_program([(o13, w13)] * T, 3, boundary="reflect",
                                quants=[(0.02, 3)] * (T - 1) + [None])
        got = ir.run_program(prog, x * 0.3)
    else:
        got = st.stencil_iterate(x, o13, w13, T)
    launched = (_launches("sweep_apply", "sweep_chain")
                - before)
    ((key, plan),) = rec.cache._mem.items()
    assert plan.request.hardware == desc.key()
    assert launched == -(-plan.time_steps // plan.fused_depth)
    if kind == "rhs":
        want = st.multi_stencil_pallas(*args, plan=plan, device="cpu")
    elif kind == "int8":
        want = ir.run_program(prog, x * 0.3, plan=plan, device="cpu")
    else:
        want = st.stencil_iterate(x, o13, w13, T, plan=plan, device="cpu")
    assert _same_bits(got.cpu(), want)


# -- the call memo ---------------------------------------------------------------


@pytest.fixture
def memo_planner(monkeypatch):
    """An empty call memo and a memory-only default planner."""
    from repro_torch.plan import PlanCache, Planner, planner

    monkeypatch.setattr(st, "_CALL_MEMO", {})
    rec = Planner(cache=PlanCache(persistent=False))
    monkeypatch.setattr(planner, "_DEFAULT", rec)
    return rec


def _memo_counts():
    t = obs.totals()
    return t["call_memo.hit"], t["call_memo.miss"]


@pytest.mark.parametrize("shape", [(128, 128, 128), (37, 41, 45)])
@pytest.mark.parametrize("ops,dtype", [("star13", torch.float32),
                                       ("box27", torch.float32),
                                       ("star13", torch.bfloat16)])
def test_call_memo_hit_equals_the_miss(dev, memo_planner, shape, ops, dtype):
    """A planned call on the card, repeated: the repeat is the call memo's
    bound launch (one hit, one apply launch), equal to the miss bit for
    bit, and both to the plain version at the same plan."""
    ((o, w),) = _direct_specs(3, ops)
    o = np.asarray(o)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        shape).astype(np.float32)).to(dev, dtype)
    hits, misses = _memo_counts()
    miss = st.stencil_pallas(x, o, w)
    assert _memo_counts() == (hits, misses + 1)
    before = _launches("sweep_apply")
    hit = st.stencil_pallas(x, o, w)
    torch.cuda.synchronize()
    assert _memo_counts() == (hits + 1, misses + 1)
    assert _launches("sweep_apply") == before + 1
    assert _same_bits(hit, miss)
    (plan,) = memo_planner._by_call.values()
    want = st.stencil_pallas(x.cpu(), o, w, plan=plan, device="cpu")
    assert _same_bits(hit.cpu(), want)


def test_call_memo_entry_evicted_during_a_side_stream_launch_equals_plain(
        dev, memo_planner, monkeypatch):
    """A call memo hit is launched on a side stream held back by a sleep.
    While it waits, calls of other shapes evict its memo entry (the memo
    cut to 2 entries) and its launch plan (``_PLANS`` cut to 2), and the
    default stream fills memory with NaN.  The side launch must still
    equal the plain version, in each of three rounds: the bound launch
    keeps its plan (host arrays only), takes the stream current at the
    call, and reads the caller's grid.  A round counts only if the side
    launch had not run when the host finished evicting; one that had is
    taken again with a sleep four times as long."""
    monkeypatch.setattr(st, "_CALL_MEMO_MAX", 2)
    monkeypatch.setattr(sweep, "_PLANS_MAX", 2)
    shape, tile = (37, 41, 45), (8, 16, 32)
    ((o, w),) = _direct_specs(3, "star13")
    o = np.asarray(o)

    def grid(n0, seed):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (n0,) + shape[1:]).astype(np.float32)).to(dev)

    def call(u):
        return st.stencil_pallas(u, o, w, tile=tile, sweep_axis=0)

    x = grid(shape[0], 0)
    want = st.stencil_pallas(x.cpu(), o, w, tile=tile, sweep_axis=0,
                             device="cpu")
    others = [grid(shape[0] + 1 + i, i + 1) for i in range(4)]
    # Cached memory for the outputs and the fills: a cudaMalloc while the
    # side launch waits would synchronize the card and let it run early.
    for u in others:
        call(u)
    warm = [torch.empty(shape, device=dev) for _ in range(16)]
    del warm
    torch.cuda.synchronize()

    def round_held(cycles):
        """One round: whether the side launch still waited when the host
        was done, after checking its result."""
        st._CALL_MEMO.clear()
        sweep._PLANS.clear()
        assert _same_bits(call(x).cpu(), want)  # the miss
        (key,) = st._CALL_MEMO
        (plan_key,) = sweep._PLANS
        torch.cuda.synchronize()
        hits = _memo_counts()[0]
        side = torch.cuda.Stream()
        ran = torch.cuda.Event()
        with torch.cuda.stream(side):
            torch.cuda._sleep(cycles)
            out = call(x)
            ran.record()
        assert _memo_counts()[0] == hits + 1
        for u in others:
            call(u)
        assert key not in st._CALL_MEMO and plan_key not in sweep._PLANS
        junk = [torch.full(shape, float("nan"), device=dev)
                for _ in range(16)]
        held = not ran.query()
        ran.synchronize()
        assert _same_bits(out.cpu(), want)
        del junk
        return held

    for _ in range(3):
        cycles = 1 << 31  # about 1 s at the SM clock
        while not round_held(cycles):
            assert cycles < 1 << 37, "the host never finished in time"
            cycles *= 4


# -- the measured tune loop ------------------------------------------------------


def test_measure_on_the_card_synchronizes(dev):
    """``measure`` on the card: each rep between CUDA events with the
    device synchronized, so a launch that keeps the card busy for a while
    reads positive times, and the work is done when it returns."""
    from repro_torch.runtime.timing import measure

    x = torch.randn((2048, 2048), device=dev)
    out = []
    res = measure(lambda: out.append(x @ x), reps=3, warmup=1, device=dev)
    assert len(out) == 4 and res.reps == 3
    assert all(t > 0 for t in res.times_s)
    assert res.median_s > 0 and res.iqr_s >= 0
    assert torch.cuda.current_stream(dev).query()


@pytest.mark.parametrize("case", ["apply", "chain", "int8"])
def test_tuned_call_equals_the_plain_version(case, dev, tmp_path,
                                             monkeypatch):
    """``tune=`` on the card races the candidates on the kernels, keeps a
    record under a ``cuda:`` fingerprint, and the tuned call equals the
    winner's launches on the CPU bit for bit; the warm call launches
    nothing while it plans."""
    from repro_torch.kernels import ref
    from repro_torch.plan import AutoTuner, PlanCache, Planner, TunedPlanDB

    monkeypatch.setenv("REPRO_TORCH_TUNED_DB_DIR", str(tmp_path))
    tuner = AutoTuner(db=TunedPlanDB(),
                      planner=Planner(cache=PlanCache(persistent=False)),
                      k=3, reps=2, warmup=1)
    shape = (40, 48, 64)
    rng = np.random.default_rng(13)
    x = rng.standard_normal(shape).astype(np.float32)
    o13, w13 = ref.star_weights_2nd_order(3, 2)
    prog = ir.chain_program([(o13, w13)] * 3, 3, boundary="reflect",
                            quants=[(0.02, 3), (0.02, 3), None])
    calls = {
        "apply": lambda **kw: st.stencil_pallas(x, o13, w13, **kw),
        "chain": lambda **kw: st.stencil_iterate(x, o13, w13, 3, **kw),
        "int8": lambda **kw: ir.run_program(prog, x * 0.3, **kw),
    }
    got = calls[case](tune=tuner)
    rec = tuner.last_record
    assert not tuner.last_plan_tuned and rec.fingerprint.startswith("cuda:")
    assert rec.never_slower and len(rec.candidates) >= 2
    want = calls[case](plan=rec.winner_plan, device="cpu")
    assert _same_bits(got.cpu(), want)
    plan_fn = tuner.plan
    during = []

    def watched(*a, **kw):
        before = _launches("sweep_apply", "sweep_chain")
        p = plan_fn(*a, **kw)
        during.append(_launches("sweep_apply", "sweep_chain")
                      - before)
        return p

    tuner.plan = watched
    again = calls[case](tune=tuner)
    assert tuner.last_plan_tuned and during == [0]
    assert _same_bits(again.cpu(), want)
