"""The bf16 apply kernel's pair loop, against the plain version.

``csrc/sweep_apply.cu`` computes two neighbouring outputs along c1 a
thread in its bf16 instantiations where a launch allows it (``P.pair``:
sweep axis 0 or 1 with c1 the minor axis, an even tile c1 extent, output
pairs on 4-byte words of every ring, compiled operator shapes alone), and
says so in its return (``kRowsPair``), which ``sweep.sweep_apply`` counts
as ``apply_rows.pair``.  Every other launch runs the element loop.  Both
sum each output's taps in the same order with separate f32 multiplies and
adds and round once to bf16, so both equal the plain version bit for bit.

The CPU test holds the plain path to counting no pair; the tests marked
``cuda`` skip without a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_apply_pairs.py
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core.cache_fitting import star_stencil  # noqa: E402
from repro_torch.kernels import stencil as st  # noqa: E402
from repro_torch.kernels import sweep  # noqa: E402

PAIRS = ("launches.sweep_apply", "apply_rows.pair")
BOX27 = np.array(list(itertools.product((-1, 0, 1), repeat=3)))
OPS = {
    "star13": star_stencil(3, 2),
    "star7": star_stencil(3, 1),
    "box27": BOX27,
    # the 7-point star in reversed order: no compiled shape, so the
    # kernel's table-driven loop
    "table": star_stencil(3, 1)[::-1].copy(),
}


def _specs(ops):
    return tuple(
        (tuple(map(tuple, OPS[op].tolist())),
         tuple(np.linspace(-0.45 + 0.1 * a, 0.4, len(OPS[op])).tolist()))
        for a, op in enumerate(ops.split("+")))


def _pairs_delta(before, after):
    return {k: after[k] - before[k] for k in PAIRS}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_plain_path_counts_no_pair(dtype):
    """On the CPU ``sweep_apply`` runs its plain version: no launch, so no
    pair loop is counted."""
    x = torch.rand((16, 18, 20)).to(dtype)
    o = star_stencil(3, 2)
    before = obs.totals()
    st.stencil_pallas(x, o, np.full(len(o), 1 / 13), device="cpu")
    st.stencil_pallas(x, o, np.full(len(o), 1 / 13), tile=(8, 8, 16),
                      device="cpu")
    assert _pairs_delta(before, obs.totals()) == dict.fromkeys(PAIRS, 0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _grids(dev, shape, n, seed, offset=0):
    """n bf16 grids of ``shape``, each starting ``offset`` elements into
    its allocation."""
    rng = np.random.default_rng(seed)
    grids = []
    for _ in range(n):
        flat = torch.empty(int(np.prod(shape)) + offset, dtype=torch.bfloat16,
                           device=dev)
        view = flat[offset:].view(shape)
        view.copy_(torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev))
        grids.append(view)
    return grids


def _apply(dev, shape, tile, sw, ops, padded=False, **grid_kw):
    """One card launch of ``ops`` over bf16 grids (or, ``padded``, their
    launch buffers) and the plain version's result; the launch's pair and
    launch counts."""
    specs = _specs(ops)
    grids = _grids(dev, shape, len(specs), seed=len(shape) + sw, **grid_kw)
    if padded:
        ins, o, ws, _, lo_w, hi_w = st._launch_inputs(grids, specs, tile)
    else:
        ins = grids
        o, ws, _, lo_w, hi_w = st._launch_geometry(specs, None, tile)
    args = (ins, o, ws, lo_w, hi_w, tile, sw)
    before = obs.totals()
    got = sweep.sweep_apply(*args, padded=padded)
    counts = _pairs_delta(before, obs.totals())
    want = sweep.sweep_apply_plain(*args, padded=padded)
    torch.cuda.synchronize()
    return got, want, counts


def _same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int16), b.contiguous().view(torch.int16)))


@pytest.mark.cuda
def test_the_benchmarks_launch_takes_the_pair_loop_bit_for_bit(dev):
    """``star13bf16-apply-512``'s launch: the 13-point star on a 512^3
    grid at its planned tile, read where it lies."""
    got, want, counts = _apply(dev, (512,) * 3, (16, 16, 64), 0, "star13")
    assert counts == {"launches.sweep_apply": 1, "apply_rows.pair": 1}
    assert _same_bits(got, want)


# shape, tile, sweep axis, operators, padded, the grid's placement
PAIR_CASES = [
    ((128,) * 3, (16, 16, 64), 0, "box27", False, {}),
    ((128,) * 3, (16, 16, 64), 0, "star7", False, {}),
    ((128,) * 3, (16, 16, 64), 0, "star13+star7", False, {}),
    ((128,) * 3, (16, 8, 32), 1, "star13", False, {}),
    ((128,) * 3, (16, 8, 32), 1, "box27+star13", False, {}),
    ((128,) * 3, (8, 16, 32), 0, "star13+box27", True, {}),
    # an odd c1 extent swept along axis 1, whose c0 stride (40 x 45) is
    # even: the last pair stores its first output alone, and the output's
    # odd sweep rows (45 elements apart) go element by element
    ((37, 40, 45), (8, 8, 16), 1, "star13", False, {}),
    ((37, 40, 45), (16, 8, 32), 1, "star13+star7", False, {}),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,tile,sw,ops,padded,grid_kw", PAIR_CASES,
    ids=[f"{c[3]}-sweep{c[2]}-{'x'.join(map(str, c[0]))}"
         f"{'-padded' if c[4] else ''}" for c in PAIR_CASES])
def test_the_pair_loop_equals_plain(dev, shape, tile, sw, ops, padded,
                                    grid_kw):
    got, want, counts = _apply(dev, shape, tile, sw, ops, padded, **grid_kw)
    assert counts == {"launches.sweep_apply": 1, "apply_rows.pair": 1}
    assert _same_bits(got, want)


# shape, tile, sweep axis, operators, the grid's placement: launches the
# pair loop does not take
FALLBACK_CASES = [
    ((128,) * 3, (32, 16, 16), 2, "star13", {}),  # c1 not the minor axis
    ((128,) * 3, (16, 16, 63), 0, "star13", {}),  # odd tile c1 extent
    ((128,) * 3, (16, 16, 64), 0, "star13", {"offset": 1}),  # off a word
    ((128,) * 3, (16, 16, 64), 0, "table", {}),  # a table-driven operator
    ((128,) * 3, (16, 16, 64), 0, "star13+table", {}),
    ((37, 41, 45), (8, 16, 16), 0, "star13", {}),  # odd c0 stride
    # the 7-point star's halo of 1 along an odd sweep stride (45) puts the
    # first window off a 4-byte word
    ((37, 40, 45), (8, 8, 16), 1, "star7", {}),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,tile,sw,ops,grid_kw", FALLBACK_CASES,
    ids=[f"{c[3]}-sweep{c[2]}-tile{'x'.join(map(str, c[1]))}-{c[4]}"
         for c in FALLBACK_CASES])
def test_each_fallback_returns_no_pair_and_equals_plain(dev, shape, tile, sw,
                                                        ops, grid_kw):
    got, want, counts = _apply(dev, shape, tile, sw, ops, **grid_kw)
    assert counts == {"launches.sweep_apply": 1, "apply_rows.pair": 0}
    assert _same_bits(got, want)


@pytest.mark.cuda
def test_the_counter_counts_the_launches_whose_return_carried_the_bit(
        dev, monkeypatch):
    """``apply_rows.pair`` moves by the launches whose launcher returned
    ``kRowsPair``, once each, and by no other."""
    fn = sweep._entry("sweep_apply")
    returned = []

    def recording(*args):
        rc = fn(*args)
        returned.append(rc)
        return rc

    monkeypatch.setitem(sweep._ENTRIES, ("sweep_apply", "launch"), recording)
    before = obs.totals()
    for shape, tile, sw, ops, grid_kw in [
            ((64,) * 3, (16, 16, 32), 0, "star13", {}),
            ((64,) * 3, (16, 16, 32), 0, "table", {}),
            ((64,) * 3, (16, 16, 32), 1, "box27", {}),
            ((64,) * 3, (16, 16, 32), 0, "star7", {"offset": 1}),
            ((64,) * 3, (16, 16, 16), 2, "star13", {})]:
        _apply(dev, shape, tile, sw, ops, **grid_kw)
    got = _pairs_delta(before, obs.totals())
    assert len(returned) == got["launches.sweep_apply"] == 5
    assert [bool(rc & sweep._ROWS_PAIR) for rc in returned] == [
        True, False, True, False, False]
    assert got["apply_rows.pair"] == 2


@pytest.mark.cuda
def test_the_benchmarks_bf16_launch_keeps_two_ctas_an_sm(dev):
    """At the planned tile (16, 16, 64) the bf16 star's launch on a 512^3
    grid takes 115,216 bytes of shared memory (rows widened by 12
    elements), and the bf16 kernel keeps two CTAs an SM there."""
    oo, ws, _, lo_w, hi_w = st._launch_geometry(_specs("star13"), None,
                                                (16, 16, 64))
    x = torch.empty((512,) * 3, dtype=torch.bfloat16, device=dev)
    plan = sweep._apply_plan([x], oo, ws, lo_w, hi_w, (16, 16, 64), 0, True,
                             padded=False)
    assert (plan["geom"][32], plan["smem"]) == (12, 115216)
    assert sweep.apply_occupancy(torch.bfloat16, 0, 115216) == 2
