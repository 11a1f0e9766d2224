"""The port's copies of the paper's core against the JAX package's modules.

``repro_torch.core.{lattice, isoperimetric, padding, cache_fitting,
cache_sim}`` and the reference traffic and compute models of
``repro_torch.core.tiling`` are copies of the reference's numpy code; on
the same seeded inputs every function returns what the reference returns,
exactly (integers, arrays and floats alike).  The grids include the plan
explain smoke's favorable (64, 91, 60) and unfavorable (45, 91, 24) grids
under the paper's (2, 512, 4) cache.
"""

import numpy as np
import pytest

from repro.core import cache_fitting as jfit
from repro.core import cache_sim as jsim
from repro.core import isoperimetric as jiso
from repro.core import lattice as jlat
from repro.core import padding as jpad
from repro.core import tiling as jtil
from repro_torch.core import cache_fitting as tfit
from repro_torch.core import cache_sim as tsim
from repro_torch.core import isoperimetric as tiso
from repro_torch.core import lattice as tlat
from repro_torch.core import padding as tpad
from repro_torch.core import tiling as ttil

S = 2 * 512 * 4  # the paper's (2, 512, 4) cache, in words


def _grids():
    rng = np.random.default_rng(11)
    grids = [(45, 91, 24), (64, 91, 60), (16, 16), (90, 182, 24)]
    for _ in range(4):
        d = int(rng.integers(2, 4))
        grids.append(tuple(int(n) for n in rng.integers(8, 120, size=d)))
    return grids


GRIDS = _grids()


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b or (a != a and b != b), (a, b)


@pytest.mark.parametrize("dims", GRIDS, ids=str)
def test_lattice_equals_reference(dims):
    _same(tlat.fortran_strides(dims), jlat.fortran_strides(dims))
    B = tlat.interference_basis(dims, S)
    _same(B, jlat.interference_basis(dims, S))
    R = tlat.lll_reduce(B)
    _same(R, jlat.lll_reduce(B))
    assert tlat.is_lll_reduced(R) == jlat.is_lll_reduced(R)
    assert tlat.is_lll_reduced(B) == jlat.is_lll_reduced(B)
    for norm in ("l1", "l2", "linf"):
        _same(tlat.shortest_vector(R, norm), jlat.shortest_vector(R, norm))
    assert tlat.basis_eccentricity(R) == jlat.basis_eccentricity(R)
    lt, lj = tlat.InterferenceLattice(dims, S), jlat.InterferenceLattice(dims, S)
    _same(lt.reduced, lj.reduced)
    assert lt.shortest_len("l1") == lj.shortest_len("l1")
    assert lt.det() == lj.det() and lt.eccentricity == lj.eccentricity
    v = tuple(int(x) for x in R[0])
    assert lt.contains(v) and lj.contains(v)
    g, h = tlat.CacheGeometry(2, 512, 4), jlat.CacheGeometry(2, 512, 4)
    addr = np.arange(0, 20000, 37)
    _same(g.set_of(addr), h.set_of(addr))
    _same(g.tag_of(addr), h.tag_of(addr))
    assert (g.size_words, g.set_span_words) == (h.size_words, h.set_span_words)


@pytest.mark.parametrize("d", [2, 3, 4])
def test_isoperimetric_equals_reference(d):
    for t in range(-1, 12):
        assert tiso.octahedron_volume(d, t) == jiso.octahedron_volume(d, t)
        assert tiso.octahedron_boundary(d, t) == jiso.octahedron_boundary(d, t)
        assert tiso.simplex_volume(d, t) == jiso.simplex_volume(d, t)
        assert tiso.octahedron_volume_recurrence(d, t) == \
            jiso.octahedron_volume_recurrence(d, t)
        assert tiso.boundary_recurrence_holds(d, t) == \
            jiso.boundary_recurrence_holds(d, t)
    assert tiso.c_d(d) == jiso.c_d(d)
    assert tiso.choose_sigma_t(d, S) == jiso.choose_sigma_t(d, S)
    for dims in GRIDS:
        if len(dims) == d:
            for p in (1, 2, 3):
                _same(tiso.lower_bound_loads(dims, S, p),
                      jiso.lower_bound_loads(dims, S, p))


@pytest.mark.parametrize("dims", GRIDS, ids=str)
def test_padding_equals_reference(dims):
    for norm in ("l1", "l2"):
        assert tpad.shortest_len(dims, S, norm) == jpad.shortest_len(dims, S,
                                                                    norm)
    for diameter, a in ((5, 1), (5, 2), (9, 1)):
        assert tpad.is_unfavorable(dims, S, diameter, a) == \
            jpad.is_unfavorable(dims, S, diameter, a)
    assert tpad.hyperbola_index(dims, S) == jpad.hyperbola_index(dims, S)
    try:
        want = jpad.pad_grid(dims, S, 5, max_pad=8)
    except ValueError as e:
        with pytest.raises(ValueError, match="no favorable padding"):
            tpad.pad_grid(dims, S, 5, max_pad=8)
        assert "no favorable padding" in str(e)
    else:
        _same(tpad.pad_grid(dims, S, 5, max_pad=8), want)
    assert tpad.tpu_pad_dim(dims[0], 128) == jpad.tpu_pad_dim(dims[0], 128)


def test_unfavorable_smoke_grid_pads_as_the_reference():
    assert jpad.is_unfavorable((45, 91, 24), S, 5)
    assert not jpad.is_unfavorable((64, 91, 60), S, 5)
    _same(tpad.pad_grid((45, 91, 24), S, 5), jpad.pad_grid((45, 91, 24), S, 5))


@pytest.mark.parametrize("dims,r", [((20, 18, 14), 1), ((24, 10), 2),
                                    ((12, 13, 9), 2)])
def test_cache_fitting_equals_reference(dims, r):
    d = len(dims)
    _same(tfit.star_stencil(d, r), jfit.star_stencil(d, r))
    _same(tfit.box_stencil(d, r), jfit.box_stencil(d, r))
    _same(tfit.natural_order(dims, r), jfit.natural_order(dims, r))
    s_small = 64
    for sweep in ("shortest", "auto", 0, d - 1):
        _same(tfit.cache_fitting_order(dims, s_small, r, sweep=sweep),
              jfit.cache_fitting_order(dims, s_small, r, sweep=sweep))
    order = tfit.natural_order(dims, r)
    K = tfit.star_stencil(d, r)
    _same(tfit.access_stream(dims, order, K),
          jfit.access_stream(dims, order, K))
    _same(tfit.access_stream(dims, order, K, base_u=7, base_q=99),
          jfit.access_stream(dims, order, K, base_u=7, base_q=99))
    o_t, q_t, info_t = tfit.plan_schedule(dims, s_small, r)
    o_j, q_j, info_j = jfit.plan_schedule(dims, s_small, r)
    _same((o_t, q_t, info_t), (o_j, q_j, info_j))
    assert tfit.lll_c_d(d) == jfit.lll_c_d(d)
    for p in (1, 2, 3):
        _same(tfit.upper_bound_loads(dims, S, r, p),
              jfit.upper_bound_loads(dims, S, r, p))
        assert tfit.rhs_array_offsets(dims, S, p) == \
            jfit.rhs_array_offsets(dims, S, p)


@pytest.mark.parametrize("geom", [(1, 64, 1), (2, 32, 4), (3, 16, 2),
                                  (4, 8, 4)])
def test_cache_sim_equals_reference(geom):
    rng = np.random.default_rng(sum(geom))
    addr = rng.integers(0, 4096, size=3000)
    dims = (12, 10, 9)
    stream = tfit.access_stream(dims, tfit.natural_order(dims, 1),
                                tfit.star_stencil(3, 1))
    gt, gj = tsim.CacheGeometry(*geom), jsim.CacheGeometry(*geom)
    for a in (addr, stream, np.zeros(0, np.int64)):
        assert tsim.simulate_misses(a, gt) == jsim.simulate_misses(a, gj)
        assert tsim.simulate_loads(a, gt) == jsim.simulate_loads(a, gj)
    assert dict(tsim.MissReport.measure(stream, gt)) == \
        dict(jsim.MissReport.measure(stream, gj))


@pytest.mark.parametrize("shape,tile,sweep", [
    ((40, 36, 70), (8, 16, 32), 0), ((40, 36, 70), (5, 7, 9), 2),
    ((33, 65), (16, 16), None), ((100,), (32,), 0),
])
def test_tiling_models_equal_reference(shape, tile, sweep):
    d = len(shape)
    halo = [(1, 2)] * d
    stages = [[(1, 1)] * d, [(2, 2)] * d, [(0, 1)] * d]
    assert ttil.surface_to_volume(tile, halo) == \
        jtil.surface_to_volume(tile, halo)
    assert ttil.fused_halo(halo, 3) == jtil.fused_halo(halo, 3)
    for ts in (1, 2):
        assert ttil.tile_traffic_bytes(shape, tile, halo, 4, sweep, ts) == \
            jtil.tile_traffic_bytes(shape, tile, halo, 4, sweep, ts)
    assert ttil.tile_traffic_bytes(shape, tile, halo, 2, sweep,
                                   stage_halos=stages) == \
        jtil.tile_traffic_bytes(shape, tile, halo, 2, sweep,
                                stage_halos=stages)
    for streaming in (True, False):
        assert ttil.chain_flops(shape, tile, [7, 13, 5], stages, sweep,
                                streaming) == \
            jtil.chain_flops(shape, tile, [7, 13, 5], stages, sweep,
                             streaming)
    for r in (0, 1, 3):
        assert ttil._traffic_lower_bound(shape, 4096, 4, r) == \
            jtil._traffic_lower_bound(shape, 4096, 4, r)
