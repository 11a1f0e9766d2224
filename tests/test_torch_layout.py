"""The port's stencil tooling against the JAX package, on the CPU: the
layout advice (``core/padding.py``: ``tpu_layout_waste``, ``advise_dim``),
the tile and traffic reports (``kernels/ops.py``: ``plan_tiles``,
``traffic_report``), the quickstart's paper numbers and the four example
twins (``repro_torch.examples``) run with ``--device cpu``.

Tolerances: exact.  The layout figures, the byte counts and the paper's
numbers are integer arithmetic or the same float expression on both
sides; the examples check their kernels against the ``stencil_ref``
oracle themselves.
"""

import dataclasses
from math import prod

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import padding as jpadding  # noqa: E402
from repro.core import tiling as jtiling  # noqa: E402
from repro.core.cache_fitting import (  # noqa: E402
    access_stream as j_access_stream,
    natural_order as j_natural_order,
    plan_schedule as j_plan_schedule,
    star_stencil as j_star_stencil,
    upper_bound_loads as j_upper_bound_loads,
)
from repro.core.cache_sim import simulate_misses as j_simulate  # noqa: E402
from repro.core.isoperimetric import lower_bound_loads as j_lower  # noqa: E402
from repro.core.lattice import CacheGeometry as JGeom  # noqa: E402
from repro.core.lattice import InterferenceLattice as JLattice  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import padding as tpadding  # noqa: E402
from repro_torch.core.tiling import minor_unit, select_tile  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    multigrid_vcycle,
    quickstart,
    rk2_damped_jacobi,
    stencil_pipeline,
)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sweep  # noqa: E402
from repro_torch.kernels import stencil as tstencil  # noqa: E402
from repro_torch.kernels.ref import star_weights_2nd_order  # noqa: E402
from repro_torch.plan import PlanCache, Planner  # noqa: E402
from repro_torch.plan import planner as planner_mod  # noqa: E402

SHAPES = [(7,), (130,), (9, 200), (8, 128), (45, 91, 60), (3, 17, 129),
          (512, 512, 257)]


@pytest.fixture
def memory_planner(monkeypatch):
    """The default planner (un-tiled calls) without a cache on disk."""
    monkeypatch.setattr(planner_mod, "_DEFAULT",
                        Planner(cache=PlanCache(persistent=False)))


# -- layout advice --------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("tile", [(8, 128), (16, 64)], ids=str)
def test_layout_waste_equals_reference_at_its_arguments(shape, tile):
    assert (tpadding.tpu_layout_waste(shape, tile)
            == jpadding.tpu_layout_waste(shape, tile))


@pytest.mark.parametrize("n", [1, 7, 80, 127, 128, 129, 250, 2560, 32000,
                               50280])
@pytest.mark.parametrize("unit,max_waste", [(128, 0.05), (64, 0.05),
                                            (128, 0.2)])
def test_advise_dim_equals_reference_at_its_arguments(n, unit, max_waste):
    assert (tpadding.advise_dim(n, unit, max_waste)
            == jpadding.advise_dim(n, unit, max_waste))
    assert tpadding.tpu_pad_dim(n, unit) == jpadding.tpu_pad_dim(n, unit)


@pytest.mark.parametrize("dtype_bytes,unit", [(4, 32), (2, 64), (1, 128)])
def test_advise_dim_defaults_to_one_line_of_the_dtype(dtype_bytes, unit):
    """The card's grain: a 128-byte line (the planner's minor tile unit)."""
    assert minor_unit(dtype_bytes) == unit
    for n in (unit - 1, unit, 3 * unit + 1, 257):
        assert (tpadding.advise_dim(n, dtype_bytes=dtype_bytes)
                == jpadding.advise_dim(n, unit))


@pytest.mark.parametrize("shape,tile,dtype", [
    ((40, 50, 60), (8, 16, 32), torch.float32),
    ((33, 20, 257), (4, 8, 64), torch.bfloat16),
    ((24, 40, 256), None, torch.float32),
    ((30, 50, 130), None, torch.float32),
    ((17, 19, 100), None, torch.bfloat16),
    ((12, 300), (4, 32), torch.float32),
], ids=str)
def test_layout_waste_is_the_slack_of_the_launch_buffer(shape, tile, dtype):
    """The buffer ``_launch_inputs`` really allocates for the 13-point (or
    9-point, 2-D) star: ``1 - prod(shape) / numel``; ``tile=None`` is the
    planned tile of ``plan_tiles``."""
    d = len(shape)
    offs, w = star_weights_2nd_order(d, 2)
    nbytes = torch.empty((), dtype=dtype).element_size()
    if tile is None:
        tile = tops.plan_tiles(shape, 2, dtype_bytes=nbytes).tile
    u = torch.zeros(shape, dtype=dtype)
    spec = (tuple(map(tuple, offs.tolist())), tuple(w))
    ins, *_ = tstencil._launch_inputs([u], (spec,), tile)
    want = 1.0 - prod(shape) / ins[0].numel()
    got = tpadding.tpu_layout_waste(shape, tile, halo=2, dtype_bytes=nbytes)
    assert got == want
    assert tpadding.tpu_layout_waste(shape, tile, halo=[(2, 2)] * d) == want


def test_layout_waste_default_grain_is_one_line_on_the_minor_dim():
    """At its defaults: the minor dim rounded to 32 f32 (64 bf16) elements,
    the others untouched, no halo; the launch of a (1, ..., line) tile."""
    for shape, nbytes in (((45, 91, 60), 4), ((9, 200), 2), ((100,), 4)):
        unit = minor_unit(nbytes)
        want = 1.0 - shape[-1] / tpadding.tpu_pad_dim(shape[-1], unit)
        assert tpadding.tpu_layout_waste(shape, dtype_bytes=nbytes) == (
            pytest.approx(want, abs=1e-15))
    u = torch.zeros((5, 6, 70))
    ins, *_ = tstencil._launch_inputs(
        [u], ((((0, 0, 0),), (1.0,)),), (1, 1, 32))
    assert tpadding.tpu_layout_waste((5, 6, 70)) == 1.0 - u.numel() / (
        ins[0].numel())


def test_row_copy_query_needs_the_card():
    """``sweep.apply_copy16`` asks the launcher (built on the card) how it
    copies a launch's rows; it has no CPU answer and says so."""
    offs, w = star_weights_2nd_order(3, 2)
    spec = (tuple(map(tuple, offs.tolist())), tuple(w))
    ins, o, ws, _, lo_w, hi_w = tstencil._launch_inputs(
        [torch.zeros((16, 32, 64))], (spec,), (8, 16, 32))
    with pytest.raises(RuntimeError, match="on the card only"):
        sweep.apply_copy16(ins, o, ws, lo_w, hi_w, (8, 16, 32), 0)


def test_layout_waste_rejects_a_halo_of_the_wrong_rank():
    with pytest.raises(ValueError, match="halo pairs"):
        tpadding.tpu_layout_waste((4, 5, 6), halo=[(1, 1)] * 2)


# -- plan_tiles and traffic_report ------------------------------------------------


@pytest.mark.parametrize("shape,r,nbytes", [
    ((32, 64, 256), 2, 4), ((64, 128, 512), 2, 4), ((512, 512, 256), 2, 2),
    ((45, 91, 60), 1, 4), ((1, 300, 300), 2, 4), ((256, 64), 3, 4),
], ids=str)
def test_plan_tiles_and_traffic_report_hold_the_ordering(shape, r, nbytes):
    """``lower_bound <= sweep_reuse <= per_tile_halo``, ``traffic_ratio >=
    1``, the reference's keys; both byte counts are the reference's
    formula at the planned tile; ``plan_tiles`` is the planner's
    ``select_tile`` (inputs = operands - 1: the output leaves from
    registers)."""
    choice = tops.plan_tiles(shape, r, dtype_bytes=nbytes)
    assert choice == select_tile(shape, [(r, r)] * len(shape),
                                 dtype_bytes=nbytes, n_inputs=1)
    rep = tops.traffic_report(shape, r, dtype_bytes=nbytes)
    want = jops.traffic_report(shape, r, dtype_bytes=nbytes)
    assert set(rep) == set(want)
    for k in ("per_tile_halo", "sweep_reuse"):
        assert set(rep[k]) == set(want[k])
    assert rep["shape"] == want["shape"] and rep["radius"] == r
    sw, pt = rep["sweep_reuse"], rep["per_tile_halo"]
    assert sw["tile"] == pt["tile"] == choice.tile
    assert sw["sweep_axis"] == choice.sweep_axis
    assert rep["lower_bound_bytes"] <= sw["traffic_bytes"] <= pt[
        "traffic_bytes"]
    assert rep["traffic_ratio"] >= 1.0
    assert 0.0 < pt["efficiency"] <= sw["efficiency"] <= 1.0
    halo = [(r, r)] * len(shape)
    assert sw["traffic_bytes"] == jtiling.tile_traffic_bytes(
        shape, choice.tile, halo, nbytes, choice.sweep_axis)
    assert pt["traffic_bytes"] == jtiling.tile_traffic_bytes(
        shape, choice.tile, halo, nbytes, None)
    assert rep["lower_bound_bytes"] == jtiling._traffic_lower_bound(
        shape, min(tops.SMEM_BLOCK_LIMIT, 232448) // nbytes, nbytes, r)


def test_traffic_report_reuse_shows_on_a_swept_grid():
    """Where the planned tile takes several sweep steps, the per-tile-halo
    schedule reads each step's halo again: the ratio is above 1."""
    rep = tops.traffic_report((512, 512, 512), 2)
    assert rep["sweep_reuse"]["tile"][rep["sweep_reuse"]["sweep_axis"]] < 512
    assert rep["traffic_ratio"] > 1.2


# -- the quickstart's paper numbers ------------------------------------------------


def _reference_paper_numbers(dims, favorable, geometry=(2, 512, 4)):
    """The same figures from the JAX package's ``core/``."""
    geom = JGeom(*geometry)
    S = geom.size_words
    padded, info = jpadding.pad_grid(dims, S, diameter=5)
    K = j_star_stencil(3, 2)
    misses = {}
    for name, d in (("unfavorable", dims), ("padded", padded),
                    ("favorable", favorable)):
        order, bq, _ = j_plan_schedule(d, S, 2, geom=geom)
        misses[name] = {
            "dims": tuple(d),
            "points": (d[0] - 4) * (d[1] - 4) * (d[2] - 4),
            "natural": int(j_simulate(j_access_stream(
                d, j_natural_order(d, 2), K, base_q=bq), geom)),
            "cache_fitting": int(j_simulate(j_access_stream(
                d, order, K, base_q=bq), geom)),
        }
    return {
        "dims": dims, "S": S,
        "shortest": tuple(int(v) for v in
                          JLattice(dims, S).shortest(norm="l1")),
        "unfavorable": bool(jpadding.is_unfavorable(dims, S, diameter=5)),
        "padded": tuple(padded), "extra_words": int(info["extra_words"]),
        "shortest_before": float(info["shortest_before"]),
        "shortest_after": float(info["shortest_after"]),
        "misses": misses,
        "lower_bound": float(j_lower(padded, S)["bound"]),
        "upper_bound": float(j_upper_bound_loads(padded, S, 2)["bound"]),
    }


@pytest.mark.parametrize("dims,favorable", [
    ((32, 64, 12), (33, 64, 12)),   # n1·n2 = S/2: unfavorable, padded
    ((20, 24, 10), (21, 24, 10)),   # favorable already: no pad
], ids=str)
def test_quickstart_paper_numbers_equal_the_reference_core(dims, favorable):
    """The paper's figures (lattice, padding, simulated misses, bounds) at
    small grids; the defaults' (45, 91, 60) takes ~30 s a side."""
    got = quickstart.paper_numbers(dims, favorable)
    assert got == _reference_paper_numbers(dims, favorable)


def test_quickstart_paper_grid_lattice_and_padding():
    """The paper's own grid, without the cache simulation: shortest vector,
    verdict, advised padding and bounds, against the reference."""
    geom = JGeom(2, 512, 4)
    S, dims = geom.size_words, (45, 91, 60)
    padded, info = tpadding.pad_grid(dims, S, diameter=5)
    assert (padded, info) == jpadding.pad_grid(dims, S, diameter=5)
    assert tpadding.is_unfavorable(dims, S, 5) and padded == (46, 91, 60)


# -- the example twins ---------------------------------------------------------------


def test_quickstart_runs_on_the_cpu(memory_planner, capsys):
    nums = quickstart.main(["--device", "cpu", "--dims", "32", "64", "12",
                            "--favorable", "33", "64", "12",
                            "--grid", "8", "16", "64"])
    out = capsys.readouterr().out
    assert nums["unfavorable"] and "planned kernel max|err|" in out
    assert "Hopper tile for (64,128,512)" in out


def test_stencil_pipeline_runs_on_the_cpu(memory_planner, capsys):
    x = stencil_pipeline.main(["--device", "cpu", "--shape", "30", "50", "130",
                               "--iters", "2"])
    out = capsys.readouterr().out
    assert tuple(x.shape) == (30, 50, 130) and bool(torch.isfinite(x).all())
    assert "minor dim 130: pad to 160" in out and "launch-buffer waste" in out


def test_rk2_damped_jacobi_runs_on_the_cpu(capsys):
    rk2_damped_jacobi.main(["--device", "cpu", "--shape", "12", "16", "40"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK") and "fused depth 2" in out


def test_multigrid_vcycle_runs_on_the_cpu(capsys):
    """The reference's own size (48 × 64): three V-cycles and the neumann
    coda."""
    multigrid_vcycle.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("V-cycle") == 3 and out.rstrip().endswith("OK")


@pytest.mark.parametrize("example", [quickstart, stencil_pipeline,
                                     rk2_damped_jacobi, multigrid_vcycle],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_examples_raise_without_cuda_unless_asked_for_the_cpu(example):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.main([])


def test_model_padding_report_uses_the_compute_dtype():
    """Mamba2's report in bf16 and f32 lines; its ``d_ff`` of 0 is left out
    (the reference's report raises ``ZeroDivisionError`` there,
    ``ROADMAP.md`` queue C)."""
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-2.7b")
    with pytest.raises(ZeroDivisionError):
        j_get_config("mamba2-2.7b").padding_report
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    assert set(cfg.padding_report) == {"vocab", "d_model", "head_dim"}
    assert cfg.padding_report["vocab"] == tpadding.advise_dim(50280, 64)
    assert f32.padding_report["vocab"] == tpadding.advise_dim(50280, 32)
    assert cfg.padding_report["vocab"]["padded"] == 50304
