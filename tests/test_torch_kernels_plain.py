"""The port's kernels module by module, on the CPU.

* The plain versions beside the two CUDA kernels against the oracles of
  ``repro_torch.kernels.ref`` (exact in f32: same tap order).
* The oracles against the JAX package's oracles (all six boundaries,
  half-even quantization) — bit for bit in f32.
* The CUDA kernels' algorithm, replayed in numpy: the ring slots, the
  pipelined prefetch and the warm-up/steady schedule of
  ``csrc/sweep_apply.cu`` and ``csrc/sweep_chain.cu`` are emulated row by
  row, with every ring slot tagged by the row it holds, so a read of a
  slot that was overwritten (or never filled) fails here before the code
  reaches a card.
* Shared-memory reckoning, the 227 KB refusal, wrapper checks and the
  launch counters.

The kernels themselves, on the card, are tested in
``tests/test_torch_kernels_cuda.py``.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import tiling  # noqa: E402
from repro_torch.core.cache_fitting import star_stencil  # noqa: E402
from repro_torch.kernels import ref, sweep  # noqa: E402
from repro_torch.kernels import stencil as st  # noqa: E402


def _spec(o, w):
    return (tuple(map(tuple, np.asarray(o).tolist())),
            tuple(float(v) for v in w))


def _launch(shape, tile, offsets_w, stages_w=None, seed=0, n=1,
            dtype=torch.float32):
    """Padded launch buffers and geometry, as the host side builds them."""
    rng = np.random.default_rng(seed)
    us = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
          .to(dtype) for _ in range(n)]
    return (us, *st._launch_inputs(us, offsets_w, tile, stages_w))


O13, W13 = star_stencil(3, 2), np.linspace(-0.4, 0.5, 13).tolist()
O7, W7 = star_stencil(3, 1), np.linspace(0.3, -0.2, 7).tolist()
OA = np.array([[-3, 0, 0], [-1, 0, 0], [0, 0, 0], [0, 1, 0], [0, 0, -1]])
WA = [0.1, 0.2, -0.3, 0.25, 0.15]


# -- plain versions against the oracles --------------------------------------


@pytest.mark.parametrize("shape,tile", [((12, 13, 14), (4, 8, 8)),
                                        ((41, 53), (16, 16)),
                                        ((70,), (8,))])
def test_apply_plain_equals_oracle(shape, tile):
    d = len(shape)
    offs, w = star_stencil(d, 2), np.linspace(-1, 1, 4 * d + 1).tolist()
    us, ins, o, ws, _, lo_w, hi_w = _launch(shape, tile, (_spec(offs, w),))
    out = sweep.sweep_apply(ins, o, ws, lo_w, hi_w, tile, 0)
    got = out[tuple(slice(0, n) for n in shape)]
    assert torch.equal(got, ref.stencil_ref(us[0], offs, w))


def test_apply_plain_two_rhs_equals_oracle_sum():
    shape, tile = (12, 13, 14), (4, 8, 8)
    us, ins, o, ws, _, lo_w, hi_w = _launch(
        shape, tile, (_spec(O13, W13), _spec(O7, W7)), n=2
    )
    out = sweep.sweep_apply(ins, o, ws, lo_w, hi_w, tile, 0)[:12, :13, :14]
    # One f32 accumulator over both RHS equals the oracle's sum only up to
    # reassociation: compare within a few f32 ulps of the operand scale.
    want = ref.stencil_ref(us[0], O13, W13) + ref.stencil_ref(us[1], O7, W7)
    assert float((out - want).abs().max()) < 1e-5


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
@pytest.mark.parametrize("T", [2, 3])
def test_chain_plain_equals_iterated_oracle(T, window_kind):
    shape, tile = (17, 19, 21), (4, 8, 8)
    stages_w = (_spec(O13, W13),) * T
    us, ins, _, _, stages, lo_w, hi_w = _launch(
        shape, tile, stages_w[:1], stages_w, seed=3
    )
    out = sweep.sweep_chain(ins[0], stages, lo_w, hi_w, tile, 0, True,
                            window_kind, shape)
    want = us[0]
    for _ in range(T):
        want = ref.stencil_ref(want, O13, W13)
    assert torch.equal(out[:17, :19, :21], want)


def test_chain_plain_bf16_rounds_every_stage():
    """A bf16 chain stores each intermediate at bf16, as separate bf16
    launches would: the fused plain chain equals applying the plain
    single-stage version twice."""
    shape, tile = (12, 13, 14), (4, 8, 8)
    stages_w = (_spec(O7, W7), _spec(O13, W13))
    us, ins, _, _, stages, lo_w, hi_w = _launch(
        shape, tile, stages_w[:1], stages_w, dtype=torch.bfloat16
    )
    fused = sweep.sweep_chain(ins[0], stages, lo_w, hi_w, tile, 0, True,
                              "ring", shape)
    assert fused.dtype == torch.bfloat16
    step = us[0]
    for o, w in ((O7, W7), (O13, W13)):
        step = st.stencil_pallas(step, o, w, tile=tile, sweep_axis=0,
                                 device="cpu")
    assert torch.equal(fused[:12, :13, :14], step)


# -- oracles against the JAX package -----------------------------------------


@pytest.mark.parametrize("boundary,value", [
    ("zero", 0.0), ("dirichlet", 1.5), ("neumann", 0.0), ("reflect", 0.0),
    ("periodic", 0.0), ("robin", (0.5, -0.25)),
])
def test_stencil_ref_equals_jax(boundary, value):
    x = np.random.default_rng(1).standard_normal((9, 10, 11)).astype(
        np.float32)
    want = jref.stencil_ref(jnp.asarray(x), O13, W13, boundary, value)
    got = ref.stencil_ref(torch.from_numpy(x), O13, W13, boundary, value)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_quantize_refs_equal_jax():
    x = np.random.default_rng(2).standard_normal(4096).astype(np.float32)
    x[:8] = [0.125, -0.125, 0.375, 2.5 * 0.05, -2.5 * 0.05, 0.0, 9.0, -9.0]
    for scale, zp in ((0.05, 0), (0.25, 3), (0.01, -7)):
        qj = np.asarray(jref.quantize_ref(jnp.asarray(x), scale, zp))
        qt = ref.quantize_ref(torch.from_numpy(x), scale, zp)
        assert qt.dtype == torch.int8 and np.array_equal(qj, qt.numpy())
        dj = np.asarray(jref.dequantize_ref(jnp.asarray(qj), scale, zp))
        dt = ref.dequantize_ref(qt, scale, zp)
        assert np.array_equal(dj, dt.numpy())


@pytest.mark.parametrize("d,r", [(1, 2), (2, 1), (3, 2)])
def test_star_weights_equal_jax(d, r):
    jo, jw = jref.star_weights_2nd_order(d, r)
    to, tw = ref.star_weights_2nd_order(d, r)
    assert np.array_equal(jo, to) and jw == tw


# -- the CUDA kernels' algorithm, replayed in numpy --------------------------


def _lift3(x, vals, fill):
    return (fill,) * (3 - x) + tuple(int(v) for v in vals)


class _Ring:
    """A shared-memory ring of sweep rows, each slot tagged with the row it
    holds; reading a slot whose tag is not the expected row fails."""

    def __init__(self, depth, c0, c1):
        self.data = np.full((depth, c0, c1), np.nan, np.float32)
        self.tag = np.full(depth, -(10 ** 9), np.int64)
        self.depth = depth

    def put(self, g, origin, plane):
        slot = (g + origin) % self.depth
        self.data[slot] = plane
        self.tag[slot] = g

    def get(self, g, origin):
        slot = (g + origin) % self.depth
        assert self.tag[slot] == g, (g, self.tag[slot], self.depth)
        return self.data[slot]


def _axes(d, sweep_axis):
    s = sweep_axis + 3 - d
    c = [i for i in range(3) if i != s]
    return s, c[0], c[1]


def _emulate(x, offsets, weights, stages, lo_w, hi_w, tile, sweep_axis,
             pipelined, window_kind, n_true):
    """Row-by-row replay of sweep_apply.cu (``stages is None``) or
    sweep_chain.cu for f32 padded inputs ``x`` (a list of p buffers)."""
    d = x[0].ndim
    s, c0, c1 = _axes(d, sweep_axis)
    perm = (s, c0, c1)
    X = [a.numpy().reshape(_lift3(d, a.shape, 1)).transpose(perm) for a in x]
    tile3 = np.array(_lift3(d, tile, 1))[list(perm)]
    lo3 = np.array(_lift3(d, lo_w, 0))[list(perm)]
    hi3 = np.array(_lift3(d, hi_w, 0))[list(perm)]
    win = tile3 + lo3 + hi3
    out_shape = np.array(X[0].shape) - lo3 - hi3
    ntiles = out_shape // tile3
    t_s, h_s, nswp = int(tile3[0]), int(lo3[0] + hi3[0]), int(ntiles[0])
    pipe = bool(pipelined) and nswp > 1 and h_s > 0
    rows = int(win[0]) + (t_s if pipe else 0)
    out = np.full(tuple(out_shape), np.nan, np.float32)
    n_true3 = np.array(_lift3(d, n_true, 1))[list(perm)]

    def taps(offs):
        o = np.asarray(offs).reshape(-1, d)
        o3 = np.concatenate([np.zeros((len(o), 3 - d), np.int64), o], 1)
        return o3[:, list(perm)]

    if stages is not None:
        warm, steady, depths = sweep.chain_schedule(
            stages, tile, sweep_axis, window_kind)
        st3 = []
        for j, stg in enumerate(stages):
            lo_j = np.array(_lift3(d, stg.lo, 0))[list(perm)]
            sfx = np.array(_lift3(d, stg.suffix_lo, 0))[list(perm)]
            ext = tile3 + sfx + np.array(
                _lift3(d, stg.suffix_hi, 0))[list(perm)]
            st3.append((lo_j, sfx, ext, taps(stg.offsets), stg.weights))

    for t0, t1 in itertools.product(range(ntiles[1]), range(ntiles[2])):
        b0, b1 = t0 * tile3[1], t1 * tile3[2]
        rings = [_Ring(rows, win[1], win[2]) for _ in X]

        def load(g0, n):
            for a, ring in enumerate(rings):
                for g in range(g0, g0 + n):
                    ring.put(g, 0, X[a][g, b0:b0 + win[1], b1:b1 + win[2]])

        if stages is not None:
            fronts = [_Ring(depths[j], st3[j][2][1], st3[j][2][2])
                      for j in range(len(stages) - 1)]
        for k in range(nswp):
            if k == 0:
                load(0, int(win[0]))
                if pipe:
                    load(t_s + h_s, t_s)
            elif pipe:
                if k + 1 < nswp:
                    load((k + 1) * t_s + h_s, t_s)
            else:
                load(k * t_s + h_s, t_s)
            if stages is None:
                for r in range(t_s):
                    acc = np.zeros((tile3[1], tile3[2]), np.float32)
                    for a, ring in enumerate(rings):
                        for o, w in zip(taps(offsets[a]), weights[a]):
                            src = ring.get(k * t_s + r + lo3[0] + o[0], 0)
                            acc = acc + np.float32(w) * src[
                                lo3[1] + o[1]:lo3[1] + o[1] + tile3[1],
                                lo3[2] + o[2]:lo3[2] + o[2] + tile3[2]]
                    out[k * t_s + r, b0:b0 + tile3[1],
                        b1:b1 + tile3[2]] = acc
                continue
            for j, r0, r1 in (warm if k == 0 else steady):
                lo_j, sfx, ext, tp, ws = st3[j]
                for r in range(r0, r1):
                    g = k * t_s + r
                    acc = np.zeros((ext[1], ext[2]), np.float32)
                    for o, w in zip(tp, ws):
                        if j == 0:
                            src = rings[0].get(g + o[0] + lo3[0], 0)
                        else:
                            src = fronts[j - 1].get(g + o[0],
                                                    st3[j - 1][1][0])
                        acc = acc + np.float32(w) * src[
                            lo_j[1] + o[1]:lo_j[1] + o[1] + ext[1],
                            lo_j[2] + o[2]:lo_j[2] + o[2] + ext[2]]
                    if j == len(stages) - 1:
                        out[g, b0:b0 + ext[1], b1:b1 + ext[2]] = acc
                        continue
                    p1 = np.arange(ext[1]) + b0 - sfx[1]
                    p2 = np.arange(ext[2]) + b1 - sfx[2]
                    inside = (
                        (0 <= g < n_true3[0])
                        & ((p1 >= 0) & (p1 < n_true3[1]))[:, None]
                        & ((p2 >= 0) & (p2 < n_true3[2]))[None, :]
                    )
                    fronts[j].put(g, sfx[0], np.where(inside, acc, 0.0))
    inv = np.argsort(perm)
    return out.transpose(inv).reshape(tuple(int(n) for n in
                                            np.array(out_shape)[inv]
                                            [3 - d:]))


EMU_CASES = [
    # shape, tile, sweep_axis
    ((12, 13, 14), (4, 8, 8), 0),
    ((12, 13, 14), (4, 4, 8), 1),
    ((12, 13, 14), (8, 8, 4), 2),
    ((41, 53), (16, 16), 0),
    ((70,), (8,), 0),
]


@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("case", range(len(EMU_CASES)))
def test_apply_kernel_algorithm_equals_plain(case, pipelined):
    shape, tile, sw = EMU_CASES[case]
    d = len(shape)
    specs = (_spec(star_stencil(d, 2), np.linspace(-1, 1, 4 * d + 1)),
             _spec(star_stencil(d, 1), np.linspace(0.5, -0.5, 2 * d + 1)))
    _, ins, o, ws, _, lo_w, hi_w = _launch(shape, tile, specs, n=2)
    want = sweep.sweep_apply_plain(ins, o, ws, lo_w, hi_w, tile, sw)
    got = _emulate(ins, o, ws, None, lo_w, hi_w, tile, sw, pipelined,
                   None, shape)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("case", range(len(EMU_CASES)))
def test_chain_kernel_algorithm_equals_plain(case, pipelined, window_kind):
    shape, tile, sw = EMU_CASES[case]
    d = len(shape)
    if d == 3:
        stages_w = (_spec(O7, W7), _spec(OA, WA), _spec(O13, W13))
    else:
        offs = star_stencil(d, 1) if d == 2 else np.array([[-3], [0], [1]])
        stages_w = (_spec(offs, np.linspace(-0.5, 0.5, len(offs))),) * 3
    _, ins, _, _, stages, lo_w, hi_w = _launch(
        shape, tile, stages_w[:1], stages_w, seed=case
    )
    want = sweep.sweep_chain_plain(ins[0], stages, lo_w, hi_w, tile, sw,
                                   pipelined, window_kind, shape)
    got = _emulate(ins, None, None, stages, lo_w, hi_w, tile, sw,
                   pipelined, window_kind, shape)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("T", [2, 3, 5, 8])
def test_ring_schedule_never_overruns(T):
    """The ring warm-up reaches every stage's full extent, in order, and no
    frontier ever holds more rows than its depth (checked stage by stage
    from the entries alone)."""
    tile = (4, 8, 8)
    stages_w = (_spec(OA, WA),) * T
    _, _, _, _, stages, _, _ = _launch((12, 13, 14), tile, stages_w[:1],
                                       stages_w)
    warm, steady, depths = sweep.chain_schedule(stages, tile, 0, "ring")
    done = [-stg.suffix_lo[0] for stg in stages]
    for j, r0, r1 in warm:
        assert r0 == done[j] and r1 > r0
        if j > 0:
            assert r1 - 1 + stages[j].hi[0] < done[j - 1]
        if j < T - 1:
            assert r1 - (done[j + 1] - stages[j + 1].lo[0]) <= depths[j]
        done[j] = r1
    assert done == [4 + stg.suffix_hi[0] for stg in stages]
    assert [r1 - r0 for _, r0, r1 in steady] == [4] * T


def test_chain_points_count_warm_up_and_streaming():
    tile = (4, 8, 8)
    stages_w = (_spec(O13, W13),) * 2
    _, ins, _, _, stages, _, _ = _launch((8, 16, 16), tile, stages_w[:1],
                                         stages_w)
    pts = sweep.chain_points(stages, tile, 0, "ring", (8, 16, 16))
    # 4 columns; stage 0 computes ext (4+4) rows at k=0 then 4 rows at k=1
    # over a (12, 12) cross plane; stage 1 computes 4 + 4 rows of (8, 8).
    assert pts == [4 * (8 + 4) * 144, 4 * (4 + 4) * 64]


# -- shared memory, checks, counters -----------------------------------------


def test_sweep_smem_bytes_layout():
    h = [(2, 2)] * 3
    # ring of t_s + h_s (+ t_s landing) rows × (16+4) × (32+4) f32
    assert tiling.sweep_smem_bytes((8, 16, 32), 0, 4, halo=h) == \
        12 * 20 * 36 * 4
    assert tiling.sweep_smem_bytes((8, 16, 32), 0, 4, halo=h,
                                   pipelined=True) == 20 * 20 * 36 * 4
    assert tiling.sweep_smem_bytes((8, 16, 32), 0, 2, halo=h, n_inputs=2,
                                   pipelined=True) == 2 * 20 * 20 * 36 * 2
    # T=3 chain: window (4+12) × 28 × 44 f32, frontiers 24x40 and 20x36 at
    # ring depth 4+4 each, or trapezoid depths 12 and 8.
    halos = [h] * 3
    ring = tiling.sweep_smem_bytes((4, 16, 32), 0, 4, stage_halos=halos)
    trap = tiling.sweep_smem_bytes((4, 16, 32), 0, 4, stage_halos=halos,
                                   window_kind="trapezoid")
    win = 16 * 28 * 44 * 4
    assert ring == win + 8 * 24 * 40 * 4 + 8 * 20 * 36 * 4
    assert trap == win + 12 * 24 * 40 * 4 + 8 * 20 * 36 * 4
    assert tiling.frontier_depth((4, 16, 32), halos, 0, 0, "ring") == 8


def test_sweep_smem_bytes_raises_above_227kb():
    h = [(2, 2)] * 3
    with pytest.raises(ValueError, match="232448"):
        tiling.sweep_smem_bytes((8, 32, 128), 0, 4, halo=h, pipelined=True)
    with pytest.raises(ValueError, match="shared memory"):
        tiling.sweep_smem_bytes((8, 16, 32), 0, 4, stage_halos=[h] * 3,
                                pipelined=True, window_kind="trapezoid")
    # The frontend refuses the tile too — it never shrinks it.
    with pytest.raises(ValueError, match="smaller tile"):
        st.stencil_pallas(torch.zeros(8, 64, 128), O13, W13,
                          tile=(8, 64, 128), sweep_axis=0, device="cpu")


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, ins, o, ws, _, lo_w, hi_w = _launch((12, 13, 14), (4, 8, 8),
                                           (_spec(O7, W7),))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sweep.sweep_apply([ins[0].double()], o, ws, lo_w, hi_w, (4, 8, 8), 0)
    with pytest.raises(ValueError, match="lo_w"):
        sweep.sweep_apply(ins, o, ws, lo_w, hi_w, (5, 8, 8), 0)
    with pytest.raises(ValueError, match="T >= 2"):
        sweep.sweep_chain(ins[0], [], lo_w, hi_w, (4, 8, 8), 0)


def test_plain_path_counts_no_launch():
    before = (sweep.sweep_apply.launches, sweep.sweep_chain.launches)
    x = np.random.default_rng(0).standard_normal((12, 13, 14)).astype(
        np.float32)
    st.stencil_pallas(x, O13, W13, tile=(4, 8, 8), sweep_axis=0,
                      device="cpu")
    st.stencil_iterate(x, O13, W13, 2, tile=(4, 8, 8), sweep_axis=0,
                       device="cpu")
    assert (sweep.sweep_apply.launches, sweep.sweep_chain.launches) == before


@pytest.mark.parametrize("call", [
    dict(tile=None), dict(plan=object()), dict(tune=True),
    dict(num_shards=2), dict(trace="t.json"), dict(vmem_budget=1 << 20),
    dict(dtypes=["bfloat16"]),
])
def test_arguments_outside_the_slice_name_their_roadmap_item(call):
    kw = dict(tile=(4, 8, 8), sweep_axis=0, device="cpu")
    kw.update(call)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        st.stencil_pallas(np.zeros((12, 13, 14), np.float32), O7, W7, **kw)


def test_boundary_and_quantized_programs_name_their_roadmap_item():
    from repro_torch import ir

    x = np.zeros((12, 13, 14), np.float32)
    for prog in (
        ir.chain_program([(O7, W7)] * 2, 3, boundary="neumann"),
        ir.chain_program([(O7, W7)] * 2, 3, quants=[(0.1, 0), None]),
        ir.chain_program([(O7, W7)] * 2, 3, dtypes=["bfloat16", None]),
    ):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ir.run_program(prog, x, tile=(4, 8, 8), sweep_axis=0,
                           device="cpu")
