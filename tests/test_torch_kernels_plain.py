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
from test_torch_kernels_cuda import (  # noqa: E402
    BOX27,
    CHAIN_CONFIGS,
    _launches,
    _symmetric_chain,
)


def _spec(o, w):
    return (tuple(map(tuple, np.asarray(o).tolist())),
            tuple(float(v) for v in w))


def _launch(shape, tile, offsets_w, stages_w=None, seed=0, n=1,
            dtype=torch.float32, **kw):
    """Padded launch buffers and geometry, as the host side builds them
    (``kw``: ``bcs_w``, ``dtypes_w``, ``quants_w``, ``in_quant``; with
    ``in_quant`` the grid is made of int8 codes)."""
    rng = np.random.default_rng(seed)
    if kw.get("in_quant") is not None:
        us = [torch.from_numpy(rng.integers(-128, 128, shape, np.int8))
              for _ in range(n)]
    else:
        us = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              .to(dtype) for _ in range(n)]
    return (us, *st._launch_inputs(us, offsets_w, tile, stages_w, **kw))


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


@pytest.mark.parametrize("boundary,value", [
    ("zero", 0.0), ("dirichlet", 1.5), ("neumann", 0.0), ("reflect", 0.0),
    ("periodic", 0.0), ("robin", (0.5, -0.25)),
])
@pytest.mark.parametrize("shape,dtype", [((9, 10, 11), "bfloat16"),
                                         ((2, 3, 9), "float32")])
def test_stencil_ref_equals_jax_bf16_and_short_axes(boundary, value, shape,
                                                    dtype):
    """bf16 grids, and axes shorter than the stencil's reach (the pads
    wrap or reflect more than once), bit for bit."""
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jref.stencil_ref(jx, O13, W13, boundary, value)
    got = ref.stencil_ref(tx, O13, W13, boundary, value)
    assert str(got.dtype) == f"torch.{dtype}"
    assert np.array_equal(np.asarray(want.astype(jnp.float32)),
                          got.float().numpy())


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


def _bf16(v):
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
        torch.bfloat16).float().numpy()


def _quant(v, q):
    s_, zp = np.float32(q[0]), np.float32(int(q[1]))
    return np.clip(np.round(v / s_) + zp, np.float32(-128), np.float32(127))


def _dequant(v, q):
    return (v - np.float32(int(q[1]))) * np.float32(q[0])


def _emulate(x, offsets, weights, stages, lo_w, hi_w, tile, sweep_axis,
             pipelined, window_kind, n_true, in_quant=None):
    """Row-by-row replay of sweep_apply.cu (``stages is None``) or
    sweep_chain.cu for padded inputs ``x`` (a list of p buffers), returned
    as f32 (int8 outputs as their codes).  The chain replay reads the
    host-built correction-term table as the kernel does (roles, global
    planes, ring-relative sweep offset, flat cross offset, coefficient
    bits) and rounds each stored row as its stage's rounding code says."""
    d = x[0].ndim
    s, c0, c1 = _axes(d, sweep_axis)
    perm = (s, c0, c1)
    X = [a.float().numpy().reshape(_lift3(d, a.shape, 1)).transpose(perm)
         for a in x]
    if in_quant is not None:
        X = [_dequant(a, in_quant) for a in X]
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
        rounding = sweep._stage_rounding(stages, x[0].dtype)
        bc_begin, bc_rows = sweep._bc_table(stages, tile, lo_w, hi_w,
                                            sweep_axis, n_true)
        listed = _class_lists(stages, bc_begin, bc_rows, sweep_axis, n_true)
        periodic = any(stg.bc is not None and stg.bc[0] == "periodic"
                       for stg in stages)
        st3 = []
        for j, stg in enumerate(stages):
            lo_j = np.array(_lift3(d, stg.lo, 0))[list(perm)]
            sfx = np.array(_lift3(d, stg.suffix_lo, 0))[list(perm)]
            ext = tile3 + sfx + np.array(
                _lift3(d, stg.suffix_hi, 0))[list(perm)]
            hi_j = np.array(_lift3(d, stg.hi, 0))[list(perm)]
            rows_j = bc_rows[bc_begin[j]:bc_begin[j + 1]]
            st3.append((lo_j, sfx, ext, taps(stg.offsets), stg.weights,
                        hi_j, rows_j))

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
                lo_j, sfx, ext, tp, ws, hi_j, rows_j = st3[j]
                stg = stages[j]

                def src_row(g_src):
                    if j == 0:
                        return rings[0].get(g_src + lo3[0], 0)
                    return fronts[j - 1].get(g_src, st3[j - 1][1][0])

                for r in range(r0, r1):
                    g = k * t_s + r
                    acc = np.zeros((ext[1], ext[2]), np.float32)
                    for o, w in zip(tp, ws):
                        src = src_row(g + o[0])
                        acc = acc + np.float32(w) * src[
                            lo_j[1] + o[1]:lo_j[1] + o[1] + ext[1],
                            lo_j[2] + o[2]:lo_j[2] + o[2] + ext[2]]
                    p1 = np.arange(ext[1]) + b0 - sfx[1]
                    p2 = np.arange(ext[2]) + b1 - sfx[2]
                    pos = (np.full((ext[1], ext[2]), g), p1[:, None]
                           + 0 * p2[None, :], 0 * p1[:, None] + p2[None, :])
                    face = any(
                        _band(ax, lo_j[a], hi_j[a], n_true3[a]) for a, ax in
                        enumerate((np.arange(r0, r1) + k * t_s, p1, p2)))
                    if stg.bc is not None and stg.bc[0] != "periodic":
                        add = np.zeros_like(acc)
                        # Each element scans its position class's list.
                        cls = sum(
                            m * np.where(pos[a] < lo_j[a], 0, np.where(
                                pos[a] >= n_true3[a] - hi_j[a], 2, 1))
                            for a, m in enumerate((9, 3, 1)))
                        flat = ((np.arange(ext[1])[:, None] + lo_j[1])
                                * (win[2] if j == 0 else st3[j - 1][2][2])
                                + np.arange(ext[2])[None, :] + lo_j[2])
                        for qi, row in enumerate(rows_j):
                            kind, tests = row[0], _row_tests(row)
                            coef = np.array(row[6], np.int32).view(
                                np.float32)
                            if kind == 0:
                                hit = np.zeros(acc.shape, bool)
                                for a, off in tests:
                                    q = pos[a] + off
                                    hit |= (q < 0) | (q >= n_true3[a])
                                term = np.broadcast_to(coef, acc.shape)
                            else:
                                hit = np.ones(acc.shape, bool)
                                for a, plane in tests:
                                    hit &= pos[a] == plane
                                src = src_row(g + row[4]).reshape(-1)
                                term = coef * src[flat + row[5]]
                            hit &= listed[j][cls, qi] & face
                            add = np.where(hit, add + term, add)
                        acc = acc + add
                    if j == len(stages) - 1:
                        if rounding[j] == sweep._ROUND_QUANT:
                            acc = _quant(acc, stg.quant)
                        out[g, b0:b0 + ext[1], b1:b1 + ext[2]] = acc
                        continue
                    inside = np.ones(acc.shape, bool)
                    for a in range(3):
                        lob, hib = 0, n_true3[a]
                        if periodic:
                            lob = -sfx[a]
                            hib = n_true3[a] + ext[a] - tile3[a] - sfx[a]
                        inside &= (pos[a] >= lob) & (pos[a] < hib)
                    v = np.where(inside, acc, np.float32(0))
                    if rounding[j] == sweep._ROUND_BF16:
                        v = _bf16(v)
                    elif rounding[j] == sweep._ROUND_QUANT:
                        v = _dequant(_quant(v, stg.quant), stg.quant)
                    fronts[j].put(g, sfx[0], v)
    inv = np.argsort(perm)
    return out.transpose(inv).reshape(tuple(int(n) for n in
                                            np.array(out_shape)[inv]
                                            [3 - d:]))


def _row_tests(row):
    """A correction-term row's tests: ``(role, value)`` for each role the
    row tests (``sweep._NONE`` marks the others)."""
    return [(r, v) for r, v in enumerate(row[1:4]) if v != sweep._NONE]


def _band(coords, lo, hi, n):
    """Do the coordinates reach into a stage's face band along one axis?"""
    return bool((np.min(coords) < lo) or (np.max(coords) >= n - hi))


def _class_lists(stages, begin, rows, sweep_axis, n_true):
    """Per stage, a (27, rows of the stage) bool matrix: which table rows
    the class lists of ``sweep._bc_classes`` name for each class."""
    tab = sweep._bc_classes(stages, begin, rows, sweep_axis, n_true)
    nb = len(stages) * sweep.N_CLASSES + 1
    out = []
    for j in range(len(stages)):
        m = np.zeros((sweep.N_CLASSES, begin[j + 1] - begin[j]), bool)
        for k in range(sweep.N_CLASSES):
            b = tab[j * sweep.N_CLASSES + k]
            e = tab[j * sweep.N_CLASSES + k + 1]
            for q in tab[nb + b:nb + e]:
                m[k, q - begin[j]] = True
        out.append(m)
    return out


EMU_CASES = [
    # shape, tile, sweep_axis
    ((12, 13, 14), (4, 8, 8), 0),
    ((12, 13, 14), (4, 4, 8), 1),
    ((12, 13, 14), (8, 8, 4), 2),
    ((41, 53), (16, 16), 0),
    ((70,), (8,), 0),
    # a sweep tile that is no multiple of the chain's 4-row register
    # block, an odd minor extent
    ((13, 13, 15), (5, 8, 8), 0),
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


@pytest.mark.parametrize("config", sorted(CHAIN_CONFIGS))
@pytest.mark.parametrize("case", range(len(EMU_CASES)))
def test_chain_kernel_with_boundaries_and_dtypes_equals_plain(case, config):
    """The replay reads the correction-term table, rounds and quantizes as
    the kernel does, and equals the plain version bit for bit (a table
    row with a wrong role, plane or offset fails here)."""
    shape, tile, sw = EMU_CASES[case]
    kw = CHAIN_CONFIGS[config]
    stages_w = _symmetric_chain(len(shape), 2)
    _, ins, _, _, stages, lo_w, hi_w = _launch(
        shape, tile, stages_w[:1], stages_w, seed=case, **kw
    )
    iq = kw.get("in_quant")
    wk = "ring" if case % 2 == 0 else "trapezoid"
    want = sweep.sweep_chain_plain(ins[0], stages, lo_w, hi_w, tile, sw,
                                   True, wk, shape, in_quant=iq)
    got = _emulate(ins, None, None, stages, lo_w, hi_w, tile, sw, True, wk,
                   shape, in_quant=iq)
    assert want.dtype == {"float32": torch.float32,
                          "bfloat16": torch.bfloat16,
                          "int8": torch.int8}[kw.get("dtypes_w",
                                                     ("float32",) * 2)[-1]]
    got = torch.from_numpy(got).to(want.dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["dirichlet", "neumann", "reflect", "robin"])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_bc_table_equals_plain_bc_terms(d, kind):
    """The host-built correction-term table, evaluated in numpy over a
    one-tile window (flat cross offsets, roles, planes, coefficient bits),
    equals the plain ``_bc_terms`` sum of every boundary kind, both by a
    scan of the whole table and by each element's class list."""
    value = {"dirichlet": -0.75, "robin": (0.7, 0.3)}.get(kind, 0.0)
    shape = (9, 10, 11)[:d]
    offs = BOX27[:, 3 - d:] if d == 3 else star_stencil(d, 2)
    offs = np.unique(offs, axis=0)
    w = np.linspace(-0.3, 0.4, len(offs)).tolist()
    stages_w = (_spec(offs, w),)
    us, ins, _, _, stages, lo_w, hi_w = _launch(
        shape, shape, stages_w, stages_w, bcs_w=((kind, value),))
    (stg,) = stages
    x = ins[0].float()
    pos = [torch.arange(n) for n in shape]
    want = sweep._bc_terms(stg, x, list(shape), pos, shape).numpy()
    begin, rows = sweep._bc_table(stages, shape, lo_w, hi_w, 0, shape)
    assert begin == [0, len(rows)] and rows
    # The table's roles and offsets are (sweep, c0, c1) of the lifted grid.
    perm = _axes(d, 0)
    X = x.numpy().reshape(_lift3(d, x.shape, 1)).transpose(perm)
    lo3 = np.array(_lift3(d, lo_w, 0))[list(perm)]
    n3 = tuple(np.array(_lift3(d, shape, 1))[list(perm)])
    idx = np.indices(n3)
    (listed,) = _class_lists(stages, begin, rows, 0, shape)
    lo_j = np.array(_lift3(d, stg.lo, 0))[list(perm)]
    hi_j = np.array(_lift3(d, stg.hi, 0))[list(perm)]
    cls = sum(m * np.where(idx[a] < lo_j[a], 0,
                           np.where(idx[a] >= n3[a] - hi_j[a], 2, 1))
              for a, m in enumerate((9, 3, 1)))
    got = np.zeros(n3, np.float32)
    by_class = np.zeros(n3, np.float32)
    w1 = X.shape[2]
    for q, row in enumerate(rows):
        tests = _row_tests(row)
        coef = np.array(row[6], np.int32).view(np.float32)
        if row[0] == 0:
            hit = np.zeros(n3, bool)
            for a, off in tests:
                hit |= (idx[a] + off < 0) | (idx[a] + off >= n3[a])
            term = np.broadcast_to(coef, n3)
        else:
            hit = np.ones(n3, bool)
            for a, plane in tests:
                hit &= idx[a] == plane
            plane_src = X[idx[0] + lo3[0] + row[4]].reshape(n3 + (-1,))
            flat = (idx[1] + lo3[1]) * w1 + idx[2] + lo3[2] + row[5]
            term = coef * np.take_along_axis(
                plane_src, flat[..., None], -1)[..., 0]
        got = np.where(hit, got + term, got)
        by_class = np.where(hit & listed[cls, q], by_class + term, by_class)
    for sums in (got, by_class):
        sums = sums.transpose(np.argsort(perm)).reshape(shape)
        assert np.array_equal(sums, want)


def _term_fires(row, p, n3):
    """The kernel's firing test of one table row at global position ``p``
    (sweep, c0, c1 roles) of a grid ``n3``."""
    tests = _row_tests(row)
    if row[0] == 0:
        return any(not 0 <= p[r] + off < n3[r] for r, off in tests)
    return all(p[r] == v for r, v in tests)


@pytest.mark.parametrize("kind", ["dirichlet", "neumann", "reflect", "robin"])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_bc_class_lists_equal_full_table_scan(d, kind):
    """For every position of a small grid and its suffix margin (outside
    the domain too), the terms of the element's class list that fire are
    exactly the terms of the whole table that fire, in the same order, so
    the two sums are the same f32 sum; and class (1, 1, 1) lists
    nothing."""
    value = {"dirichlet": -0.75, "robin": (0.7, 0.3)}.get(kind, 0.0)
    shape = (7, 8, 9)[:d]
    offs = np.unique(BOX27[:, 3 - d:] if d == 3 else star_stencil(d, 2),
                     axis=0)
    w = np.linspace(-0.3, 0.4, len(offs)).tolist()
    stages_w = (_spec(offs, w), _spec(star_stencil(d, 1),
                                      np.linspace(0.2, -0.1, 2 * d + 1)))
    _, _, _, _, stages, lo_w, hi_w = _launch(
        shape, shape, stages_w[:1], stages_w,
        bcs_w=((kind, value), (kind, value)))
    begin, rows = sweep._bc_table(stages, shape, lo_w, hi_w, 0, shape)
    tab = sweep._bc_classes(stages, begin, rows, 0, shape)
    nb = len(stages) * sweep.N_CLASSES + 1
    assert len(tab) == nb + tab[nb - 1]
    perm = _axes(d, 0)
    n3 = tuple(int(v) for v in np.array(_lift3(d, shape, 1))[list(perm)])
    rng = np.random.default_rng(d)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    for j, stg in enumerate(stages):
        lo3 = np.array(_lift3(d, stg.lo, 0))[list(perm)]
        hi3 = np.array(_lift3(d, stg.hi, 0))[list(perm)]
        sfx = np.array(_lift3(d, stg.suffix_lo, 0))[list(perm)]
        ranges = [range(-int(sfx[a]) - 1, n3[a] + int(sfx[a]) + 1)
                  if n3[a] > 1 else range(1) for a in range(3)]
        mid = (1, 1, 1)
        k_mid = 9 * mid[0] + 3 * mid[1] + mid[2]
        assert tab[j * 27 + k_mid] == tab[j * 27 + k_mid + 1]
        for p in itertools.product(*ranges):
            k = sum(m * sweep.position_class(p[a], lo3[a], hi3[a], n3[a])
                    for a, m in enumerate((9, 3, 1)))
            lst = tab[nb + tab[j * 27 + k]:nb + tab[j * 27 + k + 1]]
            assert lst == sorted(lst)
            assert all(begin[j] <= q < begin[j + 1] for q in lst)
            full = [q for q in range(begin[j], begin[j + 1])
                    if _term_fires(rows[q], p, n3)]
            assert [q for q in lst if _term_fires(rows[q], p, n3)] == full
            a = b = np.float32(0)
            for q in full:
                a = a + vals[q]
            for q in lst:
                if _term_fires(rows[q], p, n3):
                    b = b + vals[q]
            assert a == b


def test_thread_constants_match_the_kernels_launch_bounds():
    """Each sweep kernel's threads per CTA, as the wrapper passes it,
    is the count its source declares in ``__launch_bounds__``."""
    import re
    from pathlib import Path

    csrc = Path(sweep.__file__).resolve().parent.parent / "csrc"
    apply_src = (csrc / "sweep_apply.cu").read_text()
    chain_src = (csrc / "sweep_chain.cu").read_text()
    assert re.findall(r"__launch_bounds__\((\d+), 2\)", apply_src) == [
        str(sweep.APPLY_THREADS)]
    assert re.findall(r"__launch_bounds__\((\w+), 1\)", chain_src) == [
        "kThreads"]
    assert re.search(r"constexpr int kThreads = (\d+);", chain_src).group(
        1) == str(sweep.CHAIN_THREADS)


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


def test_sweep_smem_bytes_prices_int8_windows_at_one_byte():
    """An int8 input ring costs one byte an element; frontiers stay f32
    whatever the stage dtype (they hold already-rounded values)."""
    h = [(2, 2)] * 3
    assert tiling.sweep_smem_bytes((8, 16, 32), 0, 1, halo=h,
                                   pipelined=True) == 20 * 20 * 36
    halos = [h] * 2
    ring = tiling.sweep_smem_bytes((4, 16, 32), 0, 1, stage_halos=halos)
    assert ring == 12 * 24 * 40 + 8 * 20 * 36 * 4


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
    with pytest.raises(ValueError, match="T >= 1"):
        sweep.sweep_chain(ins[0], [], lo_w, hi_w, (4, 8, 8), 0)


def test_plain_path_counts_no_launch():
    before = (_launches("sweep_apply"), _launches("sweep_chain"))
    x = np.random.default_rng(0).standard_normal((12, 13, 14)).astype(
        np.float32)
    st.stencil_pallas(x, O13, W13, tile=(4, 8, 8), sweep_axis=0,
                      device="cpu")
    st.stencil_iterate(x, O13, W13, 2, tile=(4, 8, 8), sweep_axis=0,
                       device="cpu")
    assert (_launches("sweep_apply"), _launches("sweep_chain")) == before


@pytest.mark.parametrize("call", [
    pytest.param(dict(tune=True), id="call0"),
    pytest.param(dict(num_shards=2), id="call1"),
    pytest.param(dict(trace="t.json"), id="call2"),
    pytest.param(dict(mesh=2), id="call3"),
    pytest.param(dict(tile=None, num_shards=2), id="call4"),
    pytest.param(dict(tile=None, shard_axis=1), id="call5"),
    pytest.param(dict(tile=None, tune=True), id="call6"),
])
def test_arguments_outside_the_slice_name_their_roadmap_item(
        call, tmp_path, monkeypatch):
    """The arguments that once raised naming their ``ROADMAP.md`` item
    all run now.  ``tune=`` and ``trace=`` (items 9 and 10): ``tune=``
    beside a tile is the caller's contradiction (``ValueError``, as in the
    JAX package), ``trace=`` writes a trace that reconciles, and ``tune=``
    without a tile tunes on the call's device.  Sharding (item 11):
    ``num_shards=``, ``mesh=`` (a CPU mesh of 2 shards here) and
    ``shard_axis=``, with a tile or without, equal the unsharded call."""
    from repro_torch.launch.mesh import make_column_mesh
    from repro_torch.obs.report import reconcile, summarize
    from repro_torch.obs.trace_event import load_trace
    from repro_torch.plan import PlanCache, Planner
    from repro_torch.plan import planner as planner_mod
    from repro_torch.plan import tune as tune_mod

    monkeypatch.setattr(planner_mod, "_DEFAULT",
                        Planner(cache=PlanCache(persistent=False)))
    monkeypatch.setattr(tune_mod, "_DEFAULT", {})
    monkeypatch.setenv("REPRO_TORCH_TUNED_DB_DIR", str(tmp_path / "tuned"))
    kw = dict(tile=(4, 8, 8), sweep_axis=0, device="cpu")
    kw.update(call)
    if "trace" in call:
        kw["trace"] = str(tmp_path / call["trace"])
    if "mesh" in call:
        kw["mesh"] = make_column_mesh(call["mesh"], device="cpu")
    x = np.zeros((12, 13, 14), np.float32)
    if "tune" in call and kw["tile"] is not None:
        with pytest.raises(ValueError, match="tune="):
            st.stencil_pallas(x, O7, W7, **kw)
    elif "tune" in call or "trace" in call:
        out = st.stencil_pallas(x, O7, W7, **kw)
        assert torch.equal(out, torch.zeros_like(out))
        if "trace" in call:
            assert reconcile(summarize(load_trace(kw["trace"]))) == []
        else:
            assert tune_mod.resolve_tuner(True, "cpu").last_record
    else:
        x = np.random.default_rng(3).standard_normal(x.shape).astype(
            np.float32)
        out = st.stencil_pallas(x, O7, W7, **kw)
        unsharded = {k: v for k, v in kw.items()
                     if k not in ("num_shards", "mesh", "shard_axis")}
        assert torch.equal(out, st.stencil_pallas(x, O7, W7, **unsharded))


def test_boundary_and_quantized_programs_name_their_roadmap_item():
    """The calls of ``ROADMAP.md`` items 4-6 (boundary taps, stage dtypes,
    int8 frontiers), which the port once refused, now run and equal the
    JAX launch: a neumann chain, a quantized stage, a bf16 stage, and a
    ``dtypes=["bfloat16"]`` single application."""
    from repro import ir as jir
    from repro.kernels import stencil as jst
    from repro_torch import ir

    x = np.random.default_rng(5).standard_normal((12, 13, 14)).astype(
        np.float32)
    kw = dict(tile=(4, 8, 8), sweep_axis=0)
    for spec in (
        dict(boundary="neumann"),
        dict(quants=[(0.1, 0), None]),
        dict(dtypes=["bfloat16", None]),
    ):
        jprog = jir.chain_program([(O7, W7)] * 2, 3, **spec)
        want = jir.run_program(jprog, jnp.asarray(x), interpret=True, **kw)
        got = ir.run_program(ir.Program.from_json(jprog.serialize()), x,
                             device="cpu", **kw)
        assert np.array_equal(np.asarray(want), got.numpy()), spec
    want = jst.stencil_pallas(jnp.asarray(x), O7, W7, dtypes=["bfloat16"],
                              interpret=True, **kw)
    got = st.stencil_pallas(x, O7, W7, dtypes=["bfloat16"], device="cpu",
                            **kw)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(np.asarray(want.astype(jnp.float32)),
                          got.float().numpy())


def test_plan_key_normalizes_values_as_the_launch_consumes_them():
    """The chain wrapper's table cache key holds each value as the launch
    rounds it: two quantization scales or robin coefficients that print
    alike as 0-dim tensors but differ in f32 get different keys, and one
    value given as a Python float, a numpy scalar or a tensor gets one."""
    shape, tile = (12, 13, 14), (4, 8, 8)
    stages_w = (_spec(O7, W7), _spec(O13, W13))

    def key(scale, alpha):
        kw = dict(bcs_w=(("robin", (alpha, 0.3)),) * 2,
                  dtypes_w=("int8", "float32"), quants_w=((scale, 3), None))
        _, ins, _, _, stages, lo_w, hi_w = _launch(
            shape, tile, stages_w[:1], stages_w, **kw)
        return sweep._plan_key(ins[0], stages, lo_w, hi_w, tile, 0, True,
                               "ring", shape, None, None)

    t = torch.tensor
    assert repr(t(0.02)) == repr(t(0.02001))
    base = key(t(0.02), t(0.7))
    assert key(t(0.02001), t(0.7)) != base
    assert key(t(0.02), t(0.70001)) != base
    assert key(0.02, 0.7) == base == key(np.float64(0.02), np.float32(0.7))
    hash(base)
