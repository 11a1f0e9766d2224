"""The index maps of the port's conv and apply kernels, replayed in numpy.

``csrc/conv1d.cu`` and ``csrc/sweep_apply.cu`` run only on the card.
Here their work division is replayed line by line from the sources, on
the CPU:

* the conv's warps: every output row of every channel is computed once,
  each run's W-1 halo rows come from ``x``, ``state`` or zeros, and the
  f32 sums of that replay equal the plain version's bit for bit; the
  wrapper's choice of channels a thread (by C and alignment) and its
  block count;
* the apply's threads: each (row block, cross position) item, its ring
  slots (kept from step to step, every read checked against the row the
  slot holds), the compiled shapes' tap offsets at each sweep axis, the
  shared-memory row placement (each row at its source row's address
  modulo 16) within the bytes the wrapper passes, and the piecewise row
  copy;
* the apply's direct read of the caller's grid: windows laid over the
  grid at the tile's base less the halo, zeros outside it, outputs past
  it neither computed nor stored; the flat copy's units (a head piece,
  16-byte blocks, a tail piece), their zero fill and the launcher's
  choice of the flat copy at the planned tiles.
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import tiling  # noqa: E402
from repro_torch.core.cache_fitting import star_stencil  # noqa: E402
from repro_torch.kernels import conv1d, sweep  # noqa: E402
from repro_torch.kernels import stencil as st  # noqa: E402

CSRC = Path(sweep.__file__).resolve().parent.parent / "csrc"


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


CONV_SRC = (CSRC / "conv1d.cu").read_text()
APPLY_SRC = (CSRC / "sweep_apply.cu").read_text()
K_ROWS = _constant(APPLY_SRC, "kRows")
K_REACH = _constant(APPLY_SRC, "kReach")


def test_wrapper_constants_match_the_sources():
    assert _constant(CONV_SRC, "kThreads") == conv1d._THREADS
    assert _constant(CONV_SRC, "kRun") == conv1d._RUN
    assert _constant(APPLY_SRC, "kThreads") == sweep.APPLY_THREADS
    assert re.findall(r"__launch_bounds__\((\w+), 2\)", CONV_SRC) == [
        "kThreads"]


# -- the conv ----------------------------------------------------------------


def _conv_warps(b, s, c, tile_s, vec):
    """(batch row, first row, rows, first channel) of every lane that has
    work, in the kernel's order (conv1d_silu_kernel's item decode)."""
    run_rows = conv1d._RUN
    tile = min(tile_s, s)
    ntiles, runs = -(-s // tile), -(-tile // run_rows)
    nslabs = -(-(c // vec) // 32)
    for item in range(b * ntiles * runs * nslabs):
        slab, rest = item % nslabs, item // nslabs
        run, rest = rest % runs, rest // runs
        t, bb = rest % ntiles, rest // ntiles
        for lane in range(32):
            c0 = (slab * 32 + lane) * vec
            t0 = t * tile
            s0 = t0 + run * run_rows
            n = min(run_rows, t0 + tile - s0, s - s0)
            if c0 < c and n > 0:
                yield bb, s0, n, c0


def _conv_replay(x, w, bias, state, tile_s, vec):
    """The kernel's f32 pre-activation from its warps alone: each run
    starts from its own halo rows and walks its rows."""
    b, s, c = x.shape
    width = w.shape[0]
    xf = x.float().numpy()
    wf, bf = w.float().numpy(), bias.float().numpy()
    sf = None if state is None else state.float().numpy()
    acc = np.full((b, s, c), np.nan, np.float32)
    seen = np.zeros((b, s, c), np.int64)
    for bb, s0, n, c0 in _conv_warps(b, s, c, tile_s, vec):
        ch = slice(c0, c0 + vec)
        win = []
        for t in range(width - 1):
            r = s0 - (width - 1) + t
            if r >= 0:
                win.append(xf[bb, r, ch])
            elif sf is not None:
                win.append(sf[bb, width - 1 + r, ch])
            else:
                win.append(np.zeros(vec, np.float32))
        for i in range(n):
            win.append(xf[bb, s0 + i, ch])
            a = np.zeros(vec, np.float32)
            for t in range(width):
                a = a + win[t] * wf[t, ch]
            acc[bb, s0 + i, ch] = a + bf[ch]
            seen[bb, s0 + i, ch] += 1
            win.pop(0)
    return acc, seen


CONV_MAP_CASES = [
    # (batch, seq, channels, tile_s, vec): ragged runs and tiles, a tile
    # past S, S below the width, a run of one row, odd channels
    (2, 37, 24, 8, 4), (2, 75, 40, 45, 4), (1, 2, 16, 64, 2),
    (3, 1, 8, 4, 4), (2, 33, 25, 33, 1), (1, 70, 64, 256, 2),
]


@pytest.mark.parametrize("case", CONV_MAP_CASES)
def test_conv_warps_cover_every_output_once(case):
    b, s, c, tile_s, vec = case
    seen = np.zeros((b, s, c), np.int64)
    for bb, s0, n, c0 in _conv_warps(b, s, c, tile_s, vec):
        assert n <= conv1d._RUN and c0 % vec == 0
        # a run never crosses its tile's end
        tile = min(tile_s, s)
        assert s0 // tile == (s0 + n - 1) // tile
        seen[bb, s0:s0 + n, c0:c0 + vec] += 1
    assert (seen == 1).all()
    assert conv1d.grid_blocks(b, s, c, tile_s, vec) == -(
        -(b * -(-s // min(tile_s, s)) * -(-min(tile_s, s) // conv1d._RUN)
          * -(-(c // vec) // 32)) // (conv1d._THREADS // 32))


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("width", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CONV_MAP_CASES[:4])
def test_conv_replay_equals_plain(case, dtype, width, with_state):
    """The runs' halo rows (x, state or zeros) and f32 sums give the plain
    version's result bit for bit, silu applied to the whole sum alike."""
    b, s, c, tile_s, vec = case
    g = torch.Generator().manual_seed(sum(case) + width)
    x = torch.randn((b, s, c), generator=g).to(dtype)
    w = (torch.randn((width, c), generator=g) * 0.3).to(dtype)
    bias = (torch.randn((c,), generator=g) * 0.1).to(dtype)
    state = (torch.randn((b, width - 1, c), generator=g).to(dtype)
             if with_state else None)
    acc, seen = _conv_replay(x, w, bias, state, tile_s, vec)
    assert (seen == 1).all()
    got = conv1d._silu(torch.from_numpy(acc)).to(dtype)
    want = conv1d.causal_conv1d_plain(x, w, bias, state)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))


@pytest.mark.parametrize("dtype,c,offset,want", [
    (torch.bfloat16, 5376, 0, 4),   # the prefill conv: 8 bytes a thread
    (torch.bfloat16, 5372, 0, 4),   # C = 4 (mod 8)
    (torch.bfloat16, 5370, 0, 2),   # C = 2 (mod 8)
    (torch.bfloat16, 25, 0, 1),     # C odd
    (torch.bfloat16, 64, 1, 1),     # x one element off
    (torch.bfloat16, 64, 2, 2),     # x 4 bytes off
    (torch.bfloat16, 64, 4, 4),     # x 8 bytes off
    (torch.float32, 64, 0, 4),      # 16 bytes a thread
    (torch.float32, 6, 0, 2),
    (torch.float32, 64, 1, 1),
    (torch.float32, 64, 2, 2),
])
def test_conv_channels_a_thread_follow_c_and_alignment(dtype, c, offset,
                                                       want):
    b, s = 2, 3
    flat = torch.zeros(b * s * c + 16, dtype=dtype)
    base = (-flat.data_ptr() // flat.element_size()) % 8  # 16-byte start
    x = flat[base + offset:base + offset + b * s * c].view(b, s, c)
    out = torch.empty_like(x)
    assert conv1d._vec(c, x, out) == want
    state = torch.zeros((b, 3, c), dtype=dtype)
    assert conv1d._vec(c, x, out, state) == want
    # a misaligned state narrows the choice too
    sflat = torch.zeros(b * 3 * c + 16, dtype=dtype)
    sb = (-sflat.data_ptr() // sflat.element_size()) % 8 + 1
    st1 = sflat[sb:sb + b * 3 * c].view(b, 3, c)
    assert conv1d._vec(c, x, out, st1) == 1


# -- the apply -------------------------------------------------------------------


def _lift(d, vals, fill):
    return (fill,) * (3 - d) + tuple(int(v) for v in vals)


def _roles(d, sweep_axis):
    s = sweep_axis + 3 - d
    c0, c1 = [i for i in range(3) if i != s]
    return s, c0, c1


def _apply_replay(ins, offsets, weights, lo_w, hi_w, tile, sweep_axis,
                  pipelined, padded=True):
    """sweep_apply_kernel thread by thread: items of K_ROWS rows at one
    cross position, the step's first slot m0 kept from step to step, row
    offsets from the slot K_REACH rows up, and the window_step load order;
    every slot read is checked against the padded row it must hold.
    ``padded=False``: the inputs are the caller's grids, the window's
    element 0 at grid coordinate (tile base - lo), zeros outside the
    grid, and items and rows past the grid skipped."""
    x0_ = ins[0]
    d = x0_.ndim
    s, c0, c1 = _roles(d, sweep_axis)
    perm = (s, c0, c1)
    X = [a.float().numpy().reshape(_lift(d, a.shape, 1)).transpose(perm)
         for a in ins]
    tile3 = np.array(_lift(d, tile, 1))[list(perm)]
    lo3 = np.array(_lift(d, lo_w, 0))[list(perm)]
    hi3 = np.array(_lift(d, hi_w, 0))[list(perm)]
    win = tile3 + lo3 + hi3
    n_in = np.array(X[0].shape)
    org = np.zeros(3, np.int64) if padded else lo3
    out_shape = n_in - lo3 - hi3 if padded else n_in
    ntiles = -(-out_shape // tile3)
    t_s, h_s, nswp = int(tile3[0]), int(lo3[0] + hi3[0]), int(ntiles[0])
    pipe = bool(pipelined) and nswp > 1 and h_s > 0
    rows = int(win[0]) + (t_s if pipe else 0)
    t0, t1 = int(tile3[1]), int(tile3[2])
    taps = []
    for offs, wts in zip(offsets, weights):
        o = np.asarray(offs).reshape(-1, d)
        o3 = np.concatenate([np.zeros((len(o), 3 - d), np.int64), o], 1)
        taps.append([(tuple(int(v) for v in oo[list(perm)]), np.float32(w))
                     for oo, w in zip(o3, wts)])
    out = np.full(tuple(out_shape), np.nan, np.float32)
    span = K_ROWS + 2 * K_REACH
    nchunks = -(-t_s // K_ROWS)
    for tc0, tc1 in itertools.product(range(ntiles[1]), range(ntiles[2])):
        b0, b1 = tc0 * t0, tc1 * t1
        ring = [np.full((rows, win[1], win[2]), np.nan, np.float32)
                for _ in X]
        tag = np.full(rows, -1, np.int64)

        def load(g0, n):
            for g in range(g0, g0 + n):
                # load_rows_pitched: input coordinates, zeros outside
                i_s, i_0, i_1 = g - org[0], b0 - org[1], b1 - org[2]
                j0, k0 = max(0, -i_0), max(0, -i_1)
                j1 = min(win[1], n_in[1] - i_0)
                k1 = min(win[2], n_in[2] - i_1)
                for a in range(len(X)):
                    ring[a][g % rows] = 0
                    if 0 <= i_s < n_in[0] and j1 > j0 and k1 > k0:
                        ring[a][g % rows, j0:j1, k0:k1] = X[a][
                            i_s, i_0 + j0:i_0 + j1, i_1 + k0:i_1 + k1]
                tag[g % rows] = g

        m0 = int(lo3[0]) % rows
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
            g_step = k * t_s
            for u in range(nchunks * t0 * t1):
                c, rem = divmod(u, t0 * t1)
                x0, x1 = divmod(rem, t1)
                if b0 + x0 >= out_shape[1] or b1 + x1 >= out_shape[2]:
                    continue  # past the grid
                m = m0 + c * K_ROWS
                while m >= rows:
                    m -= rows
                slot = m - K_REACH
                while slot < 0:
                    slot += rows
                slots = []
                for _ in range(span):
                    slots.append(slot)
                    slot = 0 if slot + 1 == rows else slot + 1
                acc = np.zeros(K_ROWS, np.float32)
                for a, tl in enumerate(taps):
                    for (os_, o0, o1), w in tl:
                        for i in range(K_ROWS):
                            if abs(os_) <= K_REACH:
                                sl = slots[i + os_ + K_REACH]
                            else:
                                sl = (m + os_ + i) % rows
                            if c * K_ROWS + i >= t_s:
                                continue  # computed and dropped
                            want_row = g_step + c * K_ROWS + i + os_ + lo3[0]
                            assert tag[sl] == want_row, (k, u, i, os_)
                            v = ring[a][sl, x0 + lo3[1] + o0, x1 + lo3[2] + o1]
                            acc[i] = acc[i] + w * v
                for i in range(K_ROWS):
                    r = c * K_ROWS + i
                    if r < min(t_s, out_shape[0] - g_step):
                        assert np.isnan(out[g_step + r, b0 + x0, b1 + x1])
                        out[g_step + r, b0 + x0, b1 + x1] = acc[i]
            m0 = (m0 + t_s) % rows
    inv = np.argsort(perm)
    res = out.transpose(inv).reshape(tuple(
        n - l - h for n, l, h in zip(x0_.shape, lo_w, hi_w)) if padded
        else tuple(x0_.shape))
    return res


def _spec(o, w):
    return (tuple(map(tuple, np.asarray(o).tolist())),
            tuple(float(v) for v in w))


APPLY_MAP_CASES = [
    # shape, tile, sweep_axis: each sweep axis, t_s off the 4-row block,
    # t_s below it, 2-D and 1-D grids
    ((12, 13, 14), (4, 8, 8), 0),
    ((12, 13, 14), (5, 4, 8), 1),
    ((12, 13, 14), (8, 8, 3), 2),
    ((13, 13, 15), (2, 8, 8), 0),
    ((41, 53), (16, 16), 0),
    ((41, 53), (16, 6), 1),
    ((70,), (8,), 0),
    # thinner than the halo along the sweep axis, along c1
    ((3, 13, 14), (4, 8, 8), 0),
    ((12, 13, 3), (4, 8, 8), 1),
]


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "direct"])
@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("case", range(len(APPLY_MAP_CASES)))
def test_apply_thread_items_and_ring_slots_equal_plain(case, pipelined,
                                                       padded):
    shape, tile, sw = APPLY_MAP_CASES[case]
    d = len(shape)
    # a compiled shape, a star in reversed order (table-driven) and, in
    # 1-D, a reach beyond K_REACH
    specs = [_spec(star_stencil(d, 2), np.linspace(-0.4, 0.5, 4 * d + 1)),
             _spec(star_stencil(d, 1)[::-1],
                   np.linspace(0.3, -0.2, 2 * d + 1))]
    if d == 1:
        specs.append(_spec([[-3], [0], [3]], [0.25, -0.5, 0.125]))
    us = [torch.from_numpy(np.random.default_rng(case + i).standard_normal(
        shape).astype(np.float32)) for i in range(len(specs))]
    ins, o, ws, _, lo_w, hi_w = st._launch_inputs(us, tuple(specs), tile)
    want = sweep.sweep_apply_plain(ins, o, ws, lo_w, hi_w, tile, sw)
    if padded:
        got = _apply_replay(ins, o, ws, lo_w, hi_w, tile, sw, pipelined)
    else:
        got = _apply_replay(us, o, ws, lo_w, hi_w, tile, sw, pipelined,
                            padded=False)
        want = want[tuple(slice(0, n) for n in shape)]
        assert np.array_equal(got, sweep.sweep_apply_plain(
            us, o, ws, lo_w, hi_w, tile, sw, padded=False).numpy())
    assert np.array_equal(got, want.numpy())


def _shape_axis_off(shape, t, a):
    """csrc/sweep_apply.cu::shape_axis_off."""
    if shape == 3:
        return (t // 9 if a == 0 else (t // 3 % 3 if a == 1 else t % 3)) - 1
    reach = 1 if shape == 1 else 2
    if t == 0:
        return 0
    u = t - 1
    k = u % (2 * reach) // 2 + 1
    return (k if u % 2 else -k) if u // (2 * reach) == a else 0


def test_compiled_shapes_are_the_repos_operators():
    """The kernel's compiled tap tables are star_stencil(3, 1),
    star_stencil(3, 2) and the 27-point box in itertools.product order,
    so the launcher matches the operators the frontends build."""
    box = np.array(list(itertools.product((-1, 0, 1), repeat=3)))
    for shape, want in ((1, star_stencil(3, 1)), (2, star_stencil(3, 2)),
                        (3, box)):
        got = np.array([[_shape_axis_off(shape, t, a) for a in range(3)]
                        for t in range(len(want))])
        assert np.array_equal(got, want), shape


def _layout(tile, sweep_axis, es, halo, strides, pipelined, row_pad=0):
    """sweep_apply_launch's shared-memory layout: (pitch, plane bytes,
    ring bytes), and whether copy16 holds apart from the base address."""
    d = len(tile)
    s, c0, c1 = _roles(d, sweep_axis)
    tile3 = _lift(d, tile, 1)
    lo3 = _lift(d, [h[0] for h in halo], 0)
    hi3 = _lift(d, [h[1] for h in halo], 0)
    st3 = _lift(d, strides, 0)
    win = [t + lo + hi for t, lo, hi in zip(tile3, lo3, hi3)]
    pitch = win[c1] + row_pad
    if st3[c1] == 1:
        while (pitch - st3[c0]) * es % 16:
            pitch += 1
    plane = -(-win[c0] * pitch * es // 16) * 16
    rows = win[s] + (tile3[s] if pipelined else 0)
    ring = -(-(rows * plane + 16) // 16) * 16
    copy16 = (st3[c1] == 1 and st3[s] * es % 16 == 0
              and st3[c0] * es % 16 == 0 and tile3[c1] * es % 16 == 0
              and win[c1] * es % 16 == 0)
    return pitch, plane, ring, copy16, (s, c0, c1), tile3, win, st3


PLACE_CASES = [
    # padded shape, tile, sweep, dtype bytes, halo
    ((260, 260, 260), (8, 16, 32), 0, 2, [(2, 2)] * 3),  # the bf16 smoke
    ((516, 516, 516), (8, 16, 32), 0, 4, [(2, 2)] * 3),  # the f32 smoke
    ((516, 516, 516), (16, 8, 32), 1, 4, [(2, 2)] * 3),
    ((36, 44, 74), (4, 16, 32), 0, 2, [(2, 2)] * 3),
    ((17, 19, 23), (4, 5, 7), 1, 2, [(1, 2), (2, 1), (1, 1)]),
    ((17, 19, 23), (4, 5, 7), 2, 4, [(1, 2), (2, 1), (1, 1)]),
    ((45, 55), (16, 6), 0, 2, [(2, 2), (2, 2)]),
]


@pytest.mark.parametrize("case,base", [
    (c, b) for c in range(len(PLACE_CASES)) for b in (0, 2, 4, 6, 8, 14)
    if b % PLACE_CASES[c][3] == 0])
def test_apply_rows_sit_at_their_source_alignment(case, base):
    """Each shared row starts at its source row's address modulo 16 where
    c1 is the minor axis and the sweep stride is a 16-byte multiple, every
    row ends inside its ring, and the rings' bytes are what the wrapper
    passes (core/tiling.apply_smem_bytes)."""
    shape, tile, sw, es, halo = PLACE_CASES[case]
    strides = [int(np.prod(shape[i + 1:])) for i in range(len(shape))]
    pitch, plane, ring, copy16, (s, c0, c1), tile3, win, st3 = _layout(
        tile, sw, es, halo, strides, True)
    assert ring * 2 == tiling.apply_smem_bytes(tile, sw, es, halo, strides,
                                               n_inputs=2, pipelined=True)
    copy16 = copy16 and base % 16 == 0
    shape3 = _lift(len(shape), shape, 1)
    ntiles = [(n - (w - t)) // t for n, w, t in zip(shape3, win, tile3)]
    rows = ring and (ring - 16) // plane
    for tc0, tc1 in itertools.product(range(ntiles[c0]), range(ntiles[c1])):
        first = tc0 * tile3[c0] * st3[c0] + tc1 * tile3[c1] * st3[c1]
        shift = 0 if copy16 else (base + first * es) % 16
        for g, x0 in itertools.product(range(rows + 3), range(win[c0])):
            src = base + (first + g * st3[s] + x0 * st3[c0]) * es
            dst = shift + (g % rows) * plane + x0 * pitch * es
            if st3[c1] == 1 and st3[s] * es % 16 == 0:
                assert (src - dst) % 16 == 0, (tc0, tc1, g, x0)
            assert dst + win[c1] * es <= ring


def _pieces(sa, da, n_el, es):
    """copy_run_pieces: (byte offset, size) of every unit, in lane order."""
    diff = sa ^ da
    g = 16 if diff % 16 == 0 else 8 if diff % 8 == 0 else (
        4 if diff % 4 == 0 else 2)
    nbytes = n_el * es
    head = (g - sa % g) % g
    if g <= es or nbytes < head + 2 * g:
        return [(e * es, es) for e in range(n_el)]
    nblk = (nbytes - head) // g
    tail = nbytes - head - nblk * g
    units = []
    h = head
    while h:
        size = h & -h
        units.append((head & (size - 1), size))
        h &= h - 1
    units += [(head + i * g, g) for i in range(nblk)]
    t = tail
    while t:
        size = 1 << (t.bit_length() - 1)
        units.append((head + nblk * g + (tail & ~((size << 1) - 1)), size))
        t &= ~size
    return units


@pytest.mark.parametrize("es", [2, 4])
def test_row_copy_pieces_cover_the_run_aligned(es):
    """Every byte of a run is copied once, and each piece is aligned to
    its size at both ends (cp.async needs it); 2-byte pieces only for
    bf16, granules of 16 bytes wherever the two alignments agree."""
    for sa, da, n in itertools.product(range(0, 32, es), range(0, 32, es),
                                       [1, 3, 5, 8, 9, 13, 36, 37, 68]):
        units = _pieces(sa, da, n, es)
        cover = np.zeros(n * es, np.int64)
        for at, size in units:
            assert size in (2, 4, 8, 16) and size >= es
            assert (sa + at) % size == 0 and (da + at) % size == 0
            cover[at:at + size] += 1
        assert (cover == 1).all()
        if (sa - da) % 16 == 0 and n * es >= 48:
            assert sum(size == 16 for _, size in units) >= n * es // 16 - 1


def _flat_copy(shape, tile, sweep_axis, es, halo, padded, base=0):
    """sweep_apply.cu::rows_copy16 for contiguous inputs of ``shape``
    starting at address ``base``: (head, tail) bytes where every window
    row copies by the flat index, else None."""
    d = len(shape)
    s, c0, c1 = _roles(d, sweep_axis)
    st3 = _lift(d, [int(np.prod(shape[i + 1:])) for i in range(d)], 0)
    tile3 = _lift(d, tile, 1)
    lo3 = _lift(d, [h[0] for h in halo], 0)
    hi3 = _lift(d, [h[1] for h in halo], 0)
    w1 = tile3[c1] + lo3[c1] + hi3[c1]
    head = (0 if padded else lo3[c1]) * es % 16
    tail = (w1 * es - head) % 16
    ok = (st3[c1] == 1 and st3[s] * es % 16 == 0 and st3[c0] * es % 16 == 0
          and tile3[c1] * es % 16 == 0 and head in (0, 4, 8)
          and tail in (0, 4, 8) and w1 * es >= head + tail
          and base % 16 == 0)
    return (head, tail) if ok else None


def _flat_units(head, tail, w1, es, span):
    """load_rows_pitched's flat copy of one window row: (byte from the
    window row's first element, size) of each cp.async — with ``span``
    every 16-byte block the row touches, else its whole blocks, then its
    end pieces."""
    pre, post = (16 - head) % 16, (16 - tail) % 16
    if span:
        return [(-pre + 16 * b, 16)
                for b in range((pre + w1 * es + post) // 16)]
    nb = (w1 * es - head - tail) // 16
    units = [(head + 16 * b, 16) for b in range(nb)]
    if head:
        units.append((0, head))
    if tail:
        units.append((head + 16 * nb, tail))
    return units


# grid, tile, sweep, dtype bytes, halo: the benchmark's planned tiles (the
# 13-point star at 512^3 and 128^3, the 27-point box at 512^3), bf16, and
# ragged grids whose last tile column reaches past the grid
FLAT_CASES = [
    ((512, 512, 512), (8, 32, 32), 0, 4, [(2, 2)] * 3),
    ((128, 128, 128), (128, 2, 32), 0, 4, [(2, 2)] * 3),
    ((512, 512, 512), (8, 32, 32), 0, 4, [(1, 1)] * 3),
    ((256, 256, 256), (8, 16, 32), 0, 2, [(2, 2)] * 3),
    ((130, 66, 516), (8, 16, 32), 0, 4, [(2, 2)] * 3),
    ((40, 36, 44), (4, 8, 32), 1, 4, [(2, 2)] * 3),
    ((40, 48, 40), (4, 8, 32), 1, 2, [(2, 2)] * 3),
]


@pytest.mark.parametrize("span", [False, True], ids=["pieces", "span"])
@pytest.mark.parametrize("case", range(len(FLAT_CASES)))
def test_flat_copy_units_zero_fill_the_window_outside_the_grid(case, span):
    """The flat copy on the caller's grid, byte for byte: each copy is one
    cp.async (4, 8 or 16 bytes) aligned to its size at its source and in
    shared memory, reads only bytes inside the grid (a copy outside it
    reads nothing from the grid's base), writes only inside its shared
    row (whose pitch has the room for the blocks around the end pieces
    where ``span``: ``sweep._row_pad``), and leaves the zero-padded
    grid's window row in place, for every tile column of the grid."""
    shape, tile, sw, es, halo = FLAT_CASES[case]
    flat = _flat_copy(shape, tile, sw, es, halo, padded=False)
    assert flat is not None
    head, tail = flat
    d = len(shape)
    s, c0, c1 = _roles(d, sw)
    strides = [int(np.prod(shape[i + 1:])) for i in range(d)]
    lo_w, hi_w = [h[0] for h in halo], [h[1] for h in halo]
    row_pad = sweep._row_pad(torch.empty(shape, dtype={
        2: torch.bfloat16, 4: torch.float32}[es]), lo_w, hi_w, tile, sw)
    assert row_pad * es == (16 - head) % 16 + (16 - tail) % 16
    if not span:
        row_pad = 0
    pipe = _lift(d, shape, 1)[s] > _lift(d, tile, 1)[s]
    pitch, plane, ring, _, _, tile3, win, st3 = _layout(
        tile, sw, es, halo, strides, pipe, row_pad)
    shape3 = _lift(d, shape, 1)
    lo3 = _lift(d, lo_w, 0)
    n1 = shape3[c1]
    units = _flat_units(head, tail, win[c1], es, span)
    shift = -lo3[c1] * es % 16  # ring_of: the window's alignment
    row = np.arange(n1 * es, dtype=np.int64) + 1  # an input row's bytes
    for tc1 in range(-(-n1 // tile3[c1])):
        i_1 = tc1 * tile3[c1] - lo3[c1]   # the window row's first column
        assert i_1 * es % 16 == shift
        got = np.full(pitch * es, -1, np.int64)  # the shared row's bytes
        lead = shift if span else 0  # the window's first byte
        for at, size in units:
            b = i_1 * es + at
            valid = max(0, min(size, n1 * es - b)) if b >= 0 else 0
            assert size in (4, 8, 16) and 0 <= valid <= size
            assert (shift + at) % size == 0 and b % size == 0
            assert 0 <= lead + at and lead + at + size <= pitch * es
            got[lead + at:lead + at + size] = 0
            if valid:
                assert 0 <= b and b + valid <= n1 * es
                got[lead + at:lead + at + valid] = row[b:b + valid]
        want = np.zeros(win[c1] * es, np.int64)
        lo_b, hi_b = max(0, i_1 * es), min(n1 * es, (i_1 + win[c1]) * es)
        want[lo_b - i_1 * es:hi_b - i_1 * es] = row[lo_b:hi_b]
        assert np.array_equal(got[lead:lead + win[c1] * es], want), tc1
    # A slot's last row ends inside the slot's plane past the shift, so
    # each ring's rows end inside the bytes the wrapper passes.
    assert shift + (win[c0] - 1) * pitch * es + win[c1] * es <= plane + 16
    assert ring == tiling.apply_smem_bytes(tile, sw, es, halo, strides,
                                           pipelined=pipe, row_pad=row_pad)


def test_flat_copy_at_the_planned_tiles():
    """The launcher's choice on the caller's grid: the planned f32 tiles
    of the benchmark's grids keep the flat copy (an 8- or 4-byte piece at
    each end of a row, 16-byte blocks between); a grid whose rows are
    not 16-byte multiples, or a base off a 16-byte boundary, does not."""
    star, box = [(2, 2)] * 3, [(1, 1)] * 3
    assert _flat_copy((512,) * 3, (8, 32, 32), 0, 4, star, False) == (8, 8)
    assert _flat_copy((128,) * 3, (128, 2, 32), 0, 4, star, False) == (8, 8)
    assert _flat_copy((512,) * 3, (8, 32, 32), 0, 4, box, False) == (4, 4)
    assert _flat_copy((516,) * 3, (8, 32, 32), 0, 4, star, True) == (0, 0)
    assert _flat_copy((37, 41, 45), (8, 16, 32), 0, 4, star, False) is None
    assert _flat_copy((512,) * 3, (8, 32, 32), 0, 4, star, False,
                      base=4) is None


def test_apply_plan_key_covers_what_the_arrays_hold():
    """The apply wrapper keeps its launch arrays per key: launches that
    differ in a weight (as f32), an offset, the tile, the sweep axis, the
    buffers' strides or their count get different keys, and one weight
    given as a Python float or a numpy scalar gets one."""
    shape, tile = (12, 13, 14), (4, 8, 8)
    o13 = star_stencil(3, 2)
    w13 = np.linspace(-0.4, 0.5, 13)
    _, ins, o, ws, _, lo_w, hi_w = (None,) + st._launch_inputs(
        [torch.zeros(shape)], (_spec(o13, w13),), tile)

    def key(**kw):
        a = dict(ins=ins, offsets=o, weights=ws, lo_w=lo_w, hi_w=hi_w,
                 tile=tile, sweep=0, pipelined=True)
        a.update(kw)
        return sweep._apply_key(**a)

    base = key()
    hash(base)
    w2 = [list(ws[0])]
    w2[0][3] = float(np.nextafter(np.float32(w2[0][3]), np.float32(1)))
    assert key(weights=w2) != base
    assert key(weights=[[np.float32(v) for v in ws[0]]]) == base
    o2 = [np.asarray(o[0]).copy()]
    o2[0][1] = (0, 0, 0)
    assert key(offsets=o2) != base
    assert key(tile=(4, 4, 8)) != base
    assert key(sweep=1) != base
    assert key(pipelined=False) != base
    assert key(ins=ins * 2, offsets=o * 2, weights=ws * 2) != base
    assert key(ins=[ins[0].transpose(0, 1).contiguous()
                    .transpose(0, 1)]) != base
    assert key(padded=False) != base
