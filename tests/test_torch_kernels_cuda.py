"""The port's two CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (a CUDA kernel has no CPU mode; its plain version is tested on the
CPU in ``tests/test_torch_kernels_plain.py``).  The module imports only
torch, numpy and the port, so it runs on a machine without jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Kernel and plain version must agree bit for bit: both apply the taps in
``zip(offsets, weights)`` order as separate f32 multiplies and adds (the
kernels are built with ``--fmad=false``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.cache_fitting import star_stencil  # noqa: E402
from repro_torch.kernels import sweep  # noqa: E402
from repro_torch.kernels import stencil as st  # noqa: E402

pytestmark = pytest.mark.cuda

CASES = [
    # shape, tile, sweep_axis
    ((12, 13, 14), (4, 8, 8), 0),
    ((12, 13, 14), (4, 4, 8), 1),
    ((12, 13, 14), (8, 8, 4), 2),
    ((33, 40, 70), (4, 16, 32), 0),
    ((41, 53), (16, 16), 0),
    ((70,), (8,), 0),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _spec(o, w):
    return (tuple(map(tuple, np.asarray(o).tolist())),
            tuple(float(v) for v in w))


def _launch(shape, tile, offsets_w, stages_w=None, n=1, dtype=torch.float32,
            device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    us = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
          .to(device, dtype) for _ in range(n)]
    return (us, *st._launch_inputs(us, offsets_w, tile, stages_w))


def _same_bits(a, b):
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.shape == b.shape and torch.equal(a.view(view), b.view(view))


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
    before = sweep.sweep_apply.launches
    k = sweep.sweep_apply(ins, o, ws, lo_w, hi_w, tile, sw, pipelined)
    assert sweep.sweep_apply.launches == before + 1
    p = sweep.sweep_apply_plain(ins, o, ws, lo_w, hi_w, tile, sw)
    torch.cuda.synchronize()
    assert _same_bits(k, p)


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
    before = sweep.sweep_chain.launches
    k = sweep.sweep_chain(ins[0], stages, lo_w, hi_w, tile, sw, pipelined,
                          window_kind, shape)
    assert sweep.sweep_chain.launches == before + 1
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
