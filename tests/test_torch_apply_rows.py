"""The apply launcher's row path, as the port counts it.

``csrc/sweep_apply.cu``'s ``sweep_apply_launch`` returns, for a launch it
enqueued, the row path it set up: ``kRowsCopy16`` where every window row
copies by the flat index of 16-byte blocks (its ``copy16``), plus
``kRowsSpan`` where those rows were also widened to copy the blocks
around their end pieces (its ``span``, ``sweep._row_pad``).
``sweep.sweep_apply`` counts that return in ``repro_torch.obs.totals()``
as ``apply_rows.copy16`` and ``apply_rows.span``.  The CPU tests hold the
codes to the source and the plain path to counting neither; the test
marked ``cuda`` holds the counts to ``sweep.apply_copy16`` and the
launch plan's ``row_pad`` on the card and skips without one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_apply_rows.py
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core.cache_fitting import star_stencil  # noqa: E402
from repro_torch.kernels import stencil as st  # noqa: E402
from repro_torch.kernels import sweep  # noqa: E402

CU = Path(sweep.__file__).resolve().parent.parent / "csrc" / "sweep_apply.cu"
ROWS = ("launches.sweep_apply", "apply_rows.copy16", "apply_rows.span")
BOX27 = np.array(list(itertools.product((-1, 0, 1), repeat=3)))


def _rows_delta(before, after):
    return {k: after[k] - before[k] for k in ROWS}


@pytest.mark.parametrize("name,value", [
    ("kRowsCopy16", sweep._ROWS_COPY16),
    ("kRowsSpan", sweep._ROWS_SPAN),
    ("kRowsPair", sweep._ROWS_PAIR),
    ("kCudaErrorBase", sweep._CUDA_ERROR_BASE),
])
def test_the_launchers_codes_are_the_wrappers(name, value):
    found = re.findall(rf"constexpr int {name} = (\d+);", CU.read_text())
    assert found == [str(value)]


@pytest.mark.parametrize("rc,message", [
    (-1, "shared-memory layout"),
    (-2, "fixed tables"),
    (-3, "__launch_bounds__"),
    (-sweep._CUDA_ERROR_BASE - 2, "cudaError 2$"),
    (-sweep._CUDA_ERROR_BASE - 700, "cudaError 700$"),
    (700, "cudaError 700$"),  # the chain's launcher returns the error as is
])
def test_error_codes_raise_with_the_cuda_error(rc, message):
    with pytest.raises(RuntimeError, match=message):
        sweep._raise_rc("sweep_apply", rc)


def test_success_raises_nothing():
    assert sweep._raise_rc("sweep_chain", 0) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_plain_path_counts_no_row_path(dtype):
    """On the CPU ``sweep_apply`` runs its plain version: no launch, so
    neither row path is counted."""
    x = torch.rand((16, 18, 20)).to(dtype)
    o = star_stencil(3, 2)
    before = obs.totals()
    st.stencil_pallas(x, o, np.full(len(o), 1 / 13), device="cpu")
    st.stencil_pallas(x, o, np.full(len(o), 1 / 13), tile=(8, 8, 16),
                      device="cpu")
    assert _rows_delta(before, obs.totals()) == dict.fromkeys(ROWS, 0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# dtype, operator, shape, tile, elements the grid starts into its
# allocation, and (copy16, span) where the path is known (the f32 star:
# widened rows at 512^3, end pieces apart at 128^3 at (128, 2, 32), as
# test_torch_kernels_cuda.py's planned-tile test holds the plans; off a
# 16-byte boundary no flat copy); ``None``: held to ``apply_copy16`` and
# the plan alone
ROW_CASES = [
    (torch.float32, "star13", (512,) * 3, (8, 32, 32), 0, (1, 1)),
    (torch.float32, "box27", (512,) * 3, (8, 32, 32), 0, (1, 1)),
    (torch.bfloat16, "star13", (512,) * 3, (8, 32, 32), 0, None),
    (torch.bfloat16, "box27", (512,) * 3, (8, 32, 32), 0, None),
    (torch.float32, "star13", (128,) * 3, (128, 2, 32), 0, (1, 0)),
    (torch.float32, "box27", (128,) * 3, (128, 2, 32), 0, None),
    (torch.bfloat16, "star13", (128,) * 3, (128, 2, 32), 0, None),
    (torch.float32, "star13", (512,) * 3, (8, 32, 32), 1, (0, 0)),
    (torch.bfloat16, "star13", (128,) * 3, (128, 2, 32), 1, (0, 0)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ops,shape,tile,offset,known", ROW_CASES)
def test_row_path_counts_are_the_launchers(dev, dtype, ops, shape, tile,
                                           offset, known):
    """One launch on the caller's grid counts ``apply_rows.copy16`` where
    ``sweep.apply_copy16`` says its rows take the flat copy, and
    ``apply_rows.span`` where they do and its plan widened them
    (``row_pad > 0``): once each at most."""
    offs = star_stencil(3, 2) if ops == "star13" else BOX27
    specs = ((tuple(map(tuple, offs.tolist())),
              tuple(np.linspace(-0.3, 0.45, len(offs)).tolist())),)
    oo, ws, _, lo_w, hi_w = st._launch_geometry(specs, None, tile)
    n = int(np.prod(shape))
    x = torch.rand(n + offset, device=dev).to(dtype)[offset:].view(shape)
    args = ([x], oo, ws, lo_w, hi_w, tile, 0)
    copy16 = sweep.apply_copy16(*args, padded=False)
    row_pad = sweep._apply_plan(*args, True, padded=False)["geom"][32]
    before = obs.totals()
    sweep.sweep_apply(*args, padded=False)
    torch.cuda.synchronize()
    got = _rows_delta(before, obs.totals())
    want = (int(copy16), int(copy16 and row_pad > 0))
    assert got == dict(zip(ROWS, (1, *want)))
    if known is not None:
        assert want == known
