"""Rules the PyTorch port keeps.

* Nothing under ``src/repro_torch/``, and not ``chip_smoke.py``, imports
  ``jax`` or the JAX package ``repro`` (``repro_torch`` is the port).
* An entry point called without ``device="cpu"`` on a machine without
  CUDA raises; it never runs on the CPU quietly.
* ``python3 chip_smoke.py`` runs from the repository root with no
  ``PYTHONPATH``; without CUDA it exits non-zero with its no-CUDA message
  and prints no result.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [
        m for m in _imported_modules(path)
        if m.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_sees_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "src/repro_torch/kernels/stencil.py" in names
    assert "chip_smoke.py" in names
    assert "src/repro_torch/kernels/conv1d.py" in names
    assert "src/repro_torch/models/ssm.py" in names
    for module in ("obs/__init__.py", "obs/recorder.py", "obs/report.py",
                   "obs/trace_event.py", "runtime/__init__.py",
                   "runtime/timing.py", "plan/tune.py", "plan/tunedb.py",
                   "launch/mesh.py", "parallel/shard_columns.py",
                   "launch/train.py", "data/pipeline.py",
                   "optim/optimizer.py", "optim/compression.py",
                   "checkpoint/checkpointer.py",
                   "runtime/fault_tolerance.py", "configs/zamba2_2p7b.py",
                   "models/transformer.py", "models/encdec.py",
                   "configs/granite_3_2b.py", "configs/whisper_large_v3.py",
                   "configs/mixtral_8x22b.py", "configs/arctic_480b.py",
                   "examples/quickstart.py", "examples/stencil_pipeline.py",
                   "examples/rk2_damped_jacobi.py",
                   "examples/multigrid_vcycle.py"):
        assert f"src/repro_torch/{module}" in names, module
    assert len(list((ROOT / "src" / "repro_torch" / "csrc").glob("*.cu"))) == 3


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is the card")


@pytest.mark.parametrize("entry", [
    "stencil_pallas", "stencil_iterate", "multi_stencil_pallas",
    "run_program", "from_reference", "causal_conv1d", "model_init",
    "model_init_cache", "model_prefill", "model_decode_step", "serve",
    "params_from_reference", "model_loss", "train_main",
    "opt_state_from_reference", "hybrid_model_init", "hybrid_prefill",
    "get_model", "lm_prefill", "lm_serve", "encdec_prefill", "encdec_serve",
    "serve_main",
])
def test_entry_points_default_to_the_card(entry):
    _no_cuda()
    from repro_torch import convert, ir
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.cache_fitting import star_stencil
    from repro_torch.kernels import stencil as st
    from repro_torch.kernels.conv1d import causal_conv1d
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import get_model

    x = np.zeros((12, 13, 14), np.float32)
    offs, w = star_stencil(3, 1), [0.5] * 7
    kw = dict(tile=(4, 8, 8), sweep_axis=0)
    calls = {
        "stencil_pallas": lambda: st.stencil_pallas(x, offs, w, **kw),
        "stencil_iterate": lambda: st.stencil_iterate(x, offs, w, 2, **kw),
        "multi_stencil_pallas": lambda: st.multi_stencil_pallas(
            [x, x], [offs, offs], [w, w], **kw),
        "run_program": lambda: ir.run_program(
            ir.stencil_program(offs, w, time_steps=2), x, **kw),
        "from_reference": lambda: convert.from_reference(
            ir.stencil_program(offs, w).serialize(), {"u": x}),
    }
    # The Mamba2 serving path: parameters and a cache made on the CPU, then
    # each entry point called without device="cpu".
    cfg = get_smoke_config("mamba2-2.7b")
    on_cpu = get_model(cfg, device="cpu")
    params = on_cpu.init(0)
    cache = on_cpu.init_cache(1, 8)
    toks = np.zeros((1, 4), np.int64)
    conv_x = np.zeros((1, 6, 8), np.float32)
    calls.update({
        "causal_conv1d": lambda: causal_conv1d(
            conv_x, np.ones((4, 8), np.float32), np.zeros(8, np.float32),
            tile_s=4),
        "model_init": lambda: get_model(cfg).init(0),
        "model_init_cache": lambda: get_model(cfg).init_cache(1, 8),
        "model_prefill": lambda: get_model(cfg).prefill(
            params, {"tokens": toks}, cache),
        "model_decode_step": lambda: get_model(cfg).decode_step(
            params, cache, toks[:, :1], 4),
        "serve": lambda: serve(cfg, params, toks, 2),
        "params_from_reference": lambda: convert.params_from_reference(
            {}, cfg),
        "model_loss": lambda: get_model(cfg).loss(params, {
            "tokens": toks, "targets": toks,
            "mask": np.ones(toks.shape, np.float32)}),
        "train_main": lambda: train_main(["--smoke", "--steps", "1"]),
        "opt_state_from_reference": lambda: convert.opt_state_from_reference(
            {}, cfg),
    })
    # The Zamba2 hybrid, likewise.
    hyb = get_smoke_config("zamba2-2.7b")
    h_cpu = get_model(hyb, device="cpu")
    h_params, h_cache = h_cpu.init(0), h_cpu.init_cache(1, 8)
    calls.update({
        "hybrid_model_init": lambda: get_model(hyb).init(0),
        "hybrid_prefill": lambda: get_model(hyb).prefill(
            h_params, {"tokens": toks}, h_cache),
    })
    # The transformer families, likewise (get_model itself raises).
    lm, ed = get_smoke_config("granite-3-2b"), get_smoke_config(
        "whisper-large-v3")
    lm_cpu, ed_cpu = get_model(lm, device="cpu"), get_model(ed, device="cpu")
    lm_params, ed_params = lm_cpu.init(0), ed_cpu.init(0)
    frames = np.zeros((1, ed.frontend_len, ed.d_model), np.float32)
    calls.update({
        "get_model": lambda: get_model(lm),
        "lm_prefill": lambda: get_model(lm).prefill(
            lm_params, {"tokens": toks}, lm_cpu.init_cache(1, 8)),
        "lm_serve": lambda: serve(lm, lm_params, toks, 2),
        "encdec_prefill": lambda: get_model(ed).prefill(
            ed_params, {"tokens": toks, "frames": frames},
            ed_cpu.init_cache(1, 8)),
        "encdec_serve": lambda: serve(ed, ed_params, toks, 2, frames=frames),
        "serve_main": lambda: serve_main(["--smoke", "--arch",
                                          "mixtral-8x22b"]),
    })
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_explicit_cuda_without_cuda_raises():
    _no_cuda()
    from repro_torch import resolve_device

    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_runs_without_pythonpath_and_refuses_without_cuda():
    _no_cuda()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "ModuleNotFoundError" not in proc.stderr
    assert '"ok"' not in proc.stdout
