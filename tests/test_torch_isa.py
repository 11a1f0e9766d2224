"""The port's precision pins (``repro_torch.runtime.isa``) and their
anti-drift gate, as ``tests/test_isa_pin.py`` gates the reference's.

TF32 was turned off by two lines inside ``chip_smoke.py``; it now has
one home, ``runtime.isa.pin_precision``, which the entry points and the
smoke call.  These tests fail if a consumer stops calling it or grows an
inline copy back, and if the kernels' build stops taking
``--fmad=false`` from ``runtime.isa.NVCC_FLAGS``."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.runtime import isa  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
CONSUMERS = [
    REPO / "chip_smoke.py",
    PORT / "launch" / "train.py",
    PORT / "launch" / "serve.py",
    REPO / "scripts" / "lm_phases.py",
]
INLINE = ("allow_tf32", "set_float32_matmul_precision", "--fmad")


def test_every_consumer_calls_the_pin():
    for path in CONSUMERS:
        text = path.read_text()
        assert "pin_precision()" in text, f"{path.name} does not pin"
        assert "runtime.isa" in text or "runtime import isa" in text, path


@pytest.mark.parametrize("path", [
    *CONSUMERS,
    *sorted((PORT / "launch").glob("*.py")),
    *sorted((REPO / "scripts").glob("*.py")),
    PORT / "kernels" / "_build.py",
], ids=lambda p: str(p.relative_to(REPO)))
def test_no_inline_pin_outside_the_helper(path):
    text = path.read_text()
    for pin in INLINE:
        assert pin not in text, (
            f"{path.name} spells out {pin!r}; use repro_torch.runtime.isa")
    helper = (PORT / "runtime" / "isa.py").read_text()
    assert all(pin in helper for pin in INLINE)


def test_build_takes_its_flags_from_the_helper():
    assert _build.NVCC_FLAGS is isa.NVCC_FLAGS
    assert isa.FMAD_FLAG == "--fmad=false"
    assert isa.FMAD_FLAG in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_pin_precision_turns_tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        isa.pin_precision()
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def test_entry_points_pin_before_they_run(monkeypatch):
    """``launch.train.main`` and ``launch.serve.main`` call the pin (a
    caller's ``"high"`` precision does not survive into the run)."""
    from repro_torch.launch import serve, train

    calls = []
    monkeypatch.setattr(train, "pin_precision", lambda: calls.append("t"))
    monkeypatch.setattr(serve, "pin_precision", lambda: calls.append("s"))
    train.main(["--smoke", "--device", "cpu", "--steps", "1", "--batch",
                "1", "--seq", "8"])
    serve.main(["--smoke", "--device", "cpu", "--batch", "1",
                "--prompt-len", "4", "--gen", "2"])
    assert calls == ["t", "s"]


def _cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.runtime.isa", *args],
        capture_output=True, text=True, env=env, cwd=REPO, check=True,
        timeout=120,
    ).stdout.strip()


def test_export_emits_evalable_shell(capsys):
    assert isa.main(["--export"]) == 0
    assert capsys.readouterr().out.strip() == "export NVIDIA_TF32_OVERRIDE=0"
    out = _cli("--export")
    shown = subprocess.run(
        ["/bin/sh", "-c", f'{out}; printf %s "$NVIDIA_TF32_OVERRIDE"'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    assert shown == "0"
    assert _cli() == "NVIDIA_TF32_OVERRIDE=0"
