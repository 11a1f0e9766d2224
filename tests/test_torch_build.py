"""The kernel build cache of the PyTorch port (``repro_torch.kernels._build``).

No compiler is run: these check the library key (source, shared headers
and flags) and what a cached library reports, on a scratch ``csrc/`` and
``build/``.
"""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


@pytest.fixture
def scratch(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "PTXAS", {})
    monkeypatch.setattr(_build, "BUILD_SECONDS", {})
    return csrc


def test_library_key_covers_source_and_shared_headers(scratch):
    first = _build._target("k")
    assert first == _build._target("k")
    (scratch / "common.cuh").write_text("// v2\n")
    second = _build._target("k")
    assert second != first
    (scratch / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _build._target("k") not in (first, second)


def test_cached_library_reports_its_ptxas_lines(scratch, monkeypatch):
    def no_nvcc():
        raise AssertionError("a cached library must not be rebuilt")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    target = _build._target("k")
    target.parent.mkdir(parents=True)
    target.write_bytes(b"")
    lines = ["ptxas info    : Used 32 registers, 0 bytes spill stores"]
    target.with_suffix(".ptxas").write_text("\n".join(lines) + "\n")
    assert _build.build_all(["k"]) == {"k": target}
    assert _build.PTXAS == {"k": lines}
    assert _build.BUILD_SECONDS == {}


def test_missing_nvcc_raises_before_building(scratch, tmp_path, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(["k"])
    assert not _build._target("k").exists()
