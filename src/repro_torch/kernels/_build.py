"""Build and load the port's CUDA kernels.

Each ``.cu`` file under ``repro_torch/csrc/`` is compiled by ``nvcc`` into
a shared library with a plain C interface and loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds.  The ``.cuh`` headers beside
them hold device helpers the kernels share.  Libraries go to ``build/`` at
the root of the checkout (listed in ``.gitignore``), named by a hash of
the source, the headers and the flags, so an edited source is rebuilt at
its first use and an unchanged one is loaded as it is.  All sources
compile in parallel, one ``nvcc`` each.  ``ptxas -v`` lines (registers,
spills, shared memory) are saved beside each library and kept in
:data:`PTXAS` for ``chip_smoke.py`` to print, whether the library was
built in this process or found in ``build/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..runtime.isa import NVCC_FLAGS  # the flags' home

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "PTXAS", "build_all", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

PTXAS: dict[str, list[str]] = {}
BUILD_SECONDS: dict[str, float] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME or "
        "/usr/local/cuda): the port's kernels are built from "
        f"{CSRC} with nvcc for sm_90a"
    )


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _ptxas_lines(text: str) -> list[str]:
    """The lines of ``ptxas -v`` that name a function or give its
    registers, spills or shared memory."""
    keep = ("registers", "spill", "smem", "Compiling entry function",
            "Function properties")
    return [
        ln.strip() for ln in text.splitlines() if any(k in ln for k in keep)
    ]


def build_all(names=None) -> dict[str, Path]:
    """Compile every listed kernel source (default: all of ``csrc/*.cu``)
    whose library is missing, one ``nvcc`` per source, all at once.
    Raises ``RuntimeError`` with nvcc's output when one fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    for n, t in targets.items():
        log = t.with_suffix(".ptxas")
        if n not in todo and log.exists():
            PTXAS[n] = log.read_text().splitlines()
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for n, t in todo.items():
            tmp = t.with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                ),
                tmp,
            )
        errors = []
        for n, (proc, tmp) in procs.items():
            out, err = proc.communicate()
            BUILD_SECONDS[n] = time.perf_counter() - t0
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu:\n{out}{err}")
                continue
            PTXAS[n] = _ptxas_lines(out + err)
            targets[n].with_suffix(".ptxas").write_text(
                "\n".join(PTXAS[n]) + "\n"
            )
            os.replace(tmp, targets[n])
        if errors:
            raise RuntimeError("\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
