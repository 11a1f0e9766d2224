#!/usr/bin/env python3
"""Where the chain kernel's boundary time goes, measured on the card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 scripts/chain_boundary_profile.py

It needs no ``PYTHONPATH``.  Every case launches ``sweep_chain`` on a
512³ f32 grid through its wrapper and times the kernel alone with
``torch.profiler`` (median of 5 launches), next to the same launch of
these copies of ``csrc/sweep_chain.cu``, each built with the repo's nvcc
flags into the ignored ``build/``:

* ``cycles`` — instrumented: per CTA it sums the ``clock64()`` cycles of
  each schedule entry from its start to its closing barrier, by kind
  (interior, face frame, sweep face only), and thread 0's cycles inside
  ``bc_block`` and inside the tap sums of its face items;
* ``no_rows`` — the boundary sum reads its class bounds but applies no
  term rows;
* ``no_source`` — the terms are applied with a constant in place of the
  source read.

``no_rows`` and ``no_source`` give wrong results and are timed only;
``kernel`` and ``cycles`` are held against ``sweep_chain_plain`` bit for
bit.  The cases are ``bc_neumann_apply_512``'s launch (the 13-point star
once under neumann, tile (8, 16, 32)) without a boundary, with faces
everywhere, and with the faces moved out of reach along two of the three
axes (``dom`` and ``n_true`` put them 1000 cells away), plus the
three-stage chain at tile (4, 16, 32) without a boundary and under
reflect.  One JSON line per case; the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# The instrumented copy: (text in csrc/sweep_chain.cu, its replacement).
_DBG = [
    ("namespace {\n\nconstexpr int kThreads",
     "namespace {\n\n__device__ unsigned long long g_dbg[4096 * 8];\n\n"
     "constexpr int kThreads"),
    ("  if (two && frame)\n",
     "  const long long t_a = clock64();\n  if (two && frame)\n"),
    ("    entry_items<1, false, S, DQ>(P, E, smem, src);\n"
     "  __syncthreads();\n}",
     "    entry_items<1, false, S, DQ>(P, E, smem, src);\n"
     "  __syncthreads();\n"
     "  unsigned long long* d = g_dbg + blockIdx.x * 8;\n"
     "  const int sl = frame ? (E.sweep_face ? 6 : 0) : 2;\n"
     "  if (threadIdx.x == 0) {\n"
     "    d[sl] += clock64() - t_a;\n"
     "    d[sl + 1] += 1;\n"
     "  }\n}"),
    ("    bc_block<S, DQ>(P, B, src, E.src_depth, E.src_plane, m, cross, gs,\n"
     "                    E.go0 + x0, E.go1 + x1, nr, add);\n",
     "    const long long tb0 = clock64();\n"
     "    bc_block<S, DQ>(P, B, src, E.src_depth, E.src_plane, m, cross, gs,\n"
     "                    E.go0 + x0, E.go1 + x1, nr, add);\n"
     "    if (threadIdx.x == 0) {\n"
     "      float s = 0.f;\n"
     "      for (int q = 0; q < kRows; ++q) s += add[q];\n"
     "      if (s == 12345.f) g_dbg[0] = 1;  // waits for the sums\n"
     "      g_dbg[blockIdx.x * 8 + 4] += clock64() - tb0;\n"
     "    }\n"),
    ("    float acc[X][kRows];\n",
     "    float acc[X][kRows];\n    const long long tt0 = clock64();\n"),
    ("      tap_sums<X, S, DQ>(P, E.tap0, E.tap1, src, E.src_depth, "
     "E.src_plane,\n                         m, cross, nr, acc);\n",
     "      tap_sums<X, S, DQ>(P, E.tap0, E.tap1, src, E.src_depth, "
     "E.src_plane,\n                         m, cross, nr, acc);\n"
     "    if (threadIdx.x == 0 && FR && (frame || E.sweep_face)) {\n"
     "      float s = 0.f;\n"
     "      for (int q = 0; q < kRows; ++q) s += acc[0][q];\n"
     "      if (s == 12345.f) g_dbg[0] = 1;\n"
     "      g_dbg[blockIdx.x * 8 + 5] += clock64() - tt0;\n"
     "    }\n"),
    ('extern "C" int sweep_chain_threads() { return kThreads; }',
     'extern "C" int sweep_chain_threads() { return kThreads; }\n'
     'extern "C" int dbg_reset() {\n'
     '  static unsigned long long z[4096 * 8];\n'
     '  return cudaMemcpyToSymbol(g_dbg, z, sizeof(z));\n}\n'
     'extern "C" int dbg_read(void* h) {\n'
     '  return cudaMemcpyFromSymbol(h, g_dbg, sizeof(g_dbg));\n}'),
]
VARIANTS = {
    "cycles": _DBG,
    "no_rows": [("    if (t0 < t1)\n      bc_rows<S, DQ>(",
                 "    if (t0 < 0 && t0 < t1)\n      bc_rows<S, DQ>(")],
    "no_source": [
        ("    const float v = src_at<S, DQ>(P, at + wrap(srow[i] + b.x, "
         "depth) * plane);",
         "    const float v = __int_as_float(b.x + i);")],
}
FAR = 1000  # cells between the grid and a face moved out of reach
CASES = [
    ("neumann_T1_none", dict(T=1, bc=None)),
    ("neumann_T1_all_faces", dict(T=1)),
    ("neumann_T1_sweep_faces", dict(T=1, far=(1, 2))),
    ("neumann_T1_c0_faces", dict(T=1, far=(0, 2))),
    ("neumann_T1_c1_faces", dict(T=1, far=(0, 1))),
    ("chain_T3_none", dict(T=3, bc=None)),
    ("chain_T3_reflect", dict(T=3, bc="reflect")),
]


def fail(msg: str) -> None:
    print(f"chain_boundary_profile.py: {msg}", file=sys.stderr)
    sys.exit(1)


def build(name, edits, csrc, nvcc, flags, out_dir):
    """Start nvcc on csrc/sweep_chain.cu with ``edits`` applied."""
    text = (csrc / "sweep_chain.cu").read_text()
    for old, new in edits:
        if old not in text:
            fail(f"variant {name}: the kernel no longer contains {old!r}")
        text = text.replace(old, new)
    cu = out_dir / f"sweep_chain_{name}.cu"
    cu.write_text(text)
    so = out_dir / f"sweep_chain_{name}.so"
    return subprocess.Popen(
        [nvcc, *flags, "-I", str(csrc), "-o", str(so), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this profile runs the chain kernel on the card")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build, ref, sweep
    from repro_torch.kernels import stencil as st

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    out_dir = _build.BUILD_DIR / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: build(name, edits, _build.CSRC, _build._nvcc(),
                         _build.NVCC_FLAGS, out_dir)
             for name, edits in VARIANTS.items()}
    _build.build_all(["sweep_chain"])
    fns = {"kernel": sweep._entry("sweep_chain")}
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            fail(f"nvcc failed for variant {name}:\n{log[-3000:]}")
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines() if "registers" in ln]}),
            flush=True)
        lib = libs[name] = ctypes.CDLL(str(so))
        fn = lib.sweep_chain_launch
        fn.restype = ctypes.c_int
        fn.argtypes = sweep._ARGTYPES["sweep_chain_launch"]
        fns[name] = fn

    def device_ms(call, reps=5) -> float:
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        return statistics.median(
            e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "sweep_chain_kernel" in e.name)

    def cycles(lib, call) -> dict:
        """Per-entry cycle sums of the instrumented copy, one launch."""
        buf = (ctypes.c_ulonglong * (4096 * 8))()
        lib.dbg_reset()
        torch.cuda.synchronize()
        call()
        torch.cuda.synchronize()
        lib.dbg_read(buf)
        a = np.frombuffer(buf, dtype=np.uint64).reshape(-1, 8)
        a = a.astype(np.float64)

        def per(num, den):
            n = float(a[:, den].sum())
            return float(a[:, num].sum()) / n if n else None

        return {
            "interior_entries": float(a[:, 3].sum()),
            "cycles_per_interior_entry": per(2, 3),
            "frame_entries": float(a[:, 1].sum()),
            "cycles_per_frame_entry": per(0, 1),
            "sweep_face_entries": float(a[:, 7].sum()),
            "cycles_per_sweep_face_entry": per(6, 7),
            "thread0_bc_block_cycles_per_face_entry": (
                float(a[:, 4].sum()) / max(float(a[:, 1].sum()
                                                 + a[:, 7].sum()), 1.0)),
            "thread0_tap_cycles_per_face_entry": (
                float(a[:, 5].sum()) / max(float(a[:, 1].sum()
                                                 + a[:, 7].sum()), 1.0)),
        }

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    shape = (512, 512, 512)
    u = torch.randn(shape, generator=gen, device=dev)
    offs13, w13 = ref.star_weights_2nd_order(3, 2)
    spec = (tuple(map(tuple, np.asarray(offs13).tolist())),
            tuple(float(w) for w in w13))
    for name, case in CASES:
        T = case["T"]
        tile = (8, 16, 32) if T == 1 else (4, 16, 32)
        kind = case.get("bc", "neumann")
        bcs = None if kind is None else ((kind, 0.0),) * T
        ins, _, _, stages, lo_w, hi_w = st._launch_inputs(
            [u], (spec,), tile, (spec,) * T, bcs_w=bcs)
        far = case.get("far", ())
        dom = tuple(FAR if a in far else 0 for a in range(3))
        n_true = tuple(3 * FAR if a in far else n
                       for a, n in enumerate(shape))
        args = (ins[0], stages, lo_w, hi_w, tile, 0, True, "ring", n_true,
                dom)
        want = sweep.sweep_chain_plain(*args)
        row = {"case": name, "tile": list(tile), "stages": T,
               "boundary": kind, "faces_moved_off_axes": list(far)}
        for vname, fn in fns.items():
            sweep._ENTRIES["sweep_chain", "launch"] = fn
            got = sweep.sweep_chain(*args)
            torch.cuda.synchronize()
            row[vname] = {
                "device_ms": device_ms(lambda: sweep.sweep_chain(*args)),
                "equals_plain": bool(torch.equal(got.view(torch.int32),
                                                 want.view(torch.int32)))}
            if vname == "cycles":
                row[vname].update(cycles(
                    libs[vname], lambda: sweep.sweep_chain(*args)))
            del got
        sweep._ENTRIES["sweep_chain", "launch"] = fns["kernel"]
        assert row["kernel"]["equals_plain"], name
        assert row["cycles"]["equals_plain"], name
        print(json.dumps(row), flush=True)
        del ins, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
