#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

No ``PYTHONPATH`` is needed: the script puts its own ``src/`` on
``sys.path``.  It builds both sweep kernels from ``src/repro_torch/csrc/``
with nvcc (into the ignored ``build/``), then drives the port's main path
through its public entry points at full size:

* ``apply_f32_512``     — the 13-point star on a 512³ f32 grid,
  ``stencil_pallas(tile=(8, 16, 32), sweep_axis=0)``;
* ``apply_bf16_p2_256`` — two bf16 256³ RHS with two operators,
  ``multi_stencil_pallas``;
* ``chain_T3_512``      — ``stencil_iterate(time_steps=3)`` at 512³ f32,
  ring and trapezoid frontiers;
* ``chain_ragged``      — a two-stage damped-Jacobi program on a ragged
  250×253×258 grid, given as program JSON through
  ``convert.from_reference`` and ``ir.run_program``.

Each phase zeroes the kernels' launch counters, drives the path, reads the
counters (each kernel of the path must have launched), checks the output
(shape, finite, against the plain PyTorch oracle), holds each kernel
against its plain version on the same padded inputs (bit for bit), and
times kernel, plain version and — where one PyTorch call computes the same
function — that call (``F.conv3d`` with TF32 off, a yardstick the port
never calls) with CUDA events.  It prints one JSON line per phase, a
``kernels`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero; without
CUDA, or outside a checkout, it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from math import prod
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM data sheet, f32 outside tensor cores
REPLACES = "src/repro/kernels/stencil.py:148"


def fail(msg: str) -> None:
    print(f"chip_smoke.py: {msg}", file=sys.stderr)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false; this "
             "smoke runs the port's kernels on an NVIDIA H100")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"{SRC / 'repro_torch'} not found: run chip_smoke.py from the "
             "root of a checkout of the repository")
    sys.path.insert(0, str(SRC))

    import numpy as np
    import torch.nn.functional as F

    from repro_torch import convert, ir
    from repro_torch.core.cache_fitting import star_stencil
    from repro_torch.core.tiling import sweep_smem_bytes
    from repro_torch.kernels import _build, ref, sweep
    from repro_torch.kernels import stencil as st
    from repro_torch.kernels.ops import apply_star_2nd_order

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card_line = card()
    kernels = {
        "sweep_apply": sweep.sweep_apply,
        "sweep_chain": sweep.sweep_chain,
    }

    def emit(obj) -> None:
        print(json.dumps(obj), flush=True)

    def reset() -> None:
        for fn in kernels.values():
            fn.launches = 0

    def counts() -> dict:
        return {name: fn.launches for name, fn in kernels.items()}

    def time_ms(fn, reps=10, warmup=2) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def bits_equal(a, b) -> bool:
        view = torch.int16 if a.element_size() == 2 else torch.int32
        return a.shape == b.shape and bool(
            torch.equal(a.contiguous().view(view), b.contiguous().view(view))
        )

    def max_err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    def bound(shape, itemsize, n_in, stage_taps) -> dict:
        """The least time for the function on this card: the ``n_in``
        unpadded inputs read once and the output written once at the HBM
        rate, or 2 flops per tap per grid point per stage at the f32 rate,
        whichever is longer.  Zero halos, tile round-up and recomputed
        overlap are the port's own work and are not counted."""
        n = prod(shape)
        nbytes = (n_in + 1) * n * itemsize
        flops = 2 * sum(stage_taps) * n
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        tf = flops / F32_FLOPS_PER_S * 1e3
        return {"bound_ms": max(tb, tf),
                "bound_by": "bytes" if tb >= tf else "operations",
                "bytes": nbytes, "flops": flops}

    def dense_kernel(offsets, weights, r, dtype):
        k = torch.zeros((2 * r + 1,) * 3, dtype=torch.float32)
        for o, w in zip(np.asarray(offsets).tolist(), weights):
            k[tuple(r + int(v) for v in o)] += float(np.float32(w))
        return k.to(dev, dtype)

    def spec(offsets, weights):
        return (tuple(map(tuple, np.asarray(offsets).tolist())),
                tuple(float(w) for w in weights))

    summary: dict = {}
    gen = torch.Generator(device=dev)

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.BUILD_SECONDS,
          "cached": sorted(set(_build.PTXAS) - set(_build.BUILD_SECONDS)),
          "ptxas": _build.PTXAS,
          "flags": list(_build.NVCC_FLAGS)})

    # -- apply_f32_512 -------------------------------------------------------
    gen.manual_seed(0)
    shape = (512, 512, 512)
    tile = (8, 16, 32)
    u = torch.randn(shape, generator=gen, device=dev)
    offs13, w13 = ref.star_weights_2nd_order(3, 2)
    reset()
    out = st.stencil_pallas(u, offs13, w13, tile=tile, sweep_axis=0)
    torch.cuda.synchronize()
    launched = counts()
    assert launched["sweep_apply"] >= 1, launched
    assert out.shape == shape and bool(torch.isfinite(out).all())
    oracle = ref.stencil_ref(u, offs13, w13)
    oracle_err = max_err(out, oracle)
    assert oracle_err <= 1e-4, oracle_err
    star_out = apply_star_2nd_order(u, tile=tile, sweep_axis=0)
    assert bits_equal(star_out, out)
    ins, offs, wts, _, lo_w, hi_w = st._launch_inputs(
        [u], (spec(offs13, w13),), tile
    )
    args = (ins, offs, wts, lo_w, hi_w, tile, 0, True)
    k_out = sweep.sweep_apply(*args)
    p_out = sweep.sweep_apply_plain(*args)
    torch.cuda.synchronize()
    exact = bits_equal(k_out, p_out)
    err = max_err(k_out, p_out)
    assert exact, err
    kernel_ms = time_ms(lambda: sweep.sweep_apply(*args))
    plain_ms = time_ms(lambda: sweep.sweep_apply_plain(*args))
    # A device copy of the padded input moves about the kernel's bytes:
    # the rate this card reaches in practice, beside the data-sheet bound.
    copy_ms = time_ms(lambda: ins[0].clone())
    call_ms = time_ms(
        lambda: st.stencil_pallas(u, offs13, w13, tile=tile, sweep_axis=0)
    )
    kern = dense_kernel(offs13, w13, 2, torch.float32)[None, None]
    lib_ms = time_ms(lambda: F.conv3d(u[None, None], kern, padding=2))
    lib_err = max_err(F.conv3d(u[None, None], kern, padding=2)[0, 0], out)
    moved = ins[0].numel() * 4 + k_out.numel() * 4
    phase = {
        "phase": "apply_f32_512", "shape": list(shape), "tile": list(tile),
        "sweep_axis": 0, "launches": launched, "exact_vs_plain": exact,
        "max_abs_err": err, "oracle_max_abs_err": oracle_err,
        "library_max_abs_diff": lib_err, "ms": kernel_ms, "call_ms": call_ms,
        "copy_ms": copy_ms, "copy_bytes": 2 * ins[0].numel() * 4,
        "plain_ms": plain_ms, "library_ms": lib_ms,
        **bound(shape, 4, 1, [len(w13)]), "bytes_moved": moved,
        "card": card_line,
    }
    emit(phase)
    summary["sweep_apply"] = [phase]
    del u, out, oracle, star_out, ins, k_out, p_out, args
    torch.cuda.empty_cache()

    # -- apply_bf16_p2_256 ---------------------------------------------------
    gen.manual_seed(1)
    shape = (256, 256, 256)
    tile = (8, 16, 32)
    us = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
          for _ in range(2)]
    offs7 = star_stencil(3, 1)
    w7 = [-1.5] + [0.25] * 6
    reset()
    out = st.multi_stencil_pallas(
        us, [offs13, offs7], [w13, w7], tile=tile, sweep_axis=0
    )
    torch.cuda.synchronize()
    launched = counts()
    assert launched["sweep_apply"] >= 1, launched
    assert out.shape == shape and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
    # f32 oracle: the kernel rounds its f32 sum to bf16 once; allow that
    # rounding (2^-8 relative) plus f32 reassociation between the two
    # summation orders.
    oracle = (ref.stencil_ref(us[0].float(), offs13, w13)
              + ref.stencil_ref(us[1].float(), offs7, w7))
    scale = float(sum(abs(w) for w in w13 + w7)) * max(
        float(us[0].float().abs().max()), float(us[1].float().abs().max())
    )
    dev_ = (out.float() - oracle).abs() - (
        2.0 ** -8 * oracle.abs() + 1e-5 * scale
    )
    assert float(dev_.max()) <= 0, float(dev_.max())
    oracle_err = max_err(out, oracle)
    ins, offs, wts, _, lo_w, hi_w = st._launch_inputs(
        us, (spec(offs13, w13), spec(offs7, w7)), tile
    )
    args = (ins, offs, wts, lo_w, hi_w, tile, 0, True)
    k_out = sweep.sweep_apply(*args)
    p_out = sweep.sweep_apply_plain(*args)
    torch.cuda.synchronize()
    exact = bits_equal(k_out, p_out)
    err = max_err(k_out, p_out)
    assert exact, err
    kernel_ms = time_ms(lambda: sweep.sweep_apply(*args))
    plain_ms = time_ms(lambda: sweep.sweep_apply_plain(*args))
    kern = torch.stack([
        dense_kernel(offs13, w13, 2, torch.bfloat16),
        dense_kernel(offs7, w7, 2, torch.bfloat16),
    ])[None]
    xin = torch.stack(us)[None]
    lib_ms = time_ms(lambda: F.conv3d(xin, kern, padding=2))
    moved = sum(x.numel() * 2 for x in ins) + k_out.numel() * 2
    phase = {
        "phase": "apply_bf16_p2_256", "shape": list(shape),
        "tile": list(tile), "sweep_axis": 0, "p": 2, "launches": launched,
        "exact_vs_plain": exact, "max_abs_err": err,
        "oracle_max_abs_err": oracle_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "library_ms": lib_ms,
        **bound(shape, 2, 2, [len(w13) + len(w7)]), "bytes_moved": moved,
        "card": card_line,
    }
    emit(phase)
    summary["sweep_apply"].append(phase)
    del us, out, oracle, dev_, ins, k_out, p_out, args, xin
    torch.cuda.empty_cache()

    # -- chain_T3_512 ----------------------------------------------------------
    gen.manual_seed(2)
    shape = (512, 512, 512)
    tile = (4, 16, 32)
    u = torch.randn(shape, generator=gen, device=dev)
    outs, launched = {}, {}
    for wk in ("ring", "trapezoid"):
        reset()
        outs[wk] = st.stencil_iterate(
            u, offs13, w13, 3, tile=tile, sweep_axis=0, window_kind=wk
        )
        torch.cuda.synchronize()
        launched[wk] = counts()
        assert launched[wk]["sweep_chain"] >= 1, launched
    ring_eq_trap = bits_equal(outs["ring"], outs["trapezoid"])
    assert ring_eq_trap
    out = outs["ring"]
    assert out.shape == shape and bool(torch.isfinite(out).all())
    oracle = u
    for _ in range(3):
        oracle = ref.stencil_ref(oracle, offs13, w13)
    oracle_err = max_err(out, oracle)
    assert oracle_err <= 1e-3, oracle_err
    stages_w = (spec(offs13, w13),) * 3
    ins, _, _, stages, lo_w, hi_w = st._launch_inputs(
        [u], (spec(offs13, w13),), tile, stages_w
    )
    del oracle, outs
    torch.cuda.empty_cache()
    times, exact_all, err_all = {}, True, 0.0
    p_out = sweep.sweep_chain_plain(ins[0], stages, lo_w, hi_w, tile, 0,
                                    True, "ring", shape)
    for wk in ("ring", "trapezoid"):
        cargs = (ins[0], stages, lo_w, hi_w, tile, 0, True, wk, shape)
        k_out = sweep.sweep_chain(*cargs)
        torch.cuda.synchronize()
        exact_all &= bits_equal(k_out, p_out)
        err_all = max(err_all, max_err(k_out, p_out))
        times[wk] = time_ms(lambda: sweep.sweep_chain(*cargs))
        del k_out
    assert exact_all, err_all
    halos = [list(zip(s_.lo, s_.hi)) for s_ in stages]
    smem = {wk: sweep_smem_bytes(tile, 0, 4, stage_halos=halos,
                                 pipelined=True, window_kind=wk)
            for wk in ("ring", "trapezoid")}
    plain_ms = time_ms(lambda: sweep.sweep_chain_plain(
        ins[0], stages, lo_w, hi_w, tile, 0, True, "ring", shape), reps=5)
    # The same three applications through the frontend: one fused launch,
    # or three single-application launches at the apply phase's tile.
    call_ms = time_ms(lambda: st.stencil_iterate(
        u, offs13, w13, 3, tile=tile, sweep_axis=0), reps=5)

    def unfused():
        v = u
        for _ in range(3):
            v = st.stencil_pallas(v, offs13, w13, tile=(8, 16, 32),
                                  sweep_axis=0)
        return v

    unfused_ms = time_ms(unfused, reps=5)
    pts = sweep.chain_points(stages, tile, 0, "ring", p_out.shape)
    computed = sum(2 * len(s_.weights) * n for s_, n in zip(stages, pts))
    moved = ins[0].numel() * 4 + p_out.numel() * 4
    phase = {
        "phase": "chain_T3_512", "shape": list(shape), "tile": list(tile),
        "sweep_axis": 0, "time_steps": 3, "launches": launched,
        "ring_equals_trapezoid": ring_eq_trap, "exact_vs_plain": exact_all,
        "max_abs_err": err_all, "oracle_max_abs_err": oracle_err,
        "ms": times["ring"], "ms_by_window": times, "smem_bytes": smem,
        "plain_ms": plain_ms, "call_ms": call_ms,
        "unfused_call_ms": unfused_ms, "unfused_tile": [8, 16, 32],
        "library_ms": None,
        **bound(shape, 4, 1, [len(s_.weights) for s_ in stages]),
        "bytes_moved": moved, "flops_computed": computed, "card": card_line,
    }
    emit(phase)
    summary["sweep_chain"] = [phase]
    del u, out, ins, p_out
    torch.cuda.empty_cache()

    # -- chain_ragged: a program carried across from JSON ---------------------
    shape = (250, 253, 258)
    tile = (4, 16, 32)
    # Damped Jacobi u + (omega / diag) * K u: stage 1 (7-point) as a
    # combine that lowering folds, stage 2 (13-point) with the damping
    # folded into its weights.
    om = 0.8 / 7.5
    w13_jac = [1.0 + om * w13[0]] + [om * float(w) for w in w13[1:]]
    prog_json = json.dumps({"d": 3, "ops": [
        {"op": "load", "result": "u0", "input": "u"},
        {"op": "apply", "result": "a1", "operand": "u0",
         "offsets": offs7.tolist(), "weights": [-6.0] + [1.0] * 6},
        {"op": "combine", "result": "c1", "operands": ["u0", "a1"],
         "coeffs": [1.0, (2.0 / 3.0) / 6.0]},
        {"op": "apply", "result": "c2", "operand": "c1",
         "offsets": offs13.tolist(), "weights": w13_jac},
        {"op": "store", "operand": "c2"},
    ]}, sort_keys=True, separators=(",", ":"))
    grid = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    prog, arrays = convert.from_reference(prog_json, {"u": grid}, device=dev)
    lowered = ir.lower(prog, shape)
    assert lowered.kind == "chain" and len(lowered.stages) == 2
    reset()
    out = ir.run_program(prog, arrays, tile=tile, sweep_axis=0)
    torch.cuda.synchronize()
    launched = counts()
    assert launched["sweep_chain"] >= 1, launched
    assert out.shape == shape and bool(torch.isfinite(out).all())
    oracle = arrays["u"]
    for offs_j, wts_j in lowered.stages:
        oracle = ref.stencil_ref(oracle, np.asarray(offs_j), wts_j)
    oracle_err = max_err(out, oracle)
    assert oracle_err <= 1e-4, oracle_err
    stages_w = tuple(spec(o, w) for o, w in lowered.stages)
    ins, _, _, stages, lo_w, hi_w = st._launch_inputs(
        [arrays["u"]], stages_w[:1], tile, stages_w
    )
    cargs = (ins[0], stages, lo_w, hi_w, tile, 0, True, "ring", shape)
    k_out = sweep.sweep_chain(*cargs)
    p_out = sweep.sweep_chain_plain(*cargs)
    torch.cuda.synchronize()
    exact = bits_equal(k_out, p_out)
    err = max_err(k_out, p_out)
    assert exact, err
    kernel_ms = time_ms(lambda: sweep.sweep_chain(*cargs))
    plain_ms = time_ms(lambda: sweep.sweep_chain_plain(*cargs))
    pts = sweep.chain_points(stages, tile, 0, "ring", p_out.shape)
    computed = sum(2 * len(s_.weights) * n for s_, n in zip(stages, pts))
    moved = ins[0].numel() * 4 + k_out.numel() * 4
    phase = {
        "phase": "chain_ragged", "shape": list(shape), "tile": list(tile),
        "sweep_axis": 0, "stages": 2, "launches": launched,
        "exact_vs_plain": exact, "max_abs_err": err,
        "oracle_max_abs_err": oracle_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "library_ms": None,
        **bound(shape, 4, 1, [len(s_.weights) for s_ in stages]),
        "bytes_moved": moved, "flops_computed": computed, "card": card_line,
    }
    emit(phase)
    summary["sweep_chain"].append(phase)

    # -- summary ---------------------------------------------------------------
    rows = []
    parts = {"sweep_apply": "B1+B2", "sweep_chain": "B1+B3+B4"}
    for name, phases in summary.items():
        head = phases[0]

        def n_launch(ph):
            ln = ph["launches"]
            if name in ln:
                return ln[name]
            return sum(v[name] for v in ln.values())

        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES, "parts": parts[name],
            "launches": sum(n_launch(ph) for ph in phases),
            "max_abs_err": max(ph["max_abs_err"] for ph in phases),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "phase": head["phase"],
        })
    emit({"kernels": rows})
    print(card_line)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


if __name__ == "__main__":
    main()
