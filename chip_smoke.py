#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

No ``PYTHONPATH`` is needed: the script puts its own ``src/`` on
``sys.path``.  It builds every kernel (the two sweep kernels and the
Mamba2 conv) from ``src/repro_torch/csrc/`` with nvcc (into the ignored
``build/``), then drives the port's paths through their public entry
points at full size:

* ``apply_f32_512``     — the 13-point star on a 512³ f32 grid,
  ``stencil_pallas(tile=(8, 16, 32), sweep_axis=0)``;
* ``apply_bf16_p2_256`` — two bf16 256³ RHS with two operators,
  ``multi_stencil_pallas``;
* ``apply_f32_p2_512_sweep1`` — two f32 512³ RHS swept along axis 1, the
  13-point star (a compiled shape) and the 7-point star with its taps
  reversed (the table-driven tap loop) in one launch;
* ``chain_T3_512``      — ``stencil_iterate(time_steps=3)`` at 512³ f32,
  ring and trapezoid frontiers;
* ``chain_T3_512_sweep1`` — the same chain swept along axis 1 with the
  tile's roles kept (``tile=(16, 4, 32)``): the 13-point star's taps are
  then not in the order the kernel compiles, so its stages run the
  table-driven tap loop, timed against ``chain_T3_512``'s compiled ones;
* ``chain_bf16_T3_512`` — the chain on a bf16 grid (bf16 window, frontiers
  and result; the first stage reads the bf16 window on the table-driven
  loop);
* ``chain_ragged``      — a two-stage damped-Jacobi program on a ragged
  250×253×258 grid, given as program JSON through
  ``convert.from_reference`` and ``ir.run_program``;
* ``bc_neumann_apply_512`` — the 13-point star once under a neumann
  boundary at 512³ f32 (a one-stage chain launch with correction taps);
* ``chain_periodic_T3_512`` — three periodic applications at 512³ f32
  (host wrap fill, widened masks), ring and trapezoid;
* ``chain_mixed_bc_256`` — dirichlet(0.5) damped Jacobi on the 7-point
  star, then robin(0.7, 0.3) on the 27-point box, at 256³ f32;
* ``chain_dtypes_512``  — ``stencil_iterate(T=3, dtypes=["bfloat16",
  "bfloat16", "float32"])`` at 512³ f32;
* ``chain_int8_512``    — three reflect applications at 512³ f32 with
  stages 0 and 1 quantized to int8 (scale 0.02, zero point 3), plus the
  same chain split after stage 1 into two launches that hand int8 codes
  over (``in_quant``);
* ``planned_apply_f32_512``, ``planned_chain_T3_512``,
  ``planned_chain_int8_512``, ``planned_apply_bf16_p2_256`` — the calls of
  ``apply_f32_512``, ``chain_T3_512``, ``chain_int8_512`` and
  ``apply_bf16_p2_256`` with ``tile=None``: the plan compiler decides tile,
  sweep axis, window kind and fusion depth for this card (after a
  ``hopper_device`` line with the card's description); each prints the
  plan (smem per CTA, CTAs per SM, waves, ``modeled_ms``) beside the
  measured time and the hand-picked phase's from the same run, and holds
  the output bit-equal to the same launches run by the plain versions;
* ``tuned_apply_f32_512``, ``tuned_chain_T3_512``, ``tuned_chain_int8_512``,
  ``tuned_apply_bf16_p2_256`` — the same calls with ``tune=True`` (the
  default tuner: the planner's top 4 candidates, and for an undtyped
  chain its advisory bf16 and int8 storage variants, raced with 1 warm-up
  and 5 timed calls each): each prints the candidate table (modelled
  against measured ms), the winner's rank, ``speedup_vs_analytic``,
  ``rank_correlation`` and the race's seconds; holds the output bit-equal
  to the same launches on the plain versions; checks that the first call
  measured and that the warm call counts one ``tunedb_hit``, measures
  nothing, launches nothing while it plans and plans in under 1 ms of host
  time (median of 20 calls); and re-measures the winner against the
  analytic plan in 20 alternating rounds of 10 calls
  (``tuned_over_analytic``, the median ratio, at most 1.05).  Plans and
  tuned records go to fresh directories of the run, never to the home
  directory;
* ``traced_calls`` — ``apply_f32_512``'s call and the planned int8 chain
  with ``trace=`` under ``torch.profiler``: the trace passes
  ``validate_trace``, reconciles (``report.reconcile`` and ``python -m
  repro_torch.obs.report --check``), its ``kernel_launch`` spans equal the
  wrappers' launch counts, and each span's ``record_function`` range
  holds the one sweep kernel it launched; with the apply call's time
  untraced and traced;
* ``unfavorable_sweep`` — the planned 13-point star on n × n × 256 f32
  grids, n = 500..516, at the planned and at a fixed tile, ns per point
  beside whether the paper's §6 criterion flags the grid under the
  paper's (2, 512, 4) cache and under a stated L1 model; each grid a
  geometry flags is measured again on ``pad_grid``'s padded grid (ns per
  point of the caller's grid) as ``layout_sweep`` measures a grid; every
  launch bit-equal to its plain version on the first pass;
* ``layout_sweep``      — the paper's §6 for the layout the launch reads:
  the planned 13-point star on 512 × 512 × m grids, m = 240..272, f32 and
  bf16, two passes (m rising, then falling); per m the kernel's ``ms``
  and ``device_ms``, the call's ``call_ms``, ns per useful point, the
  launch buffer's slack (``core.padding.tpu_layout_waste``, held equal to
  the buffer ``_launch_inputs`` builds), whether its rows copy as whole
  16-byte blocks, and ``advise_dim``'s verdict on m; each flagged m also
  padded as advised and timed; each launch bit-equal to its plain
  version on the first pass; a verdict per dtype on whether the advice
  predicts ``ms`` or ``call_ms`` (flagged rows slower than the others by
  more than the two passes' spread);
* ``mamba2_serve``      — Mamba2-2.7B at its published width and depth (64
  layers, weights drawn from a seeded generator) with the conv on the
  kernel (``pallas_conv=True, conv_tile=256``), serving batch 4 × 2048
  prompt tokens + 16 generated tokens through ``launch.serve.serve``
  (prefill, then 15 greedy decode steps); the conv kernel against its
  plain version on layer 0's real conv input; prefill(S−1) + decode(1)
  against a teacher-forced forward; a 2-layer full-width model on the
  card against the CPU;
* ``mamba2_train``      — Mamba2-2.7B at published width and depth (64
  layers, f32 parameters, bf16 compute, weights from seed 0, the conv on
  the kernel at tile 256) trained through ``launch.train.train_step`` on
  the pipeline's synthetic batches at ``LM_SHAPES["train_4k"]``'s 4096
  tokens, batch 2 (the global batch of 256 cut to one card): a cold step
  and 3 timed steps (host clock, card synchronised; tokens/s, model flops
  6·N·tokens against the bf16 peak, peak memory, 128 conv launches a
  step), one step under ``torch.profiler`` (device busy and idle share,
  kernel classes, launches), 3 steps on a repeated batch (the loss
  falls); the conv kernel bit-equal to its plain version on layer 0's
  training input and timed beside the plain VJP (``causal_conv1d_vjp``)
  and their byte bounds; at 2 layers and full width, one step on the card
  against the CPU within a stated band, and an async save, a restore into
  fresh objects and a step bit-equal to the uninterrupted run;
* ``zamba2_serve``, ``zamba2_train`` — the Zamba2-2.7B hybrid (54 Mamba2
  layers at full width, one shared attention + MLP block applied after
  every 6th, so 9 applications each with its own KV ring) through the
  same two phases: conv launches 54 a prefill and 108 a training step,
  the conv at 4 × 2048 × 5248 bf16, the KV rings' size; the card-vs-CPU
  checks at 6 layers (one shared-block application); 3 steps on the
  repeated batch;
* ``planned_conv``      — the prefill conv's shape with ``tile_s=None``:
  the planned tile and the serving phase's 256, both timed;
* ``granite_serve``     — Granite-3.0-2B at published width and depth (40
  layers, 2.53 B f32 parameters, weights from seed 0) serving batch 4 ×
  2048 prompt tokens + 16 through ``launch.serve.serve``: prefill and
  decode ms (best of two warm runs), the profiler's idle share, peak
  memory and the KV cache's size; prefill(S−1) + decode(1) against a
  teacher-forced forward; 2 layers at full width on the card against the
  CPU;
* ``granite_train``     — the same model trained through
  ``launch.train.train_step`` at batch 2 × 4096 (``LM_SHAPES["train_4k"]``,
  the global batch cut to one card): a cold step and 3 timed steps
  (tokens/s, 6·N·tokens against the bf16 peak, peak memory at most 75
  GB), one profiled step, 5 steps on a repeated batch at lr 3e-4 (the
  loss falls), and at 2 layers one step against the CPU's within
  ``mamba2_train``'s bands and a bit-equal resume;
* ``families_serve``    — the other seven transformer architectures at
  published width, one prefill and 4 decode steps each, depth cut only
  where the weights exceed 60 GB (``fit_layers``): internvl2-2b (a
  256-patch prefix, decode at F + S + i), whisper-large-v3 (1500 frames,
  4 × 448 prompt tokens, the cross keys and values), qwen1.5-32b,
  internlm2-20b, llama3-405b, mixtral-8x22b (1 × 4608 tokens: past its
  4096-token window) and arctic-480b: prefill and decode ms, peak memory
  (at most 75 GB), layers run, MoE assignments dropped at capacity per
  layer; the teacher-forced check gated where no assignment was dropped;
  internvl2 and whisper at 2 layers, and mixtral at 1 layer (1 × 128,
  routes compared token by token), against the CPU.  None of the port's
  kernels is on these paths (the reference computes every product there
  as a plain einsum): each phase asserts that their counts stay 0;
* ``mesh_step``         — the trainer's mesh: a training step under
  ``activate_mesh(make_test_mesh())`` bit-equal to the same step without
  (granite-3-2b at 2 layers, 1 × 256; one mixtral-8x22b layer bound to
  ``dp=2``, 2 × 64), each also against the CPU's step within
  ``mamba2_train``'s bands; then ``launch.train.main`` for 2 granite
  steps under its own mesh;
* ``roofline_granite_train`` — granite's full-width step (2 × 4096)
  counted by ``launch.op_analysis`` on ``meta``: model and counted flops,
  ``useful_flop_ratio`` (at most 1), ``t_compute`` and ``t_memory`` on
  the published peaks, beside ``granite_train``'s measured step (no
  shorter than the larger of the two);
* ``dryrun_cells``      — ``python -m repro_torch.launch.dryrun`` for
  granite-3-2b ``train_4k`` on 16×16 and mixtral-8x22b ``decode_32k`` on
  2×16×16, in a child process that sees no card (host only);
* ``mixtral_train``     — mixtral-8x22b at published width, 1 of 56
  layers, trained at 1 × 4096 for 3 steps: step time, tokens/s, peak
  memory (at most 75 GB), assignments dropped; finite loss and gradients;
* ``lm_examples``       — the ``train_lm`` twin at 100M, 60 steps at 8 ×
  256 (the loss falls), and the ``serve_lm`` twin.

Each phase zeroes the kernels' launch counters, drives the path, reads the
counters (each kernel of the path must have launched), checks the output
(shape, finite, against the plain PyTorch oracle ``kernels/ref.py`` within
the stated band), holds each kernel against its plain version on the same
padded inputs (bit for bit) and ring against trapezoid frontiers (bit for
bit), and times kernel, plain version and — where one PyTorch call
computes the same function — that call (``F.conv3d`` or ``nn.Conv3d``
with TF32 off, a yardstick the port never calls) with CUDA events.  Each
chain phase also says why the chain kernel runs as it does: threads and
shared bytes per CTA, CTAs and warps resident per SM (the CUDA occupancy
query) and ptxas's register and spill line; ``chain_T3_512`` prints the
unfused call time over the fused one.  Beside each chain launch's ``ms``
(one wrapper call between CUDA events, host preparation included) it
prints ``device_ms`` (the kernel alone, from ``torch.profiler``) and
``cold_ms`` (one call with the wrapper's table cache emptied, so the
host builds the launch tables).  Each apply phase and the conv print
``device_ms`` too, ``host_ms`` (one wrapper call up to its return, the
card idle before it), threads, CTAs per SM, waves and the ptxas line; the
conv prints ``copy_ms`` / ``copy_device_ms``, a device copy of its input
(the same bytes), as the yardstick of what the card reaches.  It prints
one JSON line per phase, the seconds each group of phases took, a
``kernels`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero; without
CUDA, or outside a checkout, it exits non-zero before printing a result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from math import prod
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM data sheet, f32 outside tensor cores
BF16_FLOPS_PER_S = 989e12   # H100 SXM data sheet, bf16 dense tensor cores
# The TPU kernel each CUDA kernel replaces, and which of its parts.
REPLACES = {
    "sweep_apply": ("src/repro/kernels/stencil.py:148", "B1+B2"),
    "sweep_chain": ("src/repro/kernels/stencil.py:148", "B1+B3+B4+B5+B6"),
    "conv1d": ("src/repro/kernels/conv1d.py:44", "all"),
}


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
    # Plans and tuned records go to fresh directories of this run, removed
    # at exit: the first tuned call must measure, and nothing is read
    # from (or left in) the home directory.
    state = tempfile.TemporaryDirectory(prefix="chip_smoke-")
    os.environ["REPRO_TORCH_PLAN_CACHE_DIR"] = os.path.join(state.name,
                                                            "plans")
    os.environ["REPRO_TORCH_TUNED_DB_DIR"] = os.path.join(state.name,
                                                          "tuned")

    import numpy as np
    import torch.nn.functional as F

    from repro_torch import convert, ir, obs
    from repro_torch.core.cache_fitting import star_stencil
    from repro_torch.core.padding import pad_grid
    from repro_torch.core.tiling import apply_smem_bytes, sweep_smem_bytes
    from repro_torch.kernels import _build, conv1d, ref, sweep
    from repro_torch.kernels import stencil as st
    from repro_torch.kernels.ops import apply_star_2nd_order
    from repro_torch.obs.report import reconcile, summarize
    from repro_torch.plan import default_planner, resolve_tuner
    from repro_torch.runtime.isa import pin_precision

    pin_precision()
    dev = torch.device("cuda")
    card_line = card()
    kernels = ("sweep_apply", "sweep_chain", "conv1d")
    since: dict = {}

    def emit(obj) -> None:
        print(json.dumps(obj), flush=True)

    def reset() -> None:
        since.clear()
        since.update(obs.totals())

    def counts() -> dict:
        now = obs.totals()
        return {name: now[f"launches.{name}"] - since.get(f"launches.{name}", 0)
                for name in kernels}

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

    def host_ms(fn, reps=10) -> float:
        """Median host time of one call of ``fn`` up to its return, the card
        idle before each (the wrapper's checks, tables and launch)."""
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    def device_ms(fn, reps=5, kernel="sweep_chain_kernel"):
        """Median device time of one kernel alone (the device events whose
        name holds ``kernel``; "" for any) over ``reps`` calls of ``fn``,
        from ``torch.profiler``'s CUDA events (host preparation and launch
        overhead excluded).  A session that records no such event (seen
        after the training step's profile of 277k launches) is taken
        again, at most twice."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            ts = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and kernel in e.name]
            if ts:
                return statistics.median(ts)
        return "not measured: no device events recorded"

    def cold_ms(fn) -> dict:
        """One call of ``fn`` with the chain wrapper's table cache empty:
        CUDA events around it, and the host clock to its return."""
        sweep._PLANS.clear()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        host = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        return {"cold_ms": a.elapsed_time(b), "cold_host_ms": host}

    def chain_smem(x, stages, tile, sweep_axis, wk="ring") -> int:
        """The chain launch's dynamic shared memory (its grids all take
        several sweep steps with a halo, so the window is pipelined)."""
        return sweep_smem_bytes(
            tile, sweep_axis, x.element_size(), pipelined=True,
            stage_halos=[list(zip(s_.lo, s_.hi)) for s_ in stages],
            window_kind=wk)

    def bits_equal(a, b) -> bool:
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.element_size() == 1:
            return bool(torch.equal(a, b))
        view = torch.int16 if a.element_size() == 2 else torch.int32
        return bool(
            torch.equal(a.contiguous().view(view), b.contiguous().view(view))
        )

    def max_err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    def bound(shape, in_itemsize, out_itemsize, n_in, stage_taps) -> dict:
        """The least time for the function on this card: the ``n_in``
        unpadded inputs read once (``in_itemsize`` bytes an element) and
        the output written once (``out_itemsize``) at the HBM rate, or 2
        flops per tap per grid point per stage at the f32 rate, whichever
        is longer.  Zero halos, tile round-up, recomputed overlap and
        boundary correction taps are the port's own work and are not
        counted."""
        n = prod(shape)
        nbytes = n_in * n * in_itemsize + n * out_itemsize
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

    mangled = {torch.float32: "f", torch.bfloat16: "13__nv_bfloat16",
               torch.int8: "a"}

    def ptxas_by_function(name) -> dict:
        """Per function of kernel ``name``'s library, what ``ptxas -v``
        said: registers (entry functions), stack frame and spill bytes."""
        out, cur = {}, None
        for ln in _build.PTXAS.get(name, []):
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)", ln)
            if m:
                cur = out.setdefault(m.group(1), {})
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            if m:
                cur.update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur.update(registers=int(m.group(1)), line=ln)
        return out

    def chain_info(in_dtype, smem) -> dict:
        """Why the chain kernel runs as it does at this launch: threads and
        shared bytes per CTA, CTAs and warps resident per SM (the CUDA
        occupancy query), and ptxas's registers and spills for this
        instantiation, with the spill total over all of them."""
        fns = ptxas_by_function("sweep_chain")
        key = f"sweep_chain_kernelI{mangled[in_dtype]}E"
        mine = [v for k, v in fns.items() if key in k]
        ctas = sweep.chain_occupancy(in_dtype, smem)
        return {
            "threads_per_cta": sweep.CHAIN_THREADS,
            "smem_bytes_per_cta": smem, "ctas_per_sm": ctas,
            "warps_per_sm": ctas * sweep.CHAIN_THREADS // 32,
            "ptxas": mine[0] if mine else "not found",
            "chain_spill_bytes_all_functions": sum(
                v.get("spill_stores", 0) + v.get("spill_loads", 0)
                for v in fns.values()),
        }

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count

    def apply_info(dtype, smem, sweep_axis, ctas) -> dict:
        """Why the apply kernel runs as it does at this launch: threads and
        shared bytes per CTA, CTAs resident per SM (the occupancy query),
        the grid's CTAs in waves of SMs × CTAs per SM, and ptxas's line for
        this instantiation (with the spill total over all of them)."""
        fns = ptxas_by_function("sweep_apply")
        key = f"sweep_apply_kernelI{mangled[dtype]}"
        mine = [v for k, v in fns.items() if key in k]
        exact = [v for k, v in fns.items()
                 if key in k and f"Li{sweep_axis}E" in k]
        per_sm = sweep.apply_occupancy(dtype, sweep_axis, smem)
        return {
            "threads_per_cta": sweep.APPLY_THREADS,
            "smem_bytes_per_cta": smem, "ctas_per_sm": per_sm,
            "warps_per_sm": per_sm * sweep.APPLY_THREADS // 32,
            "ctas": ctas, "waves": ctas / (n_sms * per_sm),
            "ptxas": (exact or mine or ["not found"])[0],
            "apply_spill_bytes_all_functions": sum(
                v.get("spill_stores", 0) + v.get("spill_loads", 0)
                for v in fns.values()),
        }

    def apply_smem(args) -> int:
        """The apply launch's dynamic shared memory (its grids all take
        several sweep steps with a halo, so the window is pipelined)."""
        ins, _, _, lo_w, hi_w, tile, sw, _ = args
        return apply_smem_bytes(tile, sw, ins[0].element_size(),
                                list(zip(lo_w, hi_w)), ins[0].stride(),
                                n_inputs=len(ins), pipelined=True)

    def apply_ctas(shape, tile, sweep_axis) -> int:
        return prod(-(-n // t) for i, (n, t) in enumerate(zip(shape, tile))
                    if i != sweep_axis)

    summary: dict = {}
    gen = torch.Generator(device=dev)
    laps: dict = {}
    t_lap = [time.perf_counter()]

    def lap(name) -> None:
        """Seconds since the previous lap, under ``name``."""
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.BUILD_SECONDS,
          "cached": sorted(set(_build.PTXAS) - set(_build.BUILD_SECONDS)),
          "ptxas": _build.PTXAS,
          "flags": list(_build.NVCC_FLAGS)})

    lap("build")
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
    dev_ms = device_ms(lambda: sweep.sweep_apply(*args),
                       kernel="sweep_apply_kernel")
    info = apply_info(torch.float32, apply_smem(args),
                      0, apply_ctas(shape, tile, 0))
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
        "device_ms": dev_ms, **info,
        "host_ms": host_ms(lambda: sweep.sweep_apply(*args)),
        "copy_ms": copy_ms, "copy_bytes": 2 * ins[0].numel() * 4,
        "plain_ms": plain_ms, "library_ms": lib_ms,
        **bound(shape, 4, 4, 1, [len(w13)]), "bytes_moved": moved,
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
    dev_ms = device_ms(lambda: sweep.sweep_apply(*args),
                       kernel="sweep_apply_kernel")
    info = apply_info(torch.bfloat16, apply_smem(args),
                      0, apply_ctas(shape, tile, 0))
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
        "device_ms": dev_ms, **info,
        "host_ms": host_ms(lambda: sweep.sweep_apply(*args)),
        "plain_ms": plain_ms, "library_ms": lib_ms,
        **bound(shape, 2, 2, 2, [len(w13) + len(w7)]),
        "bytes_moved": moved,
        "card": card_line,
    }
    emit(phase)
    summary["sweep_apply"].append(phase)
    del us, out, oracle, dev_, ins, k_out, p_out, args, xin
    torch.cuda.empty_cache()

    # -- apply_f32_p2_512_sweep1 ---------------------------------------------
    # Two f32 512³ RHS swept along axis 1 (tile roles as above): the
    # 13-point star, and the 7-point star with its taps reversed, an order
    # no compiled shape has, so one launch holds both the compiled and the
    # table-driven tap paths against the plain version.
    gen.manual_seed(7)
    shape = (512, 512, 512)
    tile = (16, 8, 32)
    us = [torch.randn(shape, generator=gen, device=dev) for _ in range(2)]
    offs_r = star_stencil(3, 1)[::-1].copy()
    w_r = [0.25] * 6 + [-1.5]
    reset()
    out = st.multi_stencil_pallas(
        us, [offs13, offs_r], [w13, w_r], tile=tile, sweep_axis=1
    )
    torch.cuda.synchronize()
    launched = counts()
    assert launched["sweep_apply"] >= 1, launched
    assert out.shape == shape and bool(torch.isfinite(out).all())
    # f32 oracle: one sum against two, reassociated: 20 roundings of at
    # most the scale each.
    oracle = (ref.stencil_ref(us[0], offs13, w13)
              + ref.stencil_ref(us[1], offs_r, w_r))
    scale = float(sum(abs(w) for w in list(w13) + w_r)) * max(
        float(us[0].abs().max()), float(us[1].abs().max()))
    oracle_err = max_err(out, oracle)
    assert oracle_err <= 1e-5 * scale, (oracle_err, scale)
    ins, offs, wts, _, lo_w, hi_w = st._launch_inputs(
        us, (spec(offs13, w13), spec(offs_r, w_r)), tile
    )
    args = (ins, offs, wts, lo_w, hi_w, tile, 1, True)
    k_out = sweep.sweep_apply(*args)
    p_out = sweep.sweep_apply_plain(*args)
    torch.cuda.synchronize()
    exact = bits_equal(k_out, p_out)
    err = max_err(k_out, p_out)
    assert exact, err
    kernel_ms = time_ms(lambda: sweep.sweep_apply(*args))
    dev_ms = device_ms(lambda: sweep.sweep_apply(*args),
                       kernel="sweep_apply_kernel")
    info = apply_info(torch.float32, apply_smem(args),
                      1, apply_ctas(shape, tile, 1))
    plain_ms = time_ms(lambda: sweep.sweep_apply_plain(*args), reps=5)
    kern = torch.stack([
        dense_kernel(offs13, w13, 2, torch.float32),
        dense_kernel(offs_r, w_r, 2, torch.float32),
    ])[None]
    xin = torch.stack(us)[None]
    del us
    lib_ms = time_ms(lambda: F.conv3d(xin, kern, padding=2), reps=5)
    phase = {
        "phase": "apply_f32_p2_512_sweep1", "shape": list(shape),
        "tile": list(tile), "sweep_axis": 1, "p": 2, "launches": launched,
        "operators": ["13-point star", "7-point star, taps reversed"],
        "exact_vs_plain": exact, "max_abs_err": err,
        "oracle_max_abs_err": oracle_err, "ms": kernel_ms,
        "device_ms": dev_ms, **info,
        "host_ms": host_ms(lambda: sweep.sweep_apply(*args)),
        "plain_ms": plain_ms, "library_ms": lib_ms,
        **bound(shape, 4, 4, 2, [len(w13) + len(w_r)]),
        "bytes_moved": sum(x.numel() * 4 for x in ins) + k_out.numel() * 4,
        "card": card_line,
    }
    emit(phase)
    summary["sweep_apply"].append(phase)
    del out, oracle, ins, k_out, p_out, args, xin
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
    cargs = (ins[0], stages, lo_w, hi_w, tile, 0, True, "ring", shape)
    dev_ms = device_ms(lambda: sweep.sweep_chain(*cargs))
    cold = cold_ms(lambda: sweep.sweep_chain(*cargs))
    smem = {wk: chain_smem(ins[0], stages, tile, 0, wk)
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
        "ms": times["ring"], "ms_by_window": times, "device_ms": dev_ms,
        **cold, "smem_bytes": smem, "plain_ms": plain_ms, "call_ms": call_ms,
        "unfused_call_ms": unfused_ms, "unfused_tile": [8, 16, 32],
        "unfused_over_fused": unfused_ms / call_ms,
        **chain_info(torch.float32, smem["ring"]),
        "library_ms": None,
        **bound(shape, 4, 4, 1, [len(s_.weights) for s_ in stages]),
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
    dev_ms = device_ms(lambda: sweep.sweep_chain(*cargs))
    cold = cold_ms(lambda: sweep.sweep_chain(*cargs))
    plain_ms = time_ms(lambda: sweep.sweep_chain_plain(*cargs))
    pts = sweep.chain_points(stages, tile, 0, "ring", p_out.shape)
    computed = sum(2 * len(s_.weights) * n for s_, n in zip(stages, pts))
    moved = ins[0].numel() * 4 + k_out.numel() * 4
    phase = {
        "phase": "chain_ragged", "shape": list(shape), "tile": list(tile),
        "sweep_axis": 0, "stages": 2, "launches": launched,
        **chain_info(torch.float32, chain_smem(ins[0], stages, tile, 0)),
        "exact_vs_plain": exact, "max_abs_err": err,
        "oracle_max_abs_err": oracle_err, "ms": kernel_ms,
        "device_ms": dev_ms, **cold,
        "plain_ms": plain_ms, "library_ms": None,
        **bound(shape, 4, 4, 1, [len(s_.weights) for s_ in stages]),
        "bytes_moved": moved, "flops_computed": computed, "card": card_line,
    }
    emit(phase)
    summary["sweep_chain"].append(phase)
    del arrays, out, oracle, ins, k_out, p_out, cargs
    torch.cuda.empty_cache()

    # -- boundary conditions, stage dtypes and int8 frontiers ------------------
    # Each phase runs a program through ir.run_program (or stencil_iterate)
    # under both frontier layouts, then the kernel and its plain version on
    # the launch buffers the host side builds for the same chain.

    def oracle_band(stages_sp, bcs, dtypes, quants, maxima):
        """The documented band of tests/test_program_fuzz.py::_band: f32
        summation-order noise, plus per bf16 stage one bf16 ulp of its
        maximum and per int8 stage one code, each times the downstream
        stages' L1 weight norms (robin: times max(1, |alpha|))."""
        amps = []
        for (_, wts), bc in zip(stages_sp, bcs):
            l1 = float(np.sum(np.abs(wts)))
            if bc is not None and bc[0] == "robin":
                l1 *= max(1.0, abs(float(bc[1][0])))
            amps.append(l1)
        tol = 1e-4 * (1.0 + max(maxima))
        for j in range(len(stages_sp)):
            amp = prod(amps[j + 1:])
            if quants[j] is not None:
                tol += float(quants[j][0]) * amp
            elif dtypes[j] == "bfloat16":
                tol += maxima[j] * 2.0 ** -7 * amp
        return tol

    def iterated_oracle(u, stages_sp, bcs, dtypes, quants):
        """ref.stencil_ref stage by stage with the storage round trips the
        reference fuzzer's _oracle applies; also each stage's max |x|."""
        v = u.float()
        maxima = []
        for (offs_j, wts_j), bc, dt, qn in zip(stages_sp, bcs, dtypes,
                                               quants):
            kind, val = ("zero", 0.0) if bc is None else bc
            v = ref.stencil_ref(v, np.asarray(offs_j), wts_j, boundary=kind,
                                value=val)
            if qn is not None:
                v = ref.dequantize_ref(ref.quantize_ref(v, *qn), *qn)
            elif dt == "bfloat16":
                v = v.to(torch.bfloat16).float()
            maxima.append(float(v.abs().max()))
        return v, maxima

    def chain_phase(name, u, tile, main_call, stages_sp, bcs=None,
                    dtypes=None, quants=None, library=None, windows=None,
                    extra=None, without=None, sweep_axis=0):
        """Drive ``main_call(window_kind)`` (the user's entry point), check
        it against the iterated oracle within its band and ring against
        trapezoid, then the kernel against its plain version on the launch
        buffers, and time kernel, plain version, call and library call.
        ``without`` names what to leave out of one more timing of the
        kernel on the same grid (``"boundary"`` or ``"quantization"``):
        what the left-out part costs."""
        T = len(stages_sp)
        bcs = bcs or (None,) * T
        dtypes = dtypes or (None,) * T
        quants = quants or (None,) * T
        windows = windows or ("ring", "trapezoid")
        shape = tuple(u.shape)
        outs, launched = {}, {}
        for wk in windows:
            reset()
            outs[wk] = main_call(wk)
            torch.cuda.synchronize()
            launched[wk] = counts()
            assert launched[wk]["sweep_chain"] >= 1, (name, launched)
        out = outs[windows[0]]
        ring_eq_trap = all(bits_equal(outs[wk], out) for wk in windows)
        assert ring_eq_trap, name
        assert out.shape == shape and bool(torch.isfinite(out.float()).all())
        oracle, maxima = iterated_oracle(u, stages_sp, bcs, dtypes, quants)
        band = oracle_band(stages_sp, bcs, dtypes, quants, maxima)
        oracle_err = max_err(out, oracle)
        assert oracle_err <= band, (name, oracle_err, band)
        del oracle, outs
        torch.cuda.empty_cache()
        stages_w = tuple(spec(o, w) for o, w in stages_sp)
        eff = tuple(dt or "float32" for dt in dtypes)
        ins, _, _, stages, lo_w, hi_w = st._launch_inputs(
            [u], stages_w[:1], tile, stages_w,
            bcs_w=bcs if any(b is not None for b in bcs) else None,
            dtypes_w=eff if any(dt != "float32" for dt in eff) else None,
            quants_w=quants if any(q is not None for q in quants) else None,
        )
        sw = sweep_axis
        p_out = sweep.sweep_chain_plain(ins[0], stages, lo_w, hi_w, tile, sw,
                                        True, windows[0], shape)
        times, exact, err = {}, True, 0.0
        for wk in windows:
            cargs = (ins[0], stages, lo_w, hi_w, tile, sw, True, wk, shape)
            k_out = sweep.sweep_chain(*cargs)
            torch.cuda.synchronize()
            exact &= bits_equal(k_out, p_out)
            err = max(err, max_err(k_out, p_out))
            times[wk] = time_ms(lambda: sweep.sweep_chain(*cargs))
            del k_out
        assert exact, (name, err)
        cargs = (ins[0], stages, lo_w, hi_w, tile, sw, True, windows[0],
                 shape)
        dev_ms = device_ms(lambda: sweep.sweep_chain(*cargs))
        cold = cold_ms(lambda: sweep.sweep_chain(*cargs))
        plain_ms = time_ms(lambda: sweep.sweep_chain_plain(*cargs), reps=3,
                           warmup=1)
        without_ms = None
        if without is not None:
            field = {"boundary": "bc", "quantization": "quant"}[without]
            bare = tuple(s_._replace(**{field: None}) for s_ in stages)
            if without == "quantization":
                bare = tuple(s_._replace(dtype=None) for s_ in bare)
            bargs = (ins[0], bare, lo_w, hi_w, tile, sw, True, windows[0],
                     shape)
            without_ms = time_ms(lambda: sweep.sweep_chain(*bargs))
            without_dev = device_ms(lambda: sweep.sweep_chain(*bargs))
        call_ms = time_ms(lambda: main_call(windows[0]), reps=5)
        lib_ms = lib_diff = None
        if library is not None:
            lib_fn, lib_check = library
            lib_ms = time_ms(lib_fn)
            lib_diff = lib_check()
        pts = sweep.chain_points(stages, tile, sw, windows[0], p_out.shape)
        computed = sum(2 * len(s_.weights) * n for s_, n in zip(stages, pts))
        phase = {
            "phase": name, "shape": list(shape), "tile": list(tile),
            "sweep_axis": sw, "stages": T,
            "boundaries": [list(b) if b else None for b in bcs],
            "dtypes": list(eff), "quants": [list(q) if q else None
                                            for q in quants],
            "launches": launched, "ring_equals_trapezoid": ring_eq_trap,
            "exact_vs_plain": exact, "max_abs_err": err,
            "oracle_max_abs_err": oracle_err, "oracle_band": band,
            "ms": times[windows[0]], "ms_by_window": times,
            "device_ms": dev_ms, **cold,
            "plain_ms": plain_ms, "call_ms": call_ms, "library_ms": lib_ms,
            "library_max_abs_diff": lib_diff,
            **({f"ms_without_{without}": without_ms,
                f"device_ms_without_{without}": without_dev}
               if without else {}),
            **({"boundary_share": (times[windows[0]] - without_ms)
                / times[windows[0]]} if without == "boundary" else {}),
            **({"boundary_share_device": (dev_ms - without_dev) / dev_ms}
               if without == "boundary" and isinstance(dev_ms, float)
               and isinstance(without_dev, float) else {}),
            **chain_info(ins[0].dtype, chain_smem(ins[0], stages, tile, sw,
                                                  windows[0])),
            **bound(shape, u.element_size(), p_out.element_size(), 1,
                    [len(s_.weights) for s_ in stages]),
            "bytes_moved": ins[0].numel() * ins[0].element_size()
            + p_out.numel() * p_out.element_size(),
            "flops_computed": computed, "card": card_line,
        }
        phase.update(extra or {})
        del ins, p_out
        torch.cuda.empty_cache()
        return phase

    def conv_module(offsets, weights, r, mode):
        """nn.Conv3d with a padding mode: the one PyTorch call that applies
        this operator once under that boundary (TF32 off)."""
        conv = torch.nn.Conv3d(1, 1, 2 * r + 1, padding=r, padding_mode=mode,
                               bias=False).to(dev)
        with torch.no_grad():
            conv.weight.copy_(dense_kernel(offsets, weights, r,
                                           torch.float32)[None, None])
        return conv

    def run_prog(prog, u, tile):
        return lambda wk: ir.run_program(prog, u, tile=tile, sweep_axis=0,
                                         window_kind=wk)

    big = (512, 512, 512)

    # chain_T3_512_sweep1: chain_T3_512's chain and tile roles, swept along
    # axis 1 (the table-driven tap loop), and chain_bf16_T3_512: the same
    # chain on a bf16 grid.
    gen.manual_seed(2)
    u = torch.randn(big, generator=gen, device=dev)
    phase = chain_phase(
        "chain_T3_512_sweep1", u, (16, 4, 32),
        lambda wk: st.stencil_iterate(u, offs13, w13, 3, tile=(16, 4, 32),
                                      sweep_axis=1, window_kind=wk),
        [(offs13, w13)] * 3, windows=("ring",), sweep_axis=1,
        extra={"compare_with": "chain_T3_512 (compiled star at sweep 0)"})
    emit(phase)
    summary["sweep_chain"].append(phase)
    ub = u.to(torch.bfloat16)
    del u
    torch.cuda.empty_cache()
    phase = chain_phase(
        "chain_bf16_T3_512", ub, (4, 16, 32),
        lambda wk: st.stencil_iterate(ub, offs13, w13, 3, tile=(4, 16, 32),
                                      sweep_axis=0, window_kind=wk),
        [(offs13, w13)] * 3, dtypes=("bfloat16",) * 3, windows=("ring",))
    emit(phase)
    summary["sweep_chain"].append(phase)
    del ub
    torch.cuda.empty_cache()

    # bc_neumann_apply_512: one application under neumann, T = 1 chain form.
    gen.manual_seed(4)
    u = torch.randn(big, generator=gen, device=dev)
    bcs = (("neumann", 0.0),)
    prog = ir.chain_program([(offs13, w13)], 3, boundary="neumann")
    conv = conv_module(offs13, w13, 2, "replicate")
    with torch.no_grad():
        lib = (lambda: conv(u[None, None]),
               lambda: max_err(conv(u[None, None])[0, 0],
                               ir.run_program(prog, u, tile=(8, 16, 32),
                                              sweep_axis=0)))
        phase = chain_phase("bc_neumann_apply_512", u, (8, 16, 32),
                            run_prog(prog, u, (8, 16, 32)),
                            [(offs13, w13)], bcs=bcs, library=lib,
                            windows=("ring",), without="boundary")
    emit(phase)
    summary["sweep_chain"].append(phase)

    # chain_periodic_T3_512: three periodic applications.
    prog = ir.chain_program([(offs13, w13)] * 3, 3, boundary="periodic")
    conv = conv_module(offs13, w13, 2, "circular")
    with torch.no_grad():
        lib = (lambda: conv(u[None, None]),
               lambda: max_err(conv(u[None, None])[0, 0],
                               ref.stencil_ref(u, offs13, w13, "periodic")))
        phase = chain_phase("chain_periodic_T3_512", u, (4, 16, 32),
                            run_prog(prog, u, (4, 16, 32)),
                            [(offs13, w13)] * 3,
                            bcs=(("periodic", 0.0),) * 3, library=lib,
                            extra={"library_covers": "one of 3 applications"})
    emit(phase)
    summary["sweep_chain"].append(phase)
    del conv, lib
    torch.cuda.empty_cache()

    # chain_dtypes_512: bf16 frontiers, f32 result, through stencil_iterate.
    dts = ("bfloat16", "bfloat16", "float32")
    phase = chain_phase(
        "chain_dtypes_512", u, (4, 16, 32),
        lambda wk: st.stencil_iterate(u, offs13, w13, 3, tile=(4, 16, 32),
                                      sweep_axis=0, window_kind=wk,
                                      dtypes=list(dts)),
        [(offs13, w13)] * 3, dtypes=dts)
    assert phase["dtypes"] == list(dts)
    emit(phase)
    summary["sweep_chain"].append(phase)

    # chain_int8_512: stages 0 and 1 quantized, reflect boundary.  The grid
    # amplitude puts the stage values on the int8 grid of scale 0.02
    # (|x| up to ~2.5) rather than saturating it.
    u8 = u * 0.01
    del u
    torch.cuda.empty_cache()
    q = (0.02, 3)
    quants = (q, q, None)
    prog = ir.chain_program([(offs13, w13)] * 3, 3, boundary="reflect",
                            quants=list(quants))
    lowered = ir.lower(prog, big)
    assert lowered.dtypes == ("int8", "int8", None), lowered.dtypes
    bcs = (("reflect", 0.0),) * 3
    # The same chain in two launches: stages 0-1 store int8 codes, stage 2
    # reads them back through in_quant.
    sw = (spec(offs13, w13),) * 3
    tile = (4, 16, 32)

    def split():
        codes = st._stencil_call((u8,), sw[:1], tile, 0, True,
                                 stages_w=sw[:2], bcs_w=bcs[:2],
                                 dtypes_w=("int8", "int8"),
                                 quants_w=(q, q))
        return codes, st._stencil_call((codes,), sw[2:], tile, 0, True,
                                       stages_w=sw[2:], bcs_w=bcs[2:],
                                       dtypes_w=("float32",), in_quant=q)

    reset()
    codes, split_out = split()
    torch.cuda.synchronize()
    split_launched = counts()
    assert split_launched["sweep_chain"] == 2, split_launched
    assert codes.dtype == torch.int8 and split_out.dtype == torch.float32
    fused = ir.run_program(prog, u8, tile=tile, sweep_axis=0)
    split_equals_fused = bits_equal(split_out, fused)
    assert split_equals_fused
    del fused, split_out
    # The in_quant launch alone: int8 codes in, f32 out.
    ins, _, _, stages, lo_w, hi_w = st._launch_inputs(
        [codes], sw[2:], tile, sw[2:], bcs_w=bcs[2:],
        dtypes_w=("float32",), in_quant=q)
    cargs = (ins[0], stages, lo_w, hi_w, tile, 0, True, "ring", big, None, q)
    k_out = sweep.sweep_chain(*cargs)
    p_out = sweep.sweep_chain_plain(*cargs)
    torch.cuda.synchronize()
    iq_exact = bits_equal(k_out, p_out)
    assert iq_exact, max_err(k_out, p_out)
    in_quant_launch = {
        "launches": split_launched, "split_equals_fused": split_equals_fused,
        "exact_vs_plain": iq_exact, "max_abs_err": max_err(k_out, p_out),
        "ms": time_ms(lambda: sweep.sweep_chain(*cargs)),
        "device_ms": device_ms(lambda: sweep.sweep_chain(*cargs)),
        **cold_ms(lambda: sweep.sweep_chain(*cargs)),
        "plain_ms": time_ms(lambda: sweep.sweep_chain_plain(*cargs), reps=3,
                            warmup=1),
        **bound(big, 1, 4, 1, [len(w13)]),
        **chain_info(torch.int8, chain_smem(ins[0], stages, tile, 0)),
    }
    del ins, k_out, p_out, cargs, codes
    torch.cuda.empty_cache()
    phase = chain_phase("chain_int8_512", u8, tile,
                        run_prog(prog, u8, tile), [(offs13, w13)] * 3,
                        bcs=bcs, dtypes=("int8", "int8", None),
                        quants=quants,
                        extra={"in_quant_launch": in_quant_launch,
                               "grid_scale": 0.01},
                        without="quantization")
    phase["launches"]["split"] = split_launched
    emit(phase)
    summary["sweep_chain"].append(phase)
    del u8
    torch.cuda.empty_cache()

    # chain_mixed_bc_256: per-stage boundaries, box corners, robin.
    gen.manual_seed(5)
    u = torch.randn((256, 256, 256), generator=gen, device=dev)
    box27 = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                      for k in (-1, 0, 1)])
    w_box = [0.5 if not any(o) else 0.5 / 26 for o in box27.tolist()]
    w_jac = [1.0 / 3.0] + [1.0 / 9.0] * 6  # omega = 2/3 on the 7-point star
    mixed = [(offs7, w_jac), (box27, w_box)]
    bcs = (("dirichlet", 0.5), ("robin", (0.7, 0.3)))
    prog = ir.chain_program(mixed, 3, boundary=list(bcs))
    phase = chain_phase("chain_mixed_bc_256", u, (8, 16, 32),
                        run_prog(prog, u, (8, 16, 32)), mixed, bcs=bcs)
    emit(phase)
    summary["sweep_chain"].append(phase)
    del u
    torch.cuda.empty_cache()

    lap("hand-tiled stencil phases")
    # -- planned phases: tile=None through the plan compiler ---------------
    # Each drives the public entry point without a tile, so the default
    # planner decides tile, sweep axis, window kind and fusion depth for
    # this card; holds the output bit-equal to the same launches run by the
    # plain versions; and times it beside the hand-picked phase above.
    planner = default_planner()
    seen_plans: list = []
    plan_fn = planner.plan

    def recording_plan(request=None, /, **kw):
        p = plan_fn(request, **kw)
        seen_plans.append(p)
        return p

    planner.plan = recording_plan
    hardware = sweep.hopper_device(dev)
    emit({"phase": "hopper_device", **dataclasses.asdict(hardware),
          "card": card_line})

    def plain_binder(ins, *args, padded=True):
        """``bind_apply``'s seam, binding the plain apply instead."""
        return lambda bufs: sweep.sweep_apply_plain(bufs, *args,
                                                    padded=padded)

    def plain_versions(fn):
        """``fn()`` with the frontend's kernels swapped for their plain
        versions at the seams its launches reach them through (a plain
        application's binder, the padded apply of a sharded launch, the
        chain's wrapper): the same launches at the same planned decision
        (the call memo emptied before, so that no bound launch serves
        it, and after, so that no plain launch serves a later call).  The
        run must enqueue no apply or chain kernel."""
        kernels_n = ("launches.sweep_apply", "launches.sweep_chain")
        saved = st.bind_apply, st.sweep_apply, st.sweep_chain
        st.bind_apply, st.sweep_apply, st.sweep_chain = (
            plain_binder, sweep.sweep_apply_plain, sweep.sweep_chain_plain)
        st._CALL_MEMO.clear()
        before = [obs.totals()[k] for k in kernels_n]
        try:
            out = fn()
        finally:
            st.bind_apply, st.sweep_apply, st.sweep_chain = saved
            st._CALL_MEMO.clear()
        assert [obs.totals()[k] for k in kernels_n] == before, \
            "the plain versions' run launched a kernel"
        return out

    def by_name(name):
        return next(ph for phs in summary.values() for ph in phs
                    if ph["phase"] == name)

    def planned_phase(name, call, hand_name, hand_ms, compare, extra=None):
        """Drive ``call()`` (no tile), check it, time it; ``compare``
        names the metric held against ``hand_ms`` (the hand-picked
        phase's, same run)."""
        seen_plans.clear()
        reset()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        first_call_s = time.perf_counter() - t0
        launched = counts()
        assert seen_plans, name
        plan = seen_plans[-1]
        assert launched[f"sweep_{plan.kernel}"] >= 1, (name, launched)
        n_launch = -(-plan.time_steps // plan.fused_depth)
        assert sum(launched.values()) == n_launch, (name, launched)
        assert bool(torch.isfinite(out.float()).all())
        plain = plain_versions(call)
        exact = bits_equal(out, plain)
        err = max_err(out, plain)
        assert exact, (name, err)
        del plain
        torch.cuda.empty_cache()
        reset()
        call_ms = time_ms(call, reps=5)
        # Its two warm-up calls and five timed ones launched the kernels.
        timed = counts()
        assert timed == {k: 7 * n for k, n in launched.items()}, (name, timed)
        dev_one = device_ms(call, reps=3, kernel=f"sweep_{plan.kernel}_kernel")
        dev_call = (dev_one * n_launch if isinstance(dev_one, float)
                    else dev_one)
        measured = {"device_ms": dev_call, "call_ms": call_ms}[compare]
        phase = {
            "phase": name, "shape": list(out.shape),
            "plan": {"tile": list(plan.tile), "sweep_axis": plan.sweep_axis,
                     "fused_depth": plan.fused_depth,
                     "window_kind": plan.window_kind, "kernel": plan.kernel,
                     "smem_bytes_per_cta": plan.vmem_bytes,
                     "ctas_per_sm": plan.ctas_per_sm, "waves": plan.waves,
                     "modeled_ms": plan.modeled_ms,
                     "depth_ms": [list(r) for r in plan.depth_ms],
                     "legacy_modeled_ms": plan.legacy_modeled_ms},
            "launches": launched, "launches_per_call": n_launch,
            "exact_vs_plain": exact, "max_abs_err": err,
            "device_ms": dev_call, "device_ms_per_launch": dev_one,
            "call_ms": call_ms, "first_call_s": first_call_s,
            "hand_picked": hand_name, "hand_ms": hand_ms,
            "compared": compare,
            "planned_over_hand": (measured / hand_ms
                                  if isinstance(measured, float) else None),
            "modeled_over_measured": (plan.modeled_ms / measured
                                      if isinstance(measured, float)
                                      and compare == "device_ms" else None),
            "card": card_line,
        }
        phase.update(extra or {})
        return phase, out

    # planned_apply_f32_512: apply_f32_512's call without its tile.
    gen.manual_seed(0)
    u = torch.randn(big, generator=gen, device=dev)
    hand = summary["sweep_apply"][0]
    phase, out = planned_phase(
        "planned_apply_f32_512", lambda: st.stencil_pallas(u, offs13, w13),
        "apply_f32_512", hand["device_ms"], "device_ms")
    hand_out = st.stencil_pallas(u, offs13, w13, tile=(8, 16, 32),
                                 sweep_axis=0)
    phase["equals_hand_picked"] = bits_equal(out, hand_out)
    phase.update(**bound(big, 4, 4, 1, [len(w13)]), library_ms=None,
                 plain_ms=None, ms=phase["call_ms"])
    emit(phase)
    summary["sweep_apply"].append(phase)
    del out, hand_out
    torch.cuda.empty_cache()

    # planned_chain_T3_512: chain_T3_512's call without its tile, against
    # the faster of its fused call and three single applications.
    gen.manual_seed(2)
    u = torch.randn(big, generator=gen, device=dev)
    hand = summary["sweep_chain"][0]
    best = min(hand["call_ms"], hand["unfused_call_ms"])
    phase, out = planned_phase(
        "planned_chain_T3_512",
        lambda: st.stencil_iterate(u, offs13, w13, 3),
        "chain_T3_512" if best == hand["call_ms"]
        else "chain_T3_512 unfused", best, "call_ms",
        extra={"hand_fused_call_ms": hand["call_ms"],
               "hand_unfused_call_ms": hand["unfused_call_ms"]})
    hand_out = st.stencil_iterate(u, offs13, w13, 3, tile=(4, 16, 32),
                                  sweep_axis=0)
    phase["equals_hand_picked"] = bits_equal(out, hand_out)
    phase.update(**bound(big, 4, 4, 1, [len(w13)] * 3), library_ms=None,
                 plain_ms=None, ms=phase["call_ms"])
    emit(phase)
    summary["sweep_chain"].append(phase)
    del out, hand_out, u
    torch.cuda.empty_cache()

    # planned_chain_int8_512: the int8 reflect chain without its tile; a
    # plan whose depth is below 3 hands int8 codes from launch to launch.
    gen.manual_seed(4)
    u8 = torch.randn(big, generator=gen, device=dev) * 0.01
    prog = ir.chain_program([(offs13, w13)] * 3, 3, boundary="reflect",
                            quants=[q, q, None])
    hand = by_name("chain_int8_512")
    phase, out = planned_phase(
        "planned_chain_int8_512", lambda: ir.run_program(prog, u8),
        "chain_int8_512", hand["call_ms"], "call_ms")
    fused = ir.run_program(prog, u8, tile=(4, 16, 32), sweep_axis=0)
    phase["equals_fused"] = bits_equal(out, fused)
    assert phase["equals_fused"]
    phase.update(**bound(big, 4, 4, 1, [len(w13)] * 3), library_ms=None,
                 plain_ms=None, ms=phase["call_ms"])
    emit(phase)
    summary["sweep_chain"].append(phase)
    del out, fused, u8
    torch.cuda.empty_cache()

    # planned_apply_bf16_p2_256: apply_bf16_p2_256's call without its tile.
    gen.manual_seed(1)
    us = [torch.randn((256,) * 3, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2)]
    hand = summary["sweep_apply"][1]
    phase, out = planned_phase(
        "planned_apply_bf16_p2_256",
        lambda: st.multi_stencil_pallas(us, [offs13, offs7], [w13, w7]),
        "apply_bf16_p2_256", hand["device_ms"], "device_ms")
    hand_out = st.multi_stencil_pallas(us, [offs13, offs7], [w13, w7],
                                       tile=(8, 16, 32), sweep_axis=0)
    phase["equals_hand_picked"] = bits_equal(out, hand_out)
    phase.update(**bound((256,) * 3, 2, 2, 2, [len(w13) + len(w7)]),
                 library_ms=None, plain_ms=None, ms=phase["call_ms"])
    emit(phase)
    summary["sweep_apply"].append(phase)
    del out, hand_out, us
    torch.cuda.empty_cache()

    lap("planned phases")
    # -- tuned phases: tune=True through the measured tune loop ------------
    # Each makes the call of a planned phase with tune=True (the default
    # tuner: k=4, reps=5, warmup=1, records in this run's directory).  The
    # first call races the candidates on the kernels and serves the
    # winner; the output equals the same launches on the plain versions;
    # the warm call serves the record without measuring; the winner is
    # re-measured against candidate 0 (the analytic plan) in 20 alternating
    # rounds of 10 calls each, since one call's spread reaches 13% and a
    # 256^3 bf16 call takes about 0.25 ms, where a host stall moves a round
    # by a fifth (PERF.md §6): with 6 rounds of 5 the median ratio of two
    # near-equal plans once passed 1.05 on the card.
    gates: list = []

    def tuned_phase(name, call, kernel, extra=None):
        """``call(**kw)`` is the user's call; ``kw`` adds ``tune=True`` or
        a ``plan=``."""
        tuner = resolve_tuner(True, dev)
        reset()
        t0 = time.perf_counter()
        out = call(tune=True)
        torch.cuda.synchronize()
        race_s = time.perf_counter() - t0
        first = counts()
        rec = tuner.last_record
        measured_first = not tuner.last_plan_tuned
        assert rec is not None and rec.never_slower, name
        plain = plain_versions(lambda: call(tune=True))
        exact = bits_equal(out, plain)
        err = max_err(out, plain)
        assert exact, (name, err)
        del plain
        # The warm call, traced: one tunedb_hit, no measurement, and no
        # launch while the tuner plans.
        plan_fn = tuner.plan
        in_plan = []

        def watched(*a, **kw):
            before = counts()
            t = time.perf_counter()
            p_ = plan_fn(*a, **kw)
            in_plan.append(((time.perf_counter() - t) * 1e3,
                            sum(counts().values()) - sum(before.values())))
            return p_

        tuner.plan = watched
        try:
            reset()
            with obs.recording() as rec_obs:
                call(tune=True)
            torch.cuda.synchronize()
            warm = counts()
            warm_counters = dict(rec_obs.counters)
            warm_measured = sum(1 for sp in rec_obs.spans
                                if sp.name == "measure")
            in_plan.clear()
            for _ in range(20):
                call(tune=True)
            torch.cuda.synchronize()
        finally:
            tuner.plan = plan_fn
        warm_ms = [ms for ms, _ in in_plan]
        warm_ok = (tuner.last_plan_tuned
                   and warm_counters.get("tunedb_hit") == 1
                   and "tunedb_miss" not in warm_counters
                   and warm_measured == 0
                   and all(n == 0 for _, n in in_plan)
                   and statistics.median(warm_ms) < 1.0)
        # tuned over analytic: alternating rounds of the two plans.
        winner = rec.winner_plan
        analytic = tuner.planner._analytic(winner.request)
        ratios = []
        for i in range(20):
            order = (("w", winner), ("a", analytic))
            times = {}
            for label, pl in (order if i % 2 == 0 else order[::-1]):
                times[label] = time_ms(lambda: call(plan=pl), reps=10,
                                       warmup=2)
            ratios.append(times["w"] / times["a"])
        tuned_over = statistics.median(ratios)
        ok = (exact and measured_first and warm_ok and tuned_over <= 1.05)
        gates.append((name, ok, {
            "exact": exact, "first_call_measured": measured_first,
            "warm_ok": warm_ok, "warm_plan_host_ms": statistics.median(
                warm_ms), "tuned_over_analytic": tuned_over}))
        rows_ = [{
            "tile": list(c.tile), "sweep_axis": c.sweep_axis,
            "fused_depth": c.fused_depth, "window_kind": c.window_kind,
            "stage_dtypes": (list(c.stage_dtypes) if c.stage_dtypes
                             else None),
            "advisory": c.advisory, "modeled_ms": c.modeled_ms,
            "median_ms": c.median_s * 1e3, "iqr_ms": c.iqr_s * 1e3,
            "modeled_over_measured": c.modeled_ms / (c.median_s * 1e3),
        } for c in rec.candidates]
        phase = {
            "phase": name, "shape": list(out.shape),
            "launches": {"first_call": first, "warm_call": warm},
            "candidates": rows_, "winner_rank": rec.winner,
            "winner_is_analytic": rec.winner == 0,
            "speedup_vs_analytic": rec.speedup_vs_analytic,
            "rank_correlation": rec.rank_correlation,
            "race_s": race_s, "first_call_measured": measured_first,
            "fingerprint": rec.fingerprint,
            "exact_vs_plain": exact, "max_abs_err": err,
            "warm_plan_host_ms": statistics.median(warm_ms),
            "warm_plan_host_ms_max": max(warm_ms),
            "warm_tunedb_hit": warm_counters.get("tunedb_hit", 0),
            "warm_measure_spans": warm_measured,
            "warm_launches_in_planning": max(n for _, n in in_plan),
            "tuned_over_analytic": tuned_over,
            "tuned_over_analytic_rounds": ratios,
            "gates_ok": ok, "kernel": kernel, "card": card_line,
        }
        phase.update(extra or {})
        emit(phase)
        del out
        torch.cuda.empty_cache()
        return phase

    gen.manual_seed(0)
    u = torch.randn(big, generator=gen, device=dev)
    phase = tuned_phase(
        "tuned_apply_f32_512",
        lambda **kw: st.stencil_pallas(u, offs13, w13, **kw), "sweep_apply")
    phase.update(**bound(big, 4, 4, 1, [len(w13)]), library_ms=None,
                 plain_ms=None, ms=None)
    summary["sweep_apply"].append(phase)

    gen.manual_seed(2)
    u = torch.randn(big, generator=gen, device=dev)
    phase = tuned_phase(
        "tuned_chain_T3_512",
        lambda **kw: st.stencil_iterate(u, offs13, w13, 3, **kw),
        "sweep_apply, sweep_chain (advisory variants)")
    assert {tuple(c["stage_dtypes"] or ()) for c in phase["candidates"]} \
        >= {("bfloat16", "bfloat16", None), ("int8", "int8", None)}, phase
    phase.update(**bound(big, 4, 4, 1, [len(w13)] * 3), library_ms=None,
                 plain_ms=None, ms=None)
    summary["sweep_chain"].append(phase)
    del u
    torch.cuda.empty_cache()

    gen.manual_seed(4)
    u8 = torch.randn(big, generator=gen, device=dev) * 0.01
    prog = ir.chain_program([(offs13, w13)] * 3, 3, boundary="reflect",
                            quants=[q, q, None])
    phase = tuned_phase(
        "tuned_chain_int8_512",
        lambda **kw: ir.run_program(prog, u8, **kw), "sweep_chain")
    # A dtyped request is its own dtype assignment: no dtype variant races.
    assert not any(c["advisory"] for c in phase["candidates"]), phase
    phase.update(**bound(big, 4, 4, 1, [len(w13)] * 3), library_ms=None,
                 plain_ms=None, ms=None)
    summary["sweep_chain"].append(phase)
    del u8
    torch.cuda.empty_cache()

    gen.manual_seed(1)
    us = [torch.randn((256,) * 3, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2)]
    phase = tuned_phase(
        "tuned_apply_bf16_p2_256",
        lambda **kw: st.multi_stencil_pallas(us, [offs13, offs7],
                                             [w13, w7], **kw),
        "sweep_apply")
    phase.update(**bound((256,) * 3, 2, 2, 2, [len(w13) + len(w7)]),
                 library_ms=None, plain_ms=None, ms=None)
    summary["sweep_apply"].append(phase)
    del us
    torch.cuda.empty_cache()

    lap("tuned phases")
    # -- traced_calls: trace= under torch.profiler -----------------------------
    # apply_f32_512's call and the planned int8 chain, each with trace=.
    # The trace passes validate_trace and reconciles; its kernel_launch
    # spans equal the wrappers' launch counts; and each span's
    # record_function range holds the sweep kernel it launched in the
    # profiler's trace.  Span durations are host time (the enqueue), never
    # read as kernel time here.
    from torch.profiler import ProfilerActivity, profile

    trace_dir = Path(state.name)

    def traced(name, call):
        path = str(trace_dir / f"{name}.json")
        prof_path = str(trace_dir / f"{name}.prof.json")
        call()
        torch.cuda.synchronize()
        reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # The profiler drops the first device activity of a session
            # here (a traced chain's first fill has no kernel record), and
            # a call on the caller's grid launches its kernel alone: a
            # throwaway kernel outside any kernel_launch range goes first.
            torch.zeros(1, device=dev)
            call(trace=path)
            torch.cuda.synchronize()
        launched = counts()
        prof.export_chrome_trace(prof_path)
        doc = obs.load_trace(path)   # validate_trace on the way in
        summ = summarize(doc)
        problems = reconcile(summ)
        n_spans = len(summ["launches"])
        with open(prof_path) as fh:
            events = json.load(fh)["traceEvents"]
        held = spans_hold_kernels(events)
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.report", path,
             "--check"],
            env={**os.environ, "PYTHONPATH": str(SRC)},
            capture_output=True, text=True, timeout=300)
        ok = (not problems and n_spans == sum(launched.values())
              and cli.returncode == 0
              and held.get("every_span_holds_its_kernel") is True)
        gates.append((name, ok, {
            "reconcile_problems": problems, "kernel_launch_spans": n_spans,
            "launches": launched, "report_check_rc": cli.returncode}))
        return {
            "call": name, "launches": launched, "kernel_launch_spans": n_spans,
            "reconcile_problems": problems, "report_check_rc": cli.returncode,
            "counters": summ["counters"], "plan_spans": summ["n_plan_spans"],
            "span_kernels": held, "ok": ok,
        }

    def spans_hold_kernels(events) -> dict:
        """Match each ``kernel_launch`` range of the profiler's trace to the
        device kernels it launched: the ``cudaLaunchKernel`` calls inside
        the range, and the kernels of their correlation ids."""
        ranges = [e for e in events if e.get("name") == "kernel_launch"
                  and e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"]
        if not ranges:
            return {"not_measured": "no kernel_launch range in the "
                    "profiler's trace"}
        on_device = sum(1 for e in events if e.get("name") == "kernel_launch"
                        and e.get("cat") == "gpu_user_annotation")
        by_corr = {(k.get("args") or {}).get("correlation"): k["name"]
                   for k in events if k.get("cat") == "kernel"}
        launches = [e for e in events if e.get("cat") == "cuda_runtime"
                    and "LaunchKernel" in e.get("name", "")]
        rows = []
        for r in ranges:
            t0_, t1_ = r["ts"], r["ts"] + r["dur"]
            names = [by_corr.get((e.get("args") or {}).get("correlation"), "")
                     for e in launches if t0_ <= e["ts"] <= t1_]
            rows.append([n for n in names if "sweep_" in n])
        return {
            "ranges": len(ranges), "device_side_ranges": on_device,
            "sweep_kernels_per_range": [len(r) for r in rows],
            "kernel_names": sorted({n[:60] for r in rows for n in r}),
            "every_span_holds_its_kernel": all(len(r) == 1 for r in rows),
        }

    gen.manual_seed(0)
    u = torch.randn(big, generator=gen, device=dev)
    apply_call = lambda **kw: st.stencil_pallas(  # noqa: E731
        u, offs13, w13, tile=(8, 16, 32), sweep_axis=0, **kw)
    apply_traced = traced("apply_f32_512", apply_call)
    untraced_ms = time_ms(apply_call, reps=10)
    traced_ms = time_ms(
        lambda: apply_call(trace=str(trace_dir / "timed.json")), reps=10)
    del u
    torch.cuda.empty_cache()
    gen.manual_seed(4)
    u8 = torch.randn(big, generator=gen, device=dev) * 0.01
    chain_traced = traced(
        "planned_chain_int8_512",
        lambda **kw: ir.run_program(prog, u8, **kw))
    del u8
    torch.cuda.empty_cache()
    emit({"phase": "traced_calls", "calls": [apply_traced, chain_traced],
          "apply_untraced_call_ms": untraced_ms,
          "apply_traced_call_ms": traced_ms,
          "trace_cost_ms": traced_ms - untraced_ms, "card": card_line})

    lap("traced_calls")
    # -- sharded phases: column sharding over a 4-shard mesh on this card ----
    # Each phase runs a call of an earlier phase on an explicit mesh of 4
    # shards that share this card (a mesh never co-locates shards on its
    # own), launching in order on the current stream.  Each holds the
    # output bit-equal to the same call unsharded and to the same sharded
    # launches on the plain versions; times the sharded and the unsharded
    # call (CUDA events around one frontend call); splits the sharded
    # call's device time into the slab launches (the sweep kernels) and
    # the rest (fills, scatter, exchange, gather), and times each launch's
    # halo exchange alone on the buffers it ran on; and reads the
    # exchange counters of a traced call against the plan (or, at an
    # explicit tile, against the launch geometry).
    from repro_torch.launch.mesh import make_column_mesh
    from repro_torch.parallel import shard_columns as sc
    from repro_torch.plan import AutoTuner

    one_card = torch.device("cuda", torch.cuda.current_device())
    mesh4 = make_column_mesh(4, devices=[one_card] * 4)

    def device_split(fn, reps=3) -> dict:
        """Device ms of one call of ``fn`` (mean of ``reps``) from
        ``torch.profiler``: the sweep kernels, and every other device
        event (fills and copies)."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if not evs:
            miss = "not measured: no device events recorded"
            return {"slab_device_ms": miss, "other_device_ms": miss}
        kern = [e.time_range.elapsed_us() for e in evs if "sweep_" in e.name]
        other = [e.time_range.elapsed_us() for e in evs
                 if "sweep_" not in e.name]
        return {"slab_device_ms": sum(kern) / 1e3 / reps,
                "slab_launches_per_call": len(kern) / reps,
                "other_device_ms": sum(other) / 1e3 / reps,
                "other_events_per_call": len(other) / reps}

    def exchanges(fn) -> dict:
        """The halo exchanges of one call of ``fn``: each launch's
        ``exchange_halos`` captured, then replayed alone on the buffers it
        ran on under ``torch.profiler`` (mean of 5 replays); the bytes its
        copies move; and the launches' geometry."""
        seen = []
        real = sc.exchange_halos

        def spy(bufs, g):
            seen.append((bufs, g))
            return real(bufs, g)

        sc.exchange_halos = spy
        try:
            fn()
        finally:
            sc.exchange_halos = real
        torch.cuda.synchronize()
        copied = 0
        for bufs, g in seen:
            a = g.axis
            for rows, links in ((g.lo_w[a], g.fwd), (g.hi_w[a], g.bwd)):
                for src, _ in links:
                    for x in bufs[src]:
                        copied += (x.numel() // x.shape[a] * rows
                                   * x.element_size())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                for bufs, g in seen:
                    real(bufs, g)
            torch.cuda.synchronize()
        ts = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        out = {
            "exchange_device_ms": (sum(ts) / 1e3 / 5 if ts else
                                   "not measured: no device events"),
            "exchange_copies_per_call": len(ts) / 5,
            "exchange_copied_bytes": copied,
            "geometry_exchange_bytes": sum(g.exchange_bytes for _, g in seen),
            "geometry": [{"shard_axis": g.axis, "rows_per_shard": g.rows,
                          "last": g.last, "n_last": g.n_last,
                          "fwd": [list(p) for p in g.fwd],
                          "bwd": [list(p) for p in g.bwd],
                          "rows_lo": g.lo_w[g.axis],
                          "rows_hi": g.hi_w[g.axis]} for _, g in seen],
        }
        del seen
        return out

    def sharded_phase(name, sharded, unsharded, n_launch, plan=None,
                      hand=None, extra=None):
        """``sharded()`` is the call on ``mesh4``, ``unsharded()`` the same
        call on one device (at the sharded plan, if any); ``n_launch`` the
        launches of one call."""
        reset()
        t0 = time.perf_counter()
        out = sharded()
        torch.cuda.synchronize()
        first_call_s = time.perf_counter() - t0
        launched = counts()
        assert sum(launched.values()) == 4 * n_launch, (name, launched)
        assert bool(torch.isfinite(out.float()).all()), name
        base = unsharded()
        torch.cuda.synchronize()
        equal = bits_equal(out, base)
        plain = plain_versions(sharded)
        exact = bits_equal(out, plain)
        err = max(max_err(out, base), max_err(out, plain))
        del plain, base
        torch.cuda.empty_cache()
        with obs.recording() as rec_obs:
            sharded()
        torch.cuda.synchronize()
        c_ = rec_obs.counters
        n_x = sum(1 for sp in rec_obs.spans if sp.name == "halo_exchange")
        xch = exchanges(sharded)
        want_x = (plan.halo_exchange_bytes if plan is not None
                  else xch["geometry_exchange_bytes"])
        counters_ok = (c_.get("halo_exchange_bytes") == want_x
                       and n_x == c_.get("launches") == n_launch)
        call_ms = time_ms(sharded, reps=5)
        base_ms = time_ms(unsharded, reps=5)
        split = device_split(sharded)
        base_split = device_split(unsharded)
        ok = equal and exact and counters_ok
        gates.append((name, ok, {"equals_unsharded": equal,
                                 "exact_vs_plain": exact,
                                 "counters_ok": counters_ok}))
        phase = {
            "phase": name, "shape": list(out.shape), "mesh": {
                "shards": mesh4.size,
                "devices": [str(d_) for d_ in mesh4.devices]},
            "launches": launched, "launches_per_call": n_launch,
            "equals_unsharded": equal, "exact_vs_plain": exact,
            "max_abs_err": err,
            "ms": call_ms, "call_ms": call_ms, "unsharded_call_ms": base_ms,
            "sharded_over_unsharded": call_ms / base_ms,
            **split,
            "unsharded_slab_device_ms": base_split["slab_device_ms"],
            "unsharded_other_device_ms": base_split["other_device_ms"],
            **xch,
            "counters": {k: c_.get(k) for k in (
                "launches", "halo_exchange_bytes", "halo_exchange_rounds",
                "modeled_bytes")},
            "halo_exchange_spans": n_x, "counters_equal_plan": counters_ok,
            "plan": None if plan is None else {
                "tile": list(plan.tile), "sweep_axis": plan.sweep_axis,
                "shard_axis": plan.shard_axis,
                "fused_depth": plan.fused_depth, "kernel": plan.kernel,
                "modeled_ms": plan.modeled_ms,
                "per_shard_traffic_bytes": plan.per_shard_traffic_bytes,
                "halo_exchange_bytes": plan.halo_exchange_bytes,
                "waves": plan.waves, "ctas_per_sm": plan.ctas_per_sm},
            "first_call_s": first_call_s, "gates_ok": ok,
            "plain_ms": None, "library_ms": None, "card": card_line,
        }
        if hand is not None:
            h = by_name(hand)
            phase.update(compare_with=hand,
                         hand_call_ms=h.get("call_ms"),
                         hand_device_ms=h.get("device_ms"))
        phase.update(extra or {})
        del out
        torch.cuda.empty_cache()
        return phase

    # sharded_apply_f32_512: apply_f32_512's call; the shard axis is
    # pick_shard_axis's (axis 1: 32 columns against 16 on axis 2).
    gen.manual_seed(0)
    u = torch.randn(big, generator=gen, device=dev)
    a_call = lambda **kw: st.stencil_pallas(  # noqa: E731
        u, offs13, w13, tile=(8, 16, 32), sweep_axis=0, **kw)
    phase = sharded_phase(
        "sharded_apply_f32_512", lambda: a_call(mesh=mesh4), a_call, 1,
        hand="apply_f32_512",
        extra={"shard_axis": sc.pick_shard_axis(big, (8, 16, 32), 0)})
    phase.update(**bound(big, 4, 4, 1, [len(w13)]))
    emit(phase)
    summary["sweep_apply"].append(phase)

    # sharded_chain_T3_512: chain_T3_512's fused ring call.
    gen.manual_seed(2)
    u = torch.randn(big, generator=gen, device=dev)
    c_call = lambda **kw: st.stencil_iterate(  # noqa: E731
        u, offs13, w13, 3, tile=(4, 16, 32), sweep_axis=0,
        window_kind="ring", **kw)
    phase = sharded_phase(
        "sharded_chain_T3_512", lambda: c_call(mesh=mesh4), c_call, 1,
        hand="chain_T3_512")
    phase.update(**bound(big, 4, 4, 1, [len(w13)] * 3))
    emit(phase)
    summary["sweep_chain"].append(phase)
    del u
    torch.cuda.empty_cache()

    # sharded_periodic_ragged: a periodic T=3 chain on 250×253×258 sharded
    # along axis 1 (16 columns of 16 rows, 4 a shard: 64 rows, the last
    # shard owning 61), where the wrap links close the ring.
    rag = (250, 253, 258)
    gen.manual_seed(9)
    u = torch.randn(rag, generator=gen, device=dev)
    p_prog = ir.chain_program([(offs13, w13)] * 3, 3, boundary="periodic")
    p_call = lambda **kw: ir.run_program(  # noqa: E731
        p_prog, u, tile=(4, 16, 32), sweep_axis=0, **kw)
    phase = sharded_phase(
        "sharded_periodic_ragged", lambda: p_call(mesh=mesh4), p_call, 1)
    geo = phase["geometry"][0]
    assert (geo["shard_axis"], geo["rows_per_shard"], geo["n_last"]) == \
        (1, 64, 61), geo
    assert [3, 0] in geo["fwd"] and [0, 3] in geo["bwd"], geo
    phase.update(**bound(rag, 4, 4, 1, [len(w13)] * 3))
    emit(phase)
    summary["sweep_chain"].append(phase)
    del u
    torch.cuda.empty_cache()

    # planned_sharded_chain_int8_512: chain_int8_512's program without a
    # tile over the mesh: the planner plans the worst shard's slab, and a
    # plan that splits the chain hands int8 codes (zero point 3) from
    # launch to launch, whose mesh-edge halos hold the zero point.
    gen.manual_seed(4)
    u8 = torch.randn(big, generator=gen, device=dev) * 0.01
    i_prog = ir.chain_program([(offs13, w13)] * 3, 3, boundary="reflect",
                              quants=[q, q, None])
    seen_plans.clear()
    ir.run_program(i_prog, u8, mesh=mesh4)
    s_plan = seen_plans[-1]
    assert s_plan.num_shards == 4, s_plan
    phase = sharded_phase(
        "planned_sharded_chain_int8_512",
        lambda: ir.run_program(i_prog, u8, mesh=mesh4),
        lambda: ir.run_program(i_prog, u8, plan=s_plan, num_shards=1),
        -(-3 // s_plan.fused_depth), plan=s_plan,
        hand="planned_chain_int8_512",
        extra={"hands_int8_codes": s_plan.fused_depth < 3,
               "zero_point": q[1]})
    phase.update(**bound(big, 4, 4, 1, [len(w13)] * 3))
    emit(phase)
    summary["sweep_chain"].append(phase)
    del u8
    torch.cuda.empty_cache()

    # tuned_traced_sharded_256: a 256³ T=3 star with tune= (k=2) and
    # trace= over the mesh: the race measures sharded launches on this
    # call's mesh; the warm call serves the record with one tunedb_hit and
    # no measure span, and its trace holds one halo_exchange span a launch
    # and passes report --check.
    small = (256, 256, 256)
    gen.manual_seed(6)
    u = torch.randn(small, generator=gen, device=dev)
    s_tuner = AutoTuner(k=2, reps=5, warmup=1, device="cuda")
    t_call = lambda **kw: st.stencil_iterate(  # noqa: E731
        u, offs13, w13, 3, **kw)

    def traced_check(path) -> dict:
        summ = summarize(obs.load_trace(path))
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.report", path,
             "--check"],
            env={**os.environ, "PYTHONPATH": str(SRC)},
            capture_output=True, text=True, timeout=300)
        return {"reconcile_problems": reconcile(summ),
                "report_check_rc": cli.returncode,
                "kernel_launch_spans": len(summ["launches"]),
                "halo_exchange_spans": summ["n_exchange_spans"],
                "measure_spans": summ["n_measure_spans"],
                "span_shards": sorted({ln["num_shards"]
                                       for ln in summ["launches"]}),
                "counters": summ["counters"]}

    t0 = time.perf_counter()
    t_call(mesh=mesh4, tune=s_tuner, trace=str(trace_dir / "race.json"))
    torch.cuda.synchronize()
    race_s = time.perf_counter() - t0
    measured_first = not s_tuner.last_plan_tuned
    rec_s = s_tuner.last_record
    winner = rec_s.winner_plan
    race_trace = traced_check(str(trace_dir / "race.json"))
    reset()
    t_call(mesh=mesh4, tune=s_tuner, trace=str(trace_dir / "warm.json"))
    torch.cuda.synchronize()
    warm_launched = counts()
    warm_trace = traced_check(str(trace_dir / "warm.json"))
    n_w = -(-3 // winner.fused_depth)
    warm_ok = (s_tuner.last_plan_tuned
               and warm_trace["counters"].get("tunedb_hit") == 1
               and warm_trace["measure_spans"] == 0
               and warm_trace["report_check_rc"] == 0
               and race_trace["report_check_rc"] == 0
               and not warm_trace["reconcile_problems"]
               and warm_trace["halo_exchange_spans"]
               == warm_trace["kernel_launch_spans"] == n_w
               and warm_trace["span_shards"] == [4]
               and sum(warm_launched.values()) == 4 * n_w)
    gates.append(("tuned_traced_sharded_256 warm", warm_ok,
                  {"warm_launches": warm_launched, "warm_trace": warm_trace}))
    phase = sharded_phase(
        "tuned_traced_sharded_256",
        lambda: t_call(mesh=mesh4, tune=s_tuner),
        lambda: t_call(plan=winner, num_shards=1), n_w, plan=winner,
        extra={
            "race_s": race_s, "first_call_measured": measured_first,
            "never_slower": rec_s.never_slower,
            "winner_rank": rec_s.winner,
            "speedup_vs_analytic": rec_s.speedup_vs_analytic,
            "candidates": [{
                "tile": list(c_.tile), "sweep_axis": c_.sweep_axis,
                "shard_axis": c_.shard_axis, "fused_depth": c_.fused_depth,
                "advisory": c_.advisory, "modeled_ms": c_.modeled_ms,
                "modeled_bytes": c_.modeled_bytes,
                "median_ms": c_.median_s * 1e3} for c_ in rec_s.candidates],
            "warm_launches": warm_launched, "warm_ok": warm_ok,
            "race_trace": race_trace, "warm_trace": warm_trace,
        })
    assert measured_first and rec_s.never_slower, phase
    phase.update(**bound(small, 4, 4, 1, [len(w13)] * 3))
    emit(phase)
    summary["sweep_chain" if winner.fused_depth > 1
            else "sweep_apply"].append(phase)
    del u
    torch.cuda.empty_cache()

    lap("sharded phases")
    # unfavorable_sweep: the paper's question on this card.  The planned
    # 13-point star on n × n × 256 f32 grids, n = 500..516, timed (the
    # kernel alone, CUDA events) at the planned tile and at the fixed
    # tile (8, 16, 32), beside whether the grid is unfavorable (§6) under
    # the paper's (2, 512, 4) cache and under a stated L1 model: 4 ways ×
    # 64 sets × 128-byte lines (32 f32 words), 32 KB.  Lattices are of the
    # grid in memory order, fastest axis first: (256, n, n).  Two passes,
    # n rising then falling, so that a drift of the card's clock is not
    # read as a dependence on n; each time is the median of 20 launches.
    geoms = {"paper_2_512_4": (2, 512, 4), "l1_4_64_32": (4, 64, 32)}
    rows, swept = {}, {name: 0 for name in kernels}
    measure = sweep_measurer(torch, dev, reset, counts, time_ms, device_ms,
                             bits_equal, max_err, swept)
    err = 0.0
    for pass_, ns in enumerate((range(500, 517), range(516, 499, -1))):
        for n in ns:
            shape = (n, n, 256)
            gen.manual_seed(n)
            u = torch.randn(shape, generator=gen, device=dev)
            reset()
            out = st.stencil_pallas(u, offs13, w13)
            torch.cuda.synchronize()
            for k_, v in counts().items():
                swept[k_] += v
            plan = st._auto_tile(shape, [spec(offs13, w13)[0]], 4, 1, dev,
                                 window_kind="auto")
            row = rows.setdefault(n, {
                "n": n, "tile": list(plan.tile),
                "sweep_axis": plan.sweep_axis,
                "modeled_ms": plan.modeled_ms})
            for label, tile, sw in (("planned", plan.tile, plan.sweep_axis),
                                    ("fixed", (8, 16, 32), 0)):
                ins, offs, wts, _, lo_w, hi_w = st._launch_inputs(
                    [u], (spec(offs13, w13),), tile)
                args = (ins, offs, wts, lo_w, hi_w, tile, sw, True)
                k_out = sweep.sweep_apply(*args)
                if pass_ == 0:
                    p_out = sweep.sweep_apply_plain(*args)
                    exact = bits_equal(k_out, p_out)
                    err = max(err, max_err(k_out, p_out))
                    if label == "planned":  # the launch the call made
                        trim = k_out[tuple(slice(0, e) for e in shape)]
                        exact = exact and bits_equal(out, trim.contiguous())
                        err = max(err, max_err(out, trim))
                    assert exact, (n, label)
                    del p_out
                ms = time_ms(lambda: sweep.sweep_apply(*args), reps=20)
                row.setdefault(f"{label}_ms", []).append(ms)
                row.setdefault(f"{label}_ns_per_point", []).append(
                    ms * 1e6 / prod(shape))
                del ins, k_out, args
            del u, out
            for gname, (a, z, w) in geoms.items():
                if gname not in row:
                    rep_ = planner.lattice_report(shape[::-1], a * z * w, 5,
                                                  a=1)
                    row[gname] = {"unfavorable": rep_.unfavorable,
                                  "shortest_l1": rep_.shortest_l1,
                                  "hyperbola_k": rep_.hyperbola_k}
                    if rep_.unfavorable:
                        # The grid again, padded as pad_grid advises (its
                        # leading lattice dims are the grid's two fastest
                        # axes).
                        try:
                            row[gname]["padded"] = {"shape": list(pad_grid(
                                shape[::-1], a * z * w, 5)[0][::-1])}
                        except ValueError as e:  # no favourable pad in +16
                            row[gname]["padded"] = str(e)
                pad = row[gname].get("padded")
                if not isinstance(pad, dict):
                    continue
                p_ms, _ = measure(tuple(pad["shape"]), torch.float32,
                                  pass_ == 0, pad, seed=n)
                # Per point of the caller's grid, so that padding's extra
                # points count against it.
                pad.setdefault("ns_per_useful_point", []).append(
                    p_ms * 1e6 / prod(shape))
            torch.cuda.empty_cache()
    err = max([err] + [r[g]["padded"]["max_abs_err"] for r in rows.values()
                       for g in geoms
                       if isinstance(r[g].get("padded"), dict)])
    phase = {"phase": "unfavorable_sweep", "grids": "n x n x 256 f32",
             "passes": 2, "launches": swept, "max_abs_err": err,
             "rows": [rows[n] for n in sorted(rows)], "card": card_line}
    emit(phase)
    summary["sweep_apply"].append(phase)

    lap("unfavorable_sweep")
    # -- layout_sweep ---------------------------------------------------------
    summary["sweep_apply"].append(layout_sweep_phase(
        torch, dev, card_line, emit, reset, counts, time_ms, device_ms,
        bits_equal, max_err))

    lap("layout_sweep")
    # -- mamba2_serve -------------------------------------------------------
    summary["conv1d"] = [mamba2_phase(
        torch, F, dev, card_line, emit, reset, counts, time_ms, bits_equal,
        max_err, device_ms, host_ms, ptxas_by_function, mangled)]

    lap("mamba2_serve")
    # -- mamba2_train -------------------------------------------------------
    summary["conv1d"].append(mamba2_train_phase(
        torch, dev, card_line, emit, reset, counts, time_ms, bits_equal,
        max_err, device_ms))

    lap("mamba2_train")
    # -- zamba2_serve, zamba2_train: the hybrid, as the two phases above ------
    summary["conv1d"].append(mamba2_phase(
        torch, F, dev, card_line, emit, reset, counts, time_ms, bits_equal,
        max_err, device_ms, host_ms, ptxas_by_function, mangled,
        arch="zamba2-2.7b"))
    lap("zamba2_serve")
    summary["conv1d"].append(mamba2_train_phase(
        torch, dev, card_line, emit, reset, counts, time_ms, bits_equal,
        max_err, device_ms, arch="zamba2-2.7b",
        # A tenth of Mamba2's rate.  At 3e-4 from the first step the first
        # update overshoots at this width: the loss rises at the second
        # step, in the reference as in the port
        # (tests/test_torch_zamba2.py::
        # test_repeated_batch_at_full_width_follows_the_reference).
        repeat_lr=3e-5))

    lap("zamba2_train")
    # planned_conv: the prefill conv's shape with tile_s=None; the planned
    # tile against the serving phase's 256, both timed: the tile only
    # changes the padding.
    gen.manual_seed(8)
    xbc = torch.randn((4, 2048, 5376), generator=gen, device=dev).to(
        torch.bfloat16)
    cw = (torch.randn((4, 5376), generator=gen, device=dev) * 0.3).to(
        torch.bfloat16)
    cb = (torch.randn((5376,), generator=gen, device=dev) * 0.1).to(
        torch.bfloat16)
    reset()
    out = conv1d.causal_conv1d(xbc, cw, cb)
    torch.cuda.synchronize()
    launched = counts()
    assert launched["conv1d"] == 1, launched
    tile_s = conv1d._planned_tile_s(2048, 5376, 4, 2, hardware.key())
    p_out = conv1d.causal_conv1d_plain(xbc, cw, cb)
    exact = bits_equal(out, p_out)
    diff = (out.float() - p_out.float()).abs()
    # One bf16 ulp of the output where not bit-equal, as mamba2_serve.
    assert exact or bool((diff <= 2.0 ** -8 * p_out.float().abs()
                          + 1e-30).all()), float(diff.max())
    timed = {}
    for t in (tile_s, 256):
        timed[t] = {
            "ms": time_ms(lambda: conv1d.causal_conv1d_launch(xbc, cw, cb, t),
                          reps=20, warmup=3),
            "device_ms": device_ms(
                lambda: conv1d.causal_conv1d_launch(xbc, cw, cb, t),
                reps=10, kernel="conv1d_silu"),
        }
    hand = summary["conv1d"][0]
    phase = {
        "phase": "planned_conv", "shape": [4, 2048, 5376],
        "planned_tile_s": tile_s, "launches": launched,
        "exact_vs_plain": exact, "max_abs_err": float(diff.max()),
        "by_tile": {str(t): v for t, v in timed.items()},
        "planned_over_256_device": (
            timed[tile_s]["device_ms"] / timed[256]["device_ms"]
            if all(isinstance(v["device_ms"], float) for v in timed.values())
            else None),
        "hand_picked": "mamba2_serve conv (tile 256)",
        "hand_ms": hand["device_ms"],
        "ms": timed[tile_s]["ms"], "device_ms": timed[tile_s]["device_ms"],
        "plain_ms": None, "library_ms": None,
        "bound_ms": hand["bound_ms"], "bound_by": hand["bound_by"],
        "card": card_line,
    }
    emit(phase)
    summary["conv1d"].append(phase)
    del xbc, cw, cb, out, p_out, diff
    torch.cuda.empty_cache()

    failed = {name: why for name, ok, why in gates if not ok}
    if failed:
        fail(f"tuned/traced gates failed: {json.dumps(failed, default=str)}")

    lap("planned_conv")
    # -- granite_serve, granite_train, families_serve: the transformers ------
    # None of the port's kernels is on these paths (the reference computes
    # them with plain einsums): each phase asserts its counts stay 0.
    lm_serve_phase(torch, dev, card_line, emit, reset, counts, max_err,
                   "granite-3-2b", 4, 2048, 16, warm=2, profile=True,
                   cpu_layers=2, name="granite_serve")
    lap("granite_serve")
    granite = lm_train_phase(torch, dev, card_line, emit, reset, counts,
                             bits_equal, max_err)
    lap("granite_train")
    from repro_torch.configs import get_config

    served = [
        lm_serve_phase(torch, dev, card_line, emit, reset, counts, max_err,
                       arch, b, n_tok, 5, layers=fit_layers(get_config(arch)),
                       cpu_layers=cpu_layers, cpu_tokens=cpu_tokens)
        for arch, b, n_tok, cpu_layers, cpu_tokens in FAMILIES]
    emit({"phase": "families_serve", "card": card_line, "rows": [
        {k: ph[k] for k in ("arch", "layers", "published_layers", "batch",
                            "prompt_tokens", "prefill_ms",
                            "decode_ms_per_step", "peak_memory_gb",
                            "param_gb", "kv_cache_gb", "cross_kv_gb",
                            "moe_dropped", "teacher_forcing_max_abs_err",
                            "teacher_forcing_prefill_routes_identical",
                            "teacher_forcing_gated")}
        for ph in served]})
    lap("families_serve")
    # -- the sharded model stack and the model tooling ------------------------
    # None of the port's kernels is on these paths either.
    mesh_step_phase(torch, dev, card_line, emit, reset, counts, bits_equal,
                    max_err)
    lap("mesh_step")
    roofline_phase(torch, card_line, emit, granite)
    lap("roofline_granite_train")
    dryrun_phase(card_line, emit)
    lap("dryrun_cells")
    mixtral_train_phase(torch, dev, card_line, emit, reset, counts)
    lap("mixtral_train")
    lm_examples_phase(torch, card_line, emit, reset, counts)
    lap("lm_examples")
    # -- summary ---------------------------------------------------------------
    rows = []
    every_phase = [ph for phases in summary.values() for ph in phases]
    for name, phases in summary.items():
        head = phases[0]

        def n_launch(ph):
            ln = ph["launches"]
            if name in ln:
                return ln[name]
            return sum(v[name] for v in ln.values()
                       if isinstance(v, dict) and name in v)

        replaces, parts = REPLACES[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "parts": parts,
            "launches": sum(n_launch(ph) for ph in every_phase),
            "max_abs_err": max(ph["max_abs_err"] for ph in phases),
            "ms": head["ms"], "device_ms": head.get("device_ms"),
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "phase": head["phase"],
        })
    emit({"phase": "seconds", "total": sum(laps.values()), **laps})
    emit({"kernels": rows})
    print(card_line)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "conv1d_silu" in n:
        return "conv1d kernel"
    if any(k in n for k in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul (cuBLAS)"
    if "reduce" in n:
        return "reduction"
    if "cat" in n:
        return "concat"
    if "copy" in n:
        return "copy/cast"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


def profile_breakdown(torch, fn, cpu=True) -> dict:
    """Device time of one call of ``fn`` by kernel class and by kernel
    (top 8), and the share of the host-clock span the device was busy,
    from ``torch.profiler``.  Measurement only: if the profiler records no
    device events here, the result says "not measured".  ``cpu=False``
    records the device's activity alone (a training step's hundreds of
    thousands of host-side op events would cost minutes to collect)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"device_time": "not measured: no device events recorded"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of the kernels' intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_class: dict = {}
    by_name: dict = {}
    for e in kernels:
        d = e.time_range.elapsed_us()
        by_class[_kernel_class(e.name)] = by_class.get(
            _kernel_class(e.name), 0.0) + d / 1e3
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + d / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy / wall_us),
        "kernel_launches": len(kernels),
        "ms_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": dict(top),
    }


def sweep_measurer(torch, dev, reset, counts, time_ms, device_ms, bits_equal,
                   max_err, swept, reps=20):
    """``measure(shape, dtype, first, rec, seed=None)`` for the grid phases:
    the planned 13-point star (``stencil_pallas`` without a tile) on a grid
    of ``shape`` drawn from ``seed`` (default: the minor extent), its
    launches added to ``swept``; the planned launch again through
    ``sweep_apply``, its kernel ``ms`` (CUDA events, median of ``reps``)
    and the whole call's ``call_ms`` appended to ``rec`` and returned.
    With ``first`` also: the launch bit-equal to its plain version and the
    call's output to the launch's, trimmed (asserted; their largest
    difference is ``rec["max_abs_err"]``), the plan, the launch buffer's
    slack (``tpu_layout_waste`` at the planned tile and the star's halo,
    held equal to the buffer ``_launch_inputs`` builds), whether the
    launcher copies its rows as whole 16-byte blocks
    (``sweep.apply_copy16``) and the profiler's ``device_ms``."""
    import numpy as np

    from repro_torch.core.padding import tpu_layout_waste
    from repro_torch.kernels import ref, sweep
    from repro_torch.kernels import stencil as st

    offs13, w13 = ref.star_weights_2nd_order(3, 2)
    spec13 = (tuple(map(tuple, np.asarray(offs13).tolist())),
              tuple(float(w) for w in w13))
    gen = torch.Generator(device=dev)

    def measure(shape, dtype, first, rec, seed=None):
        nbytes = torch.empty((), dtype=dtype).element_size()
        gen.manual_seed(shape[-1] if seed is None else seed)
        u = torch.randn(shape, generator=gen, device=dev).to(dtype)
        reset()
        out = st.stencil_pallas(u, offs13, w13)
        torch.cuda.synchronize()
        for k, v in counts().items():
            swept[k] += v
        plan = st._auto_tile(shape, [spec13[0]], nbytes, 1, dev,
                             window_kind="auto")
        ins, offs, wts, _, lo_w, hi_w = st._launch_inputs([u], (spec13,),
                                                          plan.tile)
        args = (ins, offs, wts, lo_w, hi_w, plan.tile, plan.sweep_axis, True)
        if first:
            k_out = sweep.sweep_apply(*args)
            p_out = sweep.sweep_apply_plain(*args)
            trim = k_out[tuple(slice(0, e) for e in shape)]
            exact = (bits_equal(k_out, p_out)
                     and bits_equal(out, trim.contiguous()))
            err = max(max_err(k_out, p_out), max_err(out, trim))
            assert exact, (shape, dtype, err)
            waste = tpu_layout_waste(shape, plan.tile, halo=2,
                                     dtype_bytes=nbytes)
            assert waste == 1.0 - prod(shape) / ins[0].numel(), waste
            rec.update(tile=list(plan.tile), sweep_axis=plan.sweep_axis,
                       modeled_ms=plan.modeled_ms, launch_waste=waste,
                       rows_16B_blocks=sweep.apply_copy16(*args),
                       exact_vs_plain=exact, max_abs_err=err,
                       device_ms=device_ms(
                           lambda: sweep.sweep_apply(*args), reps=3,
                           kernel="sweep_apply_kernel"))
            del k_out, p_out, trim
        ms = time_ms(lambda: sweep.sweep_apply(*args), reps=reps)
        call_ms = time_ms(lambda: st.stencil_pallas(u, offs13, w13), reps=10)
        rec.setdefault("ms", []).append(ms)
        rec.setdefault("call_ms", []).append(call_ms)
        del u, out, ins, args
        torch.cuda.empty_cache()
        return ms, call_ms

    return measure


def layout_sweep_phase(torch, dev, card_line, emit, reset, counts, time_ms,
                       device_ms, bits_equal, max_err, n=512,
                       extents=range(240, 273)) -> dict:
    """The ``layout_sweep`` phase: the paper's §6 on this card, for the
    layout the launch reads.  The planned 13-point star on n × n × m
    grids, m over ``extents``, in f32 and bf16, two passes (m rising, then
    falling), each grid through :func:`sweep_measurer` (kernel ``ms``,
    ``call_ms``, and on the first pass the bit-equality checks, launch
    slack, 16-byte row copies and ``device_ms``); per row also ns per
    useful point and ``advise_dim``'s verdict on m; where the advice flags
    m, the grid padded as advised (minor extent ``padded``) measured too.
    Returns the phase record."""
    from repro_torch.core.padding import advise_dim

    swept = {name: 0 for name in counts()}
    measure = sweep_measurer(torch, dev, reset, counts, time_ms, device_ms,
                             bits_equal, max_err, swept)
    t_start = time.perf_counter()
    by_dtype, err = {}, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        nbytes = torch.empty((), dtype=dtype).element_size()
        rows = {}
        for pass_, order in enumerate((list(extents), list(extents)[::-1])):
            for m in order:
                adv = advise_dim(m, dtype_bytes=nbytes)
                row = rows.setdefault(m, {"m": m, "advise_dim": adv})
                shape = (n, n, m)
                ms, call = measure(shape, dtype, pass_ == 0, row)
                useful = prod(shape)
                row.setdefault("ns_per_point", []).append(ms * 1e6 / useful)
                row.setdefault("call_ns_per_point", []).append(
                    call * 1e6 / useful)
                if adv["unfavorable"]:
                    pad = row.setdefault("padded", {"m": adv["padded"]})
                    p_ms, p_call = measure((n, n, adv["padded"]), dtype,
                                           pass_ == 0, pad)
                    # Per point of the caller's grid: the padding's extra
                    # points count against it.
                    pad.setdefault("ns_per_useful_point", []).append(
                        p_ms * 1e6 / useful)
                    pad.setdefault("call_ns_per_useful_point", []).append(
                        p_call * 1e6 / useful)
        rows = [rows[m] for m in sorted(rows)]
        err = max([err] + [r["max_abs_err"] for r in rows]
                  + [r["padded"]["max_abs_err"] for r in rows
                     if "padded" in r])
        verdict = {}
        for key in ("ns_per_point", "call_ns_per_point"):
            med = {r["m"]: statistics.median(r[key]) for r in rows}
            # The noise: the median relative gap between the two passes.
            spread = statistics.median(
                abs(r[key][0] - r[key][1]) / med[r["m"]] for r in rows)
            flagged = [med[r["m"]] for r in rows
                       if r["advise_dim"]["unfavorable"]]
            clear = [med[r["m"]] for r in rows
                     if not r["advise_dim"]["unfavorable"]]
            gap = (statistics.median(flagged) / statistics.median(clear) - 1
                   if flagged and clear else None)
            waste = [r["launch_waste"] for r in rows]
            verdict[key] = {
                "flagged_over_clear_minus_1": gap, "pass_spread": spread,
                "advice_predicts": gap is not None and gap > spread,
                "corr_with_launch_waste": (
                    statistics.correlation(waste, list(med.values()))
                    if len(set(waste)) > 1 else None),
            }
        by_dtype[str(dtype).removeprefix("torch.")] = {
            "rows": rows, "verdict": verdict}
    phase = {"phase": "layout_sweep", "grids": f"{n} x {n} x m",
             "extents": [min(extents), max(extents)], "passes": 2,
             "launches": swept, "max_abs_err": err,
             "seconds": time.perf_counter() - t_start, **by_dtype,
             "card": card_line}
    emit(phase)
    return phase


def mamba2_phase(torch, F, dev, card_line, emit, reset, counts, time_ms,
                 bits_equal, max_err, device_ms, host_ms, ptxas_by_function,
                 mangled, arch="mamba2-2.7b") -> dict:
    """The ``mamba2_serve`` phase (``zamba2_serve`` for ``arch=
    "zamba2-2.7b"``: the hybrid, whose shared attention block keeps a KV
    ring per application); returns the conv kernel's record."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import conv1d
    from repro_torch.launch.serve import serve
    from repro_torch.models import get_model
    from repro_torch.models import ssm
    from repro_torch.models.layers import embed_tokens, rms_norm, unembed

    batch, prompt, gen = 4, 2048, 16
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, pallas_conv=True, conv_tile=256))
    cdt = cfg.compute_dtype
    model = get_model(cfg, device=dev)
    # The KV rings of the hybrid's shared block (keys and values, bf16).
    kv_gb = sum(prod(sp.shape) * torch.empty((), dtype=sp.dtype)
                .element_size() for name, sp in model.cache_specs(
                    batch, prompt + gen).get("attn", {}).items()
                if name in ("k", "v")) / 1e9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=g,
                            device=dev)

    # The main path: counts zeroed just before, read just after.
    reset()
    toks, cold = serve(cfg, params, prompts, gen, device=dev)
    launched = counts()
    assert launched["conv1d"] == cfg.n_layers, launched
    assert launched["sweep_apply"] == 0 and launched["sweep_chain"] == 0
    assert tuple(toks.shape) == (batch, gen), toks.shape
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab
    # Warm runs for the times (the first run includes cuBLAS set-up).
    warm = [serve(cfg, params, prompts, gen, device=dev) for _ in range(2)]
    same_tokens = all(bool(torch.equal(t, toks)) for t, _ in warm)
    prefill_ms = min(w["prefill_s"] for _, w in warm) * 1e3
    decode_ms = min(w["decode_s"] for _, w in warm) * 1e3 / (gen - 1)
    # Where the time goes: one prefill and one decode step under the
    # profiler (after the timed runs, so its cost is in no time above).
    prof_cache = model.init_cache(batch, prompt + 1)
    prof = {"prefill": profile_breakdown(torch, lambda: model.prefill(
        params, {"tokens": prompts}, prof_cache))}
    prof["decode_step"] = profile_breakdown(torch, lambda: model.decode_step(
        params, prof_cache, toks[:, :1], prompt))
    del prof_cache

    with torch.inference_mode():
        # The conv kernel on layer 0's real conv input (zero state, as the
        # prefill passes it from a fresh cache).
        emb = params.embed.tensors()
        p0 = params.layers[0].tensors()
        x0 = embed_tokens(cfg, emb, prompts)
        _, xbc, _ = ssm._in_proj(cfg, p0, rms_norm(x0, p0["ln"]))
        w, b = p0["conv_w"].to(cdt), p0["conv_b"].to(cdt)
        width = w.shape[0]
        st = torch.zeros((batch, width - 1, xbc.shape[2]), dtype=cdt,
                         device=dev)
        tile = cfg.ssm.conv_tile
        k_out = conv1d.causal_conv1d_launch(xbc, w, b, tile, st)
        p_out = conv1d.causal_conv1d_plain(xbc, w, b, st)
        torch.cuda.synchronize()
        exact = bits_equal(k_out, p_out)
        err = max_err(k_out, p_out)
        diff = (k_out.float() - p_out.float()).abs()
        n_diff = int((diff > 0).sum())
        # Band if not bit-equal: one bf16 ulp of the output (2^-8 relative),
        # from an ulp of difference between this build's expf and ATen's.
        band_ok = bool((diff <= 2.0 ** -8 * p_out.float().abs() + 1e-30)
                       .all())
        assert exact or band_ok, (err, n_diff)
        ms = time_ms(lambda: conv1d.causal_conv1d_launch(xbc, w, b, tile, st),
                     reps=20, warmup=3)
        conv_dev = device_ms(
            lambda: conv1d.causal_conv1d_launch(xbc, w, b, tile, st),
            reps=10, kernel="conv1d_silu")
        conv_host = host_ms(
            lambda: conv1d.causal_conv1d_launch(xbc, w, b, tile, st))
        # Yardstick: a device copy of the conv's input moves its bytes.
        copy_ms = time_ms(lambda: xbc.clone(), reps=20, warmup=3)
        copy_dev = device_ms(lambda: xbc.clone(), reps=10, kernel="")
        vec = conv1d._vec(xbc.shape[2], xbc, torch.empty_like(xbc), st)
        fns = ptxas_by_function("conv1d")
        key = f"conv1d_silu_kernelI{mangled[cdt]}Li{width}ELi{vec}E"
        conv_info = {
            "vec": vec, "threads_per_block": conv1d._THREADS,
            "blocks_per_sm": conv1d.occupancy(cdt, width, vec),
            "grid_blocks": conv1d.grid_blocks(*xbc.shape, tile, vec),
            "ptxas": next((v for k, v in fns.items() if key in k),
                          "not found"),
            "conv_spill_bytes_all_functions": sum(
                v.get("spill_stores", 0) + v.get("spill_loads", 0)
                for v in fns.values()),
        }
        plain_ms = time_ms(lambda: conv1d.causal_conv1d_plain(xbc, w, b, st),
                           reps=10)
        # Yardstick: one depthwise F.conv1d (channels first, left pad W-1,
        # first S outputs) computes the same pre-activation; it omits silu.
        wl = w.t().contiguous()[:, None, :]
        xt = xbc.transpose(1, 2)

        def library():
            return F.conv1d(xt, wl, b, padding=width - 1,
                            groups=xbc.shape[2])

        lib_ms = time_ms(library, reps=20, warmup=3)
        lib_out = library()[..., :prompt].transpose(1, 2)
        lib_diff = max_err(lib_out * torch.sigmoid(lib_out), k_out)
        n_el = xbc.numel()
        in_bytes = (xbc.numel() + st.numel() + w.numel() + b.numel()) * 2
        nbytes = in_bytes + k_out.numel() * 2
        flops = (2 * width + 1 + 4) * n_el  # taps, bias, silu (exp, +, /, ×)
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        tf = flops / F32_FLOPS_PER_S * 1e3
        del x0, xbc, k_out, p_out, diff, lib_out, st
        torch.cuda.empty_cache()

        # prefill(S-1) + decode(1) against a teacher-forced forward, in the
        # band of tests/test_models.py::test_decode_matches_teacher_forcing.
        xf, _ = ssm.ssm_forward(cfg, params, prompts, 0)
        ref_lg = unembed(cfg, emb, xf[:, -2:]).float()
        del xf
        cache = model.init_cache(batch, prompt)
        lg1, cache = model.prefill(params, {"tokens": prompts[:, :-1]}, cache)
        lg2, _ = model.decode_step(params, cache, prompts[:, -1:], prompt - 1)
        tf_err = [max_err(lg1[:, 0], ref_lg[:, 0]),
                  max_err(lg2[:, 0], ref_lg[:, 1])]
        tf_ok = all(bool(torch.allclose(a[:, 0].float(), r, atol=0.2,
                                        rtol=0.05))
                    for a, r in ((lg1, ref_lg[:, 0]), (lg2, ref_lg[:, 1])))
        assert tf_ok, tf_err
        del cache, lg1, lg2, ref_lg
        torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()

    # A 2-layer full-width model (the hybrid: attn_every layers, one
    # shared-block application), batch 1 × 256 tokens, on the card and on
    # the CPU (plain versions), same weights: prefill + 2 decode steps.
    n2 = cfg.attn_every or 2
    cfg2 = dataclasses.replace(cfg, n_layers=n2)
    p_cpu = get_model(cfg2, device="cpu").init(1)
    p_gpu = ssm.SSMModel(cfg2, device=dev)
    p_gpu.load_state_dict(p_cpu.state_dict())
    small = torch.randint(0, cfg.vocab, (1, 258),
                          generator=torch.Generator().manual_seed(7))
    logits = {}
    for where, prm in (("cpu", p_cpu), ("card", p_gpu)):
        m2 = get_model(cfg2, device="cpu" if where == "cpu" else dev)
        cache = m2.init_cache(1, 258)
        lg, cache = m2.prefill(prm, {"tokens": small[:, :256]}, cache)
        out = [lg]
        for i in (256, 257):
            lg, cache = m2.decode_step(prm, cache, small[:, i:i + 1], i)
            out.append(lg)
        logits[where] = torch.cat(out, 1).float().cpu()
    cpu_err = max_err(logits["card"], logits["cpu"])
    # Band: bf16 logits of magnitude ~1-4 (ulp 2^-7..2^-6) from two
    # accumulation orders (cuBLAS, the CPU's GEMM) and per-op bf16 rounding.
    cpu_ok = bool(torch.allclose(logits["card"], logits["cpu"], atol=0.1,
                                 rtol=0.02))
    assert cpu_ok, cpu_err
    del p_cpu, p_gpu
    torch.cuda.empty_cache()

    phase = {
        "phase": f"{arch.split('-')[0]}_serve", "arch": cfg.name,
        "layers": cfg.n_layers,
        "shared_block_applications": cfg.n_layers // cfg.attn_every
        if cfg.attn_every else 0, "kv_cache_gb": kv_gb,
        "d_model": cfg.d_model, "params": n_params, "batch": batch,
        "prompt_tokens": prompt, "generated_tokens": gen,
        "conv_tile": tile, "conv_shape": [batch, prompt, n_el // (batch * prompt)],
        "launches": launched, "init_s": init_s,
        "cold": cold, "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "prefill_tokens_per_s": batch * prompt / prefill_ms * 1e3,
        "decode_tokens_per_s": batch / decode_ms * 1e3,
        "same_tokens_warm": same_tokens, "peak_memory_gb": peak_gb,
        "profile": prof,
        "exact_vs_plain": exact, "n_differ_vs_plain": n_diff,
        "max_abs_err": err, "ms": ms, "device_ms": conv_dev,
        "host_ms": conv_host,
        "copy_ms": copy_ms, "copy_device_ms": copy_dev,
        "copy_bytes": 2 * n_el * 2, **conv_info, "plain_ms": plain_ms,
        "library_ms": lib_ms, "library": "F.conv1d(groups=C), no silu",
        "library_max_abs_diff": lib_diff,
        "bound_ms": max(tb, tf), "bound_by": "bytes" if tb >= tf else
        "operations", "bytes": nbytes, "flops": flops,
        "teacher_forcing_max_abs_err": tf_err,
        f"card_vs_cpu_{n2}layer_max_abs_err": cpu_err,
        "card": card_line,
    }
    emit(phase)
    return phase


def stream_ms(torch, fn, n) -> float:
    """Time of one call of ``fn`` over ``n`` calls issued back to back
    between two CUDA events (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def card_vs_cpu_step(torch, cfg2, dev, max_err, batch):
    """At a small depth ``cfg2``: one training step on the card against
    the same step on the CPU (plain versions), from the same weights
    (seed 1, drawn on the card and copied to the CPU) and state, on the
    pipeline batch ``batch``, within the stated bands (asserted).  Returns
    ``(losses and gradient norms, parameter max abs error, update sign
    agreement)``."""
    from repro_torch.launch.train import train_step
    from repro_torch.models import get_model
    from repro_torch.optim import OptConfig, adamw_init

    m_cpu, m_gpu = get_model(cfg2, device="cpu"), get_model(cfg2, device=dev)
    p_gpu = m_gpu.init(1)
    p_cpu = m_gpu.fam.module(cfg2, device="cpu")
    p_cpu.load_state_dict(p_gpu.state_dict())
    ocfg2 = OptConfig(lr=1e-3, warmup_steps=1)
    # The starting point stays on the card: the CPU holds one model.
    before = {k: v.detach().clone() for k, v in p_gpu.named_parameters()}
    res = {}
    for where, m2, prm in (("cpu", m_cpu, p_cpu), ("card", m_gpu, p_gpu)):
        o2 = adamw_init(dict(prm.named_parameters()))
        _, _, met = train_step(m2, prm, o2, batch, ocfg2)
        res[where] = {"loss": float(met["loss"]),
                      "grad_norm": float(met["grad_norm"])}
    # Bands: the loss within two bf16 ulps, the gradient norm within four
    # (bf16 compute, two accumulation orders: cuBLAS and the CPU's GEMM);
    # Adam's first update is ±lr an element whatever the gradient's size,
    # so an element whose tiny gradient flips sign moves by 2·lr: the
    # parameters within 2·lr (+1%), and the updates' signs agreeing on at
    # least 98% of the elements.
    upd_agree, upd_n, p_err = 0, 0, 0.0
    named_gpu = dict(p_gpu.named_parameters())
    for k, pc in p_cpu.named_parameters():
        pg = named_gpu[k].detach()
        pc = pc.detach().to(dev)
        p_err = max(p_err, max_err(pg, pc))
        du_c = torch.sign(pc - before[k])
        du_g = torch.sign(pg - before[k])
        upd_agree += int((du_c == du_g).sum())
        upd_n += du_c.numel()
        del pc, du_c, du_g
    agree = upd_agree / upd_n
    cpu_ok = (abs(res["card"]["loss"] - res["cpu"]["loss"])
              <= 2.0 ** -7 * abs(res["cpu"]["loss"])
              and abs(res["card"]["grad_norm"] - res["cpu"]["grad_norm"])
              <= 2.0 ** -6 * res["cpu"]["grad_norm"]
              and p_err <= 2.02 * ocfg2.lr and agree >= 0.98)
    assert cpu_ok, (res, p_err, agree)
    return res, p_err, agree


def resume_check(torch, cfg2, dev, bits_equal, data):
    """At a small depth ``cfg2``: an async save after a step on batch 1 of
    ``data``, a restore into fresh objects and a step on batch 2,
    bit-equal to the uninterrupted run (asserted).  Returns ``(save host
    seconds, resume exact)``."""
    from repro_torch.checkpoint import CheckpointConfig, Checkpointer
    from repro_torch.launch.train import restore_state, save_state, train_step
    from repro_torch.models import get_model
    from repro_torch.optim import OptConfig, adamw_init

    m_gpu = get_model(cfg2, device=dev)
    ocfg2 = OptConfig(lr=1e-3, warmup_steps=1)
    pa = m_gpu.init(2)
    oa = adamw_init(dict(pa.named_parameters()))
    pa, oa, _ = train_step(m_gpu, pa, oa, data.batch_at(1), ocfg2)
    with tempfile.TemporaryDirectory(prefix="chip_smoke-ckpt-") as d:
        ck = Checkpointer(CheckpointConfig(d))
        t0 = time.perf_counter()
        save_state(ck, 1, pa, oa, blocking=False)
        save_host_s = time.perf_counter() - t0
        pa, oa, met_a = train_step(m_gpu, pa, oa, data.batch_at(2), ocfg2)
        ck.wait()
        pb = m_gpu.init(7)
        ob, at = restore_state(ck, m_gpu, pb)
        assert at == 1 and int(ob["count"]) == 1
        pb, ob, met_b = train_step(m_gpu, pb, ob, data.batch_at(2), ocfg2)
    named_b = dict(pb.named_parameters())
    differ = sorted(
        [f"params.{k}" for k, v in pa.named_parameters()
         if not bits_equal(v.detach(), named_b[k].detach())]
        + [f"{mv}.{k}" for mv in ("m", "v") for k in oa[mv]
           if not bits_equal(oa[mv][k], ob[mv][k])])
    resume_exact = (not differ
                    and bits_equal(met_a["loss"], met_b["loss"])
                    and int(oa["count"]) == int(ob["count"]) == 2)
    assert resume_exact, differ[:10]
    return save_host_s, resume_exact


def train_checks(torch, cfg2, dev, bits_equal, max_err):
    """:func:`card_vs_cpu_step` and :func:`resume_check` at ``cfg2`` on a
    pipeline of one 256-token row a batch."""
    from repro_torch.data import DataConfig, TokenPipeline

    small = TokenPipeline(DataConfig(vocab=cfg2.vocab, seq_len=256,
                                     global_batch=1, seed=3))
    res, p_err, agree = card_vs_cpu_step(torch, cfg2, dev, max_err,
                                         small.batch_at(0))
    torch.cuda.empty_cache()
    save_host_s, resume_exact = resume_check(torch, cfg2, dev, bits_equal,
                                             small)
    return res, p_err, agree, save_host_s, resume_exact


def mamba2_train_phase(torch, dev, card_line, emit, reset, counts, time_ms,
                       bits_equal, max_err, device_ms, arch="mamba2-2.7b",
                       repeat_lr=3e-4) -> dict:
    """The ``mamba2_train`` phase (``zamba2_train`` for ``arch=
    "zamba2-2.7b"``); returns its record (a conv record)."""
    import numpy as np

    from repro_torch.configs import LM_SHAPES, get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import conv1d
    from repro_torch.launch.train import train_step
    from repro_torch.models import get_model, ssm
    from repro_torch.models.layers import embed_tokens, rms_norm
    from repro_torch.optim import OptConfig, adamw_init

    batch, seq = 2, LM_SHAPES["train_4k"].seq_len  # global batch 256 -> 2
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, pallas_conv=True, conv_tile=256))
    cdt = cfg.compute_dtype
    model = get_model(cfg, device=dev)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=0))
    opt_cfg = OptConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0)
    opt_state = adamw_init(dict(params.named_parameters()))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())

    def step(i, ocfg=opt_cfg, b=None):
        nonlocal params, opt_state
        params, opt_state, met = train_step(
            model, params, opt_state, data.batch_at(i) if b is None else b,
            ocfg)
        return met

    # The main path: counts zeroed just before, read just after; a cold
    # step, then 3 timed steps (host clock, the card synchronised).
    reset()
    per_step, step_s, losses, gnorms = [], [], [], []
    for i in range(4):
        before = counts()["conv1d"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = step(i)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        gnorms.append(float(met["grad_norm"]))
        per_step.append(counts()["conv1d"] - before)
    launched = counts()
    assert per_step == [2 * cfg.n_layers] * 4, per_step
    assert launched["sweep_apply"] == 0 and launched["sweep_chain"] == 0
    assert all(np.isfinite(v) for v in losses + gnorms), (losses, gnorms)
    timed_ms = [t * 1e3 for t in step_s[1:]]
    step_ms = statistics.median(timed_ms)
    tokens = batch * seq
    model_flops = 6 * n_params * tokens
    # Where a step's time goes (after the timed steps: its cost is in no
    # time above); device activity only.
    prof = profile_breakdown(torch, lambda: step(4), cpu=False)
    # The loss on a repeated batch over 3 steps (lr repeat_lr from the
    # first; 5 until the sharded stack's phases needed the time).
    repeat = data.batch_at(0)
    fast = OptConfig(lr=repeat_lr, warmup_steps=1)
    repeated = [float(step(0, fast, repeat)["loss"]) for _ in range(3)]
    falls = repeated[-1] < repeated[0]  # asserted after the record prints
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # The conv kernel on layer 0's training input (no state), against its
    # plain version; the plain VJP on the same input, timed beside it.
    with torch.no_grad():
        toks = torch.as_tensor(repeat["tokens"]).to(dev).long()
        p0 = params.layers[0].tensors()
        x0 = embed_tokens(cfg, params.embed.tensors(), toks)
        _, xbc, _ = ssm._in_proj(cfg, p0, rms_norm(x0, p0["ln"]))
        w, b = p0["conv_w"].to(cdt), p0["conv_b"].to(cdt)
        tile = cfg.ssm.conv_tile
        k_out = conv1d.causal_conv1d_launch(xbc, w, b, tile)
        p_out = conv1d.causal_conv1d_plain(xbc, w, b)
        torch.cuda.synchronize()
        exact = bits_equal(k_out, p_out)
        err = max_err(k_out, p_out)
        assert exact, err
        conv_ms = time_ms(lambda: conv1d.causal_conv1d_launch(xbc, w, b, tile),
                          reps=20, warmup=3)
        conv_dev = device_ms(
            lambda: conv1d.causal_conv1d_launch(xbc, w, b, tile), reps=10,
            kernel="conv1d_silu")
        g = torch.randn(xbc.shape, generator=torch.Generator(
            device=dev).manual_seed(9), device=dev).to(cdt)
        vjp_ms = time_ms(lambda: conv1d.causal_conv1d_vjp(xbc, w, b, g),
                         reps=10, warmup=2)
        vjp_prof = profile_breakdown(
            torch, lambda: conv1d.causal_conv1d_vjp(xbc, w, b, g), cpu=False)
        # Back-to-back calls between two CUDA events, over their count:
        # the device's time a call once the host runs ahead (no profiler).
        conv_stream = stream_ms(
            torch, lambda: conv1d.causal_conv1d_launch(xbc, w, b, tile), 50)
        vjp_stream = stream_ms(
            torch, lambda: conv1d.causal_conv1d_vjp(xbc, w, b, g), 10)
        n_el = xbc.numel()
        conv_bytes = (2 * n_el + w.numel() + b.numel()) * 2
        # The VJP reads x and g and writes dx (dw, db: 5 × C, not counted).
        vjp_bytes = 3 * n_el * 2
        conv_shape = list(xbc.shape)
        del x0, xbc, k_out, p_out, g
    del params, opt_state
    torch.cuda.empty_cache()

    # Two layers at full width (the hybrid: attn_every layers, one
    # shared-block application): one step on the card against the same
    # step on the CPU, and a resume bit-equal to the uninterrupted run.
    n2 = cfg.attn_every or 2
    res, p_err, agree, save_host_s, resume_exact = train_checks(
        torch, dataclasses.replace(cfg, n_layers=n2, loss_chunk=128), dev,
        bits_equal, max_err)
    torch.cuda.empty_cache()

    conv_tb = conv_bytes / HBM_BYTES_PER_S * 1e3
    conv_tf = (2 * 4 + 1 + 4) * n_el / F32_FLOPS_PER_S * 1e3
    phase = {
        "phase": f"{arch.split('-')[0]}_train", "arch": cfg.name,
        "layers": cfg.n_layers,
        "d_model": cfg.d_model, "params": n_params, "batch": batch,
        "seq": seq, "tokens_per_step": tokens, "conv_tile": tile,
        "init_s": init_s, "launches": launched,
        "conv_launches_per_step": per_step,
        "cold_step_ms": step_s[0] * 1e3, "step_ms": step_ms,
        "timed_step_ms": timed_ms,
        "tokens_per_s": tokens / step_ms * 1e3,
        "model_flops_per_step": model_flops,
        "model_flops_share_of_bf16_peak": (
            model_flops / (step_ms / 1e3) / BF16_FLOPS_PER_S),
        "peak_memory_gb": peak_gb, "losses": losses, "grad_norms": gnorms,
        "repeated_batch_losses": repeated, "profile_step": prof,
        "conv_shape": conv_shape, "exact_vs_plain": exact,
        "max_abs_err": err, "ms": conv_ms, "device_ms": conv_dev,
        "stream_ms": conv_stream, "vjp_stream_ms": vjp_stream,
        "bound_ms": max(conv_tb, conv_tf),
        "bound_by": "bytes" if conv_tb >= conv_tf else "operations",
        "plain_ms": None, "library_ms": None,
        "vjp_ms": vjp_ms, "vjp_device_ms": vjp_prof.get("device_busy_ms"),
        "vjp_launches": vjp_prof.get("kernel_launches"),
        "vjp_bound_ms": vjp_bytes / HBM_BYTES_PER_S * 1e3,
        f"card_vs_cpu_{n2}layer": res, "card_vs_cpu_param_max_abs_err": p_err,
        "card_vs_cpu_update_sign_agreement": agree,
        "save_host_s": save_host_s, "resume_bit_equal": resume_exact,
        "repeated_batch_loss_falls": falls, "repeat_lr": repeat_lr,
        "card": card_line,
    }
    emit(phase)
    assert falls, repeated
    return phase


# families_serve: (arch, batch, prompt tokens, layers and tokens of the
# card-vs-CPU check, 0: none).  Depth is cut only where the weights would
# not fit (fit_layers); mixtral's 4608-token prompt passes its 4096-token
# window, so the window masks on the card.
FAMILIES = [
    ("internvl2-2b", 4, 2048, 2, 256),
    ("whisper-large-v3", 4, 448, 2, 256),
    ("qwen1.5-32b", 4, 2048, 0, 0),
    ("internlm2-20b", 4, 2048, 0, 0),
    ("llama3-405b", 4, 2048, 0, 0),
    ("mixtral-8x22b", 1, 4608, 1, 128),
    ("arctic-480b", 4, 2048, 1, 64),
]
WEIGHTS_BUDGET_GB = 60.0  # of the card's 80: activations, casts, caches


def fit_layers(cfg, budget_gb=WEIGHTS_BUDGET_GB) -> int:
    """The most decoder layers whose weights, with the embeddings (and an
    encoder, which is never cut), fit in ``budget_gb``."""
    from repro_torch.models import count_params

    nbytes = _itemsize(cfg.param_dtype)
    fixed = count_params(dataclasses.replace(cfg, n_layers=0)) * nbytes
    per = count_params(dataclasses.replace(cfg, n_layers=1)) * nbytes - fixed
    return min(cfg.n_layers, int((budget_gb * 1e9 - fixed) // per))


def _itemsize(dtype) -> int:
    import torch

    return torch.empty((), dtype=dtype).element_size()


def _forward_logits(torch, cfg, params, prompts, extra, last=None):
    """A teacher-forced forward of ``prompts`` (after the VLM prefix, or
    from the encoded frames), under ``inference_mode``: the logits of the
    prompt's positions (the last ``last`` of them, or all)."""
    from repro_torch.models import encdec, transformer
    from repro_torch.models.layers import unembed

    with torch.inference_mode():
        if cfg.family == "encdec":
            enc = encdec.encode(cfg, params, extra["frames"])
            x, _ = encdec.decode_stack(cfg, params, prompts, 0, enc)
            del enc
        else:
            pre = extra.get("prefix_embeds")
            x, _ = transformer.lm_forward(cfg, params, prompts, 0,
                                          prefix_embeds=pre)
            if pre is not None:
                x = x[:, pre.shape[1]:]
        if last is not None:
            x = x[:, -last:]
        return unembed(cfg, params.embed.tensors(), x)


def lm_serve_phase(torch, dev, card_line, emit, reset, counts, max_err,
                   arch, batch, prompt, gen, layers=None, warm=1,
                   profile=False, cpu_layers=0, cpu_tokens=256,
                   name=None) -> dict:
    """One transformer family served through ``launch.serve.serve`` at
    published width, ``layers`` decoder layers (None: all), weights from
    seed 0: a cold run, then ``warm`` warm runs for the times (best of);
    the main path launches none of the port's kernels (their counts stay
    0).  Checks: the tokens' shape and range; prefill(S−1) + decode(1)
    against teacher-forced forwards, in the band of the reference's
    ``tests/test_models.py::test_decode_matches_teacher_forcing``: the
    prefill's last logits against a forward of the same S−1 tokens (same
    capacity, so an MoE's routes must be identical; always gated), the
    decode step's against a forward of all S tokens (gated only where
    that forward dropped no MoE assignment: a capacity depends on the
    token count); at ``cpu_layers`` layers and
    full width, the card against the CPU (plain versions, same weights):
    prefill and 2 decode steps at batch 1 × ``cpu_tokens``, or for MoE
    one forward whose routes are compared token by token, the logits held
    on the tokens whose routes agree.  Returns the phase record."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve, stub_inputs
    from repro_torch.models import get_model

    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    model = get_model(cfg, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    param_gb = sum(p.numel() * p.element_size()
                   for p in params.parameters()) / 1e9
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=g,
                            device=dev)
    extra = stub_inputs(cfg, batch, g)
    f = (extra["prefix_embeds"].shape[1] if "prefix_embeds" in extra
         else 0)
    specs = model.cache_specs(batch, f + prompt + gen)
    cache_gb = {}
    for part in ("self", "cross"):
        sub = specs.get(part, specs if part == "self" else {})
        cache_gb[part] = sum(prod(sub[k].shape) * _itemsize(sub[k].dtype)
                             for k in ("k", "v") if k in sub) / 1e9

    # The main path: counts zeroed just before, read just after.
    rec = params.moe_routes = [] if cfg.moe is not None else None
    reset()
    toks, cold = serve(cfg, params, prompts, gen, device=dev, **extra)
    launched = counts()
    params.moe_routes = None
    assert not any(launched.values()), launched  # no kernel of ours here
    assert tuple(toks.shape) == (batch, gen), toks.shape
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab
    runs = [serve(cfg, params, prompts, gen, device=dev, **extra)
            for _ in range(warm)]
    same_tokens = all(bool(torch.equal(t, toks)) for t, _ in runs)
    prefill_ms = min(w["prefill_s"] for _, w in runs) * 1e3
    decode_ms = min(w["decode_s"] for _, w in runs) * 1e3 / (gen - 1)
    drops = None
    if rec is not None:
        n = cfg.n_layers
        drops = {"prefill_by_layer": [int(r["dropped"].sum())
                                      for r in rec[:n]],
                 "decode_total": int(sum(int(r["dropped"].sum())
                                         for r in rec[n:])),
                 "assignments_per_layer": int(rec[0]["dropped"].numel())}
    prof = None
    if profile:
        # Where the time goes, after the timed runs: one prefill and one
        # decode step under the profiler.
        pc = model.init_cache(batch, f + prompt + 1)
        prof = {"prefill": profile_breakdown(torch, lambda: model.prefill(
            params, {"tokens": prompts, **extra}, pc))}
        prof["decode_step"] = profile_breakdown(
            torch, lambda: model.decode_step(params, pc, toks[:, :1],
                                             f + prompt))
        del pc

    # prefill(S-1) + decode(1) against teacher-forced forwards.  The
    # prefill's last logits are held to a forward of the same S-1 tokens:
    # the same token count gives an MoE layer the same capacity, so the
    # two route alike (asserted) and this half is gated for every family.
    # The decode step is held to a forward of all S tokens, whose capacity
    # differs: gated only where that forward dropped no assignment.
    moe = cfg.moe is not None
    pre_rec = params.moe_routes = [] if moe else None
    cache = model.init_cache(batch, f + prompt)
    lg1, cache = model.prefill(params, {"tokens": prompts[:, :-1], **extra},
                               cache)
    lg2, _ = model.decode_step(params, cache, prompts[:, -1:], f + prompt - 1)
    del cache
    tf_rec = params.moe_routes = [] if moe else None
    ref = _forward_logits(torch, cfg, params, prompts, extra, last=2).float()
    routes_same = None
    if moe:
        same_rec = params.moe_routes = []
        ref1 = _forward_logits(torch, cfg, params, prompts[:, :-1], extra,
                               last=1).float()[:, 0]
        routes_same = len(same_rec) == cfg.n_layers and all(
            bool(torch.equal(a["eidx"], b["eidx"]))
            and bool(torch.equal(a["dropped"], b["dropped"]))
            for a, b in zip(pre_rec[:cfg.n_layers], same_rec))
    else:
        ref1 = ref[:, 0]  # causal: the S-token forward's position S-2
    params.moe_routes = None
    tf_err = [max_err(lg1[:, 0], ref1), max_err(lg2[:, 0], ref[:, 1])]
    tf_prefill_ok, tf_ok = (
        bool(torch.allclose(a[:, 0].float(), r, atol=0.2, rtol=0.05))
        for a, r in ((lg1, ref1), (lg2, ref[:, 1])))
    tf_dropped = (None if tf_rec is None else
                  int(sum(int(r["dropped"].sum()) for r in tf_rec)))
    tf_gated = not tf_dropped
    del lg1, lg2, ref, ref1
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    cpu = None
    if cpu_layers:
        small = dataclasses.replace(
            full, n_layers=cpu_layers,
            enc_layers=cpu_layers if full.enc_layers else 0)
        cpu = lm_card_vs_cpu(torch, small, dev, max_err, cpu_tokens)
    phase = {
        "phase": name or f"{arch}_serve", "arch": cfg.name,
        "layers": cfg.n_layers, "published_layers": full.n_layers,
        "enc_layers": cfg.enc_layers or None, "d_model": cfg.d_model,
        "params": n_params, "param_gb": param_gb,
        "param_dtype": str(cfg.param_dtype).removeprefix("torch."),
        "batch": batch, "prompt_tokens": prompt, "prefix_tokens": f,
        "frames": cfg.frontend_len if cfg.family == "encdec" else None,
        "generated_tokens": gen, "decode_steps": gen - 1,
        "launches": launched, "init_s": init_s, "cold": cold,
        "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
        "prefill_tokens_per_s": batch * prompt / prefill_ms * 1e3,
        "decode_tokens_per_s": batch / decode_ms * 1e3,
        "same_tokens_warm": same_tokens, "peak_memory_gb": peak_gb,
        "kv_cache_gb": cache_gb["self"], "cross_kv_gb": cache_gb["cross"],
        "moe_dropped": drops, "profile": prof,
        "teacher_forcing_max_abs_err": tf_err,
        "teacher_forcing_prefill_ok": tf_prefill_ok,
        "teacher_forcing_prefill_routes_identical": routes_same,
        "teacher_forcing_ok": tf_ok,
        "teacher_forcing_dropped_assignments": tf_dropped,
        "teacher_forcing_gated": tf_gated, "card_vs_cpu": cpu,
        "card": card_line,
    }
    emit(phase)
    assert tf_prefill_ok and routes_same is not False, (tf_err, routes_same)
    assert tf_ok or not tf_gated, tf_err
    assert peak_gb <= 75.0, peak_gb
    return phase


def lm_card_vs_cpu(torch, cfg2, dev, max_err, tokens) -> dict:
    """``cfg2`` (a small depth at full width) on the card and on the CPU
    (plain versions) with the same weights (seed 1, drawn on the card and
    copied to the CPU).
    Dense, VLM and encoder-decoder: prefill of batch 1 × ``tokens`` (after
    the whole prefix, or from all the frames) and 2 decode steps, the
    logits within the band of ``mamba2_serve``'s check (asserted).  MoE:
    one forward of the tokens; the share of (token, k) routes that differ
    between the two, and the logits held on the tokens whose routes (and
    drops) agree (asserted)."""
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models import get_model

    m_gpu = get_model(cfg2, device=dev)
    p_gpu = m_gpu.init(1)
    p_cpu = m_gpu.fam.module(cfg2, device="cpu")
    p_cpu.load_state_dict(p_gpu.state_dict())
    g = torch.Generator().manual_seed(7)
    small = torch.randint(0, cfg2.vocab, (1, tokens + 2), generator=g)
    extra = stub_inputs(cfg2, 1, g)
    f = (extra["prefix_embeds"].shape[1] if "prefix_embeds" in extra
         else 0)
    out, routes = {}, {}
    for where, prm in (("cpu", p_cpu), ("card", p_gpu)):
        d = "cpu" if where == "cpu" else dev
        ex = {k: v.to(d) for k, v in extra.items()}
        if cfg2.moe is not None:
            rec = prm.moe_routes = []
            out[where] = _forward_logits(torch, cfg2, prm,
                                         small[:, :tokens].to(d),
                                         ex)[0].float().cpu()
            routes[where] = [(r["eidx"].cpu(), r["dropped"].cpu())
                             for r in rec]
            continue
        m2 = get_model(cfg2, device=d)
        cache = m2.init_cache(1, f + tokens + 2)
        lg, cache = m2.prefill(prm, {"tokens": small[:, :tokens], **ex},
                               cache)
        lgs = [lg]
        for i in (tokens, tokens + 1):
            lg, cache = m2.decode_step(prm, cache, small[:, i:i + 1], f + i)
            lgs.append(lg)
        out[where] = torch.cat(lgs, 1).float().cpu()
    del p_cpu, p_gpu
    torch.cuda.empty_cache()
    # Band: bf16 logits of magnitude ~1-4 (ulp 2^-7..2^-6) from two
    # accumulation orders (cuBLAS, the CPU's GEMM) and per-op bf16 rounding.
    res = {"layers": cfg2.n_layers, "tokens": tokens,
           "max_abs_err": max_err(out["card"], out["cpu"])}
    if cfg2.moe is None:
        ok = bool(torch.allclose(out["card"], out["cpu"], atol=0.1,
                                 rtol=0.02))
    else:
        agree = torch.ones(tokens, dtype=torch.bool)
        same = differ = 0
        for (e_c, d_c), (e_g, d_g) in zip(routes["cpu"], routes["card"]):
            eq = (e_c == e_g) & (d_c == d_g)
            same += int(eq.sum())
            differ += int((~eq).sum())
            agree &= eq.all(-1)
        res.update(route_share_differ=differ / (same + differ),
                   tokens_agreeing=int(agree.sum()),
                   max_abs_err_agreeing=max_err(out["card"][agree],
                                                out["cpu"][agree]))
        ok = bool(torch.allclose(out["card"][agree], out["cpu"][agree],
                                 atol=0.1, rtol=0.02))
    res["ok"] = ok
    assert ok, res
    return res


def lm_train_phase(torch, dev, card_line, emit, reset, counts, bits_equal,
                   max_err, arch="granite-3-2b", repeat_lr=3e-4) -> dict:
    """``granite_train``: the model at published width and depth trained
    through ``launch.train.train_step`` on the pipeline's synthetic
    batches at ``LM_SHAPES["train_4k"]``'s 4096 tokens, batch 2 (the
    global batch of 256 cut to one card): a cold step and 3 timed steps
    (host clock, card synchronised; tokens/s, 6·N·tokens against the bf16
    peak, peak memory at most 75 GB), one step under the profiler, 5 steps
    on a repeated batch at ``repeat_lr`` (the loss falls), and at 2 layers
    :func:`train_checks`.  The main path launches none of the port's
    kernels."""
    import numpy as np

    from repro_torch.configs import LM_SHAPES, get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.train import train_step
    from repro_torch.models import get_model
    from repro_torch.optim import OptConfig, adamw_init

    batch, seq = 2, LM_SHAPES["train_4k"].seq_len  # global batch 256 -> 2
    cfg = get_config(arch)
    model = get_model(cfg, device=dev)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=0))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0)
    opt_state = adamw_init(dict(params.named_parameters()))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())

    def step(i, ocfg=OptConfig(), b=None):
        nonlocal params, opt_state
        params, opt_state, met = train_step(
            model, params, opt_state, data.batch_at(i) if b is None else b,
            ocfg)
        return met

    # The main path: counts zeroed just before, read just after.
    reset()
    step_s, losses, gnorms = [], [], []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = step(i)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        gnorms.append(float(met["grad_norm"]))
    launched = counts()
    assert not any(launched.values()), launched
    assert all(np.isfinite(v) for v in losses + gnorms), (losses, gnorms)
    timed_ms = [t * 1e3 for t in step_s[1:]]
    step_ms = statistics.median(timed_ms)
    tokens = batch * seq
    model_flops = 6 * n_params * tokens
    prof = profile_breakdown(torch, lambda: step(4), cpu=False)
    repeat = data.batch_at(0)
    fast = OptConfig(lr=repeat_lr, warmup_steps=1)
    repeated = [float(step(0, fast, repeat)["loss"]) for _ in range(5)]
    falls = repeated[-1] < repeated[0]  # asserted after the record prints
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params, opt_state
    torch.cuda.empty_cache()

    res, p_err, agree, save_host_s, resume_exact = train_checks(
        torch, dataclasses.replace(cfg, n_layers=2, loss_chunk=128), dev,
        bits_equal, max_err)
    torch.cuda.empty_cache()
    phase = {
        "phase": f"{arch.split('-')[0]}_train", "arch": cfg.name,
        "layers": cfg.n_layers, "d_model": cfg.d_model, "params": n_params,
        "batch": batch, "seq": seq, "tokens_per_step": tokens,
        "init_s": init_s, "launches": launched,
        "cold_step_ms": step_s[0] * 1e3, "step_ms": step_ms,
        "timed_step_ms": timed_ms, "tokens_per_s": tokens / step_ms * 1e3,
        "model_flops_per_step": model_flops,
        "model_flops_share_of_bf16_peak": (
            model_flops / (step_ms / 1e3) / BF16_FLOPS_PER_S),
        "peak_memory_gb": peak_gb, "losses": losses, "grad_norms": gnorms,
        "repeated_batch_losses": repeated, "repeat_lr": repeat_lr,
        "repeated_batch_loss_falls": falls, "profile_step": prof,
        "card_vs_cpu_2layer": res, "card_vs_cpu_param_max_abs_err": p_err,
        "card_vs_cpu_update_sign_agreement": agree,
        "save_host_s": save_host_s, "resume_bit_equal": resume_exact,
        "card": card_line,
    }
    emit(phase)
    assert peak_gb <= 75.0, peak_gb
    assert falls, repeated
    return phase



def _step_pair(torch, model, seed, batch, ocfg, mesh):
    """One ``train_step`` of fresh weights (``seed``) on ``batch``, under
    ``activate_mesh(mesh)`` unless ``mesh`` is None: the loss and the
    updated parameters, and the constraints resolved on the way."""
    from repro_torch.launch.train import train_step
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import activate_mesh, record_constraints

    params = model.init(seed)
    opt = adamw_init(dict(params.named_parameters()))
    if mesh is None:
        _, _, met = train_step(model, params, opt, batch, ocfg)
        seen = []
    else:
        with activate_mesh(mesh), record_constraints() as seen:
            _, _, met = train_step(model, params, opt, batch, ocfg)
    torch.cuda.synchronize()
    return met["loss"], params, len(seen)


def mesh_step_phase(torch, dev, card_line, emit, reset, counts, bits_equal,
                    max_err) -> dict:
    """``mesh_step``: the trainer's mesh on the card.  For granite-3-2b at
    2 layers and full width, and for 1 mixtral-8x22b layer at full width
    bound to ``dp=2`` (two dispatch groups, batch 2 × 64): one training
    step under ``activate_mesh(make_test_mesh())`` is bit-equal (loss and
    every updated parameter) to the same step without a mesh, and the
    step on the card is held to the CPU's within ``mamba2_train``'s bands
    (``card_vs_cpu_step``).  Then ``launch.train.main`` runs 2 granite
    steps (40 layers, batch 2 × 256) under its own mesh."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import get_model
    from repro_torch.optim import OptConfig

    mesh = make_test_mesh()
    rows = []
    reset()
    for arch, layers, batch, seq in (("granite-3-2b", 2, 1, 256),
                                     ("mixtral-8x22b", 1, 2, 64)):
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  loss_chunk=min(seq, 128))
        if cfg.moe is not None:
            cfg = cfg.bind(tp=1, dp=2)
        model = get_model(cfg, device=dev)
        data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                        global_batch=batch, seed=4))
        b = data.batch_at(0)
        ocfg = OptConfig(lr=1e-3, warmup_steps=1)
        t0 = time.perf_counter()
        l0, p0, _ = _step_pair(torch, model, 3, b, ocfg, None)
        named0 = {k: v.detach().clone() for k, v in p0.named_parameters()}
        del p0
        l1, p1, n_seen = _step_pair(torch, model, 3, b, ocfg, mesh)
        differ = [k for k, v in p1.named_parameters()
                  if not bits_equal(v.detach(), named0[k])]
        exact = bits_equal(l0, l1) and not differ
        step_s = time.perf_counter() - t0
        del p1, named0
        torch.cuda.empty_cache()
        res, p_err, agree = card_vs_cpu_step(torch, cfg, dev, max_err, b)
        torch.cuda.empty_cache()
        rows.append({
            "arch": cfg.name, "layers": layers, "batch": batch, "seq": seq,
            "tp": cfg.tp, "dp": cfg.dp, "mesh": mesh.shape,
            "constraints_resolved": n_seen, "loss": float(l0),
            "mesh_bit_equal": exact, "params_differing": differ[:5],
            "two_steps_s": step_s, "card_vs_cpu": res,
            "card_vs_cpu_param_max_abs_err": p_err,
            "card_vs_cpu_update_sign_agreement": agree,
        })
    # launch.train.main with its mesh: the 40-layer model, 2 steps.
    t0 = time.perf_counter()
    losses = ttrain.main(["--arch", "granite-3-2b", "--steps", "2",
                          "--batch", "2", "--seq", "256", "--log-every",
                          "1"])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    launched = counts()
    phase = {
        "phase": "mesh_step", "rows": rows, "launches": launched,
        "train_main_losses": losses, "train_main_s": main_s,
        "card": card_line,
    }
    emit(phase)
    assert not any(launched.values()), launched
    assert all(r["mesh_bit_equal"] and r["constraints_resolved"] > 0
               for r in rows), rows
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    return phase


def roofline_phase(torch, card_line, emit, granite) -> dict:
    """``roofline_granite_train``: granite-3-2b's full-width training step
    at ``granite_train``'s batch (2 × 4096) counted by
    ``launch.op_analysis`` (on ``meta``: the same ops, nothing
    allocated), its roofline on this card's published peaks
    (``launch.roofline``), beside the step ``granite_train`` measured.
    Gates: ``useful_flop_ratio`` at most 1 (model flops 6·N·tokens are a
    part of the counted ones), and the measured step no shorter than
    ``max(t_compute, t_memory)``: no card beats its own roofline, so a
    failure means the count is wrong."""
    from repro_torch.configs import LM_SHAPES, get_config
    from repro_torch.launch import roofline as rf
    from repro_torch.launch.op_analysis import LiveBytes, count_ops
    from repro_torch.launch.train import train_step
    from repro_torch.models import batch_specs, count_params, get_model
    from repro_torch.optim import OptConfig, adamw_init

    t0 = time.perf_counter()
    cfg = get_config("granite-3-2b")
    shape = dataclasses.replace(LM_SHAPES["train_4k"],
                                global_batch=granite["batch"])
    model = get_model(cfg, device="meta")
    params = model.init()
    opt = adamw_init(dict(params.named_parameters()))
    batch = {k: torch.empty(sp.shape, dtype=sp.dtype, device="meta")
             for k, sp in batch_specs(cfg, shape).items()}
    with LiveBytes() as live:
        _, cost = count_ops(lambda: train_step(model, params, opt, batch,
                                               OptConfig()))
    count_s = time.perf_counter() - t0
    tokens = shape.global_batch * shape.seq_len
    model_flops = 6.0 * count_params(cfg) * tokens
    roof = rf.analyze(cost, model_flops, 1)
    step_s = granite["step_ms"] / 1e3
    floor_s = max(roof.t_compute, roof.t_memory)
    phase = {
        "phase": "roofline_granite_train", "arch": cfg.name,
        "batch": shape.global_batch, "seq": shape.seq_len,
        "model_flops": model_flops, "counted_flops": cost.flops,
        "counted_hbm_bytes": cost.hbm_bytes,
        "counted_flops_by_op": cost.per_op,
        "useful_flop_ratio": roof.useful_ratio,
        "t_compute_s": roof.t_compute, "t_memory_s": roof.t_memory,
        "bottleneck": roof.bottleneck,
        "measured_step_s": step_s,
        "measured_over_roofline": step_s / floor_s,
        "counted_temp_bytes": live.peak, "count_s": count_s,
        "peaks": {"flops": rf.PEAK_FLOPS, "hbm": rf.HBM_BW},
        "card": card_line,
    }
    emit(phase)
    assert roof.useful_ratio <= 1.0, phase
    assert step_s >= floor_s, phase
    return phase


def dryrun_phase(card_line, emit) -> dict:
    """``dryrun_cells``: ``python -m repro_torch.launch.dryrun`` for
    granite-3-2b ``train_4k`` on the 16×16 mesh and mixtral-8x22b
    ``decode_32k`` on 2×16×16, in a child process that sees no card
    (``CUDA_VISIBLE_DEVICES=""``): the dry-run runs on the host only, on
    ``meta``.  Each record's GB per device, ``fits_80g``, bottleneck and
    seconds."""
    rows = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke-dryrun-") as d:
        out = os.path.join(d, "dryrun.jsonl")
        env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
        for arch, shape, mesh in (("granite-3-2b", "train_4k", "single"),
                                  ("mixtral-8x22b", "decode_32k", "multi")):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", mesh,
                 "--out", out, "--force"],
                env=env, capture_output=True, text=True, timeout=600,
                cwd=ROOT)
            if proc.returncode:
                fail(f"dryrun {arch} {shape}: {proc.stderr[-2000:]}")
            rec = json.loads(Path(out).read_text().splitlines()[-1])
            if not rec.get("ok"):
                fail(f"dryrun {arch} {shape}: {rec.get('error')}")
            rows.append({
                "arch": arch, "shape": shape, "mesh": rec["mesh"],
                "gb_per_device": rec["bytes_per_device"] / 1e9,
                "argument_gb": rec["memory"]["argument_size_in_bytes"] / 1e9,
                "temp_gb": rec["memory"]["temp_size_in_bytes"] / 1e9,
                "fits_80g": rec["fits_80g"],
                "bottleneck": rec["roofline"]["bottleneck"],
                "t_compute_s": rec["roofline"]["t_compute_s"],
                "t_memory_s": rec["roofline"]["t_memory_s"],
                "t_collective_s": rec["roofline"]["t_collective_s"],
                "trace_s": rec["trace_s"],
                "seconds": time.perf_counter() - t0,
            })
    phase = {"phase": "dryrun_cells", "where": "host only (meta device, "
             "CUDA_VISIBLE_DEVICES empty)", "rows": rows,
             "card": card_line}
    emit(phase)
    return phase


def mixtral_train_phase(torch, dev, card_line, emit, reset, counts) -> dict:
    """``mixtral_train``: MoE training on the card.  mixtral-8x22b at
    published width, depth cut to 1 of 56 layers (its training state is
    ~40 GB a layer: two do not fit one card), weights from seed 0, trained
    through ``launch.train.train_step`` at batch 1 × 4096 for 3 steps:
    step time (host clock, card synchronised), tokens/s, peak memory (at
    most 75 GB), and the MoE assignments dropped at capacity (one
    forward of the first batch without autograd, routes recorded).  Gated
    on a finite loss and gradient norm at every step."""
    import numpy as np

    from repro_torch.configs import LM_SHAPES, get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.train import train_step
    from repro_torch.models import get_model, transformer
    from repro_torch.optim import OptConfig, adamw_init

    seq = LM_SHAPES["train_4k"].seq_len
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=1)
    model = get_model(cfg, device=dev)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=1, seed=0))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0)
    opt = adamw_init(dict(params.named_parameters()))
    n_params = sum(p.numel() for p in params.parameters())
    state_gb = torch.cuda.memory_allocated() / 1e9
    reset()
    step_s, losses, gnorms = [], [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = train_step(model, params, opt, data.batch_at(i),
                                      OptConfig())
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launched = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    routes = params.moe_routes = []
    with torch.inference_mode():
        toks = torch.as_tensor(data.batch_at(0)["tokens"]).to(dev).long()
        transformer.lm_forward(cfg, params, toks, 0)
    params.moe_routes = None
    dropped = [int(r["dropped"].sum()) for r in routes]
    step_ms = statistics.median(step_s[1:]) * 1e3
    del params, opt
    torch.cuda.empty_cache()
    phase = {
        "phase": "mixtral_train", "arch": cfg.name, "layers": 1,
        "published_layers": get_config("mixtral-8x22b").n_layers,
        "d_model": cfg.d_model, "experts": cfg.moe.n_experts,
        "params": n_params, "batch": 1, "seq": seq,
        "state_gb_before_step": state_gb, "launches": launched,
        "cold_step_ms": step_s[0] * 1e3, "step_ms": step_ms,
        "tokens_per_s": seq / step_ms * 1e3, "peak_memory_gb": peak_gb,
        "losses": losses, "grad_norms": gnorms,
        "assignments": seq * cfg.moe.top_k, "dropped": dropped,
        "card": card_line,
    }
    emit(phase)
    assert not any(launched.values()), launched
    assert all(np.isfinite(v) for v in losses + gnorms), (losses, gnorms)
    assert peak_gb <= 75.0, peak_gb
    return phase


def lm_examples_phase(torch, card_line, emit, reset, counts) -> dict:
    """``lm_examples``: the ``train_lm`` twin at its 100M config on the
    card, 60 steps at batch 8 × 256 (checkpoints to a temporary
    directory): the mean of the last 5 losses below that of the first 5;
    then the ``serve_lm`` twin (mixtral-8x22b's smoke config)."""
    import numpy as np

    from repro_torch.examples import serve_lm, train_lm

    reset()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-lm100m-") as d:
        losses = train_lm.main(["--steps", "60", "--batch", "8", "--seq",
                                "256", "--ckpt-dir", d])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = serve_lm.main(["--arch", "mixtral-8x22b"])
    serve_s = time.perf_counter() - t0
    launched = counts()
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    phase = {
        "phase": "lm_examples", "train_lm_steps": len(losses),
        "train_lm_first5": first, "train_lm_last5": last,
        "train_lm_s": train_s, "serve_lm_arch": "mixtral-8x22b",
        "serve_lm_tokens_shape": list(toks.shape), "serve_lm_s": serve_s,
        "launches": launched, "card": card_line,
    }
    emit(phase)
    assert len(losses) == 60 and last < first, (first, last)
    assert tuple(toks.shape) == (4, 12)
    return phase


if __name__ == "__main__":
    main()
