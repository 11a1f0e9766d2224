#!/usr/bin/env python3
"""Time edited copies of the conv and apply kernels against each other.

Run on an NVIDIA H100 from the root of a checkout:

    python3 scripts/kernel_variants.py [--reps 10] [--rounds 2] \
        [--phases NAME ...] [--variants NAME ...]

Each variant is a copy of ``src/repro_torch/csrc/conv1d.cu`` or
``sweep_apply.cu`` with the text substitutions listed in ``VARIANTS``
(the empty one is the source as it is), compiled with the port's nvcc
flags into ``build/variants/`` (one nvcc each, all at once), and swapped
in for the wrapper's library.  On the shapes of ``chip_smoke.py``'s
phases (the 512³ f32 and 256³ bf16 p = 2 applications, the sweep-axis-1
p = 2 application, and Mamba2-2.7B's prefill conv, 4 × 2048 × 5376 bf16)
and the benchmark's planned applications (the 13-point star and the
27-point box at 512³ on tile (8, 32, 32), the star at 128³ on tile
(128, 2, 32), and the bf16 13-point star at 512³ on the caller's grid at
its planned tile (16, 16, 64), ``star13bf16-apply-512``'s one launch),
each variant is held bit for bit against the plain version, then its
kernel's device time is read with ``torch.profiler`` (median of
``--reps`` launches), the variants in turns, ``--rounds`` times.  Each
application runs twice: on the padded launch buffer (``.padded``, the
grid copied into a zero halo beforehand; not for the bf16 512³ star) and
on the grid as it is (``.direct``, the kernel zero-filling its window
outside the grid), so a slower kernel shows apart from the buffer's
removal.
Prints the card, each variant's ptxas register and spill lines, and one
JSON line per (variant, phase, round).  ``--phases`` keeps the phases
whose names start with one of the names given, ``--variants`` the named
variants of each kernel (``as_built`` always).
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

# kernel -> variant -> {old text: new text}; for the conv, "(vec)" is the
# most channels a thread the wrapper may pick.
VARIANTS = {
    "sweep_apply": {
        "as_built": {},
        "min_blocks_1": {"__launch_bounds__(512, 2)":
                         "__launch_bounds__(512, 1)"},
        # every window row through the piecewise row copy, none through
        # the flat path of an aligned launch
        "no_copy16": {"P.copy16 = rows_copy16(geom, ins, &P.head, &P.tail);":
                      "rows_copy16(geom, ins, &P.head, &P.tail);\n"
                      "  P.copy16 = 0;"},
        # every bf16 launch through the element loop, none through the
        # pair loop
        "no_pair": {"P.pair = rows_pair(P, dtype, sweep, ins);":
                    "P.pair = 0;"},
        # eight sweep rows a thread (both loops; spills in bf16)
        "rows8": {"constexpr int kRows = 4;": "constexpr int kRows = 8;"},
        # eight sweep rows a thread in the bf16 pair loop alone
        "pair_rows8": {"constexpr int kPairRows = 4;":
                       "constexpr int kPairRows = 8;"},
    },
    "conv1d": {
        "as_built": {},
        # 8 bf16 channels (16 bytes) a thread, the instantiation restored
        "vec8": {"(vec)": 8,
                 "      case 4: return pick_width<__nv_bfloat16, 4>(width);":
                 "      case 4: return pick_width<__nv_bfloat16, 4>(width);\n"
                 "      case 8: return pick_width<__nv_bfloat16, 8>(width);"},
        "run16": {"kRun = 32;": "kRun = 16;"},
        "run64": {"kRun = 32;": "kRun = 64;"},
    },
}


def build(name, tag, subs, out_dir, nvcc, flags, csrc):
    src = (csrc / f"{name}.cu").read_text()
    for old, new in subs.items():
        if old.startswith("("):
            continue
        if old not in src:
            raise SystemExit(f"{name}/{tag}: {old!r} is not in the source")
        src = src.replace(old, new)
    cu = out_dir / f"{name}_{tag}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    proc = subprocess.Popen([nvcc, *flags, "-I", str(csrc), "-o", str(so),
                             str(cu)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return so, proc


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--phases", nargs="*", default=None)
    ap.add_argument("--variants", nargs="*", default=None)
    args = ap.parse_args()
    if args.variants is not None:
        for variants in VARIANTS.values():
            for tag in list(variants):
                if tag != "as_built" and tag not in args.variants:
                    del variants[tag]

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from repro_torch.core.cache_fitting import star_stencil
    from repro_torch.kernels import _build, conv1d, ref, sweep
    from repro_torch.kernels import stencil as st

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    libs = {}
    procs = {}
    for name, variants in VARIANTS.items():
        for tag, subs in variants.items():
            procs[name, tag] = build(name, tag, subs, out_dir, nvcc,
                                     _build.NVCC_FLAGS, _build.CSRC)
    for (name, tag), (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}/{tag}:\n{out}{err}")
        lines = _build._ptxas_lines(out + err)
        print(json.dumps({"variant": f"{name}/{tag}", "ptxas": [
            ln for ln in lines if "Used" in ln or "spill" in ln
            or "entry" in ln]}), flush=True)
        libs[name, tag] = ctypes.CDLL(str(so))

    vec_as_built = conv1d._vec

    def vec_at_most(widest, c, x, out, state):
        """The wrapper's choice, or ``widest`` channels a thread where C
        is a multiple of it and every buffer starts aligned to it."""
        bufs = [t for t in (x, out, state) if t is not None]
        if widest > conv1d._VEC and c % widest == 0 and all(
                t.data_ptr() % (widest * x.element_size()) == 0
                for t in bufs):
            return widest
        return min(widest, vec_as_built(c, x, out, state))

    def use(name, tag):
        lib = libs[name, tag]
        if name == "sweep_apply":
            fn = lib.sweep_apply_launch
            fn.restype = ctypes.c_int
            fn.argtypes = sweep._ARGTYPES["sweep_apply_launch"]
            sweep._ENTRIES["sweep_apply", "launch"] = fn
        else:
            _build._LIBS["conv1d"] = lib
            widest = VARIANTS[name][tag].get("(vec)", conv1d._VEC)
            conv1d._vec = (lambda c, x, out, state=None, widest=widest:
                           vec_at_most(widest, c, x, out, state))

    def device_ms(fn, kernel):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        ts = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and kernel in e.name]
        return statistics.median(ts) if ts else None

    def bits(t):
        return t.contiguous().view(torch.int16 if t.element_size() == 2
                                   else torch.int32)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)

    def spec(offsets, weights):
        return (tuple(map(tuple, np.asarray(offsets).tolist())),
                tuple(float(w) for w in weights))

    offs13, w13 = ref.star_weights_2nd_order(3, 2)
    offs7 = star_stencil(3, 1)
    w7 = [-1.5] + [0.25] * 6
    offs_r = star_stencil(3, 1)[::-1].copy()
    w_r = [0.25] * 6 + [-1.5]
    box = np.array(list(itertools.product((-1, 0, 1), repeat=3)))
    w_box = np.linspace(-0.3, 0.45, 27)
    phases = {}

    def applications(name, seed, shape, specs, tile, sweep_axis,
                     dtype=torch.float32, padded=True):
        """Phase ``name`` on the padded launch buffers (unless
        ``padded`` is false) and on the grids."""
        gen.manual_seed(seed)
        u = [torch.randn(shape, generator=gen, device=dev).to(dtype)
             for _ in specs]
        ins, o, w, _, lo, hi = st._launch_inputs(u, specs, tile)
        if padded:
            phases[f"{name}.padded"] = (
                "sweep_apply", (ins, o, w, lo, hi, tile, sweep_axis, True),
                {})
        phases[f"{name}.direct"] = (
            "sweep_apply", (u, o, w, lo, hi, tile, sweep_axis, True),
            {"padded": False})

    applications("apply_f32_512", 0, (512,) * 3, (spec(offs13, w13),),
                 (8, 16, 32), 0)
    applications("planned_star_f32_512", 2, (512,) * 3,
                 (spec(offs13, w13),), (8, 32, 32), 0)
    applications("planned_box_f32_512", 3, (512,) * 3, (spec(box, w_box),),
                 (8, 32, 32), 0)
    applications("planned_star_f32_128", 4, (128,) * 3,
                 (spec(offs13, w13),), (128, 2, 32), 0)
    applications("apply_bf16_p2_256", 1, (256,) * 3,
                 (spec(offs13, w13), spec(offs7, w7)), (8, 16, 32), 0,
                 torch.bfloat16)
    applications("planned_star_bf16_512", 8, (512,) * 3,
                 (spec(offs13, w13),), (16, 16, 64), 0, torch.bfloat16,
                 padded=False)
    gen.manual_seed(7)
    u = [torch.randn((512,) * 3, generator=gen, device=dev)
         for _ in range(2)]
    ins, o, w, _, lo, hi = st._launch_inputs(
        u, (spec(offs13, w13), spec(offs_r, w_r)), (16, 8, 32))
    phases["apply_f32_p2_512_sweep1"] = (
        "sweep_apply", (ins, o, w, lo, hi, (16, 8, 32), 1, True), {})
    del u
    gen.manual_seed(6)
    xbc = torch.randn((4, 2048, 5376), generator=gen, device=dev).to(
        torch.bfloat16)
    cw = (torch.randn((4, 5376), generator=gen, device=dev) * 0.3).to(
        torch.bfloat16)
    cb = (torch.randn((5376,), generator=gen, device=dev) * 0.1).to(
        torch.bfloat16)
    state = torch.zeros((4, 3, 5376), dtype=torch.bfloat16, device=dev)
    phases["conv_prefill"] = ("conv1d", (xbc, cw, cb, 256, state), {})

    if args.phases is not None:
        phases = {ph: v for ph, v in phases.items()
                  if any(ph.startswith(p) for p in args.phases)}
    plain = {}
    for ph, (name, a, kw) in phases.items():
        if ph.endswith(".direct") and ph.replace(".direct",
                                                 ".padded") not in phases:
            plain[ph] = sweep.sweep_apply_plain(*a, **kw)
        elif ph.endswith(".direct"):  # the padded phase's, trimmed
            grid = tuple(slice(0, n) for n in a[0][0].shape)
            plain[ph] = plain[ph.replace(".direct", ".padded")][grid]
        elif name == "sweep_apply":
            plain[ph] = sweep.sweep_apply_plain(*a)
        else:
            plain[ph] = conv1d.causal_conv1d_plain(a[0], a[1], a[2], a[4])
    for rnd in range(args.rounds):
        for ph, (name, a, kw) in phases.items():
            tags = list(VARIANTS[name])
            for tag in (tags if rnd % 2 == 0 else tags[::-1]):
                use(name, tag)
                if name == "sweep_apply":
                    fn = (lambda a=a, kw=kw: sweep.sweep_apply(*a, **kw))
                    kern = "sweep_apply_kernel"
                else:
                    fn = (lambda a=a: conv1d.causal_conv1d_launch(*a))
                    kern = "conv1d_silu"
                out = fn()
                torch.cuda.synchronize()
                exact = bool(torch.equal(bits(out), bits(plain[ph])))
                print(json.dumps({
                    "variant": f"{name}/{tag}", "phase": ph, "round": rnd,
                    "exact_vs_plain": exact,
                    "device_ms": device_ms(fn, kern), "card": card,
                }), flush=True)


if __name__ == "__main__":
    main()
