#!/usr/bin/env python3
"""Time the column-sharded stencil launch over several cards.

    python3 scripts/shard_cards.py

Run from the root of a checkout on a machine with one or more NVIDIA
H100s (no ``PYTHONPATH`` needed).  Two calls of the smoke's main path at
512³ f32 — the 13-point star once (``tile=(8, 16, 32)``, sweep axis 0)
and three fused applications (``tile=(4, 16, 32)``, ring frontiers) —
run unsharded on card 0, then on meshes over the first 2 and 4 cards (as
many as are visible) and on 4 shards named on card 0.  Each sharded
output must equal the unsharded one bit for bit (exit 1 otherwise).

Times: ``call_ms`` is one call between CUDA events on card 0, median of
10 after 2 warm-ups (the gather copies each shard's rows onto card 0,
which waits on that card's stream, so the end event follows every
card's work); ``kernel_ms_by_card`` is the sweep kernels' device time of
one call on each card, from ``torch.profiler`` (mean of 3 calls).  Prints
one JSON line per (call, mesh), then the cards' names and power limits
as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("shard_cards.py: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ref
    from repro_torch.kernels import stencil as st
    from repro_torch.launch.mesh import make_column_mesh

    card0 = torch.device("cuda", 0)
    n_cards = torch.cuda.device_count()
    meshes = {"unsharded": None}
    for n in (2, 4):
        if n <= n_cards:
            meshes[f"{n}_cards"] = make_column_mesh(n)
    meshes["4_shards_on_card_0"] = make_column_mesh(4, devices=[card0] * 4)

    offs, w = ref.star_weights_2nd_order(3, 2)
    gen = torch.Generator(device=card0)
    gen.manual_seed(0)
    u = torch.randn((512, 512, 512), generator=gen, device=card0)
    calls = {
        "apply_f32_512": lambda **kw: st.stencil_pallas(
            u, offs, w, tile=(8, 16, 32), sweep_axis=0, **kw),
        "chain_T3_512": lambda **kw: st.stencil_iterate(
            u, offs, w, 3, tile=(4, 16, 32), sweep_axis=0,
            window_kind="ring", **kw),
    }

    def sync():
        for i in range(n_cards):
            torch.cuda.synchronize(i)

    def call_ms(fn) -> float:
        for _ in range(2):
            fn()
        sync()
        times = []
        for _ in range(10):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(torch.cuda.current_stream(card0))
            fn()
            b.record(torch.cuda.current_stream(card0))
            b.synchronize()
            times.append(a.elapsed_time(b))
        sync()
        return statistics.median(times)

    def kernel_ms_by_card(fn, reps=3) -> dict:
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        by: dict = {}
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and "sweep_" in e.name):
                key = f"cuda:{e.device_index}"
                by[key] = by.get(key, 0.0) + e.time_range.elapsed_us()
        return {k: v / 1e3 / reps for k, v in sorted(by.items())}

    ok = True
    for cname, call in calls.items():
        base = call()
        sync()
        for mname, mesh in meshes.items():
            fn = (lambda: call()) if mesh is None else \
                (lambda: call(mesh=mesh))
            out = fn()
            sync()
            equal = bool(torch.equal(out, base))
            ok &= equal
            print(json.dumps({
                "call": cname, "mesh": mname,
                "devices": (None if mesh is None
                            else [str(d) for d in mesh.devices]),
                "equals_unsharded": equal, "call_ms": call_ms(fn),
                "kernel_ms_by_card": kernel_ms_by_card(fn),
            }), flush=True)
            del out
        del base
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
