"""Dry-run: trace every (arch × shape × mesh) cell without allocating.

The port of the JAX package's ``launch/dryrun.py``.  The reference lowers
and compiles each cell's step against sharded ``ShapeDtypeStruct``s for
256 or 512 placeholder devices and reads XLA's memory and cost analyses.
Here each cell is built on PyTorch's ``meta`` device (shapes and dtypes,
no storage) over the placeholder mesh of
:func:`~repro_torch.launch.mesh.make_production_mesh` (``device="meta"``),
with the reference's logical sharding:

* **argument bytes** a device are exact: the sum of the per-device bytes
  of the parameters', AdamW state's, batch's and cache's
  :func:`~repro_torch.parallel.sharding.sharded_struct`\\ s;
* **temp bytes** are the peak of the storages the step allocates
  (:class:`~repro_torch.launch.op_analysis.LiveBytes`), traced at the
  per-device batch (the batch's own shard: ``global_batch / dp`` where
  the data axes divide it) with one MoE dispatch group (the device's),
  each parameter's gradient priced at its own per-device share (a
  stacked group's layer at one layer's, :func:`_grad_shares`).  Activations
  are *not* divided by the tensor axis: the number is an upper bound,
  and the record says so;
* **flops and HBM bytes** are counted over that traced step
  (:class:`~repro_torch.launch.op_analysis.OpCounter`: forward,
  checkpoint recompute, backward and the AdamW update), multiplied by the
  batch's shards to the step's totals, and divided by ``world``;
* **wire bytes** are modelled from the shardings
  (:func:`~repro_torch.launch.op_analysis.model_wire_bytes`);
* ``model_flops`` is ``6·N_active·tokens`` (``2·…`` for serving), as in
  the reference, and the roofline is :func:`~.roofline.analyze` against
  the H100's published peaks.

The record keeps the reference's keys, except ``fits_80g`` (an H100's
80 GB) for ``fits_16g`` and no TPU estimate or XLA:CPU bf16 correction:
a meta trace keeps bf16.  Nothing here touches a card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from ..configs import LM_SHAPES, get_config, list_archs
from ..models import batch_specs, count_params, get_model
from ..models.layers import flatten_tree
from ..optim import OptConfig, adamw_init, opt_state_specs
from ..parallel.sharding import (
    LOGICAL_RULES,
    ParamSpec,
    map_specs,
    sharded_struct,
    specs_to_structs,
)
from . import roofline as rf
from .mesh import make_production_mesh
from .op_analysis import LiveBytes, OpCost, OpCounter, model_wire_bytes
from .train import train_step

__all__ = ["LONG_OK", "OPT", "build_cell", "main", "rules_for", "run_cell"]

# long_500k needs sub-quadratic decode: SSM state (mamba2, zamba2) or a
# sliding window (mixtral).  Pure full-attention archs skip it.
LONG_OK = {"mamba2-2.7b", "zamba2-2.7b", "mixtral-8x22b"}

OPT = OptConfig()
META = torch.device("meta")
TEMP_NOTE = ("temp: peak of the step's allocations traced at the "
             "per-device batch, not divided by the tensor axis (an upper "
             "bound); each gradient at its own per-device share")


def rules_for(cfg):
    rules = dict(LOGICAL_RULES)
    if not cfg.fsdp:
        rules["fsdp"] = ()
    if cfg.act_shard == "seq":
        rules["sequence"] = ("model",)
    if cfg.moe is not None and cfg.moe.expert_parallel:
        rules["expert"] = ("model",)
    return rules


@dataclasses.dataclass
class Cell:
    """One cell: the bound config, its argument structs, ``inputs()``
    (the step's arguments on ``meta`` at the per-device batch: parameters,
    optimizer state or cache, batch) and ``step(tracker, *inputs)``, which
    runs the step on them and returns its counted cost."""

    cfg: object
    kind: str
    rules: dict
    param_specs: dict
    structs: dict          # name -> tree of ShardedStruct
    local_batch: int
    replicas: int          # batch shards: global_batch / local_batch
    seq: int
    inputs: object
    step: object
    model_flops: float
    n_params: int
    n_active: int


def _meta_tree(specs):
    """Empty ``meta`` tensors for a spec tree (no storage)."""
    return map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device=META), specs)


def _local_bytes(structs) -> int:
    return sum(s.local_bytes for _, s in flatten_tree(structs))


def build_cell(arch: str, shape_name: str, mesh) -> Cell:
    shape = LM_SHAPES[shape_name]
    tp = mesh.shape["model"]
    dp = mesh.shape["data"] * mesh.shape.get("pod", 1)
    cfg = get_config(arch).bind(tp=tp, dp=dp)
    rules = rules_for(cfg)
    model = get_model(cfg, device=META)
    pspecs = model.param_specs()
    bspecs = batch_specs(cfg, shape)
    structs = {"params": specs_to_structs(pspecs, mesh, rules),
               "batch": specs_to_structs(bspecs, mesh, rules)}
    n_params = count_params(cfg)
    n_active = count_params(cfg, active_only=True)
    lead = "token" if shape.kind == "decode" else "tokens"
    local_b = structs["batch"][lead].local_shape[0]
    b, s = shape.global_batch, shape.seq_len
    # The device's own step: its batch shard, one dispatch group.
    dev_cfg = dataclasses.replace(cfg, dp=1)
    dev_model = get_model(dev_cfg, device=META)
    local_shape = dataclasses.replace(shape, global_batch=local_b)

    if shape.kind == "train":
        structs["opt_state"] = specs_to_structs(opt_state_specs(pspecs),
                                                mesh, rules)

        def inputs():
            params = dev_model.init()
            return (params, adamw_init(dict(params.named_parameters())),
                    _meta_tree(batch_specs(dev_cfg, local_shape)))

        def step(tracker, params, opt_state, batch):
            share = _grad_shares(params, pspecs, mesh, rules)
            hooks = [
                p.register_post_accumulate_grad_hook(
                    lambda p, n=share[name]: tracker.resize(p.grad, n))
                for name, p in params.named_parameters()]
            try:
                return _counted(lambda: train_step(
                    dev_model, params, opt_state, batch, OPT))
            finally:
                for h in hooks:
                    h.remove()

        model_flops = 6.0 * n_active * b * s
    else:
        ring = shape.kind == "decode"
        cspecs = model.cache_specs(b, s, ring=ring)
        structs["cache"] = specs_to_structs(cspecs, mesh, rules)

        def inputs():
            return (dev_model.init(),
                    _meta_tree(dev_model.cache_specs(local_b, s, ring=ring)),
                    _meta_tree(batch_specs(dev_cfg, local_shape)))

        def step(tracker, params, cache, batch):
            if shape.kind == "prefill":
                return _counted(lambda: dev_model.prefill(
                    params, batch, cache))
            return _counted(lambda: dev_model.decode_step(
                params, cache, batch["token"], s - 1))

        model_flops = 2.0 * n_active * (b * s if shape.kind == "prefill"
                                        else b)
    return Cell(cfg, shape.kind, rules, pspecs, structs, local_b,
                b // local_b, 1 if shape.kind == "decode" else s, inputs,
                step, model_flops, n_params, n_active)


def _grad_shares(model, pspecs, mesh, rules) -> dict[str, int]:
    """Each of ``model``'s parameters' per-device bytes on ``mesh``.  A
    stacked group's layer (``layers.3.attn.wq``) is one slice of the
    reference's leaf (``layers.attn.wq``, (L, ...)): it is priced as that
    leaf without its leading ``layers`` dim, which no rule shards."""
    flat = dict(flatten_tree(pspecs))
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        stacked = len(parts) > 2 and parts[1].isdigit()
        if stacked:
            parts.pop(1)
        spec = flat[".".join(parts)]
        if stacked:
            spec = ParamSpec(spec.shape[1:], spec.dtype, spec.axes[1:])
        if tuple(p.shape) != spec.shape:
            raise ValueError(f"{name}: {tuple(p.shape)} against the spec's "
                             f"{spec.shape}")
        out[name] = sharded_struct(spec, mesh, rules).local_bytes
    return out


def _counted(fn) -> OpCost:
    with OpCounter() as counter:
        fn()
    return counter.cost


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    world = mesh.size
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "world": world,
    }
    t0 = time.time()
    cell = build_cell(arch, shape_name, mesh)
    rec.update(n_params=cell.n_params, n_active=cell.n_active,
               model_flops=cell.model_flops, local_batch=cell.local_batch)
    args_meta = cell.inputs()
    t1 = time.time()
    # Outside the mesh: the traced tensors are one device's, which the
    # global mesh's activation constraints do not describe.
    with LiveBytes() as tracker:
        counted = cell.step(tracker, *args_meta)
    del args_meta
    t2 = time.time()
    args = sum(_local_bytes(v) for v in cell.structs.values())
    temp = int(tracker.peak)
    scale = cell.replicas / world
    wire = model_wire_bytes(cell.cfg, cell.param_specs, mesh, cell.rules,
                            kind=cell.kind,
                            local_batch=cell.local_batch, seq=cell.seq)
    cost = OpCost(flops=counted.flops * scale,
                  hbm_bytes=counted.hbm_bytes * scale,
                  wire_bytes=wire.wire_bytes, per_coll=wire.per_coll)
    roof = rf.analyze(cost, cell.model_flops, world)
    per_dev = args + temp
    rec.update(
        memory={"argument_size_in_bytes": args, "temp_size_in_bytes": temp,
                "temp_note": TEMP_NOTE},
        bytes_per_device=per_dev,
        fits_80g=bool(per_dev < 80e9),
        # the memory-roofline floor: every resident byte touched once
        t_ideal_memory_s=args / rf.HBM_BW,
        t_ideal_compute_s=(cell.model_flops / world) / rf.PEAK_FLOPS,
        roofline=roof.to_dict(),
        counted_per_op=counted.per_op,
        build_s=round(t1 - t0, 1),
        trace_s=round(t2 - t1, 1),
        ok=True,
    )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun.jsonl")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    done = set()
    if out.exists() and not args.force:
        for line in out.read_text().splitlines():
            try:
                r = json.loads(line)
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
            except json.JSONDecodeError:
                pass

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(LM_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    records = []
    for arch in archs:
        arch_cfg_name = get_config(arch).name
        for shape in shapes:
            if shape == "long_500k" and arch_cfg_name not in LONG_OK:
                print(f"SKIP {arch} {shape} (full attention)")
                continue
            for multi in meshes:
                mname = "2x16x16" if multi else "16x16"
                if (arch, shape, mname) in done:
                    print(f"cached {arch} {shape} {mname}")
                    continue
                print(f"=== {arch} {shape} {mname}", flush=True)
                try:
                    rec = run_cell(arch, shape, multi)
                    gb = rec["bytes_per_device"] / 1e9
                    r = rec["roofline"]
                    print(
                        f"  ok mem/dev={gb:.2f}GB fits={rec['fits_80g']} "
                        f"t_c={r['t_compute_s']:.4f}s "
                        f"t_m={r['t_memory_s']:.4f}s "
                        f"t_x={r['t_collective_s']:.4f}s "
                        f"bound={r['bottleneck']} (trace {rec['trace_s']}s)",
                        flush=True,
                    )
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = {
                        "arch": arch, "shape": shape, "mesh": mname,
                        "ok": False, "error": f"{type(e).__name__}: {e}",
                        "trace": traceback.format_exc()[-2000:],
                    }
                    print(f"  FAIL {type(e).__name__}: {str(e)[:200]}",
                          flush=True)
                records.append(rec)
                with out.open("a") as f:
                    f.write(json.dumps(rec) + "\n")
    return records


if __name__ == "__main__":
    main()
