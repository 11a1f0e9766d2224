"""Carry a computation of the reference package across to the port.

A stencil system's "weights" are its program and its grids: the JAX
package writes a program as canonical JSON (``Program.serialize()``) and
holds grids as arrays.  :func:`from_reference` reads both into the port's
:class:`repro_torch.ir.Program` and tensors on a device;
:func:`stencil_from_reference` turns an ``(offsets, weights)`` operator
into the exact values the kernels multiply with.

A model's weights are the reference's parameter tree:
:func:`params_from_reference` loads it into the port's module and
:func:`params_to_reference` gives it back; :func:`cache_from_reference`
carries a serving cache across, so a JAX prefill can be continued by the
port's decode.  A training state crosses with
:func:`opt_state_from_reference` / :func:`opt_state_to_reference`: the
reference holds the moments as trees like its parameters (``layers``
stacked (L, ...)), the port as ``{name: tensor}`` over the module's
parameter names (``layers.<i>.<leaf>``).  The reference's trees cross as
numpy arrays; bf16 values as float32 arrays (numpy has no bfloat16).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from . import ir, resolve_device

__all__ = [
    "cache_from_reference",
    "from_reference",
    "opt_state_from_reference",
    "opt_state_to_reference",
    "params_from_reference",
    "params_to_reference",
    "stencil_from_reference",
]


def from_reference(program_json, arrays: Mapping[str, np.ndarray],
                   device=None):
    """The port's ``(Program, {name: tensor})`` for a reference program.

    ``program_json`` is the reference's serialized program
    (``Program.serialize()``, boundary, quantize and dequantize ops and
    apply dtypes included); ``arrays`` maps each of the program's input
    names to a numpy array (bf16 grids arrive as float32 arrays and a
    ``dtype`` change is the caller's).  The program is verified on the grids'
    shape; a missing input raises ``KeyError``."""
    prog = ir.Program.from_json(program_json)
    missing = [n for n in prog.inputs() if n not in arrays]
    if missing:
        raise KeyError(f"program inputs missing from arrays: {missing}")
    dev = resolve_device(device)
    tensors = {
        name: torch.as_tensor(np.ascontiguousarray(arrays[name])).to(dev)
        for name in prog.inputs()
    }
    shapes = {tuple(t.shape) for t in tensors.values()}
    if len(shapes) != 1:
        raise ValueError(f"program inputs differ in shape: {sorted(shapes)}")
    ir.verify(prog, next(iter(shapes)))
    return prog, tensors


def stencil_from_reference(offsets, weights):
    """``(offsets (s, d) int64, weights (s,) float32)``: the weights cast to
    ``np.float32`` one by one, exactly as the reference's kernel does
    before its multiply-adds (``np.float32(w) * x``)."""
    offs = np.asarray(offsets, dtype=np.int64)
    if offs.ndim == 1:
        offs = offs.reshape(1, -1)
    wts = np.array([np.float32(w) for w in weights], dtype=np.float32)
    if len(wts) != len(offs):
        raise ValueError(f"{len(offs)} offsets but {len(wts)} weights")
    return offs, wts


def params_from_reference(params_np, cfg, device=None):
    """The port's :class:`~repro_torch.models.ssm.SSMModel` holding the
    reference's parameters.  ``params_np`` is the reference's tree as
    numpy arrays (``{"embed": {...}, "layers": {...}}``, the ``layers``
    leaves stacked (L, ...)); each leaf is cast to its spec's dtype (bf16
    leaves arrive as float32 arrays, and f32 → bf16 is exact for them)."""
    from .models.layers import flatten_tree
    from .models.ssm import SSMModel

    dev = resolve_device(device)
    model = SSMModel(cfg, device=dev)
    return model.load_flat(
        (path, torch.from_numpy(np.array(a, dtype=np.float32)).to(dev))
        for path, a in flatten_tree(params_np)
    )


def cache_from_reference(cache_np, cfg, device=None):
    """The port's serving cache (``ssm``: (L, B, H, P, N) f32, ``conv``:
    (L, B, W-1, C) in the compute dtype) from the reference's, given as
    numpy arrays (a bf16 ``conv`` cache arrives as float32)."""
    from .models.ssm import ssm_cache_specs

    dev = resolve_device(device)
    batch = int(np.shape(cache_np["ssm"])[1])
    specs = ssm_cache_specs(cfg, batch, 0)
    out = {}
    for name, spec in specs.items():
        a = np.array(cache_np[name], dtype=np.float32)
        if tuple(a.shape) != spec.shape:
            raise ValueError(f"cache {name}: {a.shape} is not {spec.shape}")
        out[name] = torch.from_numpy(a).to(dev, spec.dtype)
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _unstack(tree_np, device) -> dict:
    """``{port name: f32 tensor}`` from a tree shaped as the reference's
    parameters: ``embed.<leaf>`` as is, each ``layers.<leaf>`` (L, ...)
    split into ``layers.<i>.<leaf>``."""
    from .models.layers import flatten_tree

    out = {}
    for path, a in flatten_tree(tree_np):
        t = torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
        group, leaf = path.split(".", 1)
        if group == "layers":
            for i, v in enumerate(t):
                out[f"layers.{i}.{leaf}"] = v.clone()
        else:
            out[path] = t
    return out


def _stack(named) -> dict:
    """The reference's tree (numpy, ``layers`` stacked (L, ...)) from
    ``{port name: tensor}``; the inverse of :func:`_unstack`."""
    tree: dict = {}
    layers: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "layers":
            layers.setdefault(parts[2], []).append((int(parts[1]), t))
        else:
            tree.setdefault(parts[0], {})[parts[1]] = _to_numpy(t)
    if layers:
        tree["layers"] = {
            leaf: np.stack([_to_numpy(t) for _, t in sorted(vs)])
            for leaf, vs in layers.items()
        }
    return tree


def params_to_reference(model) -> dict:
    """The reference's parameter tree (numpy) from the port's
    :class:`~repro_torch.models.ssm.SSMModel`: the inverse of
    :func:`params_from_reference`."""
    return _stack(dict(model.named_parameters()))


def opt_state_from_reference(opt_np, cfg, device=None) -> dict:
    """The port's AdamW state (``m``, ``v``: ``{name: f32 tensor}``,
    ``count``: int32 0-dim) from the reference's (``m`` and ``v`` trees
    shaped as its parameters, ``count``), given as numpy arrays."""
    from .models.ssm import SSMModel

    dev = resolve_device(device)
    names = [n for n, _ in SSMModel(cfg, device="meta").named_parameters()]
    out = {}
    for k in ("m", "v"):
        got = _unstack(opt_np[k], dev)
        if set(got) != set(names):
            raise KeyError(
                f"opt state {k}: missing {sorted(set(names) - set(got))}, "
                f"unexpected {sorted(set(got) - set(names))}"
            )
        out[k] = {n: got[n] for n in names}
    out["count"] = torch.tensor(int(np.asarray(opt_np["count"])),
                                dtype=torch.int32, device=dev)
    return out


def opt_state_to_reference(opt_state) -> dict:
    """The reference's AdamW state (numpy) from the port's: the inverse of
    :func:`opt_state_from_reference`."""
    return {
        "m": _stack(opt_state["m"]),
        "v": _stack(opt_state["v"]),
        "count": np.asarray(_to_numpy(opt_state["count"]), dtype=np.int32),
    }
