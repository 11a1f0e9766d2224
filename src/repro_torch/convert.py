"""Carry a computation of the reference package across to the port.

A stencil system's "weights" are its program and its grids: the JAX
package writes a program as canonical JSON (``Program.serialize()``) and
holds grids as arrays.  :func:`from_reference` reads both into the port's
:class:`repro_torch.ir.Program` and tensors on a device;
:func:`stencil_from_reference` turns an ``(offsets, weights)`` operator
into the exact values the kernels multiply with.

A model's weights are the reference's parameter tree:
:func:`params_from_reference` loads it into the port's module of the
config's family and :func:`params_to_reference` gives it back;
:func:`cache_from_reference` carries a serving cache across, so a JAX
prefill can be continued by the port's decode.  A training state crosses
with :func:`opt_state_from_reference` / :func:`opt_state_to_reference`:
the reference holds the moments as trees like its parameters (each
stacked group, ``layers``, ``enc_layers`` and ``dec_layers``, stacked
(L, ...)), the port as ``{name: tensor}`` over the module's parameter
names (``layers.<i>.<leaf path>``).  The reference's trees cross as numpy
arrays; bf16 values as float32 arrays (numpy has no bfloat16).
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


# The groups of the reference's trees whose leaves are stacked (L, ...).
STACKED = ("layers", "enc_layers", "dec_layers")


def _family(cfg):
    from .models.model_api import family

    return family(cfg)


def params_from_reference(params_np, cfg, device=None):
    """The port's module of ``cfg``'s family
    (:class:`~repro_torch.models.ssm.SSMModel`,
    :class:`~repro_torch.models.transformer.LMModel` or
    :class:`~repro_torch.models.encdec.EncDecModel`) holding the
    reference's parameters.  ``params_np`` is the reference's tree as
    numpy arrays (``{"embed": {...}, "layers": {...}}``, the stacked
    groups' leaves (L, ...), and for the hybrid ``"shared_attn"``); each
    leaf is cast to its parameter's dtype (bf16 leaves arrive as float32
    arrays, and f32 → bf16 is exact for them)."""
    from .models.layers import flatten_tree

    dev = resolve_device(device)
    model = _family(cfg).module(cfg, device=dev)
    return model.load_flat(
        (path, torch.from_numpy(np.array(a, dtype=np.float32)).to(dev))
        for path, a in flatten_tree(params_np)
    )


def cache_from_reference(cache_np, cfg, device=None):
    """The port's serving cache from the reference's, given as numpy
    arrays (bf16 leaves as float32; integer leaves as integers), each
    leaf in its spec's dtype.  SSM family: ``ssm`` (L, B, H, P, N) f32,
    ``conv`` (L, B, W-1, C), for the hybrid ``attn`` (``k``, ``v`` (A, B,
    T, Hs, D), ``positions`` (A, T), ``pos`` (A,)); transformer: ``k``,
    ``v`` (L, B, T, Hs, D), ``positions`` (L, T), ``pos`` (L,);
    encoder-decoder: ``self`` as the transformer's and ``cross`` (``k``,
    ``v`` (L, B, F, Hs, D))."""
    from .models.layers import flatten_tree

    dev = resolve_device(device)
    got = dict(flatten_tree(cache_np))
    if cfg.family in ("ssm", "hybrid"):
        batch = int(np.shape(cache_np["ssm"])[1])
        k = got.get("attn.k")
    else:
        k = got.get("self.k", got.get("k"))
        batch = int(np.shape(k)[1])
    max_len = 0 if k is None else int(np.shape(k)[2])
    out: dict = {}
    specs = _family(cfg).cache_specs(cfg, batch, max_len)
    for path, spec in flatten_tree(specs):
        a = np.asarray(got[path])
        if tuple(a.shape) != spec.shape:
            raise ValueError(f"cache {path}: {a.shape} is not {spec.shape}")
        host = np.float32 if spec.dtype.is_floating_point else np.int64
        _set_path(out, path,
                  torch.from_numpy(np.array(a, dtype=host)).to(dev, spec.dtype))
    return out


def _set_path(tree: dict, path: str, value) -> None:
    """``tree[a][b][c] = value`` for the dotted ``path`` "a.b.c", making
    the inner dicts as needed."""
    *parents, leaf = path.split(".")
    for k in parents:
        tree = tree.setdefault(k, {})
    tree[leaf] = value


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _unstack(tree_np, device) -> dict:
    """``{port name: f32 tensor}`` from a tree shaped as the reference's
    parameters: each leaf of a stacked group, ``<group>.<path>`` (L, ...),
    split into ``<group>.<i>.<path>``; the others as they are."""
    from .models.layers import flatten_tree

    out = {}
    for path, a in flatten_tree(tree_np):
        t = torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
        group, _, rest = path.partition(".")
        if group in STACKED:
            for i, v in enumerate(t):
                out[f"{group}.{i}.{rest}"] = v.clone()
        else:
            out[path] = t
    return out


def _stack(named) -> dict:
    """The reference's tree (numpy, the stacked groups' leaves (L, ...))
    from ``{port name: tensor}``; the inverse of :func:`_unstack`."""
    tree: dict = {}
    stacked: dict = {}
    for name, t in named.items():
        group, _, rest = name.partition(".")
        i, _, leaf = rest.partition(".")
        if group in STACKED and i.isdigit():
            stacked.setdefault(f"{group}.{leaf}", []).append((int(i), t))
        else:
            _set_path(tree, name, _to_numpy(t))
    for path, vs in stacked.items():
        _set_path(tree, path, np.stack([_to_numpy(t) for _, t in sorted(vs)]))
    return tree


def params_to_reference(model) -> dict:
    """The reference's parameter tree (numpy) from the port's module: the
    inverse of :func:`params_from_reference`."""
    return _stack(dict(model.named_parameters()))


def opt_state_from_reference(opt_np, cfg, device=None) -> dict:
    """The port's AdamW state (``m``, ``v``: ``{name: f32 tensor}``,
    ``count``: int32 0-dim) from the reference's (``m`` and ``v`` trees
    shaped as its parameters, ``count``), given as numpy arrays."""
    dev = resolve_device(device)
    names = [n for n, _ in
             _family(cfg).module(cfg, device="meta").named_parameters()]
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
