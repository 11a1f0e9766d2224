"""Logical-axis sharding: one place that maps model dims to mesh axes.

The port of the JAX package's ``parallel/sharding.py``.  Every parameter
and activation dim carries a *logical* name; a rule table maps names to
mesh axes.  The same model code therefore runs on the single-pod
``("data", "model")`` mesh, the multi-pod ``("pod", "data", "model")``
mesh and the one-device test mesh (all built by
:mod:`repro_torch.launch.mesh`): only the rules change.

There is no ``NamedSharding`` in PyTorch.  :class:`Sharding` is its
counterpart: a mesh and a ``spec`` with one entry per dim (``None``, one
mesh-axis name, or a tuple of them, as ``PartitionSpec`` holds them), and
:meth:`Sharding.shard_shape` gives the per-device shape.  The port runs a
model on one device, so a sharding is a description that the dry-run
(:mod:`repro_torch.launch.dryrun`) prices, not a layout of memory.

Dims whose extent does not divide the assigned mesh axes fall back to a
prefix of the axes, then to replication, with the reference's warning.

:func:`constrain` is the reference's ``with_sharding_constraint`` by
logical names.  Without a mesh it returns its input.  Under
:func:`activate_mesh` it resolves the sharding (so an unknown rule or a
rank mismatch fails as in the reference), hands it to the active
recorder (:func:`record_constraints`) and returns the tensor unchanged:
under the jax 0.4.37 that ``requirements.txt`` pins, the constraint
changes no value either.

Stencil grids shard by columns instead: :mod:`.shard_columns`.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import logging
from dataclasses import dataclass
from math import prod
from typing import Any, Mapping, Sequence

log = logging.getLogger(__name__)

__all__ = [
    "LOGICAL_RULES",
    "ParamSpec",
    "ShardedStruct",
    "Sharding",
    "logical_sharding",
    "sharded_struct",
    "specs_to_shardings",
    "specs_to_structs",
    "pad_to_multiple",
    "activate_mesh",
    "current_mesh",
    "current_rules",
    "constrain",
    "record_constraints",
    "map_specs",
]

# Baseline rule table.  'fsdp' is the weight-shard axis (ZeRO-3 style);
# 'tensor' is TP; 'batch' is DP.  Meshes name their axes (pod, data, model);
# multi-pod FSDP/DP span (pod, data).
LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "tensor": ("model",),
    "expert": (),            # EP opt-in: dryrun.rules_for maps it to model
    "sequence": (),          # SP off by default
    "layers": (),
    "replicated": (),
}


@dataclass(frozen=True)
class ParamSpec:
    """Shape/dtype/logical-axes of one parameter leaf."""

    shape: tuple[int, ...]
    dtype: Any
    axes: tuple[str, ...]  # logical name per dim ('' = replicated)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


@dataclass(frozen=True)
class Sharding:
    """The counterpart of ``NamedSharding(mesh, PartitionSpec(*spec))``."""

    mesh: Any
    spec: tuple  # per dim: None, an axis name, or a tuple of axis names

    @staticmethod
    def axes_of(entry) -> tuple[str, ...]:
        """The mesh axes of one ``spec`` entry."""
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def shard_shape(self, global_shape: Sequence[int]) -> tuple[int, ...]:
        """The per-device shape of an array of ``global_shape``: each dim
        divided by the product of its mesh axes (which must divide it)."""
        global_shape = tuple(int(n) for n in global_shape)
        if len(self.spec) > len(global_shape):
            raise ValueError(f"spec {self.spec} has more dims than "
                             f"{global_shape}")
        out = []
        for i, n in enumerate(global_shape):
            axes = self.axes_of(self.spec[i]) if i < len(self.spec) else ()
            size = prod(self.mesh.shape[a] for a in axes)
            if n % size:
                raise ValueError(f"dim {i} of {global_shape} does not divide "
                                 f"mesh axes {axes} ({size})")
            out.append(n // size)
        return tuple(out)


@dataclass(frozen=True)
class ShardedStruct:
    """The dry-run's currency (the reference's sharded
    ``ShapeDtypeStruct``): the global shape, dtype and sharding, and what
    one device holds."""

    shape: tuple[int, ...]
    dtype: Any
    sharding: Sharding

    @property
    def local_shape(self) -> tuple[int, ...]:
        return self.sharding.shard_shape(self.shape)

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize

    @property
    def local_bytes(self) -> int:
        return prod(self.local_shape) * self.itemsize


def _mesh_axes_for(
    logical: str, rules: Mapping[str, tuple[str, ...]], mesh
) -> tuple[str, ...]:
    wanted = rules.get(logical, ())
    return tuple(a for a in wanted if a in mesh.axis_names)


@functools.lru_cache(maxsize=None)
def _warn_replicated(i: int, name: str, extent: int, mesh_axes) -> None:
    """The reference's warning, once a distinct case: eager model code
    resolves a constraint once a layer and a step, where a traced program
    resolves it once."""
    log.warning(
        "dim %d (=%s, extent %s) does not divide mesh axes %s; "
        "replicating — consider padding (paper §6)",
        i, name, extent, mesh_axes,
    )


def logical_sharding(
    axes: Sequence[str],
    mesh,
    shape: Sequence[int] | None = None,
    rules: Mapping[str, tuple[str, ...]] | None = None,
) -> Sharding:
    """Map logical axis names to a :class:`Sharding` on ``mesh``.

    A mesh axis is used at most once per array.  If ``shape`` is given, a
    dim that does not divide its mesh-axis product falls back to the
    longest prefix of those axes that divides it, else to replication
    (with a warning: the padding advisor should have fixed it upstream)."""
    rules = rules or LOGICAL_RULES
    parts: list[Any] = []
    used: set[str] = set()
    for i, name in enumerate(axes):
        mesh_axes = tuple(a for a in _mesh_axes_for(name, rules, mesh)
                          if a not in used)
        if not mesh_axes:
            parts.append(None)
            continue
        size = prod(mesh.shape[a] for a in mesh_axes)
        if shape is not None and shape[i] % size != 0:
            # try a prefix of the axes (e.g. ('pod','data') -> ('pod',))
            ok = None
            for j in range(len(mesh_axes) - 1, 0, -1):
                sz = prod(mesh.shape[a] for a in mesh_axes[:j])
                if shape[i] % sz == 0:
                    ok = mesh_axes[:j]
                    break
            if ok is None:
                _warn_replicated(i, name, shape[i], mesh_axes)
                parts.append(None)
                continue
            mesh_axes = ok
        used.update(mesh_axes)
        parts.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
    return Sharding(mesh, tuple(parts))


def sharded_struct(spec: ParamSpec, mesh, rules=None) -> ShardedStruct:
    """The spec's global shape and dtype with its sharding on ``mesh``."""
    return ShardedStruct(
        tuple(spec.shape), spec.dtype,
        logical_sharding(spec.axes, mesh, spec.shape, rules),
    )


def map_specs(fn, specs):
    """``fn`` on every :class:`ParamSpec` leaf of a tree of dicts."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: map_specs(fn, v) for k, v in specs.items()}


def specs_to_shardings(specs, mesh, rules=None):
    return map_specs(
        lambda s: logical_sharding(s.axes, mesh, s.shape, rules), specs)


def specs_to_structs(specs, mesh, rules=None):
    return map_specs(lambda s: sharded_struct(s, mesh, rules), specs)


def pad_to_multiple(n: int, unit: int) -> int:
    return -(-n // unit) * unit


# ---------------------------------------------------------------------------
# Active mesh/rules context: lets model code add sharding constraints on
# activations without threading the mesh through every call.
# ---------------------------------------------------------------------------

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)
_RULES: contextvars.ContextVar = contextvars.ContextVar("repro_torch_rules",
                                                        default=None)
_RECORD: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_constraints", default=None)


@contextlib.contextmanager
def activate_mesh(mesh, rules: Mapping[str, tuple[str, ...]] | None = None):
    t1 = _MESH.set(mesh)
    t2 = _RULES.set(dict(rules) if rules else None)
    try:
        yield
    finally:
        _MESH.reset(t1)
        _RULES.reset(t2)


def current_mesh():
    return _MESH.get()


def current_rules() -> Mapping[str, tuple[str, ...]]:
    return _RULES.get() or LOGICAL_RULES


@contextlib.contextmanager
def record_constraints():
    """Collect every constraint resolved under an active mesh, as
    ``(logical axes, shape, Sharding)``, into the yielded list."""
    got: list = []
    token = _RECORD.set(got)
    try:
        yield got
    finally:
        _RECORD.reset(token)


def constrain(x, axes: Sequence[str]):
    """``with_sharding_constraint`` by logical axis names: ``x`` itself,
    with or without a mesh.  Under a mesh the sharding is resolved (an
    unknown layout fails here as in the reference) and recorded where
    :func:`record_constraints` is active."""
    mesh = current_mesh()
    if mesh is None:
        return x
    if len(axes) > x.ndim:
        raise ValueError(f"constraint {tuple(axes)} on a tensor of rank "
                         f"{x.ndim}")
    sh = logical_sharding(axes, mesh, x.shape, current_rules())
    got = _RECORD.get()
    if got is not None:
        got.append((tuple(axes), tuple(x.shape), sh))
    return x
