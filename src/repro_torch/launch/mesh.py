"""Meshes of the port: the model meshes that the logical-axis rules of
:mod:`repro_torch.parallel.sharding` map onto, and the one-axis column
mesh of a column-sharded stencil launch
(:mod:`repro_torch.parallel.shard_columns`).  Both are a
:class:`ModelMesh`, as the reference uses one ``Mesh`` type for both.

The counterpart of the JAX package's ``launch/mesh.py``.  The reference
is one controller over local devices and never starts a distributed
runtime; here too one process drives a list of devices, so a mesh is
devices and axis names.

* :func:`make_production_mesh` — the 16×16 ``("data", "model")`` or
  2×16×16 ``("pod", "data", "model")`` mesh.  On ``device="meta"`` its
  devices are placeholders (the port's form of the reference's 512
  forced host devices), which is how the dry-run builds it; on cards it
  needs 256 or 512 of them and raises ``RuntimeError`` with fewer.
* :func:`make_test_mesh` — a ``("data", "model")`` mesh over the visible
  cards (or the CPU for ``device="cpu"``), clamped to what exists as in
  the reference; the trainer runs under it.
* :func:`make_column_mesh` — the 1-axis ``("columns",)`` mesh, below.

The column mesh:

* ``make_column_mesh(N)`` takes the first N cards and raises
  ``RuntimeError`` when fewer are visible, as the reference raises for
  too few devices.
* ``make_column_mesh(N, device="cpu")`` puts N shards on the CPU: the
  port's form of the reference's forced host devices, and how the tests
  run.
* Shards share one card only when the caller names the devices, as in
  ``make_column_mesh(4, devices=["cuda:0"] * 4)``; a mesh never
  co-locates shards on its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import prod

import torch

from .. import resolve_device

__all__ = [
    "ModelMesh",
    "make_column_mesh",
    "make_production_mesh",
    "make_test_mesh",
]


@dataclass(frozen=True)
class ModelMesh:
    """A mesh: ``axis_names``, their sizes in order, and one device a
    position (row-major over the axes).  ``shape`` maps each axis name
    to its size, as ``Mesh.shape`` reads in the reference."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} vs sizes {self.sizes}")
        if len(self.devices) != prod(self.sizes):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return prod(self.sizes)


def _model_mesh(sizes, axes, device=None, devices=None,
                hint: str = "") -> ModelMesh:
    """A mesh of ``sizes`` over ``axes`` on the first of ``devices`` (a
    device may repeat), or by default placeholders on ``meta``, the CPU
    repeated on ``cpu``, else the visible cards; raises ``RuntimeError``
    with fewer devices than positions."""
    n = prod(sizes)
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
    else:
        dev = resolve_device(device)
        if dev.type in ("meta", "cpu"):
            devs = [dev] * n
        else:
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
    if len(devs) < n:
        raise RuntimeError(f"mesh {tuple(sizes)} needs {n} devices, found "
                           f"{len(devs)} — {hint}")
    return ModelMesh(tuple(axes), tuple(sizes), tuple(devs[:n]))


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> ModelMesh:
    """16×16 single pod (256 devices) or 2×16×16 (2 pods, 512)."""
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _model_mesh(sizes, axes, device, hint=(
        "the dry-run builds it on placeholders: "
        "make_production_mesh(device='meta')"))


def make_test_mesh(data: int = 1, model: int = 1, device=None) -> ModelMesh:
    """A tiny ``("data", "model")`` mesh over however many devices exist
    (the visible cards; one for ``device="cpu"`` or ``"meta"``), with
    ``data`` and ``model`` clamped to them as in the reference."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    data = min(data, n)
    model = min(model, n // data)
    return _model_mesh((data, model), ("data", "model"), dev)


def make_column_mesh(num_shards: int, axis_name: str = "columns",
                     devices=None, device=None) -> ModelMesh:
    """The 1-axis mesh ``(axis_name,)`` of a column-sharded launch over
    ``num_shards`` shards: shard ``s`` runs on ``mesh.devices[s]``.
    ``devices`` lists the shards' devices (the first ``num_shards`` are
    taken; a device may repeat); without it the shards take the first
    ``num_shards`` cards, or all sit on the CPU for ``device="cpu"``
    (``device=None`` means the card, as every entry point of the port)."""
    num_shards = int(num_shards)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return _model_mesh((num_shards,), (str(axis_name),), device, devices,
                       hint=("to put several shards on one card, name it "
                             f"once a shard: make_column_mesh({num_shards}, "
                             f"devices=['cuda:0'] * {num_shards})"))
