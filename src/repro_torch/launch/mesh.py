"""The column mesh of the port: the devices a column-sharded stencil
launch (:mod:`repro_torch.parallel.shard_columns`) partitions over.

The counterpart of the JAX package's ``launch/mesh.py::make_column_mesh``.
The reference is one controller over local devices and never starts a
distributed runtime; here too one process drives a list of devices, so a
mesh is an ordered list of ``torch.device`` and an axis name.  The model
meshes (``make_production_mesh``, ``make_test_mesh``) belong to the
sharded model stack and are not here.

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

import torch

from .. import resolve_device

__all__ = ["ColumnMesh", "make_column_mesh"]


@dataclass(frozen=True)
class ColumnMesh:
    """A 1-axis mesh: shard ``s`` runs on ``devices[s]``."""

    devices: tuple[torch.device, ...]
    axis_name: str = "columns"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (self.axis_name,)


def make_column_mesh(num_shards: int, axis_name: str = "columns",
                     devices=None, device=None) -> ColumnMesh:
    """The 1-axis mesh of a column-sharded launch over ``num_shards``
    shards.  ``devices`` lists the shards' devices (the first
    ``num_shards`` are taken; a device may repeat); without it the shards
    take the first ``num_shards`` cards, or all sit on the CPU for
    ``device="cpu"`` (``device=None`` means the card, as every entry point
    of the port)."""
    num_shards = int(num_shards)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
    else:
        dev = resolve_device(device)
        if dev.type == "cpu":
            devs = [dev] * num_shards
        else:
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
    if len(devs) < num_shards:
        raise RuntimeError(
            f"column mesh needs {num_shards} devices, found {len(devs)} — "
            "to put several shards on one card, name it once a shard: "
            f"make_column_mesh({num_shards}, devices=['cuda:0'] * "
            f"{num_shards})"
        )
    return ColumnMesh(tuple(devs[:num_shards]), str(axis_name))
