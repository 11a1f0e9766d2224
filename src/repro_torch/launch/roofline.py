"""Roofline terms of a step, from counted operations (no card needed).

The port of the JAX package's ``launch/roofline.py``.  Three terms per
(arch × shape × mesh), in seconds, per device:

    compute    = flops      / PEAK_FLOPS
    memory     = hbm_bytes  / HBM_BW
    collective = wire_bytes / LINK_BW

The reference reads the first two from the compiled module
(``hlo_analysis.py``); here they come from
:class:`~repro_torch.launch.op_analysis.OpCounter` over the eager step,
and the wire bytes from :func:`~repro_torch.launch.op_analysis.model_wire_bytes`
(a model from the shardings, with the reference's ring factors:
:func:`~repro_torch.launch.op_analysis.ring_wire`).

Hardware constants: the NVIDIA H100 SXM's published figures (the data
sheet; dense rates, 700 W): 989 TFLOP/s bf16 on the tensor cores,
3.35 TB/s HBM3, and 450 GB/s of NVLink a direction (900 GB/s both ways).
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 989e12   # H100 SXM, dense bf16 (published)
HBM_BW = 3.35e12      # H100 SXM, HBM3 (published)
LINK_BW = 450e9       # H100 SXM, NVLink, one direction (published)

__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS", "Roofline", "analyze"]


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    wire_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops_per_device: float
    useful_ratio: float
    collectives: dict

    def to_dict(self):
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "wire_bytes": self.wire_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops_per_device": self.model_flops_per_device,
            "useful_flop_ratio": self.useful_ratio,
            "collectives": self.collectives,
        }


def analyze(cost, model_flops_total: float, world: int) -> Roofline:
    """The roofline of a per-device ``cost`` (an
    :class:`~repro_torch.launch.op_analysis.OpCost`: flops, hbm_bytes,
    wire_bytes, per_coll) against ``model_flops_total`` spread over
    ``world`` devices."""
    t_c = cost.flops / PEAK_FLOPS
    t_m = cost.hbm_bytes / HBM_BW
    t_x = cost.wire_bytes / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops_total / world
    return Roofline(
        flops=cost.flops, hbm_bytes=cost.hbm_bytes,
        wire_bytes=cost.wire_bytes,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck,
        model_flops_per_device=mf,
        useful_ratio=(mf / cost.flops) if cost.flops else 0.0,
        collectives=dict(cost.per_coll),
    )
