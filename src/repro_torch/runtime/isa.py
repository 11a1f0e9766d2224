"""The one home of the port's precision pins: the counterpart of the JAX
package's ``runtime/isa.py``, which pins XLA's host flags.

On the card two settings decide how float32 arithmetic rounds:

* **TF32.** cuBLAS and cuDNN may run an f32 matmul or convolution on the
  tensor cores with 10-bit mantissas.  PyTorch's defaults keep it off
  for matmuls, but one ``torch.set_float32_matmul_precision("high")``
  anywhere in the process turns it on, and the SSD's f32 einsums and the
  f32 yardsticks then leave their bands.  :func:`pin_precision` turns
  TF32 off in both libraries and sets the matmul precision to
  ``"highest"``.  ``launch/train.py``, ``launch/serve.py`` and
  ``chip_smoke.py`` call it; none of them spells the pins out
  (``tests/test_torch_isa.py`` fails if one grows an inline copy back).
* **FMA contraction.** nvcc contracts a multiply and an add into one
  fused multiply-add unless told not to; the kernels must round each tap
  in order, as the plain versions do.  :data:`NVCC_FLAGS` carries
  ``--fmad=false``; ``kernels/_build.py`` builds with it.

For shell users, ``python -m repro_torch.runtime.isa --export`` prints
``export NVIDIA_TF32_OVERRIDE=0``, which turns TF32 off in the CUDA
libraries of any process started from that shell, as the reference's
``--export`` prints its ``XLA_FLAGS``.
"""

from __future__ import annotations

import sys

__all__ = ["FMAD_FLAG", "NVCC_FLAGS", "TF32_ENV", "main", "pin_precision"]

FMAD_FLAG = "--fmad=false"
# How the port's kernels are compiled (kernels/_build.py): Hopper's sm_90a,
# no contraction of multiply-adds, ptxas's register and spill report.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", FMAD_FLAG, "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
TF32_ENV = ("NVIDIA_TF32_OVERRIDE", "0")


def pin_precision() -> None:
    """f32 matmuls and convolutions in full f32 on the card: TF32 off in
    cuBLAS and cuDNN, and the matmul precision ``"highest"``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def main(argv: list[str] | None = None) -> int:
    """Print the pins for a shell: the environment line (``--export``
    makes it an ``export`` for ``eval``)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--export", action="store_true",
                    help="emit an eval-able 'export NVIDIA_TF32_OVERRIDE=0'")
    args = ap.parse_args(argv)
    name, value = TF32_ENV
    print(f"export {name}={value}" if args.export else f"{name}={value}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
