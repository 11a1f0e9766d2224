"""Batched serving example: prefill + greedy decode on the smoke model.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch mixtral-8x22b

The twin of the JAX package's ``examples/serve_lm.py``: the reduced
(smoke) config of ``--arch``, batch ``--batch``, 24 prompt tokens and 12
generated ones through :func:`repro_torch.launch.serve.main`.  It runs
on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse

from ..launch.serve import main as serve_main

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return serve_main([
        "--arch", args.arch, "--smoke", "--batch", str(args.batch),
        "--prompt-len", "24", "--gen", "12",
        *(["--device", args.device] if args.device else []),
    ])


if __name__ == "__main__":
    main()
