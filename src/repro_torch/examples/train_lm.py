"""End-to-end driver: train a ~100M-param LM for a few hundred steps.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300

The twin of the JAX package's ``examples/train_lm.py``: the same 100M
config (12 layers, d 768, 12 heads, ff 3072, vocab 32000), registered as
``repro_torch.configs.lm_100m`` where ``configs.get_config`` finds it,
and trained through :func:`repro_torch.launch.train.main` with
checkpoints every 100 steps.  It runs on the card; ``--smoke --device
cpu`` trains the registered smoke config (2 layers, d 64) on the CPU.
Checkpoints go to ``--ckpt-dir`` (default: ``repro_torch_100m_ckpt``
under the temporary directory); a second run resumes from its LATEST.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import types

from ..configs.base import ModelCfg
from ..launch.train import main as train_main

__all__ = ["HUNDRED_M", "main", "register"]

# ~100M params: 12L, d=768, 12H, ff=3072, 32k vocab (GPT-2-small-ish).
HUNDRED_M = ModelCfg(
    name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=12, d_ff=3072, vocab=32000, q_chunk=128, loss_chunk=128,
    fsdp=False,
)


def register() -> str:
    """Register the config module ``repro_torch.configs.lm_100m`` (its
    ``CONFIG`` and ``smoke()``); returns the arch name to pass."""
    mod = types.ModuleType("repro_torch.configs.lm_100m")
    mod.CONFIG = HUNDRED_M
    mod.smoke = lambda: dataclasses.replace(
        HUNDRED_M, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512)
    sys.modules[mod.__name__] = mod
    return "lm_100m"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    ap.add_argument("--smoke", action="store_true",
                    help="the registered smoke config (2 layers, d 64)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    arch = register()
    from ..models import count_params

    n = count_params(HUNDRED_M)
    print(f"training {HUNDRED_M.name}: {n/1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq}")
    return train_main([
        "--arch", arch, "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
        "--log-every", "20",
        *(["--smoke"] if args.smoke else []),
        *(["--device", args.device] if args.device else []),
    ])


if __name__ == "__main__":
    main()
