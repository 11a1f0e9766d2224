"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --batch 2 --seq 4096 --steps 50 --ckpt-dir ckpt

runs on the card; ``--smoke --device cpu`` trains the reduced config on
the CPU through the kernels' plain versions.  The JAX package's loop: the
token pipeline, AdamW, checkpoint/restart (auto-resume from LATEST, async
writes in the reference's format), and the heartbeat monitor.  One
process drives one device; the reference's mesh and its ``shard_map``
compression path come with ``ROADMAP.md`` queue A item 12.  ``--arch``
takes the SSM family, the Zamba2 hybrid, and the dense, MoE and VLM
transformers (the default is ``granite-3-2b``, as in the reference); a
VLM trains on the pipeline's token batches alone, as the reference's
pipeline feeds it.  The encoder-decoder raises ``ValueError``: the
pipeline gives no ``frames``.  ``--conv-tile N`` routes the causal conv
of an SSM through the conv kernel with N tokens per block, as
``launch/serve.py``'s flag does.

:func:`train_step` is the step: the loss under autograd, ``backward()``,
then :func:`~repro_torch.optim.adamw_update` in place.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import convert, resolve_device
from ..checkpoint import CheckpointConfig, Checkpointer
from ..configs import get_config, get_smoke_config
from ..data import DataConfig, TokenPipeline
from ..models import get_model
from ..models.layers import flatten_tree
from ..optim import (
    OptConfig,
    adamw_init,
    adamw_update,
    decay_mask,
    opt_state_specs,
)
from ..runtime import Action, ClusterMonitor

__all__ = ["main", "restore_state", "save_state", "train_step"]


def train_step(model, params, opt_state, batch, opt_cfg: OptConfig):
    """One training step of ``params`` (the family's module) on ``batch``
    (``tokens``, ``targets``, ``mask``, and ``prefix_embeds`` or
    ``frames`` where the family takes them; numpy arrays or tensors).  Returns
    ``(params, opt_state, metrics)``: the parameters are updated in place,
    their gradients freed; ``metrics`` holds ``loss``, ``grad_norm`` and
    ``lr`` as 0-dim tensors on the device."""
    params.zero_grad(set_to_none=True)
    loss = model.loss(params, batch)
    loss.backward()
    named = dict(params.named_parameters())
    grads = {k: p.grad for k, p in named.items()}
    decay = decay_mask(named, model.param_specs())
    _, opt_state, metrics = adamw_update(opt_cfg, grads, opt_state, named,
                                         decay)
    params.zero_grad(set_to_none=True)
    metrics["loss"] = loss.detach()
    return params, opt_state, metrics


def save_state(ckpt: Checkpointer, step: int, params, opt_state,
               blocking: bool = True) -> None:
    """Save ``(params, opt_state)`` as the reference's trees (layers
    stacked), so the JAX package's ``Checkpointer.restore`` reads it."""
    ckpt.save(step, (convert.params_to_reference(params),
                     convert.opt_state_to_reference(opt_state)),
              blocking=blocking)


def restore_state(ckpt: Checkpointer, model, params, step=None):
    """Load step ``step`` (default: LATEST) of a checkpoint in the
    reference's format into ``params`` (in place).  Returns
    ``(opt_state, step)``."""
    specs = model.param_specs()
    (p_np, o_np), step = ckpt.restore((specs, opt_state_specs(specs)),
                                      step=step)
    dev = next(params.parameters()).device
    params.load_flat(
        (path, torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dev))
        for path, a in flatten_tree(p_np)
    )
    return convert.opt_state_from_reference(o_np, model.cfg, dev), step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--conv-tile", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name} trains on audio frames, and the token pipeline "
            "gives no 'frames'")
    if args.conv_tile is not None:
        if cfg.ssm is None:
            ap.error(f"--conv-tile: {cfg.name} has no causal conv")
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, pallas_conv=True, conv_tile=args.conv_tile))
    dev = resolve_device(args.device)
    model = get_model(cfg, device=dev)
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps)
    monitor = ClusterMonitor()

    data = TokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed,
    ))

    params = model.init(args.seed)
    opt_state = adamw_init(dict(params.named_parameters()))
    start_step = 0

    ckpt = None
    if args.ckpt_dir:
        ckpt = Checkpointer(CheckpointConfig(args.ckpt_dir))
        if ckpt.latest_step() is not None:
            opt_state, start_step = restore_state(ckpt, model, params)
            print(f"resumed from step {start_step}")

    t0 = time.time()
    losses = []
    for step in range(start_step, args.steps):
        params, opt_state, metrics = train_step(
            model, params, opt_state, data.batch_at(step), opt_cfg)
        losses.append(float(metrics["loss"]))
        action = monitor.tick(host=0, step=step)
        if action not in (Action.CONTINUE, Action.WAIT):
            print(f"monitor action: {action} (single-host: informational)")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            save_state(ckpt, step + 1, params, opt_state, blocking=False)
        if (step + 1) % args.log_every == 0:
            dt = (time.time() - t0) / (step + 1 - start_step)
            print(
                f"step {step+1} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e} ({dt:.2f}s/step)",
                flush=True,
            )
    if ckpt:
        save_state(ckpt, args.steps, params, opt_state, blocking=True)
    if losses:
        first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
        last = np.mean(losses[-5:])
        print(f"done: loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return losses


if __name__ == "__main__":
    main()
