"""Batched serving driver: prefill + greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --batch 4 --prompt-len 2048 --gen 16

runs on the card; ``--smoke --device cpu`` runs the reduced config on the
CPU through the kernels' plain versions.  ``--arch`` takes each of the
ten architectures: the SSM family and the Zamba2 hybrid (whose shared
attention block keeps a KV ring of ``prompt-len + gen`` slots per
application), the dense and MoE transformers, the VLM and the
encoder-decoder.  As in the reference's ``launch/serve.py``, a VLM's
patch prefix (``prefix_embeds``, B × frontend_len × d_model) and an
encoder-decoder's audio frames (``frames``) are drawn from the seeded
generator.

The VLM's prefix takes the first ``frontend_len`` positions, before the
prompt: its cache holds ``frontend_len + prompt-len + gen`` slots and
decode step i runs at position ``frontend_len + prompt-len + i``.  The
reference's ``launch/serve.py`` sizes the cache as ``prompt-len + gen``
and decodes at ``prompt-len + i``: its first decode step then differs
from a teacher-forced forward, and a prefix longer than ``gen`` does not
fit its cache at all.  This loop does not copy that.

``--conv-tile N`` routes the causal conv of every SSM prefill through
the conv kernel with N tokens per block (``SSMCfg(pallas_conv=True,
conv_tile=N)``); without it the conv is the unrolled loop, as in the
reference's default config.  :func:`main` pins f32 precision first
(``runtime.isa.pin_precision``: no TF32).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import resolve_device
from ..configs import get_config, get_smoke_config
from ..models import get_model
from ..runtime.isa import pin_precision

__all__ = ["serve", "stub_inputs", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg, params, prompts, gen: int, device=None, prefix_embeds=None,
          frames=None):
    """Prefill ``prompts`` (B, S) and decode ``gen`` tokens greedily: the
    prefill's argmax, then ``gen - 1`` decode steps.  A VLM may take a
    soft prefix ``prefix_embeds`` (B, F, d_model), which comes before the
    prompt (positions 0..F-1); an encoder-decoder takes ``frames``.
    Returns ``(tokens (B, gen), timings)``, ``timings`` holding
    ``prefill_s`` (the prefill and its argmax) and ``decode_s`` (all
    decode steps) on the host clock, with the device synchronised before
    and after each."""
    dev = resolve_device(device)
    model = get_model(cfg, device=dev)
    prompts = torch.as_tensor(prompts).to(dev)
    b, s = prompts.shape
    batch = {"tokens": prompts}
    first = s  # the first decode step's position
    if prefix_embeds is not None:
        batch["prefix_embeds"] = prefix_embeds
        first += prefix_embeds.shape[1]
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError(f"{cfg.name} serves audio frames: pass frames=")
        batch["frames"] = frames
    cache = model.init_cache(b, first + gen)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, cache)
    tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
    _sync(dev)
    t1 = time.perf_counter()
    out = [tok]
    for i in range(gen - 1):
        logits, cache = model.decode_step(params, cache, tok, first + i)
        tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
        out.append(tok)
    toks = torch.cat(out, dim=1)
    _sync(dev)
    t2 = time.perf_counter()
    return toks, {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                  "decode_steps": gen - 1}


def stub_inputs(cfg, batch: int, generator: torch.Generator) -> dict:
    """The frontend stubs' inputs, drawn from ``generator`` as the
    reference's ``launch/serve.py`` draws them: ``prefix_embeds`` for a
    VLM, ``frames`` for an encoder-decoder, N(0, 1) of shape (batch,
    frontend_len, d_model) in the compute dtype; ``{}`` for the other
    families."""
    name = {"vlm": "prefix_embeds", "encdec": "frames"}.get(cfg.family)
    if name is None:
        return {}
    x = torch.randn((batch, cfg.frontend_len, cfg.d_model),
                    generator=generator, device=generator.device)
    return {name: x.to(cfg.compute_dtype)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--conv-tile", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.conv_tile is not None:
        if cfg.ssm is None:
            ap.error(f"--conv-tile: {cfg.name} has no causal conv")
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, pallas_conv=True, conv_tile=args.conv_tile))
    dev = resolve_device(args.device)
    pin_precision()
    params = get_model(cfg, device=dev).init(args.seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    b, s = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    toks, t = serve(cfg, params, prompts, args.gen, device=dev,
                    **stub_inputs(cfg, b, gen))
    steps = max(t["decode_steps"], 1)
    print(f"prefill {b}x{s} in {t['prefill_s']:.2f}s; "
          f"decoded {t['decode_steps']} steps in {t['decode_s']:.2f}s "
          f"({t['decode_s'] / steps * 1000:.0f} ms/step/batch)")
    print("sample tokens:", toks[0, :10].tolist())
    return toks


if __name__ == "__main__":
    main()
