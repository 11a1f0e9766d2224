"""The port's decoder-only transformers against the JAX package, on the
CPU: training.  The loss and its gradients for the seven architectures of
``test_torch_transformer.py`` at their smoke configs, as published (bf16
compute) and in f32, the reference's whole-group remat, one AdamW step,
and the trainer's CLI.  Inputs, conversions and tolerances as
``test_torch_transformer.py`` states them.  The reference's loss and
gradients are taken under ``jax.jit``, as its trainer takes them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import get_model as t_get_model  # noqa: E402
from repro_torch.models.layers import flatten_tree  # noqa: E402

from test_torch_transformer import (  # noqa: E402
    ARCHS,
    B,
    _cfgs,
    _grad_close,
    _np,
    _prefix,
)


# -- training ---------------------------------------------------------------


def _batch(cfg, seq=64, seed=0):
    b = JTokenPipeline(JDataConfig(vocab=cfg.vocab, seq_len=seq,
                                   global_batch=B, seed=seed)).batch_at(0)
    prefix = _prefix(cfg, seed=6)
    if prefix is not None:
        b["prefix_embeds"] = prefix
    return b


def _value_and_grad(jm, params, jbatch):
    """The reference's loss and gradients, jitted."""
    return jax.jit(jax.value_and_grad(jm.loss))(params, jbatch)


def _jbatch(jc, b):
    out = {k: jnp.asarray(v) for k, v in b.items()}
    if "prefix_embeds" in out:
        out["prefix_embeds"] = out["prefix_embeds"].astype(jc.compute_dtype)
    return out


@pytest.fixture(scope="module",
                params=[(a, d) for a in ARCHS for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def loss_run(request):
    """The reference's loss and gradients on a pipeline batch of 64
    tokens (two loss chunks of 32, four query chunks of 16; the VLM's
    with its prefix), and the port's on the same parameters."""
    arch, dtype = request.param
    jc, tc = _cfgs(arch, dtype)
    jm = j_get_model(jc)
    params = jm.init(jax.random.PRNGKey(2))
    b = _batch(jc)
    loss, grads = _value_and_grad(jm, params, _jbatch(jc, b))
    model = convert.params_from_reference(_np(params), tc, device="cpu")
    t_loss = t_get_model(tc, device="cpu").loss(model, b)
    t_loss.backward()

    def grads_f32():
        jc32, _ = _cfgs(arch, "float32")
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        return _np(_value_and_grad(j_get_model(jc32), p32,
                                   _jbatch(jc32, b))[1])

    return dict(dtype=dtype, loss=float(loss), grads=_np(grads),
                grads_f32=grads_f32, t_loss=float(t_loss.detach()),
                t_grads=convert._stack({n: p.grad for n, p in
                                        model.named_parameters()}))


def test_loss_matches_reference(loss_run):
    r = 1e-6 if loss_run["dtype"] == "float32" else 2.0 ** -7
    assert loss_run["t_loss"] == pytest.approx(loss_run["loss"], rel=r)


def test_loss_gradients_match_reference(loss_run):
    _grad_close(loss_run["t_grads"], loss_run["grads"], loss_run["dtype"],
                loss_run["grads_f32"])


@pytest.mark.parametrize("arch", ["granite-3-2b", "mixtral-8x22b"])
def test_group_remat_changes_no_value(arch):
    """The reference's two-level scan (``remat_groups=2``: whole-group
    remat) against the port's per-layer checkpointing: the same loss and
    gradients, in f32."""
    jc, tc = _cfgs(arch, "float32", n_layers=4, remat_groups=2)
    params = j_get_model(jc).init(jax.random.PRNGKey(3))
    b = _batch(jc)
    loss, grads = _value_and_grad(j_get_model(jc), params, _jbatch(jc, b))
    model = convert.params_from_reference(_np(params), tc, device="cpu")
    t_loss = t_get_model(tc, device="cpu").loss(model, b)
    t_loss.backward()
    assert float(t_loss) == pytest.approx(float(loss), rel=1e-6)
    _grad_close(convert._stack({n: p.grad for n, p in
                                model.named_parameters()}),
                _np(grads), "float32")


def test_train_cli_trains_granite_by_default(tmp_path, capsys):
    """No ``--arch``: granite trains, its loss falls, and a second run
    resumes from ``LATEST`` and trains to the step asked for."""
    args = ["--smoke", "--device", "cpu", "--lr", "3e-3", "--batch", "2",
            "--seq", "32", "--log-every", "4", "--ckpt-dir", str(tmp_path)]
    losses = ttrain.main(args + ["--steps", "12"])
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "done: loss" in capsys.readouterr().out
    again = ttrain.main(args + ["--steps", "14"])
    assert len(again) == 2


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "internvl2-2b"])
def test_train_step_matches_the_reference_step(arch):
    """One ``train_step`` (loss, backward, AdamW) of the port against the
    reference's loss, gradients and ``adamw_update``, in f32: parameters
    within ``rtol = 1e-5, atol = 1e-7`` but for at most 1e-3 of the
    elements (the first step's ``g / (|g| + eps)`` moves an element whose
    gradient is within ``100 · eps`` of zero by up to ``2 · lr``)."""
    from repro.optim import OptConfig as JOptConfig
    from repro.optim import adamw_init as j_adamw_init
    from repro.optim import adamw_update as j_adamw_update
    from repro_torch.optim import OptConfig, adamw_init

    jc, tc = _cfgs(arch, "float32")
    jm = j_get_model(jc)
    params = jm.init(jax.random.PRNGKey(4))
    b = JTokenPipeline(JDataConfig(vocab=jc.vocab, seq_len=64,
                                   global_batch=B, seed=1)).batch_at(0)
    _, grads = _value_and_grad(jm, params, {k: jnp.asarray(v)
                                            for k, v in b.items()})
    jcfg = JOptConfig(lr=1e-3, warmup_steps=1)
    want, _, _ = j_adamw_update(jcfg, grads, j_adamw_init(params), params)
    model = convert.params_from_reference(_np(params), tc, device="cpu")
    tm = t_get_model(tc, device="cpu")
    opt = adamw_init(dict(model.named_parameters()))
    ttrain.train_step(tm, model, opt, b, OptConfig(lr=1e-3, warmup_steps=1))
    got = convert.params_to_reference(model)
    for (path, a), (_, w) in zip(flatten_tree(got),
                                 flatten_tree(_np(want))):
        off = ~np.isclose(a, w, rtol=1e-5, atol=1e-7)
        assert off.mean() <= 1e-3, (path, off.sum())
        assert np.abs(a - w).max() <= 2.0 * 1e-3 + 1e-6, path


def test_train_cli_refuses_the_encoder_decoder():
    with pytest.raises(ValueError, match="frames"):
        ttrain.main(["--arch", "whisper-large-v3", "--smoke", "--device",
                     "cpu", "--steps", "1"])
