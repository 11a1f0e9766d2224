"""The port's model tooling against the JAX package, on the CPU: the op
counter (``launch/op_analysis.py``) against ``launch/hlo_analysis.py``,
the collective formulas against ``launch/roofline.py``, the dry-run
(``launch/dryrun.py``) on ``meta`` against the reference's shard shapes,
the trainer's mesh and the ``train_lm`` / ``serve_lm`` twins.

* The counter gives the reference's exact flop counts for a checkpointed
  L-layer loop (forward, recompute and backward: ``2·n³·4L``) and its
  unrolled form (``3L``), as ``tests/test_hlo_analysis.py`` states them,
  and the same number as ``analyze_hlo`` on the same function.
* ``ring_wire`` equals ``roofline.collective_bytes`` on synthetic
  all-reduce, all-gather and reduce-scatter lines.
* A dry-run cell of a smoke config on a 2×2 ``meta`` mesh has argument
  bytes equal to the sum, over the reference's params, AdamW state,
  batch and cache, of shard shape × itemsize (sharded by the reference's
  rules), and a training cell prices its traced gradients at the
  reference's per-device parameter bytes.
"""

import dataclasses
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.launch.roofline import collective_bytes  # noqa: E402
from repro.models import batch_specs as j_batch_specs  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.optim import opt_state_specs as j_opt_state_specs  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as trf  # noqa: E402
from repro_torch.launch.mesh import ModelMesh  # noqa: E402
from repro_torch.launch.op_analysis import (  # noqa: E402
    LiveBytes,
    OpCounter,
    count_ops,
    model_wire_bytes,
    ring_wire,
)
from repro_torch.models import get_model as t_get_model  # noqa: E402
from repro_torch.models.layers import flatten_tree  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402

from torch.utils.checkpoint import checkpoint  # noqa: E402

from test_torch_sharding import j_rules_for  # noqa: E402


# -- the op counter ------------------------------------------------------------


def _j_layer(x, w):
    return jnp.tanh(x @ w), None


def _t_layer(x, w):
    return torch.tanh(x @ w)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_checkpointed_loop_flops_exact_and_equal_to_analyze_hlo(device):
    n, L = 128, 6

    def loss(x, ws):
        y, _ = jax.lax.scan(jax.checkpoint(_j_layer), x, ws)
        return jnp.sum(y * y)

    x = jax.ShapeDtypeStruct((n, n), jnp.float32)
    ws = jax.ShapeDtypeStruct((L, n, n), jnp.float32)
    txt = jax.jit(jax.grad(loss, argnums=(0, 1))).lower(x, ws).compile(
    ).as_text()
    want = analyze_hlo(txt).flops

    tx = torch.randn(n, n, device=device, requires_grad=True)
    tws = torch.randn(L, n, n, device=device, requires_grad=True)

    def step():
        y = tx
        for i in range(L):
            y = checkpoint(_t_layer, y, tws[i], use_reentrant=False)
        (y * y).sum().backward()

    _, cost = count_ops(step)
    assert cost.flops == 2 * n ** 3 * 4 * L  # fwd L + remat L + bwd 2L
    assert cost.flops == want
    assert cost.per_op == {"mm": cost.flops}


def test_unrolled_loop_flops_exact_and_equal_to_analyze_hlo():
    n, L = 128, 4

    def loss(x, ws):
        for i in range(L):
            x, _ = _j_layer(x, ws[i])
        return jnp.sum(x * x)

    x = jax.ShapeDtypeStruct((n, n), jnp.float32)
    ws = jax.ShapeDtypeStruct((L, n, n), jnp.float32)
    txt = jax.jit(jax.grad(loss, argnums=(0, 1))).lower(x, ws).compile(
    ).as_text()
    tx = torch.randn(n, n, requires_grad=True)
    tws = torch.randn(L, n, n, requires_grad=True)

    def step():
        y = tx
        for i in range(L):
            y = _t_layer(y, tws[i])
        (y * y).sum().backward()

    _, cost = count_ops(step)
    assert cost.flops == 2 * n ** 3 * 3 * L
    assert cost.flops == analyze_hlo(txt).flops


def test_counter_sees_composites_under_inference_mode():
    """Serving runs under ``inference_mode``, where ``einsum`` and
    ``matmul`` reach a dispatch mode whole: they are counted through
    their products, as under autograd."""
    a, b = torch.randn(3, 4, 8), torch.randn(8, 5)
    with torch.inference_mode():
        _, cost = count_ops(lambda: (torch.einsum("bsd,dv->bsv", a, b),
                                     a @ b))
    assert cost.flops == 2 * (2 * 3 * 4 * 5 * 8)
    w = torch.randn(6, 4, 3, requires_grad=True)
    x = torch.randn(2, 4, 10, requires_grad=True)
    _, cost = count_ops(lambda: torch.nn.functional.conv1d(x, w).sum()
                        .backward())
    fwd = 2 * (2 * 6 * 8) * 4 * 3
    assert cost.per_op == {"convolution": fwd,
                           "convolution_backward": 2 * fwd}


def test_bytes_count_operands_and_results_of_non_views():
    a = torch.randn(16, 32)
    with OpCounter() as c:
        b = a.t()        # a view: nothing
        _ = b + 1.0      # reads 2 KiB, writes 2 KiB
    assert c.cost.hbm_bytes == 2 * 16 * 32 * 4


def test_live_bytes_follows_allocations_and_frees():
    a = torch.randn(256, device="meta")
    with LiveBytes() as lb:
        b = a * 2          # 1 KiB new (``a`` existed: not counted)
        c = b * 2          # 1 KiB new: live 2 KiB, the peak
        del b              # freed: live 1 KiB
        d = c + 1          # 1 KiB new: live 2 KiB again
        c.add_(1)          # in place: nothing new
        lb.resize(d, 100)
    assert lb.peak == 2 * 1024
    assert lb.live == 1024 + 100


@pytest.mark.parametrize("op,line", [
    ("all-reduce", "ROOT %ar = f32[16,16] all-reduce(%p), "
                   "replica_groups={{0,1,2,3}}, to_apply=%add"),
    ("all-gather", "ROOT %ag = f32[16,16] all-gather(%p), "
                   "replica_groups={{0,1,2,3}}, dimensions={0}"),
    ("reduce-scatter", "ROOT %rs = f32[4,16] reduce-scatter(%p), "
                       "replica_groups={{0,1,2,3}}, dimensions={0}"),
])
def test_ring_factors_equal_the_reference(op, line):
    hlo = ("HloModule m\n\nENTRY %main (p: f32[16,16]) -> f32[16,16] {\n"
           "  %p = f32[16,16] parameter(0)\n  " + line + "\n}\n")
    want = collective_bytes(hlo, world=4)
    assert want.per_op == {op: want.wire_bytes}
    # the all-gather's output, the others' full operand: 16·16 f32
    assert ring_wire(op, 16 * 16 * 4, 4) == pytest.approx(want.wire_bytes)
    assert analyze_hlo(hlo, world=4).wire_bytes == pytest.approx(
        want.wire_bytes)


def test_wire_model_terms():
    """fsdp parameters: an all-gather a pass (forward and recompute) and a
    reduce-scatter; replicated ones an all-reduce over the data axes;
    tensor parallelism four all-reduces a block (two forward, two
    backward) plus two a recompute."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("granite-3-2b"),
                              remat=True).bind(tp=2, dp=2)
    mesh = ModelMesh(("data", "model"), (2, 2), (torch.device("meta"),) * 4)
    specs = t_get_model(cfg, device="meta").param_specs()
    rules = dryrun.rules_for(cfg)
    train = model_wire_bytes(cfg, specs, mesh, rules, kind="train",
                             local_batch=2, seq=16)
    serve = model_wire_bytes(cfg, specs, mesh, rules, kind="prefill",
                             local_batch=2, seq=16)
    assert set(train.per_coll) == {"all-gather", "reduce-scatter",
                                   "all-reduce"}
    assert train.per_coll["all-gather"] == pytest.approx(
        2 * serve.per_coll["all-gather"])
    assert "reduce-scatter" not in serve.per_coll
    resid = 2 * 16 * cfg.d_model * 2  # bf16 residual stream a device
    tp_serve = cfg.n_layers * 2 * ring_wire("all-reduce", resid, 2)
    assert serve.per_coll["all-reduce"] == pytest.approx(tp_serve)
    assert train.wire_bytes == pytest.approx(sum(train.per_coll.values()))


def test_roofline_constants_are_the_h100s_published_figures():
    assert (trf.PEAK_FLOPS, trf.HBM_BW, trf.LINK_BW) == (989e12, 3.35e12,
                                                         450e9)
    from repro_torch.launch.op_analysis import OpCost

    r = trf.analyze(OpCost(flops=989e12, hbm_bytes=3.35e12 / 2,
                           wire_bytes=0.0), 2 * 989e12, 4)
    assert r.bottleneck == "compute" and r.t_compute == 1.0
    assert r.useful_ratio == 0.5
    assert sorted(r.to_dict()) == sorted([
        "flops", "hbm_bytes", "wire_bytes", "t_compute_s", "t_memory_s",
        "t_collective_s", "bottleneck", "model_flops_per_device",
        "useful_flop_ratio", "collectives"])


# -- the dry-run ------------------------------------------------------------------


SMALL = {
    "train_4k": dict(seq_len=32, global_batch=4),
    "prefill_32k": dict(seq_len=32, global_batch=4),
    "decode_32k": dict(seq_len=64, global_batch=4),
    "long_500k": dict(seq_len=128, global_batch=1),
}


@pytest.fixture
def smoke_cells(monkeypatch):
    """The dry-run over smoke configs and short shapes."""
    small = {k: dataclasses.replace(v, **SMALL[k])
             for k, v in tconfigs.LM_SHAPES.items()}
    monkeypatch.setattr(dryrun, "LM_SHAPES", small)
    monkeypatch.setattr(dryrun, "get_config", tconfigs.get_smoke_config)
    return small


def _j_bytes(tree, mesh, rules):
    leaves = jax.tree.leaves(
        jsh.specs_to_structs(tree, mesh, rules),
        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    return sum(int(np.prod(s.sharding.shard_shape(s.shape)))
               * jnp.dtype(s.dtype).itemsize for s in leaves)


class GradBytes(LiveBytes):
    """A tracker that adds up the per-device bytes the dry-run prices
    each gradient at."""

    def __init__(self):
        super().__init__()
        self.n_grads = self.grad_bytes = 0

    def resize(self, t, nbytes):
        self.n_grads += 1
        self.grad_bytes += nbytes
        super().resize(t, nbytes)


@pytest.mark.parametrize("arch", ["granite-3-2b", "mixtral-8x22b",
                                  "zamba2-2.7b", "whisper-large-v3",
                                  "internvl2-2b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_cell_argument_bytes_equal_the_reference_shards(smoke_cells, arch,
                                                        shape):
    mesh = ModelMesh(("data", "model"), (2, 2), (torch.device("meta"),) * 4)
    cell = dryrun.build_cell(arch, shape, mesh)
    inputs = cell.inputs()
    with GradBytes() as tracker:
        counted = cell.step(tracker, *inputs)
    assert counted.flops > 0 and tracker.peak > 0
    got = sum(s.local_bytes for tree in cell.structs.values()
              for _, s in flatten_tree(tree))

    sc = smoke_cells[shape]
    jc = jconfigs.get_smoke_config(arch).bind(tp=2, dp=2)
    j_mesh = AbstractMesh((2, 2), ("data", "model"))
    rules = j_rules_for(jc)
    jm = j_get_model(jc)
    j_shape = dataclasses.replace(jconfigs.LM_SHAPES[shape],
                                  **SMALL[shape])
    want = _j_bytes(jm.param_specs(), j_mesh, rules)
    want += _j_bytes(j_batch_specs(jc, j_shape), j_mesh, rules)
    if sc.kind == "train":
        want += _j_bytes(j_opt_state_specs(jm.param_specs()), j_mesh, rules)
    else:
        want += _j_bytes(jm.cache_specs(sc.global_batch, sc.seq_len,
                                        ring=sc.kind == "decode"),
                         j_mesh, rules)
    assert got == want
    if sc.kind == "train":
        n_params = sum(1 for _ in inputs[0].parameters())
        assert tracker.n_grads == n_params
        assert tracker.grad_bytes == _j_bytes(jm.param_specs(), j_mesh,
                                              rules)
    assert cell.local_batch == sc.global_batch // 2
    assert cell.replicas == 2


def test_dryrun_main_records_resumes_and_skips(smoke_cells, tmp_path):
    out = tmp_path / "dryrun.jsonl"
    argv = ["--arch", "granite-3-2b", "--mesh", "single", "--out", str(out)]
    with redirect_stdout(io.StringIO()) as buf:
        recs = dryrun.main(argv)
    text = buf.getvalue()
    assert "SKIP granite-3-2b long_500k" in text
    assert [r["shape"] for r in recs] == ["train_4k", "prefill_32k",
                                          "decode_32k"]
    for r in recs:
        assert r["ok"], r
        assert r["mesh"] == "16x16" and r["world"] == 256
        assert r["bytes_per_device"] == (
            r["memory"]["argument_size_in_bytes"]
            + r["memory"]["temp_size_in_bytes"])
        assert r["fits_80g"] is True
        assert "upper bound" in r["memory"]["temp_note"]
        assert r["roofline"]["bottleneck"] in ("compute", "memory",
                                               "collective")
        assert "fits_16g" not in r and "bytes_per_device_tpu_est" not in r
    train = recs[0]
    assert train["model_flops"] == 6.0 * train["n_active"] * 4 * 32
    assert 0 < train["roofline"]["useful_flop_ratio"] <= 1
    assert len(out.read_text().splitlines()) == 3
    with redirect_stdout(io.StringIO()) as buf:
        assert dryrun.main(argv) == []
    assert buf.getvalue().count("cached granite-3-2b") == 3


def test_dryrun_full_size_decode_cell_on_the_multi_pod_mesh():
    """One cell at published size: mixtral-8x22b decode_32k on 2×16×16,
    nothing allocated."""
    rec = dryrun.run_cell("mixtral-8x22b", "decode_32k", True)
    assert rec["ok"] and rec["world"] == 512 and rec["local_batch"] == 4
    assert rec["fits_80g"]
    # the ring cache (window 4096) and the weights, sharded 512 ways
    assert 1e9 < rec["memory"]["argument_size_in_bytes"] < 80e9
    json.dumps(rec)


def test_model_init_on_meta_draws_without_a_generator():
    params = t_get_model(tconfigs.get_smoke_config("granite-3-2b"),
                         device="meta").init(0)
    assert {p.device.type for p in params.parameters()} == {"meta"}


# -- the trainer's mesh and the LM twins ---------------------------------------


def test_trainer_runs_its_loop_under_the_test_mesh(tmp_path):
    from repro_torch.launch import train as ttrain

    with tsh.record_constraints() as seen, redirect_stdout(io.StringIO()):
        losses = ttrain.main(["--smoke", "--device", "cpu", "--steps", "2",
                              "--batch", "2", "--seq", "16"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert seen and {sh.mesh.shape["data"] for _, _, sh in seen} == {1}
    assert tsh.current_mesh() is None


def test_train_lm_twin_lowers_its_loss_on_the_cpu(tmp_path):
    from repro_torch.examples import train_lm

    with redirect_stdout(io.StringIO()) as buf:
        losses = train_lm.main(["--smoke", "--device", "cpu", "--steps",
                                "40", "--batch", "4", "--seq", "64",
                                "--ckpt-dir", str(tmp_path / "ck")])
    assert "lm-100m" in buf.getvalue()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert tconfigs.get_config("lm_100m").d_model == 768
    assert tconfigs.get_smoke_config("lm_100m").d_model == 64
    assert os.path.isdir(tmp_path / "ck")


def test_serve_lm_twin_on_the_cpu():
    from repro_torch.examples import serve_lm

    with redirect_stdout(io.StringIO()) as buf:
        toks = serve_lm.main(["--arch", "mixtral-8x22b", "--batch", "2",
                              "--device", "cpu"])
    assert tuple(toks.shape) == (2, 12)
    assert "prefill 2x24" in buf.getvalue()
