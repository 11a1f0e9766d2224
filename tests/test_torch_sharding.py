"""The port's logical-axis sharding and model meshes against the JAX
package, on the CPU.

* Every parameter, AdamW-state, batch and cache leaf of every
  architecture in ``list_archs()`` at every ``LM_SHAPES`` shape, bound to
  both production meshes (16×16 and 2×16×16, ``bind(tp, dp)`` as the
  reference's dry-run binds): the port's spec tree equals the
  reference's, and the port's ``logical_sharding(...)`` gives the
  reference's ``PartitionSpec`` and ``shard_shape``.  The reference's
  meshes are ``jax.sharding.AbstractMesh``es (no devices needed); the
  port's are ``make_production_mesh(device="meta")``.
* The same on a 2×2 mesh of the CPU's four host devices, with the prefix
  and the replication fallbacks and their warning.
* ``batch_specs`` and ``bind(...).padded_heads`` / ``stored_kv_heads``
  equal the reference's.
* ``constrain`` is the identity with and without a mesh (the same tensor
  object back), and a model's loss and gradients under ``activate_mesh``
  are bit-equal to those without; ``moe_block`` under ``bind(dp=2)``
  routes as the reference's ``vmap`` groups do (f32: the routes exact,
  the output within 1e-5).
"""

import ast
import dataclasses
import logging
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import batch_specs as j_batch_specs  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.optim import opt_state_specs as j_opt_state_specs  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    ModelMesh,
    make_production_mesh,
    make_test_mesh,
)
from repro_torch.models import batch_specs as t_batch_specs  # noqa: E402
from repro_torch.models import get_model as t_get_model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.layers import flatten_tree  # noqa: E402
from repro_torch.optim import opt_state_specs as t_opt_state_specs  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402

ARCHS = tconfigs.list_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _jtree(tree):
    """A reference spec tree as (path, ParamSpec) pairs in sorted order."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jsh.ParamSpec))[0]
    out = []
    for path, s in leaves:
        out.append((".".join(str(getattr(k, "key", k)) for k in path), s))
    return sorted(out, key=lambda kv: kv[0])


def _j_rules_for():
    """The reference dry-run's ``rules_for``, compiled from its source
    over the reference's ``LOGICAL_RULES``: importing
    ``repro.launch.dryrun`` would set ``XLA_FLAGS`` to 512 host devices
    for the rest of the session."""
    src = Path(jsh.__file__).parents[1] / "launch" / "dryrun.py"
    fn = next(n for n in ast.parse(src.read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == "rules_for")
    ns = {"LOGICAL_RULES": jsh.LOGICAL_RULES}
    exec(compile(ast.Module([fn], type_ignores=[]), str(src), "exec"), ns)
    return ns["rules_for"]


j_rules_for = _j_rules_for()


def _spec_entries(spec):
    return tuple(spec)


def _same_tree(t_specs, j_specs):
    """The port's spec tree equals the reference's: paths, shapes, axes,
    dtypes (by name)."""
    got = flatten_tree(t_specs)
    want = _jtree(j_specs)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, j) in zip(got, want):
        assert tuple(t.shape) == tuple(j.shape), path
        assert tuple(t.axes) == tuple(j.axes), path
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name, path


def _same_shards(t_specs, j_specs, t_mesh, j_mesh, rules, j_rules):
    """Each leaf sharded by the port's rules on the port's mesh as by the
    reference's rules on the reference's mesh."""
    for (path, t), (_, j) in zip(flatten_tree(t_specs), _jtree(j_specs)):
        t_sh = tsh.logical_sharding(t.axes, t_mesh, t.shape, rules)
        j_sh = jsh.logical_sharding(j.axes, j_mesh, j.shape, j_rules)
        assert _spec_entries(t_sh.spec) == _spec_entries(j_sh.spec), path
        assert t_sh.shard_shape(t.shape) == tuple(
            j_sh.shard_shape(tuple(j.shape))), path
        st = tsh.sharded_struct(t, t_mesh, rules)
        assert st.local_shape == t_sh.shard_shape(t.shape)
        assert st.local_bytes == int(np.prod(st.local_shape)) * st.itemsize


def test_rule_tables_equal_the_reference():
    assert tsh.LOGICAL_RULES == jsh.LOGICAL_RULES
    for arch in ARCHS:
        for tp, dp in ((16, 16), (16, 32), (2, 2)):
            assert dryrun.rules_for(tconfigs.get_config(arch).bind(
                tp=tp, dp=dp)) == j_rules_for(
                    jconfigs.get_config(arch).bind(tp=tp, dp=dp)), arch


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_shards_as_the_reference(arch, mesh_name):
    sizes, axes = MESHES[mesh_name]
    j_mesh = AbstractMesh(sizes, axes)
    t_mesh = make_production_mesh(multi_pod=len(sizes) == 3, device="meta")
    assert t_mesh.shape == dict(j_mesh.shape)
    tp = t_mesh.shape["model"]
    dp = t_mesh.shape["data"] * t_mesh.shape.get("pod", 1)
    jc = jconfigs.get_config(arch).bind(tp=tp, dp=dp)
    tc = tconfigs.get_config(arch).bind(tp=tp, dp=dp)
    rules, j_rules = dryrun.rules_for(tc), j_rules_for(jc)
    jm, tm = j_get_model(jc), t_get_model(tc, device="meta")
    t_params, j_params = tm.param_specs(), jm.param_specs()
    _same_tree(t_params, j_params)
    _same_shards(t_params, j_params, t_mesh, j_mesh, rules, j_rules)
    t_opt, j_opt = t_opt_state_specs(t_params), j_opt_state_specs(j_params)
    _same_tree(t_opt, j_opt)
    _same_shards(t_opt, j_opt, t_mesh, j_mesh, rules, j_rules)
    for name, shape in tconfigs.LM_SHAPES.items():
        j_shape = jconfigs.LM_SHAPES[name]
        t_b, j_b = t_batch_specs(tc, shape), j_batch_specs(jc, j_shape)
        _same_tree(t_b, j_b)
        _same_shards(t_b, j_b, t_mesh, j_mesh, rules, j_rules)
        if shape.kind == "train":
            continue
        ring = shape.kind == "decode"  # the reference's dry-run's choice
        t_c = tm.cache_specs(shape.global_batch, shape.seq_len, ring=ring)
        j_c = jm.cache_specs(shape.global_batch, shape.seq_len, ring=ring)
        _same_tree(t_c, j_c)
        _same_shards(t_c, j_c, t_mesh, j_mesh, rules, j_rules)


def _cpu_meshes():
    devs = jax.devices()
    assert len(devs) >= 4, "tests/conftest.py pins 4 host devices"
    j_mesh = jax.sharding.Mesh(np.array(devs[:4]).reshape(2, 2),
                               ("data", "model"))
    cpu = torch.device("cpu")
    return j_mesh, ModelMesh(("data", "model"), (2, 2), (cpu,) * 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_shards_as_the_reference_on_a_2x2_cpu_mesh(arch):
    j_mesh, t_mesh = _cpu_meshes()
    jc = jconfigs.get_smoke_config(arch).bind(tp=2, dp=2)
    tc = tconfigs.get_smoke_config(arch).bind(tp=2, dp=2)
    rules, j_rules = dryrun.rules_for(tc), j_rules_for(jc)
    t_params = t_get_model(tc, device="cpu").param_specs()
    j_params = j_get_model(jc).param_specs()
    _same_shards(t_params, j_params, t_mesh, j_mesh, rules, j_rules)
    for name, shape in tconfigs.LM_SHAPES.items():
        small = dataclasses.replace(shape, global_batch=3, seq_len=64)
        j_small = dataclasses.replace(jconfigs.LM_SHAPES[name],
                                      global_batch=3, seq_len=64)
        _same_shards(t_batch_specs(tc, small), j_batch_specs(jc, j_small),
                     t_mesh, j_mesh, rules, j_rules)


@pytest.mark.parametrize("axes,shape,want", [
    # ('pod', 'data') = 4 does not divide 2: the prefix ('pod',) does
    (("batch", ""), (2, 8), ("pod", None)),
    # divides both: the tuple
    (("batch", "tensor"), (8, 6), (("pod", "data"), "model")),
    # 3 divides neither 4 nor 2: replicated, with the warning
    (("batch", ""), (3, 8), (None, None)),
    # a mesh axis is used once an array: 'fsdp' takes (pod, data) first
    (("fsdp", "batch", "tensor"), (4, 4, 4), (("pod", "data"), None,
                                                "model")),
    # an unknown logical name, and '' : replicated
    (("nonesuch", ""), (4, 4), (None, None)),
])
def test_fallbacks_match_the_reference(axes, shape, want, caplog):
    sizes, names = (2, 2, 2), ("pod", "data", "model")
    j_mesh = AbstractMesh(sizes, names)
    t_mesh = ModelMesh(names, sizes, (torch.device("cpu"),) * 8)
    tsh._warn_replicated.cache_clear()
    with caplog.at_level(logging.WARNING):
        t_sh = tsh.logical_sharding(axes, t_mesh, shape)
    j_sh = jsh.logical_sharding(axes, j_mesh, shape)
    assert t_sh.spec == want
    assert _spec_entries(j_sh.spec) == want
    assert t_sh.shard_shape(shape) == tuple(j_sh.shard_shape(shape))
    warned = [r for r in caplog.records
              if r.name == "repro_torch.parallel.sharding"]
    assert bool(warned) == (shape[0] == 3)
    if warned:
        assert "does not divide mesh axes" in warned[0].getMessage()


@pytest.mark.parametrize("tp", [1, 2, 3, 8, 16, 32])
@pytest.mark.parametrize("arch", ARCHS)
def test_bind_pads_heads_as_the_reference(arch, tp):
    jc = jconfigs.get_config(arch).bind(tp=tp, dp=4)
    tc = tconfigs.get_config(arch).bind(tp=tp, dp=4)
    assert (tc.tp, tc.dp) == (tp, 4)
    assert tc.padded_heads == jc.padded_heads
    assert tc.vocab_padded == jc.vocab_padded
    try:
        want = jc.stored_kv_heads
    except ValueError:
        with pytest.raises(ValueError):
            tc.stored_kv_heads
        return
    assert tc.stored_kv_heads == want
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()


def test_batch_specs_cover_every_family():
    kinds = {}
    for arch in ARCHS:
        tc = tconfigs.get_config(arch)
        for name, shape in tconfigs.LM_SHAPES.items():
            keys = sorted(t_batch_specs(tc, shape))
            kinds.setdefault((tc.family, shape.kind), keys)
    assert kinds[("vlm", "train")] == ["mask", "prefix_embeds", "targets",
                                       "tokens"]
    assert kinds[("encdec", "prefill")] == ["frames", "tokens"]
    assert kinds[("dense", "prefill")] == ["tokens"]
    assert kinds[("ssm", "decode")] == ["pos", "token"]


def test_constrain_is_the_identity_with_and_without_a_mesh():
    x = torch.randn(2, 8, 16)
    assert tsh.constrain(x, ("batch", "", "")) is x
    mesh = make_test_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    with tsh.activate_mesh(mesh), tsh.record_constraints() as got:
        assert tsh.current_mesh() is mesh
        y = tsh.constrain(x, ("batch", "", "tensor"))
    assert y is x
    assert got and got[0][0] == ("batch", "", "tensor")
    assert tsh.current_mesh() is None
    assert tsh.current_rules() is tsh.LOGICAL_RULES
    with tsh.activate_mesh(mesh), pytest.raises(ValueError):
        tsh.constrain(x, ("batch", "", "", ""))


def test_make_test_mesh_clamps_and_production_mesh_needs_its_devices():
    assert make_test_mesh(4, 4, device="cpu").shape == {"data": 1,
                                                        "model": 1}
    assert make_production_mesh(device="meta").size == 256
    multi = make_production_mesh(multi_pod=True, device="meta")
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert {d.type for d in multi.devices} == {"meta"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            make_production_mesh()


@pytest.mark.parametrize("arch", ["granite-3-2b", "mixtral-8x22b",
                                  "zamba2-2.7b", "whisper-large-v3"])
def test_a_step_under_a_mesh_is_bit_equal_to_one_without(arch):
    tc = dataclasses.replace(tconfigs.get_smoke_config(arch),
                             remat_groups=2)
    if tc.moe is not None:
        tc = tc.bind(tp=1, dp=2)
    model = t_get_model(tc, device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tc.vocab, (2, 32))
    batch = {"tokens": toks, "targets": np.roll(toks, -1, 1),
             "mask": np.ones((2, 32), np.float32)}
    if tc.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (2, tc.frontend_len, tc.d_model)).astype(np.float32)

    def step(mesh):
        params = model.init(5)
        if mesh is None:
            loss = model.loss(params, batch)
            seen = []
        else:
            with tsh.activate_mesh(mesh), tsh.record_constraints() as seen:
                loss = model.loss(params, batch)
        loss.backward()
        return loss, {k: p.grad for k, p in params.named_parameters()}, seen

    l0, g0, _ = step(None)
    l1, g1, seen = step(make_test_mesh(device="cpu"))
    assert seen  # the constraints resolved against the mesh
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_moe_block_groups_route_as_the_reference_vmap():
    """``cfg.dp = 2`` splits the batch into two dispatch groups; each
    routes on its own, as the reference's ``vmap`` over groups does (f32:
    the slots exact, the output within 1e-5)."""
    jc = dataclasses.replace(
        jconfigs.get_smoke_config("mixtral-8x22b"),
        compute_dtype=jnp.float32, param_dtype=jnp.float32).bind(1, 2)
    tc = dataclasses.replace(
        tconfigs.get_smoke_config("mixtral-8x22b"),
        compute_dtype=torch.float32, param_dtype=torch.float32).bind(1, 2)
    rng = np.random.default_rng(21)
    p = {path: (rng.standard_normal(s.shape) * 0.2).astype(np.float32)
         for path, s in flatten_tree(tlayers.moe_param_specs(tc))}
    j_tree, t_tree = {}, {}
    for path, a in p.items():
        convert._set_path(j_tree, path, jnp.asarray(a))
        convert._set_path(t_tree, path, torch.tensor(a))
    x = rng.standard_normal((4, 12, tc.d_model)).astype(np.float32)
    want = np.asarray(jlayers.moe_block(jc, j_tree, jnp.asarray(x)))
    routes = []
    got = tlayers.moe_block(tc, t_tree, torch.tensor(x), routes)
    assert len(routes) == 2  # one routing a group
    xg = x.reshape(2, 24, tc.d_model)
    for g, r in enumerate(routes):
        _, slot_of, _ = jlayers._moe_route(jc, j_tree, jnp.asarray(xg[g]))
        cap = max(int(np.ceil(24 * tc.moe.top_k / tc.moe.n_experts
                              * tc.moe.capacity_factor)), 4)
        assert np.array_equal(
            r["dropped"].numpy(),
            np.asarray(slot_of) == tc.moe.n_experts * cap)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
