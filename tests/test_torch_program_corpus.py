"""The reference fuzzer's committed corpus, replayed through the port.

Every seed under ``tests/corpus/`` is built with the reference fuzzer's own
``gen_spec``/``_build_program`` (imported from ``tests/test_program_fuzz.py``,
so the two cannot drift) and launched through both packages under both
frontier layouts: the JAX launch in interpret mode at the seed's tile, the
port at ``device="cpu"``.  The results must be equal exactly — f32, bf16
and int8 stages alike.

Two things of the port differ from the reference by design and are
checked as such:

* The corpus tiles were sized for a TPU's VMEM.  Where a tile's window and
  frontiers need more than the 227 KB of shared memory an H100 block may
  have, the port refuses it (it never shrinks a tile) and the program runs
  at :func:`corpus_tile`'s halved tile instead; the result does not depend
  on the tile.
* A program that ``ir.verify`` rejects is not launched; the port must
  reject the same programs (``test_verify_rejections_agree``).

The jax-free copy of ``gen_spec`` that the card tests use
(``tests/test_torch_kernels_cuda.py``) is held equal to the original here,
seed by seed.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import ir as jir  # noqa: E402
from repro.kernels.stencil import multi_stencil_pallas  # noqa: E402
from repro_torch import ir as tir  # noqa: E402
from test_program_fuzz import _build_program, gen_spec  # noqa: E402
from test_torch_kernels_cuda import (  # noqa: E402
    _corpus_seeds,
    corpus_program,
    corpus_spec,
    corpus_tile,
)

SEEDS = _corpus_seeds()


def _u(spec):
    return np.random.default_rng(spec["seed"]).standard_normal(
        spec["shape"]).astype(np.float32)


@pytest.mark.parametrize("seed", SEEDS)
def test_corpus_spec_copy_equals_reference(seed):
    spec = gen_spec(seed)
    assert corpus_spec(seed) == spec
    assert corpus_program(spec).serialize() == \
        _build_program(spec).serialize()


@pytest.mark.parametrize("window_kind", ["ring", "trapezoid"])
@pytest.mark.parametrize("seed", SEEDS)
def test_corpus_replay_equals_jax(seed, window_kind):
    spec = gen_spec(seed)
    jprog = _build_program(spec)
    shape = tuple(spec["shape"])
    jir.lower(jprog, shape)  # the committed corpus is all legal
    u = _u(spec)
    want = multi_stencil_pallas(
        [jnp.asarray(u)], None, None, program=jprog,
        tile=tuple(spec["tile"]), window_kind=window_kind, interpret=True,
    )
    prog = tir.Program.from_json(jprog.serialize())
    tile = corpus_tile(spec)
    if tile != tuple(spec["tile"]):
        with pytest.raises(ValueError, match="shared memory"):
            tir.run_program(prog, u, tile=tuple(spec["tile"]),
                            window_kind=window_kind, device="cpu")
    got = tir.run_program(prog, u, tile=tile, window_kind=window_kind,
                          device="cpu")
    want = np.asarray(want.astype(jnp.float32))
    assert want.shape == tuple(got.shape)
    assert np.array_equal(want, got.float().numpy()), (
        seed, float(np.abs(want - got.float().numpy()).max()))


def test_verify_rejections_agree():
    """Over the first 64 generator seeds (the hypothesis explorer's ground,
    seed 1 among them: a reflect boundary on an asymmetric halo), the
    port's verify rejects exactly the programs the reference's rejects."""
    rejected = []
    for seed in range(64):
        spec = gen_spec(seed)
        shape = tuple(spec["shape"])
        try:
            jir.lower(_build_program(spec), shape)
            ref_ok = True
        except jir.IRVerifyError:
            ref_ok = False
        try:
            tir.lower(corpus_program(spec), shape)
            port_ok = True
        except tir.IRVerifyError:
            port_ok = False
        assert ref_ok == port_ok, seed
        if not ref_ok:
            rejected.append(seed)
    assert 1 in rejected
