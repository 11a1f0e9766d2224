"""Two-level multigrid V-cycle written as stencil programs, on the port.

Solves the 2-D Poisson problem  A u = f  (5-point Laplacian, homogeneous
Dirichlet boundary) and drives every grid-touching step through the
port's stencil-program IR (:mod:`repro_torch.ir`) on the card:

* **Damped-Jacobi smoother** — ``u' = S u + (omega/4) f`` is one program:
  an ``apply`` of the smoother stencil on ``u``, an identity ``apply``
  on ``f``, and a ``combine`` — which lowers to the apply kernel's
  multi-RHS launch (one shared sweep over both operands).
* **Residual** — ``r = f - A u`` is the same shape with coefficients
  ``(+1, -1)``.
* **Boundary ops** — the homogeneous Dirichlet condition is exactly the
  engine's native zero fill, so these programs carry no boundary op.  The
  coda smooths the same iterate under a ``neumann`` boundary instead: one
  extra IR op, lowered to the chain kernel's correction taps — no host
  pad — and checked against the :func:`repro_torch.kernels.ref.stencil_ref`
  oracle.
* **Full-weighting restriction** — the 9-point averaging stencil is one
  more ``apply`` program; only the every-other-point injection after it
  is plain indexing, as is the piecewise-constant prolongation.  The
  coarse solve is a dense numpy solve on the host.

Run:  PYTHONPATH=src python -m repro_torch.examples.multigrid_vcycle [--device cpu]
"""

from __future__ import annotations

import argparse
from itertools import product

import numpy as np
import torch

from .. import ir, resolve_device
from ..core.cache_fitting import star_stencil
from ..kernels.ref import stencil_ref

__all__ = ["main"]

SHAPE = (48, 64)          # fine grid (coarse = half along each dim)
OMEGA = 0.8               # Jacobi damping
NU = 3                    # smoothing sweeps per leg
TILE = (8, 16)


def poisson_stencil(d: int):
    """A = 2d·I - sum(neighbors): the (2d+1)-point Laplacian."""
    offs = star_stencil(d, 1)
    weights = [2.0 * d if not any(off) else -1.0 for off in offs]
    return offs, weights


def smoother_program(d: int, omega: float) -> ir.Program:
    """u' = S u + (omega/2d) f  with  S = (1-omega)·I + (omega/2d)·N —
    a two-input program lowering to one multi-RHS launch."""
    offs = star_stencil(d, 1)
    s_weights = tuple(
        (1.0 - omega) if not any(off) else omega / (2 * d) for off in offs
    )
    return ir.Program(d=d, ops=(
        ir.Load(result="u", input="u"),
        ir.Load(result="f", input="f"),
        ir.Apply(result="Su", operand="u",
                 offsets=tuple(map(tuple, offs.tolist())),
                 weights=s_weights),
        ir.Apply(result="If", operand="f",
                 offsets=((0,) * d,), weights=(1.0,)),
        ir.Combine(result="q", operands=("Su", "If"),
                   coeffs=(1.0, omega / (2 * d))),
        ir.Store(operand="q"),
    ))


def residual_program(d: int) -> ir.Program:
    """r = f - A u."""
    offs, weights = poisson_stencil(d)
    return ir.Program(d=d, ops=(
        ir.Load(result="u", input="u"),
        ir.Load(result="f", input="f"),
        ir.Apply(result="Au", operand="u",
                 offsets=tuple(map(tuple, offs.tolist())),
                 weights=tuple(weights)),
        ir.Apply(result="If", operand="f",
                 offsets=((0,) * d,), weights=(1.0,)),
        ir.Combine(result="r", operands=("If", "Au"), coeffs=(1.0, -1.0)),
        ir.Store(operand="r"),
    ))


def full_weighting_program(d: int) -> ir.Program:
    """The 9-point (2-D) full-weighting average: tensor product of
    (1/4, 1/2, 1/4) per axis."""
    taps = list(product((-1, 0, 1), repeat=d))
    wts = tuple(
        float(np.prod([0.5 if o == 0 else 0.25 for o in off]))
        for off in taps
    )
    return ir.Program(d=d, ops=(
        ir.Load(result="r", input="r"),
        ir.Apply(result="rs", operand="r", offsets=tuple(taps),
                 weights=wts),
        ir.Store(operand="rs"),
    ))


def assemble_coarse(shape):
    """Dense coarse-grid operator from the *same* stencil the programs
    use; at 24x32 the direct solve is trivial and stands in for the
    deeper recursion of a real multigrid hierarchy."""
    m1, m2 = shape
    offs, weights = poisson_stencil(2)
    a = np.zeros((m1 * m2, m1 * m2))
    for (o1, o2), w in zip(offs.tolist(), weights):
        for i in range(m1):
            ii = i + o1
            if not 0 <= ii < m1:
                continue
            for j in range(m2):
                jj = j + o2
                if 0 <= jj < m2:
                    a[i * m2 + j, ii * m2 + jj] += w
    return a


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=2, default=SHAPE,
                    help="fine grid, both extents even")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    shape = tuple(args.shape)
    dev = resolve_device(args.device)
    d = len(shape)
    smoother = smoother_program(d, OMEGA)
    resid = residual_program(d)
    full_weight = full_weighting_program(d)
    print("smoother program:", ir.summarize_program(smoother))
    print("residual program:", ir.summarize_program(resid))
    print("restriction program:", ir.summarize_program(full_weight))
    halos = ir.infer_halos(resid)
    print(f"inferred input halos: u={halos['u']}  f={halos['f']}")

    def run(prog, arrays):
        return ir.run_program(prog, arrays, tile=TILE, sweep_axis=0,
                              device=dev)

    def smooth(u, f, sweeps):
        for _ in range(sweeps):
            u = run(smoother, {"u": u, "f": f})
        return u

    # Manufactured problem: a smooth true solution (vanishing at the
    # boundary, matching the homogeneous Dirichlet fill) and f = A u*.
    x = np.sin(np.pi * np.arange(1, shape[0] + 1) / (shape[0] + 1))
    y = np.sin(2 * np.pi * np.arange(1, shape[1] + 1) / (shape[1] + 1))
    u_true = torch.as_tensor(np.outer(x, y).astype(np.float32)).to(dev)
    a_offs, a_wts = poisson_stencil(d)
    f = stencil_ref(u_true, a_offs, a_wts)
    u = torch.zeros(shape, dtype=torch.float32, device=dev)
    a_coarse = assemble_coarse(tuple(s // 2 for s in shape))

    def v_cycle(u):
        u = smooth(u, f, NU)                                 # pre-smooth
        r = run(resid, {"u": u, "f": f})
        r_c = run(full_weight, r)[::2, ::2]                  # full-weight + inject
        # The unscaled stencil is h^-2-free, so restricting onto a grid of
        # doubled spacing scales the right-hand side by (h_c/h_f)^2 = 4.
        rhs = 4.0 * r_c.cpu().double().numpy().ravel()
        e_c = torch.as_tensor(
            np.linalg.solve(a_coarse, rhs).reshape(tuple(r_c.shape)),
            dtype=u.dtype).to(dev)
        e = e_c.repeat_interleave(2, 0).repeat_interleave(2, 1)  # prolongate
        u = u + e[: u.shape[0], : u.shape[1]]                # correct
        return smooth(u, f, NU)                              # post-smooth

    def rnorm(u):
        return float(torch.linalg.norm(run(resid, {"u": u, "f": f})))

    r0 = rnorm(u)
    for cycle in range(3):
        u = v_cycle(u)
        r = rnorm(u)
        print(f"V-cycle {cycle + 1}: |r| {r0:.4f} -> {r:.4f} "
              f"({r0 / max(r, 1e-30):.2f}x)")
        assert r < 0.7 * r0, "V-cycle failed to reduce the residual"
        r0 = r

    # Coda: the same smoother stencil under a neumann boundary — one
    # extra IR op, lowered to in-kernel correction taps (no host pad).
    offs = star_stencil(d, 1)
    wts = tuple(
        (1.0 - OMEGA) if not any(off) else OMEGA / (2 * d) for off in offs
    )
    neu = ir.chain_program([(offs, wts)], d, boundary="neumann")
    print("neumann smoother:", ir.summarize_program(neu))
    out = run(neu, u)
    ref = stencil_ref(u, offs, list(wts), boundary="neumann")
    err = float((out - ref).abs().max())
    print(f"  max |engine - oracle| = {err:.2e}")
    assert err < 1e-5, "neumann correction taps diverged from the oracle"
    print("OK")


if __name__ == "__main__":
    main()
