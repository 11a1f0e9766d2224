"""Stencil-program IR of the PyTorch port: a copy of the JAX package's
jax-free IR (ops, shape inference, verify, lowering), so that
``Program.from_json`` reads exactly what the reference's
``Program.serialize()`` writes.

Everything here is numpy-only; ``lower.run_program`` pulls in the torch
kernels lazily.
"""

from .infer import infer_bounds, infer_halos, stage_halos, suffix_halos
from .lower import IRLowerError, Lowered, lower, run_program
from .ops import (
    BC_KINDS,
    Apply,
    Boundary,
    Bounds,
    Combine,
    Dequantize,
    Load,
    Program,
    Quantize,
    Store,
    chain_program,
    normalize_bc,
    plan_program_key,
    rhs_program,
    stencil_program,
    summarize_program,
)
from .verify import IRVerifyError, verify

__all__ = [
    "BC_KINDS",
    "Apply",
    "Boundary",
    "Bounds",
    "Combine",
    "Dequantize",
    "IRLowerError",
    "IRVerifyError",
    "Load",
    "Lowered",
    "Program",
    "Quantize",
    "Store",
    "chain_program",
    "infer_bounds",
    "infer_halos",
    "lower",
    "normalize_bc",
    "plan_program_key",
    "rhs_program",
    "run_program",
    "stage_halos",
    "stencil_program",
    "suffix_halos",
    "summarize_program",
    "verify",
]
