"""Constraint IR, witness solver, hint registry.

≙ reference constraint/ (core.go System, per-curve solver) +
constraint/solver (hint registry).

Copied from gnark_icicle_tpu/constraint/__init__.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from .system import R1CS
from .solver import solve, is_satisfied, SolveResult, UnsatisfiedConstraintError
from .hints import register_hint, get_hint, hint_id

__all__ = [
    "R1CS",
    "solve",
    "is_satisfied",
    "SolveResult",
    "UnsatisfiedConstraintError",
    "register_hint",
    "get_hint",
    "hint_id",
]
