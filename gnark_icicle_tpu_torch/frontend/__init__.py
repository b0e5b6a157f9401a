"""Circuit frontend: declaration DSL, R1CS builder, test engine.

≙ reference frontend/ (compile.go, api.go, cs/r1cs) + test/engine.go.

Copied from gnark_icicle_tpu/frontend/__init__.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from .api import Builder, Var
from .compile import Circuit, Public, Secret, compile_circuit
from .engine import Engine, is_solved, check_solved, EngineUnsatisfiedError

__all__ = [
    "Builder",
    "Var",
    "Circuit",
    "Public",
    "Secret",
    "compile_circuit",
    "Engine",
    "is_solved",
    "check_solved",
    "EngineUnsatisfiedError",
]
