"""In-circuit proof verification — recursion gadgets (≙ reference
std/recursion: groth16/verifier.go, plonk/verifier.go): verify an inner
proof inside an outer circuit, built on the emulated curve and pairing
gadgets (``groth16``, ``plonk``), and the native 2-chain verifiers
(``native_groth16``, ``native_plonk``).

Copied from gnark_icicle_tpu/std/recursion/__init__.py:1, with the same
exports; the port's package also carries the native 2-chain Groth16
verifier (``native_groth16``)."""

from .groth16 import Groth16Verifier, VerifierProof  # noqa: F401
from .plonk import PlonkVerifier, PlonkVerifierProof  # noqa: F401
