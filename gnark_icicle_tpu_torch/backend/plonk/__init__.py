"""PLONK on the port: setup and prove run their transforms, quotient and KZG
commitments on the card, verify on the host (≙ gnark_icicle_tpu/backend/plonk)."""

from .setup import setup, build_permutation
from .prove import prove
from .verify import verify, is_valid, PlonkVerificationError
from .keys import ProvingKey, VerifyingKey, Proof

__all__ = [
    "setup", "build_permutation", "prove", "verify", "is_valid",
    "PlonkVerificationError", "ProvingKey", "VerifyingKey", "Proof",
]
