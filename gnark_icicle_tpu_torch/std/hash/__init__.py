"""Hash gadgets (≙ reference std/hash/): the port's copy of MiMC, which
PLONK's MiMC transcript and the BSB22 commitment hashes need.

Copied from gnark_icicle_tpu/std/hash/__init__.py:1 without its other
gadgets (keccakf, sha2, sha3), which no slice of the port reaches.
"""

from .mimc import MiMC, MiMCHost, keccak256

__all__ = ["MiMC", "MiMCHost", "keccak256"]
