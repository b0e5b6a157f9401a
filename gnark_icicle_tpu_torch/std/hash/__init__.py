"""Hash gadgets (≙ reference std/hash/): the port's copies of MiMC (PLONK's
MiMC transcript, the BSB22 commitment hashes, the rollup's account tree and
EdDSA messages), SHA-256 (``sha2``, the EVM's 0x02 precompile), the
keccak-f[1600] permutation (``keccakf``) and the SHA-3 / Keccak-256 sponges
over it (``sha3``), each imported from its module.

Copied from gnark_icicle_tpu/std/hash/__init__.py:1, which exports the same
names.
"""

from .mimc import MiMC, MiMCHost, keccak256

__all__ = ["MiMC", "MiMCHost", "keccak256"]
