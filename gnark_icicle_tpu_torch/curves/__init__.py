"""Curve & field parameter registry (host-side pure-Python math).

Role parity: gnark-crypto's per-curve packages (fr/fp Element, G1/G2, pairing)
— the layer below everything in the reference (SURVEY.md layer 8). Here the
host side is pure Python big-int (used by the witness solver, setup, and the
verifier oracle); the device side lives in `gnark_icicle_tpu_torch.ops` as
limb tensors and CUDA kernels.

Copied from gnark_icicle_tpu/curves/__init__.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original. The
registry adds the two curves of the 2-chain, BLS12-377 and BW6-761, which the
original leaves to their modules.
"""

from .bn254 import BN254  # noqa: F401
from .bls12_381 import BLS12_381  # noqa: F401
from .bls12_377 import BLS12_377  # noqa: F401
from .bw6_761 import BW6_761  # noqa: F401

CURVES = {
    "bn254": BN254,
    "bls12-381": BLS12_381,
    "bls12-377": BLS12_377,
    "bw6-761": BW6_761,
}


def get_curve(name: str):
    return CURVES[name.lower()]
