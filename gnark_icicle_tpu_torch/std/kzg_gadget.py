"""In-circuit KZG opening verification (BN254, BLS12-381).

Role parity: reference std/commitments/kzg (verifier.go — AssertProof:
e(C − v·G + z·W, G₂) · e(−W, τ·G₂) == 1, the primitive the PLONK recursion
verifier folds openings into), for the emulated curve family the reference
instantiates (kzg.NewVerifier[FR, G1El, G2El, GTEl] over sw_bn254 /
sw_bls12381). Built on std/sw_emulated (point arithmetic) and the
std/pairing_* gadgets; the τ·G₂ / G₂ points are verifier-side constants
from the SRS.

Copied from gnark_icicle_tpu/std/kzg_gadget.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_recursion.py holds it to the original.
"""

from __future__ import annotations

from .sw_emulated import BLS12381G1, BN254G1, EmulatedCurve
from .pairing_bn254 import BN254Pairing
from .emulated import Element


class KzgVerifier:
    """≙ kzg.Verifier[FR, G1El, G2El, GTEl]; curve_id ∈ {"bn254",
    "bls12-381"} selects the emulated instantiation."""

    def __init__(self, api, native_modulus: int, g2_gen, g2_tau,
                 curve_id: str = "bn254"):
        """g2_gen / g2_tau: host (Fp2, Fp2) affine points from the SRS."""
        self.api = api
        if curve_id == "bn254":
            self.curve = EmulatedCurve(api, BN254G1, native_modulus)
            self.pairing = BN254Pairing(api, native_modulus)
        elif curve_id == "bls12-381":
            from .pairing_bls12_381 import BLS12381Pairing

            self.curve = EmulatedCurve(api, BLS12381G1, native_modulus)
            self.pairing = BLS12381Pairing(api, native_modulus)
        else:
            raise ValueError(f"unsupported KZG curve {curve_id!r}")
        e2 = self.pairing.e2
        self.g2_gen = (e2.constant(g2_gen[0].c0, g2_gen[0].c1),
                       e2.constant(g2_gen[1].c0, g2_gen[1].c1))
        self.g2_tau = (e2.constant(g2_tau[0].c0, g2_tau[0].c1),
                       e2.constant(g2_tau[1].c0, g2_tau[1].c1))

    def assert_opening(self, commitment, z: Element, v: Element, proof_w,
                      n_bits: int | None = None) -> None:
        """Constrain p(z) == v for the committed polynomial:
        e(C − v·G + z·W, G₂) · e(−W, τG₂) == 1.

        commitment/proof_w: sw_emulated AffinePoints; z, v: emulated Fr.
        proof_w must be a non-identity point (constant polynomials have
        W = 0, which the affine Joye ladder cannot represent).
        """
        c = self.curve
        # C + (−v)·G + z·W with unified adds (v or z may be 0)
        vg = c.scalar_mul_base(v, n_bits)
        zw = c.scalar_mul(proof_w, z, n_bits)
        left = c.add_unified(c.add_unified(commitment, c.neg(vg)), zw)
        neg_w = c.neg(proof_w)

        def as_pair(pt):
            return (pt.x, pt.y)

        self.pairing.assert_pairing_check([
            (as_pair(left), self.g2_gen),
            (as_pair(neg_w), self.g2_tau),
        ])
