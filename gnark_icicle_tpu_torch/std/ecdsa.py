"""In-circuit ECDSA signature verification over emulated curves.

Role parity: reference std/signature/ecdsa (ecdsa.go PublicKey.Verify —
u₁ = H·s⁻¹, u₂ = r·s⁻¹ mod n, R' = [u₁]G + [u₂]Q via JointScalarMulBase,
then R'.x mod n == r). Works for any std/sw_emulated.SWCurveParams
(secp256k1 and P256 presets, ≙ the reference's generic [T, S] params).

Copied from gnark_icicle_tpu/std/ecdsa.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_precompiles.py holds it to the original.
"""

from __future__ import annotations

from .sw_emulated import AffinePoint, EmulatedCurve, SWCurveParams
from .emulated import Element


class PublicKey:
    """≙ ecdsa.PublicKey[Base, Scalar] (a curve point)."""

    def __init__(self, point: AffinePoint):
        self.point = point


class Signature:
    """≙ ecdsa.Signature[Scalar] — r, s as emulated scalars."""

    def __init__(self, r: Element, s: Element):
        self.r = r
        self.s = s


def verify(curve: EmulatedCurve, pub: PublicKey, msg_hash: Element,
           sig: Signature, n_bits: int | None = None) -> None:
    """Constrain (r, s) to be a valid signature over msg_hash for pub
    (≙ PublicKey.Verify, std/signature/ecdsa/ecdsa.go).

    The inverse gadgets prove s ≠ 0 and r ≠ 0 (r enters u₂ = r/s which is
    inverted implicitly through the x-coordinate equality below only if
    nonzero; we additionally pin r ≠ 0 explicitly like the reference).
    """
    fr = curve.fr
    curve.assert_on_curve(pub.point)
    # pin canonical encodings: r, s < n (ECDSA validity requires it; also
    # removes the r+n malleability of lazily-encoded witnesses)
    fr.assert_canonical(sig.r)
    fr.assert_canonical(sig.s)
    s_inv = fr.inverse(sig.s)        # proves s ≠ 0
    fr.inverse(sig.r)                # proves r ≠ 0
    u1 = fr.mul(msg_hash, s_inv)
    u2 = fr.mul(sig.r, s_inv)
    # R' = [u1]G + [u2]Q; u1/u2 may exceed n_bits only if the caller
    # restricted bits — the default covers the full scalar field
    g_part = curve.scalar_mul_base(u1, n_bits)
    q_part = curve.scalar_mul(pub.point, u2, n_bits)
    r_point = curve.add_unified(g_part, q_part)
    # R' must not be infinity, else the signature is invalid
    curve.api.assert_is_equal(curve.is_infinity(r_point), 0)
    # x-coordinate of R' reduced into the scalar field equals r
    rx_mod_n = fr.from_foreign(r_point.x, curve.fp)
    fr.assert_equal(rx_mod_n, sig.r)
