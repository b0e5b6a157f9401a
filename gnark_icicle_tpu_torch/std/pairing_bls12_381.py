"""In-circuit BLS12-381 optimal-ate pairing over the emulated tower.

Role parity: reference std/algebra/emulated/sw_bls12381 (pairing.go — the
Miller loop with sparse M-twist line evaluations and the exact hard-part
final exponentiation; the layer the BLS12-381 KZG/recursion gadgets build
on). Mirrors the validated host oracle (curves/pairing.py BLSPairing with
m_twist=True): loop over |x| with a closing conjugation for the negative
seed, no BN Frobenius end steps.

Differences from the D-twist gadgets (std/pairing_bn254.py,
std/pairing_bls12_377.py), both derived from the untwist
ψ(x', y') = (x'/w², y'/w³) of the M-twist E': y² = x³ + 4(1+u):

  line shape   ℓ ∝ (λx_R − y_R) + (−λ·x_P)·w² + y_P·w³   (w³-scaled;
               Fp2 factors are killed by the easy part of the final
               exponentiation, so the scaling is free)
  twist b      b·ξ = 4(1+u) (curves/bls12_381.py G2_B)

Final exponentiation: easy part conj·inv then ^(p²+1); hard part via the
same Hayashida-Hayasaka-Teruya factorization as BLS12-377 — EXACT because
BLS12-381's (negative) seed also satisfies x ≡ 1 (mod 3):
    (p⁴−p²+1)/r = (x−1)·((x−1)/3)·(x+p)·(x²+p²−1) + 1
(asserted at import; negative powers run through the cyclotomic
conjugate). The gadget therefore equals the host oracle bit-for-bit.

Cost note: one pairing is ~10⁴ emulated E2 multiplications over a 6-limb
381-bit field — engine-practical and the semantic base for cross-curve
recursion; constraint-compiling it rides the deferred-mulcheck emulated
path (ROADMAP).

Copied from gnark_icicle_tpu/std/pairing_bls12_381.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_recursion.py holds it to the original.
"""

from __future__ import annotations

from .algebra_towers import E2, E6, E12
from .emulated import BLS12381_FP, EmulatedField
from ..curves import bls12_381 as b381
from ..curves.tower import Fp2

P = b381.P
R = b381.R
X = b381.X_SEED          # negative seed
AX = -X                  # loop count |x|


def _host_pow2(a: Fp2, e: int) -> Fp2:
    r = Fp2(b381.TOWER, 1, 0)
    while e:
        if e & 1:
            r = r * a
        a = a * a
        e >>= 1
    return r


_XI = Fp2(b381.TOWER, 1, 1)  # ξ = 1 + u
# Frobenius gammas: γ_k = ξ^{k(p−1)/6} (Fp2), γ2_k = ξ^{k(p²−1)/6} (real)
_G1 = [_host_pow2(_XI, (P - 1) * k // 6) for k in range(1, 6)]
_G2 = [_host_pow2(_XI, (P * P - 1) * k // 6) for k in range(1, 6)]
assert all(v.c1 == 0 for v in _G2)

# hard-part factorization (exact — see module docstring)
_HARD = (P**4 - P**2 + 1) // R
assert (X - 1) % 3 == 0
assert (X - 1) * ((X - 1) // 3) * (X + P) * (X * X + P * P - 1) + 1 == _HARD


def bls12_381_towers(api, native_modulus: int):
    """(fp, e2, e6, e12) instantiated for the BLS12-381 base field."""
    fp = EmulatedField(api, BLS12381_FP, native_modulus)
    e2 = E2(fp, beta=-1, xi=(1, 1))
    e6 = E6(e2)
    return fp, e2, e6, E12(e6)


class BLS12381Pairing:
    """Pairing gadget over emulated BLS12-381 (≙ sw_bls12381.Pairing)."""

    def __init__(self, api, native_modulus: int):
        self.api = api
        self.fp, self.e2, self.e6, self.e12 = bls12_381_towers(
            api, native_modulus
        )

    # -- constants into the gadget domain -----------------------------------
    def _c2(self, v: Fp2):
        return self.e2.constant(v.c0, v.c1)

    def _zero2(self):
        return self.e2.zero()

    # -- twist arithmetic (affine, incomplete — pairing inputs are valid
    #    curve points and the ate loop never hits the exceptional cases
    #    for points of prime order) -----------------------------------------
    def _twist_double(self, Rp):
        e2 = self.e2
        x, y = Rp
        lam = e2.mul(
            e2.mul(e2.square(x), self._c2(Fp2(b381.TOWER, 3, 0))),
            e2.inverse(e2.add(y, y)),
        )
        x3 = e2.sub(e2.square(lam), e2.add(x, x))
        y3 = e2.sub(e2.mul(lam, e2.sub(x, x3)), y)
        return (x3, y3), lam

    def _twist_add(self, Rp, Q):
        e2 = self.e2
        x1, y1 = Rp
        x2, y2 = Q
        lam = e2.mul(e2.sub(y2, y1), e2.inverse(e2.sub(x2, x1)))
        x3 = e2.sub(e2.sub(e2.square(lam), x1), x2)
        y3 = e2.sub(e2.mul(lam, e2.sub(x1, x3)), y1)
        return (x3, y3), lam

    def _line(self, lam, Rp, p_g1):
        """Sparse M-twist line (w³-scaled, see module docstring):
        ℓ = (λx_R − y_R) + (−λ·x_P)·w² + y_P·w³, with w² = v landing in
        c01 and w³ in c11 of ((c00,c01,c02),(c10,c11,c12))."""
        e2 = self.e2
        fp = self.fp
        xr, yr = Rp
        xp, yp = p_g1  # emulated Fp elements
        z2 = self._zero2()
        a00 = e2.sub(e2.mul(lam, xr), yr)
        neg_xp = fp.neg(xp)
        a01 = (self.fp.mul(lam[0], neg_xp), self.fp.mul(lam[1], neg_xp))
        a11 = (yp, fp.constant(0))
        return ((a00, a01, z2), (z2, a11, z2))

    # -- Fp12 Frobenius via coefficient tables ------------------------------
    def _frob(self, f):
        e2 = self.e2
        (c00, c01, c02), (c10, c11, c12) = f
        cj = e2.conjugate
        return (
            (cj(c00), e2.mul(cj(c01), self._c2(_G1[1])),
             e2.mul(cj(c02), self._c2(_G1[3]))),
            (e2.mul(cj(c10), self._c2(_G1[0])),
             e2.mul(cj(c11), self._c2(_G1[2])),
             e2.mul(cj(c12), self._c2(_G1[4]))),
        )

    def _frob2(self, f):
        e2 = self.e2
        (c00, c01, c02), (c10, c11, c12) = f
        return (
            (c00, e2.mul(c01, self._c2(_G2[1])),
             e2.mul(c02, self._c2(_G2[3]))),
            (e2.mul(c10, self._c2(_G2[0])),
             e2.mul(c11, self._c2(_G2[2])),
             e2.mul(c12, self._c2(_G2[4]))),
        )

    # -- Miller loop ---------------------------------------------------------
    def miller_loop(self, p_g1, q_g2):
        """f_{|x|,Q}(P), conjugated for the negative seed (≙ host
        BLSPairing.miller_loop). p_g1: (x, y) emulated Fp elements;
        q_g2: (x, y) E2 pairs; inputs must be valid curve points."""
        e12 = self.e12
        f = e12.one()
        Rp = q_g2
        for bit in bin(AX)[3:]:
            f = e12.square(f)
            r_old = Rp
            Rp, lam = self._twist_double(Rp)
            f = e12.mul(f, self._line(lam, r_old, p_g1))
            if bit == "1":
                r_old = Rp
                Rp, lam2 = self._twist_add(Rp, q_g2)
                f = e12.mul(f, self._line(lam2, r_old, p_g1))
        return e12.conjugate(f)  # x < 0: f^(p⁶) = 1/f in the pairing value

    # -- final exponentiation ------------------------------------------------
    def _cyc_pow(self, f, e: int):
        """f^e in the cyclotomic subgroup (conjugate = inverse there)."""
        e12 = self.e12
        if e < 0:
            f = e12.conjugate(f)
            e = -e
        acc = e12.one()
        for b in bin(e)[2:]:
            acc = e12.square(acc)
            if b == "1":
                acc = e12.mul(acc, f)
        return acc

    def final_exponentiation(self, f):
        e12 = self.e12
        f1 = e12.mul(e12.conjugate(f), e12.inverse(f))  # f^(p⁶−1)
        f2 = e12.mul(self._frob2(f1), f1)               # ^(p²+1)
        # hard part: (x−1)·((x−1)/3)·(x+p)·(x²+p²−1) + 1  (exact)
        a = self._cyc_pow(f2, X - 1)
        a = self._cyc_pow(a, (X - 1) // 3)
        b = e12.mul(self._cyc_pow(a, X), self._frob(a))          # ^(x+p)
        c = self._cyc_pow(self._cyc_pow(b, X), X)                # ^(x²)
        c = e12.mul(e12.mul(c, self._frob2(b)),
                    e12.conjugate(b))                            # ·^(p²−1)
        return e12.mul(c, f2)                                    # ·f2

    def pair(self, p_g1, q_g2):
        return self.final_exponentiation(self.miller_loop(p_g1, q_g2))

    # -- verification shapes -------------------------------------------------
    def assert_pairing_check(self, pairs):
        """Constrain ∏ e(Pᵢ, Qᵢ) == 1 (≙ Pairing.PairingCheck)."""
        e12 = self.e12
        f = e12.one()
        for p1, q2 in pairs:
            f = e12.mul(f, self.miller_loop(p1, q2))
        e12.assert_equal(self.final_exponentiation(f), e12.one())

    def gt_constant(self, v):
        """Host Fp12 (curves.tower) -> gadget constant."""
        def c6(h6):
            return tuple(self._c2(c) for c in (h6.b0, h6.b1, h6.b2))

        return (c6(v.a0), c6(v.a1))

    def assert_pairing_equal(self, pairs, gt_const):
        """Constrain ∏ e(Pᵢ, Qᵢ) == gt_const (host Fp12)."""
        e12 = self.e12
        f = e12.one()
        for p1, q2 in pairs:
            f = e12.mul(f, self.miller_loop(p1, q2))
        e12.assert_equal(self.final_exponentiation(f),
                         self.gt_constant(gt_const))
