"""In-circuit BN254 optimal-ate pairing over the emulated tower.

Role parity: reference std/algebra/emulated/sw_bn254 (pairing.go — the
Miller loop with sparse line evaluations on the D-twist and the hard-part
final exponentiation; the layer recursion/KZG gadgets build on). This
implementation mirrors the validated host oracle (curves/pairing.py)
point-for-point: the same 6x+2 loop, the same two closing Frobenius lines,
with twist arithmetic in the E2 gadget and lines as sparse Fp12 elements.
Every constant (Frobenius coefficients, twist-point Frobenius factors, the
x-polynomial hard-part decomposition) is host-precomputed and was verified
numerically against Fp12.pow before being trusted here.

Cost note: one pairing is ~10⁴ emulated E2 multiplications — practical for
engine-level verification and as the semantic base for recursion gadgets;
compiling it to constraints awaits the range-table mul optimization.

Copied from gnark_icicle_tpu/std/pairing_bn254.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_emulated.py holds it to the original.
"""

from __future__ import annotations

from .algebra_towers import bn254_towers
from ..curves import bn254
from ..curves.tower import Fp2

P = bn254.P
X_SEED = bn254.X_SEED


def _host_pow2(a: Fp2, e: int) -> Fp2:
    r = Fp2(bn254.TOWER, 1, 0)
    while e:
        if e & 1:
            r = r * a
        a = a * a
        e >>= 1
    return r


_XI = Fp2(bn254.TOWER, 9, 1)
# Frobenius gammas: γ_k = ξ^{k(p−1)/6} (Fp2) and γ2_k = ξ^{k(p²−1)/6} (real)
_G1 = [_host_pow2(_XI, (P - 1) * k // 6) for k in range(1, 6)]
_G2 = [_host_pow2(_XI, (P * P - 1) * k // 6) for k in range(1, 6)]
assert all(v.c1 == 0 for v in _G2)
# twist-point Frobenius factors: π(x,y) = (x̄·CX, ȳ·CY)
_CX = _host_pow2(_XI, (P - 1) // 3)
_CY = _host_pow2(_XI, (P - 1) // 2)
_CX2 = _host_pow2(_XI, (P * P - 1) // 3)
_CY2 = _host_pow2(_XI, (P * P - 1) // 2)
assert _CX2.c1 == 0 and _CY2.c1 == 0
# hard part: (p⁴−p²+1)/r = p³ + λ2·p² + λ1·p + λ0 (verified numerically)
_L2 = 6 * X_SEED**2 + 1
_L1 = -(36 * X_SEED**3 + 18 * X_SEED**2 + 12 * X_SEED - 1)
_L0 = -(36 * X_SEED**3 + 30 * X_SEED**2 + 18 * X_SEED + 2)
assert (P**3 + _L2 * P**2 + _L1 * P + _L0) * bn254.R == P**4 - P**2 + 1


class BN254Pairing:
    """Pairing gadget over emulated BN254 (≙ sw_bn254.Pairing)."""

    def __init__(self, api, native_modulus: int):
        self.api = api
        self.fp, self.e2, self.e6, self.e12 = bn254_towers(
            api, native_modulus
        )

    # -- constants into the gadget domain -----------------------------------
    def _c2(self, v: Fp2):
        return self.e2.constant(v.c0, v.c1)

    def _zero2(self):
        return self.e2.zero()

    # -- twist arithmetic ----------------------------------------------------
    def _twist_double(self, R):
        e2 = self.e2
        x, y = R
        lam = e2.mul(
            e2.mul(e2.square(x), self._c2(Fp2(bn254.TOWER, 3, 0))),
            e2.inverse(e2.add(y, y)),
        )
        x3 = e2.sub(e2.square(lam), e2.add(x, x))
        y3 = e2.sub(e2.mul(lam, e2.sub(x, x3)), y)
        return (x3, y3), lam

    def _twist_add(self, R, Q):
        e2 = self.e2
        x1, y1 = R
        x2, y2 = Q
        lam = e2.mul(e2.sub(y2, y1), e2.inverse(e2.sub(x2, x1)))
        x3 = e2.sub(e2.sub(e2.square(lam), x1), x2)
        y3 = e2.sub(e2.mul(lam, e2.sub(x1, x3)), y1)
        return (x3, y3), lam

    def _line(self, lam, R, p_g1):
        """Sparse ℓ = −y_P + (λ·x_P)·w + (y_R − λ·x_R)·w³ as a full Fp12
        element (≙ the host _line on untwisted points — verified shape)."""
        e2, e6 = self.e2, self.e6
        xr, yr = R
        xp, yp = p_g1  # emulated Fp elements
        z2 = self._zero2()
        a00 = (self.fp.neg(yp), self.fp.constant(0))
        a10 = e2.mul(lam, (xp, self.fp.constant(0)))
        a11 = e2.sub(yr, e2.mul(lam, xr))
        return ((a00, z2, z2), (a10, a11, z2))

    def _pi(self, Q):
        """π on the twist: (x̄·CX, ȳ·CY)."""
        e2 = self.e2
        x, y = Q
        return (e2.mul(e2.conjugate(x), self._c2(_CX)),
                e2.mul(e2.conjugate(y), self._c2(_CY)))

    def _pi2(self, Q):
        e2 = self.e2
        x, y = Q
        return (e2.mul(x, self._c2(_CX2)), e2.mul(y, self._c2(_CY2)))

    # -- Fp12 Frobenius via coefficient tables ------------------------------
    def _frob(self, f):
        e2, e6 = self.e2, self.e6
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

    def _frob3(self, f):
        return self._frob(self._frob2(f))

    # -- Miller loop ---------------------------------------------------------
    def miller_loop(self, p_g1, q_g2):
        """f_{6x+2,Q}(P) with the two BN closing lines (≙ host
        BNPairing.miller_loop — same schedule: the doubling line is the
        tangent at the PRE-doubling R, the addition line's (x₁, y₁) is the
        post-doubling R). p_g1: (x, y) emulated Fp elements; q_g2: (x, y)
        E2 pairs; inputs must be valid curve points."""
        e12, e2 = self.e12, self.e2
        f = e12.one()
        R = q_g2
        t = 6 * X_SEED + 2
        for bit in bin(t)[3:]:
            f = e12.square(f)
            r_old = R
            R, lam = self._twist_double(R)
            f = e12.mul(f, self._line(lam, r_old, p_g1))
            if bit == "1":
                r_old = R
                R, lam2 = self._twist_add(R, q_g2)
                f = e12.mul(f, self._line(lam2, r_old, p_g1))
        # closing Frobenius lines: Q1 = π(Q), nQ2 = −π²(Q)
        q1 = self._pi(q_g2)
        p2x, p2y = self._pi2(q_g2)
        nq2 = (p2x, e2.neg(p2y))
        r_old = R
        R, lam = self._twist_add(R, q1)
        f = e12.mul(f, self._line(lam, r_old, p_g1))
        r_old = R
        _, lam2 = self._twist_add(R, nq2)
        f = e12.mul(f, self._line(lam2, r_old, p_g1))
        return f

    # -- final exponentiation ------------------------------------------------
    def _cyc_pow(self, f, e: int):
        """f^e for f in the cyclotomic subgroup (negative e via conjugate)."""
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
        # hard part: frob³(f2) · frob²(f2^λ2) · frob(f2^λ1) · f2^λ0
        a = self._frob3(f2)
        b = self._frob2(self._cyc_pow(f2, _L2))
        c = self._frob(self._cyc_pow(f2, _L1))
        d = self._cyc_pow(f2, _L0)
        return e12.mul(e12.mul(a, b), e12.mul(c, d))

    def pair(self, p_g1, q_g2):
        return self.final_exponentiation(self.miller_loop(p_g1, q_g2))

    def assert_pairing_check(self, pairs):
        """Constrain ∏ e(Pᵢ, Qᵢ) == 1 (the Groth16/KZG verification shape)."""
        e12 = self.e12
        f = e12.one()
        for p1, q2 in pairs:
            f = e12.mul(f, self.miller_loop(p1, q2))
        res = self.final_exponentiation(f)
        e12.assert_equal(res, e12.one())

    def gt_constant(self, v):
        """Host Fp12 → gadget constant (e.g. the precomputed e(α, β))."""
        def c6(h6):
            return tuple(self._c2(c) for c in (h6.b0, h6.b1, h6.b2))

        return (c6(v.a0), c6(v.a1))

    def assert_pairing_equal(self, pairs, gt_const):
        """Constrain ∏ e(Pᵢ, Qᵢ) == gt_const (host Fp12) — the Groth16
        verification equation shape with the precomputed e(α, β) on the
        right-hand side."""
        e12 = self.e12
        f = e12.one()
        for p1, q2 in pairs:
            f = e12.mul(f, self.miller_loop(p1, q2))
        res = self.final_exponentiation(f)
        e12.assert_equal(res, self.gt_constant(gt_const))
