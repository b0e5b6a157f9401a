"""In-circuit BLS12-377 optimal-ate pairing — the native 2-chain gadget.

Role parity: reference std/algebra/native/sw_bls12377/pairing.go (the
Miller loop and final exponentiation whose base-field arithmetic is the
circuit's NATIVE field when the host curve is BW6-761 — doc.go's 2-chain).
Where the reference hand-writes affine line evaluations over dedicated
fields_bls12377 gadget towers, this reuses the generic tower gadgets
(std/algebra_towers.py E2/E6/E12) over ``NativeField``, so one tower
implementation serves both the emulated (BN254-in-BN254) and native
(BLS12-377-in-BW6-761) recursion paths.

Structure mirrors the validated host oracle (curves/pairing.py BLSPairing,
tested bilinear): the ate loop runs over the POSITIVE seed x (no closing
lines, no conjugation — BLS, not BN), lines are the same sparse Fp12 shape
as the BN254 gadget because both curves are D-twists under the same tower
convention (w² = v, v³ = ξ, untwist ψ(x', y') = (x'·w², y'·w³)).

Final exponentiation: easy part conj·inv then ^(p²+1); hard part via the
Hayashida-Hayasaka-Teruya factorization, EXACT for BLS12-377's seed:
    (p⁴−p²+1)/r = (x−1)·((x−1)/3)·(x+p)·(x²+p²−1) + 1
(3 | x−1; asserted as an integer identity at import, so the gadget result
equals the host oracle's f^hard bit-for-bit, not merely up to 3-torsion).

Copied from gnark_icicle_tpu/std/pairing_bls12_377.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

from .algebra_native import NativeField, Fp1Ops, E2Ops, SWProjective
from .algebra_towers import E2, E6, E12
from ..curves import bls12_377 as b377
from ..curves.tower import Fp2

P = b377.P
R = b377.R
X = b377.X_SEED  # positive seed

# GLV/Frobenius endomorphism constants for the FAST subgroup checks
# (≙ sw_bls12377/pairing2.go AssertIsOnG1:352-369, AssertIsOnG2:394-409).
# φ(x, y) = (ω·x, y) with ω a primitive cube root of unity in Fp acts as
# an eigenvalue λ with λ²+λ+1 ≡ 0 mod r on G1; ψ is the twisted Frobenius
# ψ(x, y) = (conj(x)·c_x, conj(y)·c_y) acting as [p] ≡ [x₀] on G2.
PHI_OMEGA = 0x9B3AF05DD14F6EC619AAF7D34594AABC5ED1347970DEC00452217CC900000008508C00000000001
PSI_CX = PHI_OMEGA + 1  # the OTHER cube root ω² = ω+... (distinct root)
PSI_CY = 0x1680A40796537CAC0C534DB1A79BEB1400398F50AD1DEC1BCE649CF436B0F6299588459BFF27D8E6E76D5ECF1391C63
assert pow(PHI_OMEGA, 3, P) == 1 and PHI_OMEGA != 1
assert (PHI_OMEGA * PHI_OMEGA + PHI_OMEGA + 1) % P == 0


def _host_pow2(a: Fp2, e: int) -> Fp2:
    r = Fp2(b377.TOWER, 1, 0)
    while e:
        if e & 1:
            r = r * a
        a = a * a
        e >>= 1
    return r


_XI = Fp2(b377.TOWER, 0, 1)  # ξ = u
# Frobenius gammas: γ_k = ξ^{k(p−1)/6} (Fp2), γ2_k = ξ^{k(p²−1)/6} (real)
_G1 = [_host_pow2(_XI, (P - 1) * k // 6) for k in range(1, 6)]
_G2 = [_host_pow2(_XI, (P * P - 1) * k // 6) for k in range(1, 6)]
assert all(v.c1 == 0 for v in _G2)

# hard-part factorization (exact — see module docstring)
_HARD = (P**4 - P**2 + 1) // R
assert (X - 1) % 3 == 0
assert (X - 1) * ((X - 1) // 3) * (X + P) * (X * X + P * P - 1) + 1 == _HARD

# twist constant: E' : y² = x³ + 1/u, so b3' = 3/u = −(3/5)·u
_B3_TWIST = Fp2(b377.TOWER, 0, (-3 * pow(5, -1, P)) % P)


def bls12_377_towers(fp):
    """(e2, e6, e12) over any field-ops object for the BLS12-377 tower."""
    e2 = E2(fp, beta=-5, xi=(0, 1))
    e6 = E6(e2)
    return e2, e6, E12(e6)


class BLS12377Pairing:
    """Pairing gadget over the NATIVE field (≙ sw_bls12377.Pairing).

    ``api`` is the circuit builder or Engine; its field must be BW6-761's
    scalar field == BLS12-377's base field (asserted)."""

    def __init__(self, api, native_modulus: int = None):
        self.api = api
        q = native_modulus if native_modulus is not None else P
        assert q == P, "native BLS12-377 gadgets need a BW6-761 circuit"
        self.fp = NativeField(api, P)
        self.e2, self.e6, self.e12 = bls12_377_towers(self.fp)
        # curve gadgets for callers (verifier kSum, on-curve checks)
        self.g1 = SWProjective(Fp1Ops(self.fp), self.fp.constant(3))
        self.g2 = SWProjective(E2Ops(self.e2),
                               self.e2.constant(_B3_TWIST.c0, _B3_TWIST.c1))

    # -- constants -----------------------------------------------------------
    def _c2(self, v: Fp2):
        return self.e2.constant(v.c0, v.c1)

    def _zero2(self):
        return self.e2.zero()

    # -- twist arithmetic (affine, incomplete — pairing inputs are valid
    #    curve points and the ate loop never hits the exceptional cases
    #    for points of prime order r ∤ loop intermediates) ------------------
    def _twist_double(self, Rp):
        e2 = self.e2
        x, y = Rp
        lam = e2.mul(
            e2.mul(e2.square(x), self._c2(Fp2(b377.TOWER, 3, 0))),
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
        """Sparse ℓ = −y_P + (λ·x_P)·w + (y_R − λ·x_R)·w³ as a full Fp12
        element — identical shape to the BN254 D-twist gadget
        (std/pairing_bn254.py:_line), untwist-verified there."""
        e2 = self.e2
        xr, yr = Rp
        xp, yp = p_g1  # native Fp variables
        z2 = self._zero2()
        a00 = (self.fp.neg(yp), self.fp.constant(0))
        a10 = e2.mul(lam, (xp, self.fp.constant(0)))
        a11 = e2.sub(yr, e2.mul(lam, xr))
        return ((a00, z2, z2), (a10, a11, z2))

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
        """f_{x,Q}(P) — BLS schedule over the positive seed (≙ host
        BLSPairing.miller_loop; no closing lines). p_g1: (x, y) native
        variables; q_g2: (x, y) E2 pairs; inputs must be valid points."""
        e12 = self.e12
        f = e12.one()
        Rp = q_g2
        for bit in bin(X)[3:]:
            f = e12.square(f)
            r_old = Rp
            Rp, lam = self._twist_double(Rp)
            f = e12.mul(f, self._line(lam, r_old, p_g1))
            if bit == "1":
                r_old = Rp
                Rp, lam2 = self._twist_add(Rp, q_g2)
                f = e12.mul(f, self._line(lam2, r_old, p_g1))
        return f

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
        """Constrain ∏ e(Pᵢ, Qᵢ) == 1."""
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
        """Constrain ∏ e(Pᵢ, Qᵢ) == gt_const (host Fp12) — the Groth16
        verification equation with precomputed e(α, β) on the right."""
        e12 = self.e12
        f = e12.one()
        for p1, q2 in pairs:
            f = e12.mul(f, self.miller_loop(p1, q2))
        e12.assert_equal(self.final_exponentiation(f),
                         self.gt_constant(gt_const))

    # -- fast subgroup membership (Scott's eigenvalue tests) -----------------
    def assert_g1_member(self, xy):
        """On-curve + subgroup via P == −[x₀²]φ(P), φ(x,y) = (ω·x, y)
        (≙ sw_bls12377/pairing2.go AssertIsOnG1:352-369; ~2× fewer
        constraints than the full-order [r]P == O ladder: two 64-bit
        seed ladders instead of one 253-bit one).

        Sound for any affine (x, y): the on-curve check pins P to
        E(Fp) (the identity is not representable affinely for b = 1),
        and on E(Fp) the eigenvalue identity holds exactly on the
        order-r subgroup. The projective comparison equations reject
        Z = 0 outputs (the identity (0, λ≠0, 0) fails Y_S == −y·Z_S)."""
        fp, g1 = self.fp, self.g1
        g1.assert_on_curve_affine(xy, fp.constant(1))
        phi = (fp.mul(xy[0], fp.constant(PHI_OMEGA)), xy[1])
        s = g1.scalar_mul_const(g1.from_affine(phi), X)
        s = g1.scalar_mul_const(s, X)
        # S == −P projectively: X_S == x·Z_S ∧ Y_S == −y·Z_S
        fp.assert_equal(s[0], fp.mul(xy[0], s[2]))
        fp.assert_equal(s[1], fp.neg(fp.mul(xy[1], s[2])))

    def assert_g2_member(self, q_pt):
        """On-twist + subgroup via ψ(Q) == [x₀]Q, ψ(x,y) =
        (conj(x)·c_x, conj(y)·c_y) (≙ pairing2.go AssertIsOnG2:394-409;
        ~4× fewer constraints than the 253-bit twist ladder)."""
        e2, g2, fp = self.e2, self.g2, self.fp
        x, y = q_pt
        # on-twist: y² == x³ + b'
        lhs = e2.square(y)
        rhs = e2.add(e2.mul(e2.square(x), x),
                     self._c2(b377.G2_B))
        e2.assert_equal(lhs, rhs)
        cx, cy = fp.constant(PSI_CX), fp.constant(PSI_CY)
        xc, yc = e2.conjugate(x), e2.conjugate(y)
        psi_x = (fp.mul(xc[0], cx), fp.mul(xc[1], cx))
        psi_y = (fp.mul(yc[0], cy), fp.mul(yc[1], cy))
        s = g2.scalar_mul_const(g2.from_affine(q_pt), X)
        # ψ(Q) == S projectively (identity (0, 1, 0) fails the Y row)
        e2.assert_equal(s[0], e2.mul(psi_x, s[2]))
        e2.assert_equal(s[1], e2.mul(psi_y, s[2]))
