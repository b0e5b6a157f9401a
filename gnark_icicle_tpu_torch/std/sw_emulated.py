"""In-circuit short-Weierstrass curve arithmetic over emulated fields.

Role parity: reference std/algebra/emulated/sw_emulated (point.go — generic
Curve[Base, Scalar] with AddUnified Brier-Joye complete addition (:240),
incomplete add (:190)/double (:297)/triple (:335), fused doubleAndAddSelect
(:426), and the right-to-left Joye double-add ladder scalarMulJoye (:748)
that tolerates incomplete formulas). Backs in-circuit ECDSA (std/ecdsa.py)
exactly as sw_emulated backs std/signature/ecdsa in the reference.

The (0,0) affine pair conventionally encodes the infinity point (the curve
has no point with x=y=0 when b ≠ 0), matching the reference's EVM-style
convention.

Copied from gnark_icicle_tpu/std/sw_emulated.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_emulated.py holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass

from .emulated import (
    EmulatedField, EmulatedParams, Element,
    SECP256K1_FP, SECP256K1_FR, P256_FP, P256_FR, BN254_FP, BN254_FR,
)


@dataclass(frozen=True)
class SWCurveParams:
    """≙ sw_emulated.CurveParams (curve.go): y² = x³ + a·x + b."""

    name: str
    fp: EmulatedParams
    fr: EmulatedParams
    a: int
    b: int
    gx: int
    gy: int


SECP256K1 = SWCurveParams(
    "secp256k1", SECP256K1_FP, SECP256K1_FR, 0, 7,
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)
P256 = SWCurveParams(
    "p256", P256_FP, P256_FR,
    -3,
    0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
)
# BN254 G1 emulated inside another field (≙ sw_bn254) — also the cheap
# compile-path test vehicle since its group structure matches curves/bn254
BN254G1 = SWCurveParams("bn254.g1", BN254_FP, BN254_FR, 0, 3, 1, 2)


def _bls12381_g1() -> SWCurveParams:
    """≙ sw_emulated.GetBLS12381Params (curve.go) — G1 over emulated
    BLS12-381 Fp; generator from curves/bls12_381.py:30."""
    from .emulated import BLS12381_FP, BLS12381_FR
    from ..curves import bls12_381 as c

    return SWCurveParams("bls12-381.g1", BLS12381_FP, BLS12381_FR, 0, 4,
                         c.G1_GEN[0], c.G1_GEN[1])


def _bls12377_g1() -> SWCurveParams:
    """≙ sw_emulated.GetBLS12377Params — G1 over emulated BLS12-377 Fp
    (the 2-chain inner curve seen from a non-BW6 outer field)."""
    from .emulated import BLS12377_FP, BLS12377_FR
    from ..curves import bls12_377 as c

    return SWCurveParams("bls12-377.g1", BLS12377_FP, BLS12377_FR, 0, 1,
                         c.G1_GEN[0], c.G1_GEN[1])


def _bw6761_g1() -> SWCurveParams:
    """≙ sw_emulated.GetBW6761Params (curve.go) — G1 over emulated
    BW6-761 Fp (b = −1, curves/bw6_761.py:54)."""
    from .emulated import BW6761_FP, BW6761_FR
    from ..curves import bw6_761 as c

    return SWCurveParams("bw6-761.g1", BW6761_FP, BW6761_FR, 0,
                         c.P - 1, c.G1_GEN[0], c.G1_GEN[1])


def _bw6761_g2() -> SWCurveParams:
    """BW6-761 G2 (the sextic twist y² = x³ + 4 — over Fp itself, since
    the embedding degree is 6; curves/bw6_761.py:55) as an emulated
    short-Weierstrass group: the wrap-curve recursion verifier's G2
    membership ladder runs on plain fp points."""
    from .emulated import BW6761_FP, BW6761_FR
    from ..curves import bw6_761 as c

    return SWCurveParams("bw6-761.g2", BW6761_FP, BW6761_FR, 0, 4,
                         c.G2_GEN[0], c.G2_GEN[1])


BLS12381G1 = _bls12381_g1()
BLS12377G1 = _bls12377_g1()
BW6761G1 = _bw6761_g1()
BW6761G2 = _bw6761_g2()


class AffinePoint:
    __slots__ = ("x", "y")

    def __init__(self, x: Element, y: Element):
        self.x = x
        self.y = y


class EmulatedCurve:
    """≙ sw_emulated.Curve[B, S] (point.go:40-82)."""

    def __init__(self, api, params: SWCurveParams, native_modulus: int):
        self.api = api
        self.params = params
        self.fp = EmulatedField(api, params.fp, native_modulus)
        self.fr = EmulatedField(api, params.fr, native_modulus)
        self._a = self.fp.constant(params.a)
        self.add_a = params.a % params.fp.modulus != 0

    # -- constructors -------------------------------------------------------
    def generator(self) -> AffinePoint:
        return self.constant_point((self.params.gx, self.params.gy))

    def constant_point(self, xy) -> AffinePoint:
        return AffinePoint(self.fp.constant(xy[0]), self.fp.constant(xy[1]))

    def witness_point(self, x_limbs, y_limbs) -> AffinePoint:
        return AffinePoint(
            self.fp.from_limbs(x_limbs), self.fp.from_limbs(y_limbs)
        )

    def infinity(self) -> AffinePoint:
        return AffinePoint(self.fp.constant(0), self.fp.constant(0))

    # -- predicates / plumbing ---------------------------------------------
    def neg(self, p: AffinePoint) -> AffinePoint:
        return AffinePoint(p.x, self.fp.neg(p.y))

    def select(self, cond, p: AffinePoint, q: AffinePoint) -> AffinePoint:
        return AffinePoint(
            self.fp.select(cond, p.x, q.x), self.fp.select(cond, p.y, q.y)
        )

    def is_infinity(self, p: AffinePoint):
        return self.api.and_(self.fp.is_zero(p.x), self.fp.is_zero(p.y))

    def assert_is_equal(self, p: AffinePoint, q: AffinePoint):
        self.fp.assert_equal(p.x, q.x)
        self.fp.assert_equal(p.y, q.y)

    def assert_on_curve(self, p: AffinePoint):
        """(x, y) ∈ {y² == x³ + a·x + b} ∪ {(0, 0)} — the conventional
        infinity encoding is accepted by selecting b=0 for it, exactly as
        the reference does (≙ AssertIsOnCurve, point.go:213-228)."""
        fp = self.fp
        is_inf = self.is_infinity(p)
        b = fp.select(is_inf, fp.constant(0), fp.constant(self.params.b))
        y2 = fp.mul(p.y, p.y)
        x3 = fp.mul(fp.mul(p.x, p.x), p.x)
        rhs = fp.add(x3, b)
        if self.add_a:
            rhs = fp.add(rhs, fp.mul(self._a, p.x))
        fp.assert_equal(y2, rhs)

    # -- group law ----------------------------------------------------------
    def add(self, p: AffinePoint, q: AffinePoint) -> AffinePoint:
        """Incomplete affine add: requires p.x ≠ q.x (≙ add, point.go:190)."""
        fp = self.fp
        lam = fp.div(fp.sub(q.y, p.y), fp.sub(q.x, p.x))
        xr = fp.sub(fp.mul(lam, lam), fp.add(p.x, q.x))
        yr = fp.sub(fp.mul(lam, fp.sub(p.x, xr)), p.y)
        return AffinePoint(xr, yr)

    def double(self, p: AffinePoint) -> AffinePoint:
        """Affine double: requires p.y ≠ 0 (≙ double, point.go:297)."""
        fp = self.fp
        num = fp.mul_small(fp.mul(p.x, p.x), 3)
        if self.add_a:
            num = fp.add(num, self._a)
        lam = fp.div(num, fp.mul_small(p.y, 2))
        xr = fp.sub(fp.mul(lam, lam), fp.mul_small(p.x, 2))
        yr = fp.sub(fp.mul(lam, fp.sub(p.x, xr)), p.y)
        return AffinePoint(xr, yr)

    def add_unified(self, p: AffinePoint, q: AffinePoint) -> AffinePoint:
        """Brier-Joye unified add handling p == q and (0,0) operands; only
        p == −q (y₁+y₂ = 0) maps to infinity (≙ AddUnified, point.go:240)."""
        api, fp = self.api, self.fp
        sel_p0 = self.is_infinity(p)
        sel_q0 = self.is_infinity(q)
        # λ = ((x₁+x₂)² − x₁x₂ + a)/(y₁+y₂)
        pxqx = fp.mul(p.x, q.x)
        x_sum = fp.add(p.x, q.x)
        num = fp.sub(fp.mul(x_sum, x_sum), pxqx)
        if self.add_a:
            num = fp.add(num, self._a)
        den = fp.add(p.y, q.y)
        sel_opp = fp.is_zero(den)
        den = fp.select(sel_opp, fp.constant(1), den)
        lam = fp.div(num, den)
        xr = fp.sub(fp.mul(lam, lam), x_sum)
        yr = fp.sub(fp.mul(lam, fp.sub(p.x, xr)), p.y)
        res = AffinePoint(xr, yr)
        res = self.select(sel_p0, q, res)
        res = self.select(sel_q0, p, res)
        # (0,0) when y₁+y₂ = 0 and neither operand was the infinity encoding
        # (sel_opp also fires on (0,0) + (x,0) operands; mask it out)
        neither_zero = api.and_(api.sub(1, sel_p0), api.sub(1, sel_q0))
        truly_opp = api.and_(sel_opp, neither_zero)
        return self.select(truly_opp, self.infinity(), res)

    def double_and_add_select(self, bit, p: AffinePoint,
                              q: AffinePoint) -> AffinePoint:
        """2p+q if bit else 2q+p, saving the intermediate y (≙
        doubleAndAddSelect, point.go:426, after [ELM03] §3.1)."""
        fp = self.fp
        lam1 = fp.div(fp.sub(q.y, p.y), fp.sub(q.x, p.x))
        x2 = fp.sub(fp.mul(lam1, lam1), fp.add(p.x, q.x))
        t = self.select(bit, p, q)
        lam2 = fp.add(
            lam1, fp.div(fp.mul_small(t.y, 2), fp.sub(x2, t.x))
        )
        x3 = fp.sub(fp.mul(lam2, lam2), fp.add(t.x, x2))
        y3 = fp.sub(fp.mul(lam2, fp.sub(x3, t.x)), t.y)
        return AffinePoint(x3, y3)

    def triple(self, p: AffinePoint) -> AffinePoint:
        """3p via shared-slope trick (≙ triple, point.go:335)."""
        fp = self.fp
        num = fp.mul_small(fp.mul(p.x, p.x), 3)
        if self.add_a:
            num = fp.add(num, self._a)
        lam1 = fp.div(num, fp.mul_small(p.y, 2))
        x2 = fp.sub(fp.mul(lam1, lam1), fp.mul_small(p.x, 2))
        lam2 = fp.sub(
            fp.div(fp.mul_small(p.y, 2), fp.sub(p.x, x2)), lam1
        )
        x3 = fp.sub(fp.mul(lam2, lam2), fp.add(p.x, x2))
        y3 = fp.sub(fp.mul(lam2, fp.sub(p.x, x3)), p.y)
        return AffinePoint(x3, y3)

    # -- scalar multiplication ---------------------------------------------
    def scalar_mul(self, p: AffinePoint, s: Element,
                   n_bits: int | None = None) -> AffinePoint:
        """[s]·p by the right-to-left Joye double-add ladder
        (≙ scalarMulJoye, point.go:748, [Joye07] Alg.1).

        Incomplete formulas inside the ladder; the LSB correction uses the
        unified add so s = 0 / s = 1 stay well-defined. p must not be (0,0).
        """
        fr = self.fr
        bits = fr.bits(s)
        n = n_bits or len(bits)
        assert 2 <= n <= len(bits)

        rb = self.triple(p)
        r0 = self.select(bits[1], rb, p)
        r1 = self.select(bits[1], p, rb)
        for i in range(2, n - 1):
            rb = self.double_and_add_select(bits[i], r0, r1)
            r0 = self.select(bits[i], rb, r0)
            r1 = self.select(bits[i], r1, rb)
        if n >= 3:
            rb = self.double_and_add_select(bits[n - 1], r0, r1)
            r0 = self.select(bits[n - 1], rb, r0)
        # LSB: ladder assumed bit0 = 1; subtract p if it was 0
        r0 = self.select(bits[0], r0, self.add_unified(r0, self.neg(p)))
        return r0

    def scalar_mul_base(self, s: Element,
                        n_bits: int | None = None) -> AffinePoint:
        """[s]·G (≙ ScalarMulBase, point.go:1114)."""
        return self.scalar_mul(self.generator(), s, n_bits)

    def joint_scalar_mul_base(self, q: AffinePoint, s_base: Element,
                              s_q: Element) -> AffinePoint:
        """[s_base]·G + [s_q]·q (≙ JointScalarMulBase, point.go:1194 —
        the ECDSA-verify shape)."""
        return self.add_unified(
            self.scalar_mul_base(s_base), self.scalar_mul(q, s_q)
        )
