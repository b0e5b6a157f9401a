"""Optimal ate pairing for BN254 (host, pure Python over the Fp12 tower).

Role parity: gnark-crypto's bn254 pairing as used by the Groth16/PLONK
verifiers (reference: backend/groth16/bn254/verify.go:75-141 MillerLoop +
FinalExponentiation; verification is always host CPU work, SURVEY.md §3.4).
Correctness, not speed, is the goal here: any correct reduced optimal-ate
implementation produces the same GT value as gnark-crypto, so proofs
cross-verify. The affine Miller loop below is the textbook algorithm
(double-and-add over 6x+2 with line evaluations, two Frobenius end steps).

G1 points are affine ``(x, y)`` int tuples; G2 points affine ``(x, y)``
Fp2 tuples; ``None`` is the point at infinity.

Copied from gnark_icicle_tpu/curves/pairing.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

from .tower import Fp2, Fp6, Fp12, TowerParams


def _fp12_from_int(tp: TowerParams, x: int) -> Fp12:
    return Fp12(
        tp,
        Fp6(tp, Fp2(tp, x, 0), Fp2.zero(tp), Fp2.zero(tp)),
        Fp6.zero(tp),
    )


def _w2_w3(tp: TowerParams):
    """The Fp12 elements w² (= v) and w³ (= v·w)."""
    z = Fp2.zero(tp)
    one = Fp2.one(tp)
    w2 = Fp12(tp, Fp6(tp, z, one, z), Fp6.zero(tp))
    w3 = Fp12(tp, Fp6.zero(tp), Fp6(tp, z, one, z))
    return w2, w3


def _untwist(tp: TowerParams, q, m_twist: bool):
    """E'(Fp2) -> E(Fp12).

    D-twist (BN254, y'² = x'³ + b/ξ): ψ(x', y') = (x'·w², y'·w³).
    M-twist (BLS12-381, y'² = x'³ + b·ξ): ψ(x', y') = (x'/w², y'/w³).
    With the tower w² = v, v³ = ξ (so w⁶ = ξ) both land on E/Fp12.
    """
    x2, y2 = q
    z = Fp2.zero(tp)
    x12 = Fp12(tp, Fp6(tp, x2, z, z), Fp6.zero(tp))
    y12 = Fp12(tp, Fp6(tp, y2, z, z), Fp6.zero(tp))
    w2, w3 = _w2_w3(tp)
    if m_twist:
        return (x12 * w2.inv(), y12 * w3.inv())
    return (x12 * w2, y12 * w3)


def _line(tp, p1, p2, t):
    """Evaluate the line through p1, p2 (E(Fp12) affine) at point t.

    Returns the unnormalized line value; vertical lines return x_t - x_1.
    """
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if not (x1 == x2):
        m = (y2 - y1) * (x2 - x1).inv()
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        three = _fp12_from_int(tp, 3)
        two = _fp12_from_int(tp, 2)
        m = three * x1 * x1 * (two * y1).inv()
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def _ec_add12(p, q):
    """Affine addition on E(Fp12) (b irrelevant: inputs are on the curve)."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 == y2:
            return _ec_double12(p)
        return None
    m = (y2 - y1) * (x2 - x1).inv()
    x3 = m * m - x1 - x2
    y3 = m * (x1 - x3) - y1
    return (x3, y3)


def _ec_double12(p):
    x1, y1 = p
    tp = x1.tp
    three = _fp12_from_int(tp, 3)
    two = _fp12_from_int(tp, 2)
    m = three * x1 * x1 * (two * y1).inv()
    x3 = m * m - two * x1
    y3 = m * (x1 - x3) - y1
    return (x3, y3)


# tower.py's Fp12 carries only the ops the final-exponentiation path needed;
# the Miller loop needs full ring ops — add them here once on import.
def _ensure_fp12_ring_ops():
    if not hasattr(Fp12, "__sub__"):
        Fp12.__sub__ = lambda a, b: Fp12(a.tp, a.a0 - b.a0, a.a1 - b.a1)
    if not hasattr(Fp12, "__add__"):
        Fp12.__add__ = lambda a, b: Fp12(a.tp, a.a0 + b.a0, a.a1 + b.a1)
    if not hasattr(Fp12, "__neg__"):
        Fp12.__neg__ = lambda a: Fp12(a.tp, -a.a0, -a.a1)


_ensure_fp12_ring_ops()


class BNPairing:
    """Optimal ate pairing e: G1 × G2 -> GT for a BN curve."""

    def __init__(self, tp: TowerParams, p: int, r: int, x_seed: int):
        self.tp = tp
        self.p = p
        self.r = r
        self.x = x_seed
        self.loop_count = 6 * x_seed + 2
        self.final_exp = (p**12 - 1) // r

    def _frob_point(self, q12, power: int):
        """(x, y) -> (x^(p^k), y^(p^k)) on E(Fp12) via Fp12 pow."""
        x, y = q12
        e = self.p**power
        return (x.pow(e), y.pow(e))

    def miller_loop(self, p_g1, q_g2) -> Fp12:
        """Unreduced Miller loop f_{6x+2,Q}(P) · line terms (BN two-step)."""
        tp = self.tp
        if p_g1 is None or q_g2 is None:
            return Fp12.one(tp)
        P = (_fp12_from_int(tp, p_g1[0]), _fp12_from_int(tp, p_g1[1]))
        Q = _untwist(tp, q_g2, m_twist=False)
        f = Fp12.one(tp)
        R = Q
        t = self.loop_count
        assert t > 0
        for bit in bin(t)[3:]:  # MSB-1 downwards
            f = f * f * _line(tp, R, R, P)
            R = _ec_double12(R)
            if bit == "1":
                f = f * _line(tp, R, Q, P)
                R = _ec_add12(R, Q)
        # BN final two Frobenius steps: Q1 = π(Q), Q2 = -π²(Q)
        Q1 = self._frob_point(Q, 1)
        nQ2 = self._frob_point(Q, 2)
        nQ2 = (nQ2[0], -nQ2[1])
        f = f * _line(tp, R, Q1, P)
        R = _ec_add12(R, Q1)
        f = f * _line(tp, R, nQ2, P)
        return f

    def final_exponentiation(self, f: Fp12) -> Fp12:
        """f^((p^12-1)/r); easy part done with cheap conjugate/inv, hard part
        as a plain pow (host oracle path — not performance-critical)."""
        p = self.p
        # easy part: f^(p^6-1) = conj(f) * f^-1 ; then ^(p^2+1)
        f1 = f.conjugate() * f.inv()
        f2 = f1.pow(p * p) * f1
        # hard part: (p^4 - p^2 + 1)/r
        hard = (p**4 - p**2 + 1) // self.r
        return f2.pow(hard)

    def pair(self, p_g1, q_g2) -> Fp12:
        return self.final_exponentiation(self.miller_loop(p_g1, q_g2))

    def multi_pairing(self, g1_points, g2_points) -> Fp12:
        """∏ e(P_i, Q_i): product of Miller loops, one final exponentiation
        (the shape the Groth16 verifier uses, verify.go:75-141)."""
        f = Fp12.one(self.tp)
        for p1, q2 in zip(g1_points, g2_points):
            if p1 is None or q2 is None:
                continue
            f = f * self.miller_loop(p1, q2)
        return self.final_exponentiation(f)

    def pairing_check(self, pairs) -> bool:
        """∏ e(P_i, Q_i) == 1 — the form verification equations reduce to."""
        return self.multi_pairing(
            [p for p, _ in pairs], [q for _, q in pairs]
        ) == Fp12.one(self.tp)


class BLSPairing(BNPairing):
    """Optimal ate pairing for a BLS12 curve (loop count |x|, conjugation
    for a negative seed; no BN Frobenius end steps). Twist type is
    per-curve: BLS12-381 is an M-twist, BLS12-377 a D-twist."""

    def __init__(self, tp: TowerParams, p: int, r: int, x_seed: int,
                 m_twist: bool = True):
        super().__init__(tp, p, r, abs(x_seed))
        self.loop_count = abs(x_seed)
        self.x_negative = x_seed < 0
        self.m_twist = m_twist

    def miller_loop(self, p_g1, q_g2) -> Fp12:
        tp = self.tp
        if p_g1 is None or q_g2 is None:
            return Fp12.one(tp)
        P = (_fp12_from_int(tp, p_g1[0]), _fp12_from_int(tp, p_g1[1]))
        Q = _untwist(tp, q_g2, m_twist=self.m_twist)
        f = Fp12.one(tp)
        R = Q
        for bit in bin(self.loop_count)[3:]:
            f = f * f * _line(tp, R, R, P)
            R = _ec_double12(R)
            if bit == "1":
                f = f * _line(tp, R, Q, P)
                R = _ec_add12(R, Q)
        if self.x_negative:
            f = f.conjugate()  # f^(p^6) — inversion in the cyclotomic group
        return f


_ENGINES: dict = {}


def _engine() -> BNPairing:
    if "bn254" not in _ENGINES:
        from . import bn254

        _ENGINES["bn254"] = BNPairing(
            bn254.TOWER, bn254.P, bn254.R, bn254.X_SEED
        )
    return _ENGINES["bn254"]


def _engine_bls() -> BLSPairing:
    if "bls12-381" not in _ENGINES:
        from . import bls12_381 as bls

        _ENGINES["bls12-381"] = BLSPairing(
            bls.TOWER, bls.P, bls.R, bls.X_SEED
        )
    return _ENGINES["bls12-381"]


def pairing_bn254(p_g1, q_g2) -> Fp12:
    return _engine().pair(p_g1, q_g2)


def multi_pairing_bn254(p_list, q_list) -> Fp12:
    return _engine().multi_pairing(p_list, q_list)


def pairing_check_bn254(pairs) -> bool:
    return _engine().pairing_check(pairs)


def pairing_bls12_381(p_g1, q_g2) -> Fp12:
    return _engine_bls().pair(p_g1, q_g2)


def multi_pairing_bls12_381(p_list, q_list) -> Fp12:
    return _engine_bls().multi_pairing(p_list, q_list)


def _engine_bls377() -> BLSPairing:
    if "bls12-377" not in _ENGINES:
        from . import bls12_377 as b377

        _ENGINES["bls12-377"] = BLSPairing(
            b377.TOWER, b377.P, b377.R, b377.X_SEED, m_twist=False
        )
    return _ENGINES["bls12-377"]


def pairing_bls12_377(p_g1, q_g2) -> Fp12:
    return _engine_bls377().pair(p_g1, q_g2)


def multi_pairing_bls12_377(p_list, q_list) -> Fp12:
    return _engine_bls377().multi_pairing(p_list, q_list)


def pairing_check_bls12_377(pairs) -> bool:
    return _engine_bls377().pairing_check(pairs)


def pairing_check_bls12_381(pairs) -> bool:
    return _engine_bls().pairing_check(pairs)
