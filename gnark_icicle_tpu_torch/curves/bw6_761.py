"""BW6-761 parameters — the outer curve of the native 2-chain.

Parity target: gnark's bw6-761 backend (the host curve for
std/algebra/native/sw_bls12377 recursion: BW6-761's scalar field IS
BLS12-377's base field, so the inner curve's coordinate arithmetic is
native inside a BW6-761 circuit — reference std/algebra/native/doc.go,
std/recursion/groth16 2-chain path).

Constants derived + verified offline by tools/derive_2chain.py:
- p documented in the reference (std/math/emulated/emparams/emparams.go:236),
  primality checked; r = p_BLS377 (the 2-chain property).
- Curve orders for y²=x³−1 (G1) and y²=x³+4 (G2, the sextic twist — both
  over Fp since the embedding degree is 6) found via Cornacchia's algorithm
  on 4p = t²+3y² and verified by killing random points; both divisible by r.
- γ = −4 verified to be a sextic non-residue, so Fp6 = Fp[w]/(w⁶+4) and the
  M-twist map ψ(x,y) = (x/w², y/w³) carries y²=x³+4 onto y²=x³−1 over Fp6.
- Generators derived (smallest-x lift, cofactor-cleared, order-r checked).
  gnark-crypto's canonical generators are not available offline; any
  order-r generator yields an equivalent self-consistent instantiation.

Embedding degree 6 ⇒ GT ⊂ Fp6*; the host pairing below is the Tate pairing
f_{r,P}(ψ(Q))^((p⁶−1)/r) — slower than gnark-crypto's optimal-ate but a
host-oracle role only (≙ gnark-crypto bw6-761/pairing.go's role).

Copied from gnark_icicle_tpu/curves/bw6_761.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from .field import PrimeField
from .ec import ECGroup, FpOps

P = 6891450384315732539396789682275657542479668912536150109513790160209623422243491736087683183289411687640864567753786613451161759120554247759349511699125301598951605099378508850372543631423596795951899700429969112842764913119068299
R = 258664426012969094010652733694893533536393512754914660539884262666720468348340822774968888139573360124440321458177

# Fr(BW6-761) == Fp(BLS12-377): the 2-chain property
FP = PrimeField("bw6-761.fp", P, two_adicity=1, multiplicative_generator=2)
FR = PrimeField("bw6-761.fr", R, two_adicity=46, multiplicative_generator=15)

GAMMA = (-4) % P  # sextic non-residue: Fp6 = Fp[w]/(w⁶ − γ)

_fp = FpOps(P)

# generators derived by tools/derive_2chain.py (order r, cofactor-cleared)
G1_GEN = (
    5121082781502305659180673370797932802982723165543122975335209418297923345190975559367024470794567213188867624617939698818627134048004915564891369096213721202693630090148097888923493708182442885908076346607300083583163982163789167,
    3936891438836912583780051937508657570812555345221986954460153541952284123191322673907692687918062549220672207508016306900511821136915723707181225276750353973961376292016478674329987421847947883311993206004548631860683957877121757,
)
G2_GEN = (
    4299495046121976197967899669570453663523609133273326781652351086315825538613647196868186765217397067654540962955975840176693419657193486845273767814170238104346390446211356851381676719718477415944688400098442139983341339355564981,
    5390068907621955088169558704058566111636841949933812064258391788701969884935470780815806205108266591280868872340793447961301446566465351736303970166703756567269434202182284388197563290670801062112376259336491499915806321277334517,
)

G1 = ECGroup(_fp, (-1) % P, G1_GEN, R, name="bw6-761.g1")
G2 = ECGroup(_fp, 4, G2_GEN, R, name="bw6-761.g2")


# ---------------------------------------------------------------------------
# Fp6 = Fp[w]/(w⁶ − γ): direct sextic extension for the pairing target
# ---------------------------------------------------------------------------
class Fp6D:
    """Direct degree-6 extension element: c[0] + c[1]·w + … + c[5]·w⁵."""

    __slots__ = ("c",)

    def __init__(self, c):
        self.c = tuple(v % P for v in c)

    @staticmethod
    def from_int(v: int) -> "Fp6D":
        return Fp6D((v, 0, 0, 0, 0, 0))

    @staticmethod
    def one() -> "Fp6D":
        return Fp6D((1, 0, 0, 0, 0, 0))

    def __eq__(self, o) -> bool:
        return self.c == o.c

    def __add__(self, o):
        return Fp6D(tuple(a + b for a, b in zip(self.c, o.c)))

    def __sub__(self, o):
        return Fp6D(tuple(a - b for a, b in zip(self.c, o.c)))

    def __neg__(self):
        return Fp6D(tuple(-a for a in self.c))

    def scale(self, k: int):
        return Fp6D(tuple(a * k for a in self.c))

    def __mul__(self, o):
        a, b = self.c, o.c
        t = [0] * 11
        for i in range(6):
            ai = a[i]
            if ai:
                for j in range(6):
                    t[i + j] += ai * b[j]
        out = list(t[:6])
        for i in range(6, 11):
            out[i - 6] += t[i] * GAMMA
        return Fp6D(out)

    def square(self):
        return self * self

    def pow(self, e: int) -> "Fp6D":
        r = Fp6D.one()
        b = self
        while e:
            if e & 1:
                r = r * b
            b = b * b
            e >>= 1
        return r

    def inv(self) -> "Fp6D":
        """Polynomial extended-Euclid modulo w⁶ − γ."""
        # work over Fp[x]; a(x)·s(x) ≡ 1 (mod x⁶ − γ)
        mod = [(-GAMMA) % P, 0, 0, 0, 0, 0, 1]
        a = list(self.c)
        r0, r1 = mod, a + [0]
        s0, s1 = [0], [1]

        def deg(f):
            d = len(f) - 1
            while d >= 0 and f[d] % P == 0:
                d -= 1
            return d

        def polymod_step(num, den):
            # one full division: returns (quotient, remainder)
            num = [v % P for v in num]
            den = [v % P for v in den]
            dd = deg(den)
            inv_lead = pow(den[dd], -1, P)
            q = [0] * (max(deg(num) - dd + 1, 1))
            while deg(num) >= dd:
                dn = deg(num)
                coef = num[dn] * inv_lead % P
                q[dn - dd] = coef
                for i in range(dd + 1):
                    num[dn - dd + i] = (num[dn - dd + i] - coef * den[i]) % P
            return q, num

        while deg(r1) > 0:
            q, rem = polymod_step(r0, r1)
            r0, r1 = r1, rem
            # s_new = s0 - q*s1
            qs = [0] * (len(q) + len(s1))
            for i, qi in enumerate(q):
                if qi:
                    for j, sj in enumerate(s1):
                        qs[i + j] = (qs[i + j] + qi * sj) % P
            s_new = [
                ((s0[i] if i < len(s0) else 0) - (qs[i] if i < len(qs) else 0))
                % P
                for i in range(max(len(s0), len(qs)))
            ]
            s0, s1 = s1, s_new
        d = deg(r1)
        assert d == 0, "element not invertible"
        inv_c = pow(r1[0], -1, P)
        out = [(v * inv_c) % P for v in s1[:6]]
        out += [0] * (6 - len(out))
        return Fp6D(out)


def _untwist(q):
    """ψ: E'(Fp) → E(Fp6) for the M-twist (b' = b·γ): (x, y) ↦ (x/w², y/w³).
    1/w² = w⁴/γ and 1/w³ = w³/γ."""
    x, y = q
    ginv = pow(GAMMA, -1, P)
    xq = Fp6D((0, 0, 0, 0, x * ginv % P, 0))          # x·w⁴/γ
    yq = Fp6D((0, 0, 0, y * ginv % P, 0, 0))          # y·w³/γ
    return xq, yq


class BW6Pairing:
    """Tate pairing e: G1 × G2 → GT ⊂ Fp6* (host oracle).

    e(P, Q) = f_{r,P}(ψ(Q))^((p⁶−1)/r): the Miller loop walks multiples of
    P with Fp-affine arithmetic (lines are Fp-coefficient polynomials
    evaluated at the untwisted Q), one shared final exponentiation.
    ≙ gnark-crypto bw6-761 Pair/PairingCheck's role.
    """

    def __init__(self):
        self.p = P
        self.r = R
        self.final_exp = (P**6 - 1) // R

    def miller_loop(self, p_g1, q_g2) -> Fp6D:
        if p_g1 is None or q_g2 is None:
            return Fp6D.one()
        xq, yq = _untwist(q_g2)
        f = Fp6D.one()
        Rx, Ry = p_g1
        for bit in bin(self.r)[3:]:
            # double step: line through (Rx,Ry) twice, evaluated at Q
            lam = 3 * Rx * Rx * pow(2 * Ry, -1, P) % P
            # l(Q) = λ·(xQ − xR) − (yQ − yR)
            l = (xq - Fp6D.from_int(Rx)).scale(lam) - (
                yq - Fp6D.from_int(Ry)
            )
            f = f * f * l
            x3 = (lam * lam - 2 * Rx) % P
            Ry = (lam * (Rx - x3) - Ry) % P
            Rx = x3
            if bit == "1":
                x1, y1 = p_g1
                if Rx == x1 and (Ry + y1) % P == 0:
                    # vertical line
                    l = xq - Fp6D.from_int(Rx)
                    f = f * l
                    Rx, Ry = None, None  # at infinity; loop must end
                else:
                    lam = (y1 - Ry) * pow(x1 - Rx, -1, P) % P
                    l = (xq - Fp6D.from_int(Rx)).scale(lam) - (
                        yq - Fp6D.from_int(Ry)
                    )
                    f = f * l
                    x3 = (lam * lam - Rx - x1) % P
                    Ry = (lam * (Rx - x3) - Ry) % P
                    Rx = x3
        return f

    def final_exponentiation(self, f: Fp6D) -> Fp6D:
        return f.pow(self.final_exp)

    def pair(self, p_g1, q_g2) -> Fp6D:
        return self.final_exponentiation(self.miller_loop(p_g1, q_g2))

    def multi_pairing(self, g1_points, g2_points) -> Fp6D:
        f = Fp6D.one()
        for p1, q2 in zip(g1_points, g2_points):
            if p1 is None or q2 is None:
                continue
            f = f * self.miller_loop(p1, q2)
        return self.final_exponentiation(f)

    def pairing_check(self, pairs) -> bool:
        return self.multi_pairing(
            [p for p, _ in pairs], [q for _, q in pairs]
        ) == Fp6D.one()


_ENGINE = None


def _engine() -> BW6Pairing:
    global _ENGINE
    if _ENGINE is None:
        _ENGINE = BW6Pairing()
    return _ENGINE


def pairing_bw6_761(p_g1, q_g2) -> Fp6D:
    return _engine().pair(p_g1, q_g2)


def multi_pairing_bw6_761(p_list, q_list) -> Fp6D:
    return _engine().multi_pairing(p_list, q_list)


def pairing_check_bw6_761(pairs) -> bool:
    return _engine().pairing_check(pairs)


@dataclass(frozen=True)
class CurveBW6761:
    name: str = "bw6-761"
    fp: PrimeField = FP
    fr: PrimeField = FR
    g1: ECGroup = dc_field(default_factory=lambda: G1)
    g2: ECGroup = dc_field(default_factory=lambda: G2)

    def pairing(self, pairs):
        return pairing_check_bw6_761(pairs)

    def miller_and_final_exp(self, p_list, q_list):
        return multi_pairing_bw6_761(p_list, q_list)


BW6_761 = CurveBW6761()
