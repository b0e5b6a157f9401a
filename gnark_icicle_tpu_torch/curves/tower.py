"""Extension-field towers Fp2 → Fp6 → Fp12 (host, pure Python).

Tower shape shared by BN254 and BLS12-381 (as in gnark-crypto's
internal/fptower): Fp2 = Fp[u]/(u²-β), Fp6 = Fp2[v]/(v³-ξ),
Fp12 = Fp6[w]/(w²-v). Only the verifier-side pairing uses these; they are
deliberately simple, not fast (Verify is milliseconds of host work in the
reference too — backend/groth16/bn254/verify.go is pure CPU).

Copied from gnark_icicle_tpu/curves/tower.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TowerParams:
    p: int
    beta: int  # non-residue for Fp2: u² = beta (both curves use -1)
    xi: tuple  # non-residue for Fp6 as Fp2 element (c0, c1): v³ = xi


class Fp2:
    __slots__ = ("c0", "c1", "tp")

    def __init__(self, tp: TowerParams, c0: int, c1: int):
        self.tp = tp
        self.c0 = c0 % tp.p
        self.c1 = c1 % tp.p

    # -- constructors
    @staticmethod
    def zero(tp):
        return Fp2(tp, 0, 0)

    @staticmethod
    def one(tp):
        return Fp2(tp, 1, 0)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def is_zero(self):
        return self.c0 == 0 and self.c1 == 0

    def __add__(self, o):
        return Fp2(self.tp, self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fp2(self.tp, self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fp2(self.tp, -self.c0, -self.c1)

    def __mul__(self, o):
        p, beta = self.tp.p, self.tp.beta
        if isinstance(o, int):
            return Fp2(self.tp, self.c0 * o, self.c1 * o)
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0 % p
        t1 = a1 * b1 % p
        return Fp2(self.tp, t0 + beta * t1, (a0 + a1) * (b0 + b1) - t0 - t1)

    __rmul__ = __mul__

    def square(self):
        return self * self

    def conjugate(self):
        return Fp2(self.tp, self.c0, -self.c1)

    def inv(self):
        p, beta = self.tp.p, self.tp.beta
        # (c0 - c1 u)(c0 + c1 u) = c0² - beta c1²
        d = (self.c0 * self.c0 - beta * self.c1 * self.c1) % p
        di = pow(d, -1, p)
        return Fp2(self.tp, self.c0 * di, -self.c1 * di)

    def frobenius(self):
        """x^p : conjugation since β is a QR-free non-residue."""
        return self.conjugate()

    def __repr__(self):
        return f"Fp2({self.c0}, {self.c1})"


class Fp6:
    __slots__ = ("b0", "b1", "b2", "tp")

    def __init__(self, tp, b0: Fp2, b1: Fp2, b2: Fp2):
        self.tp, self.b0, self.b1, self.b2 = tp, b0, b1, b2

    @staticmethod
    def zero(tp):
        z = Fp2.zero(tp)
        return Fp6(tp, z, z, z)

    @staticmethod
    def one(tp):
        return Fp6(tp, Fp2.one(tp), Fp2.zero(tp), Fp2.zero(tp))

    def _xi(self):
        return Fp2(self.tp, *self.tp.xi)

    def __eq__(self, o):
        return self.b0 == o.b0 and self.b1 == o.b1 and self.b2 == o.b2

    def __add__(self, o):
        return Fp6(self.tp, self.b0 + o.b0, self.b1 + o.b1, self.b2 + o.b2)

    def __sub__(self, o):
        return Fp6(self.tp, self.b0 - o.b0, self.b1 - o.b1, self.b2 - o.b2)

    def __neg__(self):
        return Fp6(self.tp, -self.b0, -self.b1, -self.b2)

    def __mul__(self, o):
        xi = self._xi()
        a0, a1, a2, b0, b1, b2 = self.b0, self.b1, self.b2, o.b0, o.b1, o.b2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2) * xi + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + xi * t2
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(self.tp, c0, c1, c2)

    def mul_by_fp2(self, s: Fp2):
        return Fp6(self.tp, self.b0 * s, self.b1 * s, self.b2 * s)

    def mul_by_v(self):
        """multiply by v: (b0,b1,b2) -> (xi*b2, b0, b1)."""
        return Fp6(self.tp, self.b2 * self._xi(), self.b0, self.b1)

    def square(self):
        return self * self

    def inv(self):
        xi = self._xi()
        a0, a1, a2 = self.b0, self.b1, self.b2
        t0 = a0.square() - a1 * a2 * xi
        t1 = a2.square() * xi - a0 * a1
        t2 = a1.square() - a0 * a2
        d = (a0 * t0 + (a2 * t1 + a1 * t2) * xi).inv()
        return Fp6(self.tp, t0 * d, t1 * d, t2 * d)


class Fp12:
    __slots__ = ("a0", "a1", "tp")

    def __init__(self, tp, a0: Fp6, a1: Fp6):
        self.tp, self.a0, self.a1 = tp, a0, a1

    @staticmethod
    def one(tp):
        return Fp12(tp, Fp6.one(tp), Fp6.zero(tp))

    def __eq__(self, o):
        return self.a0 == o.a0 and self.a1 == o.a1

    def __mul__(self, o):
        a0, a1, b0, b1 = self.a0, self.a1, o.a0, o.a1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fp12(self.tp, c0, c1)

    def square(self):
        return self * self

    def conjugate(self):
        return Fp12(self.tp, self.a0, -self.a1)

    def inv(self):
        d = (self.a0.square() - self.a1.square().mul_by_v()).inv()
        return Fp12(self.tp, self.a0 * d, -(self.a1 * d))

    def pow(self, e: int):
        if e < 0:
            return self.inv().pow(-e)
        r = Fp12.one(self.tp)
        b = self
        while e:
            if e & 1:
                r = r * b
            b = b.square()
            e >>= 1
        return r

    def frobenius(self, frob_coeffs, power: int = 1):
        """x^(p^power) using precomputed Frobenius coefficients.

        frob_coeffs[power] is a list of 6 Fp2 values gamma_{power,i} (i=1..5)
        multiplying the coefficient of w^i written over Fp2 basis
        (1, w, w², …, w⁵) where w² = v.
        """
        # rewrite self over Fp2 basis of w: a0=(c0,c2,c4) via v=w², a1=(c1,c3,c5)
        cs = [self.a0.b0, self.a1.b0, self.a0.b1, self.a1.b1, self.a0.b2, self.a1.b2]
        out = [c.frobenius() if power % 2 == 1 else c for c in cs]
        g = frob_coeffs[power]
        for i in range(1, 6):
            out[i] = out[i] * g[i - 1]
        return Fp12(
            self.tp,
            Fp6(self.tp, out[0], out[2], out[4]),
            Fp6(self.tp, out[1], out[3], out[5]),
        )
