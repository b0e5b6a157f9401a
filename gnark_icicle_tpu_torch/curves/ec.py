"""Host-side elliptic-curve group ops, generic over the coordinate field.

One implementation serves G1 (coords in Fp) and G2 (coords in Fp2) for both
BN254 and BLS12-381 — the role gnark-crypto's per-curve G1Affine/G2Affine play
for the reference's host paths (setup batch scalar-mul, verifier small MSM).
Device-side batched curve kernels live in `gnark_icicle_tpu_torch.ops.ec_t`.

Points are affine tuples ``(x, y)`` with ``None`` as the point at infinity;
Jacobian triples are used internally for scalar multiplication.

Copied from gnark_icicle_tpu/curves/ec.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

from .tower import Fp2, TowerParams


class FpOps:
    """Adapter giving plain-int Fp the generic element interface."""

    def __init__(self, p: int):
        self.p = p

    def zero(self):
        return 0

    def one(self):
        return 1

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        return a * b % self.p

    def neg(self, a):
        return -a % self.p

    def inv(self, a):
        return pow(a, -1, self.p)

    def muli(self, a, k: int):
        return a * k % self.p

    def is_zero(self, a):
        return a % self.p == 0

    def eq(self, a, b):
        return (a - b) % self.p == 0


class Fp2Ops:
    """Adapter for Fp2 coordinates (G2)."""

    def __init__(self, tp: TowerParams):
        self.tp = tp

    def zero(self):
        return Fp2.zero(self.tp)

    def one(self):
        return Fp2.one(self.tp)

    def add(self, a, b):
        return a + b

    def sub(self, a, b):
        return a - b

    def mul(self, a, b):
        return a * b

    def neg(self, a):
        return -a

    def inv(self, a):
        return a.inv()

    def muli(self, a, k: int):
        return a * k

    def is_zero(self, a):
        return a.is_zero()

    def eq(self, a, b):
        return a == b


class ECGroup:
    """Short-Weierstrass y² = x³ + a x + b (a = 0 for all our curves)."""

    def __init__(self, fops, b, generator, order: int, name: str = ""):
        self.f = fops
        self.b = b
        self.generator = generator
        self.order = order
        self.name = name

    # -- predicates --------------------------------------------------------
    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        f = self.f
        x, y = pt
        lhs = f.mul(y, y)
        rhs = f.add(f.mul(f.mul(x, x), x), self.b)
        return f.eq(lhs, rhs)

    def eq(self, p, q) -> bool:
        if p is None or q is None:
            return p is None and q is None
        return self.f.eq(p[0], q[0]) and self.f.eq(p[1], q[1])

    def neg(self, p):
        if p is None:
            return None
        return (p[0], self.f.neg(p[1]))

    # -- affine add (slow; fine for tests/small host work) -----------------
    def add(self, p, q):
        f = self.f
        if p is None:
            return q
        if q is None:
            return p
        x1, y1 = p
        x2, y2 = q
        if f.eq(x1, x2):
            if f.eq(y1, f.neg(y2)):
                return None
            # doubling: λ = 3x²/2y
            lam = f.mul(f.muli(f.mul(x1, x1), 3), f.inv(f.muli(y1, 2)))
        else:
            lam = f.mul(f.sub(y2, y1), f.inv(f.sub(x2, x1)))
        x3 = f.sub(f.sub(f.mul(lam, lam), x1), x2)
        y3 = f.sub(f.mul(lam, f.sub(x1, x3)), y1)
        return (x3, y3)

    # -- jacobian scalar mul ------------------------------------------------
    def _jdouble(self, P):
        f = self.f
        X, Y, Z = P
        if f.is_zero(Z):
            return P
        A = f.mul(X, X)
        B = f.mul(Y, Y)
        C = f.mul(B, B)
        D = f.muli(f.sub(f.sub(f.mul(f.add(X, B), f.add(X, B)), A), C), 2)
        E = f.muli(A, 3)
        F = f.mul(E, E)
        X3 = f.sub(F, f.muli(D, 2))
        Y3 = f.sub(f.mul(E, f.sub(D, X3)), f.muli(C, 8))
        Z3 = f.muli(f.mul(Y, Z), 2)
        return (X3, Y3, Z3)

    def _jadd_affine(self, P, q):
        """Jacobian P + affine q (q != inf)."""
        f = self.f
        X1, Y1, Z1 = P
        if f.is_zero(Z1):
            return (q[0], q[1], f.one())
        x2, y2 = q
        Z1Z1 = f.mul(Z1, Z1)
        U2 = f.mul(x2, Z1Z1)
        S2 = f.mul(f.mul(y2, Z1), Z1Z1)
        H = f.sub(U2, X1)
        r = f.sub(S2, Y1)
        if f.is_zero(H):
            if f.is_zero(r):
                return self._jdouble(P)
            return (f.one(), f.one(), f.zero())
        HH = f.mul(H, H)
        HHH = f.mul(H, HH)
        V = f.mul(X1, HH)
        X3 = f.sub(f.sub(f.mul(r, r), HHH), f.muli(V, 2))
        Y3 = f.sub(f.mul(r, f.sub(V, X3)), f.mul(Y1, HHH))
        Z3 = f.mul(Z1, H)
        return (X3, Y3, Z3)

    def _to_affine(self, P):
        f = self.f
        X, Y, Z = P
        if f.is_zero(Z):
            return None
        zi = f.inv(Z)
        zi2 = f.mul(zi, zi)
        return (f.mul(X, zi2), f.mul(Y, f.mul(zi2, zi)))

    def scalar_mul(self, p, k: int):
        if p is None or k % self.order == 0:
            return None
        k %= self.order
        f = self.f
        acc = (f.one(), f.one(), f.zero())
        for bit in bin(k)[2:]:
            acc = self._jdouble(acc)
            if bit == "1":
                acc = self._jadd_affine(acc, p)
        return self._to_affine(acc)

    def in_subgroup(self, pt) -> bool:
        """[order]·P == ∞ (cofactor check; ≙ gnark-crypto IsInSubGroup)."""
        if pt is None:
            return True
        f = self.f
        acc = (f.one(), f.one(), f.zero())
        for bit in bin(self.order)[2:]:
            acc = self._jdouble(acc)
            if bit == "1":
                acc = self._jadd_affine(acc, pt)
        return f.is_zero(acc[2])

    def msm(self, scalars, points):
        """Small host MSM (verifier-sized). Device MSM is ops.msm."""
        acc = None
        for s, pt in zip(scalars, points):
            if pt is None or s % self.order == 0:
                continue
            acc = self.add(acc, self.scalar_mul(pt, s))
        return acc

    def random_point(self, rng) -> tuple:
        """Random group element as k·G (host testing helper)."""
        return self.scalar_mul(self.generator, rng.randrange(1, self.order))
