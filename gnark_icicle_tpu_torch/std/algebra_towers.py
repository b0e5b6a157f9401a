"""In-circuit extension-field towers over emulated base fields.

Role parity: reference std/algebra/emulated field towers
(fields_bn254/e2.go, e6.go, e12.go — 8.6k LoC of Fp2/Fp6/Fp12 gadget
arithmetic backing the sw_bn254/sw_bls12381 pairing gadgets). This is the
tower core: add/sub/mul/square/inverse/conjugate/mul-by-nonresidue at each
level, parameterized by the base EmulatedField and the quadratic/cubic
non-residues. The pairing gadget itself (Miller loop + final exponentiation,
Frobenius coefficient tables) is the round-2 layer on top.

Tower shape (BN254): Fp2 = Fp[u]/(u²−β), Fp6 = Fp2[v]/(v³−ξ),
Fp12 = Fp6[w]/(w²−v). Values are structural pairs/triples of Elements.

Copied from gnark_icicle_tpu/std/algebra_towers.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds the native towers (over
``algebra_native.NativeField``, the BLS12-377 pairing gadget's field) to the
original and tests/test_torch_emulated.py ``bn254_towers``, over an emulated
BN254 field.
"""

from __future__ import annotations

from .emulated import EmulatedField, Element, BN254_FP


class E2:
    """Fp2 arithmetic over an EmulatedField (≙ fields_bn254.Ext2)."""

    def __init__(self, fp: EmulatedField, beta: int = -1, xi=(9, 1)):
        self.fp = fp
        self.beta = beta % fp.p    # u² = β (reduced)
        self.beta_signed = beta    # signed form: cheap ±small scaling
        self.xi = xi               # cubic non-residue ξ = xi[0] + xi[1]·u

    def _smul(self, x, c: int):
        """x·c for a small SIGNED int constant."""
        fp = self.fp
        if c == 0:
            return fp.constant(0)
        neg = c < 0
        c = abs(c)
        out = x if c == 1 else (
            fp.mul_small(x, c) if c < 256 else fp.mul(x, fp.constant(c))
        )
        return fp.neg(out) if neg else out

    def zero(self):
        return (self.fp.constant(0), self.fp.constant(0))

    def one(self):
        return (self.fp.constant(1), self.fp.constant(0))

    def constant(self, c0: int, c1: int = 0):
        return (self.fp.constant(c0), self.fp.constant(c1))

    def add(self, a, b):
        return (self.fp.add(a[0], b[0]), self.fp.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.fp.sub(a[0], b[0]), self.fp.sub(a[1], b[1]))

    def neg(self, a):
        return (self.fp.neg(a[0]), self.fp.neg(a[1]))

    def conjugate(self, a):
        return (a[0], self.fp.neg(a[1]))

    def mul(self, a, b):
        """(a0+a1u)(b0+b1u) with u²=β — Karatsuba, 3 base muls."""
        fp = self.fp
        t0 = fp.mul(a[0], b[0])
        t1 = fp.mul(a[1], b[1])
        t2 = fp.mul(fp.add(a[0], a[1]), fp.add(b[0], b[1]))
        c0 = fp.add(t0, self._mul_beta(t1))
        c1 = fp.sub(fp.sub(t2, t0), t1)
        return (c0, c1)

    def _mul_beta(self, x):
        if -256 < self.beta_signed < 256:
            return self._smul(x, self.beta_signed)
        return self.fp.mul(x, self.fp.constant(self.beta))

    def square(self, a):
        """Complex squaring for β=−1: (a0+a1)(a0+βa1... ) — 2 base muls."""
        fp = self.fp
        if self.beta == fp.p - 1:
            t0 = fp.mul(fp.add(a[0], a[1]), fp.sub(a[0], a[1]))
            t1 = fp.mul(a[0], a[1])
            return (t0, fp.add(t1, t1))
        return self.mul(a, a)

    def mul_by_nonresidue(self, a):
        """a·ξ where ξ = xi0 + xi1·u, u² = β — general small-constant
        form: c0 = xi0·a0 + β·xi1·a1, c1 = xi1·a0 + xi0·a1
        (≙ MulByNonResidue; covers BN254/BLS12-381 ξ=9+u, β=−1 and
        BLS12-377 ξ=u, β=−5)."""
        fp = self.fp
        xi0, xi1 = self.xi
        c0 = fp.add(self._smul(a[0], xi0),
                    self._smul(a[1], self.beta_signed * xi1))
        c1 = fp.add(self._smul(a[0], xi1), self._smul(a[1], xi0))
        return (c0, c1)

    def inverse(self, a):
        """1/(a0+a1u) = conj(a)/(a0²−βa1²) (norm trick)."""
        fp = self.fp
        norm = fp.sub(fp.mul(a[0], a[0]),
                      self._mul_beta(fp.mul(a[1], a[1])))
        inv_n = fp.inverse(norm)
        return (fp.mul(a[0], inv_n), fp.neg(fp.mul(a[1], inv_n)))

    def assert_equal(self, a, b):
        self.fp.assert_equal(a[0], b[0])
        self.fp.assert_equal(a[1], b[1])

    def select(self, cond, t, f):
        return (self.fp.select(cond, t[0], f[0]),
                self.fp.select(cond, t[1], f[1]))


class E6:
    """Fp6 = Fp2[v]/(v³−ξ) (≙ fields_bn254.Ext6)."""

    def __init__(self, e2: E2):
        self.e2 = e2

    def zero(self):
        z = self.e2.zero
        return (z(), z(), z())

    def one(self):
        return (self.e2.one(), self.e2.zero(), self.e2.zero())

    def add(self, a, b):
        return tuple(self.e2.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        return tuple(self.e2.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        return tuple(self.e2.neg(x) for x in a)

    def mul(self, a, b):
        """Toom-ish schoolbook with ξ reductions (6 E2 muls Karatsuba)."""
        e2 = self.e2
        t0 = e2.mul(a[0], b[0])
        t1 = e2.mul(a[1], b[1])
        t2 = e2.mul(a[2], b[2])
        # c0 = t0 + ξ((a1+a2)(b1+b2) − t1 − t2)
        s = e2.mul(e2.add(a[1], a[2]), e2.add(b[1], b[2]))
        c0 = e2.add(t0, e2.mul_by_nonresidue(e2.sub(e2.sub(s, t1), t2)))
        # c1 = (a0+a1)(b0+b1) − t0 − t1 + ξ·t2
        s = e2.mul(e2.add(a[0], a[1]), e2.add(b[0], b[1]))
        c1 = e2.add(e2.sub(e2.sub(s, t0), t1), e2.mul_by_nonresidue(t2))
        # c2 = (a0+a2)(b0+b2) − t0 − t2 + t1
        s = e2.mul(e2.add(a[0], a[2]), e2.add(b[0], b[2]))
        c2 = e2.add(e2.sub(e2.sub(s, t0), t2), t1)
        return (c0, c1, c2)

    def square(self, a):
        return self.mul(a, a)

    def mul_by_nonresidue(self, a):
        """a·v: (a0,a1,a2) -> (ξ·a2, a0, a1)."""
        return (self.e2.mul_by_nonresidue(a[2]), a[0], a[1])

    def inverse(self, a):
        """Standard Fp6 inversion (≙ e6.go Inverse)."""
        e2 = self.e2
        t0 = e2.square(a[0])
        t1 = e2.square(a[1])
        t2 = e2.square(a[2])
        t3 = e2.mul(a[0], a[1])
        t4 = e2.mul(a[0], a[2])
        t5 = e2.mul(a[1], a[2])
        c0 = e2.sub(t0, e2.mul_by_nonresidue(t5))
        c1 = e2.sub(e2.mul_by_nonresidue(t2), t3)
        c2 = e2.sub(t1, t4)
        d = e2.add(e2.mul(a[0], c0),
                   e2.mul_by_nonresidue(
                       e2.add(e2.mul(a[2], c1), e2.mul(a[1], c2))))
        d_inv = e2.inverse(d)
        return (e2.mul(c0, d_inv), e2.mul(c1, d_inv), e2.mul(c2, d_inv))

    def assert_equal(self, a, b):
        for x, y in zip(a, b):
            self.e2.assert_equal(x, y)


class E12:
    """Fp12 = Fp6[w]/(w²−v) (≙ fields_bn254.Ext12)."""

    def __init__(self, e6: E6):
        self.e6 = e6

    def one(self):
        return (self.e6.one(), self.e6.zero())

    def add(self, a, b):
        return (self.e6.add(a[0], b[0]), self.e6.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.e6.sub(a[0], b[0]), self.e6.sub(a[1], b[1]))

    def conjugate(self, a):
        """a0 − a1·w (the GT-subgroup inverse)."""
        return (a[0], self.e6.neg(a[1]))

    def mul(self, a, b):
        """Karatsuba over Fp6 with w² = v."""
        e6 = self.e6
        t0 = e6.mul(a[0], b[0])
        t1 = e6.mul(a[1], b[1])
        c0 = e6.add(t0, e6.mul_by_nonresidue(t1))
        s = e6.mul(e6.add(a[0], a[1]), e6.add(b[0], b[1]))
        c1 = e6.sub(e6.sub(s, t0), t1)
        return (c0, c1)

    def square(self, a):
        """Complex squaring over Fp6."""
        e6 = self.e6
        t0 = e6.mul(a[0], a[1])
        s = e6.mul(e6.add(a[0], a[1]),
                   e6.add(a[0], e6.mul_by_nonresidue(a[1])))
        c0 = e6.sub(e6.sub(s, t0), e6.mul_by_nonresidue(t0))
        c1 = e6.add(t0, t0)
        return (c0, c1)

    def inverse(self, a):
        e6 = self.e6
        d = e6.sub(e6.square(a[0]), e6.mul_by_nonresidue(e6.square(a[1])))
        d_inv = e6.inverse(d)
        return (e6.mul(a[0], d_inv), e6.neg(e6.mul(a[1], d_inv)))

    def assert_equal(self, a, b):
        self.e6.assert_equal(a[0], b[0])
        self.e6.assert_equal(a[1], b[1])


def bn254_towers(api, native_modulus: int):
    """(fp, e2, e6, e12) instantiated for the BN254 base field."""
    fp = EmulatedField(api, BN254_FP, native_modulus)
    e2 = E2(fp, beta=-1, xi=(9, 1))
    e6 = E6(e2)
    return fp, e2, e6, E12(e6)
