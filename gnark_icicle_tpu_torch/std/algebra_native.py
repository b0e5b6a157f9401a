"""Native-field algebra gadgets — the 2-chain recursion core.

Role parity: reference std/algebra/native/sw_bls12377 (15.4k LoC — G1/G2
affine gadget arithmetic whose base field IS the circuit's native field,
because BW6-761's scalar field equals BLS12-377's base field; doc.go
explains the 2-chain). This module provides:

- ``NativeField``: the EmulatedField-compatible interface implemented
  directly on circuit variables (one constraint per mul, vs hundreds for
  emulated limbs) — so every tower/pairing gadget written against the
  field-ops protocol (std/algebra_towers.py) runs native unchanged.
- ``SWProjective``: complete-formula short-Weierstrass group ops (a = 0)
  generic over a field-ops object, usable for G1 (base field) and G2
  (quadratic extension via ``E2Ops``). The reference uses affine
  incomplete formulas with case hints (sw_bls12377/g1.go AddAssign);
  complete projective formulas (Renes-Costello-Batina 2015, Algorithms 7
  and 9) are branch-free — the right shape both for circuits (no case
  splits, no hints) and for the engine.

Complete-add costs: 12 mul + 2 mul-by-3b per add, 6 mul + 2 mul-by-3b per
double — all native constraints inside a BW6-761 circuit.

Copied from gnark_icicle_tpu/std/algebra_native.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations


class NativeField:
    """Field-ops over the circuit's NATIVE field (elements are Vars/ints).

    Implements the subset of the EmulatedField interface the tower and
    curve gadgets consume (≙ the role of gnark's frontend.API used
    directly by sw_bls12377 — native arithmetic needs no limb machinery).
    """

    def __init__(self, api, p: int):
        self.api = api
        self.p = p

    def constant(self, v: int):
        return v % self.p

    def add(self, a, b):
        return self.api.add(a, b)

    def sub(self, a, b):
        return self.api.sub(a, b)

    def neg(self, a):
        return self.api.neg(a)

    def mul(self, a, b):
        return self.api.mul(a, b)

    def mul_small(self, a, c: int):
        return self.api.mul(a, c % self.p)

    def square(self, a):
        return self.api.mul(a, a)

    def inverse(self, a):
        return self.api.inverse(a)

    def div(self, a, b):
        return self.api.div(a, b)

    def select(self, cond, t, f):
        return self.api.select(cond, t, f)

    def is_zero(self, a):
        return self.api.is_zero(a)

    def assert_equal(self, a, b):
        self.api.assert_is_equal(a, b)

    def reduce(self, a):
        return a  # native values are always reduced

    def assert_canonical(self, a):
        pass  # native representation is unique by construction


class Fp1Ops:
    """SWProjective field adapter: elements are plain native-field values."""

    def __init__(self, nf: NativeField):
        self.nf = nf

    def add(self, a, b):
        return self.nf.add(a, b)

    def sub(self, a, b):
        return self.nf.sub(a, b)

    def neg(self, a):
        return self.nf.neg(a)

    def mul(self, a, b):
        return self.nf.mul(a, b)

    def select(self, cond, t, f):
        return self.nf.select(cond, t, f)

    def constant(self, v):
        return self.nf.constant(v)

    def assert_equal(self, a, b):
        self.nf.assert_equal(a, b)

    def is_zero_flags(self, a):
        return self.nf.is_zero(a)


class E2Ops:
    """SWProjective field adapter over an E2 tower (elements are pairs)."""

    def __init__(self, e2):
        self.e2 = e2

    def add(self, a, b):
        return self.e2.add(a, b)

    def sub(self, a, b):
        return self.e2.sub(a, b)

    def neg(self, a):
        return self.e2.neg(a)

    def mul(self, a, b):
        return self.e2.mul(a, b)

    def select(self, cond, t, f):
        return self.e2.select(cond, t, f)

    def constant(self, v):
        """Host Fp2 (curves.tower.Fp2) or int -> gadget pair."""
        if hasattr(v, "c0"):
            return self.e2.constant(v.c0, v.c1)
        return self.e2.constant(v, 0)

    def assert_equal(self, a, b):
        self.e2.assert_equal(a, b)

    def is_zero_flags(self, a):
        api = self.e2.fp.api
        return api.and_(self.e2.fp.is_zero(a[0]), self.e2.fp.is_zero(a[1]))


class SWProjective:
    """Complete projective group law for y² = x³ + b (a = 0).

    Points are (X, Y, Z) field-element triples, identity = (0, 1, 0).
    RCB15 Algorithm 7 (add) / 9 (double) — complete on ALL inputs
    including identity and doubling, so scalar-mul needs no case hints
    (contrast: reference sw_bls12377/g1.go incomplete affine adds)."""

    def __init__(self, f, b3):
        self.f = f            # field-ops adapter (Fp1Ops / E2Ops)
        self.b3 = b3          # 3·b as a gadget field element

    def identity(self):
        f = self.f
        return (f.constant(0), f.constant(1), f.constant(0))

    def from_affine(self, xy):
        return (xy[0], xy[1], self.f.constant(1))

    def add(self, P, Q):
        """RCB15 Algorithm 7 (a = 0): 12M + 2·m3b, complete."""
        f = self.f
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        t0 = f.mul(X1, X2)
        t1 = f.mul(Y1, Y2)
        t2 = f.mul(Z1, Z2)
        t3 = f.mul(f.add(X1, Y1), f.add(X2, Y2))
        t3 = f.sub(f.sub(t3, t0), t1)                  # X1Y2 + X2Y1
        t4 = f.mul(f.add(Y1, Z1), f.add(Y2, Z2))
        t4 = f.sub(f.sub(t4, t1), t2)                  # Y1Z2 + Y2Z1
        X3 = f.mul(f.add(X1, Z1), f.add(X2, Z2))
        Y3 = f.sub(f.sub(X3, t0), t2)                  # X1Z2 + X2Z1
        X3 = f.add(f.add(t0, t0), t0)                  # 3·X1X2
        t2 = f.mul(self.b3, t2)                        # 3b·Z1Z2
        Z3 = f.add(t1, t2)
        t1 = f.sub(t1, t2)
        Y3 = f.mul(self.b3, Y3)                        # 3b·(X1Z2+X2Z1)
        X3n = f.sub(f.mul(t3, t1), f.mul(t4, Y3))
        Y3 = f.add(f.mul(t1, Z3), f.mul(Y3, X3))
        Z3 = f.add(f.mul(Z3, t4), f.mul(X3, t3))
        return (X3n, Y3, Z3)

    def double(self, P):
        """RCB15 Algorithm 9 (a = 0): 6M + 2S + 1·m3b, complete."""
        f = self.f
        X, Y, Z = P
        t0 = f.mul(Y, Y)
        Z3 = f.add(t0, t0)
        Z3 = f.add(Z3, Z3)
        Z3 = f.add(Z3, Z3)                             # 8Y²
        t1 = f.mul(Y, Z)
        t2 = f.mul(Z, Z)
        t2 = f.mul(self.b3, t2)                        # 3b·Z²
        X3 = f.mul(t2, Z3)
        Y3 = f.add(t0, t2)
        Z3 = f.mul(t1, Z3)
        t1 = f.add(t2, t2)
        t2 = f.add(t1, t2)
        t0 = f.sub(t0, t2)
        Y3 = f.mul(t0, Y3)
        Y3 = f.add(X3, Y3)
        t1 = f.mul(X, Y)
        X3 = f.mul(t0, t1)
        X3 = f.add(X3, X3)
        return (X3, Y3, Z3)

    def neg(self, P):
        return (P[0], self.f.neg(P[1]), P[2])

    def select(self, cond, P, Q):
        f = self.f
        return tuple(f.select(cond, a, b) for a, b in zip(P, Q))

    def scalar_mul_bits(self, P, bits):
        """Σ-free MSB-first double-and-add over bit variables (MSB at
        bits[-1], api.to_binary order). Complete adds make every step
        branch-free; zero scalars yield the identity."""
        acc = self.identity()
        for bit in reversed(bits):
            acc = self.double(acc)
            cand = self.add(acc, P)
            acc = self.select(bit, cand, acc)
        return acc

    def scalar_mul(self, api, P, scalar, nbits: int):
        return self.scalar_mul_bits(P, api.to_binary(scalar, nbits))

    def scalar_mul_const(self, P, k: int):
        """[k]P for a KNOWN positive scalar — plain double-and-add with no
        selects (complete formulas make every step branch-free)."""
        assert k > 0
        acc = P
        for bit in bin(k)[3:]:
            acc = self.double(acc)
            if bit == "1":
                acc = self.add(acc, P)
        return acc

    def assert_on_curve_affine(self, xy, b):
        """y² == x³ + b for an affine (x, y) gadget point."""
        f = self.f
        x, y = xy
        lhs = f.mul(y, y)
        rhs = f.add(f.mul(f.mul(x, x), x), b)
        f.assert_equal(lhs, rhs)

    def to_affine(self, nf_div, P):
        """(X, Y, Z) -> (X/Z, Y/Z). Constrains Z ≠ 0 (div is checked):
        callers must not normalize the identity — the Groth16 verifier's
        kSum is never the identity for honest inputs, and a malicious
        identity makes the circuit unsatisfiable, which is a rejection."""
        X, Y, Z = P
        return (nf_div(X, Z), nf_div(Y, Z))
