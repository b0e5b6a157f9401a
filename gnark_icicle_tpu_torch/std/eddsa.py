"""In-circuit twisted Edwards arithmetic + EdDSA verification gadget.

Role parity: reference std/algebra/native/twistededwards (in-circuit curve
ops) + std/signature/eddsa (verifier gadget, used by examples/rollup). The
complete twisted Edwards addition law is division-friendly in-circuit
(api.div emits one gate per inverse); scalar muls are bit-ladders over
to_binary decompositions.

Copied from gnark_icicle_tpu/std/eddsa.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_std.py holds it to the original.
"""

from __future__ import annotations

from ..curves import twisted_edwards as te
from .hash.mimc import MiMC

SCALAR_BITS = 251  # covers the Baby Jubjub prime subgroup order


class TECurve:
    """Twisted Edwards group ops on circuit variables."""

    def __init__(self, api, modulus: int):
        self.api = api
        self.q = modulus

    def add(self, p1, p2):
        api = self.api
        x1, y1 = p1
        x2, y2 = p2
        x1x2 = api.mul(x1, x2)
        y1y2 = api.mul(y1, y2)
        x1y2 = api.mul(x1, y2)
        y1x2 = api.mul(y1, x2)
        dxy = api.mul(te.D, x1x2, y1y2)
        x3 = api.div(api.add(x1y2, y1x2), api.add(1, dxy))
        y3 = api.div(
            api.sub(y1y2, api.mul(te.A, x1x2)), api.sub(1, dxy)
        )
        return (x3, y3)

    def double(self, p):
        return self.add(p, p)

    def select(self, cond, p1, p2):
        api = self.api
        return (api.select(cond, p1[0], p2[0]),
                api.select(cond, p1[1], p2[1]))

    def scalar_mul_bits(self, p, bits):
        """Σ bits·p via double-and-add (LSB-first bit list of variables)."""
        acc = (0, 1)  # identity as constants
        addend = p
        for i, b in enumerate(bits):
            added = self.add(acc, addend)
            acc = self.select(b, added, acc)
            if i + 1 < len(bits):
                addend = self.double(addend)
        return acc

    def scalar_mul(self, p, scalar_var, n_bits: int = SCALAR_BITS):
        return self.scalar_mul_bits(p, self.api.to_binary(scalar_var, n_bits))

    def assert_on_curve(self, p):
        api = self.api
        x, y = p
        x2 = api.mul(x, x)
        y2 = api.mul(y, y)
        lhs = api.add(api.mul(te.A, x2), y2)
        rhs = api.add(1, api.mul(te.D, x2, y2))
        api.assert_is_equal(lhs, rhs)


def verify_signature(api, modulus: int, public, r_point, s, msg):
    """Constrain EdDSA validity: S·B == R + H(R,A,msg)·A.

    public/r_point: (x, y) variable pairs; s, msg: variables.
    ≙ std/signature/eddsa Verify.
    """
    curve = TECurve(api, modulus)
    curve.assert_on_curve(public)
    curve.assert_on_curve(r_point)

    h = MiMC(api, modulus)
    h.write(r_point[0], r_point[1], public[0], public[1], msg)
    c = h.sum()

    lhs = curve.scalar_mul(te.BASE, s)
    c_a = curve.scalar_mul(public, c, n_bits=254)
    rhs = curve.add(r_point, c_a)
    api.assert_is_equal(lhs[0], rhs[0])
    api.assert_is_equal(lhs[1], rhs[1])
