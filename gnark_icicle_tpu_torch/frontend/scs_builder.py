"""PLONK-arithmetization builder: the frontend.API over sparse gates.

Role parity: gnark's SCS builder (reference: frontend/cs/scs/builder.go:48
NewBuilder, api.go — values are single coeff·wire terms, constants fold into
gate coefficients, additions/multiplications emit one gate each). Implements
the same op surface as frontend.api.Builder so circuits compile unchanged
under either arithmetization (≙ frontend.Compile's builder parameter).

Copied from gnark_icicle_tpu/frontend/scs_builder.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

from ..constraint.scs import SparseR1CS
from ..constraint import hints as hintlib


class SVar:
    """coeff · wire (SCS values are single terms, ≙ expr.Term)."""

    __slots__ = ("coeff", "wire")

    def __init__(self, coeff: int, wire: int):
        self.coeff = coeff
        self.wire = wire

    def __repr__(self):
        return f"SVar({self.coeff}·w{self.wire})"


class ScsBuilder:
    """frontend.API emitting qL·a + qR·b + qM·ab + qO·o + qC = 0 gates."""

    def __init__(self, field_modulus: int):
        self.cs = SparseR1CS(field_modulus)
        self.q = field_modulus
        self._booleans: set[int] = set()
        self._pending_public: list[int] = []

    # -- declaration (compile() protocol) ------------------------------------
    def public_variable(self, name: str):
        wid = self.cs.add_public(name)
        # public-input gate: −x + PI(Qk) = 0 (emitted immediately so gate j
        # aligns with public input j; the builder is called for all publics
        # before any user constraint)
        self.cs.add_gate(wid, wid, wid, ql=-1, qr=0, qm=0, qo=0, qc=0)
        return SVar(1, wid)

    def secret_variable(self, name: str):
        return SVar(1, self.cs.add_secret(name))

    # -- value plumbing -------------------------------------------------------
    def constant_value(self, v):
        if isinstance(v, SVar):
            return None
        return int(v) % self.q

    def _is_const(self, v):
        return not isinstance(v, SVar)

    def _new_wire(self):
        return self.cs.new_internal()

    # -- linear ---------------------------------------------------------------
    def _add2(self, a, b):
        ca, cb = self.constant_value(a), self.constant_value(b)
        if ca is not None and cb is not None:
            return (ca + cb) % self.q
        if ca is not None:
            a, b, ca, cb = b, a, cb, ca
        # a is SVar; b may be const or SVar
        if cb is not None:
            if cb == 0:
                return a
            o = self._new_wire()
            # ql·a + qc − o = 0
            self.cs.add_gate(a.wire, a.wire, o, ql=a.coeff, qr=0, qm=0,
                             qo=-1, qc=cb, solved_wire=o)
            return SVar(1, o)
        if a.wire == b.wire:
            return SVar((a.coeff + b.coeff) % self.q, a.wire)
        o = self._new_wire()
        self.cs.add_gate(a.wire, b.wire, o, ql=a.coeff, qr=b.coeff, qm=0,
                         qo=-1, qc=0, solved_wire=o)
        return SVar(1, o)

    def add(self, a, b, *rest):
        acc = self._add2(a, b)
        for v in rest:
            acc = self._add2(acc, v)
        return acc

    def neg(self, a):
        if self._is_const(a):
            return (-int(a)) % self.q
        return SVar((-a.coeff) % self.q, a.wire)

    def sub(self, a, b, *rest):
        acc = self._add2(a, self.neg(b))
        for v in rest:
            acc = self._add2(acc, self.neg(v))
        return acc

    # -- multiplicative --------------------------------------------------------
    def _mul2(self, a, b):
        ca, cb = self.constant_value(a), self.constant_value(b)
        if ca is not None and cb is not None:
            return ca * cb % self.q
        if ca is not None:
            a, ca, cb = b, cb, ca
        if cb is not None:
            return SVar(a.coeff * cb % self.q, a.wire)
        o = self._new_wire()
        # qm·ab − o = 0
        self.cs.add_gate(a.wire, b.wire, o, ql=0, qr=0,
                         qm=a.coeff * b.coeff % self.q, qo=-1, qc=0,
                         solved_wire=o)
        return SVar(1, o)

    def mul(self, a, b, *rest):
        acc = self._mul2(a, b)
        for v in rest:
            acc = self._mul2(acc, v)
        return acc

    def div_unchecked(self, a, b):
        """a/b with 0/0 = 0 (hint value + check gate, ≙ api.DivUnchecked)."""
        ca, cb = self.constant_value(a), self.constant_value(b)
        if cb is not None:
            if cb == 0:
                if ca == 0:
                    return 0
                raise ZeroDivisionError("division by constant zero")
            return self._mul2(a, pow(cb, -1, self.q))
        a_in = a if isinstance(a, SVar) else None
        (out,) = self.new_hint(hintlib.DIV_UNCHECKED, 1, a, b)
        # check gate: qm·(b·out) − a = 0 (no solved wire)
        if a_in is None:
            self.cs.add_gate(b.wire, out.wire, out.wire, ql=0, qr=0,
                             qm=b.coeff, qo=0, qc=-ca)
        else:
            self.cs.add_gate(b.wire, out.wire, a_in.wire, ql=0, qr=0,
                             qm=b.coeff, qo=-a_in.coeff % self.q, qc=0)
        return out

    def div(self, a, b):
        return self.mul(a, self.inverse(b))

    def inverse(self, a):
        ca = self.constant_value(a)
        if ca is not None:
            if ca == 0:
                raise ZeroDivisionError("inverse of constant zero")
            return pow(ca, -1, self.q)
        o = self._new_wire()
        # a·o = 1
        self.cs.add_gate(a.wire, o, o, ql=0, qr=0, qm=a.coeff, qo=0, qc=-1,
                         solved_wire=o)
        return SVar(1, o)

    # -- bits -------------------------------------------------------------------
    def to_binary(self, a, n: int = None):
        if n is None:
            n = self.q.bit_length()
        ca = self.constant_value(a)
        if ca is not None:
            if ca >= (1 << n):
                raise ValueError(f"constant {ca} does not fit in {n} bits")
            return [((ca >> i) & 1) for i in range(n)]
        bit_wids = [self.cs.new_internal() for _ in range(n)]
        self.cs.add_hint(
            hintlib.TO_BITS, [[(a.coeff, a.wire)]], bit_wids, static_args=(n,)
        )
        bits = [SVar(1, w) for w in bit_wids]
        for bv in bits:
            self.assert_is_boolean(bv)
        # Σ 2^i b_i == a via an add chain
        acc = self._mul2(bits[0], 1)
        for i in range(1, n):
            acc = self._add2(acc, SVar((1 << i) % self.q, bit_wids[i]))
        self.assert_is_equal(acc, a)
        return bits

    def from_binary(self, bits):
        acc = 0
        for i, b in enumerate(bits):
            acc = self._add2(acc, self._mul2(b, (1 << i) % self.q))
        return acc

    def _bool(self, v):
        self.assert_is_boolean(v)
        return v

    def _xor_or(self, a, b, qm_sign2: bool):
        """xor (a+b−2ab−o=0) / or (a+b−ab−o=0) as ONE gate with a solved
        output wire (≙ the reference scs builder's single-constraint Xor/Or,
        frontend/cs/scs/api.go)."""
        ca, cb = self.constant_value(a), self.constant_value(b)
        if ca is not None and cb is not None:
            if ca not in (0, 1) or cb not in (0, 1):
                raise ValueError("xor/or on non-boolean constants")
            return (ca ^ cb) if qm_sign2 else (ca | cb)
        if ca is not None or cb is not None:
            cst, v = (ca, b) if ca is not None else (cb, a)
            if cst not in (0, 1):
                raise ValueError("xor/or with non-boolean constant")
            v = self._bool(v)
            if cst == 0:
                return v
            return self.sub(1, v) if qm_sign2 else 1
        a, b = self._bool(a), self._bool(b)
        o = self._new_wire()
        k = 2 if qm_sign2 else 1
        self.cs.add_gate(
            a.wire, b.wire, o, ql=a.coeff, qr=b.coeff,
            qm=(-k * a.coeff * b.coeff) % self.q, qo=-1, qc=0,
            solved_wire=o,
        )
        out = SVar(1, o)
        self._mark_boolean(out)
        return out

    def xor(self, a, b):
        return self._xor_or(a, b, True)

    def and_(self, a, b):
        out = self.mul(self._bool(a), self._bool(b))
        self._mark_boolean(out)
        return out

    def or_(self, a, b):
        return self._xor_or(a, b, False)

    # -- conditionals -------------------------------------------------------------
    def select(self, cond, t, f):
        cond = self._bool(cond)
        return self.add(f, self.mul(cond, self.sub(t, f)))

    def lookup2(self, b0, b1, v0, v1, v2, v3):
        lo = self.select(b0, v1, v0)
        hi = self.select(b0, v3, v2)
        return self.select(b1, hi, lo)

    def is_zero(self, a):
        ca = self.constant_value(a)
        if ca is not None:
            return 1 if ca == 0 else 0
        k = self.new_hint(hintlib.INV_OR_ZERO, 1, a)[0]
        m = self.sub(1, self.mul(a, k))
        # a·m = 0
        self.cs.add_gate(a.wire, m.wire, m.wire,
                         ql=0, qr=0, qm=a.coeff * m.coeff % self.q,
                         qo=0, qc=0)
        self._mark_boolean(m)
        return m

    def cmp(self, a, b, n_bits: int = None):
        if n_bits is None:
            n_bits = self.q.bit_length() - 2
        bits_a = self.to_binary(a, n_bits)
        bits_b = self.to_binary(b, n_bits)
        res = 0
        for i in range(n_bits):
            ai, bi = bits_a[i], bits_b[i]
            gt = self.mul(ai, self.sub(1, bi))
            lt = self.mul(bi, self.sub(1, ai))
            diff = self.sub(gt, lt)
            res = self.select(self.is_zero(diff), res, diff)
        return res

    # -- assertions -----------------------------------------------------------------
    def assert_is_equal(self, a, b):
        ca, cb = self.constant_value(a), self.constant_value(b)
        if ca is not None and cb is not None:
            if ca != cb:
                raise ValueError("assert_is_equal on unequal constants")
            return
        if ca is not None:
            a, b, ca, cb = b, a, cb, ca
        if cb is not None:
            self.cs.add_gate(a.wire, a.wire, a.wire, ql=a.coeff, qr=0, qm=0,
                             qo=0, qc=-cb)
            return
        if a.wire == b.wire and a.coeff == b.coeff:
            return
        self.cs.add_gate(a.wire, b.wire, a.wire, ql=a.coeff,
                         qr=-b.coeff % self.q, qm=0, qo=0, qc=0)

    def assert_is_different(self, a, b):
        self.inverse(self.sub(a, b))

    def _mark_boolean(self, v):
        if isinstance(v, SVar) and v.coeff == 1:
            self._booleans.add(v.wire)

    def assert_is_boolean(self, a):
        ca = self.constant_value(a)
        if ca is not None:
            if ca not in (0, 1):
                raise ValueError(f"assert_is_boolean on constant {ca}")
            return
        if a.coeff == 1 and a.wire in self._booleans:
            return
        # b − b² = 0:  ql·b + qm·b·b = 0 with ql=c, qm=−c²
        self.cs.add_gate(a.wire, a.wire, a.wire, ql=a.coeff, qr=0,
                         qm=-(a.coeff * a.coeff) % self.q, qo=0, qc=0)
        self._mark_boolean(a)

    def assert_is_less_or_equal(self, v, bound):
        cb = self.constant_value(bound)
        if cb is not None:
            n = max(cb.bit_length(), 1)
            bits = self.to_binary(v, n)
            p = 1
            for i in range(n - 1, -1, -1):
                if (cb >> i) & 1:
                    p = self.mul(p, bits[i])
                else:
                    prod = self.mul(p, bits[i])
                    self.assert_is_equal(prod, 0)
            return
        n = self.q.bit_length() - 2
        self.to_binary(self.sub(bound, v), n)

    # -- hints & logging ----------------------------------------------------------
    def new_hint(self, hint_fn_or_id, nb_outputs: int, *inputs, static_args=()):
        hid = (
            hint_fn_or_id
            if isinstance(hint_fn_or_id, int)
            else hintlib.register_hint(hint_fn_or_id)
        )
        in_exprs = []
        for v in inputs:
            cv = self.constant_value(v)
            if cv is not None:
                # constants enter hints via a synthetic (coeff, wire) on a
                # solved wire: emit o = cv and reference it
                o = self._new_wire()
                self.cs.add_gate(o, o, o, ql=0, qr=0, qm=0, qo=-1, qc=cv,
                                 solved_wire=o)
                in_exprs.append([(1, o)])
            else:
                in_exprs.append([(v.coeff, v.wire)])
        out_wids = [self.cs.new_internal() for _ in range(nb_outputs)]
        self.cs.add_hint(hid, in_exprs, out_wids, static_args=static_args)
        return [SVar(1, w) for w in out_wids]

    def commit(self, *vs):
        """BSB22 commitment in PLONK form (≙ scs builder Commit,
        frontend/cs/scs/api.go): one COMMITTED row per committed variable
        binding it to the prover's PI2 column, one COMMITMENT row binding
        the hint output to the injected Qk value.
        """
        from ..constraint.scs import (
            PlonkCommitment, COMMIT_COMMITTED, COMMIT_COMMITMENT,
        )

        vars_ = [v for v in vs if isinstance(v, SVar)]  # ≙ filterConstants
        if not vars_:
            raise ValueError("must commit to at least one variable")
        committed = []
        for v in vars_:
            # row: −v + PI2 = 0 (PI2 supplied by the prover's committed poly)
            gi = self.cs.add_gate(v.wire, v.wire, v.wire,
                                  ql=-v.coeff % self.q, qr=0, qm=0, qo=0,
                                  qc=0)
            self.cs.commitment_tags[gi] = COMMIT_COMMITTED
            committed.append(gi)
        depth = len(self.cs.commitments)
        (out,) = self.new_hint(
            hintlib.BSB22_PLACEHOLDER, 1, depth, *vars_
        )
        # row: −c + commitmentValue(Qk-injected) = 0
        ci = self.cs.add_gate(out.wire, out.wire, out.wire,
                              ql=-1 % self.q, qr=0, qm=0, qo=0, qc=0)
        self.cs.commitment_tags[ci] = COMMIT_COMMITMENT
        self.cs.commitments.append(
            PlonkCommitment(committed=committed, commitment_index=ci)
        )
        return out

    def defer_(self, cb):
        """Run cb(api) after define returns (≙ api.Compiler().Defer /
        internal/circuitdefer)."""
        from .compile import defer_circuit

        defer_circuit(self, cb)

    def println(self, *args):
        pass
