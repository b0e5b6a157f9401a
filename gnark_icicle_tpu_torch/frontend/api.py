"""Circuit-building API and the R1CS builder.

Role parity: gnark's ``frontend.API`` (~25 ops, reference:
frontend/api.go:26-156) and the R1CS builder (frontend/cs/r1cs/builder.go:51,
api.go — LinearExpression values, constant folding, boolean marking). The
Python surface mirrors the Go one op-for-op in snake_case: add/mul/sub/neg/
div/inverse/select/lookup2/is_zero/cmp/to_binary/from_binary/xor/or_/and_/
assert_is_equal/assert_is_different/assert_is_boolean/
assert_is_less_or_equal/println/new_hint/constant_value.

Values flowing through ``define`` are ``Var`` linear expressions (wire-id →
coefficient maps) or plain python ints; constants fold eagerly exactly like
the reference's builder (frontend/cs/r1cs/api.go keeps expressions unreduced
and folds constants before emitting constraints).

Copied from gnark_icicle_tpu/frontend/api.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

from ..constraint.system import R1CS, COEFF_ONE
from ..constraint import hints as hintlib


class Var:
    """A linear combination of wires: {wire_id: coeff}. Immutable by
    convention (ops return new Vars)."""

    __slots__ = ("terms",)

    def __init__(self, terms: dict):
        self.terms = terms

    def __repr__(self):
        return f"Var({self.terms})"


class Builder:
    """frontend.API + Compiler for R1CS (≙ r1cs.NewBuilder's builder)."""

    def __init__(self, field_modulus: int,
                 compress_threshold: int = 300):
        self.cs = R1CS(field_modulus)
        self.q = field_modulus
        # ≙ frontend.WithCompressThreshold (default 300, compile.go:149)
        self.compress_threshold = compress_threshold
        self._booleans: set[int] = set()  # wire ids proven boolean

    # ------------------------------------------------------------------
    # value plumbing
    # ------------------------------------------------------------------
    def _to_var(self, v) -> Var:
        if isinstance(v, Var):
            return v
        return Var({0: int(v) % self.q})  # constant on the ONE wire

    def constant_value(self, v):
        """Int value if v is a compile-time constant, else None
        (≙ api.Compiler().ConstantValue)."""
        if not isinstance(v, Var):
            return int(v) % self.q
        if all(w == 0 for w in v.terms):
            return v.terms.get(0, 0) % self.q
        return None

    def _is_const(self, v):
        return self.constant_value(v) is not None

    def _terms_list(self, v: Var):
        """Var -> [(coeff_id, wire_id)] for the constraint store."""
        return [
            (self.cs.coeff_id(c), w)
            for w, c in sorted(v.terms.items())
            if c % self.q != 0
        ]

    def _new_wire_var(self) -> tuple:
        wid = self.cs.new_internal()
        return wid, Var({wid: 1})

    # ------------------------------------------------------------------
    # input declaration (used by compile())
    # ------------------------------------------------------------------
    def public_variable(self, name: str) -> Var:
        return Var({self.cs.add_public(name): 1})

    def secret_variable(self, name: str) -> Var:
        return Var({self.cs.add_secret(name): 1})

    # ------------------------------------------------------------------
    # linear ops (no constraints emitted)
    # ------------------------------------------------------------------
    def _compress(self, out: dict) -> "Var":
        """If a linear expression grew past the compress threshold,
        materialize it into ONE wire via LE·1 = t (≙ builder.compress,
        reference frontend/cs/r1cs/builder.go:461-474, default threshold
        300 — frontend/compile.go:149). Without this, patterns like
        v = add(mul(v,v), v, i) grow the expression by O(1) terms per
        step and compilation goes quadratic (measured 4x time per 2x
        constraints on the 2^k chain benchmark)."""
        if len(out) < self.compress_threshold:
            return Var(out)
        wid, t = self._new_wire_var()
        self.cs.add_r1c(
            sorted(((self.cs.coeff_id(c), w) for w, c in out.items()),
                   key=lambda t_: t_[1]),
            [(COEFF_ONE, 0)], self._terms_list(t), solved_wire=wid,
        )
        return t

    def add(self, a, b, *rest):
        out = dict(self._to_var(a).terms)
        for v in (b, *rest):
            for w, c in self._to_var(v).terms.items():
                out[w] = (out.get(w, 0) + c) % self.q
        return self._compress(out)

    def sub(self, a, b, *rest):
        out = dict(self._to_var(a).terms)
        for v in (b, *rest):
            for w, c in self._to_var(v).terms.items():
                out[w] = (out.get(w, 0) - c) % self.q
        return self._compress(out)

    def neg(self, a):
        return Var({w: (-c) % self.q for w, c in self._to_var(a).terms.items()})

    def _scale(self, a: Var, k: int) -> Var:
        k %= self.q
        return Var({w: c * k % self.q for w, c in a.terms.items()})

    # ------------------------------------------------------------------
    # multiplicative ops
    # ------------------------------------------------------------------
    def mul(self, a, b, *rest):
        acc = self._to_var(a)
        for v in (b, *rest):
            acc = self._mul2(acc, self._to_var(v))
        return acc

    def _mul2(self, a: Var, b: Var) -> Var:
        ca, cb = self.constant_value(a), self.constant_value(b)
        if ca is not None:
            return self._scale(b, ca)
        if cb is not None:
            return self._scale(a, cb)
        wid, out = self._new_wire_var()
        self.cs.add_r1c(
            self._terms_list(a), self._terms_list(b), self._terms_list(out),
            solved_wire=wid,
        )
        return out

    def div_unchecked(self, a, b):
        """a/b with 0/0 = 0 (≙ api.DivUnchecked: hint value + out·b == a)."""
        va, vb = self._to_var(a), self._to_var(b)
        ca, cb = self.constant_value(va), self.constant_value(vb)
        if cb is not None:
            if cb == 0:
                if ca == 0:
                    return Var({0: 0})
                raise ZeroDivisionError("division by constant zero")
            return self._scale(va, pow(cb, -1, self.q))
        (out,) = self.new_hint(hintlib.DIV_UNCHECKED, 1, va, vb)
        # check constraint: out·b == a (accepts 0/0 = 0, rejects a/0)
        self.cs.add_r1c(
            self._terms_list(out), self._terms_list(vb), self._terms_list(va)
        )
        return out

    def div(self, a, b):
        """a/b, proving b ≠ 0 (≙ api.Div: constrains b·(1/b) = 1)."""
        inv_b = self.inverse(b)
        return self.mul(a, inv_b)

    def inverse(self, a):
        va = self._to_var(a)
        ca = self.constant_value(va)
        if ca is not None:
            if ca == 0:
                raise ZeroDivisionError("inverse of constant zero")
            return Var({0: pow(ca, -1, self.q)})
        wid, out = self._new_wire_var()
        one = Var({0: 1})
        # out·a = 1, solve out
        self.cs.add_r1c(
            self._terms_list(out), self._terms_list(va), self._terms_list(one),
            solved_wire=wid,
        )
        return out

    # ------------------------------------------------------------------
    # bit ops
    # ------------------------------------------------------------------
    def to_binary(self, a, n: int = None):
        """Little-endian bit decomposition, n bits (≙ api.ToBinary).

        Hint-computed bits, each constrained boolean, with the weighted sum
        constrained equal to a (frontend/cs/r1cs/api.go ToBinary shape).
        """
        if n is None:
            n = self.q.bit_length()
        va = self._to_var(a)
        ca = self.constant_value(va)
        if ca is not None:
            if ca >= (1 << n):
                raise ValueError(f"constant {ca} does not fit in {n} bits")
            return [Var({0: (ca >> i) & 1}) for i in range(n)]
        bit_wids = [self.cs.new_internal() for _ in range(n)]
        self.cs.add_hint(
            hintlib.TO_BITS, [self._terms_list(va)], bit_wids, static_args=(n,)
        )
        bits = [Var({w: 1}) for w in bit_wids]
        for bv in bits:
            self.assert_is_boolean(bv)
        acc = Var({w: (1 << i) % self.q for i, w in enumerate(bit_wids)})
        # Σ 2^i b_i = a  as (acc)·1 = a
        self.cs.add_r1c(
            self._terms_list(acc), [(COEFF_ONE, 0)], self._terms_list(va)
        )
        return bits

    def from_binary(self, bits):
        acc = Var({})
        for i, b in enumerate(bits):
            acc = self.add(acc, self._scale(self._to_var(b), 1 << i))
        return acc

    def _xor_or_const(self, cst: int, v: Var, is_xor: bool):
        if cst not in (0, 1):
            raise ValueError(f"xor/or with non-boolean constant {cst}")
        self.assert_is_boolean(v)
        if is_xor:
            out = self.sub(1, v) if cst else v
        else:
            out = Var({0: 1}) if cst else v
        self._mark_boolean(out)
        return out

    def xor(self, a, b):
        """a ⊕ b for booleans, as a·(1−2b) + b with b the SHORTER operand
        (≙ api.go:375-400): the product lands in ONE fresh wire, so the
        result has ≤ len(b)+1 terms — composing xors (hash circuits) stays
        bounded instead of growing the linear expression per level (the
        naive a+b−2ab form made keccak-f compile superlinearly)."""
        va, vb = self._to_var(a), self._to_var(b)
        ca, cb = self.constant_value(va), self.constant_value(vb)
        if ca is not None and cb is not None:
            if ca not in (0, 1) or cb not in (0, 1):
                raise ValueError("xor on non-boolean constants")
            return Var({0: ca ^ cb})
        if ca is not None:
            return self._xor_or_const(ca, vb, True)
        if cb is not None:
            return self._xor_or_const(cb, va, True)
        self.assert_is_boolean(va)
        self.assert_is_boolean(vb)
        if len(vb.terms) > len(va.terms):
            va, vb = vb, va
        t = self.sub(1, self._scale(vb, 2))
        out = self.add(self._mul2(va, t), vb)
        self._mark_boolean(out)
        return out

    def and_(self, a, b):
        self.assert_is_boolean(a)
        self.assert_is_boolean(b)
        out = self.mul(a, b)
        self._mark_boolean(self._to_var(out))
        return out

    def or_(self, a, b):
        """a ∨ b as a·(1−b) + b (one product wire, bounded result —
        ≙ api.go Or's same rewrite)."""
        va, vb = self._to_var(a), self._to_var(b)
        ca, cb = self.constant_value(va), self.constant_value(vb)
        if ca is not None and cb is not None:
            if ca not in (0, 1) or cb not in (0, 1):
                raise ValueError("or on non-boolean constants")
            return Var({0: ca | cb})
        if ca is not None:
            return self._xor_or_const(ca, vb, False)
        if cb is not None:
            return self._xor_or_const(cb, va, False)
        self.assert_is_boolean(va)
        self.assert_is_boolean(vb)
        if len(vb.terms) > len(va.terms):
            va, vb = vb, va
        t = self.sub(1, vb)
        out = self.add(self._mul2(va, t), vb)
        self._mark_boolean(out)
        return out

    # ------------------------------------------------------------------
    # conditionals
    # ------------------------------------------------------------------
    def select(self, cond, t, f):
        """cond ? t : f  =  f + cond·(t − f) (≙ api.Select)."""
        self.assert_is_boolean(cond)
        d = self.sub(t, f)
        return self.add(f, self.mul(cond, d))

    def lookup2(self, b0, b1, v0, v1, v2, v3):
        """2-bit lookup (≙ api.Lookup2)."""
        lo = self.select(b0, v1, v0)
        hi = self.select(b0, v3, v2)
        return self.select(b1, hi, lo)

    def is_zero(self, a):
        """1 if a == 0 else 0 (≙ api.IsZero: m = −a·k + 1, a·m = 0 with
        k = inv-or-zero hint)."""
        va = self._to_var(a)
        ca = self.constant_value(va)
        if ca is not None:
            return Var({0: 1 if ca == 0 else 0})
        k_wid = self.cs.new_internal()
        self.cs.add_hint(hintlib.INV_OR_ZERO, [self._terms_list(va)], [k_wid])
        k = Var({k_wid: 1})
        # m = 1 − a·k  (one mul constraint solving m)
        ak = self.mul(va, k)
        m = self.sub(1, ak)
        # a·m = 0
        self.cs.add_r1c(
            self._terms_list(va), self._terms_list(m), []
        )
        self._mark_boolean(m)
        return m

    def cmp(self, a, b, n_bits: int = None):
        """Sign of a−b as {-1,0,1}, comparing n_bits-bit values (≙ api.Cmp)."""
        if n_bits is None:
            n_bits = self.q.bit_length() - 2
        bits_a = self.to_binary(a, n_bits)
        bits_b = self.to_binary(b, n_bits)
        res = Var({0: 0})
        for i in range(n_bits):  # MSB decides
            ai, bi = bits_a[i], bits_b[i]
            gt = self.mul(ai, self.sub(1, bi))
            lt = self.mul(bi, self.sub(1, ai))
            diff = self.sub(gt, lt)  # {-1,0,1} at bit i
            unchanged = self.is_zero(diff)
            res = self.select(unchanged, res, diff)
        return res

    # ------------------------------------------------------------------
    # assertions
    # ------------------------------------------------------------------
    def assert_is_equal(self, a, b):
        d = self.sub(a, b)
        cd = self.constant_value(d)
        if cd is not None:
            if cd != 0:
                raise ValueError(f"assert_is_equal on unequal constants ({cd})")
            return
        # (a−b)·1 = 0
        self.cs.add_r1c(self._terms_list(d), [(COEFF_ONE, 0)], [])

    def assert_is_different(self, a, b):
        self.inverse(self.sub(a, b))  # invertible ⇔ nonzero

    def _mark_boolean(self, v):
        """Record a PROVEN-boolean value for assert dedup. Single wires are
        keyed by id; linear combinations (xor/or outputs) by their frozen
        term set (≙ builder.MarkBoolean, which stores the whole LinearExpr —
        frontend/cs/r1cs/api.go:398)."""
        if not isinstance(v, Var):
            return
        if len(v.terms) == 1:
            (w, c), = v.terms.items()
            if c == 1:
                self._booleans.add(w)
                return
        self._booleans.add(frozenset(v.terms.items()))

    def _is_marked_boolean(self, v: Var) -> bool:
        if len(v.terms) == 1:
            (w, c), = v.terms.items()
            if c == 1 and w in self._booleans:
                return True
        return frozenset(v.terms.items()) in self._booleans

    def assert_is_boolean(self, a):
        va = self._to_var(a)
        ca = self.constant_value(va)
        if ca is not None:
            if ca not in (0, 1):
                raise ValueError(f"assert_is_boolean on constant {ca}")
            return
        if self._is_marked_boolean(va):  # dedup (≙ builder MarkBoolean)
            return
        one_minus = self.sub(1, va)
        self.cs.add_r1c(
            self._terms_list(va), self._terms_list(one_minus), []
        )
        self._mark_boolean(va)

    def assert_is_less_or_equal(self, v, bound):
        """v ≤ bound (≙ api.AssertIsLessOrEqual, bit-decomposition variant)."""
        cb = self.constant_value(self._to_var(bound)) if not isinstance(bound, Var) \
            else self.constant_value(bound)
        if cb is not None:
            self._assert_leq_constant(v, cb)
            return
        n = self.q.bit_length() - 2
        diff = self.sub(bound, v)
        self.to_binary(diff, n)  # decomposable in n bits ⇒ no wraparound

    def _assert_leq_constant(self, v, bound: int):
        n = max(bound.bit_length(), 1)
        bits = self.to_binary(v, n)
        # Walk bound's bits MSB→LSB (gnark's AssertIsLessOrEqual "aux" chain):
        # p accumulates ANDs of v's bits at bound's 1-positions; at each
        # 0-position of bound require p·v_bit = 0.
        p = Var({0: 1})
        for i in range(n - 1, -1, -1):
            if (bound >> i) & 1:
                p = self.mul(p, bits[i])
            else:
                self.cs.add_r1c(
                    self._terms_list(p),
                    self._terms_list(self._to_var(bits[i])),
                    [],
                )

    # ------------------------------------------------------------------
    # hints & logging
    # ------------------------------------------------------------------
    def new_hint(self, hint_fn_or_id, nb_outputs: int, *inputs,
                 static_args=()):
        """Run a registered hint at solve time (≙ api.Compiler().NewHint)."""
        hid = (
            hint_fn_or_id
            if isinstance(hint_fn_or_id, int)
            else hintlib.register_hint(hint_fn_or_id)
        )
        in_exprs = [self._terms_list(self._to_var(v)) for v in inputs]
        out_wids = [self.cs.new_internal() for _ in range(nb_outputs)]
        self.cs.add_hint(hid, in_exprs, out_wids, static_args=static_args)
        return [Var({w: 1}) for w in out_wids]

    def commit(self, *vs):
        """BSB22 commitment to the given variables (≙ builder.Commit,
        reference: frontend/cs/r1cs/api.go:689-830).

        Appends a random hiding mask, sorts the committed wires into
        public/commitment/private classes (a private wire already committed
        by an earlier commitment is replaced by that commitment's wire),
        and emits the placeholder hint the prover overrides with the real
        Pedersen commitment. Returns the commitment variable.
        """
        from ..constraint.system import Groth16Commitment

        # hiding mask, involved in a (tautological) constraint so it gets a
        # nonzero K scalar and thus a usable Pedersen basis point
        (mask,) = self.new_hint(hintlib.RANDOMIZE, 1)
        self.cs.add_r1c(
            self._terms_list(mask), [(COEFF_ONE, 0)], self._terms_list(mask)
        )
        vs = list(vs) + [mask]

        existing = [c.commitment_index for c in self.cs.commitments]
        existing_set = set(existing)
        committed_by = {}  # private wire id -> index of committing commitment
        for ci, c in enumerate(self.cs.commitments):
            for w in c.private_committed:
                committed_by[w] = ci

        # gather candidate wire ids (constants/ONE contribute nothing)
        worklist = set()
        for v in vs:
            for w in self._to_var(v).terms:
                if w != 0:
                    worklist.add(w)

        nb_pub = self.cs.nb_public
        public_committed = set()
        commitment_committed = set()
        private_committed = set()
        from collections import deque

        pending = deque(sorted(worklist))
        while pending:
            w = pending.popleft()  # deque: list.pop(0) is O(n) and the
            # multicommit path commits to ~1e6 wires (mulcheck operands)
            if w < nb_pub:
                public_committed.add(w)
            elif w in existing_set:
                commitment_committed.add(w)
            elif w in committed_by:
                # commit to the earlier commitment instead of double-binding
                cw = existing[committed_by[w]]
                if cw not in commitment_committed:
                    pending.append(cw)
            else:
                private_committed.add(w)

        pub_sorted = sorted(public_committed)
        com_sorted = sorted(commitment_committed)
        priv_sorted = sorted(private_committed)
        if not (pub_sorted or com_sorted or priv_sorted):
            raise ValueError("must commit to at least one variable")

        inputs = (
            [Var({0: len(self.cs.commitments)})]
            + [Var({w: 1}) for w in pub_sorted + com_sorted]
            + [Var({w: 1}) for w in priv_sorted]
        )
        (res,) = self.new_hint(hintlib.BSB22_PLACEHOLDER, 1, *inputs)
        (cwid,) = res.terms
        self.cs.commitments.append(Groth16Commitment(
            public_and_commitment_committed=pub_sorted + com_sorted,
            nb_public_committed=len(pub_sorted),
            private_committed=priv_sorted,
            commitment_index=cwid,
        ))
        return res

    def defer_(self, cb):
        """Run cb(api) after define returns (≙ api.Compiler().Defer /
        internal/circuitdefer)."""
        from .compile import defer_circuit

        defer_circuit(self, cb)

    def println(self, *args):
        """Record values to resolve at solve time (≙ api.Println)."""
        entry = []
        for v in args:
            if isinstance(v, Var):
                entry.append(("var", self._terms_list(v)))
            else:
                entry.append(("const", v))
        self.cs.log_entries.append(entry)
