"""Test engine: run ``define`` directly over field ints — no compilation.

Role parity: gnark's big.Int test engine (reference: test/engine.go:47-145
``test.IsSolved`` runs Define with an engine implementing frontend.API over
big.Int mod q). Fast completeness checking and the fuzzing executor; every
Builder op has a matching plain-arithmetic implementation here, and tests
cross-check engine vs solver on the same assignments (test strategy §4.1).

Copied from gnark_icicle_tpu/frontend/engine.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

from ..constraint import hints as hintlib


class EngineUnsatisfiedError(Exception):
    pass


class Engine:
    """frontend.API implemented directly over ints mod q."""

    def __init__(self, modulus: int):
        self.q = modulus

    def _v(self, x) -> int:
        return int(x) % self.q

    # linear
    def add(self, a, b, *rest):
        s = self._v(a) + self._v(b)
        for r in rest:
            s += self._v(r)
        return s % self.q

    def sub(self, a, b, *rest):
        s = self._v(a) - self._v(b)
        for r in rest:
            s -= self._v(r)
        return s % self.q

    def neg(self, a):
        return -self._v(a) % self.q

    def mul(self, a, b, *rest):
        s = self._v(a) * self._v(b) % self.q
        for r in rest:
            s = s * self._v(r) % self.q
        return s

    def div_unchecked(self, a, b):
        va, vb = self._v(a), self._v(b)
        if vb == 0:
            if va == 0:
                return 0
            raise EngineUnsatisfiedError("division by zero")
        return va * pow(vb, -1, self.q) % self.q

    def div(self, a, b):
        vb = self._v(b)
        if vb == 0:
            raise EngineUnsatisfiedError("division by zero")
        return self._v(a) * pow(vb, -1, self.q) % self.q

    def inverse(self, a):
        va = self._v(a)
        if va == 0:
            raise EngineUnsatisfiedError("inverse of zero")
        return pow(va, -1, self.q)

    # bits
    def to_binary(self, a, n: int = None):
        if n is None:
            n = self.q.bit_length()
        va = self._v(a)
        if va >= (1 << n):
            raise EngineUnsatisfiedError(f"{va} does not fit in {n} bits")
        return [(va >> i) & 1 for i in range(n)]

    def from_binary(self, bits):
        return sum(self._v(b) << i for i, b in enumerate(bits)) % self.q

    def _bool(self, x):
        v = self._v(x)
        if v not in (0, 1):
            raise EngineUnsatisfiedError(f"{v} is not boolean")
        return v

    def xor(self, a, b):
        return self._bool(a) ^ self._bool(b)

    def and_(self, a, b):
        return self._bool(a) & self._bool(b)

    def or_(self, a, b):
        return self._bool(a) | self._bool(b)

    # conditionals
    def select(self, cond, t, f):
        return self._v(t) if self._bool(cond) else self._v(f)

    def lookup2(self, b0, b1, v0, v1, v2, v3):
        idx = self._bool(b0) | (self._bool(b1) << 1)
        return self._v([v0, v1, v2, v3][idx])

    def is_zero(self, a):
        return 1 if self._v(a) == 0 else 0

    def cmp(self, a, b, n_bits: int = None):
        va, vb = self._v(a), self._v(b)
        if n_bits is not None:
            if va >= (1 << n_bits) or vb >= (1 << n_bits):
                raise EngineUnsatisfiedError("cmp operand out of bit range")
        return 1 if va > vb else (self.q - 1 if va < vb else 0)

    # assertions
    def assert_is_equal(self, a, b):
        if self._v(a) != self._v(b):
            raise EngineUnsatisfiedError(
                f"assert_is_equal: {self._v(a)} != {self._v(b)}"
            )

    def assert_is_different(self, a, b):
        if self._v(a) == self._v(b):
            raise EngineUnsatisfiedError("assert_is_different: values equal")

    def assert_is_boolean(self, a):
        self._bool(a)

    def assert_is_less_or_equal(self, v, bound):
        if self._v(v) > self._v(bound):
            raise EngineUnsatisfiedError(
                f"assert_is_less_or_equal: {self._v(v)} > {self._v(bound)}"
            )

    def constant_value(self, v):
        return self._v(v)

    # hints & logging
    def new_hint(self, hint_fn_or_id, nb_outputs: int, *inputs, static_args=()):
        fn = (
            hintlib.get_hint(hint_fn_or_id)
            if isinstance(hint_fn_or_id, int)
            else hint_fn_or_id
        )
        try:
            outs = fn(self.q, [self._v(x) for x in inputs] + list(static_args))
        except EngineUnsatisfiedError:
            raise
        except Exception as e:  # hint failure ⇒ witness unsolvable
            raise EngineUnsatisfiedError(f"hint failed: {e}") from e
        if len(outs) != nb_outputs:
            raise EngineUnsatisfiedError("hint output arity mismatch")
        return [o % self.q for o in outs]

    def commit(self, *vs):
        """Deterministic stand-in commitment — hash of the committed values,
        nonzero (≙ the reference test engine's Commit, test/engine.go:
        cSHAKE128 over the values with a 0→1 fallback)."""
        from ..backend.hash_to_field import hash_to_fr

        msg = b"".join(self._v(x).to_bytes(32, "big") for x in vs)
        v = hash_to_fr(msg, b"engine-commit", self.q)[0]
        return v if v != 0 else 1

    def defer_(self, cb):
        """Run cb(api) after define returns (≙ api.Compiler().Defer)."""
        from .compile import defer_circuit

        defer_circuit(self, cb)

    def println(self, *args):
        pass


def is_solved(circuit, modulus: int) -> bool:
    """Run define over the assignment with the engine (≙ test.IsSolved)."""
    try:
        check_solved(circuit, modulus)
        return True
    except EngineUnsatisfiedError:
        return False


def check_solved(circuit, modulus: int) -> None:
    """Like is_solved but raises with the failing assertion's message."""
    eng = Engine(modulus)
    inst = type(circuit).__new__(type(circuit))
    for decl in type(circuit)._inputs():
        v = getattr(circuit, decl.name, None)
        if v is None:
            raise ValueError(f"input {decl.name!r} not assigned")
        setattr(inst, decl.name, v)
    inst.define(eng)
    from .compile import _run_deferred

    _run_deferred(eng)
