"""Bounded comparison gadgets with low constraint counts.

Role parity: reference std/math/cmp (bounded.go BoundedComparator — signed
comparison of a, b when |a − b| ≤ absDiffUpp is known; every method costs one
binary decomposition of absDiffUppBitLen bits; generic.go IsLess/Min via the
same machinery at full width).

Copied from gnark_icicle_tpu/std/math_cmp.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_emulated.py holds it to the original.
"""

from __future__ import annotations

from ..constraint import hints as hintlib


def _is_less_output_hint(q, inputs):
    """(a, b) -> 1 if a < b else 0, comparing the canonical residues
    (≙ isLessOutputHint)."""
    a, b = inputs[0] % q, inputs[1] % q
    return [1 if a < b else 0]


IS_LESS_OUTPUT = hintlib.register_hint(_is_less_output_hint, "cmp.is_less")


class BoundedComparator:
    """≙ cmp.NewBoundedComparator(api, absDiffUpp, allowEqual).

    Methods are sound iff |a − b| ≤ abs_diff_upp for the compared values;
    the bound is enforced by the single n-bit decomposition each performs.
    """

    def __init__(self, api, abs_diff_upp: int):
        assert abs_diff_upp >= 1
        self.api = api
        self.n_bits = abs_diff_upp.bit_length()

    def assert_is_less_eq(self, a, b):
        """a ≤ b: b − a decomposes in n_bits bits (no wraparound within the
        bound)."""
        self.api.to_binary(self.api.sub(b, a), self.n_bits)

    def assert_is_less(self, a, b):
        """a < b ⟺ a ≤ b − 1."""
        self.assert_is_less_eq(self.api.add(a, 1), b)

    def is_less(self, a, b):
        """Boolean a < b via the output hint + a bounded check of the claim
        (≙ bounded.go IsLess): if out then a < b else b ≤ a."""
        api = self.api
        (out,) = api.new_hint(IS_LESS_OUTPUT, 1, a, b)
        api.assert_is_boolean(out)
        # out=1 → b−a−1 ≥ 0; out=0 → a−b ≥ 0. One decomposition of the
        # selected difference.
        diff = api.select(out, api.sub(b, a, 1), api.sub(a, b))
        api.to_binary(diff, self.n_bits)
        return out

    def is_less_eq(self, a, b):
        return self.api.sub(1, self.is_less(b, a))

    def min_(self, a, b):
        """min(a, b) (≙ bounded.go Min)."""
        return self.api.select(self.is_less(a, b), a, b)

    def max_(self, a, b):
        return self.api.select(self.is_less(a, b), b, a)
