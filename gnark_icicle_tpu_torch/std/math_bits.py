"""Bit-manipulation gadgets (≙ reference std/math/bits + std/math/uints).

Words are little-endian bit lists (the api.to_binary convention); the U32/U64
helpers model fixed-width unsigned words with the operations hash circuits
need (xor/and/not/rotations/shifts/modular add) — the uints API the
reference's sha2/keccak gadgets build on.

Copied from gnark_icicle_tpu/std/math_bits.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_precompiles.py holds it to the original.
"""

from __future__ import annotations


def rotate_left(bits: list, k: int) -> list:
    """Little-endian bit list rotated left by k (value · 2^k mod 2^n − wrap)."""
    n = len(bits)
    k %= n
    # value bit i moves to position (i + k) mod n
    return [bits[(i - k) % n] for i in range(n)]


def rotate_right(bits: list, k: int) -> list:
    return rotate_left(bits, -(k % len(bits)))


def shift_left(bits: list, k: int) -> list:
    """Logical shift left by k (low bits zero-filled, width preserved)."""
    n = len(bits)
    k = min(k, n)
    return [0] * k + bits[: n - k]


def shift_right(bits: list, k: int) -> list:
    n = len(bits)
    k = min(k, n)
    return bits[k:] + [0] * k


def xor_bits(api, a: list, b: list) -> list:
    return [api.xor(x, y) for x, y in zip(a, b)]


def and_bits(api, a: list, b: list) -> list:
    return [api.and_(x, y) for x, y in zip(a, b)]


def not_bits(api, a: list) -> list:
    return [api.sub(1, x) for x in a]


class UWord:
    """Fixed-width unsigned word as bits (≙ uints.U32/U64)."""

    def __init__(self, api, bits: list):
        self.api = api
        self.bits = list(bits)

    @classmethod
    def from_var(cls, api, v, width: int) -> "UWord":
        return cls(api, api.to_binary(v, width))

    @classmethod
    def constant(cls, api, value: int, width: int) -> "UWord":
        return cls(api, [(value >> i) & 1 for i in range(width)])

    @property
    def width(self) -> int:
        return len(self.bits)

    def value(self):
        return self.api.from_binary(self.bits)

    def xor(self, other: "UWord") -> "UWord":
        return UWord(self.api, xor_bits(self.api, self.bits, other.bits))

    def and_(self, other: "UWord") -> "UWord":
        return UWord(self.api, and_bits(self.api, self.bits, other.bits))

    def not_(self) -> "UWord":
        return UWord(self.api, not_bits(self.api, self.bits))

    def ror(self, k: int) -> "UWord":
        return UWord(self.api, rotate_right(self.bits, k))

    def rol(self, k: int) -> "UWord":
        return UWord(self.api, rotate_left(self.bits, k))

    def shr(self, k: int) -> "UWord":
        return UWord(self.api, shift_right(self.bits, k))

    def add(self, *others: "UWord") -> "UWord":
        """Modular 2^width addition: sum the values, decompose wide, truncate
        (≙ uints.Add — the sha2 word add)."""
        api = self.api
        total = self.value()
        for o in others:
            total = api.add(total, o.value())
        slack = (len(others) + 1).bit_length()
        wide = api.to_binary(total, self.width + slack)
        return UWord(api, wide[: self.width])
