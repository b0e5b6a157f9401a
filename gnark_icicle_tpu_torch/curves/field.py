"""Host-side prime field helpers (pure Python big ints).

These play the role gnark-crypto's `fr.Element` / `fp.Element` play for the
reference's host code paths (witness solving, setup scalar math, verifier):
see SURVEY.md layer 8. Device math lives in `gnark_icicle_tpu_torch.ops.field`
as 32-bit-word Montgomery tensors; this module is the bit-exactness oracle
for it.

Copied from gnark_icicle_tpu/curves/field.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field


@dataclass(frozen=True)
class PrimeField:
    """A prime field q with the metadata the NTT/serialization layers need."""

    name: str
    modulus: int
    # largest s with 2^s | q-1
    two_adicity: int
    # smallest generator of the multiplicative group
    multiplicative_generator: int
    # number of bytes in gnark-crypto's big-endian serialization
    nb_bytes: int = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "nb_bytes", (self.modulus.bit_length() + 7) // 8)

    # ---- basic ops -------------------------------------------------------
    def add(self, a: int, b: int) -> int:
        return (a + b) % self.modulus

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.modulus

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.modulus

    def neg(self, a: int) -> int:
        return (-a) % self.modulus

    def inv(self, a: int) -> int:
        if a % self.modulus == 0:
            raise ZeroDivisionError("inverse of 0 in %s" % self.name)
        return pow(a, -1, self.modulus)

    def exp(self, a: int, e: int) -> int:
        return pow(a, e, self.modulus)

    def batch_inv(self, xs):
        """Montgomery batch inversion: n muls + 1 inversion."""
        q = self.modulus
        n = len(xs)
        prefix = [1] * (n + 1)
        for i, x in enumerate(xs):
            prefix[i + 1] = prefix[i] * (x if x % q else 1) % q
        inv = pow(prefix[n], -1, q)
        out = [0] * n
        for i in range(n - 1, -1, -1):
            if xs[i] % q == 0:
                out[i] = 0
            else:
                out[i] = inv * prefix[i] % q
                inv = inv * xs[i] % q
        return out

    # ---- roots of unity --------------------------------------------------
    def root_of_unity(self, log_n: int) -> int:
        """Primitive 2^log_n-th root of unity."""
        if log_n > self.two_adicity:
            raise ValueError(
                f"{self.name}: requested 2^{log_n} root; two-adicity is {self.two_adicity}"
            )
        g = pow(
            self.multiplicative_generator,
            (self.modulus - 1) >> self.two_adicity,
            self.modulus,
        )
        return pow(g, 1 << (self.two_adicity - log_n), self.modulus)

    # ---- serialization (gnark-crypto: fixed-width big-endian) ------------
    def to_bytes(self, a: int) -> bytes:
        return (a % self.modulus).to_bytes(self.nb_bytes, "big")

    def from_bytes(self, b: bytes) -> int:
        v = int.from_bytes(b, "big")
        if v >= self.modulus:
            raise ValueError("non-canonical field element encoding")
        return v

    # ---- hashing to field (RFC 9380 expand_message_xmd / SHA-256) --------
    def hash_to_field(self, msg: bytes, dst: bytes, count: int = 1):
        """hash-to-field per RFC 9380 §5 with expand_message_xmd(SHA-256).

        Matches the construction gnark uses for commitment challenge
        derivation (reference: backend/groth16/bn254/verify.go:54-56 uses
        gnark-crypto's fr.Hash which is RFC9380 hash_to_field, L = 48).
        """
        L = ((self.modulus.bit_length() + 128) + 7) // 8  # security parameter pad
        n = count * L
        pseudo = _expand_message_xmd(msg, dst, n)
        return [
            int.from_bytes(pseudo[i * L : (i + 1) * L], "big") % self.modulus
            for i in range(count)
        ]


def _expand_message_xmd(msg: bytes, dst: bytes, length: int) -> bytes:
    h = hashlib.sha256
    b_in_bytes = 32
    ell = -(-length // b_in_bytes)
    if ell > 255 or length > 65535 or len(dst) > 255:
        raise ValueError("expand_message_xmd parameter out of range")
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = b"\x00" * 64  # SHA-256 block size
    l_i_b = length.to_bytes(2, "big")
    b0 = h(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    b1 = h(b0 + b"\x01" + dst_prime).digest()
    out = [b1]
    for i in range(2, ell + 1):
        prev = out[-1]
        tmp = bytes(x ^ y for x, y in zip(b0, prev))
        out.append(h(tmp + i.to_bytes(1, "big") + dst_prime).digest())
    return b"".join(out)[:length]
