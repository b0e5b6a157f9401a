"""Twisted Edwards curve over BN254 fr (Baby Jubjub) + EdDSA-MiMC (host).

Role parity: gnark-crypto's bn254/twistededwards + eddsa — the signature
scheme the reference's rollup example uses (examples/rollup/,
std/signature/eddsa). The curve: a·x² + y² = 1 + d·x²·y² over fr with the
standard Baby Jubjub parameters; EdDSA follows the same structure
(deterministic nonce, MiMC challenge, S·B == R + c·A) — self-consistent with
the in-circuit verifier in std/eddsa.py.

Copied from gnark_icicle_tpu/curves/twisted_edwards.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_std.py holds it to the original.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from .bn254 import R as FR_MOD
from ..std.hash.mimc import MiMCHost

# Baby Jubjub (twisted Edwards over BN254 fr), cofactor 8
A = 168700
D = 168696
ORDER = 21888242871839275222246405745257275088614511777268538073601725287587578984328
COFACTOR = 8
SUBGROUP_ORDER = ORDER // COFACTOR
# Base8 — generator of the prime-order subgroup
BASE = (
    5299619240641551281634865583518297030282874472190772894086521144482721001553,
    16950150798460657717958625567821834550301663161624707787222815936182638968203,
)

Q = FR_MOD


def add(p1, p2):
    """Complete twisted Edwards addition (unified for all inputs)."""
    x1, y1 = p1
    x2, y2 = p2
    dxy = D * x1 % Q * x2 % Q * y1 % Q * y2 % Q
    x3 = (x1 * y2 + y1 * x2) % Q * pow(1 + dxy, -1, Q) % Q
    y3 = (y1 * y2 - A * x1 % Q * x2) % Q * pow(1 - dxy, -1, Q) % Q
    return (x3, y3)


def scalar_mul(p, k: int):
    k %= ORDER
    result = (0, 1)  # identity
    addend = p
    while k:
        if k & 1:
            result = add(result, addend)
        addend = add(addend, addend)
        k >>= 1
    return result


def is_on_curve(p) -> bool:
    x, y = p
    return (A * x * x + y * y) % Q == (1 + D * x * x % Q * y % Q * y) % Q


@dataclass
class KeyPair:
    scalar: int  # secret
    public: tuple  # A = scalar·B


def generate_key(seed: bytes) -> KeyPair:
    s = int.from_bytes(hashlib.sha512(seed).digest(), "big") % SUBGROUP_ORDER
    if s == 0:
        s = 1
    return KeyPair(scalar=s, public=scalar_mul(BASE, s))


def _challenge(rx, ry, ax, ay, msg: int) -> int:
    h = MiMCHost(Q)
    h.write(rx, ry, ax, ay, msg)
    return h.h % SUBGROUP_ORDER


def sign(kp: KeyPair, msg: int):
    """(R, S): R = r·B with deterministic r; S = r + H(R,A,msg)·s."""
    r = int.from_bytes(
        hashlib.sha512(
            kp.scalar.to_bytes(32, "big") + int(msg).to_bytes(32, "big")
        ).digest(), "big",
    ) % SUBGROUP_ORDER
    if r == 0:
        r = 1
    R = scalar_mul(BASE, r)
    c = _challenge(R[0], R[1], kp.public[0], kp.public[1], msg)
    s = (r + c * kp.scalar) % SUBGROUP_ORDER
    return R, s


def verify(public, R, s: int, msg: int) -> bool:
    if not (is_on_curve(public) and is_on_curve(R)):
        return False
    c = _challenge(R[0], R[1], public[0], public[1], msg)
    lhs = scalar_mul(BASE, s)
    rhs = add(R, scalar_mul(public, c))
    return lhs == rhs
