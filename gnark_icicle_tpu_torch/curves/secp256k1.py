"""secp256k1 host curve + ECDSA sign/verify (test-vector source).

Role parity: gnark-crypto's ecdsa package as used by the reference's
std/signature/ecdsa tests (std/signature/ecdsa/ecdsa_test.go signs with
gnark-crypto and verifies in-circuit). Host-side only — the in-circuit
verifier is std/ecdsa.py over std/sw_emulated.py.

Copied from gnark_icicle_tpu/curves/secp256k1.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_precompiles.py holds it to the original.
"""

from __future__ import annotations

import hashlib
import hmac

from .ec import ECGroup, FpOps

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

_fp = FpOps(P)
G1 = ECGroup(_fp, 7, (GX, GY), N, name="secp256k1")


def keygen(rng):
    """(secret scalar, public point)."""
    d = rng.randrange(1, N)
    return d, G1.scalar_mul(G1.generator, d)


def _rfc6979_k(d: int, h: int) -> int:
    """Deterministic nonce (RFC 6979, SHA-256) — keeps test vectors stable."""
    holen = 32
    x = d.to_bytes(32, "big")
    m = (h % N).to_bytes(32, "big")
    v = b"\x01" * holen
    k = b"\x00" * holen
    k = hmac.new(k, v + b"\x00" + x + m, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + m, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(d: int, msg_hash: int) -> tuple:
    """(r, s) ECDSA signature over the hash value."""
    h = msg_hash % N
    while True:
        k = _rfc6979_k(d, msg_hash)
        R = G1.scalar_mul(G1.generator, k)
        r = R[0] % N
        if r == 0:
            msg_hash += 1
            continue
        s = pow(k, -1, N) * (h + r * d) % N
        if s == 0:
            msg_hash += 1
            continue
        return r, s


def verify(pub, msg_hash: int, sig: tuple) -> bool:
    r, s = sig
    if not (1 <= r < N and 1 <= s < N):
        return False
    if not G1.is_on_curve(pub):
        return False
    h = msg_hash % N
    si = pow(s, -1, N)
    u1 = h * si % N
    u2 = r * si % N
    R = G1.add(
        G1.scalar_mul(G1.generator, u1), G1.scalar_mul(pub, u2)
    )
    if R is None:
        return False
    return R[0] % N == r
