"""Deterministic hashing to the G2 group (unknown-discrete-log points).

Role parity: gnark-crypto's ``curve.HashToG2`` as used by the MPC ceremony's
proof-of-knowledge binding (reference: backend/groth16/bn254/mpcsetup/
utils.go:159-170 genR — R = HashToG2(sG1 ‖ sxG1 ‖ challenge, dst)). The
reference maps via SVDW per RFC 9380; here the map is hash-and-check
(try-and-increment) over the sextic twist followed by cofactor clearing —
same security property for this use (deterministic, nobody knows dlog(R)),
not byte-compatible with gnark's SVDW output (documented divergence; the
ceremony verifies against its own transcripts).

Copied from gnark_icicle_tpu/curves/hash_to_g2.py:1, so that the port
imports nothing of the JAX package; tests/test_torch_mpcsetup.py holds it to
the original.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

from .tower import Fp2


def _sqrt_fp(a: int, p: int):
    assert p % 4 == 3
    r = pow(a, (p + 1) // 4, p)
    return r if r * r % p == a % p else None


def _sqrt_fp2(a: Fp2):
    p = a.tp.p
    if a.c1 == 0:
        r = _sqrt_fp(a.c0, p)
        if r is not None:
            return Fp2(a.tp, r, 0)
        r = _sqrt_fp((-a.c0) % p, p)
        return Fp2(a.tp, 0, r) if r is not None else None
    n = (a.c0 * a.c0 + a.c1 * a.c1) % p
    s = _sqrt_fp(n, p)
    if s is None:
        return None
    inv2 = pow(2, -1, p)
    t = (a.c0 + s) * inv2 % p
    x0 = _sqrt_fp(t, p)
    if x0 is None:
        t = (a.c0 - s) * inv2 % p
        x0 = _sqrt_fp(t, p)
        if x0 is None:
            return None
    x1 = a.c1 * pow(2 * x0, -1, p) % p
    return Fp2(a.tp, x0, x1)


def _raw_mul(group, pt, k: int):
    """k·pt WITHOUT reducing k mod the subgroup order — required for points
    of full twist order (group.scalar_mul's mod-order fast path is only
    valid inside the r-subgroup)."""
    if pt is None or k == 0:
        return None
    f = group.f
    acc = (f.one(), f.one(), f.zero())
    for bit in bin(k)[2:]:
        acc = group._jdouble(acc)
        if bit == "1":
            acc = group._jadd_affine(acc, pt)
    return group._to_affine(acc)


@lru_cache(maxsize=None)
def _twist_cofactor(curve) -> int:
    """#E'(Fp²)/r for the sextic twist, derived from the Frobenius trace and
    validated on the curve (the two sextic-twist orders are
    p² + 1 − (−3f − t²+2p)/... — we simply test the candidates)."""
    import math

    p = curve.fp.modulus
    r = curve.fr.modulus
    # Frobenius trace over Fp per family: BN has #E(Fp) = r (cofactor 1) so
    # t = p+1-r; BLS12 has t = x+1 (x the, possibly negative, seed)
    if curve.name.startswith("bn"):
        t = p + 1 - r
    elif curve.name.startswith("bls12"):
        t = curve.x_seed + 1
    else:
        raise NotImplementedError(f"trace formula for {curve.name}")
    t2 = t * t - 2 * p  # trace over Fp2
    f2 = (4 * p * p - t2 * t2) // 3
    f = math.isqrt(f2)
    assert f * f == f2, "trace discriminant not of CM form -3"
    candidates = [
        p * p + 1 - (-3 * f + t2) // 2,
        p * p + 1 - (3 * f + t2) // 2,
        p * p + 1 + (-3 * f + t2) // 2,
        p * p + 1 + (3 * f + t2) // 2,
        p * p + 1 + t2,
        p * p + 1 - t2,
    ]
    g2 = curve.g2
    # validate on a RAW curve point of full group order (the r-order
    # generator is annihilated by every multiple of r — useless as a probe)
    tp = curve.tower
    b = g2.b
    x = Fp2(tp, 3, 1)
    while True:
        y = _sqrt_fp2(x * x * x + b)
        if y is not None:
            probe = (x, y)
            break
        x = Fp2(tp, (x.c0 + 1) % p, x.c1)
    for n2 in candidates:
        if n2 % r == 0 and _raw_mul(g2, probe, n2) is None:
            return n2 // r
    raise AssertionError("no twist order candidate annihilates the twist")


def hash_to_g2(curve, msg: bytes, dst: bytes):
    """Map msg to an r-order G2 point nobody knows the dlog of."""
    p = curve.fp.modulus
    tp = curve.tower
    b = curve.g2.b  # twist b (Fp2)
    ctr = 0
    while True:
        h = hashlib.sha256(dst + len(dst).to_bytes(1, "big")
                           + ctr.to_bytes(4, "big") + msg)
        h2 = hashlib.sha256(b"\x01" + h.digest() + msg)
        x = Fp2(tp, int.from_bytes(h.digest(), "big") % p,
                int.from_bytes(h2.digest(), "big") % p)
        rhs = x * x * x + b
        y = _sqrt_fp2(rhs)
        if y is not None:
            # sign convention: take the lexicographically smaller y
            if (y.c1, y.c0) > (((-y).c1), ((-y).c0)):
                y = -y
            pt = (x, y)
            cleared = _raw_mul(curve.g2, pt, _twist_cofactor(curve))
            if cleared is not None:
                return cleared
        ctr += 1
