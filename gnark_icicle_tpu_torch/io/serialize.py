"""gnark-crypto wire formats: points, proofs, keys, witnesses.

Role parity: reference per-curve marshal.go (backend/groth16/bn254/marshal.go
— proof order Ar|Bs|Krs|commitments|PoK at :44-69, VK bellman-style order
[α]1,[β]1,[β]2,[γ]2,[δ]1,[δ]2,K at :110-159) and the witness binary protocol
[nbPublic|nbSecret|fr.Vector] (backend/witness/witness.go:15-96).

Point encoding is gnark-crypto's (bn254): fixed-width big-endian coordinates
with 2-bit flags in the most significant byte —
    0b00 << 6  uncompressed
    0b10 << 6  compressed, y lexicographically smallest
    0b11 << 6  compressed, y lexicographically largest
    0b01 << 6  compressed point at infinity
G2 (Fp2) coordinates serialize imaginary-part-first (A1 ‖ A0); flags live on
the first byte. Field elements are canonical big-endian, 32 bytes for bn254.

Copied whole from gnark_icicle_tpu/io/serialize.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_io.py holds it to the original. ``g1_to_bytes`` is
the one ``backend/transcript.py`` binds with. Its limits are the original's: a G2
point must lie over Fp2 (a BW6-761 proof does not encode), and a compressed point
decodes only where p ≡ 3 (mod 4) (not BLS12-377's).
"""

from __future__ import annotations

import struct

from ..curves.tower import Fp2

M_MASK = 0b11 << 6
M_UNCOMPRESSED = 0b00 << 6
M_COMPRESSED_SMALLEST = 0b10 << 6
M_COMPRESSED_LARGEST = 0b11 << 6
M_COMPRESSED_INFINITY = 0b01 << 6


class _FlagScheme:
    """Per-curve msb flag layout (gnark-crypto marshal.go constants).

    Most curves use the 2-bit gnark scheme (mask 0b11<<6). BLS12-381 uses
    a 3-bit scheme matching the zcash/ETH2 serialization (gnark-crypto
    ecc/bls12-381/marshal.go: mMask 0b111<<5, compressed bit 0x80,
    infinity 0x40, lexicographically-largest 0x20) — caught by the REAL
    bellman fixtures (backend/groth16/bellman_test.go), whose points our
    former 2-bit decode rejected as non-canonical."""

    def __init__(self, mask, unc, unc_inf, small, large, inf):
        self.mask = mask
        self.unc = unc
        self.unc_inf = unc_inf  # None = uncompressed infinity is all-zero
        self.small = small
        self.large = large
        self.inf = inf


_SCHEME_GNARK = _FlagScheme(
    0b11 << 6, 0b00 << 6, None, 0b10 << 6, 0b11 << 6, 0b01 << 6
)
_SCHEME_ZCASH = _FlagScheme(
    0b111 << 5, 0b000 << 5, 0b010 << 5, 0b100 << 5, 0b101 << 5, 0b110 << 5
)


def _scheme(curve) -> _FlagScheme:
    return _SCHEME_ZCASH if curve.name == "bls12-381" else _SCHEME_GNARK


def _fp_bytes(v: int, nb: int) -> bytes:
    return int(v).to_bytes(nb, "big")


def _sqrt_fp(a: int, p: int) -> int | None:
    """Square root mod p ≡ 3 (mod 4) (both our curves' fp qualify)."""
    assert p % 4 == 3
    r = pow(a, (p + 1) // 4, p)
    return r if r * r % p == a % p else None


def _sqrt_fp2(a: Fp2) -> Fp2 | None:
    """Square root in Fp2 = Fp[u]/(u²+1) via the norm trick."""
    p = a.tp.p
    if a.c1 == 0:
        r = _sqrt_fp(a.c0, p)
        if r is not None:
            return Fp2(a.tp, r, 0)
        r = _sqrt_fp((-a.c0) % p, p)
        return Fp2(a.tp, 0, r) if r is not None else None
    n = (a.c0 * a.c0 + a.c1 * a.c1) % p  # norm (u² = −1)
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


def _lex_largest_fp(y: int, p: int) -> bool:
    return y > (p - 1) // 2


def _lex_largest_fp2(y: Fp2) -> bool:
    p = y.tp.p
    if y.c1 != 0:
        return _lex_largest_fp(y.c1, p)
    return _lex_largest_fp(y.c0, p)


# ---------------------------------------------------------------------------
# G1
# ---------------------------------------------------------------------------

def g1_to_bytes(curve, pt, compressed: bool = True) -> bytes:
    nb = curve.fp.nb_bytes
    s = _scheme(curve)
    if compressed:
        if pt is None:
            return bytes([s.inf]) + bytes(nb - 1)
        x, y = pt
        flag = (
            s.large if _lex_largest_fp(y, curve.fp.modulus) else s.small
        )
        b = bytearray(_fp_bytes(x, nb))
        b[0] |= flag
        return bytes(b)
    if pt is None:
        if s.unc_inf is not None:
            return bytes([s.unc_inf]) + bytes(2 * nb - 1)
        return bytes(2 * nb)
    return _fp_bytes(pt[0], nb) + _fp_bytes(pt[1], nb)


def g1_from_bytes(curve, data: bytes, offset: int = 0):
    """Returns (point, bytes_consumed). Auto-detects compression by flags."""
    nb = curve.fp.nb_bytes
    p = curve.fp.modulus
    s = _scheme(curve)
    flag = data[offset] & s.mask
    if flag == s.unc or flag == s.unc_inf:
        x = int.from_bytes(data[offset : offset + nb], "big")
        y = int.from_bytes(data[offset + nb : offset + 2 * nb], "big")
        if flag == s.unc_inf:  # explicit uncompressed-infinity flag
            return None, 2 * nb
        if x == 0 and y == 0:
            return None, 2 * nb
        if x >= p or y >= p:  # ≙ gnark-crypto SetBytes canonicality
            raise ValueError("G1 coordinate not canonical (>= p)")
        pt = (x, y)
        if not curve.g1.is_on_curve(pt):
            raise ValueError("G1 point not on curve")
        return pt, 2 * nb
    if flag == s.inf:
        return None, nb
    if flag not in (s.small, s.large):
        raise ValueError(f"invalid G1 encoding flag {flag:#x}")
    xb = bytearray(data[offset : offset + nb])
    xb[0] &= ~s.mask & 0xFF
    x = int.from_bytes(bytes(xb), "big")
    if x >= p:
        raise ValueError("G1 coordinate not canonical (>= p)")
    y2 = (pow(x, 3, p) + curve.g1.b) % p
    y = _sqrt_fp(y2, p)
    if y is None:
        raise ValueError("invalid compressed G1 point")
    if _lex_largest_fp(y, p) != (flag == s.large):
        y = (-y) % p
    return (x, y), nb


# ---------------------------------------------------------------------------
# G2
# ---------------------------------------------------------------------------

def g2_to_bytes(curve, pt, compressed: bool = True) -> bytes:
    if curve.name == "bls24-315":
        raise NotImplementedError(
            "bls24-315 G2 (Fp4 coordinates) has no byte serialization — "
            "gnark-crypto's encoding is not derivable from the reference "
            "tree (PARITY.md memo); proofs stay in-memory/pickled"
        )
    nb = curve.fp.nb_bytes
    s = _scheme(curve)
    if compressed:
        if pt is None:
            return bytes([s.inf]) + bytes(2 * nb - 1)
        x, y = pt
        flag = s.large if _lex_largest_fp2(y) else s.small
        b = bytearray(_fp_bytes(x.c1, nb) + _fp_bytes(x.c0, nb))
        b[0] |= flag
        return bytes(b)
    if pt is None:
        if s.unc_inf is not None:
            return bytes([s.unc_inf]) + bytes(4 * nb - 1)
        return bytes(4 * nb)
    x, y = pt
    return (
        _fp_bytes(x.c1, nb) + _fp_bytes(x.c0, nb)
        + _fp_bytes(y.c1, nb) + _fp_bytes(y.c0, nb)
    )


def g2_from_bytes(curve, data: bytes, offset: int = 0):
    nb = curve.fp.nb_bytes
    tp = curve.tower
    s = _scheme(curve)
    flag = data[offset] & s.mask
    p = curve.fp.modulus
    if flag == s.unc or flag == s.unc_inf:
        vals = [
            int.from_bytes(data[offset + i * nb : offset + (i + 1) * nb], "big")
            for i in range(4)
        ]
        if flag == s.unc_inf:
            return None, 4 * nb
        if all(v == 0 for v in vals):
            return None, 4 * nb
        if any(v >= p for v in vals):
            raise ValueError("G2 coordinate not canonical (>= p)")
        x = Fp2(tp, vals[1], vals[0])
        y = Fp2(tp, vals[3], vals[2])
        pt = (x, y)
        if not curve.g2.is_on_curve(pt):
            raise ValueError("G2 point not on curve")
        return pt, 4 * nb
    if flag == s.inf:
        return None, 2 * nb
    if flag not in (s.small, s.large):
        raise ValueError(f"invalid G2 encoding flag {flag:#x}")
    xb = bytearray(data[offset : offset + 2 * nb])
    xb[0] &= ~s.mask & 0xFF
    x1 = int.from_bytes(bytes(xb[:nb]), "big")
    x0 = int.from_bytes(bytes(xb[nb:]), "big")
    if x0 >= p or x1 >= p:
        raise ValueError("G2 coordinate not canonical (>= p)")
    x = Fp2(tp, x0, x1)
    y2 = x * x * x + curve.g2.b
    y = _sqrt_fp2(y2)
    if y is None:
        raise ValueError("invalid compressed G2 point")
    if _lex_largest_fp2(y) != (flag == s.large):
        y = -y
    return (x, y), 2 * nb


# ---------------------------------------------------------------------------
# proof / vk  (gnark groth16 bn254 marshal.go order)
# ---------------------------------------------------------------------------

def proof_to_bytes(curve, proof, compressed: bool = True) -> bytes:
    """Ar | Bs | Krs | uint32 nbCommitments | commitments | PoK
    (marshal.go:44-69)."""
    out = bytearray()
    out += g1_to_bytes(curve, proof.ar, compressed)
    out += g2_to_bytes(curve, proof.bs, compressed)
    out += g1_to_bytes(curve, proof.krs, compressed)
    commitments = getattr(proof, "commitments", []) or []
    out += struct.pack(">I", len(commitments))
    for cm in commitments:
        out += g1_to_bytes(curve, cm, compressed)
    out += g1_to_bytes(curve, getattr(proof, "commitment_pok", None),
                       compressed)
    return bytes(out)


def proof_from_bytes(curve, data: bytes):
    from ..backend.groth16.keys import Proof

    off = 0
    ar, n = g1_from_bytes(curve, data, off)
    off += n
    bs, n = g2_from_bytes(curve, data, off)
    off += n
    krs, n = g1_from_bytes(curve, data, off)
    off += n
    (nb_comm,) = struct.unpack_from(">I", data, off)
    off += 4
    commitments = []
    for _ in range(nb_comm):
        cm, n = g1_from_bytes(curve, data, off)
        commitments.append(cm)
        off += n
    pok, n = g1_from_bytes(curve, data, off)  # PoK
    off += n
    return Proof(ar=ar, krs=krs, bs=bs, commitments=commitments,
                 commitment_pok=pok), off


def vk_to_bytes(curve, vk, compressed: bool = True) -> bytes:
    """Bellman-style [α]1,[β]1,[β]2,[γ]2,[δ]1,[δ]2,K… (marshal.go:110-159).

    [β]1/[δ]1 are not used by our verifier; they serialize as infinity when
    absent (gnark keeps them for recursion-friendly VKs).
    """
    out = bytearray()
    out += g1_to_bytes(curve, vk.g1_alpha, compressed)
    out += g1_to_bytes(curve, getattr(vk, "g1_beta", None), compressed)
    out += g2_to_bytes(curve, vk.g2_beta, compressed)
    out += g2_to_bytes(curve, vk.g2_gamma, compressed)
    out += g1_to_bytes(curve, getattr(vk, "g1_delta", None), compressed)
    out += g2_to_bytes(curve, vk.g2_delta, compressed)
    out += struct.pack(">I", len(vk.g1_k))
    for pt in vk.g1_k:
        out += g1_to_bytes(curve, pt, compressed)
    # PublicAndCommitmentCommitted as [][]uint64 then the pedersen VKs
    # (marshal.go:110-159 trailing section)
    pacc = getattr(vk, "public_and_commitment_committed", []) or []
    out += struct.pack(">I", len(pacc))
    for inner in pacc:
        out += struct.pack(">I", len(inner))
        for idx in inner:
            out += struct.pack(">Q", idx)
    cks = getattr(vk, "commitment_keys", []) or []
    out += struct.pack(">I", len(cks))
    for ck in cks:
        out += g2_to_bytes(curve, ck.g, compressed)
        out += g2_to_bytes(curve, ck.g_sigma_neg, compressed)
    return bytes(out)


def vk_from_bytes(curve, data: bytes):
    from ..backend.groth16.keys import VerifyingKey

    off = 0
    g1_alpha, n = g1_from_bytes(curve, data, off); off += n
    _g1_beta, n = g1_from_bytes(curve, data, off); off += n
    g2_beta, n = g2_from_bytes(curve, data, off); off += n
    g2_gamma, n = g2_from_bytes(curve, data, off); off += n
    _g1_delta, n = g1_from_bytes(curve, data, off); off += n
    g2_delta, n = g2_from_bytes(curve, data, off); off += n
    (k_len,) = struct.unpack_from(">I", data, off); off += 4
    g1_k = []
    for _ in range(k_len):
        pt, n = g1_from_bytes(curve, data, off)
        g1_k.append(pt)
        off += n
    # trailing: PublicAndCommitmentCommitted ([][]uint64) + commitment keys
    (pacc_len,) = struct.unpack_from(">I", data, off); off += 4
    pacc = []
    for _ in range(pacc_len):
        (inner,) = struct.unpack_from(">I", data, off); off += 4
        row = []
        for _ in range(inner):
            (idx,) = struct.unpack_from(">Q", data, off); off += 8
            row.append(int(idx))
        pacc.append(row)
    (nb_ck,) = struct.unpack_from(">I", data, off); off += 4
    cks = []
    if nb_ck:
        from ..backend.pedersen import PedersenVerifyingKey

        for _ in range(nb_ck):
            g, n = g2_from_bytes(curve, data, off); off += n
            gsn, n = g2_from_bytes(curve, data, off); off += n
            cks.append(PedersenVerifyingKey(g=g, g_sigma_neg=gsn))
    vk = VerifyingKey(
        g1_alpha=g1_alpha, g2_beta=g2_beta, g2_gamma=g2_gamma,
        g2_delta=g2_delta, g1_k=g1_k, nb_public=k_len - nb_ck,
        commitment_keys=cks, public_and_commitment_committed=pacc,
    )
    return vk, off


# ---------------------------------------------------------------------------
# witness  (backend/witness/witness.go binary protocol + JSON form)
# ---------------------------------------------------------------------------

def witness_to_json(cs, public_values, secret_values=None) -> str:
    """Named JSON witness (≙ witness.ToJSON via the schema; names come from
    the compiled system's public/secret name lists)."""
    import json

    names_pub = cs.public_names[1:] if cs.public_names[:1] == ["one"] \
        else cs.public_names
    out = {
        "public": {n: str(v) for n, v in zip(names_pub, public_values)},
    }
    if secret_values is not None:
        out["secret"] = {
            n: str(v) for n, v in zip(cs.secret_names, secret_values)
        }
    return json.dumps(out, indent=2)


def witness_from_json(text: str):
    """-> (public_values, secret_values) in declaration order."""
    import json

    obj = json.loads(text)
    pub = [int(v) for v in obj.get("public", {}).values()]
    sec = [int(v) for v in obj.get("secret", {}).values()]
    return pub, sec


def witness_to_bytes(curve, public_values, secret_values=None) -> bytes:
    """uint32 nbPublic | uint32 nbSecret | uint32 len | elements (32B BE).

    public_values excludes the ONE wire (gnark witnesses never contain it).
    """
    fr = curve.fr
    secret_values = secret_values or []
    out = bytearray()
    out += struct.pack(">I", len(public_values))
    out += struct.pack(">I", len(secret_values))
    vec = list(public_values) + list(secret_values)
    out += struct.pack(">I", len(vec))
    for v in vec:
        out += fr.to_bytes(int(v) % fr.modulus)
    return bytes(out)


def witness_from_bytes(curve, data: bytes):
    """-> (public_values, secret_values)."""
    fr = curve.fr
    nb_pub, nb_sec, ln = struct.unpack_from(">III", data, 0)
    if ln != nb_pub + nb_sec:
        raise ValueError("witness vector length mismatch")
    off = 12
    vals = []
    for _ in range(ln):
        vals.append(fr.from_bytes(data[off : off + fr.nb_bytes]))
        off += fr.nb_bytes
    return vals[:nb_pub], vals[nb_pub:]
