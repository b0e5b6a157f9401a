"""Fiat-Shamir transcripts (gnark-crypto's, byte for byte).

A copy of gnark_icicle_tpu/backend/transcript.py: ``GnarkTranscript`` (:32),
``point_limbs`` (:78), ``MiMCTranscript`` (:105, over the port's
``std/hash/mimc.py``), ``make_transcript`` (:149) and ``kzg_fold_challenge``
(:160). Challenges are
named and ordered; challenge_i's digest is
    H(name_i ∥ digest_{i-1 if i>0} ∥ bindings_i)
with SHA-256, and its field value is int(digest) mod q. Points are bound as
gnark-crypto's uncompressed bytes (``io/serialize.py``), field elements
big-endian in gnark-crypto's fr.Bytes: 32 bytes for the scalar fields of
BN254, BLS12-381 and BLS12-377, 48 for BW6-761's 377-bit r. The original
binds 32 bytes for every field (:54), which raises OverflowError for a
BW6-761 element above 2^256; the two agree byte for byte on every field of
at most 256 bits. The MiMC transcript binds field elements, so it has no
such width.
"""

from __future__ import annotations

import hashlib


class GnarkTranscript:
    """gnark-crypto fiat-shamir transcript (SHA-256), byte-exact."""

    def __init__(self, modulus: int, names: list):
        self.q = modulus
        self.fr_bytes = max(32, (modulus.bit_length() + 7) // 8)
        self.names = [n if isinstance(n, bytes) else n.encode() for n in names]
        self._bindings = {n: bytearray() for n in self.names}
        self._digests: dict = {}
        self._next_pos = 0

    def bind(self, name, data: bytes):
        name = name if isinstance(name, bytes) else name.encode()
        if name in self._digests:
            raise ValueError(f"challenge {name!r} already computed")
        self._bindings[name].extend(data)

    def bind_point(self, name, curve, pt):
        from ..io.serialize import g1_to_bytes

        self.bind(name, g1_to_bytes(curve, pt, compressed=False))

    def bind_fr(self, name, v: int):
        self.bind(name, int(v % self.q).to_bytes(self.fr_bytes, "big"))

    def challenge(self, name) -> int:
        name = name if isinstance(name, bytes) else name.encode()
        if name in self._digests:
            return int.from_bytes(self._digests[name], "big") % self.q
        pos = self.names.index(name)
        if pos != self._next_pos:
            raise ValueError(f"challenge {name!r} out of order")
        h = hashlib.sha256()
        h.update(name)
        if pos > 0:
            h.update(self._digests[self.names[pos - 1]])
        h.update(bytes(self._bindings[name]))
        d = h.digest()
        self._digests[name] = d
        self._next_pos = pos + 1
        return int.from_bytes(d, "big") % self.q


FS_LIMB_BITS = 64  # must match std/emulated BN254_FP (w=64, k=4)


def point_limbs(curve, pt, n_limbs: int | None = None) -> list:
    """A G1 point as 2·k field elements: k little-endian 64-bit limbs of
    each canonical affine coordinate (infinity → all zeros), k sized to
    the curve's base field (4 for BN254, 6 for BLS12-381 — matching the
    std/emulated presets) so NO coordinate bits escape the Fiat-Shamir
    binding. This is exactly how the recursion verifier absorbs an
    emulated point witness — its reduced limb variables — so host and
    gadget transcripts agree. curve=None (the BN254 recursion callers)
    defaults to 4 limbs."""
    k = n_limbs or (
        (curve.fp.modulus.bit_length() + FS_LIMB_BITS - 1) // FS_LIMB_BITS
        if curve is not None else 4
    )
    if pt is None:
        return [0] * (2 * k)
    mask = (1 << FS_LIMB_BITS) - 1
    out = []
    for c in (pt[0], pt[1]):
        c = int(c)
        out.extend((c >> (FS_LIMB_BITS * i)) & mask for i in range(k))
    return out


def name_tag(name, q: int) -> int:
    name = name if isinstance(name, bytes) else name.encode()
    return int.from_bytes(name, "big") % q


class MiMCTranscript:
    """Fr-friendly transcript with the SAME named-challenge schedule as
    GnarkTranscript (challenge = MiMC(tag, prev?, bindings...)); used by
    recursion-friendly proofs so the outer circuit replays challenges
    natively (≙ recursion.NewShort hash swap)."""

    def __init__(self, modulus: int, names: list):
        self.q = modulus
        self.names = [n if isinstance(n, bytes) else n.encode() for n in names]
        self._bindings = {n: [] for n in self.names}
        self._values: dict = {}
        self._next_pos = 0

    def bind_fr(self, name, v: int):
        name = name if isinstance(name, bytes) else name.encode()
        if name in self._values:
            raise ValueError(f"challenge {name!r} already computed")
        self._bindings[name].append(int(v) % self.q)

    def bind_point(self, name, curve, pt):
        for limb in point_limbs(curve, pt):
            self.bind_fr(name, limb)

    def challenge(self, name) -> int:
        from ..std.hash.mimc import MiMCHost

        name = name if isinstance(name, bytes) else name.encode()
        if name in self._values:
            return self._values[name]
        pos = self.names.index(name)
        if pos != self._next_pos:
            raise ValueError(f"challenge {name!r} out of order")
        h = MiMCHost(self.q)
        h.write(name_tag(name, self.q))
        if pos > 0:
            h.write(self._values[self.names[pos - 1]])
        for v in self._bindings[name]:
            h.write(v)
        c = h.h
        self._values[name] = c
        self._next_pos = pos + 1
        return c


def make_transcript(modulus: int, names: list, fs_hash: str = "sha256"):
    """Transcript factory: "sha256" (gnark-byte-exact, default) or "mimc"
    (Fr-friendly — what recursion provers use so the outer circuit can
    replay the challenges natively)."""
    if fs_hash == "sha256":
        return GnarkTranscript(modulus, names)
    if fs_hash == "mimc":
        return MiMCTranscript(modulus, names)
    raise ValueError(f"unknown fs_hash {fs_hash!r}")


def kzg_fold_challenge(fs_hash: str, curve, q: int, point: int, digests,
                       claimed_values, data_tail: int | None = None) -> int:
    """The batched-KZG fold challenge γ (≙ gnark-crypto kzg.deriveGamma,
    called from BatchOpenSinglePoint / FoldProof with the shifted opening's
    claimed value as extra transcript data, prove.go:757-764): a fresh
    one-challenge transcript binding the evaluation point, every digest,
    every claimed value, then the extra data."""
    ts = make_transcript(q, [b"gamma"], fs_hash)
    ts.bind_fr(b"gamma", point)
    for d in digests:
        ts.bind_point(b"gamma", curve, d)
    for v in claimed_values:
        ts.bind_fr(b"gamma", v)
    if data_tail is not None:
        ts.bind_fr(b"gamma", data_tail)
    return ts.challenge(b"gamma")
