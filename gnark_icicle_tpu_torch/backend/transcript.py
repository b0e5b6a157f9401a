"""Fiat-Shamir transcripts (gnark-crypto's, byte for byte).

A copy of gnark_icicle_tpu/backend/transcript.py: ``GnarkTranscript`` (:32),
``make_transcript`` (:149) and ``kzg_fold_challenge`` (:160). Challenges are
named and ordered; challenge_i's digest is
    H(name_i ∥ digest_{i-1 if i>0} ∥ bindings_i)
with SHA-256, and its field value is int(digest) mod q. Points are bound as
gnark-crypto's uncompressed bytes (``io/serialize.py``), field elements
big-endian in gnark-crypto's fr.Bytes: 32 bytes for the scalar fields of
BN254, BLS12-381 and BLS12-377, 48 for BW6-761's 377-bit r. The original
binds 32 bytes for every field (:54), which raises OverflowError for a
BW6-761 element above 2^256; the two agree byte for byte on every field of
at most 256 bits. The MiMC transcript (:105) needs ``std.hash.mimc``,
which the port has not copied yet: ``fs_hash="mimc"`` raises
NotImplementedError.
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


def make_transcript(modulus: int, names: list, fs_hash: str = "sha256"):
    """Transcript factory: "sha256" (gnark-byte-exact, default); "mimc"
    (the recursion-friendly transcript) is not ported yet."""
    if fs_hash == "sha256":
        return GnarkTranscript(modulus, names)
    if fs_hash == "mimc":
        raise NotImplementedError(
            "the MiMC transcript needs std.hash.mimc, which is not ported yet")
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
