"""PLONK proof / verifying-key serialization.

Role parity: reference backend/plonk/bn254/marshal.go. The proof follows
gnark's WriteTo field order exactly (marshal.go:36-61): LRO[0..2], Z,
H[0..2], BatchedProof.H, ClaimedValues (uint32 length + fr vector),
ZShiftedOpening.H, ClaimedValue, Bsb22Commitments (uint32 length +
points) — points in gnark-crypto encoding, field elements 32-byte
big-endian. The vk keeps the framework's own deterministic layout.

Copied whole from gnark_icicle_tpu/io/plonk_serialize.py:1 (``plonk_proof_to_bytes``/
``_from_bytes`` :21/:37, ``plonk_vk_to_bytes``/``_from_bytes`` :72/:88), over the port's
``backend/plonk/keys.py`` dataclasses; tests/test_torch_io.py holds it to the
original. The JAX package has no PLONK proving-key encoding, and neither has the port.
"""

from __future__ import annotations

import struct

from .serialize import g1_to_bytes, g1_from_bytes, g2_to_bytes, g2_from_bytes
from ..backend.plonk.keys import Proof, VerifyingKey

_VK_NAMES = ("ql", "qr", "qm", "qo", "qk", "s1", "s2", "s3")


def plonk_proof_to_bytes(curve, proof: Proof, compressed: bool = True) -> bytes:
    fr = curve.fr
    out = bytearray()
    for pt in (*proof.lro, proof.z_com, *proof.h_coms, proof.batch_h):
        out += g1_to_bytes(curve, pt, compressed)
    out += struct.pack(">I", len(proof.batch_claimed))
    for v in proof.batch_claimed:
        out += fr.to_bytes(v)
    out += g1_to_bytes(curve, proof.z_shifted_h, compressed)
    out += fr.to_bytes(proof.z_shifted_claimed)
    out += struct.pack(">I", len(proof.bsb22_commitments))
    for pt in proof.bsb22_commitments:
        out += g1_to_bytes(curve, pt, compressed)
    return bytes(out)


def plonk_proof_from_bytes(curve, data: bytes):
    fr = curve.fr
    off = 0
    pts = []
    for _ in range(8):  # LRO, Z, H x3, BatchedProof.H
        pt, n = g1_from_bytes(curve, data, off)
        pts.append(pt)
        off += n
    (nb_cv,) = struct.unpack_from(">I", data, off)
    off += 4
    claimed = []
    for _ in range(nb_cv):
        claimed.append(fr.from_bytes(data[off : off + fr.nb_bytes]))
        off += fr.nb_bytes
    z_shifted_h, n = g1_from_bytes(curve, data, off)
    off += n
    zu = fr.from_bytes(data[off : off + fr.nb_bytes])
    off += fr.nb_bytes
    (nb_c,) = struct.unpack_from(">I", data, off)
    off += 4
    bsb22 = []
    for _ in range(nb_c):
        pt, n = g1_from_bytes(curve, data, off)
        bsb22.append(pt)
        off += n
    proof = Proof(
        lro=(pts[0], pts[1], pts[2]), z_com=pts[3],
        h_coms=(pts[4], pts[5], pts[6]),
        batch_h=pts[7], batch_claimed=claimed,
        z_shifted_h=z_shifted_h, z_shifted_claimed=zu,
        bsb22_commitments=bsb22,
    )
    return proof, off


def plonk_vk_to_bytes(curve, vk: VerifyingKey, compressed: bool = True) -> bytes:
    fr = curve.fr
    out = bytearray()
    nb_c = len(vk.commitment_constraint_indexes)
    out += struct.pack(">IIII", vk.log_n, vk.nb_public, nb_c, 0)
    out += fr.to_bytes(vk.k1) + fr.to_bytes(vk.k2) + fr.to_bytes(vk.omega)
    for name in _VK_NAMES:
        out += g1_to_bytes(curve, vk.commitments[name], compressed)
    out += g2_to_bytes(curve, vk.g2_gen, compressed)
    out += g2_to_bytes(curve, vk.g2_tau, compressed)
    for i in range(nb_c):
        out += g1_to_bytes(curve, vk.commitments[f"qcp{i}"], compressed)
        out += struct.pack(">I", vk.commitment_constraint_indexes[i])
    return bytes(out)


def plonk_vk_from_bytes(curve, data: bytes):
    fr = curve.fr
    log_n, nb_public, nb_c, _ = struct.unpack_from(">IIII", data, 0)
    off = 16
    k1 = fr.from_bytes(data[off : off + fr.nb_bytes]); off += fr.nb_bytes
    k2 = fr.from_bytes(data[off : off + fr.nb_bytes]); off += fr.nb_bytes
    omega = fr.from_bytes(data[off : off + fr.nb_bytes]); off += fr.nb_bytes
    commitments = {}
    for name in _VK_NAMES:
        pt, n = g1_from_bytes(curve, data, off)
        commitments[name] = pt
        off += n
    g2_gen, n = g2_from_bytes(curve, data, off); off += n
    g2_tau, n = g2_from_bytes(curve, data, off); off += n
    cci = []
    for i in range(nb_c):
        pt, n = g1_from_bytes(curve, data, off); off += n
        commitments[f"qcp{i}"] = pt
        (idx,) = struct.unpack_from(">I", data, off); off += 4
        cci.append(int(idx))
    vk = VerifyingKey(
        commitments=commitments, log_n=log_n, k1=k1, k2=k2,
        nb_public=nb_public, g2_gen=g2_gen, g2_tau=g2_tau, omega=omega,
        commitment_constraint_indexes=cci,
    )
    return vk, off
