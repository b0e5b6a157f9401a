"""ProvingKey and constraint-system persistence.

Role parity: reference durable-state story (SURVEY.md §5 checkpoint/resume):
every artifact serializes — PK/VK via point encodings (WriteTo/ReadFrom,
backend/groth16/bn254/marshal.go) plus a fast in-process dump
(WriteDump/ReadDump, groth16.go:86-89 — explicitly unsafe/non-portable in
the reference too; pickle is the Python analog, same trust model), and the
constraint system in a compact binary (the reference uses CBOR +
intcomp-compressed uint32 calldata, constraint/marshal.go — ours is a
length-prefixed struct format over the SoA arrays).

Copied whole from gnark_icicle_tpu/io/keys.py:1 (``pk_to_bytes``/``pk_from_bytes``
:30/:57, ``pk_write_dump``/``pk_read_dump`` :115/:127, ``r1cs_to_bytes``/
``r1cs_from_bytes`` :202/:223, ``scs_to_bytes``/``scs_from_bytes`` :272/:295), over the
port's ``ProvingKey``, ``R1CS`` and ``SparseR1CS``; tests/test_torch_io.py holds it to
the original. The dump leaves out the key's device staging (``ProvingKey._device``),
so that a pickle holds no CUDA tensor and loads on a machine without a card.
"""

from __future__ import annotations

import pickle
import struct

import numpy as np

from .serialize import g1_to_bytes, g1_from_bytes, g2_to_bytes, g2_from_bytes
from ..backend.groth16.keys import ProvingKey
from ..constraint.system import R1CS
from ..constraint.scs import SparseR1CS


# ---------------------------------------------------------------------------
# ProvingKey
# ---------------------------------------------------------------------------

def pk_to_bytes(curve, pk: ProvingKey, compressed: bool = False) -> bytes:
    """Portable PK encoding (≙ WriteTo/WriteRawTo)."""
    out = bytearray()
    out += struct.pack(">I", pk.domain_log_n)
    for pt in (pk.g1_alpha, pk.g1_beta, pk.g1_delta):
        out += g1_to_bytes(curve, pt, compressed)
    for pt in (pk.g2_beta, pk.g2_delta):
        out += g2_to_bytes(curve, pt, compressed)
    for lst in (pk.g1_a, pk.g1_b, pk.g1_k, pk.g1_z):
        out += struct.pack(">I", len(lst))
        for pt in lst:
            out += g1_to_bytes(curve, pt, compressed)
    out += struct.pack(">I", len(pk.g2_b))
    for pt in pk.g2_b:
        out += g2_to_bytes(curve, pt, compressed)
    # BSB22 pedersen proving keys (≙ pk.CommitmentKeys in marshal.go)
    cks = getattr(pk, "commitment_keys", []) or []
    out += struct.pack(">I", len(cks))
    for ck in cks:
        out += struct.pack(">I", len(ck.basis))
        for pt in ck.basis:
            out += g1_to_bytes(curve, pt, compressed)
        for pt in ck.basis_exp_sigma:
            out += g1_to_bytes(curve, pt, compressed)
    return bytes(out)


def pk_from_bytes(curve, data: bytes) -> ProvingKey:
    off = 0
    (log_n,) = struct.unpack_from(">I", data, off)
    off += 4
    singles_g1 = []
    for _ in range(3):
        pt, n = g1_from_bytes(curve, data, off)
        singles_g1.append(pt)
        off += n
    singles_g2 = []
    for _ in range(2):
        pt, n = g2_from_bytes(curve, data, off)
        singles_g2.append(pt)
        off += n
    lists_g1 = []
    for _ in range(4):
        (ln,) = struct.unpack_from(">I", data, off)
        off += 4
        lst = []
        for _ in range(ln):
            pt, n = g1_from_bytes(curve, data, off)
            lst.append(pt)
            off += n
        lists_g1.append(lst)
    (ln,) = struct.unpack_from(">I", data, off)
    off += 4
    g2_b = []
    for _ in range(ln):
        pt, n = g2_from_bytes(curve, data, off)
        g2_b.append(pt)
        off += n
    cks = []
    if off < len(data):  # older encodings lack the commitment-key section
        from ..backend.pedersen import PedersenProvingKey

        (nb_ck,) = struct.unpack_from(">I", data, off)
        off += 4
        for _ in range(nb_ck):
            (bl,) = struct.unpack_from(">I", data, off)
            off += 4
            basis, sigma_basis = [], []
            for target in (basis, sigma_basis):
                for _ in range(bl):
                    pt, n = g1_from_bytes(curve, data, off)
                    target.append(pt)
                    off += n
            cks.append(PedersenProvingKey(
                basis=basis, basis_exp_sigma=sigma_basis
            ))
    return ProvingKey(
        g1_alpha=singles_g1[0], g1_beta=singles_g1[1], g1_delta=singles_g1[2],
        g2_beta=singles_g2[0], g2_delta=singles_g2[1],
        g1_a=lists_g1[0], g1_b=lists_g1[1], g1_k=lists_g1[2],
        g1_z=lists_g1[3], g2_b=g2_b, domain_log_n=log_n,
        commitment_keys=cks,
    )


def pk_write_dump(pk: ProvingKey, path: str):
    """Fast non-portable dump (≙ WriteDump — same unsafe-by-design contract;
    only load dumps you created)."""
    dev = pk._device
    pk._device = {}
    try:
        with open(path, "wb") as f:
            pickle.dump(pk, f, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        pk._device = dev


def pk_read_dump(path: str) -> ProvingKey:
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# constraint systems
# ---------------------------------------------------------------------------

_MAGIC_R1CS = b"GTR1"
_MAGIC_SCS = b"GTS1"


def _pack_ints(xs) -> bytes:
    arr = np.asarray(xs, dtype=np.int64)
    return struct.pack(">I", len(arr)) + arr.tobytes()


def _unpack_ints(data, off):
    (n,) = struct.unpack_from(">I", data, off)
    off += 4
    arr = np.frombuffer(data, dtype=np.int64, count=n, offset=off)
    return list(map(int, arr)), off + 8 * n


def _pack_bigints(xs, nb: int) -> bytes:
    out = bytearray(struct.pack(">I", len(xs)))
    for x in xs:
        out += int(x).to_bytes(nb, "big")
    return bytes(out)


def _unpack_bigints(data, off, nb: int):
    (n,) = struct.unpack_from(">I", data, off)
    off += 4
    xs = []
    for _ in range(n):
        xs.append(int.from_bytes(data[off : off + nb], "big"))
        off += nb
    return xs, off


def _pack_hints(hints) -> bytes:
    out = bytearray(struct.pack(">I", len(hints)))
    for h in hints:
        out += struct.pack(">QI", h.hint_id, len(h.outputs))
        out += _pack_ints(h.outputs)
        out += struct.pack(">I", len(h.inputs))
        for expr in h.inputs:
            out += _pack_ints([c for c, _ in expr])
            out += _pack_ints([w for _, w in expr])
        out += _pack_ints(list(h.static_args))
    return bytes(out)


def _unpack_hints(data, off, cls):
    (n,) = struct.unpack_from(">I", data, off)
    off += 4
    hints = []
    for _ in range(n):
        hid, _n_out = struct.unpack_from(">QI", data, off)
        off += 12
        outs, off = _unpack_ints(data, off)
        (n_in,) = struct.unpack_from(">I", data, off)
        off += 4
        inputs = []
        for _ in range(n_in):
            cs_, off = _unpack_ints(data, off)
            ws, off = _unpack_ints(data, off)
            inputs.append(list(zip(cs_, ws)))
        sargs, off = _unpack_ints(data, off)
        hints.append(cls(hid, inputs, outs, tuple(sargs)))
    return hints, off


def r1cs_to_bytes(cs: R1CS) -> bytes:
    nb = (cs.q.bit_length() + 7) // 8
    out = bytearray(_MAGIC_R1CS)
    out += struct.pack(">I", nb) + cs.q.to_bytes(nb, "big")
    out += struct.pack(">III", cs.nb_public, cs.nb_secret, cs.nb_internal)
    out += _pack_bigints(cs.coeffs, nb)
    for arr in (cs.term_coeff, cs.term_wire, cs.l_off, cs.r_off, cs.o_off,
                cs.solved_wire):
        out += _pack_ints(arr)
    out += _pack_ints([k for k, _ in cs.instructions])
    out += _pack_ints([i for _, i in cs.instructions])
    out += _pack_hints(cs.hints)
    # BSB22 commitment info (≙ System.CommitmentInfo in the CBOR payload)
    out += struct.pack(">I", len(cs.commitments))
    for c in cs.commitments:
        out += struct.pack(">II", c.nb_public_committed, c.commitment_index)
        out += _pack_ints(c.public_and_commitment_committed)
        out += _pack_ints(c.private_committed)
    return bytes(out)


def r1cs_from_bytes(data: bytes) -> R1CS:
    from ..constraint.system import HintInstr

    assert data[:4] == _MAGIC_R1CS, "not an R1CS blob"
    off = 4
    (nb,) = struct.unpack_from(">I", data, off)
    off += 4
    q = int.from_bytes(data[off : off + nb], "big")
    off += nb
    cs = R1CS(q)
    cs.nb_public, cs.nb_secret, cs.nb_internal = struct.unpack_from(
        ">III", data, off
    )
    off += 12
    coeffs, off = _unpack_bigints(data, off, nb)
    cs.coeffs = coeffs
    cs._coeff_index = {c: i for i, c in enumerate(coeffs)}
    arrays = []
    for _ in range(6):
        arr, off = _unpack_ints(data, off)
        arrays.append(arr)
    (cs.term_coeff, cs.term_wire, cs.l_off, cs.r_off, cs.o_off,
     cs.solved_wire) = arrays
    kinds, off = _unpack_ints(data, off)
    idxs, off = _unpack_ints(data, off)
    cs.instructions = list(zip(kinds, idxs))
    cs.hints, off = _unpack_hints(data, off, HintInstr)
    if off < len(data):
        from ..constraint.system import Groth16Commitment

        (nb_c,) = struct.unpack_from(">I", data, off)
        off += 4
        for _ in range(nb_c):
            nb_pc, c_idx = struct.unpack_from(">II", data, off)
            off += 8
            pacc, off = _unpack_ints(data, off)
            priv, off = _unpack_ints(data, off)
            cs.commitments.append(Groth16Commitment(
                public_and_commitment_committed=list(pacc),
                nb_public_committed=nb_pc,
                private_committed=list(priv),
                commitment_index=c_idx,
            ))
    cs.constraint_origins = [None] * len(cs.l_off)
    cs.public_names = ["one"] + [f"pub{i}" for i in range(cs.nb_public - 1)]
    cs.secret_names = [f"sec{i}" for i in range(cs.nb_secret)]
    return cs


def scs_to_bytes(cs: SparseR1CS) -> bytes:
    nb = (cs.q.bit_length() + 7) // 8
    out = bytearray(_MAGIC_SCS)
    out += struct.pack(">I", nb) + cs.q.to_bytes(nb, "big")
    out += struct.pack(">III", cs.nb_public, cs.nb_secret, cs.nb_internal)
    for arr in (cs.xa, cs.xb, cs.xc, cs.solved_wire):
        out += _pack_ints(arr)
    for col in (cs.ql, cs.qr, cs.qm, cs.qo, cs.qc):
        out += _pack_bigints(col, nb)
    out += _pack_ints([k for k, _ in cs.instructions])
    out += _pack_ints([i for _, i in cs.instructions])
    out += _pack_hints(cs.hints)
    # BSB22 commitment rows (tags + descriptors)
    out += struct.pack(">I", len(cs.commitments))
    for c in cs.commitments:
        out += struct.pack(">I", c.commitment_index)
        out += _pack_ints(c.committed)
    tags = sorted(cs.commitment_tags.items())
    out += _pack_ints([g for g, _ in tags])
    out += _pack_ints([t for _, t in tags])
    return bytes(out)


def scs_from_bytes(data: bytes) -> SparseR1CS:
    from ..constraint.scs import SparseHint

    assert data[:4] == _MAGIC_SCS, "not an SCS blob"
    off = 4
    (nb,) = struct.unpack_from(">I", data, off)
    off += 4
    q = int.from_bytes(data[off : off + nb], "big")
    off += nb
    cs = SparseR1CS(q)
    cs.nb_public, cs.nb_secret, cs.nb_internal = struct.unpack_from(
        ">III", data, off
    )
    off += 12
    ints = []
    for _ in range(4):
        arr, off = _unpack_ints(data, off)
        ints.append(arr)
    cs.xa, cs.xb, cs.xc, cs.solved_wire = ints
    bigs = []
    for _ in range(5):
        col, off = _unpack_bigints(data, off, nb)
        bigs.append(col)
    cs.ql, cs.qr, cs.qm, cs.qo, cs.qc = bigs
    kinds, off = _unpack_ints(data, off)
    idxs, off = _unpack_ints(data, off)
    cs.instructions = list(zip(kinds, idxs))
    cs.hints, off = _unpack_hints(data, off, SparseHint)
    if off < len(data):
        from ..constraint.scs import PlonkCommitment

        (nb_c,) = struct.unpack_from(">I", data, off)
        off += 4
        for _ in range(nb_c):
            (ci,) = struct.unpack_from(">I", data, off)
            off += 4
            committed, off = _unpack_ints(data, off)
            cs.commitments.append(PlonkCommitment(
                committed=list(committed), commitment_index=int(ci)
            ))
        tag_gates, off = _unpack_ints(data, off)
        tag_vals, off = _unpack_ints(data, off)
        cs.commitment_tags = {
            int(g): int(t) for g, t in zip(tag_gates, tag_vals)
        }
    cs.public_names = [f"pub{i}" for i in range(cs.nb_public)]
    cs.secret_names = [f"sec{i}" for i in range(cs.nb_secret)]
    return cs
