"""gnark constraint-system wire format: decode/encode + IR translation.

Role parity: reference constraint/marshal.go (System.ToBytes/FromBytes,
4-section binary container + CBOR body), constraint/bn254/marshal.go
(curve-level WriteTo/ReadFrom: version header + coeff table) and
constraint/bn254/coeff.go (Montgomery-limb coeff table). This unblocks
cross-loading gnark ``.r1cs`` / ``.scs`` artifacts the moment fixtures or a
Go toolchain exist (there is neither on this machine), and is fully
self-tested by encoder/decoder round-trips plus the reference's
FuzzIntcomp32 corpus.

Layout (all integers little-endian):

    [totalLen u64][verMajor u64][verMinor u64][verPatch u64]
    -- System.ToBytes (marshal.go:17-62): ---------------------------------
    [levelsLen u64][instructionsLen u64][calldataLen u64][bodyLen u64]
    levels       : u64 count, then per level one intcomp u32 stream
    instructions : 3 intcomp u32 streams (blueprintID, constraintOffset,
                   wireOffset) + 1 intcomp u64 stream (startCallData)
    calldata     : u64 count + that many uvarints    (marshal.go:314-334)
    body         : deterministic CBOR of the System struct, blueprint and
                   commitment types tag-wrapped (tags 5309735..5309743,
                   marshal.go:336-361)
    -- CoeffTable.toBytes (coeff.go:51-63): -------------------------------
    [count u64][count x ceil(bits/64) u64 Montgomery-form limbs]

Semantic translation maps the decoded stream into this repo's
array-oriented IR (constraint/system.py R1CS, constraint/scs.py SCS) by
replaying the blueprint instruction stream (blueprint_r1cs.go:36-59,
blueprint_hint.go:10-36, blueprint_scs.go:39-51,190-201,236-249,285-291).
The R1C solved-wire metadata gnark derives at solve time is reconstructed
by a definedness sweep over the instruction order.

Copied whole from gnark_icicle_tpu/io/gnark_cs.py:1 (``decode``/``encode`` :164/:255,
``to_r1cs``/``from_r1cs`` :350/:540, ``to_scs``/``from_scs`` :432/:623 and the
readers and writers :743-755), so that the port imports nothing of the JAX
package; it resolves hint ids through the port's ``constraint/hints.py`` and
commitments through its ``constraint/system.py`` and ``constraint/scs.py``.
Two loops of the original run as numpy passes, with the same bytes and
values: the calldata's uvarints (``_uvarints``, ``_read_uvarints``; tens of
millions at 2^17 constraints), and the coefficient table's Montgomery
inverse, computed once per modulus (``_r_inv``).
tests/test_torch_io.py holds it to the original.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from . import cbor, intcomp
from .cbor import Tagged
from ..constraint.hints import hint_name as _hint_name
from ..constraint.system import R1CS
from ..constraint.scs import SparseR1CS, PlonkCommitment
from ..constraint.system import Groth16Commitment

GNARK_VERSION = (0, 11, 0)  # ≙ reference doc.go:25

TAG_GENERIC_HINT = 5309735
TAG_GENERIC_R1C = 5309736
TAG_GENERIC_SPARSE_R1C = 5309737
TAG_SPARSE_R1C_ADD = 5309738
TAG_SPARSE_R1C_MUL = 5309739
TAG_SPARSE_R1C_BOOL = 5309740
TAG_LOOKUP_HINT = 5309741
TAG_G16_COMMITMENTS = 5309742
TAG_PLONK_COMMITMENTS = 5309743

SYSTEM_R1CS = 1        # ≙ constraint.SystemR1CS
SYSTEM_SPARSE_R1CS = 2  # ≙ constraint.SystemSparseR1CS

# gnark reserved coefficient ids (constraint/core.go CoeffId*)
_G_ZERO, _G_ONE, _G_TWO, _G_MINUS_ONE, _G_MINUS_TWO = 0, 1, 2, 3, 4


@dataclass
class GnarkInstruction:
    """≙ constraint.PackedInstruction (core.go:30-49)."""

    blueprint_id: int
    constraint_offset: int
    wire_offset: int
    start_calldata: int


@dataclass
class GnarkCS:
    """A decoded gnark constraint system, lossless (re-encodable)."""

    q: int
    system_type: int                       # SYSTEM_R1CS / SYSTEM_SPARSE_R1CS
    gnark_version: str = "%d.%d.%d" % GNARK_VERSION
    blueprints: list = field(default_factory=list)     # cbor.Tagged items
    instructions: list = field(default_factory=list)   # GnarkInstruction
    calldata: list = field(default_factory=list)       # uint32 stream
    levels: list = field(default_factory=list)         # [[instr ids]]
    coeffs: list = field(default_factory=list)         # plain ints (< q)
    nb_constraints: int = 0
    nb_internal: int = 0
    public_names: list = field(default_factory=list)   # incl. "1" ONE wire
    secret_names: list = field(default_factory=list)
    logs: list = field(default_factory=list)
    debug_info: list = field(default_factory=list)
    symbols: dict = field(default_factory=dict)
    m_debug: dict = field(default_factory=dict)
    hint_names: dict = field(default_factory=dict)     # hintID -> name
    commitment_info: object = None                     # Tagged or None
    gkr_info: object = None

    # -- per-instruction views ----------------------------------------------
    def unpack(self, inst: GnarkInstruction) -> list:
        """≙ PackedInstruction.Unpack: the instruction's calldata slice."""
        bp = self.blueprints[inst.blueprint_id]
        size = _CALLDATA_SIZE.get(bp.tag, -1)
        if size < 0:
            size = self.calldata[inst.start_calldata]
        return self.calldata[inst.start_calldata : inst.start_calldata + size]


# ≙ Blueprint.CalldataSize() per type (blueprint_*.go)
_CALLDATA_SIZE = {
    TAG_GENERIC_HINT: -1,
    TAG_GENERIC_R1C: -1,
    TAG_GENERIC_SPARSE_R1C: 9,
    TAG_SPARSE_R1C_ADD: 6,
    TAG_SPARSE_R1C_MUL: 4,
    TAG_SPARSE_R1C_BOOL: 3,
    TAG_LOOKUP_HINT: -1,
}


def _n_limbs(q: int) -> int:
    return (q.bit_length() + 63) // 64


@lru_cache(maxsize=None)
def _r_inv(q: int, nl: int) -> int:
    return pow(1 << (64 * nl), q - 2, q)


def _from_mont(limbs: list, q: int) -> int:
    v = 0
    for i, w in enumerate(limbs):
        v |= w << (64 * i)
    return (v * _r_inv(q, len(limbs))) % q


def _to_mont(v: int, q: int, nl: int) -> list:
    m = (v << (64 * nl)) % q
    return [(m >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(nl)]


def _uvarints(values) -> bytes:
    """Each value (below 2^64) as a Go uvarint (LEB128: low 7 bits first,
    0x80 = continuation), in one numpy pass: the original's ``_uvarint``
    (:139) in a loop, for the tens of millions of calldata values of a
    2^17-constraint system."""
    v = np.asarray(values, dtype=np.uint64)
    n = np.ones(len(v), dtype=np.int64)    # bytes a value: 1 + its 7-bit groups above the first
    for k in range(1, 10):
        more = (v >> np.uint64(7 * k)) > 0
        if not more.any():
            break
        n += more
    starts = np.cumsum(n) - n
    out = np.empty(int(n.sum()), dtype=np.uint8)
    for k in range(int(n.max(initial=0))):
        sel = n > k
        low = ((v[sel] >> np.uint64(7 * k)) & np.uint64(0x7F)).astype(np.uint8)
        out[starts[sel] + k] = low | ((n[sel] > k + 1).astype(np.uint8) << 7)
    return out.tobytes()


def _read_uvarints(buf: bytes, off: int, count: int):
    """``count`` uvarints from buf[off:], each masked to 32 bits (the
    calldata's uint32), in one numpy pass: the values and the offset after
    them; the original's ``_read_uvarint`` (:146) in a loop. Raises
    ValueError on a truncated or overlong one, as that does."""
    if count == 0:
        return [], off
    arr = np.frombuffer(buf, dtype=np.uint8, offset=off)
    ends = np.flatnonzero(arr < 0x80)[:count]
    if len(ends) < count:
        raise ValueError("gnark_cs: truncated uvarint")
    starts = np.concatenate(([0], ends[:-1] + 1))
    if int((ends - starts).max()) > 9:
        raise ValueError("gnark_cs: uvarint overflow")
    v = np.zeros(count, dtype=np.uint64)
    for k in range(5):   # bits 0-34: all that the 32-bit mask keeps
        has = starts + k <= ends
        v[has] |= (arr[starts[has] + k] & 0x7F).astype(np.uint64) << np.uint64(7 * k)
    return (v & np.uint64(0xFFFFFFFF)).tolist(), off + int(ends[-1]) + 1


# -- decode ------------------------------------------------------------------

def decode(data: bytes) -> GnarkCS:
    """Parse a gnark curve-typed system blob (≙ system.ReadFrom)."""
    if len(data) < 32:
        raise ValueError("gnark_cs: truncated version header")
    total, major, minor, patch = struct.unpack_from("<4Q", data, 0)
    if major != 0 or minor < 10:
        raise ValueError(
            f"gnark_cs: unsupported gnark version {major}.{minor}.{patch}"
        )
    body = data[32 : 32 + total]
    if len(body) != total:
        raise ValueError("gnark_cs: truncated body")

    # System container (marshal.go FromBytes)
    if len(body) < 32:
        raise ValueError("gnark_cs: truncated section header")
    l_len, i_len, c_len, b_len = struct.unpack_from("<4Q", body, 0)
    off = 32
    sec_levels = body[off : off + l_len]
    off += l_len
    sec_instr = body[off : off + i_len]
    off += i_len
    sec_calldata = body[off : off + c_len]
    off += c_len
    sec_body = body[off : off + b_len]
    off += b_len
    sec_coeffs = body[off:]

    # CBOR body first (it carries ScalarField = q, needed for coeffs)
    sysmap, _ = cbor.decode(sec_body)
    if not isinstance(sysmap, dict):
        raise ValueError("gnark_cs: body is not a CBOR map")
    q = int(sysmap["ScalarField"], 16)

    gcs = GnarkCS(q=q, system_type=sysmap["Type"])
    gcs.gnark_version = sysmap["GnarkVersion"]
    gcs.blueprints = list(sysmap.get("Blueprints") or [])
    gcs.nb_constraints = sysmap.get("NbConstraints", 0)
    gcs.nb_internal = sysmap.get("NbInternalVariables", 0)
    gcs.public_names = list(sysmap.get("Public") or [])
    gcs.secret_names = list(sysmap.get("Secret") or [])
    gcs.logs = sysmap.get("Logs") or []
    gcs.debug_info = sysmap.get("DebugInfo") or []
    gcs.symbols = sysmap.get("SymbolTable") or {}
    gcs.m_debug = sysmap.get("MDebug") or {}
    gcs.hint_names = {
        int(k): v for k, v in (sysmap.get("MHintsDependencies") or {}).items()
    }
    gcs.commitment_info = sysmap.get("CommitmentInfo")
    gcs.gkr_info = sysmap.get("GkrInfo")

    # levels (marshal.go levelsFromBytes)
    (n_levels,) = struct.unpack_from("<Q", sec_levels, 0)
    loff = 8
    for _ in range(n_levels):
        lvl, loff = intcomp.read_u32_stream(sec_levels, loff)
        gcs.levels.append(lvl)

    # instructions (marshal.go instructionsFromBytes)
    ioff = 0
    bids, ioff = intcomp.read_u32_stream(sec_instr, ioff)
    coffs, ioff = intcomp.read_u32_stream(sec_instr, ioff)
    woffs, ioff = intcomp.read_u32_stream(sec_instr, ioff)
    starts, ioff = intcomp.read_u64_stream(sec_instr, ioff)
    if not len(bids) == len(coffs) == len(woffs) == len(starts):
        raise ValueError("gnark_cs: instruction column length mismatch")
    gcs.instructions = [
        GnarkInstruction(b, c, w, s)
        for b, c, w, s in zip(bids, coffs, woffs, starts)
    ]

    # calldata (marshal.go calldataFromBytes)
    (n_calldata,) = struct.unpack_from("<Q", sec_calldata, 0)
    gcs.calldata, _ = _read_uvarints(sec_calldata, 8, n_calldata)

    # coeff table (coeff.go fromBytes) — limbs are Montgomery form
    (n_coeffs,) = struct.unpack_from("<Q", sec_coeffs, 0)
    nl = _n_limbs(q)
    koff = 8
    for _ in range(n_coeffs):
        limbs = struct.unpack_from(f"<{nl}Q", sec_coeffs, koff)
        koff += 8 * nl
        gcs.coeffs.append(_from_mont(list(limbs), q))
    return gcs


# -- encode ------------------------------------------------------------------

def encode(gcs: GnarkCS) -> bytes:
    """Re-emit the gnark wire format (≙ system.WriteTo)."""
    # levels
    sec_levels = bytearray(struct.pack("<Q", len(gcs.levels)))
    for lvl in gcs.levels:
        intcomp.write_u32_stream(sec_levels, lvl)

    # instructions
    sec_instr = bytearray()
    intcomp.write_u32_stream(
        sec_instr, [i.blueprint_id for i in gcs.instructions])
    intcomp.write_u32_stream(
        sec_instr, [i.constraint_offset for i in gcs.instructions])
    intcomp.write_u32_stream(
        sec_instr, [i.wire_offset for i in gcs.instructions])
    intcomp.write_u64_stream(
        sec_instr, [i.start_calldata for i in gcs.instructions])

    # calldata
    sec_calldata = struct.pack("<Q", len(gcs.calldata)) + _uvarints(gcs.calldata)

    # CBOR body — field set mirrors constraint.System's cbor-visible fields
    sysmap = {
        "GnarkVersion": gcs.gnark_version,
        "ScalarField": format(gcs.q, "x"),
        "Type": gcs.system_type,
        "Blueprints": gcs.blueprints,
        "NbConstraints": gcs.nb_constraints,
        "NbInternalVariables": gcs.nb_internal,
        "Public": gcs.public_names,
        "Secret": gcs.secret_names,
        "Logs": gcs.logs or None,
        "DebugInfo": gcs.debug_info or None,
        "SymbolTable": gcs.symbols
        or {"Locations": None, "Functions": None},
        "MDebug": gcs.m_debug,
        "MHintsDependencies": dict(gcs.hint_names),
        "CommitmentInfo": gcs.commitment_info,
        "GkrInfo": gcs.gkr_info or {
            "Circuit": None, "MaxNIns": 0, "NbInstances": 0,
            "HashName": "", "SolveHintID": 0, "ProveHintID": 0,
        },
    }
    sec_body = cbor.encode(sysmap)

    container = struct.pack(
        "<4Q", len(sec_levels), len(sec_instr), len(sec_calldata),
        len(sec_body),
    ) + bytes(sec_levels) + bytes(sec_instr) + bytes(sec_calldata) + sec_body

    # coeff table
    nl = _n_limbs(gcs.q)
    sec_coeffs = bytearray(struct.pack("<Q", len(gcs.coeffs)))
    for c in gcs.coeffs:
        sec_coeffs += struct.pack(f"<{nl}Q", *_to_mont(c, gcs.q, nl))

    total = len(container) + len(sec_coeffs)
    return (
        struct.pack("<4Q", total, *GNARK_VERSION)
        + container
        + bytes(sec_coeffs)
    )


# -- translation: gnark stream -> our IR -------------------------------------

def _coeff_mapper(gcs: GnarkCS, intern):
    """gnark coeff id -> (our coeff id) via `intern(value)`; reserved ids
    0..3 coincide by design (constraint/system.py), −2 is interned."""

    def map_cid(gid: int) -> int:
        if gid >= len(gcs.coeffs):
            raise ValueError(f"gnark_cs: coeff id {gid} out of range")
        return intern(gcs.coeffs[gid])

    return map_cid



def _resolve_hint_id(gcs: GnarkCS, hid32: int) -> int:
    """gnark stores 32-bit hint ids in calldata; our registry keys are the
    64-bit FNV-1a of the hint NAME. Recover the full id through
    MHintsDependencies when the name is known (our exporter always records
    it), else keep the raw 32-bit id (caller registers an implementation
    under that id, ≙ solver.RegisterNamedHint)."""
    from ..constraint.hints import hint_id as name_to_id

    name = gcs.hint_names.get(hid32)
    if not name or name.startswith("0x"):  # unnamed: keep the raw id
        return hid32
    return name_to_id(name)


def to_r1cs(gcs: GnarkCS) -> R1CS:
    """Replay the instruction stream into our array-oriented R1CS."""
    if gcs.system_type != SYSTEM_R1CS:
        raise ValueError("gnark_cs: not an R1CS blob")
    cs = R1CS(gcs.q)
    # wires: gnark order = publics (incl. ONE at 0) | secrets | internals
    cs.public_names = list(gcs.public_names) or ["one"]
    cs.nb_public = len(cs.public_names)
    cs.secret_names = list(gcs.secret_names)
    cs.nb_secret = len(cs.secret_names)
    cs.nb_internal = gcs.nb_internal
    n_in = cs.nb_public + cs.nb_secret
    cid = _coeff_mapper(gcs, cs.coeff_id)

    defined = [True] * n_in + [False] * gcs.nb_internal

    def terms(flat, lo, n):
        return [
            (cid(flat[lo + 2 * k]), flat[lo + 2 * k + 1]) for k in range(n)
        ]

    for inst in gcs.instructions:
        bp = gcs.blueprints[inst.blueprint_id]
        data = gcs.unpack(inst)
        if bp.tag == TAG_GENERIC_R1C:
            # [nbInputs, lenL, lenR, lenO, (cid,vid)*]
            ln_l, ln_r, ln_o = data[1], data[2], data[3]
            l = terms(data, 4, ln_l)
            r = terms(data, 4 + 2 * ln_l, ln_r)
            o = terms(data, 4 + 2 * (ln_l + ln_r), ln_o)
            # reconstruct the solved wire: the single undefined wire
            unsolved = [
                w for _, w in l + r + o if w >= n_in and not defined[w]
            ]
            unsolved = list(dict.fromkeys(unsolved))
            if len(unsolved) > 1:
                raise ValueError(
                    "gnark_cs: R1C with >1 undefined wire "
                    f"(ids {unsolved}) — stream is not solve-ordered"
                )
            sw = unsolved[0] if unsolved else -1
            if sw >= 0:
                defined[sw] = True
            cs.add_r1c(l, r, o, solved_wire=sw)
        elif bp.tag == TAG_GENERIC_HINT:
            # [nbInputs, hintID, lenInputs, (lenExpr, (cid,vid)*)*, lo, hi]
            hint_id = _resolve_hint_id(gcs, data[1])
            n_inputs = data[2]
            j = 3
            inputs = []
            for _ in range(n_inputs):
                n = data[j]
                j += 1
                inputs.append(terms(data, j, n))
                j += 2 * n
            lo, hi = data[j], data[j + 1]
            outputs = list(range(lo, hi))
            for w in outputs:
                defined[w] = True
            cs.add_hint(hint_id, inputs, outputs)
        else:
            raise NotImplementedError(
                f"gnark_cs: R1CS blueprint tag {bp.tag} not supported"
            )

    if gcs.nb_constraints != cs.nb_constraints:
        raise ValueError(
            f"gnark_cs: NbConstraints header {gcs.nb_constraints} != "
            f"replayed {cs.nb_constraints}"
        )
    # commitments
    for c in _commitment_list(gcs.commitment_info, TAG_G16_COMMITMENTS):
        cs.commitments.append(Groth16Commitment(
            public_and_commitment_committed=list(
                c.get("PublicAndCommitmentCommitted") or []),
            nb_public_committed=c.get("NbPublicCommitted", 0),
            private_committed=list(c.get("PrivateCommitted") or []),
            commitment_index=c.get("CommitmentIndex", 0),
        ))
    return cs


def to_scs(gcs: GnarkCS) -> SparseR1CS:
    """Replay the instruction stream into our SCS (PLONK arithmetization)."""
    if gcs.system_type != SYSTEM_SPARSE_R1CS:
        raise ValueError("gnark_cs: not a sparse R1CS blob")
    scs = SparseR1CS(gcs.q)
    scs.public_names = list(gcs.public_names)
    scs.nb_public = len(scs.public_names)
    scs.secret_names = list(gcs.secret_names)
    scs.nb_secret = len(scs.secret_names)
    scs.nb_internal = gcs.nb_internal
    n_in = scs.nb_public + scs.nb_secret
    defined = [True] * n_in + [False] * gcs.nb_internal
    coeffs = gcs.coeffs
    q = gcs.q
    M1 = q - 1

    # Our SCS convention: the first nb_public gates are public-input gates
    # (−x_i + PI_i(Qk) = 0, frontend/scs_builder.py:39-45) whose Qk column
    # carries the public value at prove time. gnark's stream has NO such
    # gates (its PLONK prover feeds publics through a separate PI
    # polynomial, backend/plonk/bn254/prove.go) — synthesize them here so
    # the imported system drives our prover unchanged; from_scs strips
    # them again (round-trip identity).
    for i in range(scs.nb_public):
        scs.add_gate(i, i, i, q - 1, 0, 0, 0, 0, solved_wire=-1)

    def gate(xa, xb, xc, ql, qr, qm, qo, qc, commit=0):
        # reconstruct the solved wire (gnark derives it at solve time,
        # blueprint_scs.go:64-120): the single not-yet-defined wire
        unsolved = [
            w for w in dict.fromkeys((xa, xb, xc))
            if w >= n_in and not defined[w]
        ]
        if len(unsolved) > 1:
            raise ValueError(
                f"gnark_cs: gate with >1 undefined wire {unsolved}"
            )
        sw = unsolved[0] if unsolved else -1
        if sw >= 0:
            defined[sw] = True
        idx = scs.add_gate(xa, xb, xc, ql, qr, qm, qo, qc, solved_wire=sw)
        if commit:
            scs.commitment_tags[idx] = commit
        return idx

    for inst in gcs.instructions:
        bp = gcs.blueprints[inst.blueprint_id]
        d = gcs.unpack(inst)
        t = bp.tag
        if t == TAG_GENERIC_SPARSE_R1C:
            # [xa xb xc qL qR qO qM qC commitment] (blueprint_scs.go:35-51)
            gate(d[0], d[1], d[2], coeffs[d[3]], coeffs[d[4]],
                 coeffs[d[6]], coeffs[d[5]], coeffs[d[7]], commit=d[8])
        elif t == TAG_SPARSE_R1C_MUL:
            # qM⋅(xa⋅xb) == xc   [xa xb xc qM]
            gate(d[0], d[1], d[2], 0, 0, coeffs[d[3]], M1, 0)
        elif t == TAG_SPARSE_R1C_ADD:
            # qL⋅xa + qR⋅xb + qC == xc   [xa xb xc qL qR qC]
            gate(d[0], d[1], d[2], coeffs[d[3]], coeffs[d[4]], 0, M1,
                 coeffs[d[5]])
        elif t == TAG_SPARSE_R1C_BOOL:
            # qL⋅xa + qM⋅xa² == 0   [xa qL qM]
            gate(d[0], d[0], 0, coeffs[d[1]], 0, coeffs[d[2]], 0, 0)
        elif t == TAG_GENERIC_HINT:
            hint_id = _resolve_hint_id(gcs, d[1])
            n_inputs = d[2]
            j = 3
            inputs = []
            for _ in range(n_inputs):
                n = d[j]
                j += 1
                inputs.append([
                    (coeffs[d[j + 2 * k]], d[j + 2 * k + 1])
                    for k in range(n)
                ])
                j += 2 * n
            outputs = list(range(d[j], d[j + 1]))
            for w in outputs:
                defined[w] = True
            scs.add_hint(hint_id, inputs, outputs)
        else:
            raise NotImplementedError(
                f"gnark_cs: SCS blueprint tag {t} not supported"
            )
    for c in _commitment_list(gcs.commitment_info, TAG_PLONK_COMMITMENTS):
        scs.commitments.append(PlonkCommitment(
            committed=list(c.get("Committed") or []),
            # gnark counts constraints only; our gate indices include the
            # synthesized leading public-input gates
            commitment_index=c.get("CommitmentIndex", 0) + scs.nb_public,
        ))
    return scs


def _commitment_list(info, want_tag) -> list:
    if info is None:
        return []
    if isinstance(info, Tagged):
        if info.tag != want_tag:
            raise ValueError(
                f"gnark_cs: commitment tag {info.tag}, want {want_tag}"
            )
        info = info.value
    return info or []


# -- translation: our IR -> gnark stream -------------------------------------

def from_r1cs(cs: R1CS) -> GnarkCS:
    """Express our R1CS in gnark's stream shape (blueprints 0=hint,
    1=generic R1C — the reference builder's registration order,
    core.go:151 + frontend/cs/r1cs/builder.go:123)."""
    from ..constraint.system import INSTR_HINT, INSTR_R1C

    gcs = GnarkCS(q=cs.q, system_type=SYSTEM_R1CS)
    gcs.blueprints = [
        Tagged(TAG_GENERIC_HINT, {}), Tagged(TAG_GENERIC_R1C, {}),
    ]
    gcs.public_names = list(cs.public_names)
    gcs.secret_names = list(cs.secret_names)
    gcs.nb_internal = cs.nb_internal
    n_in = cs.nb_public + cs.nb_secret
    # gnark interns the value −2 eagerly (coeff.go newCoeffTable); ours
    # interns lazily — emit gnark's 5 reserved ids then our tail
    gcs.coeffs = [0, 1, 2, cs.q - 1, cs.q - 2] + [
        c for c in cs.coeffs[4:]
    ]

    def g_cid(our: int) -> int:
        return our if our < 4 else our + 1

    wire_hwm = n_in  # high-water mark of defined wires (WireOffset parity)
    n_constraints = 0
    for kind, idx in cs.instructions:
        start = len(gcs.calldata)
        if kind == INSTR_R1C:
            (ls, le), (rs, re_), (os_, oe) = cs.constraint_slots(idx)
            ln_l, ln_r, ln_o = le - ls, re_ - rs, oe - os_
            data = [4 + 2 * (ln_l + ln_r + ln_o), ln_l, ln_r, ln_o]
            for t in range(ls, oe):
                data.append(g_cid(cs.term_coeff[t]))
                data.append(cs.term_wire[t])
            gcs.calldata.extend(data)
            gcs.instructions.append(
                GnarkInstruction(1, n_constraints, wire_hwm, start))
            n_constraints += 1
            sw = cs.solved_wire[idx]
            if sw >= 0:
                wire_hwm = max(wire_hwm, sw + 1)
        else:
            h = cs.hints[idx]
            lo, hi = (h.outputs[0], h.outputs[-1] + 1) if h.outputs else (0, 0)
            if list(range(lo, hi)) != list(h.outputs):
                raise ValueError(
                    "gnark_cs: hint outputs not contiguous — cannot express "
                    "as a gnark OutputRange"
                )
            data = [0, h.hint_id & 0xFFFFFFFF, len(h.inputs)]
            for expr in h.inputs:
                data.append(len(expr))
                for c, w in expr:
                    data.append(g_cid(c))
                    data.append(w)
            data.extend([lo, hi])
            data[0] = len(data)
            gcs.calldata.extend(data)
            gcs.instructions.append(
                GnarkInstruction(0, n_constraints, wire_hwm, start))
            wire_hwm = max(wire_hwm, hi)
            gcs.hint_names.setdefault(
                h.hint_id & 0xFFFFFFFF, _hint_name(h.hint_id))
    gcs.nb_constraints = n_constraints
    gcs.levels = [
        [i for i in lvl] for lvl in cs.compute_levels()
    ]
    if cs.commitments:
        gcs.commitment_info = Tagged(TAG_G16_COMMITMENTS, [
            {
                "PublicAndCommitmentCommitted":
                    list(c.public_and_commitment_committed),
                "PrivateCommitted": list(c.private_committed),
                "CommitmentIndex": c.commitment_index,
                "NbPublicCommitted": c.nb_public_committed,
            }
            for c in cs.commitments
        ])
    else:
        gcs.commitment_info = Tagged(TAG_G16_COMMITMENTS, [])
    return gcs


def from_scs(scs: SparseR1CS) -> GnarkCS:
    """Express our SparseR1CS in gnark's stream shape (blueprint order per
    the reference SCS builder: hint=0, generic=1, mul=2, add=3, bool=4,
    frontend/cs/scs/builder.go:121-124; every gate is emitted through the
    generic 9-word blueprint — a valid formulation the specialized
    blueprints merely compress)."""
    from ..constraint.scs import INSTR_GATE, INSTR_HINT

    gcs = GnarkCS(q=scs.q, system_type=SYSTEM_SPARSE_R1CS)
    gcs.blueprints = [
        Tagged(TAG_GENERIC_HINT, {}),
        Tagged(TAG_GENERIC_SPARSE_R1C, {}),
        Tagged(TAG_SPARSE_R1C_MUL, {}),
        Tagged(TAG_SPARSE_R1C_ADD, {}),
        Tagged(TAG_SPARSE_R1C_BOOL, {}),
    ]
    gcs.public_names = list(scs.public_names)
    gcs.secret_names = list(scs.secret_names)
    gcs.nb_internal = scs.nb_internal
    n_in = scs.nb_public + scs.nb_secret

    q = scs.q
    gcs.coeffs = [0, 1, 2, q - 1, q - 2]
    interned = {0: 0, 1: 1, 2: 2, q - 1: 3, q - 2: 4}

    def cid(v: int) -> int:
        v %= q
        i = interned.get(v)
        if i is None:
            i = len(gcs.coeffs)
            gcs.coeffs.append(v)
            interned[v] = i
        return i

    wire_hwm = n_in
    n_constraints = 0
    for kind, idx in scs.instructions:
        if kind == INSTR_GATE and idx < scs.nb_public:
            # our leading public-input (Qk) gates — gnark's stream has no
            # equivalent (see to_scs, which re-synthesizes them on import)
            continue
        start = len(gcs.calldata)
        if kind == INSTR_GATE:
            gcs.calldata.extend([
                scs.xa[idx], scs.xb[idx], scs.xc[idx],
                cid(scs.ql[idx]), cid(scs.qr[idx]), cid(scs.qo[idx]),
                cid(scs.qm[idx]), cid(scs.qc[idx]),
                scs.commitment_tags.get(idx, 0),
            ])
            gcs.instructions.append(
                GnarkInstruction(1, n_constraints, wire_hwm, start))
            n_constraints += 1
            sw = scs.solved_wire[idx]
            if sw >= 0:
                wire_hwm = max(wire_hwm, sw + 1)
        else:
            h = scs.hints[idx]
            lo, hi = (h.outputs[0], h.outputs[-1] + 1) if h.outputs else (0, 0)
            if list(range(lo, hi)) != list(h.outputs):
                raise ValueError(
                    "gnark_cs: hint outputs not contiguous — cannot express "
                    "as a gnark OutputRange"
                )
            data = [0, h.hint_id & 0xFFFFFFFF, len(h.inputs)]
            for expr in h.inputs:
                data.append(len(expr))
                for coeff, w in expr:
                    data.append(cid(coeff))
                    data.append(w)
            data.extend([lo, hi])
            data[0] = len(data)
            gcs.calldata.extend(data)
            gcs.instructions.append(
                GnarkInstruction(0, n_constraints, wire_hwm, start))
            wire_hwm = max(wire_hwm, hi)
            gcs.hint_names.setdefault(
                h.hint_id & 0xFFFFFFFF, _hint_name(h.hint_id))
    gcs.nb_constraints = n_constraints

    # dependency levels over the instruction stream (≙ instruction_tree.go;
    # SparseR1CS keeps none in-memory — derived here for the wire format)
    wire_level: dict = {}
    levels: list = []
    pos = -1
    for kind, idx in scs.instructions:
        if kind == INSTR_GATE and idx < scs.nb_public:
            continue  # stripped public-input gates (see above)
        pos += 1
        if kind == INSTR_GATE:
            reads = [
                w for w in (scs.xa[idx], scs.xb[idx], scs.xc[idx])
                if w != scs.solved_wire[idx]
            ]
            outs = ([scs.solved_wire[idx]]
                    if scs.solved_wire[idx] >= 0 else [])
        else:
            h = scs.hints[idx]
            reads = [w for expr in h.inputs for _, w in expr]
            outs = list(h.outputs)
        lvl = 1 + max(
            (wire_level.get(w, -1) for w in reads if w >= n_in), default=-1
        )
        for w in outs:
            wire_level[w] = lvl
        while len(levels) <= lvl:
            levels.append([])
        levels[lvl].append(pos)
    gcs.levels = levels

    if scs.commitments:
        gcs.commitment_info = Tagged(TAG_PLONK_COMMITMENTS, [
            {"Committed": list(c.committed),
             "CommitmentIndex": c.commitment_index - scs.nb_public}
            for c in scs.commitments
        ])
    else:
        gcs.commitment_info = Tagged(TAG_PLONK_COMMITMENTS, [])
    return gcs


def write_r1cs(cs: R1CS) -> bytes:
    return encode(from_r1cs(cs))


def write_scs(scs: SparseR1CS) -> bytes:
    return encode(from_scs(scs))


def read_r1cs(data: bytes) -> R1CS:
    return to_r1cs(decode(data))


def read_scs(data: bytes) -> SparseR1CS:
    return to_scs(decode(data))
