"""PLONK key and proof objects.

Copied from gnark_icicle_tpu/backend/plonk/keys.py (:16-57): that module
cannot be imported without JAX, because its package ``__init__`` imports
the JAX prover. The proof has gnark's linearization-trick shape: wire,
permutation and quotient commitments, one batched KZG opening at ζ of
[linearized poly, L, R, O, S1, S2, Qcp...] and the shifted opening of Z at
ωζ.

``from_reference`` builds a key or proof from any object with the same
public fields (the JAX package's, in the tests), reading them by name; the
proving key's SRS and every G2 coordinate come over as the port's objects.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

from ..kzg import SRS, port_point


class _Carry:
    """from_reference over the public dataclass fields."""

    @classmethod
    def from_reference(cls, obj):
        out = {}
        for f in fields(cls):
            if f.name.startswith("_"):
                continue
            v = getattr(obj, f.name)
            if f.name in ("g2_gen", "g2_tau"):
                v = port_point(v)
            elif f.name == "srs":
                v = SRS.from_reference(v)
            elif f.name == "vk" and v is not None:
                v = VerifyingKey.from_reference(v)
            out[f.name] = v
        return cls(**out)


@dataclass
class ProvingKey(_Carry):
    trace_coeffs: dict  # name -> coefficient list (ql, qr, qm, qo, qk, s1-3)
    log_n: int
    k1: int
    k2: int
    srs: object  # kzg.SRS
    sigma: list  # permutation on 3n positions (for Z construction)
    vk: object = None  # VerifyingKey (≙ pk.Vk — the FS transcript binds it)


@dataclass
class VerifyingKey(_Carry):
    commitments: dict  # name -> G1 commitment of each trace polynomial
    log_n: int
    k1: int
    k2: int
    nb_public: int
    g2_gen: tuple
    g2_tau: tuple
    omega: int
    # BSB22: rows whose Qk value is the injected commitment hash
    # (≙ vk.CommitmentConstraintIndexes; ours are ABSOLUTE gate rows —
    # gnark stores them relative to NbPublicVariables, verify.go:183)
    commitment_constraint_indexes: list = field(default_factory=list)


@dataclass
class Proof(_Carry):
    """≙ prove.go:91-109 Proof{LRO, Z, H, BatchedProof, ZShiftedOpening,
    Bsb22Commitments}."""

    lro: tuple           # (A, B, C) wire commitments
    z_com: tuple         # permutation product commitment
    h_coms: tuple        # (H1, H2, H3) quotient shards
    batch_h: tuple       # BatchedProof.H — folded ζ-opening quotient
    batch_claimed: list  # ClaimedValues: [lin, l, r, o, s1, s2, qcp...]
    z_shifted_h: tuple   # ZShiftedOpening.H
    z_shifted_claimed: int  # Z(ωζ)
    # BSB22: KZG commitments to the per-commitment PI2 polynomials
    # (≙ proof.Bsb22Commitments, setup.go:102)
    bsb22_commitments: list = field(default_factory=list)
