"""Sparse (PLONK-ish) constraint system: qL·a + qR·b + qM·a·b + qO·o + qC = 0.

Role parity: gnark's SparseR1CS (reference: constraint/r1cs_sparse.go:143-147
SparseR1C{XA,XB,XC,QL,QR,QO,QM,QC}, per-curve system in
constraint/bn254/system.go). Same array-oriented stance as system.py: gates
are structure-of-arrays (wire-id and coeff-id columns), consumed wholesale by
the PLONK setup/prover as vectors.

Wire numbering: publics from 0, then secrets, then internals. Unlike the
R1CS path there is no ONE wire — constants live in the gate coefficients and
public inputs enter through the Qk column: the builder emits one
``−x + PI = 0`` gate per public input at the very start (gate j < nb_public
has runtime Qk = the j-th public value; the committed Qk keeps zeros there,
≙ completeQk, reference backend/plonk/bn254/prove.go:363).

Copied from gnark_icicle_tpu/constraint/scs.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass

INSTR_GATE = 0
INSTR_HINT = 1

# commitment gate tags (≙ constraint.CommitmentConstraint,
# constraint/r1cs_sparse.go:135-139)
COMMIT_NOT = 0
COMMIT_COMMITTED = 1   # row binds a committed wire to the PI2 column
COMMIT_COMMITMENT = 2  # row binds the commitment wire to the injected Qk


@dataclass
class PlonkCommitment:
    """≙ constraint.PlonkCommitment (constraint/commitment.go:16-19):
    committed = gate indices of the COMMITTED rows, commitment_index = the
    COMMITMENT row's gate index."""

    committed: list
    commitment_index: int


@dataclass
class SparseHint:
    hint_id: int
    inputs: list  # list of [(coeff, wire)] linear expressions (raw coeffs)
    outputs: list
    static_args: tuple = ()


class SparseR1CS:
    """PLONK-arithmetization constraint system over fr."""

    def __init__(self, field_modulus: int):
        self.q = field_modulus
        self.nb_public = 0  # public INPUTS (no ONE wire in gate wiring)
        self.nb_secret = 0
        self.nb_internal = 0
        self.public_names: list[str] = []
        self.secret_names: list[str] = []
        # gate columns (parallel arrays; one entry per gate)
        self.xa: list[int] = []
        self.xb: list[int] = []
        self.xc: list[int] = []
        self.ql: list[int] = []
        self.qr: list[int] = []
        self.qm: list[int] = []
        self.qo: list[int] = []
        self.qc: list[int] = []
        # wire the gate solves for: 0=xa? no — -1 none, else wire id
        self.solved_wire: list[int] = []
        self.instructions: list[tuple] = []
        self.hints: list[SparseHint] = []
        # BSB22: gate idx -> COMMIT_* tag; commitment descriptors
        self.commitment_tags: dict[int, int] = {}
        self.commitments: list[PlonkCommitment] = []
        # optional per-gate source info (debug mode, ≙ -tags=debug)
        self.gate_origins: list = []

    @property
    def nb_gates(self) -> int:
        return len(self.xa)

    @property
    def nb_wires(self) -> int:
        return self.nb_public + self.nb_secret + self.nb_internal

    def add_public(self, name: str) -> int:
        wid = self.nb_public
        self.nb_public += 1
        self.public_names.append(name)
        return wid

    def add_secret(self, name: str) -> int:
        wid = self.nb_public + self.nb_secret
        self.nb_secret += 1
        self.secret_names.append(name)
        return wid

    def new_internal(self) -> int:
        wid = self.nb_public + self.nb_secret + self.nb_internal
        self.nb_internal += 1
        return wid

    def add_gate(self, xa, xb, xc, ql, qr, qm, qo, qc,
                 solved_wire: int = -1) -> int:
        from .. import profile as _profile

        if _profile.is_profiling():
            _profile.record_constraint()
        from .. import debug as _debug

        self.gate_origins.append(
            _debug.capture_stack() if _debug.is_debug() else None
        )
        q = self.q
        self.xa.append(xa)
        self.xb.append(xb)
        self.xc.append(xc)
        self.ql.append(ql % q)
        self.qr.append(qr % q)
        self.qm.append(qm % q)
        self.qo.append(qo % q)
        self.qc.append(qc % q)
        self.solved_wire.append(solved_wire)
        idx = self.nb_gates - 1
        self.instructions.append((INSTR_GATE, idx))
        return idx

    def add_hint(self, hint_id: int, inputs, outputs, static_args=()):
        self.hints.append(SparseHint(hint_id, inputs, outputs, tuple(static_args)))
        self.instructions.append((INSTR_HINT, len(self.hints) - 1))

    def __repr__(self):
        return (
            f"SparseR1CS(q=…{str(self.q)[-6:]}, gates={self.nb_gates}, "
            f"public={self.nb_public}, secret={self.nb_secret}, "
            f"internal={self.nb_internal})"
        )


class SparseUnsatisfiedError(Exception):
    pass


def solve_scs(cs: SparseR1CS, public_values, secret_values,
              native: str | bool = "auto", hint_overrides=None):
    """Wire assignment + per-gate (a, b, c) wire-value vectors.

    ≙ the generated SCS solver (constraint/bn254/solver.go instantiated for
    SparseR1CS): instruction-ordered, one unknown per gate. native=True
    routes through the C++ core — opt-in rather than auto because the PLONK
    prover consumes host ints for the permutation product, so the
    Montgomery→int conversion eats the native win (the R1CS path avoids
    this via lazy limb-array views, see constraint.solver.SolveResult).
    """
    if native is True:
        from ..native import solve_scs_native

        res = solve_scs_native(cs, public_values, secret_values,
                               hint_overrides=hint_overrides)
        if res is not None:
            return res
    from .hints import get_hint, hint_name

    q = cs.q
    if len(public_values) != cs.nb_public:
        raise ValueError(
            f"expected {cs.nb_public} public values, got {len(public_values)}"
        )
    if len(secret_values) != cs.nb_secret:
        raise ValueError(
            f"expected {cs.nb_secret} secret values, got {len(secret_values)}"
        )
    wires = [None] * max(cs.nb_wires, 1)
    for i, v in enumerate(public_values):
        wires[i] = int(v) % q
    for i, v in enumerate(secret_values):
        wires[cs.nb_public + i] = int(v) % q

    a = [0] * cs.nb_gates
    b = [0] * cs.nb_gates
    c = [0] * cs.nb_gates

    for kind, idx in cs.instructions:
        if kind == INSTR_HINT:
            h = cs.hints[idx]
            ins = []
            for expr in h.inputs:
                s = 0
                for coeff, wid in expr:
                    v = wires[wid]
                    if v is None:
                        raise SparseUnsatisfiedError(
                            f"hint input wire {wid} unsolved"
                        )
                    s += coeff * v
                ins.append(s % q)
            ins.extend(h.static_args)
            fn = (hint_overrides or {}).get(h.hint_id) or get_hint(h.hint_id)
            outs = fn(q, ins)
            if len(outs) != len(h.outputs):
                raise SparseUnsatisfiedError(
                    f"hint {hint_name(h.hint_id)} arity mismatch"
                )
            for wid, v in zip(h.outputs, outs):
                wires[wid] = int(v) % q
            continue

        j = idx
        wa, wb, wc = cs.xa[j], cs.xb[j], cs.xc[j]
        ql, qr, qm, qo, qc = cs.ql[j], cs.qr[j], cs.qm[j], cs.qo[j], cs.qc[j]
        if j < cs.nb_public:  # public-input gate: runtime Qk carries PI
            qc = (qc + wires[j]) % q
        sw = cs.solved_wire[j]
        va, vb, vc = wires[wa], wires[wb], wires[wc]
        if sw >= 0 and wires[sw] is None:
            # the unknown may occupy several slots (e.g. inverse aliases
            # xb = xc); solve the linear equation coef·x + const = 0
            in_a, in_b, in_c = wa == sw, wb == sw, wc == sw
            if not in_a and va is None:
                raise SparseUnsatisfiedError(f"gate {j}: wire {wa} unsolved")
            if not in_b and vb is None:
                raise SparseUnsatisfiedError(f"gate {j}: wire {wb} unsolved")
            if not in_c and vc is None:
                raise SparseUnsatisfiedError(f"gate {j}: wire {wc} unsolved")
            coef = (ql if in_a else 0) + (qr if in_b else 0) + (qo if in_c else 0)
            const = qc
            if not in_a:
                const += ql * va
            if not in_b:
                const += qr * vb
            if not in_c:
                const += qo * vc
            if qm:
                if in_a and in_b:
                    raise SparseUnsatisfiedError(
                        f"gate {j}: quadratic in the unknown"
                    )
                if in_a:
                    coef += qm * vb
                elif in_b:
                    coef += qm * va
                else:
                    const += qm * va * vb
            coef %= q
            if coef == 0:
                raise SparseUnsatisfiedError(f"gate {j}: singular")
            wires[sw] = -const * pow(coef, -1, q) % q
        va, vb, vc = wires[wa], wires[wb], wires[wc]
        if va is None or vb is None or vc is None:
            raise SparseUnsatisfiedError(f"gate {j}: unsolved wire used")
        if cs.commitment_tags.get(j, COMMIT_NOT) == COMMIT_NOT:
            # commitment rows balance against the PI2/injected-Qk columns the
            # solver cannot see — skipped like the reference
            # (constraint/blueprint_scs.go:56-60)
            if (ql * va + qr * vb + qm * va * vb + qo * vc + qc) % q != 0:
                origin = (cs.gate_origins[j]
                          if j < len(cs.gate_origins) else None)
                where = f" (at {origin})" if origin else ""
                raise SparseUnsatisfiedError(f"gate {j} unsatisfied{where}")
        a[j], b[j], c[j] = va, vb, vc

    for w in range(len(wires)):
        if wires[w] is None:
            wires[w] = 0
    return wires, a, b, c
