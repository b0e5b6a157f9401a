"""Array-oriented R1CS constraint system (the framework's IR).

Role parity: gnark's ``constraint.System`` + per-curve R1CS
(reference: constraint/core.go:77-130 System, constraint/r1cs.go:150 R1C,
constraint/term.go:31 Term{CID,VID}). Design differences, deliberate and
TPU-first (SURVEY.md §7 "make the IR array-oriented"):

* Terms live in flat structure-of-arrays (coeff-id / wire-id int arrays with
  CSR offsets), not per-instruction packed blueprints — the prover and setup
  consume the whole system as batched sparse-matrix-like passes, and numpy
  views of these arrays feed device kernels directly.
* Coefficients are interned in one table (≙ gnark's CoeffTable,
  constraint/bn254/coeff.go) with the same four reserved ids.

Wire numbering (matches gnark's ordering semantics, frontend/compile.go:83-112):
wire 0 is the constant ONE public wire, then public inputs, then secret
inputs, then internal wires.

Copied from gnark_icicle_tpu/constraint/system.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# reserved coefficient ids (≙ constraint/core.go CoeffIdZero..CoeffIdMinusOne)
COEFF_ZERO = 0
COEFF_ONE = 1
COEFF_TWO = 2
COEFF_MINUS_ONE = 3

# instruction kinds
INSTR_R1C = 0
INSTR_HINT = 1


@dataclass
class Groth16Commitment:
    """One BSB22 commitment (≙ constraint.Groth16Commitment,
    reference: constraint/commitment.go:9-14).

    public_and_commitment_committed: sorted wire ids of committed public
    wires followed by committed earlier-commitment wires;
    private_committed: sorted ids of committed private/internal wires;
    commitment_index: the commitment's own wire id (the hint output).
    """

    public_and_commitment_committed: list
    nb_public_committed: int
    private_committed: list
    commitment_index: int


@dataclass
class HintInstr:
    hint_id: int
    # inputs: list of linear expressions, each a list of (coeff_id, wire_id)
    inputs: list
    outputs: list  # wire ids written
    # static (non-field-element) extra args appended to the input values
    static_args: tuple = ()


class R1CS:
    """Rank-1 constraint system over a prime field fr.

    Constraints are (L · R = O) triples of linear expressions. The terms of
    all three slots are stored in one flat term array; constraint j's slots
    are [l_off[j], r_off[j]) / [r_off[j], o_off[j]) / [o_off[j], l_off[j+1]).
    """

    def __init__(self, field_modulus: int):
        self.q = field_modulus
        # interned coefficient table
        self.coeffs: list[int] = [0, 1, 2, field_modulus - 1]
        self._coeff_index: dict[int, int] = {
            0: 0, 1: 1, 2: 2, field_modulus - 1: 3
        }
        # wires
        self.nb_public = 1  # wire 0 = ONE
        self.nb_secret = 0
        self.nb_internal = 0
        self.public_names: list[str] = ["one"]
        self.secret_names: list[str] = []
        # flat term storage
        self.term_coeff: list[int] = []
        self.term_wire: list[int] = []
        # per-constraint slot offsets into the term arrays
        self.l_off: list[int] = []
        self.r_off: list[int] = []
        self.o_off: list[int] = []
        # solve metadata per constraint: wire to solve for (-1 = check only)
        self.solved_wire: list[int] = []
        # instruction stream: (kind, index) — R1C index or HintInstr index
        self.instructions: list[tuple] = []
        self.hints: list[HintInstr] = []
        # debug/log
        self.log_entries: list = []  # (format, [linear expressions])
        self.constraint_origins: list = []  # optional per-constraint source info
        # BSB22 commitments (≙ System.CommitmentInfo, constraint/core.go)
        self.commitments: list[Groth16Commitment] = []

    def __getstate__(self):
        # the derived level schedule is cheap to rebuild but large to store —
        # keep pickles (checkpoints, .2chain_ck stages) lean
        state = dict(self.__dict__)
        state.pop("_levels_cache", None)
        state.pop("_native_stage_cache", None)
        state.pop("_native_sched_cache", None)
        return state

    # -- sizes ---------------------------------------------------------------
    @property
    def nb_constraints(self) -> int:
        return len(self.l_off)

    @property
    def nb_wires(self) -> int:
        return self.nb_public + self.nb_secret + self.nb_internal

    # -- construction ----------------------------------------------------------
    def coeff_id(self, c: int) -> int:
        c %= self.q
        idx = self._coeff_index.get(c)
        if idx is None:
            idx = len(self.coeffs)
            self.coeffs.append(c)
            self._coeff_index[c] = idx
        return idx

    def add_public(self, name: str) -> int:
        """Returns the new public wire id (public wires precede secret)."""
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

    def add_r1c(self, l_terms, r_terms, o_terms, solved_wire: int = -1,
                origin=None) -> int:
        """Append constraint L·R = O. Terms: [(coeff_id, wire_id), ...].

        solved_wire ≥ 0 marks the single unknown wire the solver derives from
        this constraint (≙ gnark's blueprint solve index).
        """
        from .. import profile as _profile

        if _profile.is_profiling():  # ≙ profile.RecordConstraint (core.go:348)
            _profile.record_constraint()
        if origin is None:
            from .. import debug as _debug

            if _debug.is_debug():  # ≙ -tags=debug stack capture
                origin = _debug.capture_stack()
        base = len(self.term_coeff)
        self.l_off.append(base)
        for cid, wid in l_terms:
            self.term_coeff.append(cid)
            self.term_wire.append(wid)
        self.r_off.append(len(self.term_coeff))
        for cid, wid in r_terms:
            self.term_coeff.append(cid)
            self.term_wire.append(wid)
        self.o_off.append(len(self.term_coeff))
        for cid, wid in o_terms:
            self.term_coeff.append(cid)
            self.term_wire.append(wid)
        self.solved_wire.append(solved_wire)
        self.constraint_origins.append(origin)
        cidx = self.nb_constraints - 1
        self.instructions.append((INSTR_R1C, cidx))
        return cidx

    def add_hint(self, hint_id: int, inputs, outputs, static_args=()) -> None:
        self.hints.append(HintInstr(hint_id, inputs, outputs, tuple(static_args)))
        self.instructions.append((INSTR_HINT, len(self.hints) - 1))

    def compute_levels(self) -> list:
        """Dependency levels over the instruction stream (≙ the compile-time
        instruction tree, constraint/core.go:111-117 + instruction_tree.go).

        Returns a list of levels; each level is a list of instruction
        indices (positions in self.instructions) whose inputs are all
        produced at strictly earlier levels — instructions within one level
        are independently solvable (the reference's per-level worker pool;
        our native core's parallel batch).

        Cached per instruction-stream length: the walk is O(terms) Python
        and the solver calls it on EVERY solve (the reference computes its
        tree once at compile time, core.go:111).
        """
        cache = getattr(self, "_levels_cache", None)
        ckey = (len(self.instructions), len(self.term_coeff))
        if cache is not None and cache[0] == ckey:
            return cache[1]
        n_in = self.nb_public + self.nb_secret
        wire_level: dict[int, int] = {}  # producer level per wire

        def read_level(wids) -> int:
            lvl = -1
            for w in wids:
                if w >= n_in:
                    lvl = max(lvl, wire_level.get(w, -1))
            return lvl

        levels: list[list[int]] = []
        for pos, (kind, idx) in enumerate(self.instructions):
            if kind == INSTR_HINT:
                h = self.hints[idx]
                reads = [w for expr in h.inputs for _, w in expr]
                lvl = read_level(reads) + 1
                for w in h.outputs:
                    wire_level[w] = lvl
            else:
                (ls, _), (_, _), (_, oe) = self.constraint_slots(idx)
                sw = self.solved_wire[idx]
                # the three slots are contiguous in the term arrays
                reads = [
                    self.term_wire[t] for t in range(ls, oe)
                    if self.term_wire[t] != sw
                ]
                lvl = read_level(reads) + 1
                if sw >= 0:
                    wire_level[sw] = lvl
            while len(levels) <= lvl:
                levels.append([])
            levels[lvl].append(pos)
        self._levels_cache = (ckey, levels)
        return levels

    def constraint_slots(self, j: int):
        """Term index ranges (l, r, o) of constraint j."""
        end = self.l_off[j + 1] if j + 1 < len(self.l_off) else len(self.term_coeff)
        return (
            (self.l_off[j], self.r_off[j]),
            (self.r_off[j], self.o_off[j]),
            (self.o_off[j], end),
        )

    # -- SoA views for the prover/setup (zero-copy into device staging) ------
    def term_arrays(self):
        """(coeff_values int-object array, wire int32 array, l/r/o offsets)."""
        coeff_vals = np.array(
            [self.coeffs[c] for c in self.term_coeff], dtype=object
        )
        wires = np.asarray(self.term_wire, dtype=np.int64)
        return coeff_vals, wires, (
            np.asarray(self.l_off + [len(self.term_coeff)], dtype=np.int64),
            np.asarray(self.r_off, dtype=np.int64),
            np.asarray(self.o_off, dtype=np.int64),
        )

    def __repr__(self):
        return (
            f"R1CS(q=…{str(self.q)[-6:]}, constraints={self.nb_constraints}, "
            f"public={self.nb_public}, secret={self.nb_secret}, "
            f"internal={self.nb_internal})"
        )
