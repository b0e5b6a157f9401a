"""Witness solver: instruction-ordered wire derivation + a/b/c vector fill.

Role parity: gnark's generated per-curve solver (reference:
constraint/bn254/solver.go:58 newSolver, :426 run, :540 solveR1C, :205
solveWithHint). The reference levels instructions into a DAG and runs a
goroutine pool per level; here the instruction stream is already in
dependency order (the builder emits producers before consumers) and host
solving is a single pass — per-level batching onto the device is a planned
optimization, the sequential order is the correctness baseline.

Outputs: the full wire assignment plus the per-constraint evaluation vectors
a, b, c (L·R = O) the Groth16 prover consumes (≙ solver.go a/b/c fill).

Copied from gnark_icicle_tpu/constraint/solver.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_copies.py holds it to the original.
``SolveResult._u16`` (:55) goes through :func:`solved_u32`, which reads the
native solver's (N, 4) or (N, 6) uint64 arrays as (N, 8) or (N, 12) 32-bit
limbs, the layout of the port's kernels, and converts Python ints itself
where the reference reaches its JAX MSM module.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .system import R1CS, INSTR_R1C, INSTR_HINT
from .hints import get_hint, hint_name


class UnsatisfiedConstraintError(Exception):
    def __init__(self, idx, msg, origin=None):
        self.idx = idx
        self.origin = origin
        where = f" ({origin})" if origin else ""
        super().__init__(f"constraint #{idx} unsatisfied{where}: {msg}")


class SolveResult:
    """Solved assignment + a/b/c vectors.

    The native path stores plain-form (N, 4)-uint64 numpy arrays and
    materializes Python ints lazily; `*_u16()` accessors expose the device
    16-bit-limb layout as zero-copy views (the prover's fast path).
    """

    def __init__(self, wires=None, a=None, b=None, c=None, u64=None):
        self._ints = {"wires": wires, "a": a, "b": b, "c": c}
        self._u64 = u64 or {}

    def _get(self, name):
        if self._ints[name] is None:
            from ..native import u64x4_to_ints

            self._ints[name] = u64x4_to_ints(self._u64[name])
        return self._ints[name]

    wires = property(lambda s: s._get("wires"))
    a = property(lambda s: s._get("a"))
    b = property(lambda s: s._get("b"))
    c = property(lambda s: s._get("c"))

    def _u16(self, name):
        """(N, 16) int32 16-bit-limb view (plain form, device layout); as
        the original, the native solve's full width ((N, 24) for 6 words)."""
        from ..ops.field import repack32_to_16

        words = 2 * self._u64[name].shape[1] if name in self._u64 else 8
        return repack32_to_16(solved_u32(self, name, words))

    def wires_u16(self):
        return self._u16("wires")

    def a_u16(self):
        return self._u16("a")

    def b_u16(self):
        return self._u16("b")

    def c_u16(self):
        return self._u16("c")


def solved_u32(res, name: str, n_words: int) -> np.ndarray:
    """``res.<name>`` (wires, a, b or c) as (N, n_words) uint32 plain-form
    limbs: n_words = ``ops.field.words_for(q)`` of the scalar field, 8 below
    2^255 and 12 for BW6-761's 377-bit r. The native solver's (N, 4) or
    (N, 6) 64-bit words are viewed as 32-bit words of that count."""
    if name in res._u64:
        arr = np.ascontiguousarray(res._u64[name], dtype="<u8")
        out = arr.view("<u4").reshape(arr.shape[0], -1).astype(np.uint32)
        if out.shape[1] != n_words:
            raise ValueError(f"the native solve holds {out.shape[1]} words, "
                             f"not {n_words}")
        return out
    from ..ops.field import ints_to_limbs32

    return ints_to_limbs32(res._ints[name], n_words)


def solve(cs: R1CS, public_values: list, secret_values: list,
          native: str | bool = "auto", hint_overrides=None) -> SolveResult:
    """Derive all wires from the input assignment.

    public_values: values of public wires 1..nb_public-1 (ONE is implicit)
    secret_values: values of the nb_secret secret wires
    native: True / False / "auto" — large systems route through the C++
    4x64-Montgomery core (the port's native.py, ≙ gnark-crypto's asm
    layer); identical results, orders of magnitude faster host solve.
    hint_overrides: {hint_id: fn} replacing registered hints for this solve
    (≙ solver.OverrideHint — the BSB22 prover path, prove.go:82-84).
    """
    # the C++ core covers 4×64 and 6×64 limb fields; anything over 384
    # bits falls back to the Python solver
    if cs.q >= (1 << 384):
        native = False
    if native is True or (native == "auto" and cs.nb_constraints >= 512):
        from ..native import solve_native

        res = solve_native(cs, public_values, secret_values,
                           hint_overrides=hint_overrides)
        if res is not None:
            return res
    q = cs.q
    if len(public_values) != cs.nb_public - 1:
        raise ValueError(
            f"expected {cs.nb_public - 1} public values, got {len(public_values)}"
        )
    if len(secret_values) != cs.nb_secret:
        raise ValueError(
            f"expected {cs.nb_secret} secret values, got {len(secret_values)}"
        )

    wires = [None] * cs.nb_wires
    wires[0] = 1
    for i, v in enumerate(public_values):
        wires[1 + i] = int(v) % q
    for i, v in enumerate(secret_values):
        wires[cs.nb_public + i] = int(v) % q

    coeffs = cs.coeffs
    tc, tw = cs.term_coeff, cs.term_wire
    a = [0] * cs.nb_constraints
    b = [0] * cs.nb_constraints
    c = [0] * cs.nb_constraints

    def eval_slot(start, end, skip_wire=-1):
        """Σ coeff·wire over [start,end); returns (sum, unknown_coeff) where
        unknown_coeff is the coefficient of skip_wire (0 if absent)."""
        s = 0
        unk = 0
        for t in range(start, end):
            w = tw[t]
            if w == skip_wire and wires[w] is None:
                unk = coeffs[tc[t]]
                continue
            v = wires[w]
            if v is None:
                raise UnsatisfiedConstraintError(
                    -1, f"wire {w} used before solved"
                )
            s += coeffs[tc[t]] * v
        return s % q, unk

    for kind, idx in cs.instructions:
        if kind == INSTR_HINT:
            h = cs.hints[idx]
            inputs = []
            for expr in h.inputs:
                s = 0
                for cid, wid in expr:
                    v = wires[wid]
                    if v is None:
                        raise UnsatisfiedConstraintError(
                            -1, f"hint input wire {wid} unsolved"
                        )
                    s += coeffs[cid] * v
                inputs.append(s % q)
            inputs.extend(h.static_args)
            fn = (hint_overrides or {}).get(h.hint_id) or get_hint(h.hint_id)
            try:
                outs = fn(q, inputs)
            except Exception as e:  # noqa: BLE001 — hint errors surface as solve errors
                raise UnsatisfiedConstraintError(
                    -1, f"hint {hint_name(h.hint_id)} failed: {e}"
                ) from e
            if len(outs) != len(h.outputs):
                raise UnsatisfiedConstraintError(
                    -1,
                    f"hint {hint_name(h.hint_id)} returned {len(outs)} values, "
                    f"want {len(h.outputs)}",
                )
            for wid, v in zip(h.outputs, outs):
                wires[wid] = int(v) % q
            continue

        # R1C
        j = idx
        (ls, le), (rs, re), (os_, oe) = cs.constraint_slots(j)
        sw = cs.solved_wire[j]
        if sw >= 0 and wires[sw] is None:
            lv, lu = eval_slot(ls, le, sw)
            rv, ru = eval_slot(rs, re, sw)
            ov, ou = eval_slot(os_, oe, sw)
            n_unknown = (lu != 0) + (ru != 0) + (ou != 0)
            if n_unknown != 1:
                raise UnsatisfiedConstraintError(
                    j, "constraint does not have exactly one unknown slot",
                    cs.constraint_origins[j],
                )
            if ou:
                # L·R = ov + ou·w
                w = (lv * rv - ov) * pow(ou, -1, q) % q
            elif lu:
                # (lv + lu·w)·R = O  →  w = (ov − lv·rv) / (lu·rv)
                den = lu * rv % q
                if den == 0:
                    raise UnsatisfiedConstraintError(
                        j, "division by zero while solving",
                        cs.constraint_origins[j],
                    )
                w = (ov - lv * rv) * pow(den, -1, q) % q
            else:
                den = ru * lv % q
                if den == 0:
                    raise UnsatisfiedConstraintError(
                        j, "division by zero while solving",
                        cs.constraint_origins[j],
                    )
                w = (ov - lv * rv) * pow(den, -1, q) % q
            wires[sw] = w
            lv2, rv2, ov2 = (
                (lv + (lu * w if lu else 0)) % q,
                (rv + (ru * w if ru else 0)) % q,
                (ov + (ou * w if ou else 0)) % q,
            )
        else:
            lv2, _ = eval_slot(ls, le)
            rv2, _ = eval_slot(rs, re)
            ov2, _ = eval_slot(os_, oe)
        if lv2 * rv2 % q != ov2:
            raise UnsatisfiedConstraintError(
                j,
                f"{lv2} × {rv2} ≠ {ov2} (mod q)",
                cs.constraint_origins[j],
            )
        a[j], b[j], c[j] = lv2, rv2, ov2

    for w, v in enumerate(wires):
        if v is None:
            wires[w] = 0  # unreferenced internal wires default to 0

    # resolve api.Println entries now that wires are known (≙ solver
    # LogEntry resolution, constraint/bn254/solver.go:256-326)
    if cs.log_entries:
        from ..logger import logger

        for entry in cs.log_entries:
            parts = []
            for kind, payload in entry:
                if kind == "const":
                    parts.append(str(payload))
                else:
                    s = sum(coeffs[cid] * wires[wid] for cid, wid in payload)
                    parts.append(str(s % q))
            logger().info("circuit: %s", " ".join(parts))

    return SolveResult(wires, a, b, c)


def is_satisfied(cs: R1CS, public_values, secret_values) -> bool:
    try:
        solve(cs, public_values, secret_values)
        return True
    except UnsatisfiedConstraintError:
        return False
