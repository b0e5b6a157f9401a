"""ctypes bridge to the C++ solver core (csrc/solver.cc).

Role parity: gnark-crypto's assembly field arithmetic + the generated Go
solver (SURVEY.md §2.3 "gnark-crypto asm" row — the host-side native layer).
The library is compiled on first use with g++ into
``build/gnark_icicle_tpu_torch/<hash of the source>/`` at the root of the
checkout; absence of a toolchain degrades gracefully to the pure-Python solver.

Copied from gnark_icicle_tpu/native.py:1 (and native/solver.cc into
csrc/solver.cc), so that the port imports nothing of the JAX package;
tests/test_torch_copies.py holds it to the original. Only the source and
build paths differ.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_LIB = None
_LIB_LOCK = threading.Lock()
_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG_DIR, "csrc", "solver.cc")
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build",
                           "gnark_icicle_tpu_torch")


def _build() -> str | None:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = os.path.join(_BUILD_ROOT, tag)
    out = os.path.join(out_dir, "libsolver.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        os.makedirs(out_dir, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-march=native", "-fopenmp",
             "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)  # a half-written library is never loaded
        return out
    except Exception:
        return None


def get_lib():
    """The loaded library, or None when unavailable."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB or None
        path = _build()
        if path is None:
            _LIB = False
            return None
        lib = ctypes.CDLL(path)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_longlong)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.r1cs_solve_run.restype = ctypes.c_longlong
        lib.r1cs_solve_run.argtypes = [
            u64p, ctypes.c_uint64,  # p, inv
            u64p,                   # coeffs
            u32p, u32p,             # term_coeff, term_wire
            i64p, i64p, i64p,       # l_off, r_off, o_off
            i64p,                   # solved_wire
            i64p, ctypes.c_longlong, ctypes.c_longlong,  # order, n_run, n_cons
            u64p, u8p,              # wires, assigned
            u64p, u64p,             # abc, one_mont
        ]
        if hasattr(lib, "r1cs_solve_level"):
            lib.r1cs_solve_level.restype = ctypes.c_longlong
            lib.r1cs_solve_level.argtypes = lib.r1cs_solve_run.argtypes
        lib.from_mont_batch.restype = None
        lib.from_mont_batch.argtypes = [
            u64p, ctypes.c_uint64, u64p, ctypes.c_longlong
        ]
        lib.to_mont_batch.restype = None
        lib.to_mont_batch.argtypes = [
            u64p, ctypes.c_uint64, u64p, u64p, ctypes.c_longlong
        ]
        _LIB = lib
        return lib


def ints_to_u64xn(xs, nl: int = 4) -> np.ndarray:
    out = np.zeros((len(xs), nl), dtype=np.uint64)
    M = 0xFFFFFFFFFFFFFFFF
    for i, x in enumerate(xs):
        x = int(x)
        for j in range(nl):
            out[i, j] = (x >> (64 * j)) & M
    return out


def u64xn_to_ints(arr) -> list:
    arr = np.ascontiguousarray(arr, dtype=np.uint64)
    nl = arr.shape[1]
    return [
        sum(int(r[j]) << (64 * j) for j in range(nl)) for r in arr
    ]


# 4-limb aliases (the common fr case)
def ints_to_u64x4(xs):
    return ints_to_u64xn(xs, 4)


def u64x4_to_ints(arr):
    return u64xn_to_ints(arr)


class NativeField:
    """Host Nx64 Montgomery context for one fr modulus (N = 4 below
    2^256, N = 6 below 2^384 — BW6-761's 377-bit fr)."""

    _cache: dict = {}

    def __new__(cls, q: int):
        if q in cls._cache:
            return cls._cache[q]
        self = super().__new__(cls)
        cls._cache[q] = self
        return self

    def __init__(self, q: int):
        if getattr(self, "_initialized", False):
            return
        self._initialized = True
        assert q < (1 << 384) and q % 2 == 1
        self.nl = 4 if q < (1 << 256) else 6
        self.q = q
        self.R = 1 << (64 * self.nl)
        self.Rinv = pow(self.R, -1, q)
        self.inv64 = (-pow(q, -1, 1 << 64)) % (1 << 64)
        self.p_arr = ints_to_u64xn([q], self.nl)[0].copy()
        self.one_mont = ints_to_u64xn([self.R % q], self.nl)[0].copy()

    def to_mont_ints(self, xs):
        return [int(x) % self.q * self.R % self.q for x in xs]

    def from_mont_int(self, x: int) -> int:
        return x * self.Rinv % self.q


def solve_scs_native(cs, public_values, secret_values, hint_overrides=None):
    """Native-core SCS solve; same contract as constraint.scs.solve_scs.

    Returns None when the native library is unavailable.
    """
    lib = get_lib()
    if lib is None or cs.q >= (1 << 384):
        return None
    entry_name = "scs_solve_run" if cs.q < (1 << 256) else "scs_solve_run6"
    if not hasattr(lib, entry_name):
        return None
    entry = getattr(lib, entry_name)
    if getattr(entry, "argtypes", None) is None:
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_longlong)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        entry.restype = ctypes.c_longlong
        entry.argtypes = [
            u64p, ctypes.c_uint64,
            u32p, u32p, u32p,
            u64p, u64p, u64p, u64p, u64p,
            i64p, i64p, ctypes.c_longlong,
            u64p, u8p, u64p, ctypes.c_longlong, u64p,
        ]
    from .constraint.scs import INSTR_GATE, INSTR_HINT, SparseUnsatisfiedError
    from .constraint.hints import get_hint, hint_name

    q = cs.q
    nf = NativeField(q)
    nl = nf.nl
    if (len(public_values) != cs.nb_public
            or len(secret_values) != cs.nb_secret):
        raise ValueError("bad input lengths")
    nw = max(cs.nb_wires, 1)
    ng = cs.nb_gates
    wires = np.zeros((nw, nl), dtype=np.uint64)
    assigned = np.zeros(nw, dtype=np.uint8)
    init_vals = [int(v) for v in public_values] + [int(v) for v in secret_values]
    if init_vals:
        wires[: len(init_vals)] = ints_to_u64xn(nf.to_mont_ints(init_vals), nl)
        assigned[: len(init_vals)] = 1

    xa = np.asarray(cs.xa, dtype=np.uint32)
    xb = np.asarray(cs.xb, dtype=np.uint32)
    xc = np.asarray(cs.xc, dtype=np.uint32)
    qc_eff = list(cs.qc)
    for j, pv in enumerate(public_values):  # runtime Qk (public gates first)
        qc_eff[j] = (qc_eff[j] + int(pv)) % q
    cols = {}
    for name, col in (("ql", cs.ql), ("qr", cs.qr), ("qm", cs.qm),
                      ("qo", cs.qo), ("qc", qc_eff)):
        cols[name] = ints_to_u64xn(nf.to_mont_ints(col), nl)
    solved = np.asarray(cs.solved_wire, dtype=np.int64)
    abc = np.zeros((3, max(ng, 1), nl), dtype=np.uint64)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    def run(order):
        order = np.asarray(order, dtype=np.int64)
        rc = entry(
            ptr(nf.p_arr, ctypes.c_uint64), ctypes.c_uint64(nf.inv64),
            ptr(xa, ctypes.c_uint32), ptr(xb, ctypes.c_uint32),
            ptr(xc, ctypes.c_uint32),
            ptr(cols["ql"], ctypes.c_uint64), ptr(cols["qr"], ctypes.c_uint64),
            ptr(cols["qm"], ctypes.c_uint64), ptr(cols["qo"], ctypes.c_uint64),
            ptr(cols["qc"], ctypes.c_uint64),
            ptr(solved, ctypes.c_longlong),
            ptr(order, ctypes.c_longlong), len(order),
            ptr(wires, ctypes.c_uint64), ptr(assigned, ctypes.c_uint8),
            ptr(abc, ctypes.c_uint64), ng,
            ptr(nf.one_mont, ctypes.c_uint64),
        )
        if rc >= 0:
            raise SparseUnsatisfiedError(f"gate {int(rc)} unsatisfied (native)")

    def wire_val(w: int) -> int:
        x = sum(int(v) << (64 * j) for j, v in enumerate(wires[w]))
        return nf.from_mont_int(x)

    pending: list = []
    tagged: list = []
    for kind, idx in cs.instructions:
        if kind == INSTR_GATE:
            # commitment rows balance against prover-side columns the C++
            # core cannot see; fill their a/b/c from wires afterwards
            if cs.commitment_tags.get(idx):
                tagged.append(idx)
            else:
                pending.append(idx)
            continue
        if pending:
            run(pending)
            pending = []
        h = cs.hints[idx]
        ins = []
        for expr in h.inputs:
            s = 0
            for coeff, wid in expr:
                if not assigned[wid]:
                    raise SparseUnsatisfiedError(
                        f"hint input wire {wid} unsolved"
                    )
                s += coeff * wire_val(wid)
            ins.append(s % q)
        ins.extend(h.static_args)
        fn = (hint_overrides or {}).get(h.hint_id) or get_hint(h.hint_id)
        outs = fn(q, ins)
        if len(outs) != len(h.outputs):
            raise SparseUnsatisfiedError(
                f"hint {hint_name(h.hint_id)} arity mismatch"
            )
        mont = ints_to_u64xn(nf.to_mont_ints(outs), nl)
        for wid, row in zip(h.outputs, mont):
            wires[wid] = row
            assigned[wid] = 1
    if pending:
        run(pending)

    wires[assigned == 0] = 0
    for j in tagged:
        abc[0, j] = wires[cs.xa[j]]
        abc[1, j] = wires[cs.xb[j]]
        abc[2, j] = wires[cs.xc[j]]
    demont = lib.from_mont_batch if nl == 4 else lib.from_mont_batch6
    demont.restype = None
    demont.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_longlong,
    ]
    demont(
        ptr(nf.p_arr, ctypes.c_uint64), ctypes.c_uint64(nf.inv64),
        ptr(wires, ctypes.c_uint64), nw,
    )
    abc_flat = np.ascontiguousarray(abc[:, :ng].reshape(-1, nl))
    if ng:
        demont(
            ptr(nf.p_arr, ctypes.c_uint64), ctypes.c_uint64(nf.inv64),
            ptr(abc_flat, ctypes.c_uint64), 3 * ng,
        )
    abc_plain = abc_flat.reshape(3, max(ng, 1), nl)[:, :ng]
    return (
        u64xn_to_ints(wires),
        u64xn_to_ints(abc_plain[0]),
        u64xn_to_ints(abc_plain[1]),
        u64xn_to_ints(abc_plain[2]),
    )


def solve_native(cs, public_values, secret_values, hint_overrides=None):
    """Native-core solve; same contract as constraint.solver.solve.

    Returns None when the native library is unavailable (caller falls back).
    """
    lib = get_lib()
    if lib is None or cs.q >= (1 << 384):
        return None
    from .constraint.system import INSTR_R1C, INSTR_HINT
    from .constraint.solver import SolveResult, UnsatisfiedConstraintError
    from .constraint.hints import get_hint, hint_name

    q = cs.q
    nf = NativeField(q)
    nl = nf.nl
    suffix = "" if nl == 4 else "6"
    if not hasattr(lib, "r1cs_solve_run" + suffix):
        return None
    if len(public_values) != cs.nb_public - 1 or len(secret_values) != cs.nb_secret:
        raise ValueError("bad input lengths")

    nw = cs.nb_wires
    n_cons = cs.nb_constraints
    wires = np.zeros((nw, nl), dtype=np.uint64)
    assigned = np.zeros(nw, dtype=np.uint8)
    init_vals = [1] + [int(v) for v in public_values] + [int(v) for v in secret_values]
    wires[: len(init_vals)] = ints_to_u64xn(nf.to_mont_ints(init_vals), nl)
    assigned[: len(init_vals)] = 1

    # staging arrays are pure functions of the (frozen) constraint system —
    # cache them on the CS: rebuilding 4 × ~N-entry lists as numpy each
    # solve cost more than the native solve itself at 2^17 constraints
    stage = getattr(cs, "_native_stage_cache", None)
    if stage is None or stage[0] != (len(cs.term_coeff), len(cs.coeffs), nl):
        stage = (
            (len(cs.term_coeff), len(cs.coeffs), nl),
            ints_to_u64xn(nf.to_mont_ints(cs.coeffs), nl),
            np.asarray(cs.term_coeff, dtype=np.uint32),
            np.asarray(cs.term_wire, dtype=np.uint32),
            np.asarray(cs.l_off + [len(cs.term_coeff)], dtype=np.int64),
            np.asarray(cs.r_off, dtype=np.int64),
            np.asarray(cs.o_off, dtype=np.int64),
            np.asarray(cs.solved_wire, dtype=np.int64),
        )
        cs._native_stage_cache = stage
    _, coeffs_m, term_coeff, term_wire, l_off, r_off, o_off, solved = stage
    abc = np.zeros((3, max(n_cons, 1), nl), dtype=np.uint64)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    run_entry = getattr(lib, "r1cs_solve_run" + suffix)
    level_entry = getattr(lib, "r1cs_solve_level" + suffix, None)
    for e in (run_entry, level_entry):
        if e is not None and getattr(e, "argtypes", None) is None:
            e.restype = ctypes.c_longlong
            e.argtypes = lib.r1cs_solve_run.argtypes

    def run(order, level_parallel=False):
        order = np.asarray(order, dtype=np.int64)
        entry = (level_entry
                 if level_parallel and level_entry is not None
                 else run_entry)
        rc = entry(
            ptr(nf.p_arr, ctypes.c_uint64), ctypes.c_uint64(nf.inv64),
            ptr(coeffs_m, ctypes.c_uint64),
            ptr(term_coeff, ctypes.c_uint32), ptr(term_wire, ctypes.c_uint32),
            ptr(l_off, ctypes.c_longlong), ptr(r_off, ctypes.c_longlong),
            ptr(o_off, ctypes.c_longlong), ptr(solved, ctypes.c_longlong),
            ptr(order, ctypes.c_longlong), len(order), n_cons,
            ptr(wires, ctypes.c_uint64), ptr(assigned, ctypes.c_uint8),
            ptr(abc, ctypes.c_uint64), ptr(nf.one_mont, ctypes.c_uint64),
        )
        if rc >= 0:
            raise UnsatisfiedConstraintError(
                int(rc), "constraint unsatisfied (native solver)",
                cs.constraint_origins[int(rc)],
            )

    def wire_val(w: int) -> int:
        x = sum(int(v) << (64 * j) for j, v in enumerate(wires[w]))
        return nf.from_mont_int(x)

    def run_hint(idx):
        h = cs.hints[idx]
        ins = []
        for expr in h.inputs:
            s = 0
            for cid, wid in expr:
                if not assigned[wid]:
                    raise UnsatisfiedConstraintError(
                        -1, f"hint input wire {wid} unsolved"
                    )
                s += cs.coeffs[cid] * wire_val(wid)
            ins.append(s % q)
        ins.extend(h.static_args)
        fn = (hint_overrides or {}).get(h.hint_id) or get_hint(h.hint_id)
        try:
            outs = fn(q, ins)
        except Exception as e:  # noqa: BLE001
            raise UnsatisfiedConstraintError(
                -1, f"hint {hint_name(h.hint_id)} failed: {e}"
            ) from e
        if len(outs) != len(h.outputs):
            raise UnsatisfiedConstraintError(
                -1, f"hint {hint_name(h.hint_id)} arity mismatch"
            )
        mont = ints_to_u64xn(nf.to_mont_ints(outs), nl)
        for wid, row in zip(h.outputs, mont):
            wires[wid] = row
            assigned[wid] = 1

    if os.environ.get("GNARK_TPU_LEVEL_SOLVE", "1") == "1":
        # dependency-levelled schedule (≙ the reference's Levels + per-level
        # worker pool, with its ≥50-constraints-per-task floor,
        # constraint/solver/options.go:60-80): a level only pays the
        # OpenMP-entry cost when it is wide enough to amortize it. Narrow
        # levels — e.g. a pure dependency CHAIN, where every level holds ONE
        # constraint — are coalesced into sequential native batches; level
        # order already is a valid sequential order, so this is exact.
        # (Without this, a 2^17-constraint chain made 131k ctypes+OpenMP
        # calls ≈ 50 s of pure dispatch; one sequential call is ~ms.)
        # The flattened step list is cached on the CS with the order arrays
        # prebuilt — list→numpy of a 2^17-entry order was ~0.5 s per solve.
        sched = getattr(cs, "_native_sched_cache", None)
        skey = (len(cs.instructions), len(cs.term_coeff))
        if sched is None or sched[0] != skey:
            par_min = max(256, 64 * (os.cpu_count() or 1))
            steps: list = []  # ("run", order_np, parallel) | ("hint", idx)
            seq: list = []

            def _flush_seq():
                if seq:
                    steps.append(
                        ("run", np.asarray(seq, dtype=np.int64), False))
                    seq.clear()

            for level in cs.compute_levels():
                wide = len(level) >= par_min
                batch = []
                for pos in level:
                    kind, idx = cs.instructions[pos]
                    if kind == INSTR_R1C:
                        (batch if wide else seq).append(idx)
                    else:
                        # seq holds earlier-level work: it goes first
                        _flush_seq()
                        if batch:
                            steps.append((
                                "run",
                                np.asarray(batch, dtype=np.int64), True))
                            batch = []
                        steps.append(("hint", idx))
                if batch:
                    _flush_seq()
                    steps.append(
                        ("run", np.asarray(batch, dtype=np.int64), True))
            _flush_seq()
            sched = (skey, steps)
            cs._native_sched_cache = sched
        for step in sched[1]:
            if step[0] == "run":
                run(step[1], level_parallel=step[2])
            else:
                run_hint(step[1])
    else:
        pending: list = []
        for kind, idx in cs.instructions:
            if kind == INSTR_R1C:
                pending.append(idx)
                continue
            if pending:
                run(pending)
                pending = []
            run_hint(idx)
        if pending:
            run(pending)

    # batch Montgomery -> plain in C++ (the Python bigint path here would
    # dominate the whole solve)
    wires[assigned == 0] = 0
    demont = lib.from_mont_batch if nl == 4 else lib.from_mont_batch6
    demont.restype = None
    demont.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_longlong,
    ]
    demont(
        ptr(nf.p_arr, ctypes.c_uint64), ctypes.c_uint64(nf.inv64),
        ptr(wires, ctypes.c_uint64), nw,
    )
    abc_flat = np.ascontiguousarray(abc[:, :n_cons].reshape(-1, nl))
    demont(
        ptr(nf.p_arr, ctypes.c_uint64), ctypes.c_uint64(nf.inv64),
        ptr(abc_flat, ctypes.c_uint64), 3 * n_cons,
    )
    abc_plain = abc_flat.reshape(3, n_cons, nl)
    res = SolveResult(u64={
        "wires": wires,
        "a": abc_plain[0], "b": abc_plain[1], "c": abc_plain[2],
    })

    # println resolution mirrors the Python path
    if cs.log_entries:
        from .logger import logger

        for entry in cs.log_entries:
            parts = []
            for kind2, payload in entry:
                if kind2 == "const":
                    parts.append(str(payload))
                else:
                    s = sum(cs.coeffs[cid] * res.wires[wid]
                            for cid, wid in payload)
                    parts.append(str(s % q))
            logger().info("circuit: %s", " ".join(parts))
    return res
