"""GKR protocol: host prover + in-circuit verifier over layered circuits.

Role parity: reference std/gkr (gkr.go — Gate/Wire/Circuit over multilinear
wire assignments, one eq·gate sumcheck per wire walked output-to-input with
a claims manager combining multiple downstream claims by a random
coefficient) and the host prover role of gnark-crypto's gkr package (reached
through constraint/bn254/gkr.go solve hints in the reference).

Prover and verifier share the transcript and sumcheck code
(std/sumcheck.py); the prover runs them with the test engine as its api, so
challenges agree by construction. Structural simplification vs the
reference (documented): input wires' claims are checked by evaluating the
input multilinear directly in-circuit (O(2ⁿ) muls per claim) instead of a
dedicated input sumcheck — same statement, fewer moving parts.

Copied from gnark_icicle_tpu/std/gkr.py:1, so that the port imports nothing of
the JAX package; tests/test_torch_std.py holds it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .fiat_shamir import CircuitTranscript
from .polynomial import Polynomial
from . import sumcheck as sc


# ---------------------------------------------------------------------------
# gates & circuit topology (≙ gkr.Gate / Wire / Circuit, gkr.go:18-56)
# ---------------------------------------------------------------------------

class AddGate:
    degree = 1

    @staticmethod
    def evaluate(api, *ins):
        return ins[0] if len(ins) == 1 else api.add(*ins)


class MulGate:
    degree = 2

    @staticmethod
    def evaluate(api, a, b):
        return api.mul(a, b)


class IdentityGate:
    degree = 1

    @staticmethod
    def evaluate(api, a):
        return a


@dataclass
class Wire:
    gate: object = None      # None => input wire
    inputs: list = field(default_factory=list)  # indices of input wires

    @property
    def is_input(self) -> bool:
        return self.gate is None


class Circuit:
    """Wires in topological order (inputs before consumers)."""

    def __init__(self, wires: list):
        self.wires = wires
        n = len(wires)
        self.nb_unique_outputs = [0] * n
        for w in wires:
            for u in sorted(set(w.inputs)):
                self.nb_unique_outputs[u] += 1
        for i, w in enumerate(wires):
            for u in w.inputs:
                assert u < i, "wires must be topologically ordered"

    def is_output(self, i: int) -> bool:
        return self.nb_unique_outputs[i] == 0

    def nb_claims(self, i: int) -> int:
        return 1 if self.is_output(i) else self.nb_unique_outputs[i]


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _eq_table(api, z: list) -> list:
    """eq(z, ·) over the hypercube with z[0] on the HIGHEST index bit —
    consistent with Polynomial.eval_multilinear, which folds at[0] against
    the table halves. (Each concatenation step makes the just-processed
    variable the new top bit, so iterate in reverse.)"""
    tab = [1]
    for zk in reversed(z):
        one_m = api.sub(1, zk)
        tab = [api.mul(e, one_m) for e in tab] + [api.mul(e, zk) for e in tab]
    return tab


def _fold(api, tab: list, r) -> list:
    half = len(tab) // 2
    return [
        api.add(tab[i], api.mul(r, api.sub(tab[half + i], tab[i])))
        for i in range(half)
    ]


def _extend(api, tab: list, t: int) -> list:
    """Table at X_j = t for a small integer t (linear extension)."""
    half = len(tab) // 2
    if t == 0:
        return tab[:half]
    if t == 1:
        return tab[half:]
    return [
        api.add(tab[i], api.mul(t, api.sub(tab[half + i], tab[i])))
        for i in range(half)
    ]


def _transcript_names(circuit: Circuit, n_vars: int) -> list:
    names = [f"gkr.z.{i}" for i in range(n_vars)]
    for i in reversed(range(len(circuit.wires))):
        if not circuit.wires[i].is_input:
            names += sc.challenge_names(
                f"gkr.w{i}.", circuit.nb_claims(i), n_vars
            )
    return names


def _unique_inputs(wire: Wire) -> list:
    seen = []
    for u in wire.inputs:
        if u not in seen:
            seen.append(u)
    return seen


# ---------------------------------------------------------------------------
# claims (≙ eqTimesGateEvalSumcheckClaims / LazyClaims, gkr.go:62-260)
# ---------------------------------------------------------------------------

class _WireClaims:
    """One wire's accumulated claims, usable as both prover and verifier
    sumcheck claims. As verifier claims, verify_final_eval also feeds the
    downstream claims into `manager` (≙ claimsManager, gkr.go)."""

    def __init__(self, api, circuit, wire_idx, points, values,
                 assignments=None, manager=None):
        self.api = api
        self.circuit = circuit
        self.wire = circuit.wires[wire_idx]
        self.points = points
        self.values = values
        self.n_vars = len(points[0])
        self.manager = manager
        # prover state
        self.assignments = assignments
        self._tabs = None
        self._eq = None
        self.r = []

    # -- shared (verifier) interface ---------------------------------------
    def claims_num(self):
        return len(self.points)

    def vars_num(self):
        return self.n_vars

    def degree(self, j):
        return 1 + self.wire.gate.degree

    def combined_sum(self, api, comb):
        acc = self.values[0]
        pw = comb
        for v in self.values[1:]:
            acc = api.add(acc, api.mul(v, pw))
            pw = api.mul(pw, comb)
        return acc if len(self.values) > 1 else self.values[0]

    def verify_final_eval(self, api, r, comb, purported, final_proof):
        poly = Polynomial(api)
        # Σ comb^i eq(z_i, r) by Horner from the last point (gkr.go:71-79)
        ev = poly.eval_equal(self.points[-1], r)
        for i in range(len(self.points) - 2, -1, -1):
            ev = api.mul(ev, comb)
            ev = api.add(ev, poly.eval_equal(self.points[i], r))
        uniq = _unique_inputs(self.wire)
        eval_by_wire = dict(zip(uniq, final_proof))
        gate_ins = [eval_by_wire[u] for u in self.wire.inputs]
        gate_val = self.wire.gate.evaluate(api, *gate_ins)
        api.assert_is_equal(api.mul(ev, gate_val), purported)
        if self.manager is not None:
            for u, e_u in zip(uniq, final_proof):
                self.manager[u][0].append(list(r))
                self.manager[u][1].append(e_u)

    # -- prover interface ---------------------------------------------------
    def _g_evals(self, comb_unused=None):
        """[g(1)..g(D)] for the current variable from the live tables."""
        api = self.api
        D = self.degree(0)
        out = []
        for t in range(1, D + 1):
            eq_t = _extend(api, self._eq, t)
            tabs_t = [_extend(api, tab, t) for tab in self._tabs]
            terms = []
            for i in range(len(eq_t)):
                gate_ins = [tabs_t[self._pos[u]][i]
                            for u in self.wire.inputs]
                terms.append(api.mul(
                    eq_t[i], self.wire.gate.evaluate(api, *gate_ins)))
            out.append(terms[0] if len(terms) == 1 else api.add(*terms))
        return out

    def combine(self, comb):
        api = self.api
        uniq = _unique_inputs(self.wire)
        self._pos = {u: k for k, u in enumerate(uniq)}
        self._tabs = [list(self.assignments[u]) for u in uniq]
        eq = _eq_table(api, self.points[0])
        pw = comb
        for pt in self.points[1:]:
            tab = _eq_table(api, pt)
            eq = [api.add(e, api.mul(t, pw)) for e, t in zip(eq, tab)]
            pw = api.mul(pw, comb)
        self._eq = eq
        return self._g_evals()

    def next(self, rj):
        api = self.api
        self.r.append(rj)
        self._eq = _fold(api, self._eq, rj)
        self._tabs = [_fold(api, tab, rj) for tab in self._tabs]
        if len(self._eq) == 1:
            return None  # all variables bound; prove_final_eval is next
        return self._g_evals()

    def prove_final_eval(self):
        # all folds applied: each table holds exactly V_u(r)
        assert all(len(t) == 1 for t in self._tabs)
        return [tab[0] for tab in self._tabs]


# ---------------------------------------------------------------------------
# prover / verifier (≙ gkr.Prove role in gnark-crypto + gkr.Verify)
# ---------------------------------------------------------------------------

@dataclass
class GkrProof:
    # wire idx (non-input, reverse topo order) -> SumcheckProof
    sumchecks: dict = field(default_factory=dict)


def evaluate_circuit(api, circuit: Circuit, inputs: dict) -> dict:
    """Forward evaluation: {input wire idx: [2^n values]} -> all wires."""
    assign = {i: list(v) for i, v in inputs.items()}
    n_inst = len(next(iter(inputs.values())))
    for i, w in enumerate(circuit.wires):
        if w.is_input:
            assert i in assign, f"missing input assignment for wire {i}"
            continue
        assign[i] = [
            w.gate.evaluate(api, *[assign[u][k] for u in w.inputs])
            for k in range(n_inst)
        ]
    return assign


def _initial_claims(api, circuit, assignments, transcript, n_vars):
    """Bind outputs, draw the common evaluation point z, claim each output
    wire's multilinear at z."""
    poly = Polynomial(api)
    out_wires = [i for i in range(len(circuit.wires)) if circuit.is_output(i)]
    out_values = []
    for i in out_wires:
        out_values.extend(assignments[i])
    transcript.bind("gkr.z.0", out_values)
    z = [transcript.compute_challenge(f"gkr.z.{i}") for i in range(n_vars)]
    claims = {i: ([], []) for i in range(len(circuit.wires))}
    for i in out_wires:
        claims[i][0].append(z)
        claims[i][1].append(poly.eval_multilinear(z, assignments[i]))
    return claims


def prove(api, circuit: Circuit, assignments: dict) -> GkrProof:
    """Host prover: run with the test engine as api over int assignments
    (≙ the gnark-crypto gkr prover the reference reaches via solve hints)."""
    n_inst = len(next(iter(assignments.values())))
    n_vars = (n_inst - 1).bit_length()
    assert n_inst == 1 << n_vars and n_vars >= 1
    transcript = CircuitTranscript(
        api, api.q, _transcript_names(circuit, n_vars)
    )
    claims = _initial_claims(api, circuit, assignments, transcript, n_vars)
    proof = GkrProof()
    for i in reversed(range(len(circuit.wires))):
        w = circuit.wires[i]
        if w.is_input:
            continue
        pts, vals = claims[i]
        wc = _WireClaims(api, circuit, i, pts, vals, assignments=assignments)
        sp = sc.prove(api, wc, transcript, prefix=f"gkr.w{i}.")
        proof.sumchecks[i] = sp
        for u, ev in zip(_unique_inputs(w), sp.final_eval_proof):
            claims[u][0].append(list(wc.r))
            claims[u][1].append(ev)
    return proof


def verify(api, circuit: Circuit, inputs: dict, outputs: dict,
           proof: GkrProof, n_vars: int) -> None:
    """In-circuit verifier (≙ gkr.Verify, gkr.go:330+).

    inputs/outputs: {wire idx: [2ⁿ circuit variables]}. Proof values enter
    as circuit variables (hint outputs or witness). Input-wire claims are
    checked by evaluating the input multilinear directly.
    """
    transcript = CircuitTranscript(
        api, api.q, _transcript_names(circuit, n_vars)
    )
    claims = _initial_claims(api, circuit, outputs, transcript, n_vars)
    for i in reversed(range(len(circuit.wires))):
        w = circuit.wires[i]
        if w.is_input:
            continue
        pts, vals = claims[i]
        wc = _WireClaims(api, circuit, i, pts, vals, manager=claims)
        sc.verify(api, wc, proof.sumchecks[i], transcript,
                  prefix=f"gkr.w{i}.")
    poly = Polynomial(api)
    for i, w in enumerate(circuit.wires):
        if not w.is_input:
            continue
        pts, vals = claims[i]
        for z, c in zip(pts, vals):
            api.assert_is_equal(
                poly.eval_multilinear(z, inputs[i]), c
            )


# ---------------------------------------------------------------------------
# frontend integration (≙ std/gkr/compile.go API/Solution + the solve/prove
# hints of constraint/bn254/gkr.go — here the two hints share closure state
# within one GkrApi instance instead of solver-embedded GkrInfo)
# ---------------------------------------------------------------------------

_gkr_instance_counter = [0]


class GkrApi:
    """Build a GKR circuit over per-instance frontend variables, solve its
    outputs through a hint, and verify the proof in-circuit.

    Usage inside a circuit's define():

        g = GkrApi()
        a = g.import_(list_of_vars)       # 2^k instances
        b = g.import_(other_vars)
        c = g.mul(a, b)
        sol = g.solve(api)
        outs = sol.export(c)              # per-instance output variables
        sol.verify()                      # proof checked in-circuit
    """

    def __init__(self):
        from ..constraint import hints as hintlib

        self.wires: list = []
        self.assignments: dict = {}
        self._n_inst = None
        self._state: dict = {}  # shared between the solve and prove hints
        _gkr_instance_counter[0] += 1
        uid = _gkr_instance_counter[0]
        self._solve_hint = hintlib.register_hint(
            self._solve_hint_fn, f"gkr.solve.{uid}"
        )
        self._prove_hint = hintlib.register_hint(
            self._prove_hint_fn, f"gkr.prove.{uid}"
        )

    # -- circuit building ---------------------------------------------------
    def import_(self, assignment: list) -> int:
        """≙ API.Import: new input wire with per-instance values."""
        n = len(assignment)
        assert n & (n - 1) == 0 and n >= 2, "need a power-of-2 instance count"
        if self._n_inst is None:
            self._n_inst = n
        assert n == self._n_inst, "instance count mismatch"
        idx = len(self.wires)
        self.wires.append(Wire())
        self.assignments[idx] = list(assignment)
        return idx

    def _gate(self, gate, ins):
        idx = len(self.wires)
        self.wires.append(Wire(gate, list(ins)))
        return idx

    def add(self, a: int, b: int) -> int:
        return self._gate(AddGate, [a, b])

    def mul(self, a: int, b: int) -> int:
        return self._gate(MulGate, [a, b])

    def named_gate(self, gate, *ins) -> int:
        """≙ API.NamedGate: any low-degree Gate implementation."""
        return self._gate(gate, ins)

    # -- hints (host side; closure state carries values solve -> prove) -----
    def _solve_hint_fn(self, q, inputs):
        from ..frontend.engine import Engine

        circuit = Circuit(self.wires)
        n = self._n_inst
        in_wires = [i for i, w in enumerate(self.wires) if w.is_input]
        vals = {}
        off = 0
        for i in in_wires:
            vals[i] = [v % q for v in inputs[off : off + n]]
            off += n
        eng = Engine(q)
        assign = evaluate_circuit(eng, circuit, vals)
        self._state["assignments"] = assign
        self._state["q"] = q
        outs = []
        for i in range(len(self.wires)):
            if circuit.is_output(i):
                outs.extend(assign[i])
        return outs

    def _prove_hint_fn(self, q, inputs):
        from ..frontend.engine import Engine

        circuit = Circuit(self.wires)
        assign = self._state.get("assignments")
        if assign is None:
            raise RuntimeError("gkr prove hint ran before the solve hint")
        proof = prove(Engine(q), circuit, assign)
        return _serialize_proof(circuit, proof)

    # -- solve / verify ------------------------------------------------------
    def solve(self, api) -> "GkrSolution":
        """≙ API.Solve: one hint call computes every output wire's values."""
        circuit = Circuit(self.wires)
        n = self._n_inst
        ins = []
        for i, w in enumerate(self.wires):
            if w.is_input:
                ins.extend(self.assignments[i])
        out_wires = [i for i in range(len(self.wires))
                     if circuit.is_output(i)]
        outs = api.new_hint(self._solve_hint, len(out_wires) * n, *ins)
        out_vars = {}
        for k, i in enumerate(out_wires):
            out_vars[i] = outs[k * n : (k + 1) * n]
        return GkrSolution(self, api, circuit, out_vars)


class GkrSolution:
    """≙ gkr.Solution (compile.go:94-155)."""

    def __init__(self, gapi, api, circuit, out_vars):
        self.gapi = gapi
        self.api = api
        self.circuit = circuit
        self.out_vars = out_vars

    def export(self, wire_idx: int) -> list:
        return list(self.out_vars[wire_idx])

    def verify(self) -> None:
        """Second hint produces the serialized proof; std.gkr.verify checks
        it against the in-circuit inputs/outputs."""
        gapi, api, circuit = self.gapi, self.api, self.circuit
        n = gapi._n_inst
        n_vars = (n - 1).bit_length()
        size = _proof_size(circuit, n_vars)
        # tie ordering: feed one output var so the solver runs solve first
        first_out = next(iter(self.out_vars.values()))[0]
        proof_vals = api.new_hint(gapi._prove_hint, size, first_out)
        proof = _deserialize_proof(circuit, n_vars, proof_vals)
        inputs = {i: gapi.assignments[i]
                  for i, w in enumerate(gapi.wires) if w.is_input}
        verify(api, circuit, inputs, self.out_vars, proof, n_vars)


def _proof_shape(circuit: Circuit, n_vars: int):
    """[(wire, nb_polys=n_vars, poly_len, nb_final)] in proof order."""
    shape = []
    for i in reversed(range(len(circuit.wires))):
        w = circuit.wires[i]
        if w.is_input:
            continue
        deg = 1 + w.gate.degree
        shape.append((i, n_vars, deg, len(_unique_inputs(w))))
    return shape


def _proof_size(circuit: Circuit, n_vars: int) -> int:
    return sum(nv * d + nf for _, nv, d, nf in _proof_shape(circuit, n_vars))


def _serialize_proof(circuit: Circuit, proof: GkrProof) -> list:
    n_vars = len(next(iter(proof.sumchecks.values())).partial_sum_polys)
    out = []
    for i, nv, d, nf in _proof_shape(circuit, n_vars):
        sp = proof.sumchecks[i]
        for poly in sp.partial_sum_polys:
            assert len(poly) == d
            out.extend(poly)
        assert len(sp.final_eval_proof) == nf
        out.extend(sp.final_eval_proof)
    return out


def _deserialize_proof(circuit: Circuit, n_vars: int, vals: list) -> GkrProof:
    from .sumcheck import SumcheckProof

    proof = GkrProof()
    off = 0
    for i, nv, d, nf in _proof_shape(circuit, n_vars):
        polys = []
        for _ in range(nv):
            polys.append(list(vals[off : off + d]))
            off += d
        fin = list(vals[off : off + nf])
        off += nf
        proof.sumchecks[i] = SumcheckProof(polys, fin)
    return proof
