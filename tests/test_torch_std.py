"""The rollup and hashing gadgets of the port's std/ and the interactive-proof
verifiers, against the JAX package, on the CPU.

gnark_icicle_tpu_torch holds copies of the JAX package's
``curves/twisted_edwards.py`` (Baby Jubjub, host EdDSA over MiMC) and of
``std/{eddsa, merkle, selector, bitslice, fiat_shamir, polynomial, sumcheck,
gkr, fri, compress_lzss}.py`` and ``std/hash/{keccakf, sha3}.py``. The same
circuits, built over each package's frontend and gadgets (the circuits of
the JAX package's tests/test_std_small.py, test_std_gadgets.py,
test_gkr.py, test_fri.py and test_compress_lzss.py, and the EdDSA and
Merkle circuits of tests/stats_circuits.py), give the same systems and, on
the same inputs, the same wires; a wrong witness is refused by both solvers;
every hint has the JAX package's id. Inputs come from numpy seeds; every
comparison is exact.

Hint ids: ``bitslice.partition`` is registered by name in both packages.
``compress_lzss`` passes its bit hint to ``api.new_hint`` unnamed in the JAX
package, which names it by its module's path; the copy registers it under
that name, so the ids agree. ``GkrApi`` registers ``gkr.solve.{uid}`` and
``gkr.prove.{uid}`` with a process-wide counter in each package: the GKR
test sets both counters to the larger of the two before compiling, so that
the uids are fresh and equal and the systems, ids included, are equal.
"""

import hashlib
import secrets

import pytest

from gnark_icicle_tpu_torch.curves import bn254

from test_torch_emulated import PKGS, _plain, mod, rand_below

Q = bn254.R


@pytest.fixture(autouse=True)
def fixed_mask(monkeypatch):
    """Both packages' api.commit mask (secrets.randbelow: the lookup
    tables of compress_lzss commit) fixed, so that the two solves see one
    witness."""
    monkeypatch.setattr(secrets, "randbelow", lambda m: 0x5EED % m)


def plain(v):
    """Host objects of either package as plain data (dataclasses and dicts
    by their fields and items)."""
    if hasattr(v, "__dataclass_fields__"):
        v = vars(v)
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    return v


def assert_same_system(a, b) -> None:
    """Two compiled systems (R1CS or SCS) hold the same data: each field
    equal as it is (lists of ints), else as test_torch_emulated.state's
    plain data (the hint records and commitments, which are each
    package's own classes)."""
    fields = [cs.__getstate__() if hasattr(cs, "nb_constraints") else vars(cs) for cs in (a, b)]
    keys = [sorted(k for k in f if not k.startswith("_")) for f in fields]
    assert keys[0] == keys[1]
    for k in keys[0]:
        va, vb = fields[0][k], fields[1][k]
        if hasattr(va, "tolist") or va != vb:
            assert _plain(va) == _plain(vb), k


def witness(Circuit, **values) -> tuple:
    return Circuit(**values).witness_values(Q)


def same_systems_and_wires(make, good: dict, bads: tuple = (), builder: str = "r1cs") -> list:
    """make(pkg) -> a circuit class over pkg's frontend and gadgets. Both
    packages compile it to the same system, solve `good` (input values by
    name) to the same wires, and refuse each of `bads`. Returns the two
    systems (the port's first)."""
    systems, wires = [], []
    for pkg in PKGS:
        Circuit = make(pkg)
        cs = mod(pkg, "frontend").compile_circuit(Q, Circuit, builder=builder)
        systems.append(cs)
        if builder == "r1cs":
            solver = mod(pkg, "constraint.solver")
            solve, refused = (lambda *a: list(solver.solve(cs, *a).wires),
                              solver.UnsatisfiedConstraintError)
        else:
            scs = mod(pkg, "constraint.scs")
            solve, refused = (lambda *a: list(scs.solve_scs(cs, *a)[0]),
                              scs.SparseUnsatisfiedError)
        wires.append(solve(*witness(Circuit, **good)))
        for bad in bads:
            with pytest.raises(refused):
                solve(*witness(Circuit, **bad))
    assert_same_system(*systems)
    assert wires[0] == wires[1]
    return systems


# ---------------------------------------------------------------------------
# Baby Jubjub and EdDSA (curves/twisted_edwards.py, std/eddsa.py)
# ---------------------------------------------------------------------------

def signed(pkg: str, seed: int) -> tuple:
    """(public key, msg, R, s) of a package's host EdDSA over MiMC."""
    te = mod(pkg, "curves.twisted_edwards")
    kp = te.generate_key(seed.to_bytes(8, "big"))
    msg = rand_below(seed, Q, 1)[0]
    R, s = te.sign(kp, msg)
    return kp.public, msg, R, s


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_twisted_edwards_host_keys_and_signatures_match(seed):
    """keygen and sign give the same key and signature in both packages;
    both verify it and refuse it over msg + 1, with s + 1 and under another
    key; the group law and scalar product agree."""
    got = [signed(pkg, seed) for pkg in PKGS]
    assert got[0] == got[1]
    pub, msg, R, s = got[0]
    other = signed(PKGS[0], seed + 10)[0]
    k = rand_below(seed + 20, Q, 1)[0]
    for pkg in PKGS:
        te = mod(pkg, "curves.twisted_edwards")
        assert te.is_on_curve(pub) and te.is_on_curve(R)
        assert te.verify(pub, R, s, msg)
        assert not te.verify(pub, R, s, (msg + 1) % Q)
        assert not te.verify(pub, R, (s + 1) % te.SUBGROUP_ORDER, msg)
        assert not te.verify(other, R, s, msg)
    ports = [mod(pkg, "curves.twisted_edwards") for pkg in PKGS]
    assert ports[0].add(pub, R) == ports[1].add(pub, R)
    assert ports[0].scalar_mul(R, k) == ports[1].scalar_mul(R, k)


def eddsa_circuit(pkg: str):
    """tests/stats_circuits.py's EdDSAVerify (std/eddsa_verify: 9,195
    constraints)."""
    fe = mod(pkg, "frontend")
    eddsa = mod(pkg, "std.eddsa")

    class EdDSAVerify(fe.Circuit):
        pub_x = fe.Public()
        pub_y = fe.Public()
        r_x = fe.Secret()
        r_y = fe.Secret()
        s = fe.Secret()
        msg = fe.Public()

        def define(self, api):
            eddsa.verify_signature(api, Q, (self.pub_x, self.pub_y), (self.r_x, self.r_y),
                                   self.s, self.msg)

    return EdDSAVerify


def test_eddsa_verify_signature_matches_reference():
    """The EdDSA gadget: 9,195 constraints (latest_stats.csv) in both
    packages, the same system and wires on a host signature; s + 1 and
    msg + 1 refused by both solvers."""
    pub, msg, R, s = signed(PKGS[0], 4)
    good = dict(pub_x=pub[0], pub_y=pub[1], r_x=R[0], r_y=R[1], s=s, msg=msg)
    systems = same_systems_and_wires(eddsa_circuit, good,
                                     ({**good, "s": s + 1}, {**good, "msg": msg + 1}))
    assert systems[0].nb_constraints == 9_195


# ---------------------------------------------------------------------------
# Merkle paths (std/merkle.py)
# ---------------------------------------------------------------------------

MERKLE_DEPTH = 4


def merkle_circuit(pkg: str):
    """tests/stats_circuits.py's _merkle(depth)."""
    fe = mod(pkg, "frontend")
    merkle = mod(pkg, "std.merkle")

    class Merkle(fe.Circuit):
        root = fe.Public()
        leaf = fe.Secret()
        siblings = fe.Secret(shape=MERKLE_DEPTH)
        dirs = fe.Secret(shape=MERKLE_DEPTH)

        def define(self, api):
            merkle.verify_proof(api, Q, self.root, self.leaf, self.siblings, self.dirs)

    return Merkle


def test_merkle_tree_and_verify_proof_match_reference():
    """MerkleTreeHost gives the same root and proofs in both packages,
    before and after an update; verify_proof at depth 4 compiles to the same
    system and solves to the same wires; a wrong leaf and a flipped
    direction bit are refused by both."""
    leaves = rand_below(5, Q, 1 << MERKLE_DEPTH)
    trees = [mod(pkg, "std.merkle").MerkleTreeHost(Q, leaves) for pkg in PKGS]
    for tree in trees:
        tree.update(6, leaves[6] + 1)
    assert trees[0].root == trees[1].root
    assert all(trees[0].proof(i) == trees[1].proof(i) for i in range(1 << MERKLE_DEPTH))
    sibs, dirs = trees[0].proof(11)
    good = dict(root=trees[0].root, leaf=leaves[11], siblings=sibs, dirs=dirs)
    same_systems_and_wires(merkle_circuit, good, (
        {**good, "leaf": leaves[11] + 1},
        {**good, "dirs": [1 - dirs[0]] + dirs[1:]}))


# ---------------------------------------------------------------------------
# selector, bitslice, fiat_shamir, polynomial (tests/test_std_gadgets.py,
# tests/test_std_small.py)
# ---------------------------------------------------------------------------

def mux_circuit(pkg: str):
    fe = mod(pkg, "frontend")
    selector = mod(pkg, "std.selector")

    class MuxCircuit(fe.Circuit):
        sel = fe.Secret()
        vals = fe.Public(shape=4)
        out = fe.Public()

        def define(self, api):
            api.assert_is_equal(selector.mux(api, self.sel, *self.vals), self.out)

    return MuxCircuit


def map_circuit(pkg: str):
    fe = mod(pkg, "frontend")
    selector = mod(pkg, "std.selector")

    class MapCircuit(fe.Circuit):
        query = fe.Secret()
        out = fe.Public()

        def define(self, api):
            api.assert_is_equal(selector.map_lookup(api, self.query, [5, 9, 13], [50, 90, 130]),
                                self.out)

    return MapCircuit


def mask_circuit(pkg: str):
    fe = mod(pkg, "frontend")
    selector = mod(pkg, "std.selector")

    class MaskCircuit(fe.Circuit):
        length = fe.Secret()
        mask = fe.Public(shape=5)

        def define(self, api):
            for o, m in zip(selector.step_mask(api, self.length, 5), self.mask):
                api.assert_is_equal(o, m)

    return MaskCircuit


SELECTOR_CASES = {
    "mux": (mux_circuit, dict(sel=2, vals=[10, 20, 30, 40], out=30),
            (dict(sel=2, vals=[10, 20, 30, 40], out=99), dict(sel=7, vals=[1, 2, 3, 4], out=1))),
    "map_lookup": (map_circuit, dict(query=9, out=90),
                   (dict(query=9, out=50), dict(query=7, out=50))),
    "step_mask": (mask_circuit, dict(length=3, mask=[1, 1, 1, 0, 0]),
                  (dict(length=3, mask=[1, 1, 0, 0, 0]),)),
}


@pytest.mark.parametrize("case", sorted(SELECTOR_CASES))
def test_selector_gadgets_match_reference(case):
    """mux, map_lookup and step_mask: the same systems and wires; a wrong
    output, an out-of-range selector and a missing key refused by both."""
    make, good, bads = SELECTOR_CASES[case]
    same_systems_and_wires(make, good, bads)


def partition_circuit(pkg: str):
    fe = mod(pkg, "frontend")
    bitslice = mod(pkg, "std.bitslice")

    class PartitionCircuit(fe.Circuit):
        v = fe.Secret()
        lo = fe.Public()
        hi = fe.Public()

        def define(self, api):
            lo, hi = bitslice.partition(api, self.v, 16, nb_digits=64)
            api.assert_is_equal(lo, self.lo)
            api.assert_is_equal(hi, self.hi)

    return PartitionCircuit


def test_bitslice_partition_matches_reference():
    """bitslice.partition: its hint has the JAX package's id (the FNV hash
    of "bitslice.partition") and outputs; the same system and wires; a
    wrong lower half refused by both."""
    v = 0xDEADBEEF12345678
    ids = [mod(pkg, "std.bitslice").PARTITION for pkg in PKGS]
    assert ids[0] == ids[1] == mod(PKGS[0], "constraint.hints").hint_id("bitslice.partition")
    for pkg in PKGS:
        hints = mod(pkg, "constraint.hints")
        assert hints.get_hint(ids[0])(Q, [v, 16]) == [v & 0xFFFF, v >> 16]
    systems = same_systems_and_wires(partition_circuit, dict(v=v, lo=v & 0xFFFF, hi=v >> 16),
                                     (dict(v=v, lo=0, hi=v >> 16),))
    assert [h.hint_id for h in systems[0].hints] == [h.hint_id for h in systems[1].hints]


def transcript_circuit(pkg: str):
    fe = mod(pkg, "frontend")
    fs = mod(pkg, "std.fiat_shamir")

    class FSCircuit(fe.Circuit):
        a = fe.Secret()
        c1 = fe.Public()
        c2 = fe.Public()

        def define(self, api):
            ts = fs.CircuitTranscript(api, Q, ["alpha", "beta"])
            ts.bind("alpha", [self.a])
            api.assert_is_equal(ts.compute_challenge("alpha"), self.c1)
            api.assert_is_equal(ts.compute_challenge("beta"), self.c2)

    return FSCircuit


def test_fiat_shamir_transcript_matches_reference():
    """CircuitTranscript's challenges are the host MiMC's (tag, bound
    values, previous challenge), the same system and wires in both
    packages, a wrong challenge refused; a challenge out of order raises
    ValueError in both."""
    from gnark_icicle_tpu_torch.std.hash.mimc import MiMCHost

    a = rand_below(6, Q, 1)[0]
    h = MiMCHost(Q)
    h.write(int.from_bytes(b"alpha", "big") % Q, a)
    c1 = h.h
    h = MiMCHost(Q)
    h.write(int.from_bytes(b"beta", "big") % Q, a, c1)
    c2 = h.h
    same_systems_and_wires(transcript_circuit, dict(a=a, c1=c1, c2=c2),
                           (dict(a=a, c1=c1, c2=(c2 + 1) % Q),))
    for pkg in PKGS:
        fe = mod(pkg, "frontend")
        fs = mod(pkg, "std.fiat_shamir")

        class BadOrder(fe.Circuit):
            a = fe.Secret()

            def define(self, api):
                ts = fs.CircuitTranscript(api, Q, ["alpha", "beta"])
                ts.bind("alpha", [self.a])
                ts.compute_challenge("beta")

        with pytest.raises(ValueError):
            fe.is_solved(BadOrder(a=1), Q)


COEFFS, ML, LDE = [3, 1, 4, 1, 5], [2, 7, 1, 8], [9, 2, 6, 5]


def poly_circuit(pkg: str):
    """tests/test_std_small.py's PolyCircuit: univariate, multilinear and
    LDE evaluations, and eval_equal."""
    fe = mod(pkg, "frontend")
    poly = mod(pkg, "std.polynomial")

    class PolyCircuit(fe.Circuit):
        at = fe.Secret()
        expect_uni = fe.Public()
        expect_ml = fe.Public()
        expect_lde = fe.Public()
        bits = fe.Secret(shape=2)
        expect_eq = fe.Public()

        def define(self, api):
            p = poly.Polynomial(api)
            api.assert_is_equal(p.eval_univariate(COEFFS, self.at), self.expect_uni)
            api.assert_is_equal(p.eval_multilinear([self.at, api.add(self.at, 1)], ML),
                                self.expect_ml)
            api.assert_is_equal(p.interpolate_lde(self.at, LDE), self.expect_lde)
            api.assert_is_equal(p.eval_equal(self.bits, [1, 0]), self.expect_eq)

    return PolyCircuit


def _ml_eval(at, vals):
    vals = list(vals)
    for x in at:
        half = len(vals) // 2
        vals = [(vals[i] + x * (vals[half + i] - vals[i])) % Q for i in range(half)]
    return vals[0]


def _lde_eval(at, vals):
    acc = 0
    for i, v in enumerate(vals):
        term = v
        for j in range(len(vals)):
            if j != i:
                term = term * ((at - j) % Q) % Q * pow((i - j) % Q, -1, Q) % Q
        acc = (acc + term) % Q
    return acc


@pytest.mark.parametrize("at", [2, 11])
def test_polynomial_gadgets_match_reference(at):
    """Polynomial's evaluations (at an LDE domain point and off it) against
    Python integers, the same system and wires in both packages, a wrong
    value refused; EmulatedPolynomial over secp256k1's r gives the same
    value in both packages' Engines."""
    good = dict(at=at, expect_uni=sum(c * at ** i for i, c in enumerate(COEFFS)) % Q,
                expect_ml=_ml_eval([at, at + 1], ML), expect_lde=_lde_eval(at, LDE),
                bits=[1, 0], expect_eq=1)
    same_systems_and_wires(poly_circuit, good, ({**good, "expect_lde": good["expect_lde"] + 1},
                                                {**good, "bits": [1, 1]}))
    got = []
    for pkg in PKGS:
        em = mod(pkg, "std.emulated")
        f = em.EmulatedField(mod(pkg, "frontend.engine").Engine(Q), em.SECP256K1_FR, Q)
        p = mod(pkg, "std.polynomial").EmulatedPolynomial(f)
        got.append(f.value_hint(f.reduce(p.eval_univariate([f.constant(c) for c in (5, 3, 2)],
                                                           f.constant(10 ** 30 + at)))))
    n = mod(PKGS[0], "std.emulated").SECP256K1_FR.modulus
    assert got[0] == got[1] == sum(c * pow(10 ** 30 + at, i, n)
                                   for i, c in enumerate((5, 3, 2))) % n


# ---------------------------------------------------------------------------
# sumcheck and GKR (tests/test_gkr.py:106-212)
# ---------------------------------------------------------------------------

def square_circuit(gkr):
    """out = a·b + a over 2^k instances (tests/test_gkr.py
    _mimic_square_circuit)."""
    return gkr.Circuit([gkr.Wire(), gkr.Wire(), gkr.Wire(gkr.MulGate, [0, 1]),
                        gkr.Wire(gkr.AddGate, [2, 0])])


def gkr_verifier_circuit(pkg: str):
    """tests/test_gkr.py's GkrCircuit: a GKR proof of the square circuit
    over 4 instances (two sumchecks) verified in-circuit."""
    fe = mod(pkg, "frontend")
    gkr = mod(pkg, "std.gkr")
    sumcheck = mod(pkg, "std.sumcheck")

    class GkrCircuit(fe.Circuit):
        a = fe.Secret(shape=4)
        b = fe.Secret(shape=4)
        out = fe.Public(shape=4)
        psp3 = fe.Secret(shape=(2, 2))
        fin3 = fe.Secret(shape=2)
        psp2 = fe.Secret(shape=(2, 3))
        fin2 = fe.Secret(shape=2)

        def define(self, api):
            proof = gkr.GkrProof(sumchecks={
                3: sumcheck.SumcheckProof([list(r) for r in self.psp3], list(self.fin3)),
                2: sumcheck.SumcheckProof([list(r) for r in self.psp2], list(self.fin2))})
            gkr.verify(api, square_circuit(gkr), {0: list(self.a), 1: list(self.b)},
                       {3: list(self.out)}, proof, 2)

    return GkrCircuit


def test_sumcheck_gkr_prover_and_verifier_match_reference():
    """The host GKR prover (sumcheck's prove under the Engine) gives the same
    assignments and proof in both packages; the in-circuit verifier compiles
    to the same system and solves to the same wires; a wrong output and a
    tampered sumcheck polynomial are refused by both."""
    a, b = rand_below(7, Q, 4), rand_below(8, Q, 4)
    runs = []
    for pkg in PKGS:
        gkr = mod(pkg, "std.gkr")
        eng = mod(pkg, "frontend.engine").Engine(Q)
        assign = gkr.evaluate_circuit(eng, square_circuit(gkr), {0: a, 1: b})
        runs.append((assign, gkr.prove(eng, square_circuit(gkr), assign)))
    assert plain(runs[0][0]) == plain(runs[1][0])
    assert plain(runs[0][1]) == plain(runs[1][1])
    assign, proof = runs[0]
    sc3, sc2 = proof.sumchecks[3], proof.sumchecks[2]
    good = dict(a=a, b=b, out=[int(v) for v in assign[3]],
                psp3=[list(p) for p in sc3.partial_sum_polys], fin3=list(sc3.final_eval_proof),
                psp2=[list(p) for p in sc2.partial_sum_polys], fin2=list(sc2.final_eval_proof))
    wrong_out = [(good["out"][0] + 1) % Q] + good["out"][1:]
    tampered = [[(good["psp2"][0][0] + 1) % Q] + good["psp2"][0][1:]] + good["psp2"][1:]
    same_systems_and_wires(gkr_verifier_circuit, good,
                           ({**good, "out": wrong_out}, {**good, "psp2": tampered}))


def gkr_api_circuit(pkg: str):
    """tests/test_gkr.py's GkrApiCircuit: GkrApi's solve and prove hints
    inside an R1CS, the proof verified in-circuit."""
    fe = mod(pkg, "frontend")
    gkr = mod(pkg, "std.gkr")

    class GkrApiCircuit(fe.Circuit):
        a = fe.Secret(shape=4)
        b = fe.Secret(shape=4)
        want = fe.Public(shape=4)

        def define(self, api):
            g = gkr.GkrApi()
            wa = g.import_(list(self.a))
            wb = g.import_(list(self.b))
            out = g.add(g.mul(wa, wb), wa)
            sol = g.solve(api)
            for o, w in zip(sol.export(out), self.want):
                api.assert_is_equal(o, w)
            sol.verify()

    return GkrApiCircuit


def test_gkr_api_matches_reference_with_aligned_uids():
    """GkrApi in a circuit: with both packages' instance counters set to the
    larger of the two, the two hints are gkr.solve.{uid} and gkr.prove.{uid}
    with the same fresh uid, so the systems are equal, hint ids included;
    each package solves its own system (the hints keep their state in the
    GkrApi that built it) to the same wires, and refuses a wrong output."""
    counters = [mod(pkg, "std.gkr")._gkr_instance_counter for pkg in PKGS]
    top = max(c[0] for c in counters)
    for c in counters:
        c[0] = top
    a, b = rand_below(9, Q, 4), rand_below(10, Q, 4)
    want = [(x * y + x) % Q for x, y in zip(a, b)]
    systems = same_systems_and_wires(gkr_api_circuit, dict(a=a, b=b, want=want),
                                     (dict(a=a, b=b, want=[(w + 1) % Q for w in want]),))
    for pkg, cs in zip(PKGS, systems):
        hints = mod(pkg, "constraint.hints")
        assert [hints.hint_name(h.hint_id) for h in cs.hints
                if hints.hint_name(h.hint_id).startswith("gkr.")] == [
            f"gkr.solve.{top + 1}", f"gkr.prove.{top + 1}"]


# ---------------------------------------------------------------------------
# FRI (tests/test_fri.py:51-98)
# ---------------------------------------------------------------------------

def fri_proof(pkg: str, coeffs: list):
    fri = mod(pkg, "std.fri").Fri(mod(pkg, "curves.bn254").FR, size=4, nb_queries=2)
    return fri, fri.prove(coeffs)


def fri_circuit(pkg: str, coeffs: list):
    fe = mod(pkg, "frontend")
    fri_mod = mod(pkg, "std.fri")
    fri, _ = fri_proof(pkg, coeffs)
    steps = fri.nb_steps

    class FriCircuit(fe.Circuit):
        roots = fe.Public(shape=steps)
        evaluation = fe.Public()
        flat = fe.Secret(shape=sum(2 + 2 * (fri.log_n0 - i) for _ in range(fri.nb_queries)
                                   for i in range(steps)))

        def define(self, api):
            it = iter(self.flat)
            queries = []
            for _ in range(fri.nb_queries):
                rounds = []
                for i in range(steps):
                    d = fri.log_n0 - i
                    lo, hi = next(it), next(it)
                    lo_s = [next(it) for _ in range(d)]
                    hi_s = [next(it) for _ in range(d)]
                    rounds.append(fri_mod.FriQueryRound(lo, hi, lo_s, hi_s))
                queries.append(rounds)
            fri.verify(api, fri_mod.FriProof(roots=list(self.roots),
                                             evaluation=self.evaluation, queries=queries))

    return FriCircuit


def test_fri_prover_and_compiled_verifier_match_reference():
    """Fri's host prover gives the same proof in both packages; its
    verifier as a circuit compiles to the same system and solves to the same
    wires; a tampered opening and a tampered evaluation are refused by
    both."""
    coeffs = rand_below(11, Q, 4)
    proofs = [fri_proof(pkg, coeffs)[1] for pkg in PKGS]
    assert plain(proofs[0]) == plain(proofs[1])
    proof = proofs[0]
    flat = [v for rounds in proof.queries for r in rounds
            for v in [r.lo, r.hi, *r.lo_sibs, *r.hi_sibs]]
    good = dict(roots=proof.roots, evaluation=proof.evaluation, flat=flat)
    same_systems_and_wires(lambda pkg: fri_circuit(pkg, coeffs), good, (
        {**good, "flat": [(flat[0] + 1) % Q] + flat[1:]},
        {**good, "evaluation": (proof.evaluation + 1) % Q}))


# ---------------------------------------------------------------------------
# LZSS decompression (tests/test_compress_lzss.py:119-162)
# ---------------------------------------------------------------------------

LZSS_DATA = b"compress me: abcabcabc abcabcabc!"
LZSS_DICT = b"abc"
BREAK_BITS_NAME = "gnark_icicle_tpu.std.compress_lzss._break_bits_hint"


def lzss_circuit(pkg: str, n_c: int, dict_aug: bytes):
    fe = mod(pkg, "frontend")
    lzss = mod(pkg, "std.compress_lzss")

    class LzssCircuit(fe.Circuit):
        c = fe.Secret(shape=n_c)
        c_length = fe.Secret()
        d = fe.Public(shape=len(LZSS_DATA))
        d_length = fe.Public()

        def define(self, api):
            d, d_len = lzss.decompress(api, list(self.c), self.c_length,
                                       [int(b) for b in dict_aug], len(self.d))
            for have, want in zip(d, self.d):
                api.assert_is_equal(have, want)
            api.assert_is_equal(d_len, self.d_length)

    return LzssCircuit


def test_compress_lzss_matches_reference_and_its_hint_id():
    """The host compressor gives the same bytes in both packages; the
    decompression circuit compiles to the same system, its bit hint under
    the JAX package's id (the JAX package names it by its module's path,
    the copy registers that name), and solves to the same wires; a wrong
    decompressed byte and a wrong length are refused by both."""
    dict_aug = [mod(pkg, "std.compress_lzss").augment_dict(LZSS_DICT) for pkg in PKGS]
    comp = [mod(pkg, "std.compress_lzss").lzss_compress(LZSS_DATA, d, max_out=len(LZSS_DATA))
            for pkg, d in zip(PKGS, dict_aug)]
    assert dict_aug[0] == dict_aug[1] and comp[0] == comp[1]
    c = comp[0]
    good = dict(c=list(c), c_length=len(c), d=list(LZSS_DATA), d_length=len(LZSS_DATA))
    wrong_byte = list(LZSS_DATA)
    wrong_byte[3] = (wrong_byte[3] + 1) % 256
    systems = same_systems_and_wires(lambda pkg: lzss_circuit(pkg, len(c), dict_aug[0]), good, (
        {**good, "d": wrong_byte}, {**good, "d_length": len(LZSS_DATA) + 1}))
    hid = mod(PKGS[0], "constraint.hints").hint_id(BREAK_BITS_NAME)
    assert mod(PKGS[0], "std.compress_lzss").BREAK_BITS == hid
    for pkg, cs in zip(PKGS, systems):
        assert hid in {h.hint_id for h in cs.hints}
        assert mod(pkg, "constraint.hints").hint_name(hid) == BREAK_BITS_NAME


# ---------------------------------------------------------------------------
# keccak-f[1600] and the SHA-3 sponges (std/hash/keccakf.py, sha3.py)
# ---------------------------------------------------------------------------

# gates of each hash of 64 bytes under the SCS builder (one permutation; the
# padding's constants differ)
GATES = {"keccak256": 229_712, "sha3_256": 229_716}
HASHES = {"keccak256": lambda data: mod(PKGS[0], "std.hash.mimc").keccak256(data),
          "sha3_256": lambda data: hashlib.sha3_256(data).digest()}


def hash_circuit(pkg: str, fn: str, n: int):
    fe = mod(pkg, "frontend")
    sha3 = mod(pkg, "std.hash.sha3")

    class Hash(fe.Circuit):
        data = fe.Secret(shape=n)
        digest = fe.Public(shape=32)

        def define(self, api):
            for have, want in zip(getattr(sha3, fn)(api, list(self.data)), self.digest):
                api.assert_is_equal(have, want)

    return Hash


@pytest.mark.parametrize("fn", sorted(HASHES))
def test_sha3_sponges_match_the_host_hash_under_scs(fn):
    """keccak256 (the EVM's: the port's host std/hash/mimc.py keccak256)
    and sha3_256 (hashlib's) of 64 seeded bytes, a Solidity mapping slot's
    preimage: one keccak-f permutation, 229,712 and 229,716 gates under the
    SCS builder in both packages, the same system; the host digest solves to the same
    wires in both, a digest with one byte changed is refused by both."""
    data = bytes(rand_below(12, 256, 64))
    digest = list(HASHES[fn](data))
    wrong = list(digest)
    wrong[7] ^= 0x40
    systems = same_systems_and_wires(lambda pkg: hash_circuit(pkg, fn, len(data)),
                                     dict(data=list(data), digest=digest),
                                     (dict(data=list(data), digest=wrong),), builder="scs")
    assert systems[0].nb_gates == GATES[fn]
