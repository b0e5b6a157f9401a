"""The port's copies of the JAX package's host modules, held to their
originals on the CPU.

gnark_icicle_tpu_torch keeps its own copies of the JAX-free host modules it
needs (frontend, constraint, native solver, curves, logger, debug, profile,
and the native 2-chain gadgets of std/), so that it imports nothing of the
JAX package. Each copy must behave as its original: the same R1CS from the
same circuit, the same wires from the native and the Python solver, the same
curve constants and pairings, the same gadget results under the Engine.
"""

import dataclasses
import random

import pytest

from gnark_icicle_tpu import constraint as ref_constraint
from gnark_icicle_tpu import frontend as ref_frontend
from gnark_icicle_tpu.curves import bls12_377 as ref_bls377
from gnark_icicle_tpu.curves import bls12_381 as ref_bls381
from gnark_icicle_tpu.curves import bn254 as ref_bn254
from gnark_icicle_tpu.curves import bw6_761 as ref_bw6
from gnark_icicle_tpu_torch import constraint, frontend
from gnark_icicle_tpu_torch.curves import bls12_377, bls12_381, bn254, bw6_761

CURVE_MODULES = {"bn254": (bn254, ref_bn254), "bls12_381": (bls12_381, ref_bls381),
                 "bls12_377": (bls12_377, ref_bls377)}


def chain_circuit(fe, steps: int):
    class Chain(fe.Circuit):
        x = fe.Secret()
        out = fe.Public()

        def define(self, api):
            v = self.x
            for i in range(steps):
                v = api.add(api.mul(v, v), v, i)
            api.assert_is_equal(v, self.out)

    return Chain


def bits_circuit(fe):
    """A circuit whose witness needs a hint (to_binary's bit decomposition)."""
    class Bits(fe.Circuit):
        x = fe.Secret()
        low = fe.Public()

        def define(self, api):
            bits = api.to_binary(self.x, 16)
            acc = 0
            for i in range(8):
                acc = api.add(acc, api.mul(bits[i], 1 << i))
            api.assert_is_equal(acc, self.low)

    return Bits


CIRCUITS = {"chain": lambda fe: chain_circuit(fe, 40), "to_binary": bits_circuit}
WITNESS = {"chain": None, "to_binary": ([0xBEEF & 0xFF], [0xBEEF])}


def _state(cs) -> dict:
    """An R1CS as plain data: its fields, with hint records as dicts."""
    def plain(v):
        if dataclasses.is_dataclass(v):
            return {k: plain(x) for k, x in vars(v).items()}
        if isinstance(v, (list, tuple)):
            return type(v)(plain(x) for x in v)
        return v

    return {k: plain(v) for k, v in cs.__getstate__().items()}


def _witness(name, q):
    if WITNESS[name] is not None:
        return WITNESS[name]
    v = 3
    for i in range(40):
        v = (v * v + v + i) % q
    return [v], [3]


@pytest.mark.parametrize("name", sorted(CIRCUITS))
@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_compile_gives_the_reference_r1cs(name, curve):
    q = CURVE_MODULES[curve][0].R
    cs = frontend.compile_circuit(q, CIRCUITS[name](frontend))
    ref = ref_frontend.compile_circuit(q, CIRCUITS[name](ref_frontend))
    assert _state(cs) == _state(ref)
    got, want = cs.term_arrays(), ref.term_arrays()
    assert list(got[0]) == list(want[0])
    assert (got[1] == want[1]).all()
    for a, b in zip(got[2], want[2]):
        assert (a == b).all()


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_native_and_python_solves_agree_with_the_reference(name):
    q = bls12_381.R
    cs = frontend.compile_circuit(q, CIRCUITS[name](frontend))
    ref_cs = ref_frontend.compile_circuit(q, CIRCUITS[name](ref_frontend))
    pub, sec = _witness(name, q)
    want = ref_constraint.solve(ref_cs, pub, sec, native=False).wires
    for native in (True, False):
        res = constraint.solve(cs, pub, sec, native=native)
        assert res.wires == want, native
        for part in ("a", "b", "c"):
            assert getattr(res, part) == getattr(
                ref_constraint.solve(ref_cs, pub, sec, native=native), part)


def test_native_library_builds_into_the_ports_build_directory():
    import os

    from gnark_icicle_tpu_torch import native

    if native.get_lib() is None:
        pytest.skip("no host C++ compiler: the pure-Python solver runs")
    path = native._build()
    assert os.sep + os.path.join("build", "gnark_icicle_tpu_torch") + os.sep in path


def _flat(x) -> list:
    """An Fp/Fp2/Fp6/Fp12 value or a point as a flat list of ints."""
    if x is None:
        return [None]
    if isinstance(x, int):
        return [x]
    if isinstance(x, (tuple, list)):
        return [v for c in x for v in _flat(c)]
    return [v for c in ("c0", "c1", "c2") if hasattr(x, c)
            for v in _flat(getattr(x, c))]


@pytest.mark.parametrize("curve", sorted(CURVE_MODULES))
def test_curve_constants_match(curve):
    mod, ref = CURVE_MODULES[curve]
    assert (mod.P, mod.R, mod.X_SEED) == (ref.P, ref.R, ref.X_SEED)
    c, rc = (getattr(m, curve.upper()) for m in (mod, ref))
    assert (c.name, c.tower.beta, c.tower.xi) == (rc.name, rc.tower.beta, rc.tower.xi)
    for f, rf in ((c.fr, rc.fr), (c.fp, rc.fp)):
        assert (f.modulus, f.two_adicity, f.multiplicative_generator) == \
            (rf.modulus, rf.two_adicity, rf.multiplicative_generator)
    assert c.fr.root_of_unity(6) == rc.fr.root_of_unity(6)
    for g, rg in ((c.g1, rc.g1), (c.g2, rc.g2)):
        assert _flat(g.b) == _flat(rg.b)
        assert _flat(g.generator) == _flat(rg.generator)
        assert _flat(g.scalar_mul(g.generator, 12345)) == \
            _flat(rg.scalar_mul(rg.generator, 12345))


@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_pairing_matches_and_checks(curve):
    mod, ref = CURVE_MODULES[curve]
    c, rc = (getattr(m, curve.upper()) for m in (mod, ref))
    p, q = c.g1.scalar_mul(c.g1.generator, 6), c.g2.scalar_mul(c.g2.generator, 35)
    rp, rq = rc.g1.scalar_mul(rc.g1.generator, 6), rc.g2.scalar_mul(rc.g2.generator, 35)
    assert _flat(c.miller_and_final_exp([p], [q])) == \
        _flat(rc.miller_and_final_exp([rp], [rq]))
    # e(6·G1, 35·G2) · e(−210·G1, G2) = 1, and not with −209
    g1, g2 = c.g1.generator, c.g2.generator
    assert c.pairing([(p, q), (c.g1.scalar_mul(g1, c.fr.modulus - 210), g2)])
    assert not c.pairing([(p, q), (c.g1.scalar_mul(g1, c.fr.modulus - 209), g2)])


def test_bw6_761_constants_match():
    assert (bw6_761.P, bw6_761.R, bw6_761.GAMMA) == (ref_bw6.P, ref_bw6.R, ref_bw6.GAMMA)
    c, rc = bw6_761.BW6_761, ref_bw6.BW6_761
    assert c.name == rc.name
    for f, rf in ((c.fr, rc.fr), (c.fp, rc.fp)):
        assert (f.modulus, f.two_adicity, f.multiplicative_generator) == \
            (rf.modulus, rf.two_adicity, rf.multiplicative_generator)
    assert c.fr.root_of_unity(16) == rc.fr.root_of_unity(16)
    for g, rg in ((c.g1, rc.g1), (c.g2, rc.g2)):
        assert (g.b, g.generator, g.order) == (rg.b, rg.generator, rg.order)
        assert g.scalar_mul(g.generator, 12345) == rg.scalar_mul(rg.generator, 12345)


def test_bw6_761_pairing_matches_and_checks():
    c, rc = bw6_761.BW6_761, ref_bw6.BW6_761
    p, q = c.g1.scalar_mul(c.g1.generator, 6), c.g2.scalar_mul(c.g2.generator, 35)
    assert c.miller_and_final_exp([p], [q]).c == rc.miller_and_final_exp([p], [q]).c
    g1, g2 = c.g1.generator, c.g2.generator
    assert c.pairing([(p, q), (c.g1.scalar_mul(g1, c.fr.modulus - 210), g2)])
    assert not c.pairing([(p, q), (c.g1.scalar_mul(g1, c.fr.modulus - 209), g2)])


# -- the native 2-chain gadgets (std/), on both packages under the Engine ----
# The tests of tests/test_native_recursion.py:65-177, run once on the port's
# copies and once on the originals.

def _gadgets(pkg: str):
    """(curves.bls12_377, tower, Engine, EngineUnsatisfiedError,
    BLS12377Pairing) of one package."""
    import importlib

    base = {"port": "gnark_icicle_tpu_torch", "jax": "gnark_icicle_tpu"}[pkg]
    b377 = importlib.import_module(base + ".curves.bls12_377")
    tower = importlib.import_module(base + ".curves.tower")
    engine = importlib.import_module(base + ".frontend.engine")
    pairing = importlib.import_module(base + ".std.pairing_bls12_377")
    return b377, tower, engine.Engine, engine.EngineUnsatisfiedError, pairing.BLS12377Pairing


def _gin1(pr, p):
    return (pr.fp.constant(p[0]), pr.fp.constant(p[1]))


def _gin2(pr, q):
    return (pr.e2.constant(q[0].c0, q[0].c1), pr.e2.constant(q[1].c0, q[1].c1))


def _aff1(P, p):
    X, Y, Z = (int(v) for v in P)
    if Z == 0:
        return None
    zi = pow(Z, -1, p)
    return (X * zi % p, Y * zi % p)


def _aff2(P, tower, tp):
    X, Y, Z = (tower.Fp2(tp, int(c[0]), int(c[1])) for c in P)
    if Z.c0 == 0 and Z.c1 == 0:
        return None
    zi = Z.inv()
    return (X * zi, Y * zi)


PKGS = ["port", "jax"]


@pytest.mark.parametrize("pkg", PKGS)
def test_native_g1_complete_formulas_match_host(pkg):
    b377, _, Engine, _, Pairing = _gadgets(pkg)
    rng = random.Random(41)
    eng = Engine(b377.P)
    pr = Pairing(eng)
    g1g, host = pr.g1, b377.G1
    p, q = host.random_point(rng), host.random_point(rng)
    P = g1g.from_affine(_gin1(pr, p))
    Qp = g1g.from_affine(_gin1(pr, q))
    aff = lambda X: _aff1(X, b377.P)  # noqa: E731
    assert aff(g1g.add(P, Qp)) == host.add(p, q)
    assert aff(g1g.double(P)) == host.add(p, p)
    ident = g1g.identity()
    assert aff(g1g.add(ident, P)) == p and aff(g1g.add(P, ident)) == p
    assert aff(g1g.add(P, g1g.neg(P))) is None
    assert aff(g1g.add(P, P)) == host.add(p, p)
    k = rng.randrange(1, b377.R)
    assert aff(g1g.scalar_mul_const(P, k)) == host.scalar_mul(p, k)
    assert aff(g1g.scalar_mul(eng, P, k, 253)) == host.scalar_mul(p, k)
    assert aff(g1g.scalar_mul(eng, P, 0, 253)) is None
    assert aff(g1g.scalar_mul_const(P, b377.R)) is None


@pytest.mark.parametrize("pkg", PKGS)
def test_native_g2_complete_formulas_match_host(pkg):
    b377, tower, Engine, _, Pairing = _gadgets(pkg)
    rng = random.Random(42)
    pr = Pairing(Engine(b377.P))
    g2g, host = pr.g2, b377.G2
    p, q = host.random_point(rng), host.random_point(rng)
    P = g2g.from_affine(_gin2(pr, p))
    Qp = g2g.from_affine(_gin2(pr, q))
    aff = lambda X: _aff2(X, tower, b377.TOWER)  # noqa: E731
    assert aff(g2g.add(P, Qp)) == host.add(p, q)
    assert aff(g2g.double(P)) == host.add(p, p)
    assert aff(g2g.add(P, g2g.neg(P))) is None
    k = rng.randrange(1, b377.R)
    assert aff(g2g.scalar_mul_const(P, k)) == host.scalar_mul(p, k)
    assert aff(g2g.scalar_mul_const(P, b377.R)) is None


# on y² = x³ + 1 but outside the order-r subgroup (tests/test_native_recursion.py:112)
_G1_NONSUB = (2, 3)
_G2_NONSUB_Y = (
    87422840072826444250887876553565942107355551262075501346398264275644536685914269348883251443966746472990108358918,
    215532314401042231238087290877698852638896402558755014880383192266220331697178391270737005425522628434566521626153,
)


@pytest.mark.parametrize("pkg", PKGS)
def test_native_fast_subgroup_check_g1(pkg):
    b377, _, Engine, Unsat, Pairing = _gadgets(pkg)
    rng = random.Random(43)
    for pt in (b377.G1_GEN, b377.G1.random_point(rng)):
        pr = Pairing(Engine(b377.P))
        pr.assert_g1_member(_gin1(pr, pt))
    x, y = _G1_NONSUB
    for bad in (_G1_NONSUB, (x, (y + 1) % b377.P)):
        pr = Pairing(Engine(b377.P))
        with pytest.raises(Unsat):
            pr.assert_g1_member(_gin1(pr, bad))


@pytest.mark.parametrize("pkg", PKGS)
def test_native_fast_subgroup_check_g2(pkg):
    b377, tower, Engine, Unsat, Pairing = _gadgets(pkg)
    rng = random.Random(44)
    TP = b377.TOWER
    bad = (tower.Fp2(TP, 2, 1), tower.Fp2(TP, *_G2_NONSUB_Y))
    assert bad[1] * bad[1] == bad[0] * bad[0] * bad[0] + b377.G2_B
    for qt in (b377.G2_GEN, b377.G2.random_point(rng)):
        pr = Pairing(Engine(b377.P))
        pr.assert_g2_member(_gin2(pr, qt))
    off = (bad[0], tower.Fp2(TP, bad[1].c0, (bad[1].c1 + 1) % b377.P))
    for pt in (bad, off):
        pr = Pairing(Engine(b377.P))
        with pytest.raises(Unsat):
            pr.assert_g2_member(_gin2(pr, pt))


def _outer_circuit(pkg: str, vk, committed: bool = False):
    """OuterG16 of tools/run_2chain_device.py:80-92 over one package; with
    ``committed``, the inner proof's BSB22 commitment and its proof of
    knowledge are four more secret words (OuterG16C of
    tests/test_commit_recursion.py:145-158)."""
    import importlib

    base = {"port": "gnark_icicle_tpu_torch", "jax": "gnark_icicle_tpu"}[pkg]
    fe = importlib.import_module(base + ".frontend")
    ng = importlib.import_module(base + ".std.recursion.native_groth16")

    class OuterG16(fe.Circuit):
        inner_pub = fe.Public()
        pr = fe.Secret(shape=12 if committed else 8)

        def define(self, api):
            gv = ng.NativeGroth16Verifier(api, vk)
            p = self.pr
            cm = dict(commitments=((p[8], p[9]),), commitment_pok=(p[10], p[11])) \
                if committed else {}
            w = ng.NativeVerifierProof(ar=(p[0], p[1]), bs=((p[2], p[3]), (p[4], p[5])),
                                       krs=(p[6], p[7]), **cm)
            gv.assert_proof(w, [self.inner_pub])

    return fe, OuterG16


def _proof_words(proof, commitment=None) -> list:
    """An inner proof's coordinates in OuterG16's order; a committed
    proof's commitment (or ``commitment`` in its place) and proof of
    knowledge after them."""
    words = [proof.ar[0], proof.ar[1], proof.bs[0].c0, proof.bs[0].c1,
             proof.bs[1].c0, proof.bs[1].c1, proof.krs[0], proof.krs[1]]
    if proof.commitments:
        cm = commitment or proof.commitments[0]
        words += [cm[0], cm[1], proof.commitment_pok[0], proof.commitment_pok[1]]
    return words


def _inner_chain(steps: int, committed: bool = False):
    """A BLS12-377 Chain of ``steps`` proved by the port on the CPU; with
    ``committed``, one api.commit over the secret and the output, proved
    with the 2-chain's commitment hash ("mimc", BW6-761's r). Returns (vk,
    proof, public output)."""
    from gnark_icicle_tpu_torch.backend import groth16

    class CommitChain(frontend.Circuit):
        x = frontend.Secret()
        out = frontend.Public()

        def define(self, api):
            v = self.x
            for i in range(steps):
                v = api.add(api.mul(v, v), v, i)
            api.assert_is_different(api.commit(self.x, v), 0)
            api.assert_is_equal(v, self.out)

    circuit = CommitChain if committed else chain_circuit(frontend, steps)
    cs = frontend.compile_circuit(bls12_377.R, circuit)
    v = 3
    for i in range(steps):
        v = (v * v + v + i) % bls12_377.R
    kw = {"commitment_hash": ("mimc", bls12_377.P)} if committed else {}
    pk, vk = groth16.setup(cs, bls12_377.BLS12_377, rng=random.Random(3), device="cpu")
    proof = groth16.prove(cs, pk, [v], [3], bls12_377.BLS12_377,
                          rng=random.Random(4), device="cpu", **kw)
    groth16.verify(proof, vk, [v], bls12_377.BLS12_377, **kw)
    return vk, proof, v


def _outer_pair(vk, committed: bool):
    """The outer circuit compiled with each package's gadgets, over
    BW6-761's r (= BLS12-377's p)."""
    import importlib

    from test_torch_common import to_reference

    ref_vk = to_reference(vk, importlib.import_module(
        "gnark_icicle_tpu.curves.bls12_377").BLS12_377)
    fe, Outer = _outer_circuit("port", vk, committed)
    rfe, ROuter = _outer_circuit("jax", ref_vk, committed)
    ocs = fe.compile_circuit(bls12_377.P, Outer)
    ref_ocs = rfe.compile_circuit(bls12_377.P, ROuter)
    assert ocs.nb_constraints == ref_ocs.nb_constraints
    assert _state(ocs) == _state(ref_ocs)
    return Outer, ocs, ref_ocs


def test_outer_2chain_circuit_and_solve_match_reference():
    """The BW6-761 outer circuit (the in-circuit verifier of a BLS12-377
    Groth16 proof) compiles to the reference's R1CS with either package's
    gadgets, and the port's native solver (6 64-bit words: BW6-761's r has
    377 bits) and Python solver give the reference's wires."""
    vk, proof, v = _inner_chain(8)
    Outer, ocs, ref_ocs = _outer_pair(vk, committed=False)
    pub, sec = Outer(inner_pub=v, pr=_proof_words(proof)).witness_values(bls12_377.P)
    want = ref_constraint.solve(ref_ocs, pub, sec, native=False).wires
    for native in (True, False):
        res = constraint.solve(ocs, pub, sec, native=native)
        assert res.wires == want, native
        if native and res._u64:  # the C++ core ran (a host compiler exists)
            assert res._u64["wires"].shape[1] == 6


def test_outer_2chain_committed_circuit_and_solve_match_reference():
    """The 2-chain's BSB22 branch: an inner BLS12-377 proof with one
    commitment, made with ("mimc", BW6-761's r). The outer circuit, which
    re-derives the commitment wire with the MiMC gadget and checks the
    Pedersen proof of knowledge by a pairing, compiles to the reference's
    R1CS; the port's native solver gives the reference's wires; a doubled
    commitment leaves the system unsatisfied in both packages."""
    from gnark_icicle_tpu.constraint.solver import (
        UnsatisfiedConstraintError as RefUnsat,
    )
    from gnark_icicle_tpu_torch.constraint.solver import UnsatisfiedConstraintError

    vk, proof, v = _inner_chain(4, committed=True)
    assert len(vk.commitment_keys) == 1 and len(proof.commitments) == 1
    Outer, ocs, ref_ocs = _outer_pair(vk, committed=True)
    plain_constraints = 35871
    assert ocs.nb_constraints > plain_constraints   # the MiMC hash and the PoK pairing
    pub, sec = Outer(inner_pub=v, pr=_proof_words(proof)).witness_values(bls12_377.P)
    want = ref_constraint.solve(ref_ocs, pub, sec, native=False).wires
    assert constraint.solve(ocs, pub, sec, native=True).wires == want
    other = bls12_377.G1.scalar_mul(proof.commitments[0], 2)
    bad_pub, bad_sec = Outer(inner_pub=v, pr=_proof_words(proof, other)).witness_values(
        bls12_377.P)
    with pytest.raises(UnsatisfiedConstraintError):
        constraint.solve(ocs, bad_pub, bad_sec, native=True)
    with pytest.raises(RefUnsat):
        ref_constraint.solve(ref_ocs, bad_pub, bad_sec, native=False)


# -- KZG and PLONK's host pieces ---------------------------------------------

PLONK_CURVES = {"bn254": (bn254.BN254, ref_bn254.BN254),
                "bls12_381": (bls12_381.BLS12_381, ref_bls381.BLS12_381),
                "bls12_377": (bls12_377.BLS12_377, ref_bls377.BLS12_377),
                "bw6_761": (bw6_761.BW6_761, ref_bw6.BW6_761)}


@pytest.mark.parametrize("curve", sorted(PLONK_CURVES))
def test_g1_to_bytes_matches(curve):
    from gnark_icicle_tpu.io.serialize import g1_to_bytes as ref_g1_to_bytes
    from gnark_icicle_tpu_torch.io.serialize import g1_to_bytes

    c, rc = PLONK_CURVES[curve]
    pts = [None, c.g1.generator] + [c.g1.scalar_mul(c.g1.generator, k) for k in (2, 7, 12345)]
    pts.append(c.g1.neg(pts[-1]))        # y above (p − 1) / 2 for one of the pair
    for pt in pts:
        for compressed in (True, False):
            assert g1_to_bytes(c, pt, compressed) == ref_g1_to_bytes(rc, pt, compressed)


@pytest.mark.parametrize("curve", ["bn254", "bls12_381", "bls12_377"])
def test_transcript_matches(curve):
    """The same bindings give the same challenges, on every field of at
    most 256 bits; the fold challenge too."""
    from gnark_icicle_tpu.backend import transcript as ref_ts
    from gnark_icicle_tpu_torch.backend import transcript as ts

    c, rc = PLONK_CURVES[curve]
    q = c.fr.modulus
    names = [b"gamma", b"beta", b"alpha"]
    pts = [c.g1.scalar_mul(c.g1.generator, k) for k in (3, 5)] + [None]
    out = []
    for mod, cv in ((ts, c), (ref_ts, rc)):
        t = mod.make_transcript(q, names)
        for pt in pts:
            t.bind_point(b"gamma", cv, pt)
        t.bind_fr(b"gamma", q - 1)
        t.bind(b"alpha", b"raw")
        got = [t.challenge(n) for n in names]
        got.append(mod.kzg_fold_challenge("sha256", cv, q, 77, pts[:2], [1, q - 2], 9))
        out.append(got)
    assert out[0] == out[1]


def test_transcript_binds_bw6_761_elements_in_48_bytes():
    """gnark-crypto's fr.Bytes for BW6-761's 377-bit r (the original's 32
    overflow above 2^256); the MiMC transcript binds field elements, and
    gives the original's challenges there too."""
    from gnark_icicle_tpu.backend import transcript as ref_ts
    from gnark_icicle_tpu_torch.backend import transcript as ts

    q = bw6_761.R
    t = ts.make_transcript(q, [b"x"])
    t.bind_fr(b"x", q - 1)
    assert bytes(t._bindings[b"x"]) == (q - 1).to_bytes(48, "big")
    got, want = ts.make_transcript(q, [b"x"], "mimc"), ref_ts.make_transcript(q, [b"x"], "mimc")
    for tr, c in ((got, bw6_761.BW6_761), (want, ref_bw6.BW6_761)):
        tr.bind_fr(b"x", q - 1)
        tr.bind_point(b"x", c, c.g1.generator)
    assert got.challenge(b"x") == want.challenge(b"x")


def _scs_chain(fe, q, steps=6):
    return fe.compile_circuit(q, chain_circuit(fe, steps), builder="scs")


def test_plonk_host_stages_match():
    """build_permutation, _mul_zh, _add_poly, _eval_poly and
    bind_public_data of the port's plonk backend against the originals."""
    import importlib

    from gnark_icicle_tpu.backend.transcript import make_transcript as ref_make
    from gnark_icicle_tpu_torch.backend.transcript import make_transcript

    # the packages export setup() and prove() functions under the modules' names
    port_prove, ref_prove, port_setup, ref_setup = (
        importlib.import_module(f"{pkg}.backend.plonk.{mod}")
        for mod in ("prove", "setup") for pkg in ("gnark_icicle_tpu_torch", "gnark_icicle_tpu"))
    q = bn254.R
    cs, ref_cs = _scs_chain(frontend, q), _scs_chain(ref_frontend, q)
    for n in (32, 64):
        assert (port_setup.build_permutation(cs, n)
                == ref_setup.build_permutation(ref_cs, n)).all()
    for m in (2, 3, 300, 513):
        assert port_setup._next_pow2_log(m) == ref_setup._next_pow2_log(m)
    a, b = [3, q - 1, 5, 7], [q - 2, 11]
    assert port_prove._mul_zh(a, 8, q) == ref_prove._mul_zh(a, 8, q)
    assert port_prove._add_poly(a, b, q) == ref_prove._add_poly(a, b, q)
    assert port_prove._add_poly(b, a, q) == ref_prove._add_poly(b, a, q)
    assert port_prove._eval_poly(a, 12345, q) == ref_prove._eval_poly(a, 12345, q)
    assert port_prove.CHALLENGES == ref_prove.CHALLENGES

    class VK:
        commitments = {k: bn254.BN254.g1.scalar_mul(bn254.BN254.g1.generator, i + 2)
                       for i, k in enumerate(("s1", "s2", "s3", "ql", "qr", "qm", "qo", "qk"))}
        commitment_constraint_indexes = []

    got, want = make_transcript(q, [b"gamma"]), ref_make(q, [b"gamma"])
    port_prove.bind_public_data(got, bn254.BN254, VK, [9, q - 1])
    ref_prove.bind_public_data(want, ref_bn254.BN254, VK, [9, q - 1])
    assert got.challenge(b"gamma") == want.challenge(b"gamma")


def test_plonk_verify_and_keys_copy_match():
    """The port's verifier and key classes on a proof of the JAX package's
    host engine: the same verdicts as the original's, valid and tampered."""
    from gnark_icicle_tpu.backend import plonk as ref_plonk
    from gnark_icicle_tpu_torch.backend import plonk

    q = bn254.R
    ref_cs = _scs_chain(ref_frontend, q)
    v = 3
    for i in range(6):
        v = (v * v + v + i) % q
    pk, vk = ref_plonk.setup(ref_cs, ref_bn254.BN254, rng=random.Random(5), engine="host")
    proof = ref_plonk.prove(ref_cs, pk, [v], [3], ref_bn254.BN254, rng=random.Random(6),
                            engine="host")
    port_vk, port_proof = plonk.VerifyingKey.from_reference(vk), plonk.Proof.from_reference(proof)
    bad = dataclasses.replace(port_proof, z_shifted_claimed=(proof.z_shifted_claimed + 1) % q)
    for pub, pf, ok in (([v], port_proof, True), ([v + 1], port_proof, False),
                        ([v], bad, False)):
        assert plonk.is_valid(pf, port_vk, pub, bn254.BN254) is ok
        ref_pf = ref_plonk.Proof(**{f.name: getattr(pf, f.name)
                                    for f in dataclasses.fields(pf)})
        assert ref_plonk.is_valid(ref_pf, vk, pub, ref_bn254.BN254) is ok


# the four curves' scalar fields, for the MiMC copies
FR = {"bn254": bn254.R, "bls12_381": bls12_381.R, "bls12_377": bls12_377.R,
      "bw6_761": bw6_761.R}


def _seeded_bytes(seed: int, n: int) -> bytes:
    import numpy as np

    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def test_keccak256_matches():
    """Legacy Keccak-256 on seeded messages of 0-300 bytes (every padding
    case around the 136-byte rate)."""
    from gnark_icicle_tpu.std.hash import mimc as ref_mimc
    from gnark_icicle_tpu_torch.std.hash import mimc

    for n in (0, 1, 134, 135, 136, 137, 300):
        msg = _seeded_bytes(800 + n, n)
        assert mimc.keccak256(msg) == ref_mimc.keccak256(msg)


@pytest.mark.parametrize("curve", sorted(FR))
def test_mimc_matches(curve):
    """MiMCHost (write, sum, reset), mimc_hash and the round parameters on
    each curve's r, on seeded values (0, 1 and r − 1 among them)."""
    from gnark_icicle_tpu.std.hash import mimc as ref_mimc
    from gnark_icicle_tpu_torch.std.hash import mimc

    from test_torch_common import rand_ints

    q = FR[curve]
    vals = rand_ints(810, q, 6)
    assert mimc.mimc_params(q) == ref_mimc.mimc_params(q)
    assert mimc.mimc_hash(q, vals) == ref_mimc.mimc_hash(q, vals)
    h, rh = mimc.MiMCHost(q), ref_mimc.MiMCHost(q)
    h.write(*vals[:3])
    rh.write(*vals[:3])
    assert h.sum(*vals[3:]) == rh.sum(*vals[3:])
    h.reset()
    rh.reset()
    assert h.sum(q - 1) == rh.sum(q - 1)


def test_hash_to_field_matches():
    """expand_message_xmd, hash_to_fr, serialize_commitment and the two
    commitment hashes (MiMC with the point absorbed whole and as 64-bit
    limbs; EVM with sha256 and keccak256) on seeded inputs."""
    from gnark_icicle_tpu.backend import hash_to_field as ref_h2f
    from gnark_icicle_tpu_torch.backend import hash_to_field as h2f

    from test_torch_common import rand_ints

    for n in (0, 32, 96):
        msg = _seeded_bytes(820 + n, n)
        for length in (1, 48, 100):
            assert h2f.expand_message_xmd(msg, b"dst", length) == \
                ref_h2f.expand_message_xmd(msg, b"dst", length)
        for q in (bn254.R, bw6_761.R):
            assert h2f.hash_to_fr(msg, h2f.COMMITMENT_DST, q, 3) == \
                ref_h2f.hash_to_fr(msg, ref_h2f.COMMITMENT_DST, q, 3)
    assert (h2f.COMMITMENT_DST, h2f.G16_FOLD_DST, h2f.MIMC_COMMITMENT_TAG) == \
        (ref_h2f.COMMITMENT_DST, ref_h2f.G16_FOLD_DST, ref_h2f.MIMC_COMMITMENT_TAG)
    vals = rand_ints(830, bn254.R, 4)
    pt = bn254.BN254.g1.scalar_mul(bn254.BN254.g1.generator, 12345)
    assert h2f.serialize_commitment(b"pt", vals, 32) == ref_h2f.serialize_commitment(b"pt", vals,
                                                                                      32)
    # the native 2-chain (BLS12-377's Fp fits BW6-761's r) and BN254 in
    # BN254's own r (its Fp does not fit: limbs)
    for outer, inner_r, inner_p, point in ((bw6_761.R, bls12_377.R, bls12_377.P,
                                            bls12_377.BLS12_377.g1.generator),
                                           (bn254.R, bn254.R, bn254.P, pt),
                                           (bn254.R, bn254.R, bn254.P, None)):
        assert h2f.mimc_commitment_hash(outer, inner_r, inner_p, point, vals) == \
            ref_h2f.mimc_commitment_hash(outer, inner_r, inner_p, point, vals)
    for name in ("sha256", "keccak256"):
        for point in (pt, None):
            assert h2f.evm_commitment_hash(name, bn254.R, point, vals) == \
                ref_h2f.evm_commitment_hash(name, bn254.R, point, vals)


def test_pedersen_matches():
    """commit, prove_knowledge, fold_proofs and batch_verify_multi_vk on
    seeded keys of two commitments over BN254 (a zero value and a point at
    infinity among them), accepted and, with a tampered proof, rejected by
    both."""
    from gnark_icicle_tpu.backend import pedersen as ref_ped
    from gnark_icicle_tpu.curves import bn254 as rb
    from gnark_icicle_tpu_torch.backend import pedersen

    from test_torch_common import rand_ints

    c = bn254.BN254
    g1, g2 = c.g1, c.g2
    q = c.fr.modulus
    ks = rand_ints(840, q, 8, edge=False)
    values = [[0, 5, q - 1], [ks[7]]]
    pks, vks, rpks, rvks = [], [], [], []
    gq = g2.scalar_mul(g2.generator, ks[0])
    for i, vals in enumerate(values):
        sigma = ks[1 + i]
        basis = [g1.scalar_mul(g1.generator, k) for k in ks[3:3 + len(vals)]]
        basis[0] = None if i == 1 else basis[0]
        sig = [None if b is None else g1.scalar_mul(b, sigma) for b in basis]
        pks.append(pedersen.PedersenProvingKey(basis=basis, basis_exp_sigma=sig))
        rpks.append(ref_ped.PedersenProvingKey(basis=basis, basis_exp_sigma=sig))
        neg = g2.scalar_mul(gq, (q - sigma) % q)
        vks.append(pedersen.PedersenVerifyingKey(g=gq, g_sigma_neg=neg))
        rvks.append(ref_ped.PedersenVerifyingKey(g=gq, g_sigma_neg=neg))
    cms = [pedersen.commit(c, pk, v) for pk, v in zip(pks, values)]
    assert cms == [ref_ped.commit(rb.BN254, pk, v) for pk, v in zip(rpks, values)]
    poks = [pedersen.prove_knowledge(c, pk, v) for pk, v in zip(pks, values)]
    assert poks == [ref_ped.prove_knowledge(rb.BN254, pk, v) for pk, v in zip(rpks, values)]
    folded = pedersen.fold_proofs(c, poks, ks[6])
    assert folded == ref_ped.fold_proofs(rb.BN254, poks, ks[6])
    bad = g1.add(folded, g1.generator)
    for pok, ok in ((folded, True), (bad, False)):
        assert pedersen.batch_verify_multi_vk(c, vks, cms, pok, ks[6]) is ok
        assert ref_ped.batch_verify_multi_vk(rb.BN254, rvks, cms, pok, ks[6]) is ok


def test_engine_commit_and_placeholder_hint_match():
    """Engine.commit and the BSB22 placeholder hint: the originals' values."""
    from gnark_icicle_tpu.constraint import hints as ref_hints
    from gnark_icicle_tpu.frontend.engine import Engine as RefEngine
    from gnark_icicle_tpu_torch.constraint import hints
    from gnark_icicle_tpu_torch.frontend.engine import Engine

    from test_torch_common import rand_ints

    for q in (bn254.R, bls12_377.R):
        vals = rand_ints(850, q, 5)
        assert Engine(q).commit(*vals) == RefEngine(q).commit(*vals)
        assert hints.bsb22_placeholder_hint(q, vals) == ref_hints.bsb22_placeholder_hint(q, vals)
    assert hints.BSB22_PLACEHOLDER == ref_hints.BSB22_PLACEHOLDER
