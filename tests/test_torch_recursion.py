"""The recursion verifiers and emulated pairings of the port's std/ against
the JAX package's, on the CPU.

gnark_icicle_tpu_torch/std/ holds copies of the JAX package's emulated
BLS12-381 and BW6-761 pairings (``pairing_bls12_381.py``,
``pairing_bw6_761.py`` with its ``emulated.bw6_761.inv6`` hint), the KZG
gadget (``kzg_gadget.py``) and the recursion verifiers
(``recursion/{groth16,plonk,native_plonk}.py``). Held here, on inputs made
from numpy seeds: the pairing pieces (a line, a Miller-loop double and add
step, the final exponentiation's easy part) give the same values in both
packages' Engines; the hint has the JAX package's id and outputs; small
pieces compile to the same systems under both builders and solve to the same
wires; the Groth16 verifier (BN254 in BN254) and the native PLONK verifier
(BLS12-377 in BW6-761) accept an inner proof and refuse a wrong public
input, each inner proof made by both packages' host engines (``engine=
"host"``) under one rng, to the same bytes. As in the JAX package, the full
pairings, the cross-curve and wrap verifiers, the KZG openings, the
commitment variants and the compiled systems of millions of constraints are
``slow``.
"""

import importlib
import random
import secrets

import numpy as np
import pytest

from gnark_icicle_tpu_torch.curves import bls12_377, bls12_381, bn254, bw6_761

Q = bn254.R
PKGS = ("gnark_icicle_tpu_torch", "gnark_icicle_tpu")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def fixed_mask(monkeypatch):
    """Both packages' api.commit mask (secrets.randbelow) fixed, so that
    the two solves see one witness."""
    monkeypatch.setattr(secrets, "randbelow", lambda m: 0x5EED % m)


def seeded(seed: int, bound: int, n: int) -> list:
    """n values in [1, bound) from a numpy seed."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, -(-bound.bit_length() // 32)), dtype=np.uint64)
    return [int.from_bytes(w.astype("<u4").tobytes(), "little") % (bound - 1) + 1
            for w in words]


def ints(fp, x):
    """An Engine value of emulated elements (nested tuples) as ints."""
    if isinstance(x, (tuple, list)):
        return [ints(fp, v) for v in x]
    return fp.value_hint(fp.reduce(x))


def state(cs) -> dict:
    """A compiled system as plain data (an R1CS by its pickled state, an SCS
    by its fields)."""
    raw = cs.__getstate__() if hasattr(cs, "nb_constraints") else vars(cs)

    def plain(v):
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        if hasattr(v, "tolist"):
            return v.tolist()
        if hasattr(v, "__dict__") and not isinstance(v, type):
            return {k: plain(x) for k, x in vars(v).items()}
        return v

    return {k: plain(v) for k, v in raw.items() if not k.startswith("_")}


# -- the BLS12-381 pairing's pieces ------------------------------------------

def _points_381(seed: int) -> tuple:
    a, b = seeded(seed, bls12_381.R, 2)
    return (bls12_381.G1.scalar_mul(bls12_381.G1.generator, a),
            bls12_381.G2.scalar_mul(bls12_381.G2.generator, b))


def _gin1(pr, p):
    return (pr.fp.constant(p[0]), pr.fp.constant(p[1]))


def _gin2(pr, q):
    return (pr.e2.constant(q[0].c0, q[0].c1), pr.e2.constant(q[1].c0, q[1].c1))


def bls381_steps(pkg: str, seed: int) -> dict:
    """One Miller-loop double and add step of the BLS12-381 gadget in the
    Engine (the loop body of ``miller_loop``), its two lines, and the easy
    part of the final exponentiation of the result."""
    pw = mod(pkg, "std.pairing_bls12_381")
    pr = pw.BLS12381Pairing(mod(pkg, "frontend.engine").Engine(Q), Q)
    p, q = _points_381(seed)
    P, Qg = _gin1(pr, p), _gin2(pr, q)
    e12 = pr.e12
    f = e12.square(e12.one())
    R2, lam = pr._twist_double(Qg)
    line_d = pr._line(lam, Qg, P)
    f = e12.mul(f, line_d)
    R3, lam2 = pr._twist_add(R2, Qg)
    line_a = pr._line(lam2, R2, P)
    f = e12.mul(f, line_a)
    f1 = e12.mul(e12.conjugate(f), e12.inverse(f))      # f^(p⁶−1)
    easy = e12.mul(pr._frob2(f1), f1)                   # ^(p²+1)
    return {k: ints(pr.fp, v) for k, v in {
        "double": R2, "add": R3, "line_double": line_d, "line_add": line_a, "f": f,
        "easy": easy}.items()}


def test_bls12_381_miller_step_and_easy_part_match():
    """A line, a double and an add step and the easy part: the same values
    in both Engines; the step's points are 2Q and 3Q on the host curve."""
    got = [bls381_steps(pkg, 1) for pkg in PKGS]
    assert got[0] == got[1]
    _, q = _points_381(1)
    g2 = bls12_381.G2
    for name, k in (("double", 2), ("add", 3)):
        want = g2.scalar_mul(q, k)
        assert got[0][name] == [[want[0].c0, want[0].c1], [want[1].c0, want[1].c1]]


# -- the BW6-761 pairing's pieces --------------------------------------------

def _points_bw6(seed: int) -> tuple:
    a, b = seeded(seed, bw6_761.R, 2)
    return (bw6_761.G1.scalar_mul(bw6_761.G1.generator, a),
            bw6_761.G2.scalar_mul(bw6_761.G2.generator, b))


def bw6_steps(pkg: str, seed: int) -> dict:
    """One Miller-loop double and add step of the BW6-761 gadget (the body of
    ``miller_loop``), its lines, and the final exponentiation's easy part
    (its E6Direct inverse through the inv6 hint)."""
    pw = mod(pkg, "std.pairing_bw6_761")
    pr = pw.BW6761Pairing(mod(pkg, "frontend.engine").Engine(Q), Q)
    fp, e6 = pr.fp, pr.e6
    p, q = _points_bw6(seed)
    P = (fp.constant(p[0]), fp.constant(p[1]))
    Qg = (fp.constant(q[0]), fp.constant(q[1]))
    rx, ry = P
    lam = fp.div(fp.mul(fp.constant(3), fp.mul(rx, rx)), fp.add(ry, ry))
    line_d = pr._line(lam, (rx, ry), Qg)
    f = e6.mul(e6.square(e6.one()), line_d)
    x3 = fp.sub(fp.mul(lam, lam), fp.add(rx, rx))
    ry = fp.sub(fp.mul(lam, fp.sub(rx, x3)), ry)
    rx = x3
    double = (rx, ry)
    lam = fp.div(fp.sub(P[1], ry), fp.sub(P[0], rx))
    line_a = pr._line(lam, (rx, ry), Qg)
    f = e6.mul(f, line_a)
    x3 = fp.sub(fp.sub(fp.mul(lam, lam), rx), P[0])
    ry = fp.sub(fp.mul(lam, fp.sub(rx, x3)), ry)
    f1 = e6.mul(e6.frob3(f), e6.inverse(f))     # f^(p³−1)
    easy = e6.mul(e6.frob(f1), f1)              # ^(p+1)
    return {k: ints(fp, v) for k, v in {
        "double": double, "add": (x3, ry), "line_double": line_d, "line_add": line_a,
        "f": f, "easy": easy}.items()}


def test_bw6_761_miller_step_and_easy_part_match():
    """The same for BW6-761's Tate loop: both Engines agree, and the step's
    points are 2P and 3P on the host curve."""
    got = [bw6_steps(pkg, 2) for pkg in PKGS]
    assert got[0] == got[1]
    p, _ = _points_bw6(2)
    for name, k in (("double", 2), ("add", 3)):
        assert tuple(got[0][name]) == bw6_761.G1.scalar_mul(p, k)


def test_inv6_hint_has_the_reference_id_and_outputs():
    """The hint registers under the JAX package's name, and both hint
    functions give the same limbs, those of the host Fp6 inverse."""
    hints = [mod(pkg, "constraint.hints") for pkg in PKGS]
    pws = [mod(pkg, "std.pairing_bw6_761") for pkg in PKGS]
    assert pws[0].INV6 == pws[1].INV6
    assert pws[0].INV6 == hints[0].hint_id("emulated.bw6_761.inv6")
    assert hints[0].get_hint(pws[0].INV6).__name__ == "_inv6_hint"
    coeffs = seeded(3, bw6_761.P, 6)
    params = mod(PKGS[0], "std.emulated").BW6761_FP
    k, w = params.n_limbs, params.limb_bits
    limbs = [(c >> (w * i)) & ((1 << w) - 1) for c in coeffs for i in range(k)]
    outs = [h.get_hint(pw.INV6)(Q, limbs + [k, w]) for h, pw in zip(hints, pws)]
    assert outs[0] == outs[1]
    inv = [sum(outs[0][c * k + i] << (w * i) for i in range(k)) for c in range(6)]
    assert bw6_761.Fp6D(coeffs) * bw6_761.Fp6D(inv) == bw6_761.Fp6D.one()


# -- small pieces compiled ----------------------------------------------------

def e6_piece(pkg: str):
    """An E6Direct product and its inverse over emulated BW6-761 Fp."""
    fe, em = mod(pkg, "frontend"), mod(pkg, "std.emulated")
    pw = mod(pkg, "std.pairing_bw6_761")
    k = em.BW6761_FP.n_limbs

    class E6Piece(fe.Circuit):
        a = fe.Secret(shape=6 * k)
        b = fe.Secret(shape=6 * k)

        def define(self, api):
            fp = em.EmulatedField(api, em.BW6761_FP, Q)
            e6 = pw.E6Direct(fp)
            a = tuple(fp.from_limbs(self.a[i * k:(i + 1) * k]) for i in range(6))
            b = tuple(fp.from_limbs(self.b[i * k:(i + 1) * k]) for i in range(6))
            e6.inverse(e6.mul(a, b))

    def witness(seed):
        p = em.BW6761_FP
        return E6Piece(**{name: [(v >> (p.limb_bits * i)) & ((1 << p.limb_bits) - 1)
                                 for v in seeded(seed + j, bw6_761.P, 6)
                                 for i in range(k)]
                          for j, name in enumerate("ab")})

    return E6Piece, witness


def line_piece(pkg: str):
    """The BLS12-381 gadget's line (``_line``) through a secret twist point
    with a secret slope, at a secret G1 point, constrained to public
    coefficients."""
    fe, em = mod(pkg, "frontend"), mod(pkg, "std.emulated")
    pw = mod(pkg, "std.pairing_bls12_381")
    k = em.BLS12381_FP.n_limbs

    class LinePiece(fe.Circuit):
        xs = fe.Secret(shape=8 * k)      # λ (2), x_R (2), y_R (2), x_P, y_P
        out = fe.Public(shape=6 * k)     # the line's nonzero coefficients

        def define(self, api):
            fp, e2, _, _ = pw.bls12_381_towers(api, Q)
            v = [fp.from_limbs(self.xs[i * k:(i + 1) * k]) for i in range(8)]
            pr = pw.BLS12381Pairing.__new__(pw.BLS12381Pairing)
            pr.api, pr.fp, pr.e2 = api, fp, e2
            (a00, a01, _), (_, a11, _) = pr._line((v[0], v[1]), ((v[2], v[3]), (v[4], v[5])),
                                                  (v[6], v[7]))
            got = [a00[0], a00[1], a01[0], a01[1], a11[0], a11[1]]
            for i, g in enumerate(got):
                fp.assert_equal(g, fp.from_limbs(self.out[i * k:(i + 1) * k]))

    def witness(seed, wrong=False):
        p, bits = bls12_381.P, em.BLS12381_FP.limb_bits
        v = seeded(seed, p, 8)
        lam, xr, yr = (v[0], v[1]), (v[2], v[3]), (v[4], v[5])
        # λ·x_R − y_R over Fp2 (u² = −1), −λ·x_P, y_P
        a00 = ((lam[0] * xr[0] - lam[1] * xr[1] - yr[0]) % p,
               (lam[0] * xr[1] + lam[1] * xr[0] - yr[1]) % p)
        a01 = (-lam[0] * v[6] % p, -lam[1] * v[6] % p)
        out = [a00[0], a00[1], a01[0], a01[1], (v[7] + wrong) % p, 0]

        def lb(vals):
            return [(x >> (bits * i)) & ((1 << bits) - 1) for x in vals for i in range(k)]

        return LinePiece(xs=lb(v), out=lb(out))

    return LinePiece, witness


@pytest.mark.parametrize("builder", ["r1cs", "scs"])
@pytest.mark.parametrize("piece", ["e6_mul_inverse", "e2_line"])
def test_small_pieces_compile_as_the_reference(piece, builder):
    """An E6Direct product and inverse (the inv6 hint) and a BLS12-381 line:
    the same system under each builder and the same wires from each
    package's solver; the line refuses a wrong coefficient in both."""
    systems, wires = [], []
    for pkg in PKGS:
        Circuit, witness = {"e6_mul_inverse": e6_piece, "e2_line": line_piece}[piece](pkg)
        cs = mod(pkg, "frontend").compile_circuit(Q, Circuit, builder=builder)
        systems.append(cs)
        good = witness(5).witness_values(Q)
        bad = witness(5, wrong=True).witness_values(Q) if piece == "e2_line" else None
        if builder == "r1cs":
            solver = mod(pkg, "constraint.solver")
            run, err = solver.solve, solver.UnsatisfiedConstraintError
            wires.append(run(cs, *good).wires)
        else:
            scs = mod(pkg, "constraint.scs")
            run, err = scs.solve_scs, scs.SparseUnsatisfiedError
            wires.append(list(run(cs, *good)[0]))
        if bad is not None:
            with pytest.raises(err):
                run(cs, *bad)
    assert state(systems[0]) == state(systems[1])
    assert wires[0] == wires[1]


# -- whole verifiers over inner proofs of the host engine --------------------

def cubic(pkg: str):
    fe = mod(pkg, "frontend")

    class Cubic(fe.Circuit):
        """x³ + x + 5 == y (tests/circuits.py Cubic)."""

        x = fe.Secret()
        y = fe.Public()

        def define(self, api):
            x3 = api.mul(self.x, self.x, self.x)
            api.assert_is_equal(self.y, api.add(x3, self.x, 5))

    return Cubic


def inner_proofs(system: str, curve_name: str, seeds: tuple, circuit=cubic,
                 pub=(35,), sec=(3,), **prove_kw) -> list:
    """[(vk, proof, proof bytes)] of both packages: the circuit proved by each
    package's host engine under the same rngs."""
    out = []
    for pkg in PKGS:
        name = curve_name.replace("-", "_")
        curve = getattr(mod(pkg, "curves." + name), name.upper())
        backend = mod(pkg, "backend." + system)
        cs = mod(pkg, "frontend").compile_circuit(
            curve.fr.modulus, circuit(pkg), builder="r1cs" if system == "groth16" else "scs")
        pk, vk = backend.setup(cs, curve, rng=random.Random(seeds[0]), engine="host")
        proof = backend.prove(cs, pk, list(pub), list(sec), curve, rng=random.Random(seeds[1]),
                              engine="host", **prove_kw)
        out.append((vk, proof, _proof_bytes(pkg, system, curve, proof)))
    return out


def _proof_bytes(pkg: str, system: str, curve, proof) -> bytes:
    if system == "groth16" and curve.name != "bw6-761":
        return mod(pkg, "io.serialize").proof_to_bytes(curve, proof)
    if system == "plonk":
        return mod(pkg, "io.plonk_serialize").plonk_proof_to_bytes(curve, proof)
    return repr(vars(proof)).encode()


@pytest.fixture(scope="module")
def groth16_bn254():
    return inner_proofs("groth16", "bn254", (2024, 7))


def test_groth16_verifier_bn254_accepts_and_refuses(groth16_bn254):
    """BN254 in BN254: the inner proofs of both host engines are the same
    bytes; the port's verifier accepts the port's, and refuses it with a
    wrong public input and with Krs off the curve."""
    from gnark_icicle_tpu_torch.frontend.engine import Engine, EngineUnsatisfiedError
    from gnark_icicle_tpu_torch.std.recursion import Groth16Verifier

    (vk, proof, data), (_, _, ref_data) = groth16_bn254
    assert data == ref_data
    gv = Groth16Verifier(Engine(Q), Q, vk)
    gv.assert_proof(gv.proof_witness(proof), [35])
    gv = Groth16Verifier(Engine(Q), Q, vk)
    with pytest.raises(EngineUnsatisfiedError):
        gv.assert_proof(gv.proof_witness(proof), [36])
    gv = Groth16Verifier(Engine(Q), Q, vk)
    bad = gv.proof_witness(proof)
    x = bn254.G1.scalar_mul(bn254.G1.generator, seeded(6, Q, 1)[0])[0]
    bad.krs = gv.curve.constant_point((x, x))
    with pytest.raises(EngineUnsatisfiedError):
        gv.assert_proof(bad, [35])


@pytest.fixture(scope="module")
def plonk_bls12_377():
    return inner_proofs("plonk", "bls12-377", (3030, 17), fs_hash="mimc")


def test_native_plonk_verifier_accepts_and_refuses(plonk_bls12_377):
    """BLS12-377 PLONK (MiMC transcript) in a BW6-761 Engine: the inner
    proofs of both host engines are the same bytes; the port's native
    verifier accepts and refuses a wrong public input."""
    from gnark_icicle_tpu_torch.frontend.engine import Engine, EngineUnsatisfiedError
    from gnark_icicle_tpu_torch.std.recursion.native_plonk import NativePlonkVerifier

    (vk, proof, data), (_, _, ref_data) = plonk_bls12_377
    assert data == ref_data
    pv = NativePlonkVerifier(Engine(bls12_377.P), vk)
    pv.assert_proof(pv.proof_witness(proof), [35])
    pv = NativePlonkVerifier(Engine(bls12_377.P), vk)
    with pytest.raises(EngineUnsatisfiedError):
        pv.assert_proof(pv.proof_witness(proof), [36])


@pytest.fixture(scope="module")
def plonk_bn254():
    return inner_proofs("plonk", "bn254", (1, 2), fs_hash="mimc")


@pytest.mark.parametrize("tamper", ["public_input", "evaluation"])
def test_plonk_verifier_refuses_as_the_reference(plonk_bn254, tamper):
    """BN254 PLONK in BN254: a wrong public input and a changed claimed
    evaluation fail the native quotient identity early, in both
    packages' verifiers."""
    for pkg, (vk, proof, _) in zip(PKGS, plonk_bn254):
        engine = mod(pkg, "frontend.engine")
        pv = mod(pkg, "std.recursion.plonk").PlonkVerifier(engine.Engine(Q), Q, vk)
        w = pv.proof_witness(proof)
        pub = [35]
        if tamper == "public_input":
            pub = [36]
        else:
            w.batch_claimed = list(w.batch_claimed)
            w.batch_claimed[1] = (w.batch_claimed[1] + 1) % Q
        with pytest.raises(engine.EngineUnsatisfiedError):
            pv.assert_proof(w, pub)


def test_recursion_exports_are_the_reference():
    port, ref = (mod(pkg, "std.recursion") for pkg in PKGS)
    names = {n for n in vars(ref) if not n.startswith("_") and n[0].isupper()}
    assert names == {"Groth16Verifier", "VerifierProof", "PlonkVerifier", "PlonkVerifierProof"}
    assert names <= set(vars(port))
    assert mod(PKGS[0], "std.recursion.native_groth16").NativeGroth16Verifier


# -- slow: whole pairings, the cross-curve verifiers, KZG, commitments -------

@pytest.mark.slow
def test_bls12_381_pairing_matches_the_host_oracle():
    """The whole emulated BLS12-381 pairing against the host pairing and the
    JAX package's gadget."""
    from gnark_icicle_tpu_torch.curves.pairing import BLSPairing

    p, q = _points_381(11)
    got = []
    for pkg in PKGS:
        pr = mod(pkg, "std.pairing_bls12_381").BLS12381Pairing(
            mod(pkg, "frontend.engine").Engine(Q), Q)
        got.append(ints(pr.fp, pr.pair(_gin1(pr, p), _gin2(pr, q))))
    assert got[0] == got[1]
    host = BLSPairing(bls12_381.TOWER, bls12_381.P, bls12_381.R, bls12_381.X_SEED,
                      m_twist=True).pair(p, q)
    want = [[[c.c0, c.c1] for c in (h.b0, h.b1, h.b2)] for h in (host.a0, host.a1)]
    assert got[0] == want


@pytest.mark.slow
def test_bw6_761_pairing_matches_the_host_oracle():
    p, q = _points_bw6(12)
    got = []
    for pkg in PKGS:
        pr = mod(pkg, "std.pairing_bw6_761").BW6761Pairing(
            mod(pkg, "frontend.engine").Engine(Q), Q)
        fp = pr.fp
        P = (fp.constant(p[0]), fp.constant(p[1]))
        Qg = (fp.constant(q[0]), fp.constant(q[1]))
        got.append(ints(fp, pr.pair(P, Qg)))
    assert got[0] == got[1]
    assert got[0] == list(bw6_761.BW6Pairing().pair(p, q).c)


@pytest.mark.slow
@pytest.mark.parametrize("curve_id, seeds", [("bls12-381", (2025, 8)), ("bw6-761", (2027, 9))])
def test_groth16_verifier_cross_curve_and_wrap(curve_id, seeds):
    """A BLS12-381 proof and a BW6-761 proof (the 2-chain's wrap) in a BN254
    Engine: the same inner bytes in both packages, accepted, and refused
    with a wrong public input."""
    from gnark_icicle_tpu_torch.frontend.engine import Engine, EngineUnsatisfiedError
    from gnark_icicle_tpu_torch.std.recursion import Groth16Verifier

    (vk, proof, data), (_, _, ref_data) = inner_proofs("groth16", curve_id, seeds)
    assert data == ref_data
    gv = Groth16Verifier(Engine(Q), Q, vk, curve_id=curve_id)
    gv.assert_proof(gv.proof_witness(proof), [35])
    gv = Groth16Verifier(Engine(Q), Q, vk, curve_id=curve_id)
    with pytest.raises(EngineUnsatisfiedError):
        gv.assert_proof(gv.proof_witness(proof), [36])


@pytest.mark.slow
@pytest.mark.parametrize("curve_id", ["bn254", "bls12-381"])
def test_plonk_verifier_accepts(plonk_bn254, curve_id):
    """Same-curve and cross-curve PLONK (MiMC transcript) in a BN254 Engine:
    accepted; the cross-curve one refuses a wrong public input."""
    from gnark_icicle_tpu_torch.frontend.engine import Engine, EngineUnsatisfiedError
    from gnark_icicle_tpu_torch.std.recursion import PlonkVerifier

    proofs = plonk_bn254 if curve_id == "bn254" else inner_proofs(
        "plonk", "bls12-381", (3, 4), fs_hash="mimc")
    (vk, proof, data), (_, _, ref_data) = proofs
    assert data == ref_data
    pv = PlonkVerifier(Engine(Q), Q, vk, curve_id=curve_id)
    pv.assert_proof(pv.proof_witness(proof), [35])
    if curve_id != "bn254":
        pv = PlonkVerifier(Engine(Q), Q, vk, curve_id=curve_id)
        with pytest.raises(EngineUnsatisfiedError):
            pv.assert_proof(pv.proof_witness(proof), [36])


def kzg_opening(curve, seed: int) -> tuple:
    """The port's host KZG: a degree-7 polynomial committed and opened at a
    seeded point (SRS of 16 powers): (srs, commitment, z, value, proof)."""
    from gnark_icicle_tpu_torch.backend.kzg import unsafe_srs
    from gnark_icicle_tpu_torch.backend.plonk.host_engine import HostKZG

    r = curve.fr.modulus
    tau, z, *coeffs = seeded(seed, r, 10)
    srs = unsafe_srs(curve, 16, tau=tau, engine="host")
    kzg = HostKZG(curve, srs)
    v, w = kzg.open(coeffs, z)
    return srs, kzg.commit(coeffs), z, v, w


@pytest.mark.slow
@pytest.mark.parametrize("curve_id", ["bn254", "bls12-381"])
def test_kzg_verifier_accepts_and_refuses(curve_id):
    """An opening of the host KZG accepted by both packages' KzgVerifier in a
    BN254 Engine, and a changed value refused."""
    curve = {"bn254": bn254.BN254, "bls12-381": bls12_381.BLS12_381}[curve_id]
    srs, cm, z, v, w = kzg_opening(curve, 13)
    for pkg in PKGS:
        engine = mod(pkg, "frontend.engine")
        swe = mod(pkg, "std.sw_emulated")
        tp = getattr(mod(pkg, "curves." + curve_id.replace("-", "_")), "TOWER")
        fp2 = mod(pkg, "curves.tower").Fp2

        def g2(pt):
            return tuple(fp2(tp, c.c0, c.c1) for c in pt)

        for value, ok in ((v, True), ((v + 1) % curve.fr.modulus, False)):
            kv = mod(pkg, "std.kzg_gadget").KzgVerifier(engine.Engine(Q), Q, g2(srs.g2_gen),
                                                        g2(srs.g2_tau), curve_id=curve_id)
            fp, fr = kv.curve.fp, kv.curve.fr

            def pt(p):
                return swe.AffinePoint(fp.constant(p[0]), fp.constant(p[1]))

            run = lambda: kv.assert_opening(pt(cm), fr.constant(z), fr.constant(value), pt(w))  # noqa: E731
            if ok:
                run()
            else:
                with pytest.raises(engine.EngineUnsatisfiedError):
                    run()


def inner_commit(pkg: str):
    fe = mod(pkg, "frontend")

    class InnerCommit(fe.Circuit):
        """y = x² with a commitment binding x and the public y
        (tests/test_commit_recursion.py)."""

        x = fe.Secret()
        y = fe.Public()

        def define(self, api):
            c = api.commit(self.x, self.y)
            api.assert_is_different(c, 0)
            api.assert_is_equal(api.mul(self.x, self.x), self.y)

    return InnerCommit


@pytest.mark.slow
@pytest.mark.parametrize("variant", ["groth16 bn254", "groth16 bls12-381", "plonk bn254",
                                     "native plonk bls12-377"])
def test_commitment_recursion(variant):
    """Inner proofs with a BSB22 commitment hashed with MiMC over the outer
    field (``("mimc", outer modulus)``), the same bytes from both host
    engines: accepted by the port's verifier, and refused with the
    commitment doubled."""
    from gnark_icicle_tpu_torch.frontend.engine import Engine, EngineUnsatisfiedError
    from gnark_icicle_tpu_torch.std.recursion import Groth16Verifier, PlonkVerifier
    from gnark_icicle_tpu_torch.std.recursion.native_plonk import NativePlonkVerifier

    system, curve_id = variant.split()[-2:]
    outer = bls12_377.P if curve_id == "bls12-377" else Q
    kw = {"commitment_hash": ("mimc", outer)}
    if system == "plonk":
        kw["fs_hash"] = "mimc"
    (vk, proof, data), (_, _, ref_data) = inner_proofs(system, curve_id, (21, 5),
                                                       circuit=inner_commit, pub=(9,),
                                                       sec=(3,), **kw)
    assert data == ref_data
    host = {"bn254": bn254, "bls12-381": bls12_381, "bls12-377": bls12_377}[curve_id]
    pub = [9]

    def verifier():
        if variant.startswith("native"):
            return NativePlonkVerifier(Engine(outer), vk)
        if system == "plonk":
            return PlonkVerifier(Engine(Q), Q, vk, curve_id=curve_id)
        return Groth16Verifier(Engine(Q), Q, vk, curve_id=curve_id)

    v = verifier()
    if curve_id == "bls12-381":
        pub = [v.curve.fr.constant(9)]
    v.assert_proof(v.proof_witness(proof), pub)
    v = verifier()
    bad = v.proof_witness(proof)
    if variant.startswith("native"):
        other = host.G1.scalar_mul(proof.bsb22_commitments[0], 2)
        bad.bsb22_commitments = ((v.nf.constant(other[0]), v.nf.constant(other[1])),)
    elif system == "plonk":
        other = host.G1.scalar_mul(proof.bsb22_commitments[0], 2)
        fp = v.curve.fp
        bad.bsb22_commitments = (type(bad.z_com)(fp.constant(other[0]), fp.constant(other[1])),)
    else:
        other = host.G1.scalar_mul(proof.commitments[0], 2)
        fp = v.curve.fp
        bad.commitments = (type(bad.ar)(fp.constant(other[0]), fp.constant(other[1])),)
    with pytest.raises(EngineUnsatisfiedError):
        v.assert_proof(bad, pub)


@pytest.mark.slow
def test_compiled_kzg_opening_and_native_plonk_verifier_match():
    """The BN254 KZG opening compiled (5,860,711 constraints, 9,558,798
    wires: tests/test_kzg_compiled.py:34-35) and the BW6-761 circuit of the
    native PLONK verifier over a BLS12-377 vk: the same systems in both
    packages. Millions of constraints a package: run on a large host only."""
    inner = inner_proofs("plonk", "bls12-377", (3030, 17), fs_hash="mimc")
    for build in (_compiled_kzg, _compiled_native_plonk):
        systems = [build(pkg, *inner[i][:2]) for i, pkg in enumerate(PKGS)]
        assert state(systems[0]) == state(systems[1])
        if build is _compiled_kzg:
            assert (systems[0].nb_constraints, systems[0].nb_wires) == (5_860_711, 9_558_798)


def _compiled_kzg(pkg: str, *_):
    fe, em = mod(pkg, "frontend"), mod(pkg, "std.emulated")
    kg = mod(pkg, "std.kzg_gadget")
    nl, nlr = em.BN254_FP.n_limbs, em.BN254_FR.n_limbs
    srs, *_ = kzg_opening(bn254.BN254, 2024)
    tp = mod(pkg, "curves.bn254").TOWER
    fp2 = mod(pkg, "curves.tower").Fp2
    g2 = [tuple(fp2(tp, c.c0, c.c1) for c in pt) for pt in (srs.g2_gen, srs.g2_tau)]

    class KzgCheck(fe.Circuit):
        cx = fe.Secret(shape=nl)
        cy = fe.Secret(shape=nl)
        wx = fe.Secret(shape=nl)
        wy = fe.Secret(shape=nl)
        z = fe.Secret(shape=nlr)
        v = fe.Secret(shape=nlr)

        def define(self, api):
            ver = kg.KzgVerifier(api, Q, *g2, curve_id="bn254")
            cm = ver.curve.witness_point(self.cx, self.cy)
            w = ver.curve.witness_point(self.wx, self.wy)
            fr = ver.curve.fr
            ver.assert_opening(cm, fr.from_limbs(self.z), fr.from_limbs(self.v), w)

    return fe.compile_circuit(Q, KzgCheck)


def native_plonk_outer(pkg: str, vk, proof) -> tuple:
    """The BW6-761 circuit of `pkg`'s native PLONK verifier over an inner
    BLS12-377 vk, the proof's nine points and seven evaluations secret (as a
    compiled outer circuit allocates them), and its assignment for `proof`
    with the public input 35: (circuit class, assignment)."""
    fe, em = mod(pkg, "frontend"), mod(pkg, "std.emulated")
    npl = mod(pkg, "std.recursion.native_plonk")
    k, bits = em.BLS12377_FR.n_limbs, em.BLS12377_FR.limb_bits

    class Outer(fe.Circuit):
        pub = fe.Public()
        pts = fe.Secret(shape=18)          # lro, z_com, h_coms, batch_h, z_shifted_h
        claimed = fe.Secret(shape=7 * k)   # batch_claimed, z_shifted_claimed

        def define(self, api):
            pv = npl.NativePlonkVerifier(api, vk)
            P = [(self.pts[2 * i], self.pts[2 * i + 1]) for i in range(9)]
            ev = [pv.fr.from_limbs(self.claimed[i * k:(i + 1) * k]) for i in range(7)]
            w = npl.NativePlonkProof(lro=P[0:3], z_com=P[3], h_coms=P[4:7], batch_claimed=ev[:6],
                                     batch_h=P[7], z_shifted_claimed=ev[6], z_shifted_h=P[8])
            pv.assert_proof(w, [self.pub])

    points = [*proof.lro, proof.z_com, *proof.h_coms, proof.batch_h, proof.z_shifted_h]
    values = [*proof.batch_claimed, proof.z_shifted_claimed]
    return Outer, Outer(pub=35, pts=[c for pt in points for c in pt],
                        claimed=[(int(v) >> (bits * i)) & ((1 << bits) - 1)
                                 for v in values for i in range(k)])


def test_native_plonk_outer_circuit_runs_in_the_engine(plonk_bls12_377):
    """The compiled test's outer circuit (native_plonk_outer), its proof as
    secret inputs, solved by both packages' Engines, and refused with a
    changed evaluation."""
    for pkg, (vk, proof, _) in zip(PKGS, plonk_bls12_377):
        Outer, w = native_plonk_outer(pkg, vk, proof)
        assert mod(pkg, "frontend").is_solved(w, bls12_377.P)
        w.claimed = [w.claimed[0] + 1] + list(w.claimed[1:])
        assert not mod(pkg, "frontend").is_solved(w, bls12_377.P)


def _compiled_native_plonk(pkg: str, vk, proof):
    return mod(pkg, "frontend").compile_circuit(bls12_377.P, native_plonk_outer(pkg, vk, proof)[0])
