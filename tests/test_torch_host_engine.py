"""The host engine, BLS24-315, ``testing.py`` and ``stats.py`` of the port
against the JAX package's, on the CPU.

gnark_icicle_tpu_torch holds copies of the JAX package's host engine
(``backend/groth16/host_compute.py``, ``backend/plonk/host_engine.py``),
BLS24-315 (``curves/bls24_315.py``), the CheckCircuit harness
(``testing.py``) and the constraint-count snapshot (``stats.py``, with its
own copy of ``latest_stats.csv``), and takes ``engine="host"`` in Groth16's
and PLONK's setup and prove, ``kzg.unsafe_srs`` and the serving classes.
Held here, on inputs made from numpy seeds: each host function gives the JAX
package's values; a small circuit's Groth16 and PLONK proofs from the port's
host engine are the JAX host engine's bytes and the port's device engine's
(``device="cpu"``, the kernels' plain versions) under one rng; BLS24-315's
constants, tower arithmetic, GLV endomorphism, Frobenius coefficients and
curve orders are the JAX package's; ``check_circuit`` and ``fuzz_circuit``
give the JAX package's verdicts; ``stats.snapshot`` the JAX package's rows,
which are the CSV's. BLS24-315's proof round trips (Python pairings over
E24, seconds each) are ``slow``, as in the JAX package.
"""

import importlib
import pathlib
import random
import secrets
import types

import numpy as np
import pytest

from gnark_icicle_tpu_torch.curves import bls12_381, bn254

Q = bn254.R
PKGS = ("gnark_icicle_tpu_torch", "gnark_icicle_tpu")
REPO = pathlib.Path(__file__).resolve().parents[1]


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def fixed_mask(monkeypatch):
    """Both packages' api.commit mask (secrets.randbelow) fixed, so that
    the two solves see one witness."""
    monkeypatch.setattr(secrets, "randbelow", lambda m: 0x5EED % m)


def seeded(seed: int, bound: int, n: int) -> list:
    """n values below bound from a numpy seed."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, -(-bound.bit_length() // 32)), dtype=np.uint64)
    return [int.from_bytes(w.astype("<u4").tobytes(), "little") % bound for w in words]


def corpus(pkg: str) -> types.ModuleType:
    """tests/circuits.py over `pkg`'s frontend (its one import rewritten), so
    that both packages compile the same circuits."""
    src = (REPO / "tests" / "circuits.py").read_text()
    src = src.replace("from gnark_icicle_tpu.frontend", f"from {pkg}.frontend")
    module = types.ModuleType(f"circuits_{pkg}")
    exec(compile(src, "tests/circuits.py", "exec"), module.__dict__)
    return module


def affine(pt):
    """A host point as plain ints (Fp2 coordinates as (c0, c1))."""
    if pt is None:
        return None
    return tuple((c.c0, c.c1) if hasattr(c, "c0") else c for c in pt)


# -- host_compute and host_engine, function by function ----------------------

def test_ntt_and_compute_h_host_match():
    fr = bn254.BN254.fr
    hosts = [mod(pkg, "backend.groth16.host_compute") for pkg in PKGS]
    vals = seeded(1, Q, 16)
    root = fr.root_of_unity(4)
    assert hosts[0].ntt_host(vals, Q, root) == hosts[1].ntt_host(vals, Q, root)
    a, b, c = (seeded(s, Q, 13) for s in (2, 3, 4))
    got = [h.compute_h_host(a, b, c, 4, fr) for h in hosts]
    assert got[0] == got[1] and len(got[0]) == 16
    assert hosts[0].z_scalars_bitreversed(got[0], 4, 15) == \
        hosts[1].z_scalars_bitreversed(got[1], 4, 15)


@pytest.mark.parametrize("group", ["bn254 g1", "bls12_381 g2"])
def test_msm_host_matches(group):
    """Σ sᵢ·Pᵢ with zero scalars and an infinity point among the terms."""
    name, g = group.split()
    curves = [getattr(mod(pkg, "curves." + name), name.upper()) for pkg in PKGS]
    grp = getattr(curves[0], g)
    r = curves[0].fr.modulus
    pts = [grp.scalar_mul(grp.generator, s) for s in seeded(5, r, 6)] + [None]
    scal = seeded(6, r, 7)
    scal[2] = 0
    got = [mod(pkg, "backend.groth16.host_compute").msm_host(getattr(c, g), pts, scal)
           for pkg, c in zip(PKGS, curves)]
    assert affine(got[0]) == affine(got[1])
    want = None
    for p, s in zip(pts, scal):
        if p is not None and s:
            want = grp.add(want, grp.scalar_mul(p, s))
    assert affine(got[0]) == affine(want)


def test_host_engine_transforms_and_quotient_match():
    """intt_host, coset_ntt_host, coset_intt_host (a round trip) and
    quotient_host on seeded 4n-coset evaluations (n = 8, one BSB22 column
    pair), then HostKZG's commit and open on one SRS."""
    fr = bn254.BN254.fr
    g = fr.multiplicative_generator
    hes = [mod(pkg, "backend.plonk.host_engine") for pkg in PKGS]
    ev = seeded(7, Q, 8)
    coeffs = [h.intt_host(ev, 3, fr) for h in hes]
    assert coeffs[0] == coeffs[1]
    cos = [h.coset_ntt_host(coeffs[0], 5, fr, g) for h in hes]
    assert cos[0] == cos[1]
    back = hes[0].coset_intt_host(cos[0], 5, fr, g)
    assert back == hes[1].coset_intt_host(cos[0], 5, fr, g)
    assert back == coeffs[0] + [0] * 24
    names = ("a", "b", "c", "z", "zw", "ql", "qr", "qm", "qo", "qk", "s1", "s2", "s3",
             "qcp0", "pi2_0")
    cols = {k: seeded(10 + i, Q, 32) for i, k in enumerate(names)}
    beta, gamma, alpha = seeded(8, Q, 3)
    got = [h.quotient_host(cols, 8, beta, gamma, alpha, g, g * g % Q, fr) for h in hes]
    assert got[0] == got[1] and len(got[0]) == 32
    srs = mod(PKGS[0], "backend.kzg").unsafe_srs(bn254.BN254, 12, tau=seeded(9, Q, 1)[0],
                                                 engine="host")
    poly = seeded(30, Q, 10)
    z = seeded(31, Q, 1)[0]
    kzgs = [h.HostKZG(bn254.BN254, srs) for h in hes]
    assert kzgs[0].commit(poly) == kzgs[1].commit(poly)
    assert kzgs[0].open(poly, z) == kzgs[1].open(poly, z)
    assert kzgs[0].commit([]) is None


def test_unsafe_srs_host_engine_matches():
    """kzg.unsafe_srs(engine="host") past the device batch's 256 powers: the
    JAX package's SRS under one rng, and no device read."""
    srs = [mod(pkg, "backend.kzg").unsafe_srs(bn254.BN254, 260, rng=random.Random(4),
                                              engine="host") for pkg in PKGS]
    assert srs[0].g1_powers == srs[1].g1_powers
    assert affine(srs[0].g2_tau) == affine(srs[1].g2_tau)


# -- engine="host" against the JAX host engine and the device engine ---------

def cubic(pkg: str):
    return corpus(pkg).Cubic


def inner_commit(pkg: str):
    fe = mod(pkg, "frontend")

    class InnerCommit(fe.Circuit):
        """y = x² with a commitment binding x and the public y."""

        x = fe.Secret()
        y = fe.Public()

        def define(self, api):
            c = api.commit(self.x, self.y)
            api.assert_is_different(c, 0)
            api.assert_is_equal(api.mul(self.x, self.x), self.y)

    return InnerCommit


def proof_bytes(pkg: str, system: str, curve, proof) -> bytes:
    if system == "groth16":
        return mod(pkg, "io.serialize").proof_to_bytes(curve, proof)
    return mod(pkg, "io.plonk_serialize").plonk_proof_to_bytes(curve, proof)


def prove_both(system: str, curve_name: str, circuit, pub, sec, **kw) -> list:
    """The proof bytes of the port's host engine, the JAX package's host
    engine and the port's device engine on the CPU, in that order, each
    from its own setup under the same rngs; the first proof verified (the
    others are its bytes where the caller finds them equal)."""
    out = []
    for pkg, engine in ((PKGS[0], {"engine": "host"}), (PKGS[1], {"engine": "host"}),
                        (PKGS[0], {"device": "cpu"})):
        curve = getattr(mod(pkg, "curves." + curve_name), curve_name.upper())
        backend = mod(pkg, "backend." + system)
        cs = mod(pkg, "frontend").compile_circuit(
            curve.fr.modulus, circuit(pkg), builder="r1cs" if system == "groth16" else "scs")
        pk, vk = backend.setup(cs, curve, rng=random.Random(11), **engine)
        proof = backend.prove(cs, pk, pub, sec, curve, rng=random.Random(12), **engine, **kw)
        if not out:
            backend.verify(proof, vk, pub, curve, **kw)
        out.append(proof_bytes(pkg, system, curve, proof))
    return out


@pytest.mark.parametrize("system", ["groth16", "plonk"])
@pytest.mark.parametrize("curve_name", ["bn254", "bls12_381"])
def test_host_engine_proof_bytes(system, curve_name):
    """Cubic: the port's host engine gives the JAX host engine's bytes and
    the port's device engine's."""
    got = prove_both(system, curve_name, cubic, [35], [3])
    assert got[0] == got[1] == got[2]


@pytest.mark.parametrize("system", ["groth16", "plonk"])
def test_host_engine_proof_bytes_with_a_commitment(system):
    """A BSB22 commitment (the host Pedersen products in Groth16's host
    engine, the PI2 column in PLONK's): the same three-way equality."""
    kw = {"fs_hash": "mimc"} if system == "plonk" else {}
    got = prove_both(system, "bn254", inner_commit, [9], [3], **kw)
    assert got[0] == got[1] == got[2]


def test_prover_service_host_engine():
    """Groth16Prover and PlonkProver with engine="host" (tests/test_aux.py:
    170, 180) bind no device and prove the direct host proof's bytes."""
    from gnark_icicle_tpu_torch.backend import groth16, plonk
    from gnark_icicle_tpu_torch.backend.prover_service import Groth16Prover, PlonkProver
    from gnark_icicle_tpu_torch.frontend import compile_circuit

    curve = bn254.BN254
    for backend, cls, builder in ((groth16, Groth16Prover, "r1cs"), (plonk, PlonkProver, "scs")):
        cs = compile_circuit(Q, cubic(PKGS[0]), builder=builder)
        pk, _ = backend.setup(cs, curve, rng=random.Random(1), engine="host")
        svc = cls(cs, pk, curve, engine="host")
        assert svc.device is None
        got = svc.prove([35], [3], rng=random.Random(2))
        want = backend.prove(cs, pk, [35], [3], curve, rng=random.Random(2), engine="host")
        system = "groth16" if backend is groth16 else "plonk"
        assert proof_bytes(PKGS[0], system, curve, got) == \
            proof_bytes(PKGS[0], system, curve, want)
    with pytest.raises(ValueError):
        Groth16Prover(cs, pk, curve, engine="tpu")


# -- BLS24-315 ----------------------------------------------------------------

def test_bls24_315_constants_match():
    """The seed, moduli, cofactors, twist coefficient, generators, GLV
    constants and final exponent are the JAX package's; the seed and moduli
    are the reference tree's (tests/test_bls24_315.py)."""
    port, ref = (mod(pkg, "curves.bls24_315") for pkg in PKGS)
    for name in ("X_SEED", "R", "P", "U_SQ", "N1", "H1", "N2", "H2", "G1_GEN", "G2_GEN", "G2_B",
                 "GLV_LAMBDA", "GLV_OMEGA", "FINAL_EXP", "F4_ONE", "V4", "E24_ONE"):
        assert getattr(port, name) == getattr(ref, name), name
    x = port.X_SEED
    assert port.R == x**8 - x**4 + 1 == 0x196deac24a9da12b25fc7ec9cf927a98c8c480ece644e36419d0c5fd00c00001
    assert port.P == (x - 1) ** 2 * port.R // 3 + x
    assert port.FP.modulus == port.P and port.FR.modulus == port.R
    assert port.BLS24_315.name == "bls24-315"
    assert mod(PKGS[0], "curves").CURVES["bls24-315"] is port.BLS24_315


def test_bls24_315_tower_matches():
    """Fp4 and E24 arithmetic and the sparse Miller line on seeded values."""
    port, ref = (mod(pkg, "curves.bls24_315") for pkg in PKGS)
    p = port.P
    a, b = (tuple(seeded(s, p, 4)) for s in (1, 2))
    for name in ("f4_mul", "f4_add", "f4_sub"):
        assert getattr(port, name)(a, b) == getattr(ref, name)(a, b), name
    assert port.f4_inv(a) == ref.f4_inv(a)
    assert port.f4_mul(a, port.f4_inv(a)) == port.F4_ONE
    e, f = (tuple(tuple(seeded(s + 10 * i, p, 4)) for i in range(6)) for s in (3, 4))
    assert port.e24_mul(e, f) == ref.e24_mul(e, f)
    assert port.e24_pow(e, 12345) == ref.e24_pow(e, 12345)
    xp, yp = seeded(5, p, 2)
    args = (xp, yp, a, b, tuple(seeded(6, p, 4)))
    assert port._line_sparse(*args) == ref._line_sparse(*args)


def test_bls24_315_glv_frobenius_and_orders():
    """The checks of tests/test_bls24_315.py on the port's module: the GLV
    endomorphism acts as [λ] on G1, the in-tree Frobenius coefficients are
    powers of 13, and the generators have order r."""
    b24 = mod(PKGS[0], "curves.bls24_315")
    P, R, X = b24.P, b24.R, b24.X_SEED
    assert (b24.GLV_LAMBDA ** 2 + b24.GLV_LAMBDA + 1) % R == 0
    assert b24.GLV_LAMBDA % R == (X**4 - 1) % R
    assert pow(b24.GLV_OMEGA, 3, P) == 1 and b24.GLV_OMEGA != 1
    g = b24.G1_GEN
    phi = (b24.GLV_OMEGA * g[0] % P, g[1])
    assert b24.G1.is_on_curve(phi) and phi == b24.G1.scalar_mul(g, b24.GLV_LAMBDA)
    # fields_bls24315/e24.go:70-85, three of its thirteen coefficients
    intree = {(1, 4): 14265754707630841383590096931465005402246260064523506653409458152869013672931584279153351926943,
              (1, 24): 37719635718874797449167165011304104204868932892052995456614707782168504515295626008356825673023,
              (2, 3): 37014442673353839783463348892746893664389658635873267609916377398480286678854893830142}
    for (mult, denom), want in intree.items():
        assert pow(13, mult * ((P - 1) // denom), P) == want
    assert b24.N1 == P + 1 - (X + 1) and b24.H1 * R == b24.N1 and b24.H2 * R == b24.N2
    assert b24.G1.is_on_curve(b24.G1_GEN) and b24.G2.is_on_curve(b24.G2_GEN)
    assert b24.G1.scalar_mul(b24.G1_GEN, R) is None
    assert b24.G2.scalar_mul(b24.G2_GEN, R) is None


def test_bls24_315_has_no_device_path():
    """DeviceCtx refuses BLS24-315 with its reason, on any device, and so do
    the default engines; nothing falls back to the host."""
    from gnark_icicle_tpu_torch.backend import groth16
    from gnark_icicle_tpu_torch.curves.bls24_315 import BLS24_315, R
    from gnark_icicle_tpu_torch.device import DeviceCtx
    from gnark_icicle_tpu_torch.frontend import compile_circuit

    for device in (None, "cpu"):
        with pytest.raises(NotImplementedError, match="host engine only"):
            DeviceCtx(BLS24_315, device)
    with pytest.raises(NotImplementedError, match="host engine only"):
        groth16.setup(compile_circuit(R, cubic(PKGS[0])), BLS24_315, rng=random.Random(1),
                      device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("system", ["groth16", "plonk", "groth16 commit"])
def test_bls24_315_round_trip(system):
    """Groth16 and PLONK on BLS24-315 through the host engine (and Groth16
    with a commitment): the JAX package's proof, verified, and refused with
    a wrong public input."""
    circuit, pub, sec = (inner_commit, 49, 7) if system.endswith("commit") else (cubic, 35, 3)
    name = system.split()[0]
    got = []
    for pkg in PKGS:
        b24 = mod(pkg, "curves.bls24_315")
        backend = mod(pkg, "backend." + name)
        cs = mod(pkg, "frontend").compile_circuit(
            b24.R, circuit(pkg), builder="r1cs" if name == "groth16" else "scs")
        pk, vk = backend.setup(cs, b24.BLS24_315, rng=random.Random(1), engine="host")
        proof = backend.prove(cs, pk, [pub], [sec], b24.BLS24_315, rng=random.Random(2),
                              engine="host")
        got.append({k: v for k, v in vars(proof).items() if not k.startswith("_")})
        if pkg == PKGS[0]:
            backend.verify(proof, vk, [pub], b24.BLS24_315)
            assert not backend.is_valid(proof, vk, [pub + 1], b24.BLS24_315)
    assert repr(got[0]) == repr(got[1])


# -- testing.py and stats.py ---------------------------------------------------

def verdict(pkg: str, fn: str, *args, **kw) -> str:
    try:
        getattr(mod(pkg, "testing"), fn)(*args, **kw)
    except mod(pkg, "testing").CheckFailure as e:
        return "CheckFailure: " + str(e).split(":")[0]
    return "passed"


@pytest.mark.parametrize("case", ["valid", "bad valid", "bad invalid", "prover tier"])
def test_check_circuit_verdicts_match(case):
    """check_circuit's verdicts over tests/circuits.py's Cubic, the prover
    tier (Groth16 and PLONK) on the host engine."""
    args = {"valid": dict(valid=[dict(x=3, y=35)], invalid=[dict(x=3, y=36)]),
            "bad valid": dict(valid=[dict(x=3, y=36)]),
            "bad invalid": dict(invalid=[dict(x=3, y=35)]),
            "prover tier": dict(valid=[dict(x=3, y=35)], invalid=[dict(x=0, y=1)],
                                prover_checks=True, engine="host")}[case]
    got = [verdict(pkg, "check_circuit", corpus(pkg).Cubic, **args) for pkg in PKGS]
    assert got[0] == got[1]
    assert got[0] == ("passed" if case in ("valid", "prover tier") else
                      "CheckFailure: engine rejects valid witness {'x'" if case == "bad valid"
                      else "CheckFailure: engine accepts invalid witness {'x'")


def test_check_circuit_prover_tier_defaults_to_the_card():
    """The port's prover tier runs on the card unless asked otherwise: with
    no engine and no card it raises, where the original would prove on the
    host."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the prover tier would run on it")
    from gnark_icicle_tpu_torch.testing import check_circuit

    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_circuit(corpus(PKGS[0]).Cubic, valid=[dict(x=3, y=35)], prover_checks=True)


def test_fuzz_circuit_verdicts_match():
    names = {"Cubic": ["x", "y"], "IsZeroCircuit": ["a", "z"],
             "SelectCircuit": ["cond", "t", "f", "out"], "XorCircuit": ["a", "b", "c"]}
    for cls, inputs in names.items():
        got = [verdict(pkg, "fuzz_circuit", getattr(corpus(pkg), cls), inputs) for pkg in PKGS]
        assert got == ["passed", "passed"], cls


def test_stats_snapshot_matches_the_reference_and_the_csv():
    """A few corpus circuits' rows under both builders, on BN254 and
    BLS12-381: the JAX package's rows and the locked CSV's; the port's CSV
    is a copy of the JAX package's."""
    from gnark_icicle_tpu_torch import stats

    assert pathlib.Path(stats.LOCKED_CSV).read_bytes() == \
        (REPO / "gnark_icicle_tpu" / "latest_stats.csv").read_bytes()
    locked_rows = stats.from_csv(pathlib.Path(stats.LOCKED_CSV).read_text())
    locked = {(r["circuit"], r["curve"], r["backend"]): r for r in locked_rows}
    assert len(locked) >= 253
    picked = ("cubic", "add", "assertequal", "bool")
    for curve, q in (("bn254", Q), ("bls12-381", bls12_381.R)):
        rows = []
        for pkg in PKGS:
            circuits = {name: cls for name, cls, _, _ in corpus(pkg).corpus(q) if name in picked}
            rows.append(mod(pkg, "stats").snapshot(circuits, q, curve))
        assert rows[0] == rows[1] and len(rows[0]) == 2 * len(picked)
        assert stats.diff(locked_rows, rows[0]) == []
        for r in rows[0]:
            assert locked[r["circuit"], r["curve"], r["backend"]] == r
    assert stats.from_csv(stats.to_csv(rows[0])) == rows[0]
