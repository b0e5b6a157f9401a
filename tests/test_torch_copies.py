"""The port's copies of the JAX package's host modules, held to their
originals on the CPU.

gnark_icicle_tpu_torch keeps its own copies of the JAX-free host modules it
needs (frontend, constraint, native solver, curves, logger, debug, profile),
so that it imports nothing of the JAX package. Each copy must behave as its
original: the same R1CS from the same circuit, the same wires from the
native and the Python solver, the same curve constants and pairings.
"""

import dataclasses

import pytest

from gnark_icicle_tpu import constraint as ref_constraint
from gnark_icicle_tpu import frontend as ref_frontend
from gnark_icicle_tpu.curves import bls12_377 as ref_bls377
from gnark_icicle_tpu.curves import bls12_381 as ref_bls381
from gnark_icicle_tpu.curves import bn254 as ref_bn254
from gnark_icicle_tpu_torch import constraint, frontend
from gnark_icicle_tpu_torch.curves import bls12_377, bls12_381, bn254

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
